"""MH transitions of the LM completed in the window over the window's
seconds; the window ends at the last completed step's synchronize."""


def read(run):
    steps = run.stats.get("steps")
    return None if not steps else steps / run.stats["window_s"]
