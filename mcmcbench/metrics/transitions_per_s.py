"""Transitions completed by all chains in the window over the window's seconds."""


def read(run):
    n = run.stats.get("transitions")
    return None if not n else n / run.stats["window_s"]
