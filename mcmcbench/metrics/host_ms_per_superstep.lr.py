"""core/ensemble.py's masked loop: the window's milliseconds over its
supersteps, counted as the round op's launches (one a superstep)."""


def read(run):
    n = run.stats.get("supersteps")
    return None if not n else 1e3 * run.stats["window_s"] / n
