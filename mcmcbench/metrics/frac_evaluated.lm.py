"""core/sequential_test.py: the mean share of the pool a step's test
evaluated (``LMTrainInfo.n_evaluated`` / pool) over the window's steps, in %."""


def read(run):
    n = run.stats.get("n_evaluated")
    if not n:
        return None
    return 100.0 * sum(n) / (len(n) * run.stats["pool"])
