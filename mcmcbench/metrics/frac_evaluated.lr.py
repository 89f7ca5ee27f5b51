"""core/sequential_test.py: the mean share of the N rows a transition's
test evaluated (``n_evaluated`` / N) over the window's transitions, in %."""


def read(run):
    n = run.stats.get("transitions")
    if not n:
        return None
    return 100.0 * run.stats["n_evaluated_sum"] / (n * run.stats["num_sections"])
