"""The cost of one test round of the LM step (two forwards over the round's
sequences and the test's round), in ms: the least-squares slope of each
window step's seconds on its rounds. A step costs a fixed part (proposal,
prior) plus its rounds, so the slope does not move with how many rounds the
trajectory's tests read, where ``lm_steps_per_s`` does."""
import numpy as np


def read(run):
    t, r = run.stats.get("step_s"), run.stats.get("rounds")
    if not t or len(set(r)) < 3:
        return None
    r = np.asarray(r, np.float64)
    t = np.asarray(t, np.float64)
    rc = r - r.mean()
    return 1e3 * float((rc * (t - t.mean())).sum() / (rc * rc).sum())
