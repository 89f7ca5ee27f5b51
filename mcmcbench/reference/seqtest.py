"""The plain reference of the sequential test (the paper's Alg. 2), in
float64 with the exact Student-t tail, and the measures by which a
program's test is held to it.

Sections are consumed in stream order, m a round (the last round holds what
is left of the pool of N). After round r, with n sections seen, mean and
sample variance s_l^2: s = s_l / sqrt(n) * sqrt(1 - (n - 1) / (N - 1)),
t = |mean - mu0| / s, p = 2 P(T_{n-1} > t). The test stops at the first
round with s_l > 0 and p < epsilon, or when the pool is exhausted; the
decision is mean > mu0.
"""
from __future__ import annotations

import numpy as np
from scipy import special

BAND = 0.1  # relative: the program's Student-t tail is within 6e-2 of the exact one


def round_stats(deltas: np.ndarray, m: int, n_total: int):
    """Per round of stream-ordered ``deltas`` (S, N) float64: n (R,), mean
    (S, R), standard error with the finite-population correction (S, R), and
    the sample std (S, R). R = ceil(N / m)."""
    deltas = np.asarray(deltas, np.float64)
    n = np.minimum(np.arange(1, -(-n_total // m) + 1) * m, n_total)
    c1 = np.cumsum(deltas, axis=1)[:, n - 1]
    c2 = np.cumsum(deltas * deltas, axis=1)[:, n - 1]
    mean = c1 / n
    var = np.maximum(c2 / n - mean * mean, 0.0) * n / np.maximum(n - 1, 1)
    sd = np.sqrt(var)
    corr = np.maximum(1.0 - (n - 1) / max(n_total - 1, 1), 0.0)
    se = sd / np.sqrt(n) * np.sqrt(corr)
    return n, mean, se, sd


def pvalues(mean, se, mu0, n):
    """Two-sided p of each round, (S, R); 0 where the standard error is 0."""
    t = np.abs(mean - mu0[:, None]) / np.where(se > 0, se, 1.0)
    p = 2.0 * special.stdtr(np.maximum(n - 1, 1)[None, :], -t)
    return np.where(se > 0, p, 0.0)


def first_stop(p, sd, n, n_total, epsilon):
    """The reference's stopping round (1-based) of each row."""
    stop = (sd > 0) & (p < epsilon)
    stop[:, -1] = True  # the pool is exhausted at the last round
    return np.argmax(stop, axis=1) + 1


def hold(deltas, mu0, epsilon, m, n_total, rounds, n_evaluated, mu_hat, accepted):
    """Hold a program's tests to the reference on the same deltas.

    ``deltas`` (S, N) are the sections in stream order (only the first
    ``n_evaluated`` of a row are read), ``mu0`` (S,), and the program's
    ``rounds``, ``n_evaluated``, ``mu_hat`` and ``accepted`` (S,). Returns a
    dict of measures:

    - ``count``: rows whose ``n_evaluated`` is not what ``rounds`` rounds
      of m consume;
    - ``mu``: the widest |mu_hat - the reference's mean over the same
      sections|, in units of the reference's standard error there;
    - ``stop``: rows whose stopping round breaks the rule by more than
      ``BAND``: p at the stopping round above epsilon (1 + BAND) (unless the
      pool is exhausted), or p at an earlier round below epsilon (1 - BAND).
      The band holds the program's float32 Student-t tail, which the port
      documents within 6e-2 relative of the exact tail;
    - ``decision``: rows whose accept is not mean > mu0 at the stopping
      round, where the mean is more than 1e-3 standard errors from mu0.
    """
    deltas = np.asarray(deltas, np.float64)
    mu0 = np.asarray(mu0, np.float64)
    rounds = np.asarray(rounds, np.int64)
    n, mean, se, sd = round_stats(deltas, m, n_total)
    p = pvalues(mean, se, mu0, n)
    rows = np.arange(len(rounds))
    r = np.clip(rounds, 1, len(n)) - 1
    count = int(np.sum(np.asarray(n_evaluated) != n[r]))
    se_r = np.where(se[rows, r] > 0, se[rows, r], sd[rows, r] / np.sqrt(n[r]) + 1e-30)
    mu = float(np.max(np.abs(np.asarray(mu_hat, np.float64) - mean[rows, r]) / se_r)) \
        if len(rows) else 0.0
    stop = 0
    for i in rows:
        ri = r[i]
        late = n[ri] < n_total and sd[i, ri] > 0 and p[i, ri] >= epsilon * (1 + BAND)
        early = ((sd[i, :ri] > 0) & (p[i, :ri] < epsilon * (1 - BAND))).any()
        stop += int(late or early)
    gap = (mean[rows, r] - mu0) / se_r
    clear = np.abs(gap) > 1e-3
    decision = int(np.sum(clear & ((gap > 0) != np.asarray(accepted, bool))))
    return {"count": count, "mu": mu, "stop": stop, "decision": decision}


def sequential(round_deltas, mu0: float, epsilon: float, m: int, n_total: int,
               stat_round=None):
    """The reference's test run round by round: ``round_deltas(r)`` gives
    round r's deltas (0-based); ``stat_round`` rounds the running mean and
    standard error (the control's lower precision). Returns (rounds, n
    evaluated, mean, accept, the deltas seen)."""
    rnd = stat_round or (lambda a: a)
    seen = np.full((1, n_total), np.nan)
    n_rounds = -(-n_total // m)
    for r in range(n_rounds):
        a, b = r * m, min((r + 1) * m, n_total)
        seen[0, a:b] = round_deltas(r)
        n, mean, se, sd = round_stats(np.nan_to_num(seen), m, n_total)
        mean, se = rnd(mean[:, r:r + 1]), rnd(se[:, r:r + 1])
        p = pvalues(mean, se, np.array([mu0]), n[r:r + 1])
        if (sd[0, r] > 0 and p[0, 0] < epsilon) or b >= n_total:
            return r + 1, b, float(mean[0, 0]), bool(mean[0, 0] > mu0), seen[0, :b]
    raise AssertionError("unreachable: the last round exhausts the pool")


def bf16(a):
    """float64 values rounded to bfloat16 (to nearest even), as float64."""
    import torch

    return torch.as_tensor(np.asarray(a, np.float64)).to(torch.bfloat16).double().numpy()
