"""The port's Sec. 3.3 safeguard against the JAX package's.

Both packages get the same numpy inputs. The Jarque–Bera statistic is host
numpy in both and must agree exactly. ``trial_run_report`` draws its u,
proposals and Fisher–Yates draws from each package's own generator, so the
reports are held by distribution over a few seeds, at the settings of
``tests/test_core.py::test_trial_run_report_flags_clean_problem_as_safe``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro_torch.core import RandomWalk, from_iid_loglik, jarque_bera, trial_run_report

torch.set_num_threads(1)

SEEDS = (0, 1, 2, 3)


@pytest.mark.parametrize("case", ["normal", "heavy_tailed", "n_below_8", "zero_spread"])
def test_jarque_bera_matches_reference(case):
    rng = np.random.default_rng(3)
    x = {"normal": rng.standard_normal(200),
         "heavy_tailed": rng.standard_t(1.5, 200),
         "n_below_8": rng.standard_normal(7),
         "zero_spread": np.full(50, 0.25)}[case].astype(np.float32)
    got, want = jarque_bera(x), J.jarque_bera(x)
    assert got == want
    if case in ("n_below_8", "zero_spread"):
        assert got == (0.0, 1.0)


def _targets(pop):
    """The same iid scaffold in both packages: prior -theta^2/2 and local
    sections ``loglik(theta, i)`` over the float32 population ``pop``; the
    conjugate Gaussian harness of ``tests/conftest.py`` when ``pop`` is its
    data and ``loglik = -(x_i - theta)^2 / 2``."""
    n = len(pop)
    xj, xt = jnp.asarray(pop), torch.tensor(pop)
    return {
        "gaussian": (
            J.from_iid_loglik(lambda th: -0.5 * jnp.sum(th ** 2),
                              lambda th, idx: -0.5 * (xj[idx] - th) ** 2, None, n),
            from_iid_loglik(lambda th: -0.5 * (th ** 2).sum(),
                            lambda th, idx: -0.5 * (xt[idx.long()] - th) ** 2, None, n)),
        "linear": (
            J.from_iid_loglik(lambda th: -0.5 * jnp.sum(th ** 2),
                              lambda th, idx: th * xj[idx], None, n),
            from_iid_loglik(lambda th: -0.5 * (th ** 2).sum(),
                            lambda th, idx: th * xt[idx.long()], None, n)),
    }


def _reports(target_j, target_t, **kw):
    out = {"jax": [], "torch": []}
    for seed in SEEDS:
        out["jax"].append(J.trial_run_report(jax.random.key(seed), jnp.zeros(()), target_j,
                                             J.RandomWalk(0.05), **kw))
        out["torch"].append(trial_run_report(seed, torch.zeros(()), target_t, RandomWalk(0.05),
                                             **kw))
    return out


def test_trial_run_report_on_conjugate_gaussian_matches_reference():
    """n = 800, batch 50, epsilon 0.05, 6 trials (the reference test's
    setting). Every report in both packages passes the normality check and
    the reference test's error bound; the port's mean evaluated fraction
    over the seeds is within 0.1 of the reference's (one trial's fraction is
    a multiple of 50 / 800, and the trials follow each package's draws)."""
    n = 800
    x = (0.7 + np.random.default_rng(1).standard_normal(n)).astype(np.float32)
    reps = _reports(*_targets(x)["gaussian"], batch_size=50, epsilon=0.05, num_trials=6)
    for pkg, rs in reps.items():
        for r in rs:
            assert r.num_trials == 6
            assert r.normal_ok, (pkg, r)
            assert r.decision_error_rate <= 0.3, (pkg, r)
            assert 0.0 < r.mean_fraction_evaluated <= 1.0, (pkg, r)
            assert np.isfinite(r.jb_stat_mean) and 0.0 < r.jb_pvalue_min <= 1.0
    frac = {pkg: np.mean([r.mean_fraction_evaluated for r in rs]) for pkg, rs in reps.items()}
    assert abs(frac["torch"] - frac["jax"]) <= 0.1, frac


def test_trial_run_report_flags_heavy_tails_in_both_packages():
    """l_i = (theta' - theta) t_i with t_i Student-t with 1.5 degrees of
    freedom: the mini-batch means are far from normal, and both packages
    say so and recommend against subsampling."""
    t = np.random.default_rng(5).standard_t(1.5, 2000).astype(np.float32)
    reps = _reports(*_targets(t)["linear"], batch_size=50, epsilon=0.05, num_trials=6)
    for pkg, rs in reps.items():
        for r in rs:
            assert not r.normal_ok, (pkg, r)
            assert r.recommendation.startswith("heavy-tailed"), (pkg, r)
