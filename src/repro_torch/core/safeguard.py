"""Sec. 3.3 safeguard: normality diagnostics + auto exact-vs-subsampled report.

The port of ``repro.core.safeguard``. "Our software can provide a normality
test for the distribution of the estimated mean in trial runs and produce an
auto-generated comparison between the performance of the approximate MH and
regular inference."

The t-test in Alg. 2 assumes mini-batch means of {l_i} are near-normal; heavy
tails (the Bardenet et al. counterexample) break the CLT on small subsets.
:func:`trial_run_report` runs a few transitions, collects the population
{l_i} at each proposal, tests normality of mini-batch means (Jarque–Bera),
and replays the SAME (u, theta, theta') decisions through both the exact
rule and the sequential test to report the empirical decision-error rate.

The subsampled test is the port's host loop of rounds, each one
Fisher–Yates draw, one evaluation through ``target.local_round`` and one
round op, so on the card it runs the same kernels as a transition. The
exact pass reads ``range(0, N)`` when the target takes ranges (the logit
and AR(1) families' contiguous form, with no index tensor).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import make_generator, to_leaf, tree_leaves, tree_map
from .proposals import propose
from .samplers import fy_draw, fy_init, fy_reset
from .sequential_test import sequential_test
from .stats import jarque_bera
from .subsampled_mh import draw_log_u
from .target import PartitionedTarget


@dataclasses.dataclass
class TrialReport:
    num_trials: int
    jb_stat_mean: float
    jb_pvalue_min: float
    normal_ok: bool
    decision_error_rate: float
    mean_fraction_evaluated: float
    recommendation: str

    def __str__(self) -> str:  # pragma: no cover - formatting
        lines = [
            "Sec 3.3 safeguard report",
            f"  trials                      : {self.num_trials}",
            f"  Jarque-Bera stat (mean)     : {self.jb_stat_mean:.3f}",
            f"  Jarque-Bera p-value (min)   : {self.jb_pvalue_min:.4f}",
            f"  batch-mean normality OK     : {self.normal_ok}",
            f"  exact-vs-subsampled errors  : {self.decision_error_rate:.3%}",
            f"  mean fraction of N evaluated: {self.mean_fraction_evaluated:.3%}",
            f"  recommendation              : {self.recommendation}",
        ]
        return "\n".join(lines)


def trial_run_report(
    seed_or_gen,
    theta0,
    target: PartitionedTarget,
    proposal,
    batch_size: int = 100,
    epsilon: float = 0.01,
    num_trials: int = 20,
) -> TrialReport:
    """Run ``num_trials`` trial transitions from ``theta0`` and report.

    ``seed_or_gen`` is an int or a ``torch.Generator`` on the target's
    device (for a hand-wired target without one, theta0's). Each trial draws
    u, then the proposal, then the test's Fisher–Yates draws; the chain
    advances on the exact decision.
    """
    dev = target.device or tree_leaves(theta0)[0].device
    gen = make_generator(seed_or_gen, dev)
    n = target.num_sections
    theta = tree_map(lambda leaf: to_leaf(leaf, dev), theta0)
    idx_all = range(0, n) if target.range_sections else torch.arange(
        n, dtype=torch.int32, device=dev)
    jb_stats, jb_ps, errors, fractions = [], [], [], []

    for _ in range(num_trials):
        log_u = float(draw_log_u(gen, (), dev))
        theta_p, corr = propose(proposal, gen, theta)
        g = float(target.log_global(theta, theta_p) + corr)
        l = target.log_local(theta, theta_p, idx_all).cpu().numpy()
        mu0 = (log_u - g) / n
        exact_accept = l.mean() > mu0

        # normality of mini-batch means
        nb = max(len(l) // batch_size, 1)
        means = np.array([c.mean() for c in np.array_split(l, nb)]) if nb > 1 else l
        jb, p = jarque_bera(means)
        jb_stats.append(jb)
        jb_ps.append(p)

        res = sequential_test(
            gen, torch.tensor(mu0, dtype=torch.float32, device=dev), fy_draw,
            target.local_round(theta, theta_p), fy_reset(fy_init(n, device=dev)), n,
            batch_size, epsilon,
        )
        errors.append(bool(res.decision) != bool(exact_accept))
        fractions.append(float(res.n_evaluated) / n)

        if exact_accept:  # advance chain with the exact decision (trial run)
            theta = theta_p

    normal_ok = min(jb_ps) > 0.01
    err = float(np.mean(errors))
    rec = (
        "subsampled MH looks safe at this epsilon/batch size"
        if normal_ok and err <= max(2.0 * epsilon, 0.1)
        else "heavy-tailed l_i or high decision-error rate: increase batch size, "
        "lower epsilon, or fall back to exact MH for this variable"
    )
    return TrialReport(
        num_trials=num_trials,
        jb_stat_mean=float(np.mean(jb_stats)),
        jb_pvalue_min=float(min(jb_ps)),
        normal_ok=normal_ok,
        decision_error_rate=err,
        mean_fraction_evaluated=float(np.mean(fractions)),
        recommendation=rec,
    )
