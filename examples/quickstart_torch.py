"""Quickstart on the port: sublinear-time MH on Bayesian logistic regression.
The counterpart of ``examples/quickstart.py``: exact MH (O(N) per
transition) against subsampled MH (Alg. 3), plus the Sec-3.3 normality
safeguard report.

    PYTHONPATH=src python examples/quickstart_torch.py                 # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --smoke --device cpu

Randomness: the synthetic data, the safeguard's trials and the chains come
from ``torch.Generator``s seeded 0, 1 and 2, where the reference uses
``jax.random.key(0/1/2)``, so the numbers match the reference's in
distribution, not in bits. ``run(data=...)`` takes another data set (the
reference's, converted) in place of the seeded one.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import RandomWalk, SubsampledMHConfig, run_chain, trial_run_report
from repro_torch.experiments import bayeslr
from repro_torch.kernels import ops


def sizes(smoke: bool) -> tuple[int, int, int, int]:
    """(N, D, transitions, m) of the smoke or full run."""
    return (5_000, 10, 100, 200) if smoke else (50_000, 50, 400, 1000)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(smoke: bool = False, *, device=None, data: bayeslr.LRData | None = None,
        steps: int | None = None, log=print) -> dict:
    """The example's run; returns the numbers it prints."""
    dev = resolve_device(device)
    n, d, n_steps, m = sizes(smoke)
    steps = steps or n_steps
    if data is None:
        data = bayeslr.synth_mnist_like(0, n_train=n, n_test=1000, d=d, device=dev)
    n, d = data.x_train.shape
    target = bayeslr.make_target(data.x_train.to(dev), data.y_train.to(dev))
    w0 = torch.zeros(d, device=dev)
    prop = RandomWalk(0.03)

    log(ops.dispatch_summary())
    log(f"Bayesian logistic regression, N={n}, D={d} (paper Sec 4.1 scale)")
    log("\n--- Sec 3.3 safeguard (trial run) ---")
    report = trial_run_report(1, w0, target, prop, num_trials=10)
    log(report)

    out = {"n": n, "d": d, "steps": steps,
           "report": {k: getattr(report, k) for k in (
               "num_trials", "jb_stat_mean", "jb_pvalue_min", "normal_ok",
               "decision_error_rate", "mean_fraction_evaluated")}}
    for kernel, cfg in [
        ("exact", None),
        ("subsampled", SubsampledMHConfig(batch_size=m, epsilon=0.05, sampler="stream")),
    ]:
        _sync(dev)
        t0 = time.perf_counter()
        _, samples, infos = run_chain(2, w0, target, prop, steps, kernel=kernel, config=cfg,
                                      device=dev)
        _sync(dev)
        wall = time.perf_counter() - t0
        w = samples.cpu().numpy()[steps // 2:]
        acc = float(np.mean(infos.accepted.cpu().numpy()))
        n_eval = float(np.mean(infos.n_evaluated.cpu().numpy()))
        out[kernel] = {"wall_s": wall, "ms_per_transition": 1e3 * wall / steps,
                       "posterior_mean": w.mean(0), "acceptance": acc,
                       "sections_evaluated": n_eval, "frac_evaluated": n_eval / n}
        log(f"\n--- {kernel} MH ({steps} transitions) ---")
        log(f"  wall time          : {wall:.2f}s ({1e3 * wall / steps:.2f} ms/transition)")
        log(f"  posterior mean w[:4]: {w.mean(0)[:4]}")
        log(f"  acceptance rate    : {acc:.2f}")
        log(f"  sections evaluated : {n_eval:.0f} / {n} ({n_eval / n:.1%})")

    we, ws = out["exact"]["posterior_mean"], out["subsampled"]["posterior_mean"]
    out["posterior_mean_gap"] = float(np.linalg.norm(we - ws))
    out["speedup"] = out["exact"]["wall_s"] / out["subsampled"]["wall_s"]
    log("\n--- comparison ---")
    log(f"  posterior-mean gap : {out['posterior_mean_gap']:.4f}")
    log(f"  speedup            : {out['speedup']:.2f}x wall-clock at equal transitions")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (seconds instead of minutes)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    run(smoke=args.smoke, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
