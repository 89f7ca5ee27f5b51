"""Multi-chain quickstart on the port: a K-chain ensemble on Bayesian
logistic regression. The counterpart of ``examples/multichain.py``.

The run uses masked stepping with the adaptive schedule
(``stepping="masked"`` + ``ScheduleConfig``): chains whose sequential test
stops early start their next transition in the same superstep, and each
chain tunes its batch-size bucket and epsilon from its own trailing test
statistics. Cross-chain split R-hat and ESS come from
``repro_torch.core.stats``.

    PYTHONPATH=src python examples/multichain_torch.py                 # on the card
    PYTHONPATH=src python examples/multichain_torch.py --smoke --device cpu

Randomness: the data come from a ``torch.Generator`` seeded 0 and the
chains from one seeded 1, where the reference uses ``jax.random.key(0/1)``;
the K chains share that one generator. So the numbers match the
reference's in distribution, not in bits. ``run(data=...)`` takes another
data set (the reference's, converted) in place of the seeded one.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import ScheduleConfig
from repro_torch.experiments import bayeslr
from repro_torch.kernels import ops


def sizes(smoke: bool) -> tuple[int, int, int, int]:
    """(N, D, chains, steps) of the smoke or full run."""
    return (2_000, 4, 8, 200) if smoke else (20_000, 8, 16, 1200)


def run(smoke: bool = False, *, device=None, data: bayeslr.LRData | None = None,
        steps: int | None = None, log=print) -> dict:
    """The example's run; returns the numbers it prints."""
    dev = resolve_device(device)
    n, d, chains, n_steps = sizes(smoke)
    steps = steps or n_steps
    if data is None:
        data = bayeslr.synth_mnist_like(0, n_train=n, n_test=500, d=d, device=dev)
    n, d = data.x_train.shape

    log(ops.dispatch_summary())
    log(f"BayesLR N={n}, D={d}: {chains} subsampled-MH chains x {steps} steps "
        f"(masked-continuation + adaptive scheduling)")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    samples, diag = bayeslr.run_posterior_ensemble(
        1, data, num_chains=chains, num_steps=steps, batch_size=500, epsilon=0.05,
        sigma=0.04, overdisperse=0.2, stepping="masked", schedule=ScheduleConfig(), device=dev)
    wall = time.perf_counter() - t0

    w = samples[:, steps // 2:]  # (K, T/2, D)
    err = bayeslr.test_error(w.reshape(-1, d).mean(0), data.x_test, data.y_test)
    tail = diag["rounds_tail"]
    out = {"n": n, "d": d, "chains": chains, "steps": steps, "wall_s": wall,
           "transitions_per_s": chains * steps / wall, "rhat_max": float(np.max(diag["rhat"])),
           "ess_w0": float(diag["ess_w0"]), "accept_rate": diag["accept_rate"],
           "accept_rate_overall": diag["accept_rate_overall"],
           "mean_n_evaluated": diag["mean_n_evaluated_overall"],
           "frac_evaluated": diag["mean_n_evaluated_overall"] / n, "rounds_tail": tail,
           "final_epsilon": diag["final_epsilon"], "final_batch_eff": diag["final_batch_eff"],
           "test_error": err}
    log(f"  wall time            : {wall:.1f}s "
        f"({chains * steps / wall:.0f} transitions/sec aggregate)")
    log(f"  split R-hat (max dim): {out['rhat_max']:.3f}")
    log(f"  total ESS of w[0]    : {out['ess_w0']:.0f}")
    log(f"  acceptance per chain : {np.round(diag['accept_rate'], 2)}")
    log(f"  sections evaluated   : {out['mean_n_evaluated']:.0f} / {n} "
        f"({out['frac_evaluated']:.1%} of data per transition)")
    log(f"  test rounds          : p50={tail['p50']:.0f} p99={tail['p99']:.0f} "
        f"max={tail['max']:.0f} (the lock-step engine would pay the max, per row)")
    log(f"  adapted epsilon      : {np.round(diag['final_epsilon'], 3)}")
    log(f"  adapted batch size   : {np.asarray(diag['final_batch_eff'], int)}")
    log(f"  posterior-mean test error: {err:.3f}")
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
