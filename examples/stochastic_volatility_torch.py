"""Stochastic volatility on the port: joint state and parameter estimation
(paper Sec 4.3). The counterpart of ``examples/stochastic_volatility.py``.

Particle Gibbs (conditional SMC) samples the latent log-volatility paths;
subsampled MH samples (phi, sigma^2) with *dependent* local sections (the
h-transition factors). The program (a particle-Gibbs sweep cycled with the
two parameter moves) runs as a composite cycle on the ensemble engine: the
sweep is one ``pgibbs_sweep`` launch for every chain, and the parameter
moves' rounds score (K, m) blocks through the ``gaussian_ar1`` kernel.

    PYTHONPATH=src python examples/stochastic_volatility_torch.py                 # on the card
    PYTHONPATH=src python examples/stochastic_volatility_torch.py --smoke --device cpu

Randomness: the data come from a ``torch.Generator`` seeded 0 and the chains
from one seeded 1, where the reference uses ``jax.random.key(0/1)``; the
chains share that one generator. So the numbers match the reference's in
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
from repro_torch.experiments import stochvol
from repro_torch.kernels import ops

TRUE_PHI, TRUE_SIGMA = 0.95, 0.1


def sizes(smoke: bool) -> tuple[int, int, int, int, int]:
    """(series, length, chains, cycles, particles) of the smoke or full run."""
    return (60, 5, 2, 60, 10) if smoke else (200, 5, 4, 400, 25)


def run(smoke: bool = False, *, device=None, data: stochvol.SVData | None = None,
        cycles: int | None = None, log=print) -> dict:
    """The example's run; returns the numbers it prints."""
    dev = resolve_device(device)
    series, length, chains, n_cycles, particles = sizes(smoke)
    iters = cycles or n_cycles
    if data is None:
        data = stochvol.synth(0, num_series=series, length=length, phi=TRUE_PHI,
                              sigma=TRUE_SIGMA, device=dev)
    series, length = data.obs.shape
    n = data.obs.numel()

    log(ops.dispatch_summary() + f" sweep={stochvol.resolve_sweep()}")
    log(f"stochvol S={series} T={length} ({n} transition factors): "
        f"{chains} chains x {iters} cycles of (pgibbs, mh-phi, mh-sigma2)")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, samples, infos, diag = stochvol.run_posterior_ensemble(
        1, data, num_chains=chains, num_steps=iters, device=dev,
        batch_size=100, epsilon=0.01, num_particles=particles)
    wall = time.perf_counter() - t0

    burn = iters // 3
    phis = samples["phi"].cpu().numpy()[:, burn:]
    sigmas = np.sqrt(samples["sigma2"].cpu().numpy()[:, burn:])
    frac = diag["frac_evaluated"]
    out = {"series": series, "length": length, "chains": chains, "cycles": iters,
           "wall_s": wall, "cycles_per_s": chains * iters / wall,
           "phi_mean": float(phis.mean()), "phi_std": float(phis.std()),
           "sigma_mean": float(sigmas.mean()), "sigma_std": float(sigmas.std()),
           "rhat_phi": float(diag["rhat_phi"]), "rhat_sigma2": float(diag["rhat_sigma2"]),
           "frac_evaluated": frac, "accept_rate": diag["accept_rate"]}
    log(f"  wall time        : {wall:.1f}s "
        f"({chains * iters / wall:.0f} cycles/sec aggregate)")
    log(f"  posterior phi    : {phis.mean():.3f} ± {phis.std():.3f} (true {TRUE_PHI})")
    log(f"  posterior sigma  : {sigmas.mean():.3f} ± {sigmas.std():.3f} (true {TRUE_SIGMA})")
    log(f"  split R-hat      : phi={out['rhat_phi']:.3f} sigma2={out['rhat_sigma2']:.3f}")
    log(f"  sections touched : phi={frac['phi']:.1%} sigma2={frac['sigma2']:.1%} "
        f"of {n} transition factors per move")
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
