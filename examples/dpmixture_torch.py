"""Joint DP mixture of logistic experts (paper Sec. 4.2) on the port. The
counterpart of ``examples/dpmixture.py``.

CRP Gibbs for the assignments + MH for alpha + subsampled MH for each
expert's weights (the inference program of paper Fig. 7, top), expressed as
a composite cycle and run as K independent replicas on the ensemble engine:
one Gibbs-sweep launch, one alpha move and one lock-step sequential test a
w move for all replicas.

    PYTHONPATH=src python examples/dpmixture_torch.py                 # on the card
    PYTHONPATH=src python examples/dpmixture_torch.py --smoke --device cpu

Randomness: the data come from a ``torch.Generator`` seeded 0 and the run
(its initial state included) from one seeded 2, where the reference uses
``jax.random.key(0/2)``; the replicas share that one generator. So the
numbers match the reference's in distribution, not in bits. Beside the
reference's lines it prints the initial state's test accuracy, which the
reference's accuracy criterion (``tests/test_experiments.py:147-167``)
compares against. ``run(data=...)`` takes another data set (the
reference's, converted) in place of the seeded one.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch._device import make_generator, resolve_device, tree_map
from repro_torch.experiments import jointdpm
from repro_torch.kernels import ops


def sizes(smoke: bool) -> tuple[int, int, int, int, int]:
    """(N, N_test, replicas, cycles, w moves) of the smoke or full run."""
    return (800, 200, 2, 8, 5) if smoke else (4000, 1000, 4, 30, 10)


def run(smoke: bool = False, *, device=None, data: jointdpm.JDPMData | None = None,
        cycles: int | None = None, log=print) -> dict:
    """The example's run; returns the numbers it prints."""
    dev = resolve_device(device)
    cfg = jointdpm.JDPMConfig()
    n, n_test, replicas, n_cycles, w_moves = sizes(smoke)
    cycles = cycles or n_cycles
    if data is None:
        data = jointdpm.synth(0, n=n, n_test=n_test, device=dev)
    n = data.x.shape[0]

    log(ops.dispatch_summary())
    log(f"jointDPM N={n}: {replicas} replicas x {cycles} cycles of "
        f"(mh-alpha, gibbs-z, {w_moves} subsampled-mh-w moves)")
    gen = make_generator(2, dev)
    state0 = jointdpm.init_state(gen, jointdpm._on_device(data, dev), cfg)
    acc0 = jointdpm.accuracy(jointdpm.predict_proba(state0, data.x_test.to(dev), cfg),
                             data.y_test)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, samples, infos, diag = jointdpm.run_posterior_ensemble(
        gen, data, cfg, num_chains=replicas, num_cycles=cycles, state0=state0, device=dev,
        batch_size=100, epsilon=0.3, sigma_prop=0.3, w_moves=w_moves)
    wall = time.perf_counter() - t0

    # posterior-predictive accuracy of each replica's final state
    accs = []
    for k in range(replicas):
        st_k = tree_map(lambda l: l[k], state.theta)
        prob = jointdpm.predict_proba(st_k, data.x_test.to(dev), cfg)
        accs.append(jointdpm.accuracy(prob, data.y_test))
    out = {"n": n, "replicas": replicas, "cycles": cycles, "wall_s": wall,
           "cycles_per_s": replicas * cycles / wall, "accuracy_before": acc0,
           "accuracy": np.asarray(accs), "k_active_final": diag["k_active_final"],
           "w_accept_rate": diag["w_accept_rate"], "w_frac_evaluated": diag["w_frac_evaluated"]}
    log(f"  wall time          : {wall:.1f}s "
        f"({replicas * cycles / wall:.1f} cycles/sec aggregate)")
    log(f"  accuracy before    : {acc0:.3f} (the initial state)")
    log(f"  accuracy/replica   : {np.round(accs, 3)}")
    log(f"  active clusters    : {diag['k_active_final']}")
    log(f"  w accept rate      : {np.round(diag['w_accept_rate'], 2)}")
    log(f"  w sections touched : {diag['w_frac_evaluated']:.1%} of each expert's "
        f"members per move")
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
