#!/usr/bin/env python3
"""Phase X of ``chip_smoke.py`` alone: the chains x data mesh on the card.

    python3 tools/phase_x.py          # from the repository root

Run on a machine with an NVIDIA card and ``nvcc``. It builds the kernels,
runs BayesLR at phase C's setting for C's first 200 steps (lock-step) and
K's 250 (masked) to stand for phases C and K, then ``chip_smoke.phase_x``:
each sharded run held bit for bit against its counterpart, the pair-delta
launches per slot, transitions/s sharded and unsharded, and X-fleet. It
prints the card's name and power limit first, ``PHASE_X_OK`` last, and
writes the phase's report to ``chiprun_out/phase_x.json``; a failed check
exits 1.
"""
import collections
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), HERE]


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.experiments import bayeslr
    from repro_torch.kernels import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    _build.build_all()
    data = bayeslr.synth_mnist_like(0)
    report = {"phases": collections.defaultdict(dict),
              "kernels": collections.defaultdict(lambda: {"launches": 0})}
    stand_ins = []
    for steps, kw in ((200, {}), (cs.K_STEPS, {"stepping": "masked"})):
        t0 = time.perf_counter()
        samples, _, _, infos = cs.bayeslr_ensemble(3, data, 32, steps, **kw)
        torch.cuda.synchronize()
        stand_ins.append((samples, infos, 32 * steps / (time.perf_counter() - t0)))
    try:
        cs.phase_x(report, data, *stand_ins)
    except cs.CheckFailed as e:
        print(f"phase_x: FAILED: {e}", file=sys.stderr)
        return 1
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "phase_x.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print("PHASE_X_OK")
    return 0


if __name__ == "__main__":
    from repro_torch.distributed import force_devices

    with force_devices(1):  # one slot, cuda:0, unless a run forces more (its @4cards layout)
        sys.exit(main())
