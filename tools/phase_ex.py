#!/usr/bin/env python3
"""Phases C-pc, H-mala, H-mala-mp and EX of ``chip_smoke.py`` alone: the
per-chain logit pools against the shared pool, MALA over chatglm3-6b whole
and sharded on four slots of the card (bit for bit), and the five examples
as entry points at their full sizes.

    python3 tools/phase_ex.py          # from the repository root

Run on a machine with an NVIDIA card and ``nvcc``. It builds the kernels,
runs BayesLR at phase C's setting for C's first ``CPC_STEPS`` steps to stand
for phase C, then ``chip_smoke.phase_c_pc``; H-mala and H-mala-mp start from
the launcher's initial chatglm3-6b (random, seed 0) where ``chip_smoke.py``
starts from phase H's last sample; then ``chip_smoke.phase_ex``. It prints
the card's name and power limit first, each phase's seconds, and
``PHASE_EX_OK`` last, and writes the report to ``chiprun_out/phase_ex.json``;
a failed check exits 1.
"""
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), HERE]


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import ARCHS
    from repro_torch.experiments import bayeslr
    from repro_torch.kernels import _build, autotune
    from repro_torch.models import init_params

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    os.environ[autotune.DIR_ENV_VAR] = tempfile.mkdtemp(prefix="autotune_",
                                                        dir=os.path.join(HERE, "build"))
    os.environ[autotune.ENV_VAR] = "auto"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f}s")
    report = {"phases": collections.defaultdict(dict),
              "kernels": collections.defaultdict(lambda: {"launches": 0})}
    seconds = {}
    try:
        t0 = time.perf_counter()
        data = bayeslr.synth_mnist_like(0)
        samples, _, _, infos = cs.bayeslr_ensemble(3, data, 32, cs.CPC_STEPS)
        torch.cuda.synchronize()
        report["phases"]["C"]["transitions_per_s"] = (32 * cs.CPC_STEPS
                                                      / (time.perf_counter() - t0))
        cs.phase_c_pc(report, data, (samples, infos))
        seconds["C-pc"] = time.perf_counter() - t0
        cfg = ARCHS[cs.LM_ARCH]
        params = init_params(0, cfg)
        t0 = time.perf_counter()
        mala = cs.phase_h_mala(report, params, cfg)
        seconds["H-mala"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cs.phase_h_mala_mp(report, params, cfg, mala)
        seconds["H-mala-mp"] = time.perf_counter() - t0
        del params, mala
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cs.phase_ex(report)
        seconds["EX"] = time.perf_counter() - t0
        for phase, need in cs.EX_NEEDS.items():
            got = report["phases"][phase]["launches"]
            cs.check(all(got.get(n, 0) > 0 for n in need), f"phase {phase} went through {need}")
        print(f"  seconds taken by the phases: {seconds}")
        report["seconds"] = seconds
    except cs.CheckFailed as e:
        print(f"phase_ex: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "phase_ex.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    print("PHASE_EX_OK")
    return 0


if __name__ == "__main__":
    from repro_torch.distributed import force_devices

    with force_devices(1):  # one slot, cuda:0, unless a run forces more (its @4cards layout)
        sys.exit(main())
