#!/usr/bin/env python3
"""Phases U and H-adam of ``chip_smoke.py`` alone: the launch-parameter
tuner over a fresh cache, then the hybrid Adam-then-MH path (the ``100m``
preset of ``examples/lm_train_torch.py`` and one Adam step on chatglm3-6b at
full width cut to 2 layers).

    python3 tools/phase_hybrid.py          # from the repository root

Run on a machine with an NVIDIA card and ``nvcc``. It prints the card's name
and power limit first, each phase's seconds, and ``PHASE_HYBRID_OK`` last,
and writes the phases' report to ``chiprun_out/phase_hybrid.json``; a failed
check exits 1.
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
    from repro_torch.kernels import _build, autotune

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f}s")
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    os.environ[autotune.DIR_ENV_VAR] = tempfile.mkdtemp(prefix="autotune_",
                                                        dir=os.path.join(HERE, "build"))
    report = {"phases": collections.defaultdict(dict),
              "kernels": collections.defaultdict(lambda: {"launches": 0})}
    try:
        for name, phase in (("U", cs.phase_u), ("H-adam", cs.phase_h_adam)):
            t0 = time.perf_counter()
            phase(report)
            print(f"  seconds taken by phase {name}: {time.perf_counter() - t0:.1f}")
    except cs.CheckFailed as e:
        print(f"phase_hybrid: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "phase_hybrid.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    print("PHASE_HYBRID_OK")
    return 0


if __name__ == "__main__":
    from repro_torch.distributed import force_devices

    with force_devices(1):  # one slot, cuda:0, unless a run forces more (its @4cards layout)
        sys.exit(main())
