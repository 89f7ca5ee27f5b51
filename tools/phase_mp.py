#!/usr/bin/env python3
"""Phases H, H-mp, T and T-mp of ``chip_smoke.py`` alone: the LM launcher
on chatglm3-6b at full size, the same chain with ``--model-parallel 2`` on
four slots of the card (a 2 x 2 mesh on cuda:0) held to it bit for bit, H's
checkpoint restored onto the mesh's pieces, then decoding from that
checkpoint whole (T) and sharded (T-mp), held to each other bit for bit.

    python3 tools/phase_mp.py          # from the repository root

Run on a machine with an NVIDIA card and ``nvcc`` (phase H's round op is a
CUDA kernel). It prints the card's name and power limit first, each phase's
seconds, and ``PHASE_MP_OK`` last, and writes the phases' report to
``chiprun_out/phase_mp.json``; a failed check exits 1. Disk: two 12 GB
checkpoints at a time (H's subsampled one and H-mp's, removed at once).
"""
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), HERE]


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f}s")
    report = {"phases": collections.defaultdict(dict),
              "kernels": collections.defaultdict(lambda: {"launches": 0})}
    root = tempfile.mkdtemp(prefix="phase_mp_")
    seconds = {}
    try:
        t0 = time.perf_counter()
        params, cfg, infos = cs.phase_h(report, root)
        seconds["H"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cs.phase_h_mp(report, root, params, infos)
        seconds["H-mp"] = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        t_out = cs.phase_t(report, os.path.join(root, "sub"))
        seconds["T"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cs.phase_t_mp(report, os.path.join(root, "sub"), t_out)
        seconds["T-mp"] = time.perf_counter() - t0
        print(f"  seconds taken by the phases: {seconds}")
        report["seconds"] = seconds
    except cs.CheckFailed as e:
        print(f"phase_mp: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "phase_mp.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    print("PHASE_MP_OK")
    return 0


if __name__ == "__main__":
    from repro_torch.distributed import force_devices

    with force_devices(1):  # one slot, cuda:0, unless a run forces more (its @4cards layout)
        sys.exit(main())
