#!/usr/bin/env python3
"""The family phases of ``chip_smoke.py`` alone: T-whisper, T-vlm, T-moe,
T-hybrid and H-moe on the card.

    python3 tools/phase_families.py [PHASE ...]   # from the repository root

With no argument all five run, in ``chip_smoke.py``'s order; otherwise the
named ones (e.g. ``T-moe H-moe``). Run on a machine with an NVIDIA card and
``nvcc`` (H-moe's subsampled steps launch the round op, so the kernels are
built first). It prints the card's name and power limit first, each phase's
seconds, and ``PHASE_FAMILIES_OK`` last, and writes the phases' report to
``chiprun_out/phase_families.json``; a failed check exits 1.
"""
import collections
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), HERE]


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    wanted = argv or list(cs.FAMILY_PHASES)
    unknown = set(wanted) - set(cs.FAMILY_PHASES)
    if unknown:
        print(f"phase_families: unknown phases {sorted(unknown)}; known: {cs.FAMILY_PHASES}",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    report = {"phases": collections.defaultdict(dict),
              "kernels": collections.defaultdict(lambda: {"launches": 0})}
    try:
        cs.family_phases(report, wanted)
        if "H-moe" in wanted:
            got = report["phases"]["H-moe"]["launches"]
            cs.check(got.get("t_test_round", 0) > 0, "phase H-moe went through t_test_round")
    except cs.CheckFailed as e:
        print(f"phase_families: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "phase_families.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    print("PHASE_FAMILIES_OK")
    return 0


if __name__ == "__main__":
    from repro_torch.distributed import force_devices

    with force_devices(1):  # one slot, cuda:0: the families run unsharded on any machine
        sys.exit(main(sys.argv[1:]))
