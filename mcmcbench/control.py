"""The control of a cell: its reference computed in the precision below the
configuration's, put in the program's place, on several seeds; each of the
cell's compared numbers printed beside its limit. The control must come out
as not correct. Not run by the benchmark's own runs.

    python3 mcmcbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 5]
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from mcmcbench.lib import env

    env.prepare(ROOT)
    import torch

    from mcmcbench.lib import harness, spec

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    driver = spec.driver_module(cell.driver)
    limits = harness.load_limits(cell.name)
    for seed in (int(s) for s in args.seeds.split(",")):
        values = driver.control(cell, seed, torch.device("cuda", 0), args.seconds)
        failed = [k for k, lim in limits.items() if not values[k] <= lim["limit"]]
        print(json.dumps({"seed": seed, "correct": not failed, "failed": failed,
                          "values": values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
