"""Run one cell of the benchmark once, on the card of the machine it starts on.

    python3 mcmcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cells are the ``workloads`` of
``BENCHMARK.json``. Prints the compared numbers beside their limits as the
last lines of standard error and one JSON object as the last line of
standard output. Exits non-zero without a result where no card (or too
few) is present, where the port cannot be imported, or where a module of
JAX or of the JAX package is loaded.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from mcmcbench.lib import env

    env.prepare(ROOT)
    import torch

    from mcmcbench.lib import harness, spec

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the program: fails here without src/)

    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START)
    harness.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
