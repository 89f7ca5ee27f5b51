#!/usr/bin/env python3
"""Host rates of the unsharded BayesLR path under two source trees, in one
call, alternated (A, B, B, A, ...):

    python3 tools/ab_rates.py <tree A> <tree B> [rounds]

Run on a machine with an NVIDIA card and ``nvcc``; each tree is a checkout
(``git archive`` of a commit) holding ``src/`` and ``chip_smoke.py``. Every
measurement is a fresh process that imports only its tree: it builds the
kernels, runs 8 warm-up steps, then phase C's configuration (K=32,
lock-step, 200 steps) and phase K's (masked, 250 steps) through that tree's
``chip_smoke.bayeslr_ensemble``, and reports transitions/s summed over the
chains. Prints one JSON line per measurement and the card's name and power
limit first; ``rounds`` (default 2) is the number of A, B, B, A groups.
"""
import json
import os
import subprocess
import sys

WORKER = r"""
import json, sys, time
tree = sys.argv[1]
sys.path[:0] = [tree + "/src", tree]
import torch
import chip_smoke as cs
from repro_torch.experiments import bayeslr
from repro_torch.kernels import _build
_build.build_all()
data = bayeslr.synth_mnist_like(0)
cs.bayeslr_ensemble(3, data, 32, 8)
out = {}
for name, steps, kw in (("C", 200, {}), ("K", 250, {"stepping": "masked"})):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.bayeslr_ensemble(3, data, 32, steps, **kw)
    torch.cuda.synchronize()
    out[name] = 32 * steps / (time.perf_counter() - t0)
print(json.dumps(out))
"""


def main() -> int:
    a, b = (os.path.abspath(t) for t in sys.argv[1:3])
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for tree in [a, b, b, a] * rounds:
        done = subprocess.run([sys.executable, "-c", WORKER, tree], capture_output=True,
                              text=True, cwd=tree)
        if done.returncode != 0:
            print(done.stderr[-3000:], file=sys.stderr)
            return 1
        rates = json.loads(done.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": "A" if tree == a else "B", **rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
