#!/usr/bin/env python3
"""Host rates of the unsharded BayesLR path under two source trees, in one
call, alternated (A, B, B, A, ...):

    python3 tools/ab_rates.py <tree A> <tree B> [rounds]

Run on a machine with an NVIDIA card and ``nvcc``; each tree is a checkout
(``git archive`` of a commit) holding ``src/`` and ``chip_smoke.py``. Every
measurement is a fresh process that imports only its tree: it builds the
kernels, warms up each configuration (8 ensemble steps of each stepping, 20
steps of one chain: a tree with the launch-parameter tuner races its buckets
there, in a fresh cache under the tree's ``build/``), then runs phase B's
configuration (one chain, 300 steps), phase C's (K=32, lock-step, 200 steps)
and phase K's (masked, 250 steps) through that tree's entry points, and
reports transitions/s summed over the chains. It also times the pair delta's
default launch (the kernel wrapper with no launch argument) at B's and C's
rounds, fp32: device µs by CUDA events over 200 launches queued behind a
sleep kernel, best of three. Prints one JSON line per measurement and the
card's name and power limit first; ``rounds`` (default 2) is the number of
A, B, B, A groups.
"""
import json
import os
import subprocess
import sys

WORKER = r"""
import json, os, sys, tempfile, time
tree = sys.argv[1]
sys.path[:0] = [tree + "/src", tree]
os.makedirs(tree + "/build", exist_ok=True)
os.environ["REPRO_AUTOTUNE_DIR"] = tempfile.mkdtemp(prefix="autotune_", dir=tree + "/build")
import torch
import chip_smoke as cs
from repro_torch.core import RandomWalk, SubsampledMHConfig, run_chain
from repro_torch.experiments import bayeslr
from repro_torch.kernels import _build, batched_loglik, logit_loglik
_build.build_all()
data = bayeslr.synth_mnist_like(0)
dev = torch.device("cuda")
target = bayeslr.make_target(data.x_train, data.y_train)
cfg = SubsampledMHConfig(batch_size=100, epsilon=0.05, sampler="stream")
theta0 = torch.zeros(data.x_train.shape[1])
chain = lambda steps: run_chain(1, theta0, target, RandomWalk(0.05), steps, config=cfg)
cs.bayeslr_ensemble(3, data, 32, 8)
cs.bayeslr_ensemble(3, data, 32, 8, stepping="masked")
chain(20)
out = {}
torch.cuda.synchronize()
t0 = time.perf_counter()
chain(300)
torch.cuda.synchronize()
out["B"] = 300 / (time.perf_counter() - t0)
for name, steps, kw in (("C", 200, {}), ("K", 250, {"stepping": "masked"})):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.bayeslr_ensemble(3, data, 32, steps, **kw)
    torch.cuda.synchronize()
    out[name] = 32 * steps / (time.perf_counter() - t0)


def device_us(fn, reps=200):
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) * 1e3 / reps)
    return best


g = torch.Generator(device=dev).manual_seed(0)
x, y = data.x_train.to(dev), data.y_train.to(dev).float()
w = torch.randn(32, x.shape[1], generator=g, device=dev)
wp = w + 0.01
idx = torch.randint(0, x.shape[0], (32, 100), generator=g, device=dev, dtype=torch.int32)
out["C_delta_us"] = device_us(lambda: batched_loglik.gather_and_delta(x, y, idx, w, wp))
out["B_delta_us"] = device_us(lambda: logit_loglik.logit_delta(x, y, w[0], w[1], idx=idx[0]))
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
