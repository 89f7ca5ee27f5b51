#!/usr/bin/env python3
"""Where a step of the collapsed Gibbs sweep kernel spends its time.

    git show <commit>:src/repro_torch/kernels/csrc/gibbs_z_sweep.cu \\
        > build/gibbs_probe/parent.cu    # the kernel to compare against
    python3 tools/gibbs_step_probe.py

Run from the repository root on a machine with an NVIDIA H100 and ``nvcc``.
It builds variants of ``src/repro_torch/kernels/csrc/gibbs_z_sweep.cu`` into
``build/gibbs_probe/`` and times one sweep of each at the joint DP mixture's
main-path shape (K=8 replicas, N=10 000, K_max=20, P=5 000 steps, D=2; and
K=1 for the first two), the best of four after a warm-up, with CUDA events,
the variants in turns (parent, new, the stubs, new, parent):

  parent   ``build/gibbs_probe/parent.cu``, the kernel before the redesign
           (one warp recomputing every cluster's whole predictive at every
           step, then the pick), kept there for this comparison (an earlier
           commit's source; the step above makes it);
  new      the source as it is;
  pick     the pick chain alone: the speculated work a stub (the predictive
           of warps 1-2 and the label terms of warp 3 replaced by one
           multiply-add each), so warp 0's chain and the hand-overs set the
           pace;
  spec     the speculated chain alone: warp 0's pick replaced by a pick from
           the uniform alone, so warps 1-3 and the hand-overs set the pace;
  ieee     the new kernel with the speculated chain on '/' and sqrtf (their
           branches to the slow paths included) instead of the fast paths;
  handover both stubs: the barriers, the exchange through shared memory and
           the loop, with next to no work between them.

The stubs compute something else; only their times mean anything. "new" and
"ieee" must give the parent's z, w and statistics bit for bit, which the
script checks. Every replacement must match the source exactly once, or the
script stops: a stub that matched nothing would time the unchanged kernel
under a false name. Results go to stdout and ``chiprun_out/gibbs_probe.json``.
"""
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
PARENT = os.path.join(HERE, "build", "gibbs_probe", "parent.cu")

STUB_PREDICTIVE = ("      const float feat = predictive<D>(var, xs, pr, tab, tmax);\n",
                   "      const float feat = var.ct * 1e-3f + xs[0];\n")
STUB_LABEL = ("  return -(fmaxf(arg, 0.0f) + log1pf(expf(-fabsf(arg))));\n",
              "  return arg * 1e-3f;\n")
STUB_PICK = ("      const int knew = pick(logp, own, u);\n",
             "      const int knew = min((int)(u * (float)kmax), kmax - 1);\n")
IEEE = (("    state_of<D, true>(s, pr, tn, o, ok);\n", "    state_of<D, false>(s, pr, tn, o, ok);\n"),
        ("    feat = tail_of<D, true>(o, xi, ok);\n", "    feat = tail_of<D, false>(o, xi, ok);\n"))


def replaced(src: str, *pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"gibbs_step_probe: {old.strip()!r} matches {src.count(old)} times "
                             "in the source, not once")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch

    from repro_torch.experiments import jointdpm
    from repro_torch.inference.niw import ClusterStats
    from repro_torch.kernels import _build, gibbs_z

    if not torch.cuda.is_available():
        print("gibbs_step_probe: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.exists(PARENT):
        print(f"gibbs_step_probe: {PARENT} is missing (see the docstring)", file=sys.stderr)
        return 2
    src = (_build.CSRC / "gibbs_z_sweep.cu").read_text()
    hdr = (_build.CSRC / "lgamma_xla.cuh").read_text()
    variants = {"parent": open(PARENT).read(), "new": src,
                "pick": replaced(src, STUB_PREDICTIVE, STUB_LABEL),
                "spec": replaced(src, STUB_PICK), "ieee": replaced(src, *IEEE),
                "handover": replaced(src, STUB_PREDICTIVE, STUB_LABEL, STUB_PICK)}
    root = os.path.join(HERE, "build", "gibbs_probe")
    procs = {}
    for name, s in variants.items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        open(os.path.join(d, "gibbs_z_sweep.cu"), "w").write(s)
        open(os.path.join(d, "lgamma_xla.cuh"), "w").write(hdr)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", d, "-o", os.path.join(d, "lib.so"),
               os.path.join(d, "gibbs_z_sweep.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        lines = log.splitlines()
        info = [lines[i + 1].strip() + "; " + lines[i + 2].split(":")[-1].strip()
                for i, l in enumerate(lines[:-2])
                if "Function properties" in l and "sweep_kernelILi2E" in l]
        print(f"{name}: {info[0] if info else ''}")
        fn = ctypes.CDLL(os.path.join(d, "lib.so")).gibbs_z_sweep
        P, I, FL = _build.P, _build.I, _build.FL
        fn.argtypes = [P, P, P, I, I, P, P, P, P, P, P, I, I, P, P, I, P, FL, FL, FL, P]
        fn.restype = I
        fns[name] = fn

    dev = torch.device("cuda")
    cfg = jointdpm.JDPMConfig()
    data = jointdpm.synth(60, 10_000, 1_000)
    prior = cfg.niw_prior(dev)
    n, p = 10_000, 5_000
    cases = {}
    for k in (8, 1):
        gen = torch.Generator(device=dev).manual_seed(70 + k)
        z = torch.randint(0, 3, (k, n), generator=gen, device=dev).to(torch.int32)
        w = torch.randn((k, cfg.k_max, cfg.d + 1), generator=gen, device=dev)
        stats = ClusterStats.from_assignments(data.x, z, cfg.k_max)
        la = torch.zeros(k, device=dev)
        keys = torch.rand((k, n), generator=gen, device=dev, dtype=torch.float64)
        points = torch.argsort(keys, dim=-1, stable=True)[:, :p].to(torch.int32).contiguous()
        nrm, u = gibbs_z.draw_sweep_randomness(gen, k, p, cfg.d, dev)
        cases[k] = (z, w, la, stats, points, nrm, u)

    def sweep(name, k):
        z, w, la, stats, points, nrm, u = cases[k]
        gibbs_z._bind = lambda fn=fns[name]: fn  # the wrapper launches this variant
        times = []
        for _ in range(5):
            zk, wk = z.clone(), w.clone()
            sk = ClusterStats(*(s.clone() for s in stats))
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            gibbs_z.gibbs_z_sweep(data.x, data.y, zk, wk, la, sk, points, nrm, u, prior, 1.0)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return min(times[1:]), (zk, wk, *sk)

    order = [("parent", 8), ("new", 8), ("pick", 8), ("spec", 8), ("ieee", 8), ("handover", 8),
             ("new", 8), ("parent", 8), ("parent", 1), ("new", 1), ("new", 1), ("parent", 1)]
    best, outs = {}, {}
    for name, k in order:
        ms, out = sweep(name, k)
        best[(name, k)] = min(ms, best.get((name, k), ms))
        outs[(name, k)] = out
    rows = []
    for (name, k), ms in best.items():
        same = None
        if name in ("new", "ieee"):
            same = all(torch.equal(a, b) for a, b in zip(outs[(name, k)], outs[("parent", k)]))
        rows.append({"variant": name, "K": k, "sweep_ms": ms, "step_us": ms * 1e3 / p,
                     "bits_equal_parent": same})
        print(f"{name} K={k}: sweep {ms:.3f} ms, {ms * 1e3 / p:.4f} us a step"
              + ("" if same is None else f"; z, w and statistics equal to the parent's: {same}"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "gibbs_probe.json"), "w") as f:
        json.dump({"card": card, "shape": {"N": n, "P": p, "K_max": cfg.k_max, "D": cfg.d},
                   "rows": rows}, f, indent=1)
    bad = [r for r in rows if r["bits_equal_parent"] is False]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
