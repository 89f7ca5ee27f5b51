#!/usr/bin/env python3
"""Where a step of the collapsed Gibbs sweep kernel spends its time.

    python3 tools/gibbs_step_probe.py

Run from the repository root on a machine with an NVIDIA H100 and ``nvcc``.
It builds variants of ``src/repro_torch/kernels/csrc/gibbs_z_sweep.cu`` into
``build/gibbs_probe/`` and times one sweep of each at the joint DP mixture's
main-path shape (K=8 replicas, N=10 000, K_max=20, P=5 000 steps, D=2), the
best of three after a warm-up, with CUDA events:

  V0  the source as it is;
  V1  lgamma forced inline (its bits are V0's);
  V2  the predictive's two lgammas replaced by a stub;
  V3  the whole predictive replaced by a stub;
  V4  fused multiply-adds allowed (nvcc without --fmad=false).

V2 and V3 compute something else; only their times mean anything. The
differences say what a step's dependent chain is made of.
"""
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))


def main() -> int:
    import torch

    from repro_torch.experiments import jointdpm
    from repro_torch.inference.niw import ClusterStats
    from repro_torch.kernels import _build, gibbs_z

    if not torch.cuda.is_available():
        print("gibbs_step_probe: no CUDA device", file=sys.stderr)
        return 2
    src = (_build.CSRC / "gibbs_z_sweep.cu").read_text()
    hdr = (_build.CSRC / "lgamma_xla.cuh").read_text()
    stub_lgamma = src.replace("lgamma_xla((df + (float)D) / 2.0f)", "((df + (float)D) * 0.5f)") \
        .replace("lgamma_xla(df / 2.0f)", "(df * 0.5f)")
    stub_pred = src.replace(
        "const float feat = predictive<D>(st.x, ct, sx, sxx, k0m0, s0, k0mm, k0, v0);",
        "const float feat = ct * 1e-3f;")
    inline = hdr.replace("__device__ float lgamma_xla(float inp)",
                         "__device__ __forceinline__ float lgamma_xla(float inp)")
    variants = [("V0 as it is", src, hdr, True), ("V1 lgamma inlined", src, inline, True),
                ("V2 lgamma a stub", stub_lgamma, hdr, True),
                ("V3 predictive a stub", stub_pred, hdr, True), ("V4 fmad on", src, hdr, False)]
    root = os.path.join(HERE, "build", "gibbs_probe")
    procs = []
    for i, (name, s, h, no_fmad) in enumerate(variants):
        d = os.path.join(root, f"v{i}")
        os.makedirs(d, exist_ok=True)
        open(os.path.join(d, "gibbs_z_sweep.cu"), "w").write(s)
        open(os.path.join(d, "lgamma_xla.cuh"), "w").write(h)
        flags = [f for f in _build.NVCC_FLAGS if no_fmad or f != "--fmad=false"]
        cmd = [_build._nvcc(), *flags, "-I", d, "-o", os.path.join(d, "lib.so"),
               os.path.join(d, "gibbs_z_sweep.cu")]
        procs.append((name, d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    for name, d, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1

    dev = torch.device("cuda")
    cfg = jointdpm.JDPMConfig()
    data = jointdpm.synth(60, 10_000, 1_000)
    gen = torch.Generator(device=dev).manual_seed(70)
    k, n, p = 8, 10_000, 5_000
    z = torch.randint(0, 3, (k, n), generator=gen, device=dev).to(torch.int32)
    w = torch.randn((k, cfg.k_max, cfg.d + 1), generator=gen, device=dev)
    stats = ClusterStats.from_assignments(data.x, z, cfg.k_max)
    la = torch.zeros(k, device=dev)
    keys = torch.rand((k, n), generator=gen, device=dev, dtype=torch.float64)
    points = torch.argsort(keys, dim=-1, stable=True)[:, :p].to(torch.int32).contiguous()
    nrm, u = gibbs_z.draw_sweep_randomness(gen, k, p, cfg.d, dev)
    prior = cfg.niw_prior(dev)
    z0 = None
    for name, d, _ in procs:
        fn = ctypes.CDLL(os.path.join(d, "lib.so")).gibbs_z_sweep
        P, I, FL = _build.P, _build.I, _build.FL
        fn.argtypes = [P, P, P, I, I, P, P, P, P, P, P, I, I, P, P, I, P, FL, FL, FL, P]
        fn.restype = I
        gibbs_z._bind = lambda fn=fn: fn  # the wrapper launches this variant
        times = []
        for _ in range(4):
            zk, wk = z.clone(), w.clone()
            sk = ClusterStats(*(s.clone() for s in stats))
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            gibbs_z.gibbs_z_sweep(data.x, data.y, zk, wk, la, sk, points, nrm, u, prior, 1.0)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        z0 = zk.clone() if z0 is None else z0
        ms = min(times[1:])
        print(f"{name}: sweep {ms:.3f} ms, {ms * 1e3 / p:.3f} us a step; z equal to V0's: "
              f"{bool(torch.equal(zk, z0))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
