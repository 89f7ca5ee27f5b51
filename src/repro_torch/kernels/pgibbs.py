"""Fused particle-Gibbs sweep: every chain x series in one kernel.

The port of ``repro.kernels.pgibbs`` (``batched_pgibbs_sweep`` in
``mode="fast"`` and its single-chain wrapper ``pgibbs_sweep_fused``). One
conditional-SMC sweep (Andrieu et al. 2010) updates the retained latent
paths h (K, S, T) of K chains over S series at once: P particles per series,
slot 0 pinned to the retained path, conditional multinomial resampling by
inverse CDF, a final pick and the ancestral trace-back. The AR(1)
propagation and the particle weight are :func:`repro_torch.kernels.ref
.ar1_propagate` and :func:`repro_torch.kernels.ref.sv_obs_loglik`, the same
definitions the MH moves score with.

The wrapper draws every random number from the caller's ``torch.Generator``
(normals (T, K, S, P), then uniforms (T, K, S, P), then one final-pick
uniform per (chain, series)) and hands them to the kernel
(``csrc/pgibbs_sweep.cu``) or to the plain version :func:`pgibbs_sweep_ref`,
so the two are comparable value for value. The reference's final pick is
Gumbel-max (``jax.random.categorical``); the inverse-CDF pick from one
uniform draws from the same distribution.

``mode="compat"`` of the reference reproduces JAX's threefry key stream bit
for bit; PyTorch's generators cannot give those bits, so here it raises.
"""
from __future__ import annotations

import functools

import torch

from . import _build, ops
from .ref import ar1_propagate, lane_order_cdf, sv_obs_loglik

NAME = "pgibbs_sweep"
MODES = ("fast", "compat")
MAX_PARTICLES = 256  # the kernel keeps P / 32 particles per lane in registers
SMEM_BYTES = 227 * 1024  # shared memory a block may use
COMPAT_REASON = (
    "mode='compat' reproduces JAX's threefry key stream bit for bit; "
    "PyTorch's generators cannot give those bits (use mode='fast')"
)

__all__ = ["batched_pgibbs_sweep", "pgibbs_sweep_fused", "pgibbs_sweep", "pgibbs_sweep_ref",
           "draw_sweep_randomness"]


def draw_sweep_randomness(gen: torch.Generator, k: int, s: int, t_len: int, p: int, device):
    """The sweep's random numbers, in the order the generator gives them:
    noise (T, K, S, P) standard normal, u (T, K, S, P) and u_pick (K, S)
    uniform on [0, 1)."""
    noise = torch.randn((t_len, k, s, p), generator=gen, device=device)
    u = torch.rand((t_len, k, s, p), generator=gen, device=device)
    u_pick = torch.rand((k, s), generator=gen, device=device)
    return noise, u, u_pick


def pgibbs_sweep_ref(noise, u, u_pick, obs, h, phi, s2, h0: float = 0.0) -> torch.Tensor:
    """Plain version of :func:`pgibbs_sweep`: a loop over T of (K, S, P)
    tensor steps, then the trace-back."""
    k, s, t_len = h.shape
    p = noise.shape[-1]
    phi_b, s2_b = phi.reshape(k, 1, 1), s2.reshape(k, 1, 1)
    h_prev = torch.full((k, s, p), h0, dtype=torch.float32, device=h.device)
    hs, ancs = [], []
    cdf = None
    for t in range(t_len):
        h_t = ar1_propagate(h_prev, noise[t], phi_b, s2_b)
        h_t = torch.cat([h[:, :, t, None], h_t[..., 1:]], dim=-1)  # the retained particle
        logw = sv_obs_loglik(obs[None, :, t, None], h_t)
        cdf = lane_order_cdf(logw)
        anc = torch.clamp_max(torch.searchsorted(cdf, u[t].contiguous()), p - 1)
        anc[..., 0] = 0
        hs.append(h_t)
        ancs.append(anc)
        h_prev = h_t.gather(-1, anc)
    b = torch.clamp_max(torch.searchsorted(cdf, u_pick[..., None].contiguous()), p - 1)
    out = [None] * t_len
    for t in range(t_len - 1, -1, -1):
        out[t] = hs[t].gather(-1, b)
        if t > 0:
            b = ancs[t - 1].gather(-1, b)
    return torch.cat(out, dim=-1)


@functools.cache
def _bind():
    fn = _build.load("pgibbs_sweep").pgibbs_sweep
    P, I = _build.P, _build.I
    fn.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, _build.FL, P]
    fn.restype = I
    return fn


def pgibbs_sweep(noise, u, u_pick, obs, h, phi, s2, h0: float = 0.0) -> torch.Tensor:
    """One sweep from given random numbers: obs (S, T), h (K, S, T), phi and
    s2 (K,), noise and u (T, K, S, P), u_pick (K, S), all float32 ->
    new paths (K, S, T). Launches the kernel on CUDA tensors (the plain
    version on CPU tensors)."""
    if h.device.type == "cpu":
        return pgibbs_sweep_ref(noise, u, u_pick, obs, h, phi, s2, h0)
    if h.device.type != "cuda":
        raise ValueError(f"pgibbs_sweep has no kernel for device {h.device}")
    k, s, t_len = h.shape
    p = noise.shape[-1]
    if not 1 <= p <= MAX_PARTICLES:
        raise ValueError(f"the sweep kernel takes 1 .. {MAX_PARTICLES} particles, got {p}")
    if k * s * 32 > 2 ** 31 - 1:
        raise ValueError(f"the sweep kernel indexes K x S = {k * s} series in 32 bits")
    n2 = 1 << (p - 1).bit_length()  # particle slots a series
    if (32 // min(n2, 32)) * (2 * t_len * n2 + 3 * n2 + 2) * 4 > SMEM_BYTES:
        raise ValueError(f"T={t_len} x P={p} does not fit one warp's shared memory")
    dev, f32 = h.device, (torch.float32,)
    _build.require(obs, "obs", dev, f32, (s, t_len))
    _build.require(h, "h", dev, f32, (k, s, t_len))
    _build.require(phi, "phi", dev, f32, (k,))
    _build.require(s2, "s2", dev, f32, (k,))
    _build.require(noise, "noise", dev, f32, (t_len, k, s, p))
    _build.require(u, "u", dev, f32, (t_len, k, s, p))
    _build.require(u_pick, "u_pick", dev, f32, (k, s))
    out = torch.empty((k, s, t_len), dtype=torch.float32, device=dev)
    q = _build.ptr
    err = _build.launch(_bind(), h.device,
        q(obs), q(h), q(phi), q(s2), q(noise), q(u), q(u_pick), q(out), k, s, t_len, p, float(h0),
        _build.stream_of(h))
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return out


def batched_pgibbs_sweep(gen: torch.Generator, obs, h, phi, s2, *, num_particles: int,
                         mode: str = "fast", h0: float = 0.0,
                         fused_kernels: str = "auto") -> torch.Tensor:
    """One conditional-SMC sweep for all K chains' S series at once.

    obs (S, T) shared by the chains, h (K, S, T) retained paths, phi and s2
    (K,) -> new paths (K, S, T). ``fused_kernels`` is the kernel dispatch
    (``auto`` | ``always`` | ``never``). The particle weight is the
    stochastic-volatility observation factor (the reference's default
    ``obs_logpdf``, the one the kernel computes).
    """
    if mode not in MODES:
        raise ValueError(f"unknown pgibbs mode {mode!r}; expected one of {MODES}")
    if mode == "compat":
        raise NotImplementedError(COMPAT_REASON)
    k, s, t_len = h.shape
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=h.device).reshape(k)
    phi, s2 = f32(phi), f32(s2)
    noise, u, u_pick = draw_sweep_randomness(gen, k, s, t_len, num_particles, h.device)
    obs, h = obs.to(torch.float32).contiguous(), h.to(torch.float32).contiguous()
    return ops.pgibbs_sweep(noise, u, u_pick, obs, h, phi, s2, h0=h0, mode=fused_kernels)


def pgibbs_sweep_fused(gen: torch.Generator, obs, h, phi, s2, *, num_particles: int,
                       mode: str = "fast", h0: float = 0.0,
                       fused_kernels: str = "auto") -> torch.Tensor:
    """Single-chain wrapper over :func:`batched_pgibbs_sweep` (K = 1): equal
    to ``batched_pgibbs_sweep(gen, obs, h[None], ...)[0]`` by construction,
    which keeps the sequential cycle and the K-chain ensemble comparable."""
    return batched_pgibbs_sweep(gen, obs, h[None], torch.as_tensor(phi).reshape(1),
                                torch.as_tensor(s2).reshape(1), num_particles=num_particles,
                                mode=mode, h0=h0,
                                fused_kernels=fused_kernels)[0]
