"""Ensemble-batched AR(1) transition-factor delta: the port of the Pallas
kernel ``repro.kernels.gaussian_ar1.batched_gaussian_ar1_delta`` and of the
gather XLA fuses in front of it.

A lock-step round of the stochastic-volatility phi / sigma^2 moves scores a
(K, m) block

    l[k, i] = log N(xt[k,i] | phi'_k xp[k,i], s2'_k) - log N(xt[k,i] | phi_k xp[k,i], s2_k)

with one (phi, s2, phi', s2') quadruple per chain. Both wrappers launch the
kernel of ``csrc/gaussian_ar1_delta.cu`` and count under
``"gaussian_ar1_delta"``:

  * :func:`batched_gaussian_ar1_delta` on gathered sections xt, xp (K, m);
  * :func:`gather_ar1_delta` on the pools with the section indices idx
    (K, m): shared (N,) pools or per-chain (K, N) pools, read in place; or
    on a contiguous run ``idx=range(start, stop)`` of shared (N,) pools, the
    exact transition's full pass, which the kernel reads with no index
    tensor.

One chain is the K = 1 case. ``round_bf16`` rounds fp32 pools to bf16 as the
kernel loads them (precision bf16 in one launch). The plain versions are
:func:`repro_torch.kernels.ref.batched_gaussian_ar1_delta_ref` and
:func:`repro_torch.kernels.ref.gather_ar1_delta_ref`.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .batched_loglik import _on_cuda
from .ref import batched_gaussian_ar1_delta_ref, check_range, gather_ar1_delta_ref

__all__ = ["batched_gaussian_ar1_delta", "gather_ar1_delta",
           "batched_gaussian_ar1_delta_ref", "gather_ar1_delta_ref"]

NAME = "gaussian_ar1_delta"
_XTYPES = (torch.float32, torch.bfloat16)
LAUNCH_CHOICES = (0, 1, 2, 4, 8)  # warps a block; 0: the default


@functools.cache
def _bind():
    fn = _build.load("gaussian_ar1_delta").ar1_pair_delta
    P, I, LL = _build.P, _build.I, _build.LL
    fn.argtypes = [P, P, I, I, P, LL, LL, P, P, P, P, P, I, I, I, P]
    fn.restype = I
    return fn


def _launch(xt, xp, idx, params, k: int, m: int, stride: int, first: int = 0,
            round_bf16: bool = False, warps: int = 0) -> torch.Tensor:
    """Chain k's pools start ``k * stride`` elements into xt, xp; its
    sections are ``idx[k]`` or, without idx, elements first .. first + m - 1.
    ``warps`` (1, 2, 4 or 8) overrides the warps a block; 0 keeps the
    source's choice, and every choice gives the same bits."""
    if warps not in LAUNCH_CHOICES:
        raise ValueError(f"warps must be one of {LAUNCH_CHOICES}; got {warps}")
    dev = xt.device
    for name, p in zip(("phi_cur", "s2_cur", "phi_prop", "s2_prop"), params):
        _build.require(p, name, dev, (torch.float32,), (k,))
    _build.require(xp, "xp", dev, (xt.dtype,), tuple(xt.shape))
    if round_bf16 and xt.dtype != torch.float32:
        raise TypeError("round_bf16 rounds fp32 pools; these are already bf16")
    out = torch.empty((k, m), dtype=torch.float32, device=dev)
    if k == 0 or m == 0:
        return out  # no sections: nothing to launch
    p = _build.ptr
    err = _build.launch(_bind(), xt.device,
        p(xt), p(xp), int(xt.dtype == torch.bfloat16), int(round_bf16), p(idx), stride, first,
        *(p(v) for v in params), p(out), k, m, int(warps), _build.stream_of(xt))
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return out


def batched_gaussian_ar1_delta(xt, xp, phi_cur, s2_cur, phi_prop, s2_prop, *,
                               round_bf16: bool = False, warps: int = 0) -> torch.Tensor:
    """xt, xp (K, m) f32 or bf16 gathered sections, parameters (K,) f32 ->
    (K, m) f32. ``warps`` overrides the launch (see :func:`_launch`)."""
    if not _on_cuda(xt, "batched_gaussian_ar1_delta"):
        return batched_gaussian_ar1_delta_ref(xt, xp, phi_cur, s2_cur, phi_prop, s2_prop)
    if xt.ndim != 2:
        raise ValueError(f"xt must be (K, m), got {tuple(xt.shape)}")
    k, m = xt.shape
    _build.require(xt, "xt", xt.device, _XTYPES, (k, m))
    return _launch(xt, xp, None, (phi_cur, s2_cur, phi_prop, s2_prop), k, m, m,
                   round_bf16=round_bf16, warps=warps)


def gather_ar1_delta(xt, xp, idx, phi_cur, s2_cur, phi_prop, s2_prop, *,
                     round_bf16: bool = False, warps: int = 0) -> torch.Tensor:
    """The same delta on sections ``idx`` (K, m) int32 of the pools xt, xp:
    (N,) shared by every chain or (K, N) one per chain -> (K, m) f32.
    Indices must lie in [0, N): the samplers clamp them. ``idx`` may instead
    be ``range(start, stop)`` of (N,) pools -> (1, stop - start)."""
    if not _on_cuda(xt, "gather_ar1_delta"):
        return gather_ar1_delta_ref(xt, xp, idx, phi_cur, s2_cur, phi_prop, s2_prop)
    params = (phi_cur, s2_cur, phi_prop, s2_prop)
    dev = xt.device
    if isinstance(idx, range):
        _build.require(xt, "xt", dev, _XTYPES, (None,))
        check_range(idx, xt.shape[0])
        return _launch(xt, xp, None, params, 1, len(idx), 0, first=idx.start,
                       round_bf16=round_bf16, warps=warps)
    if idx.ndim != 2:
        raise ValueError(f"idx must be (K, m), got {tuple(idx.shape)}")
    k, m = idx.shape
    _build.require(idx, "idx", dev, (torch.int32,), (k, m))
    if xt.ndim == 1:
        _build.require(xt, "xt", dev, _XTYPES, (None,))
        stride = 0
    else:
        _build.require(xt, "xt", dev, _XTYPES, (k, None))
        stride = xt.shape[1]
    return _launch(xt, xp, idx, params, k, m, stride, round_bf16=round_bf16, warps=warps)
