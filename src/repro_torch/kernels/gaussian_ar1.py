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
    (K, m): shared (N,) pools or per-chain (K, N) pools, read in place.

One chain is the K = 1 case. The plain versions are
:func:`repro_torch.kernels.ref.batched_gaussian_ar1_delta_ref` and
:func:`repro_torch.kernels.ref.gather_ar1_delta_ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .batched_loglik import _on_cuda
from .ref import batched_gaussian_ar1_delta_ref, gather_ar1_delta_ref

__all__ = ["batched_gaussian_ar1_delta", "gather_ar1_delta",
           "batched_gaussian_ar1_delta_ref", "gather_ar1_delta_ref"]

NAME = "gaussian_ar1_delta"
_XTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _bind():
    fn = _build.load("gaussian_ar1_delta").ar1_pair_delta
    P, I = _build.P, _build.I
    fn.argtypes = [P, P, I, P, ctypes.c_longlong, P, P, P, P, P, I, I, P]
    fn.restype = I
    return fn


def _launch(xt, xp, idx, params, k: int, m: int) -> torch.Tensor:
    dev = xt.device
    for name, p in zip(("phi_cur", "s2_cur", "phi_prop", "s2_prop"), params):
        _build.require(p, name, dev, (torch.float32,), (k,))
    if idx is None:
        _build.require(xt, "xt", dev, _XTYPES, (k, m))
        stride = 0
    else:
        _build.require(idx, "idx", dev, (torch.int32,), (k, m))
        if xt.ndim == 1:
            _build.require(xt, "xt", dev, _XTYPES, (None,))
            stride = 0
        else:
            _build.require(xt, "xt", dev, _XTYPES, (k, None))
            stride = xt.shape[1]
    _build.require(xp, "xp", dev, (xt.dtype,), tuple(xt.shape))
    out = torch.empty((k, m), dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _bind()(p(xt), p(xp), int(xt.dtype == torch.bfloat16), p(idx), stride,
                  *(p(v) for v in params), p(out), k, m, _build.stream_of(xt))
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return out


def batched_gaussian_ar1_delta(xt, xp, phi_cur, s2_cur, phi_prop, s2_prop) -> torch.Tensor:
    """xt, xp (K, m) f32 or bf16 gathered sections, parameters (K,) f32 ->
    (K, m) f32."""
    if not _on_cuda(xt, "batched_gaussian_ar1_delta"):
        return batched_gaussian_ar1_delta_ref(xt, xp, phi_cur, s2_cur, phi_prop, s2_prop)
    if xt.ndim != 2:
        raise ValueError(f"xt must be (K, m), got {tuple(xt.shape)}")
    k, m = xt.shape
    return _launch(xt, xp, None, (phi_cur, s2_cur, phi_prop, s2_prop), k, m)


def gather_ar1_delta(xt, xp, idx, phi_cur, s2_cur, phi_prop, s2_prop) -> torch.Tensor:
    """The same delta on sections ``idx`` (K, m) int32 of the pools xt, xp:
    (N,) shared by every chain or (K, N) one per chain -> (K, m) f32.
    Indices must lie in [0, N): the samplers clamp them."""
    if not _on_cuda(xt, "gather_ar1_delta"):
        return gather_ar1_delta_ref(xt, xp, idx, phi_cur, s2_cur, phi_prop, s2_prop)
    if idx.ndim != 2:
        raise ValueError(f"idx must be (K, m), got {tuple(idx.shape)}")
    k, m = idx.shape
    return _launch(xt, xp, idx, (phi_cur, s2_cur, phi_prop, s2_prop), k, m)
