"""Logit pair delta for one chain: the port of the Pallas kernel
``repro.kernels.logit_loglik.logit_delta``.

l_i = log sig(y_i x_i.w') - log sig(y_i x_i.w), both sides from one read of
x. The CUDA source is ``csrc/logit_delta.cu``; its body serves the batched and
gathered forms in :mod:`repro_torch.kernels.batched_loglik` as well, with the
chain count K = 1 here. The plain version is
:func:`repro_torch.kernels.ref.logit_delta_ref`.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .ref import logit_delta_ref

__all__ = ["logit_delta", "logit_delta_ref", "launch_pair_delta"]

_XTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _bind():
    lib = _build.load("logit_delta")
    fn = lib.logit_pair_delta
    P, I = _build.P, _build.I
    fn.argtypes = [P, I, P, P, P, P, P, I, I, I, P]
    fn.restype = I
    return fn


def launch_pair_delta(x, y, idx, w_cur, w_prop, k: int, m: int, name: str) -> torch.Tensor:
    """Launch the pair-delta kernel: x is the (N, D) pool when ``idx`` (K, m)
    is given, else (K, m, D) rows; returns (K, m) fp32. Counts one launch
    under ``name``."""
    dev = x.device
    d = x.shape[-1]
    _build.require(w_cur, "w_cur", dev, (torch.float32,), (k, d))
    _build.require(w_prop, "w_prop", dev, (torch.float32,), (k, d))
    if idx is not None:
        _build.require(x, "x", dev, _XTYPES, (None, d))
        _build.require(y, "y", dev, (torch.float32,), (x.shape[0],))
        _build.require(idx, "idx", dev, (torch.int32,), (k, m))
    else:
        _build.require(x, "x", dev, _XTYPES, (k, m, d))
        _build.require(y, "y", dev, (torch.float32,), (k, m))
    out = torch.empty((k, m), dtype=torch.float32, device=dev)
    fn = _bind()
    err = fn(_build.ptr(x), int(x.dtype == torch.bfloat16), _build.ptr(y),
             _build.ptr(idx), _build.ptr(w_cur), _build.ptr(w_prop), _build.ptr(out),
             k, m, d, _build.stream_of(x))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def logit_delta(x: torch.Tensor, y: torch.Tensor, w_cur: torch.Tensor,
                w_prop: torch.Tensor, *, idx: torch.Tensor | None = None) -> torch.Tensor:
    """x (N, D) f32 or bf16, y (N,), w_* (D,) f32 -> (N,) f32; with ``idx``
    (m,) int32, only those rows of the pool -> (m,)."""
    if x.device.type == "cpu":
        if idx is not None:
            idx = idx.long()
            return logit_delta_ref(x[idx], y[idx], w_cur, w_prop)
        return logit_delta_ref(x, y, w_cur, w_prop)
    if x.device.type != "cuda":
        raise ValueError(f"logit_delta has no kernel for device {x.device}")
    if x.ndim != 2:
        raise ValueError(f"x must be (N, D), got {tuple(x.shape)}")
    m = x.shape[0] if idx is None else idx.shape[0]
    if idx is None:
        out = launch_pair_delta(x[None], y[None], None, w_cur[None], w_prop[None],
                                1, m, "logit_delta")
    else:
        out = launch_pair_delta(x, y, idx[None], w_cur[None], w_prop[None],
                                1, m, "logit_delta")
    return out[0]
