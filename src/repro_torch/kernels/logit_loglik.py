"""Logit pair delta for one chain: the port of the Pallas kernel
``repro.kernels.logit_loglik.logit_delta``.

l_i = log sig(y_i x_i.w') - log sig(y_i x_i.w), both sides from one read of
x. The CUDA source is ``csrc/logit_delta.cu``; its body serves the batched and
gathered forms in :mod:`repro_torch.kernels.batched_loglik` as well, with the
chain count K = 1 here. The plain version is
:func:`repro_torch.kernels.ref.logit_delta_ref`.

Rows are the whole pool, rows ``idx`` of it (an int32 tensor), or a
contiguous run ``idx=range(start, stop)``: the exact transition's full pass,
which the kernel reads with no index tensor.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .ref import check_range, logit_delta_ref

__all__ = ["logit_delta", "logit_delta_ref", "launch_pair_delta", "select_rows"]

_XTYPES = (torch.float32, torch.bfloat16)
LAUNCH_CHOICES = (0, 1, 2, 4, 8)  # warps a block; 0: the default


@functools.cache
def _bind(any_warps: bool = False):
    """The default launch's entry point, or (``any_warps``) the twin library's,
    which takes the warps a block as a last argument."""
    P, I = _build.P, _build.I
    if any_warps:
        fn = _build.load("logit_delta_warps").logit_pair_delta_warps
        fn.argtypes = [P, I, P, P, P, P, P, I, I, I, _build.LL, I, P, I]
    else:
        fn = _build.load("logit_delta").logit_pair_delta
        fn.argtypes = [P, I, P, P, P, P, P, I, I, I, _build.LL, I, P]
    fn.restype = I
    return fn


def select_rows(x: torch.Tensor, y: torch.Tensor, idx):
    """Rows ``idx`` of the pool (x (N, D), y (N,)): an int tensor gathers,
    a ``range`` slices; ``None`` is the whole pool."""
    if idx is None:
        return x, y
    if isinstance(idx, range):
        check_range(idx, x.shape[0])
        return x[idx.start:idx.stop], y[idx.start:idx.stop]
    idx = idx.long()
    return x[idx], y[idx]


def launch_pair_delta(x, y, idx, w_cur, w_prop, k: int, m: int, name: str, *,
                      first: int = 0, round_bf16: bool = False, warps: int = 0) -> torch.Tensor:
    """Launch the pair-delta kernel; returns (K, m) fp32 and counts one
    launch under ``name`` (none for an empty block). With ``idx`` (K, m)
    int32, x is the (N, D) pool and y (N,). Without it the rows are
    contiguous: chain k's row r is row ``first + k m + r`` of x, which is
    the (N, D) pool with y (N,) (K = 1) or the (K, m, D) slab with y (K, m)
    (``first`` = 0). ``round_bf16`` rounds w, w' and fp32 x to bf16 in the
    kernel. ``warps`` (1, 2, 4 or 8) overrides the launch's warps a block
    through ``csrc/logit_delta_warps.cu``; 0 keeps the default launch, and
    every choice gives the same bits (see ``csrc/logit_delta.cu``)."""
    if warps not in LAUNCH_CHOICES:
        raise ValueError(f"warps must be one of {LAUNCH_CHOICES}; got {warps}")
    dev = x.device
    d = x.shape[-1]
    _build.require(w_cur, "w_cur", dev, (torch.float32,), (k, d))
    _build.require(w_prop, "w_prop", dev, (torch.float32,), (k, d))
    if idx is not None:
        _build.require(x, "x", dev, _XTYPES, (None, d))
        _build.require(y, "y", dev, (torch.float32,), (x.shape[0],))
        _build.require(idx, "idx", dev, (torch.int32,), (k, m))
    elif x.ndim == 3:
        _build.require(x, "x", dev, _XTYPES, (k, m, d))
        _build.require(y, "y", dev, (torch.float32,), (k, m))
    else:
        _build.require(x, "x", dev, _XTYPES, (None, d))
        _build.require(y, "y", dev, (torch.float32,), (x.shape[0],))
        if k != 1 or not 0 <= first <= first + m <= x.shape[0]:
            raise ValueError(f"rows [{first}, {first + m}) of one chain must lie in the pool "
                             f"of {x.shape[0]} rows")
    out = torch.empty((k, m), dtype=torch.float32, device=dev)
    if k == 0 or m == 0:
        return out  # no rows: nothing to launch
    args = (_build.ptr(x), int(x.dtype == torch.bfloat16), _build.ptr(y), _build.ptr(idx),
            _build.ptr(w_cur), _build.ptr(w_prop), _build.ptr(out), k, m, d, first,
            int(round_bf16), _build.stream_of(x))
    err = (_build.launch(_bind(True), dev, *args, int(warps)) if warps
           else _build.launch(_bind(), dev, *args))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def logit_delta(x: torch.Tensor, y: torch.Tensor, w_cur: torch.Tensor,
                w_prop: torch.Tensor, *, idx=None, round_bf16: bool = False,
                warps: int = 0) -> torch.Tensor:
    """x (N, D) f32 or bf16, y (N,), w_* (D,) f32 -> (N,) f32; with ``idx``
    (m,) int32, or ``range(start, stop)``, only those rows of the pool ->
    (m,). ``round_bf16`` (kernel only) rounds w, w' and fp32 x to bf16;
    ``warps`` as in :func:`launch_pair_delta`."""
    if x.device.type == "cpu":
        return logit_delta_ref(*select_rows(x, y, idx), w_cur, w_prop)
    if x.device.type != "cuda":
        raise ValueError(f"logit_delta has no kernel for device {x.device}")
    if x.ndim != 2:
        raise ValueError(f"x must be (N, D), got {tuple(x.shape)}")
    first = 0
    if isinstance(idx, range):
        check_range(idx, x.shape[0])
        first, m, idx = idx.start, len(idx), None
    else:
        m = x.shape[0] if idx is None else idx.shape[0]
    out = launch_pair_delta(x, y, None if idx is None else idx[None], w_cur[None], w_prop[None],
                            1, m, "logit_delta", first=first, round_bf16=round_bf16,
                            warps=warps)
    return out[0]
