"""One round of the partial Fisher–Yates draw for K chains, as one kernel.

The port of the ``fori_loop`` in ``repro.core.samplers.fy_draw``: m swap
steps over each chain's persistent (capacity,) int32 index buffer, then the
round's m indices, their valid flags and the new position. The buffer is
updated in place; chains that are not ``active`` leave it untouched (the
lock-step rule). The uniforms (K, m) float64 come from the caller's
generator, so kernel and plain version give identical indices for the same
uniforms. An optional per-chain ``m_eff`` (the adaptive scheduler's
effective batch, ``repro.core.samplers.fy_draw_bounded``) leaves the swaps
and indices as they are, flags lanes ``s >= m_eff`` invalid and advances
the position by ``m_eff`` instead of ``m``.

  u (K, m) f64   idx (K, cap) int32   pos, size (K,) int32   active (K,) bool | None
  m_eff (K,) int32 in [0, m] | None
  -> out (K, m) int32, valid (K, m) bool, new_pos (K,) int32

The CUDA source is ``csrc/fy_draw.cu``; :func:`fy_draw_ref` is the plain
version. On a CPU tensor the wrapper runs the plain version; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

NAME = "fy_draw"

__all__ = ["fy_draw", "fy_draw_ref"]


def _swap_in_place(idx, p, j) -> None:
    """Swap idx[k, p[k, s]] and idx[k, j[k, s]] for s = 0, 1, ... in order."""
    for s in range(p.shape[1]):
        ps, js = p[:, s:s + 1], j[:, s:s + 1]
        vi, vj = idx.gather(1, ps), idx.gather(1, js)
        idx.scatter_(1, ps, vj)
        idx.scatter_(1, js, vi)


def _swap_on_host(idx, p, j) -> None:
    """The same swaps on a numpy view of a CPU buffer: three host operations
    a step instead of four tensor dispatches. The CPU tests run every
    Fisher-Yates chain through this plain version; with the tensor loop
    alone, tests/test_torch_stochvol.py and tests/test_torch_pgibbs.py take
    over 40% longer in one process."""
    buf, rows, pn, jn = idx.numpy(), np.arange(idx.shape[0]), p.numpy(), j.numpy()
    for s in range(pn.shape[1]):
        ps, js = pn[:, s], jn[:, s]
        vi = buf[rows, ps]
        buf[rows, ps] = buf[rows, js]
        buf[rows, js] = vi


def fy_draw_ref(u, idx, pos, size, m: int, active=None, m_eff=None):
    """Plain version of :func:`fy_draw` (same in-place contract). The swap
    targets of all m steps are computed at once; the swaps themselves, which
    depend on each other, run one step at a time."""
    cap = idx.shape[-1]
    steps = torch.arange(m, dtype=torch.int32, device=idx.device)
    p = torch.clamp_max(pos[:, None] + steps, cap - 1)
    span = torch.clamp_min(size[:, None] - p, 1)
    draw = torch.minimum((u * span).to(torch.int32), span - 1)
    j = torch.clamp_max(p + draw, cap - 1)
    if active is not None:
        j = torch.where(active[:, None], j, p)  # a self-swap leaves the buffer alone
    swaps = _swap_on_host if idx.device.type == "cpu" else _swap_in_place
    swaps(idx, p.long(), j.long())
    offs = pos[:, None] + steps
    valid = offs < size[:, None]
    out = idx.gather(1, torch.clamp_max(offs, cap - 1).long())
    if m_eff is None:
        new_pos = torch.minimum(pos + m, size)
    else:
        valid &= steps < m_eff[:, None]
        new_pos = torch.minimum(pos + m_eff, size)
    if active is not None:
        new_pos = torch.where(active, new_pos, pos)
    return out, valid, new_pos


@functools.cache
def _bind():
    fn = _build.load("fy_draw").fy_draw
    P, I = _build.P, _build.I
    fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, P]
    fn.restype = I
    return fn


def fy_draw(u, idx, pos, size, m: int, active=None, m_eff=None):
    """Launch the draw on CUDA tensors (the plain version on CPU tensors)."""
    if idx.device.type == "cpu":
        return fy_draw_ref(u, idx, pos, size, m, active, m_eff)
    if idx.device.type != "cuda":
        raise ValueError(f"fy_draw has no kernel for device {idx.device}")
    if idx.ndim != 2:
        raise ValueError(f"idx must be (K, capacity), got {tuple(idx.shape)}")
    k, cap = idx.shape
    dev = idx.device
    _build.require(idx, "idx", dev, (torch.int32,), (k, cap))
    _build.require(u, "u", dev, (torch.float64,), (k, m))
    _build.require(pos, "pos", dev, (torch.int32,), (k,))
    _build.require(size, "size", dev, (torch.int32,), (k,))
    if active is not None:
        _build.require(active, "active", dev, (torch.bool,), (k,))
    if m_eff is not None:
        _build.require(m_eff, "m_eff", dev, (torch.int32,), (k,))
    out = torch.empty((k, m), dtype=torch.int32, device=dev)
    valid = torch.empty((k, m), dtype=torch.bool, device=dev)
    new_pos = torch.empty((k,), dtype=torch.int32, device=dev)
    p = _build.ptr
    err = _build.launch(_bind(), idx.device,
        p(u), p(idx), p(pos), p(size), p(active), p(m_eff), p(out), p(valid), p(new_pos), k, m, cap,
        _build.stream_of(idx))
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return out, valid, new_pos
