"""Without-replacement mini-batch samplers with sublinear per-round cost.

The port of ``repro.core.samplers``. Sampler states hold tensors with an
optional leading chain axis: ``pos`` is () for one chain and (K,) for an
ensemble, and one draw serves both. Every draw takes an ``active`` mask
(default: all chains): chains that are not active keep their state, which is
the lock-step rule of the reference's batched while loop.

  * ``stream``: a pre-permuted pool consumed in contiguous slices. It uses no
    randomness, so a sequential test on it is deterministic.
  * ``fy``: a partial Fisher–Yates shuffle over a persistent index buffer.
    One round is m swap steps batched over chains, with all m uniforms drawn
    in one call. The swaps update the buffer in place (the JAX package's
    state is immutable; XLA updates it in place under its loop), in one
    launch of the ``fy_draw`` kernel on the card.

Both draws take ``mode`` (the kernel dispatch); the stream draw launches
nothing and ignores it. Their ``_bounded`` twins take an effective batch
``m_eff`` (a () or per-chain (K,) int tensor) beside the static ``m_max``,
the adaptive scheduler's bucket mechanism: shapes stay at ``m_max``, lanes
at ``s >= m_eff`` are invalid, and the position advances by ``m_eff``. A
bounded Fisher–Yates draw still performs all ``m_max`` swaps; those beyond
``m_eff`` only re-permute the unconsumed tail, and any permutation is a
valid start for the next without-replacement draw.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from ..kernels import ops


class FisherYatesState(NamedTuple):
    idx: torch.Tensor  # int32 (..., capacity): a permutation buffer
    pos: torch.Tensor  # int32 (...): indices consumed this transition
    size: torch.Tensor  # int32 (...): logical pool size (<= capacity)

    @property
    def capacity(self) -> int:
        return self.idx.shape[-1]


def fy_init(n: int, size=None, *, device=None) -> FisherYatesState:
    """Pool over [0, n); ``size`` restricts draws to a logical prefix."""
    device = resolve_device(device)
    return FisherYatesState(
        torch.arange(n, dtype=torch.int32, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
        torch.tensor(n if size is None else size, dtype=torch.int32, device=device),
    )


def fy_from_buffer(idx_buffer: torch.Tensor, size) -> FisherYatesState:
    """Pool drawing from an explicit (padded) index buffer (..., capacity) of
    logical ``size`` (an int, or an int tensor shaped like the leading
    axes: a DP-mixture cluster's member count N_k, one per chain). The
    buffer is used as given: draws swap it in place."""
    idx = idx_buffer.to(torch.int32)
    lead = idx.shape[:-1]
    size = torch.broadcast_to(torch.as_tensor(size, device=idx.device).to(torch.int32), lead)
    return FisherYatesState(idx, torch.zeros(lead, dtype=torch.int32, device=idx.device),
                            size.contiguous())


def fy_reset(state: FisherYatesState) -> FisherYatesState:
    """Rewind for a new transition; the buffer itself persists."""
    return FisherYatesState(state.idx, torch.zeros_like(state.pos), state.size)


def fy_draw(gen: torch.Generator, state: FisherYatesState, m: int,
            active: torch.Tensor | None = None, *, mode: str = "auto", m_eff=None):
    """Draw ``m`` indices without replacement from the logical pool.

    Returns (new_state, indices int32 (..., m), valid bool (..., m)). When
    fewer than m remain, the tail repeats valid draws and is flagged invalid.
    The m uniforms of every chain come from ``gen`` in one call; the swaps
    run in :func:`repro_torch.kernels.ops.fy_draw` (one launch on the card,
    dispatched by ``mode``). ``m_eff`` is :func:`fy_draw_bounded`'s.
    """
    idx, pos, n = state.idx, state.pos, state.size
    cap = idx.shape[-1]
    u = torch.rand(pos.shape + (m,), generator=gen, dtype=torch.float64, device=idx.device)
    flat = lambda t: t.reshape(-1) if t.ndim == pos.ndim else t.reshape(-1, t.shape[-1])
    if m_eff is not None:
        m_eff = torch.broadcast_to(m_eff, pos.shape).reshape(-1).contiguous()
    out, valid, new_pos = ops.fy_draw(
        flat(u), flat(idx), flat(pos), flat(n), m,
        None if active is None else active.reshape(-1), mode=mode, m_eff=m_eff)
    shape = pos.shape + (m,)
    return FisherYatesState(idx, new_pos.reshape(pos.shape), n), out.reshape(shape), \
        valid.reshape(shape)


def _clip_m_eff(m_eff, m_max: int, device) -> torch.Tensor:
    return torch.as_tensor(m_eff, device=device).to(torch.int32).clamp(0, m_max)


def fy_draw_bounded(gen: torch.Generator, state: FisherYatesState, m_max: int, m_eff,
                    active: torch.Tensor | None = None, *, mode: str = "auto"):
    """Fisher–Yates draw with an effective batch ``m_eff`` (clipped to
    [0, m_max]): all ``m_max`` swaps run, only the first ``m_eff`` lanes are
    valid, and the next draw resumes at ``pos + m_eff``."""
    return fy_draw(gen, state, m_max, active, mode=mode,
                   m_eff=_clip_m_eff(m_eff, m_max, state.pos.device))


class StreamSliceState(NamedTuple):
    """Without-replacement draws as contiguous slices of a pool that the data
    pipeline already put in random order."""

    pos: torch.Tensor  # int32 (...)
    n: int

    @property
    def num_sections(self) -> int:
        return self.n


def stream_init(n: int, *, device=None) -> StreamSliceState:
    return StreamSliceState(torch.zeros((), dtype=torch.int32, device=resolve_device(device)), n)


def stream_reset(state: StreamSliceState) -> StreamSliceState:
    return StreamSliceState(torch.zeros_like(state.pos), state.n)


def stream_draw(gen, state: StreamSliceState, m: int, active: torch.Tensor | None = None,
                *, mode: str = "auto"):
    del gen, mode  # randomness lives in the stream order; nothing launches
    pos = state.pos
    offs = pos[..., None] + torch.arange(m, dtype=torch.int32, device=pos.device)
    valid = offs < state.n
    out = torch.clamp_max(offs, state.n - 1)
    new_pos = torch.clamp_max(pos + m, state.n)
    if active is not None:
        new_pos = torch.where(active, new_pos, pos)
    return StreamSliceState(new_pos, state.n), out, valid


def stream_draw_bounded(gen, state: StreamSliceState, m_max: int, m_eff,
                        active: torch.Tensor | None = None, *, mode: str = "auto"):
    """Stream-slice draw with an effective batch ``m_eff`` <= ``m_max``:
    lanes past it are invalid and do not advance the stream position."""
    del gen, mode
    pos = state.pos
    m_eff = _clip_m_eff(m_eff, m_max, pos.device)
    lanes = torch.arange(m_max, dtype=torch.int32, device=pos.device)
    offs = pos[..., None] + lanes
    valid = (offs < state.n) & (lanes < m_eff[..., None])
    out = torch.clamp_max(offs, state.n - 1)
    new_pos = torch.clamp_max(pos + m_eff, state.n)
    if active is not None:
        new_pos = torch.where(active, new_pos, pos)
    return StreamSliceState(new_pos, state.n), out, valid


def sampler_fns(kind: str):
    """(reset_fn, draw_fn) for ``kind`` in {fy, stream}."""
    if kind == "fy":
        return fy_reset, fy_draw
    if kind == "stream":
        return stream_reset, stream_draw
    raise ValueError(f"unknown sampler kind: {kind!r}")


def make_sampler(kind: str, n: int, *, device=None):
    """Returns (init_state, reset_fn, draw_fn) for ``kind`` in {fy, stream}."""
    reset_fn, draw_fn = sampler_fns(kind)
    init = fy_init if kind == "fy" else stream_init
    return init(n, device=device), reset_fn, draw_fn


def make_bounded_draw(kind: str):
    """The bounded twin of ``sampler_fns``'s draw:
    ``draw(gen, state, m_max, m_eff, active=None, mode=) -> (state, idx, valid)``."""
    if kind == "fy":
        return fy_draw_bounded
    if kind == "stream":
        return stream_draw_bounded
    raise ValueError(f"unknown sampler kind: {kind!r}")


def batch_sampler_state(state, num_chains: int):
    """Give every tensor of a single-chain sampler state a leading (K,) axis
    (independent copies: the Fisher–Yates buffer is updated in place)."""
    if isinstance(state, FisherYatesState):
        return FisherYatesState(
            state.idx[None].repeat(num_chains, 1),
            state.pos[None].repeat(num_chains),
            state.size[None].repeat(num_chains),
        )
    return StreamSliceState(state.pos[None].repeat(num_chains), state.n)
