"""Per-token LM log-likelihood over a large vocabulary: the port of the
Pallas kernels ``repro.kernels.fused_ce.fused_ce`` and
``repro.kernels.fused_ce.batched_fused_ce``.

    out[k, t] = log softmax(h[k, t] . W_k^T)[target[k, t]]

online over vocabulary tiles, so the (T, V) logits never reach device
memory. One CUDA source, ``csrc/fused_ce.cu``, serves every form:

  * :func:`fused_ce` for one chain (counts under ``"fused_ce"``): h (T, D),
    or rows ``idx`` (m,) of an (N, D) pool read in place;
  * :func:`batched_fused_ce` for K chains (counts under
    ``"batched_fused_ce"``): h (K, T, D) against a shared (V, D) or a
    per-chain (K, V, D) table;
  * :func:`gather_fused_ce`, the same on rows ``idx`` (K, m) of a shared
    (N, D) pool and its (N,) targets (counts under ``"batched_fused_ce"``).

h and the table may each be fp32 or bf16; the sums are fp32.
``round_bf16=True`` rounds fp32 operands to bf16 as the kernel loads them
(``precision="bf16"`` without a bf16 copy of the table). The plain versions
are :func:`repro_torch.kernels.ref.fused_ce_ref`,
:func:`~repro_torch.kernels.ref.batched_fused_ce_ref` and
:func:`~repro_torch.kernels.ref.gather_fused_ce_ref`.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernel or raise. The kernel computes the logits on the tensor
cores (bf16 ``wgmma``, fp32 operands split into exact bf16 terms, fp32
accumulators; see the source's note). A block is 104 tokens by 128
vocabulary rows (compiled in); ``tile_v`` sets how many vocabulary rows one
block walks (a multiple of 128), by default enough splits of the vocabulary
to fill every SM once (on a mesh slot, as many as the whole round's launch
would take, so that each token's bits do not depend on the split). The table streams through TMA where its base is
16-byte aligned and a row is a multiple of 16 bytes (else plain loads);
bf16 h rows through ``cp.async`` where they are 16-byte aligned.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .batched_loglik import _on_cuda
from .ref import batched_fused_ce_ref, fused_ce_ref, gather_fused_ce_ref

__all__ = ["fused_ce", "batched_fused_ce", "gather_fused_ce", "fused_ce_ref",
           "batched_fused_ce_ref", "gather_fused_ce_ref", "TILE_T", "TILE_V"]

TILE_T = 104  # tokens per block: wgmma's N (compiled into csrc/fused_ce.cu)
TILE_V = 128  # vocabulary rows per tile: two m64 warpgroups (compiled in)
_TYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _bind():
    fn = _build.load("fused_ce").fused_ce_launch
    P, I = _build.P, _build.I
    fn.argtypes = [P, I, P, I, P, P, ctypes.c_longlong, P, P, I, I, I, I, I, I, I, I, I, P]
    fn.restype = I
    return fn


def smem_bytes(h_dtype, table_dtype, round_bf16: bool = False) -> int:
    """The partial kernel's dynamic shared memory for a dtype pair (builds
    the kernel)."""
    fn = _build.load("fused_ce").fused_ce_smem_bytes
    fn.argtypes, fn.restype = [_build.I] * 3, _build.I
    return fn(int(h_dtype == torch.bfloat16), int(table_dtype == torch.bfloat16), int(round_bf16))


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits(dev, n_vtiles: int, blocks: int, tile_v: int | None) -> tuple[int, int]:
    """(vocabulary tiles per block, number of vocabulary splits). By default
    the splits times ``blocks`` (token tiles x chains) fill the SMs once,
    one block an SM (its shared memory holds a deep ring)."""
    if tile_v is None:
        wanted = max(1, _num_sms(dev.index or 0) // blocks)
        per = -(-n_vtiles // max(1, min(n_vtiles, wanted)))
    else:
        if tile_v <= 0 or tile_v % TILE_V:
            raise ValueError(f"tile_v must be a positive multiple of {TILE_V}, got {tile_v}")
        per = tile_v // TILE_V
    return per, -(-n_vtiles // per)


def _aligned(t: torch.Tensor, d: int) -> bool:
    """Rows that start on 16 bytes: what TMA and cp.async need."""
    return t.data_ptr() % 16 == 0 and (d * t.element_size()) % 16 == 0


def _launch(h, table, targets, idx, k: int, t: int, name: str, *, round_bf16: bool,
            tile_t: int | None, tile_v: int | None) -> torch.Tensor:
    if tile_t is not None and tile_t != TILE_T:
        raise ValueError(f"the CUDA kernel's token tile is {TILE_T}; got tile_t={tile_t}")
    dev = h.device
    d = h.shape[-1]
    if table.ndim == 2:
        _build.require(table, "table", dev, _TYPES, (None, d))
        v, stride = table.shape[0], 0
    else:
        _build.require(table, "table", dev, _TYPES, (k, None, d))
        v = table.shape[1]
        stride = v * d
    if idx is None:
        _build.require(h, "h", dev, _TYPES, (k, t, d))
        _build.require(targets, "targets", dev, (torch.int32,), (k, t))
    else:
        _build.require(h, "h", dev, _TYPES, (None, d))
        _build.require(targets, "targets", dev, (torch.int32,), (h.shape[0],))
        _build.require(idx, "idx", dev, (torch.int32,), (k, t))
    whole = _build.round_shape()  # a mesh slot's piece splits the vocabulary as its round does
    blocks = -(-t // TILE_T) * k if whole is None else -(-whole[1] // TILE_T) * whole[0]
    per, n_split = _splits(dev, -(-v // TILE_V), blocks, tile_v)
    part = torch.empty(3 * k * t * n_split, dtype=torch.float32, device=dev)
    out = torch.empty((k, t), dtype=torch.float32, device=dev)
    h_bf16 = h.dtype == torch.bfloat16
    p = _build.ptr
    err = _build.launch(_bind(), h.device,
        p(h), int(h_bf16), p(table), int(table.dtype == torch.bfloat16), p(targets), p(idx), stride,
        p(part), p(out), k, t, d, v, per, n_split, int(round_bf16), int(_aligned(table, d)),
        int(h_bf16 and _aligned(h, d)), _build.stream_of(h))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def _round(*ts):
    return tuple(x.to(torch.bfloat16) for x in ts)


def fused_ce(h: torch.Tensor, table: torch.Tensor, targets: torch.Tensor, *,
             idx: torch.Tensor | None = None, round_bf16: bool = False,
             tile_t: int | None = None, tile_v: int | None = None) -> torch.Tensor:
    """One chain: h (T, D), table (V, D), targets (T,) int32 -> (T,) f32; with
    ``idx`` (m,) int32, rows ``idx`` of the pool h (N, D) and targets (N,)
    -> (m,) f32."""
    if not _on_cuda(h, "fused_ce"):
        if round_bf16:
            h, table = _round(h, table)
        if idx is not None:
            h, targets = h[idx.long()], targets[idx.long()]
        return fused_ce_ref(h, table, targets)
    if h.ndim != 2 or table.ndim != 2:
        raise ValueError(f"fused_ce takes h (T, D) and table (V, D); got {tuple(h.shape)}, "
                         f"{tuple(table.shape)}")
    if idx is None:
        t = h.shape[0]
        out = _launch(h[None], table, targets[None], None, 1, t, "fused_ce",
                      round_bf16=round_bf16, tile_t=tile_t, tile_v=tile_v)
    else:
        out = _launch(h, table, targets, idx[None], 1, idx.shape[0], "fused_ce",
                      round_bf16=round_bf16, tile_t=tile_t, tile_v=tile_v)
    return out[0]


def batched_fused_ce(h: torch.Tensor, table: torch.Tensor, targets: torch.Tensor, *,
                     round_bf16: bool = False, tile_t: int | None = None,
                     tile_v: int | None = None) -> torch.Tensor:
    """K chains: h (K, T, D), table (V, D) or (K, V, D), targets (K, T) int32
    -> (K, T) f32."""
    if not _on_cuda(h, "batched_fused_ce"):
        if round_bf16:
            h, table = _round(h, table)
        return batched_fused_ce_ref(h, table, targets)
    if h.ndim != 3:
        raise ValueError(f"h must be (K, T, D), got {tuple(h.shape)}")
    k, t, _ = h.shape
    return _launch(h, table, targets, None, k, t, "batched_fused_ce",
                   round_bf16=round_bf16, tile_t=tile_t, tile_v=tile_v)


def gather_fused_ce(h: torch.Tensor, targets: torch.Tensor, idx: torch.Tensor,
                    table: torch.Tensor, *, round_bf16: bool = False,
                    tile_t: int | None = None, tile_v: int | None = None) -> torch.Tensor:
    """Rows ``idx`` (K, m) int32 of the pool h (N, D) and its targets (N,)
    against a shared (V, D) or per-chain (K, V, D) table -> (K, m) f32.
    Indices must lie in [0, N): the samplers clamp them."""
    if not _on_cuda(h, "gather_fused_ce"):
        if round_bf16:
            h, table = _round(h, table)
        return gather_fused_ce_ref(h, targets, idx, table)
    if idx.ndim != 2:
        raise ValueError(f"idx must be (K, m), got {tuple(idx.shape)}")
    k, m = idx.shape
    return _launch(h, table, targets, idx, k, m, "batched_fused_ce",
                   round_bf16=round_bf16, tile_t=tile_t, tile_v=tile_v)
