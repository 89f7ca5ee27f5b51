"""Logical-axis sharding over a mesh of slots: the port of
``repro.distributed.sharding``.

Each tensor dim carries a *logical* name, and a prioritised rule list maps
names to mesh axes. A rule is skipped when the dim is not divisible by the
size of its mesh axes, or when another dim of the same tensor already took
one of them; the dim is then replicated (MaxText-style). The rules and
:func:`resolve_spec` are the reference's, so the same shape, names and mesh
shape give the same spec.

The reference's mesh is an array of JAX devices that one program drives
through ``jit`` and ``shard_map``. Here it is an array of *slots*, each a
``torch.device`` that one process drives eagerly (:mod:`.slots` lists
them): a slot holds its piece of a tensor on its device, and
:func:`shard_tensor` / :func:`assemble` move pieces out and back. Several
slots may share one device (the counterpart of JAX's forced host devices).
Along a mesh axis that a tensor's spec does not use, the pieces repeat, and
only the slot at index 0 of that axis holds one
(:meth:`NamedSharding.owners`): it does that piece's work.

The LM's parameters live on the mesh as :class:`ShardedTensor` leaves: each
owner slot holds its piece of the leaf under the reference's rules, and no
whole copy lives anywhere. Compute stays on the leaf's *home* device: the
model gathers a leaf, or one row of a stacked leaf, just before it reads it
and drops it after (:func:`shard_params`, :func:`gather_params`). The
activations are whole on home, so ``lc(x, names)``, which in the reference
constrains an activation's layout inside jitted model code, is a no-op
here under any mesh. A sharded step is therefore the unsharded step bit for
bit. Gradients follow the same rule: :class:`GradTape` lets autograd see
each gather, and a read's gradient is written into a gradient leaf of the
same layout (:class:`GradSink`), so no whole gradient is held on home and
the bits are the unsharded backward's. :func:`transfer_counts` reads the
gathers' and scatters' counts and bytes (the dry run's stand-in for the
reference's collectives).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..kernels import _build

# Priority-ordered candidate mesh axes per logical axis name. The first
# candidate whose size divides the dim (and isn't already used by another dim
# of the same tensor) wins; otherwise the dim is replicated.
DEFAULT_RULES: dict[str, tuple[tuple[str, ...], ...]] = {
    "batch": (("pod", "data"), ("data",)),
    "vocab": (("model",),),
    "embed": (("data",),),  # FSDP-style weight sharding over the data axis
    "embed_tp": (("model",),),
    "mlp": (("model",),),
    "q_heads": (("model",),),
    "kv_heads": (("model",),),
    "heads_flat": (("model",),),
    "experts": (("model",),),
    "mamba_inner": (("model",),),
    "expert_mlp": (("model",),),
    "capacity": (("model",),),  # MoE buffer fallback when experts % model != 0
    "kv_seq": (("model", "data"), ("model",)),  # decode-cache sequence sharding
    "seq": (),  # sequence dim: replicated by default (SP is a perf knob)
    "layers": (),
    "conv": (),
    "state": (),
    # -- MCMC-ensemble axes (the chains x data mesh of ChainEnsemble). The
    # (K,) chain axis spreads whole chains; "subsample" is the m axis of a
    # sequential-test round's (K, m) mini-batch, split over the data axis so
    # each slot scores its columns of the drawn sections. Both are no-ops on
    # model-training meshes (no "chains" axis there) and fall through to
    # replicated when the dim isn't divisible.
    "ensemble_chains": (("chains",),),
    "subsample": (("data",),),
}

# The logical names of a sequential-test round's (K, m) block.
ROUND_AXES = ("ensemble_chains", "subsample")


class PartitionSpec(tuple):
    """Per dim, the mesh axis (a name), axes (a tuple of names) or None
    (replicated) it is split over; trailing Nones are dropped, as JAX's
    ``PartitionSpec`` built by :func:`resolve_spec` drops them."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class Mesh:
    """An n-d array of slots with one name per axis. ``shape`` is the dict
    {axis name: size}, as JAX's; ``devices`` the object array of
    ``torch.device`` slots."""

    def __init__(self, devices: Sequence | np.ndarray, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object) if isinstance(devices, np.ndarray) else None
        if arr is None:
            flat = list(devices)
            arr = np.empty(len(flat), dtype=object)
            arr[:] = [torch.device(d) for d in flat]
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"mesh of {arr.ndim} dims needs as many axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        self.devices = arr
        self.axis_names = axis_names
        self._round_blocks: dict = {}  # split_round's owner blocks, by shape and rules

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devs})"


class _Ctx(threading.local):
    mesh: Mesh | None = None
    rules: dict[str, tuple[tuple[str, ...], ...]] | None = None


_CTX = _Ctx()


@contextlib.contextmanager
def logical_axis_rules(mesh: Mesh, rules: dict | None = None):
    """Activate a mesh and a rule set for this thread: the ensemble's round
    evaluators then split their (K, m) blocks over it."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active_mesh() -> tuple[Mesh, dict] | None:
    """(mesh, rules) of this thread's active mesh of more than one slot, or
    None."""
    mesh = _CTX.mesh
    if mesh is None or mesh.size <= 1:
        return None
    return mesh, _CTX.rules


def _mesh_axis_size(mesh: Mesh, axes: tuple[str, ...]) -> int:
    size = 1
    for a in axes:
        size *= mesh.shape.get(a, 1)
    return size


def resolve_spec(shape: Sequence[int], logical: Sequence[str | None], mesh: Mesh,
                 rules: dict) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec honoring divisibility and
    one-mesh-axis-per-tensor uniqueness. Reads only ``mesh.shape``."""
    used: set[str] = set()
    parts: list = []
    for dim, name in zip(shape, logical):
        assigned = None
        if name is not None:
            for cand in rules.get(name, ()):
                cand_eff = tuple(a for a in cand if a in mesh.shape and a not in used)
                if not cand_eff:
                    continue
                if dim % _mesh_axis_size(mesh, cand_eff) == 0:
                    assigned = cand_eff if len(cand_eff) > 1 else cand_eff[0]
                    used.update(cand_eff)
                    break
        parts.append(assigned)
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def lc(x: torch.Tensor, logical: Sequence[str | None]) -> torch.Tensor:
    """Logical sharding constraint: a no-op. Activations are whole on the home
    device under any mesh (the module docstring); the reference's constraint
    of their layout inside a jitted step has no eager counterpart."""
    return x


class Block(NamedTuple):
    """One owner slot's piece: its position in the mesh, its device and the
    index slices of its piece, one per dim."""

    slot: tuple[int, ...]
    device: torch.device
    index: tuple[slice, ...]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout over ``mesh``: ``spec`` names the mesh axes each dim
    is split over (evenly: :func:`resolve_spec` only splits divisible dims)."""

    mesh: Mesh
    spec: PartitionSpec

    def _dim_axes(self, ndim: int) -> list[tuple[str, ...]]:
        parts = list(self.spec) + [None] * (ndim - len(self.spec))
        return [() if p is None else (p,) if isinstance(p, str) else tuple(p) for p in parts]

    def slot_index(self, slot: tuple[int, ...], shape: Sequence[int]) -> tuple[slice, ...]:
        """The index slices of slot ``slot``'s piece of a ``shape`` tensor."""
        sizes = self.mesh.shape
        pos = dict(zip(self.mesh.axis_names, slot))
        index = []
        for dim, axes in zip(shape, self._dim_axes(len(shape))):
            n, i = 1, 0
            for a in axes:  # row-major over the dim's axes, as JAX numbers shards
                n, i = n * sizes[a], i * sizes[a] + pos[a]
            if dim % n:
                raise ValueError(f"dim {dim} does not split evenly over mesh axes {axes}")
            step = dim // n
            index.append(slice(i * step, (i + 1) * step))
        return tuple(index)

    def owners(self, shape: Sequence[int]) -> list[Block]:
        """The slots that own a distinct piece: index 0 along every mesh axis
        the spec does not use (the others' pieces repeat an owner's)."""
        used = {a for axes in self._dim_axes(len(shape)) for a in axes}
        free = [k for k, a in enumerate(self.mesh.axis_names) if a not in used]
        return [Block(slot, self.mesh.devices[slot], self.slot_index(slot, shape))
                for slot in np.ndindex(*self.mesh.devices.shape)
                if all(slot[k] == 0 for k in free)]


def named_sharding(mesh: Mesh, shape: Sequence[int], logical: Sequence[str | None],
                   rules: dict | None = None) -> NamedSharding:
    rules = dict(DEFAULT_RULES, **(rules or {}))
    return NamedSharding(mesh, resolve_spec(shape, logical, mesh, rules))


def tree_shardings(mesh: Mesh, specs: dict, rules: dict | None = None):
    """Map a {path: ParamSpec} dict to {path: NamedSharding}."""
    return {k: named_sharding(mesh, v.shape, v.logical, rules) for k, v in specs.items()}


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def count_bytes(specs: dict) -> int:
    """Bytes of a {path: ParamSpec} dict's tensors."""
    return sum(int(np.prod(v.shape)) * _itemsize(v.dtype) for v in specs.values())


# ---------------------------------------------------------------------------
# Moving pieces between the home device and the slots
# ---------------------------------------------------------------------------


def canonical(device) -> torch.device:
    """``device`` with its index: bare ``cuda`` is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


_BETWEEN = [0, 0]  # copies between devices by place() and assemble(): [count, bytes]


def device_copies() -> dict:
    """``{"count", "bytes"}`` of the copies between two devices that
    :func:`place` and :func:`assemble` made since :func:`reset_device_copies`
    (a mesh round's pieces, rows and pools; none where every slot is the
    home device)."""
    return {"count": _BETWEEN[0], "bytes": _BETWEEN[1]}


def reset_device_copies() -> None:
    _BETWEEN[0] = _BETWEEN[1] = 0


def _between(t: torch.Tensor) -> None:
    _BETWEEN[0] += 1
    _BETWEEN[1] += t.numel() * t.element_size()


def place(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``; itself when it is there already. A contiguous
    tensor keeps its address modulo 16 bytes, so a kernel that picks its
    vector width from the address reads the copy as it reads ``t``."""
    device = canonical(device)
    if canonical(t.device) == device:
        return t
    _between(t)
    off = t.data_ptr() % 16
    if not t.is_contiguous() or off % t.element_size():
        return t.to(device)
    lead = off // t.element_size()
    buf = torch.empty(t.numel() + lead, dtype=t.dtype, device=device)
    out = buf[lead:].view(t.shape)
    out.copy_(t)
    return out


def shard_tensor(x: torch.Tensor, blocks: Sequence[Block]) -> list[torch.Tensor]:
    """Each block's piece of ``x``, contiguous, on the block's device
    (``blocks`` as :meth:`NamedSharding.owners` gives them)."""
    return [place(x[blk.index].contiguous(), blk.device) for blk in blocks]


def assemble(pieces: Sequence[torch.Tensor], blocks: Sequence[Block], shape: Sequence[int],
             device) -> torch.Tensor:
    """The whole ``shape`` tensor on ``device`` from the blocks' pieces."""
    out = torch.empty(tuple(shape), dtype=pieces[0].dtype, device=device)
    for blk, piece in zip(blocks, pieces):
        if piece.device != out.device:
            _between(piece)
        out[blk.index].copy_(piece)
    return out


class _SlotContext:
    """Attributes kernel launches to a slot (``_build.SLOT_LAUNCHES``), tells
    them the whole round's (K, m) (``_build.round_shape``) and makes the
    slot's card the current one while it launches."""

    __slots__ = ("slot", "device", "shape", "_prev", "_guard")

    def __init__(self, slot, device, shape=None):
        self.slot, self.device, self.shape = slot, device, shape

    def __enter__(self):
        self._prev = _build.enter_slot(self.slot, self.shape)
        self._guard = None
        if self.device.type == "cuda" and self.device.index != torch.cuda.current_device():
            self._guard = torch.cuda.device(self.device)
            self._guard.__enter__()

    def __exit__(self, *exc):
        if self._guard is not None:
            self._guard.__exit__(*exc)
        _build.leave_slot(self._prev)


def split_round(mesh: Mesh, rules: dict, home,
                score: Callable[[Block, torch.Tensor], torch.Tensor]):
    """``idx (K, m) -> (K, m)`` that splits each round's index block over the
    mesh by :data:`ROUND_AXES`: ``score(block, idx_piece)`` scores one owner
    slot's piece on the slot's device (``idx_piece`` contiguous there), and
    the pieces are assembled on ``home``. Work on a slot's device follows the
    copies to it, and the assembly follows the slot's kernels, through the
    calling thread's current stream on each device (PyTorch orders a copy
    between devices after both devices' current streams)."""
    home = canonical(home)
    plans = mesh._round_blocks  # kept on the mesh: a transition binds a new split_round

    def run(idx: torch.Tensor) -> torch.Tensor:
        key = (tuple(idx.shape),) + tuple(rules.get(name) for name in ROUND_AXES)
        blocks = plans.get(key)
        if blocks is None:
            sh = NamedSharding(mesh, resolve_spec(idx.shape, ROUND_AXES, mesh, rules))
            blocks = plans[key] = [blk._replace(device=canonical(blk.device))
                                   for blk in sh.owners(idx.shape)]
        out = []
        for blk, piece in zip(blocks, shard_tensor(idx, blocks)):
            with _SlotContext(blk.slot, blk.device, tuple(idx.shape)):
                out.append(score(blk, piece))
        return assemble(out, blocks, idx.shape, home)

    return run


def rows_of(tree: Any, rows: slice, device) -> Any:
    """Rows ``rows`` of every leaf of a chain-batched tree, on ``device``."""
    from .._device import tree_map

    return tree_map(lambda l: place(l[rows].contiguous(), device), tree)


# ---------------------------------------------------------------------------
# Sharded leaves: pieces on the slots, compute on the home device
# ---------------------------------------------------------------------------

# A gathered leaf, or rows of one, keeps the address modulo this many bytes
# that the unsharded leaf's view has, so a GEMM library or a vectorized CPU
# loop takes the same code path on it (64 is the CPU allocator's alignment;
# the CUDA allocator's is 512).
GATHER_ALIGN = 64

# Leaves above this many elements are read and updated in chunks of
# leading-axis rows of at most this size (:func:`map_rows`; one 56 M-element
# layer of chatglm3-6b's stacked MLP leaf, 16384 rows of its embedding
# table): a float32 temporary of the whole MLP leaf would be 6.3 GB, while
# every chunk costs a few launches of host time (~107 chunks for the whole
# model; 4 M-element chunks left the card idle two thirds of a LM step).
ROW_CHUNK = 1 << 26

_TRANSFERS = {"gather": [0, 0], "scatter": [0, 0]}  # kind -> [count, bytes]
_EVENTS: dict | None = None  # kind -> [(start, end)] CUDA events while timed


def reset_transfers() -> None:
    """Zero the gather and scatter counters (and any timed events)."""
    for rec in _TRANSFERS.values():
        rec[0] = rec[1] = 0
    if _EVENTS is not None:
        for ev in _EVENTS.values():
            ev.clear()


def transfer_counts() -> dict:
    """``{"gather": {"count", "bytes"}, "scatter": {...}}`` since the last
    reset: a gather copies pieces into a tensor on the home device, a
    scatter copies a home tensor into pieces. Inside :func:`timed_transfers`
    each kind also has ``ms``, the CUDA time of its copies (this waits for
    them)."""
    out = {k: {"count": c, "bytes": b} for k, (c, b) in _TRANSFERS.items()}
    if _EVENTS is not None:
        for k, ev in _EVENTS.items():
            if ev:
                ev[-1][1].synchronize()
            out[k]["ms"] = sum(s.elapsed_time(e) for s, e in ev)
    return out


@contextlib.contextmanager
def timed_transfers():
    """Bracket every gather and scatter on a CUDA home device with CUDA
    events until the block ends (:func:`transfer_counts` sums them). Yields
    ``{"gather": [(start, end), ...], "scatter": [...]}``, in launch order."""
    global _EVENTS
    prev, _EVENTS = _EVENTS, {"gather": [], "scatter": []}
    try:
        yield _EVENTS
    finally:
        _EVENTS = prev


@contextlib.contextmanager
def uncounted_transfers():
    """Gathers and scatters inside the block are neither counted nor timed
    (a check that reads sharded leaves beside a measured run)."""
    global _EVENTS
    saved = {k: list(v) for k, v in _TRANSFERS.items()}
    prev, _EVENTS = _EVENTS, None
    try:
        yield
    finally:
        _EVENTS = prev
        for k, v in saved.items():
            _TRANSFERS[k][:] = v


def _transfer_count(kind: str, nbytes: int) -> None:
    rec = _TRANSFERS[kind]
    rec[0] += 1
    rec[1] += int(nbytes)


@contextlib.contextmanager
def _transfer(kind: str, nbytes: int, device: torch.device):
    _transfer_count(kind, nbytes)
    if _EVENTS is None or device.type != "cuda":
        yield
        return
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    _EVENTS[kind].append((start, end))


def _aligned_empty(shape, dtype: torch.dtype, device: torch.device, off: int) -> torch.Tensor:
    """An empty contiguous tensor whose address is ``off`` modulo
    :data:`GATHER_ALIGN` (a fresh allocation is 0 there)."""
    size = dtype.itemsize
    if off == 0 or off % size or device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    lead = off // size
    buf = torch.empty(int(np.prod(shape, dtype=np.int64)) + lead, dtype=dtype, device=device)
    return buf[lead:].view(tuple(shape))


def _address(t: torch.Tensor) -> int:
    return 0 if t.device.type == "meta" else t.data_ptr() % GATHER_ALIGN


def _piece_shape(index: tuple[slice, ...]) -> tuple[int, ...]:
    return tuple(s.stop - s.start for s in index)


class ShardedTensor:
    """A leaf kept as its owner slots' pieces under ``sharding``
    (:meth:`NamedSharding.owners`), read on its ``home`` device: whole by
    :meth:`gather`, a row of a stacked leaf by ``leaf[i]``, rows by
    :meth:`rows`. ``shape``, ``dtype``, ``ndim`` and ``device`` (the home
    device) are the unsharded leaf's; ``align`` is that leaf's address
    modulo :data:`GATHER_ALIGN`, which every gathered tensor keeps as the
    unsharded view at the same place would have it."""

    __slots__ = ("pieces", "sharding", "blocks", "shape", "dtype", "home", "align")

    def __init__(self, pieces: Sequence[torch.Tensor], sharding: NamedSharding, shape,
                 dtype: torch.dtype, home, align: int = 0, blocks: Sequence[Block] | None = None):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.home = canonical(home)
        self.align = int(align)
        self.blocks = list(blocks) if blocks is not None else [
            blk._replace(device=canonical(blk.device)) for blk in sharding.owners(self.shape)]
        self.pieces = list(pieces)
        if len(self.pieces) != len(self.blocks):
            raise ValueError(f"{len(self.pieces)} pieces for {len(self.blocks)} owner slots")

    @classmethod
    def from_tensor(cls, x: torch.Tensor, sharding: NamedSharding, home=None) -> "ShardedTensor":
        """``x`` split into its owners' pieces (copies: nothing of ``x`` is
        kept), home ``home`` (default: ``x``'s device)."""
        out = cls.empty(sharding, x.shape, x.dtype, x.device if home is None else home,
                        align=_address(x))
        with _transfer("scatter", out.nbytes_held, out.home):
            for blk, piece in out._copies():
                piece.copy_(x[blk.index])
        return out

    @classmethod
    def empty(cls, sharding: NamedSharding, shape, dtype: torch.dtype, home,
              align: int = 0) -> "ShardedTensor":
        """A leaf with uninitialized pieces on their owner slots."""
        blocks = [blk._replace(device=canonical(blk.device))
                  for blk in sharding.owners(torch.Size(shape))]
        pieces = [torch.empty(_piece_shape(blk.index), dtype=dtype, device=blk.device)
                  for blk in blocks]
        return cls(pieces, sharding, shape, dtype, home, align, blocks)

    def empty_like(self, dtype: torch.dtype | None = None) -> "ShardedTensor":
        """A leaf of the same shape, sharding and home, in ``dtype`` (default:
        this leaf's), with uninitialized pieces (a fresh whole leaf's
        address: ``align`` 0)."""
        dtype = dtype or self.dtype
        pieces = [torch.empty_like(p, dtype=dtype) for p in self.pieces]
        return ShardedTensor(pieces, self.sharding, self.shape, dtype, self.home, 0, self.blocks)

    def zeros_like(self, dtype: torch.dtype | None = None) -> "ShardedTensor":
        """A leaf of zeros of the same shape, sharding and home, in ``dtype``
        (default: this leaf's)."""
        dtype = dtype or self.dtype
        pieces = [torch.zeros(p.shape, dtype=dtype, device=p.device) for p in self.pieces]
        return ShardedTensor(pieces, self.sharding, self.shape, dtype, self.home, 0, self.blocks)

    @property
    def device(self) -> torch.device:
        return self.home

    def _copies(self):
        """(block, piece) pairs to copy through: none on the meta device,
        whose tensors hold no data (the dry run counts the transfers and
        allocates their results, and skips thousands of empty copies)."""
        return () if self.home.type == "meta" else zip(self.blocks, self.pieces)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def element_size(self) -> int:
        return self.dtype.itemsize

    @property
    def nbytes_held(self) -> int:
        """Bytes of every piece together (the owners' copies)."""
        return sum(int(np.prod(_piece_shape(b.index), dtype=np.int64)) for b in self.blocks) \
            * self.dtype.itemsize

    def gather(self) -> torch.Tensor:
        """The whole leaf on the home device."""
        out = _aligned_empty(self.shape, self.dtype, self.home, self.align)
        with _transfer("gather", self.numel() * self.dtype.itemsize, self.home):
            for blk, piece in self._copies():
                out[blk.index].copy_(piece)
        return out

    def _row_bytes(self) -> int:
        return int(np.prod(self.shape[1:], dtype=np.int64)) * self.dtype.itemsize

    def _row_parts(self, start: int, stop: int):
        """(piece, its rows, the destination's index) of every owner piece
        holding rows of [start, stop) along dim 0."""
        for blk, piece in zip(self.blocks, self.pieces):
            s0, s1 = blk.index[0].start, blk.index[0].stop
            lo, hi = max(start, s0), min(stop, s1)
            if lo < hi:
                yield piece, slice(lo - s0, hi - s0), (slice(lo - start, hi - start),) \
                    + blk.index[1:]

    def rows(self, start: int, stop: int) -> torch.Tensor:
        """Rows [start, stop) along dim 0, gathered on the home device from
        the row slices of the pieces alone."""
        if self.ndim == 0:
            return self.gather()
        shape = (stop - start,) + tuple(self.shape[1:])
        out = _aligned_empty(shape, self.dtype, self.home,
                             (self.align + start * self._row_bytes()) % GATHER_ALIGN)
        if self.home.type == "meta":
            _transfer_count("gather", (stop - start) * self._row_bytes())
            return out
        with _transfer("gather", (stop - start) * self._row_bytes(), self.home):
            for piece, rows, dst in self._row_parts(start, stop):
                out[dst].copy_(piece[rows])
        return out

    def __getitem__(self, i: int) -> torch.Tensor:
        """Row ``i`` of a stacked leaf (its ``"layers"`` axis), on home."""
        if not isinstance(i, int):
            raise TypeError(f"a sharded leaf is read by an int row, not {type(i).__name__}")
        i = i + self.shape[0] if i < 0 else i
        return self.rows(i, i + 1)[0]

    def write_rows(self, start: int, stop: int, value: torch.Tensor) -> None:
        """Copy ``value``, rows [start, stop) of the whole leaf on any device,
        into the pieces that hold them."""
        if self.ndim == 0:
            with _transfer("scatter", self.nbytes_held, self.home):
                for _, piece in self._copies():
                    piece.copy_(value)
            return
        parts = list(self._row_parts(start, stop))
        nbytes = sum(int(np.prod(_piece_shape(dst), dtype=np.int64))
                     for _, _, dst in parts) * self.dtype.itemsize
        if self.home.type == "meta":
            _transfer_count("scatter", nbytes)
            return
        with _transfer("scatter", nbytes, self.home):
            for piece, rows, src in parts:
                piece[rows].copy_(value[src])

    def row_bounds(self, max_elems: int) -> list[tuple[int, int]]:
        """The (start, stop) row ranges of ``_device.row_chunks(leaf,
        max_elems)`` on the unsharded leaf."""
        return row_bounds(self.shape, max_elems)

    def to_host(self) -> "ShardedTensor":
        """A copy whose pieces (and home) are on the CPU, same layout."""
        blocks = [b._replace(device=torch.device("cpu")) for b in self.blocks]
        return ShardedTensor([p.detach().cpu() for p in self.pieces], self.sharding, self.shape,
                             self.dtype, "cpu", self.align, blocks)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.sharding.spec}, home={self.home}, pieces={len(self.pieces)})")


# ---------------------------------------------------------------------------
# Gradients of sharded leaves: a gather that autograd sees
# ---------------------------------------------------------------------------


class GradSink:
    """The gradient of one sharded leaf, built in pieces with the leaf's own
    layout as the backward reaches each read of the leaf: no whole gradient
    of the leaf is held on the home device.

    The unsharded backward adds every read's contribution into one buffer of
    the leaf's size, in the order the reads' gradients arrive, where a read
    of rows contributes zeros everywhere else. A sink adds the contributions
    in the same order over the rows they touch. The zeros matter only to a
    zero's sign: ``x + 0`` makes -0 into +0, so a row that some read did
    not touch is settled by :meth:`rows` (a stacked leaf read one layer at a
    time: every row of a leaf of two or more layers)."""

    __slots__ = ("grad", "touched", "count")

    def __init__(self, leaf: "ShardedTensor"):
        self.grad = leaf.zeros_like()
        self.touched = np.zeros(leaf.shape[0] if leaf.ndim else 1, dtype=np.int64)
        self.count = 0

    def add(self, start: int, stop: int, g: torch.Tensor) -> None:
        """A read's gradient ``g`` of rows [start, stop) (the whole leaf for
        a gather), in the leaf's dtype on its home device."""
        if self.touched[start:stop].any():
            g = self.grad.rows(start, stop) + g
        self.grad.write_rows(start, stop, g)
        self.touched[start:stop] += 1
        self.count += 1

    def rows(self, start: int, stop: int) -> torch.Tensor:
        """Rows [start, stop) of the finished gradient, gathered on home."""
        out = self.grad.rows(start, stop)
        loose = np.flatnonzero(self.touched[start:stop] < self.count)
        if loose.size == stop - start:
            out.masked_fill_(out == 0, 0)
        else:
            for i in loose:
                out[i].masked_fill_(out[i] == 0, 0)
        return out

    def finish(self, max_elems: int = ROW_CHUNK) -> "ShardedTensor":
        """The finished gradient: the untouched rows settled in place, chunk
        by chunk of at most ``max_elems`` elements."""
        if (self.touched < self.count).any():
            for a, b in self.grad.row_bounds(max_elems):
                if (self.touched[a:b] < self.count).any():
                    self.grad.write_rows(a, b, self.rows(a, b))
        return self.grad


class _Gather(torch.autograd.Function):
    """Rows [start, stop) of a sharded leaf (all of it when ``start`` is
    None) gathered on home; the backward hands their gradient to the sink.
    ``anchor`` is a 0-d tensor that requires grad, so autograd records the
    read; it gets no gradient. The output is registered with the leaf's
    tape, which keeps it out of autograd's saved tensors."""

    @staticmethod
    def forward(ctx, anchor, leaf, sink, start, stop):
        ctx.sink, ctx.bounds = sink, (start, stop)
        out = (ShardedTensor.gather(leaf) if start is None
               else ShardedTensor.rows(leaf, start, stop))
        if out.device.type != "meta":
            leaf.saved[out.untyped_storage().data_ptr()] = _Gathered(out, leaf.source, start,
                                                                      stop)
        return out

    @staticmethod
    def backward(ctx, g):
        start, stop = ctx.bounds
        if start is None:
            start, stop = 0, len(ctx.sink.touched)
        ctx.sink.add(start, stop, g)
        return None, None, None, None, None


class _TrackedLeaf(ShardedTensor):
    """A sharded leaf whose reads under grad mode go through :class:`_Gather`
    into a :class:`GradSink`; the same pieces, gathered as the leaf is.
    ``source`` is the watched leaf and ``saved`` its tape's registry of
    gathered outputs: neither refers back to this leaf or to the tape, so
    a step's tape and gradients are freed by reference counts alone (a
    cycle would keep a 12 GB gradient until the cyclic collector ran)."""

    __slots__ = ("sink", "anchor", "source", "saved")

    def gather(self) -> torch.Tensor:
        if not torch.is_grad_enabled():
            return super().gather()
        return _Gather.apply(self.anchor, self, self.sink, None, None)

    def rows(self, start: int, stop: int) -> torch.Tensor:
        if self.ndim == 0:
            return self.gather()
        if not torch.is_grad_enabled():
            return super().rows(start, stop)
        return _Gather.apply(self.anchor, self, self.sink, start, stop)


class _Gathered:
    """A gather's output as the backward finds it again: the (unwatched)
    leaf, its rows, a weak reference to the forward's tensor and one to the
    tensor gathered again in the backward (shared by every saved view)."""

    __slots__ = ("out", "leaf", "start", "stop", "again")

    def __init__(self, out, leaf, start, stop):
        self.out, self.leaf, self.start, self.stop = weakref.ref(out), leaf, start, stop
        self.again = None

    def regather(self) -> torch.Tensor:
        again = self.again() if self.again is not None else None
        if again is None:
            again = (ShardedTensor.gather(self.leaf) if self.start is None
                     else ShardedTensor.rows(self.leaf, self.start, self.stop))
            self.again = weakref.ref(again)
        return again


class GradTape:
    """Autograd over leaves of which some are sharded. :meth:`watch` gives
    the leaf to read in the forward: a plain leaf detached and requiring
    grad (as unsharded code reads it), a sharded one as a leaf on the same
    pieces whose reads feed a :class:`GradSink`. :meth:`grad` then runs one
    backward and returns, per watched leaf, its gradient tensor (None for a
    plain leaf the forward did not read) or its sink.

    Run the forward inside ``with tape:``. Autograd then keeps no gathered
    rows for the backward: a saved tensor that is a gather's output, or a
    view of one, is kept as its leaf and rows and gathered again when the
    backward reads it (FSDP's reshard after forward). The bits are the
    same, at the same address modulo :data:`GATHER_ALIGN`, so a sharded
    forward holds no whole copy of the model on home."""

    def __init__(self):
        self.anchor: torch.Tensor | None = None
        self.watched: list = []
        self._outputs: dict[int, _Gathered] = {}  # storage address -> a gather's output
        self._hooks = None

    def watch(self, leaf):
        if not isinstance(leaf, ShardedTensor):
            out = leaf.detach().requires_grad_(True)
            self.watched.append(out)
            return out
        if self.anchor is None:
            self.anchor = torch.zeros((), device=leaf.home, requires_grad=True)
        out = _TrackedLeaf(leaf.pieces, leaf.sharding, leaf.shape, leaf.dtype, leaf.home,
                           leaf.align, leaf.blocks)
        out.sink, out.anchor, out.source, out.saved = GradSink(leaf), self.anchor, leaf, \
            self._outputs
        self.watched.append(out)
        return out

    def __enter__(self) -> "GradTape":
        self._hooks = torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._hooks.__exit__(*exc)
        self._hooks = None

    def _pack(self, t: torch.Tensor):
        if not self._outputs or t.device.type == "meta" or t.layout != torch.strided:
            return t
        rec = self._outputs.get(t.untyped_storage().data_ptr())
        base = rec.out() if rec is not None else None
        if base is None or base.dtype != t.dtype:
            return t
        return rec, tuple(t.shape), t.stride(), t.storage_offset() - base.storage_offset()

    @staticmethod
    def _unpack(packed) -> torch.Tensor:
        if isinstance(packed, torch.Tensor):
            return packed
        rec, shape, stride, offset = packed
        again = rec.regather()
        return again.as_strided(shape, stride, again.storage_offset() + offset)

    def grad(self, value: torch.Tensor, allow_unused: bool = False) -> list:
        plain = [w for w in self.watched if not isinstance(w, ShardedTensor)]
        if self.anchor is None:
            got = iter(torch.autograd.grad(value, plain, allow_unused=allow_unused))
        else:
            got = iter(torch.autograd.grad(value, plain + [self.anchor], allow_unused=True))
        self._outputs.clear()
        return [w.sink if isinstance(w, ShardedTensor) else next(got) for w in self.watched]


# ---------------------------------------------------------------------------
# Row chunks: one loop for plain and sharded leaves
# ---------------------------------------------------------------------------


def row_bounds(shape, max_elems: int) -> list[tuple[int, int]]:
    """The (start, stop) rows of ``_device.row_chunks`` on a tensor of
    ``shape``: one chunk at or under ``max_elems`` elements or under two
    dims, else runs of whole rows of at most ``max_elems`` elements."""
    n = shape[0] if len(shape) else 1
    numel = int(np.prod(shape, dtype=np.int64))
    if numel <= max_elems or len(shape) < 2:
        return [(0, n)]
    per = max(1, max_elems // max(1, numel // n))
    return [(a, min(a + per, n)) for a in range(0, n, per)]


def _read(x, start: int, stop: int, whole: bool) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if whole else x[start:stop]
    return x.rows(start, stop)  # a ShardedTensor or a GradSink: gathered on home


def _write(dst, start: int, stop: int, whole: bool, t: torch.Tensor) -> None:
    if isinstance(dst, ShardedTensor):
        dst.write_rows(start, stop, t)
        return
    view = dst if whole else dst[start:stop]
    if t.data_ptr() != view.data_ptr() or t.shape != view.shape:  # else updated in place
        view.copy_(t)


def iter_rows(leaf, max_elems: int = ROW_CHUNK):
    """The chunks of ``_device.row_chunks(leaf, max_elems)`` in order: views
    of a plain leaf; of a sharded one, each chunk's rows gathered on its
    home device as it is reached."""
    span = row_bounds(leaf.shape, max_elems)
    return (_read(leaf, a, b, len(span) == 1) for a, b in span)


def map_rows(fn: Callable, leaves: Sequence, out=None, dtypes=None,
             max_elems: int = ROW_CHUNK):
    """``fn`` over the row chunks of ``leaves`` (those of
    ``_device.row_chunks(leaves[0], max_elems)``), in order, each leaf read
    as :func:`iter_rows` reads it (a :class:`GradSink` by its settled rows).
    ``fn`` gives one tensor or a tuple, the outputs' chunks. They are
    written into ``out`` (a leaf or a tuple of them) when given (a plain
    chunk that ``fn`` updated in place is not copied onto itself), else into
    new leaves of the first leaf's shape, sharded alike when it is sharded,
    in ``dtypes`` (a dtype or a tuple; default: the chunks' own). A plain
    first leaf of one chunk gets ``fn``'s tensors themselves (cast). Returns
    the outputs as ``fn`` gives them. Every chunk is computed as the
    unsharded leaf's chunk is, so a sharded leaf's outputs are the plain
    leaf's bit for bit."""
    first = leaves[0]
    span = row_bounds(first.shape, max_elems)
    whole = len(span) == 1
    one = out is not None and not isinstance(out, tuple)
    outs = None if out is None else (out,) if one else tuple(out)
    for a, b in span:
        got = fn(*(_read(x, a, b, whole) for x in leaves))
        if out is None:
            one = not isinstance(got, tuple)
        got = (got,) if one else got
        if outs is None:
            dts = dtypes if isinstance(dtypes, tuple) else (dtypes,) * len(got)
            if whole and not isinstance(first, ShardedTensor):
                res = tuple(t if d is None else t.to(d) for t, d in zip(got, dts))
                return res[0] if one else res
            outs = tuple(first.empty_like(d or t.dtype) if isinstance(first, ShardedTensor)
                         else torch.empty(first.shape, dtype=d or t.dtype, device=first.device)
                         for t, d in zip(got, dts))
        for o, t in zip(outs, got):
            _write(o, a, b, whole, t)
    return outs[0] if one else outs


def whole(x: Any) -> Any:
    """A sharded leaf gathered on its home device; anything else as is."""
    return x.gather() if isinstance(x, ShardedTensor) else x


def shard_tree(tree: Any, shardings: Any, home=None) -> Any:
    """Each tensor leaf of ``tree`` whose leaf in ``shardings`` (the same
    nesting) is a :class:`NamedSharding` split into a :class:`ShardedTensor`;
    a None sharding, or a non-tensor leaf, kept as is."""
    from .._device import tree_map

    def put(leaf, sh):
        if sh is None or not isinstance(leaf, torch.Tensor):
            return leaf
        return ShardedTensor.from_tensor(leaf, sh, home)

    return tree_map(put, tree, shardings)


def shard_params(params: Any, mesh: Mesh, rules: dict | None = None, home=None, *,
                 specs: Any) -> Any:
    """A parameter tree split over ``mesh``: each leaf by the reference's
    rules (``rules`` over :data:`DEFAULT_RULES`) from the logical axes of its
    ``ParamSpec`` in ``specs`` (the same nesting), home ``home`` (default:
    the leaf's device)."""
    from .._device import tree_map

    shardings = tree_map(lambda s: named_sharding(mesh, s.shape, s.logical, rules), specs)
    return shard_tree(params, shardings, home)


def gather_params(tree: Any) -> Any:
    """Every sharded leaf of ``tree`` gathered whole on its home device."""
    from .._device import tree_map

    return tree_map(whole, tree)
