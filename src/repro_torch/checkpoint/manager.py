"""Checkpointing of tensor trees: the port of ``repro.checkpoint.manager``,
the part ``run_loop`` needs (``save``, ``latest_step``, ``restore``).

Layout (the port's own): ``<dir>/step_<N>/`` holds ``manifest.json`` and one
raw-bytes file per leaf, its dtype and shape in the manifest (bf16 is
written as its 16-bit pattern). A save goes to a ``.tmp`` directory renamed
into place, so a preemption during a save never damages the latest
checkpoint. ``save_async`` copies to the host on the caller's thread and
writes on a daemon thread.

A sharded leaf (``repro_torch.distributed.ShardedTensor``) is written piece
by piece into its place in the file, the same bytes as an unsharded save.
``restore(..., shardings=)`` is the reference's elastic reshard: each owner
slot's piece is read from its slice of the file straight to the slot, and no
whole leaf is ever on a device; a target leaf that is sharded places its
restored leaf by its own sharding.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from ..distributed.sharding import ShardedTensor

_SEP = "__"
_DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int32": torch.int32, "int64": torch.int64,
           "uint8": torch.uint8, "bool": torch.bool}
_BITS = {torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{_SEP}{i}" if prefix else str(i)))
        return out
    return {prefix: tree}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _np_bits(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=_BITS.get(dtype, dtype)).numpy().dtype


def _write_sharded(path: str, leaf: ShardedTensor) -> None:
    """The whole leaf's bytes, each owner piece written into its slice."""
    if leaf.numel() == 0 or leaf.ndim == 0:
        t = leaf.gather().view(_BITS.get(leaf.dtype, leaf.dtype)).cpu().numpy()
        t.tofile(path)
        return
    out = np.memmap(path, dtype=_np_bits(leaf.dtype), mode="w+", shape=tuple(leaf.shape))
    for blk, piece in zip(leaf.blocks, leaf.pieces):
        out[blk.index] = piece.detach().view(_BITS.get(leaf.dtype, leaf.dtype)).cpu().numpy()
    out.flush()
    del out


def save(ckpt_dir: str, step: int, state: Any, keep: int = 3) -> str:
    """Write ``state`` (a tree of tensors, sharded leaves among them)
    atomically as step ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}}
    for name, leaf in _flatten(state).items():
        fn = f"{name}.bin"
        if isinstance(leaf, ShardedTensor):
            _write_sharded(os.path.join(tmp, fn), leaf)
            t = leaf
        else:
            t = torch.as_tensor(leaf).detach().contiguous()
            host = t.view(_BITS.get(t.dtype, t.dtype)).cpu().numpy()
            with open(os.path.join(tmp, fn), "wb") as f:
                host.tofile(f)
        manifest["leaves"][name] = {"file": fn, "dtype": _dtype_name(t), "shape": list(t.shape)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _cleanup(ckpt_dir, keep)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _load_sharded(path: str, meta: dict, sharding, home) -> ShardedTensor:
    """The leaf of ``meta`` split by ``sharding``: each owner piece read from
    its slice of the file (a memory map) onto its slot."""
    dtype = _DTYPES[meta["dtype"]]
    shape = tuple(meta["shape"])
    file = os.path.join(path, meta["file"])
    if shape and int(np.prod(shape)):
        src = np.memmap(file, dtype=_np_bits(dtype), mode="r", shape=shape)
    else:  # a memory map needs a dim and a byte
        src = np.fromfile(file, dtype=_np_bits(dtype)).reshape(shape)
    out = ShardedTensor.empty(sharding, shape, dtype, home)
    for blk, piece in zip(out.blocks, out.pieces):
        piece.copy_(torch.from_numpy(np.array(src[blk.index])).view(dtype))
    del src
    return out


def _load(path: str, meta: dict, device) -> torch.Tensor:
    dtype = _DTYPES[meta["dtype"]]
    bits = _BITS.get(dtype, dtype)
    arr = np.fromfile(os.path.join(path, meta["file"]),
                      dtype=torch.empty((), dtype=bits).numpy().dtype)
    t = torch.from_numpy(arr.reshape(meta["shape"])).view(dtype)
    return t.to(device) if device is not None else t


def restore(ckpt_dir: str, step: int | None = None, target: Any = None,
            shardings: Any = None) -> tuple[int, Any]:
    """Load a checkpoint: ``(step, tree)``. With ``target`` (a tree of the
    wanted structure) the leaves are rebuilt into its nesting and placed on
    its leaves' devices; without it, a flat dict of CPU tensors.
    ``shardings`` (the target's nesting; a ``NamedSharding`` or None a leaf)
    splits each leaf that has one over its mesh, home the target leaf's
    device: pass the shardings of a new mesh to reshard on restore. A target
    leaf that is a ``ShardedTensor`` and has no sharding there is split by
    its own."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = manifest["leaves"]
    if target is None:
        return manifest["step"], {name: _load(path, meta, None) for name, meta in leaves.items()}
    flat_t = _flatten(target)
    if set(flat_t) != set(leaves):
        raise ValueError(f"checkpoint/target mismatch: {set(flat_t) ^ set(leaves)}")
    sh_flat = _flatten(shardings) if shardings is not None else {}

    def rebuild(t, prefix=""):
        if isinstance(t, dict):
            return {k: rebuild(v, f"{prefix}{_SEP}{k}" if prefix else str(k)) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(rebuild(v, f"{prefix}{_SEP}{i}" if prefix else str(i))
                           for i, v in enumerate(t))
        dev = t.device if isinstance(t, (torch.Tensor, ShardedTensor)) else None
        sh = sh_flat.get(prefix)
        if sh is None and isinstance(t, ShardedTensor):
            sh = t.sharding
        if sh is not None:
            return _load_sharded(path, leaves[prefix], sh, dev if dev is not None else "cpu")
        return _load(path, leaves[prefix], dev)

    return manifest["step"], rebuild(target)


def _cleanup(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def save_async(ckpt_dir: str, step: int, state: Any, keep: int = 3) -> threading.Thread:
    """Copy ``state`` to the host now (cheap), write it on a daemon thread;
    returns the thread (``join`` it before reading the checkpoint)."""
    host = {name: leaf.to_host() if isinstance(leaf, ShardedTensor)
            else torch.as_tensor(leaf).detach().cpu().clone()
            for name, leaf in _flatten(state).items()}
    t = threading.Thread(target=save, args=(ckpt_dir, step, host, keep), daemon=True)
    t.start()
    return t
