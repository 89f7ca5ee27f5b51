"""Checkpointing of tensor trees: the port of ``repro.checkpoint.manager``,
the part ``run_loop`` needs (``save``, ``latest_step``, ``restore``).

Layout (the port's own): ``<dir>/step_<N>/`` holds ``manifest.json`` and one
raw-bytes file per leaf, its dtype and shape in the manifest (bf16 is
written as its 16-bit pattern). A save goes to a ``.tmp`` directory renamed
into place, so a preemption during a save never damages the latest
checkpoint. ``save_async`` copies to the host on the caller's thread and
writes on a daemon thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

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


def save(ckpt_dir: str, step: int, state: Any, keep: int = 3) -> str:
    """Write ``state`` (a tree of tensors) atomically as step ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}}
    for name, leaf in _flatten(state).items():
        t = torch.as_tensor(leaf).detach().contiguous()
        host = t.view(_BITS.get(t.dtype, t.dtype)).cpu().numpy()
        fn = f"{name}.bin"
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


def _load(path: str, meta: dict, device) -> torch.Tensor:
    dtype = _DTYPES[meta["dtype"]]
    bits = _BITS.get(dtype, dtype)
    arr = np.fromfile(os.path.join(path, meta["file"]),
                      dtype=torch.empty((), dtype=bits).numpy().dtype)
    t = torch.from_numpy(arr.reshape(meta["shape"])).view(dtype)
    return t.to(device) if device is not None else t


def restore(ckpt_dir: str, step: int | None = None, target: Any = None) -> tuple[int, Any]:
    """Load a checkpoint: ``(step, tree)``. With ``target`` (a tree of the
    wanted structure) the leaves are rebuilt into its nesting and placed on
    its leaves' devices; without it, a flat dict of CPU tensors."""
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

    def rebuild(t, prefix=""):
        if isinstance(t, dict):
            return {k: rebuild(v, f"{prefix}{_SEP}{k}" if prefix else str(k)) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(rebuild(v, f"{prefix}{_SEP}{i}" if prefix else str(i))
                           for i, v in enumerate(t))
        dev = t.device if isinstance(t, torch.Tensor) else None
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
    host = {name: torch.as_tensor(leaf).detach().cpu().clone()
            for name, leaf in _flatten(state).items()}
    t = threading.Thread(target=save, args=(ckpt_dir, step, host, keep), daemon=True)
    t.start()
    return t
