"""Device resolution and the small tree helpers the port uses in place of
pytrees.

Every public constructor that creates tensors takes ``device=None``, which
means the CUDA card. Without a card that raises: a caller who wants the CPU
(the tests) says ``device="cpu"``. Nothing carries on silently on the CPU.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; raises when that card is absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def make_generator(seed, device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device``: ``seed`` is an int, or a generator
    that already lives there (returned as is)."""
    if isinstance(seed, torch.Generator):
        if seed.device.type != torch.device(device).type:
            raise ValueError(
                f"generator lives on {seed.device}, the run on {device}"
            )
        return seed
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def to_leaf(leaf, device) -> torch.Tensor:
    """A theta leaf on ``device``: an int32 leaf (a mixture's assignments)
    stays int32, every other leaf becomes float32."""
    t = torch.as_tensor(leaf)
    return t.to(device=device, dtype=torch.int32 if t.dtype == torch.int32 else torch.float32)


# Theta is a tensor, or a dict / tuple / list of tensors.


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_select(pred: torch.Tensor, on_true: Any, on_false: Any) -> Any:
    """``where(pred, a, b)`` leaf by leaf, ``pred`` broadcast over trailing
    leaf dims (a (K,) predicate against (K, ...) leaves, or a scalar)."""

    def sel(a, b):
        p = pred.reshape(pred.shape + (1,) * (a.ndim - pred.ndim))
        return torch.where(p, a, b)

    return tree_map(sel, on_true, on_false)


def row_chunks(t: torch.Tensor, max_elems: int) -> list[torch.Tensor]:
    """Views of ``t`` along its leading axis, each at most ``max_elems``
    elements (at least one row): the unit in which a big leaf is processed,
    so temporaries stay one chunk. A tensor at or under the bound, or of
    fewer than two dims, is one chunk."""
    if t.numel() <= max_elems or t.ndim < 2:
        return [t]
    per = max(1, max_elems // max(1, t[0].numel()))
    return list(t.split(per, dim=0))
