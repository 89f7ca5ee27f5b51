"""Minimal functional optimizers (Adam, SGD, SGLD) over parameter trees: the
port of ``repro.optim.optimizers``.

A tree is a tensor or a nested dict / list / tuple of tensors (the port's LM
parameters are nested dicts). Every step returns new tensors and leaves its
inputs as they are. Each leaf updates in float32 and is cast back to its own
dtype, in the reference's order of operations:

  Adam   m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g;
         p - (lr m / (1 - b1^c)) / (sqrt(v / (1 - b2^c)) + eps)
  SGD    p - lr g
  SGLD   (p + lr g) + sqrt(2 lr T) xi

``torch.optim.Adam`` places ``eps`` and the bias corrections differently, so
its numbers are not the reference's. ``b1^c`` is float32 ``torch.pow``;
XLA's ``pow`` may differ from it by one ulp at some counts, which moves a
float32 leaf by at most an ulp or two.

SGLD takes a ``torch.Generator`` where the reference takes a key, and draws
one float32 normal tensor per leaf in the reference's leaf order (sorted dict
keys), so the noise is the reference's in distribution, not in bits.

:func:`lm_loss_fn` is the mean negative log-likelihood per token of the LM;
:func:`value_and_grad` gives its value and gradient by autograd through the
port's eager forward (the counterpart of ``jax.value_and_grad``).

Every leaf is updated chunk by chunk of its leading-axis rows
(:func:`~repro_torch.distributed.sharding.map_rows`; a leaf of up to 64 M
elements is one chunk). A leaf may be a
:class:`~repro_torch.distributed.ShardedTensor` (the LM's parameters on a
mesh of slots): its gradient, moments and new value are sharded alike, each
chunk gathered on its home device, computed as the plain leaf's chunk is
and scattered back, so the bits are the unsharded step's. The reference has
no mesh code here: GSPMD splits its jitted step.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .._device import tree_leaves, tree_map
from ..distributed.sharding import GradTape, ShardedTensor, map_rows

Params = Any
F32 = torch.float32


class AdamState(NamedTuple):
    mu: Params
    nu: Params
    count: torch.Tensor  # int32, 0-d, on the leaves' device


def _zeros_f32(p):
    if isinstance(p, ShardedTensor):
        return p.zeros_like(F32)
    return torch.zeros(p.shape, dtype=F32, device=p.device)


def adam_init(params: Params) -> AdamState:
    zeros = tree_map(_zeros_f32, params)
    device = tree_leaves(params)[0].device
    return AdamState(mu=zeros, nu=tree_map(_zeros_f32, params),
                     count=torch.zeros((), dtype=torch.int32, device=device))


def adam_step(grads: Params, state: AdamState, params: Params, lr: float = 1e-3,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> tuple[Params, AdamState]:
    count = state.count + 1
    cf = count.to(F32)
    c1 = 1 - b1 ** cf  # 0-d float32, as the reference's weak-typed scalars
    c2 = 1 - b2 ** cf

    def upd_rows(g, m, v, p):
        # in-place ops on fresh temporaries only: the same roundings as the
        # reference's expressions, with fewer full-size buffers alive
        g = g.to(F32)
        m = torch.mul(m, b1).add_(torch.mul(g, 1 - b1))
        v = torch.mul(v, b2).add_(torch.mul(g, 1 - b2).mul_(g))
        den = torch.div(v, c2).sqrt_().add_(eps)
        step = torch.div(m, c1).mul_(lr).div_(den)
        del den
        return p.to(F32).sub(step).to(p.dtype), m, v

    def upd(g, m, v, p):
        return map_rows(lambda p_, g_, m_, v_: upd_rows(g_, m_, v_, p_), [p, g, m, v])

    out = tree_map(upd, grads, state.mu, state.nu, params)
    return _unzip(out, 0), AdamState(_unzip(out, 1), _unzip(out, 2), count)


def _is_triple(x) -> bool:
    return isinstance(x, tuple) and len(x) == 3 and all(
        isinstance(t, (torch.Tensor, ShardedTensor)) for t in x)


def _unzip(tree: Any, i: int) -> Any:
    """Element ``i`` of every (param, mu, nu) triple of a tree of triples."""
    if _is_triple(tree):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _unzip(v, i) for k, v in tree.items()}
    return type(tree)(_unzip(v, i) for v in tree)


def sgd_step(grads: Params, params: Params, lr: float = 1e-2) -> Params:
    return tree_map(lambda p, g: map_rows(
        lambda p_, g_: (p_.to(F32) - lr * g_.to(F32)).to(p_.dtype), [p, g]), params, grads)


def _sorted_paths(tree: Any, prefix: tuple = ()) -> list[tuple]:
    """The leaves' paths in the reference's flatten order: dict keys sorted."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _sorted_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [q for i, v in enumerate(tree) for q in _sorted_paths(v, prefix + (i,))]
    return [prefix]


def _with_paths(fn: Callable, tree: Any, *rest: Any, prefix: tuple = ()) -> Any:
    """``tree_map`` that also hands ``fn`` each leaf's path."""
    if isinstance(tree, dict):
        return {k: _with_paths(fn, v, *(r[k] for r in rest), prefix=prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_with_paths(fn, *xs, prefix=prefix + (i,))
                          for i, xs in enumerate(zip(tree, *rest)))
    return fn(prefix, tree, *rest)


def sgld_step(gen: torch.Generator, grads: Params, params: Params, lr: float,
              temperature: float = 1.0) -> Params:
    """Stochastic gradient Langevin dynamics, the classic scalable-Bayes
    comparator to subsampled MH: one normal draw from ``gen`` per leaf, in
    sorted leaf order (of a sharded leaf too, whole on its home device, so
    the generator's stream is the unsharded step's). Each leaf's noise is
    drawn just before its update and freed after it: the updates draw
    nothing, so the stream is that of drawing every leaf's noise first,
    while at most one leaf's noise lives at a time."""
    noise_scale = (2.0 * lr * temperature) ** 0.5
    new = {}
    for path in _sorted_paths(params):
        p, g = _at(params, path), _at(grads, path)
        xi = torch.randn(p.shape, generator=gen, dtype=F32, device=p.device)
        new[path] = map_rows(lambda p_, g_, xi_: (p_.to(F32) + lr * g_.to(F32)
                                                  + noise_scale * xi_).to(p_.dtype), [p, g, xi])
        del xi
    return _with_paths(lambda path, p: new.pop(path), params)


def _at(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def lm_loss_fn(cfg):
    """Mean negative log-likelihood per token (for the Adam/SGD substrate):
    ``loss(params, batch) = -sum(forward_loglik) / max(sum(mask[:, 1:]), 1)``."""
    from ..models.transformer import forward_loglik

    def loss(params, batch):
        ll = forward_loglik(params, batch, cfg)
        denom = torch.clamp_min(batch["mask"][:, 1:].sum(), 1)
        return -ll.sum() / denom

    return loss


def value_and_grad(fn: Callable) -> Callable:
    """``vg(params, *args) -> (value, grads)``: ``fn``'s value and its
    gradient with respect to every leaf of ``params`` (a tree of the same
    structure, each leaf in its own dtype; zeros for a leaf ``fn`` does not
    read), by autograd. ``params`` is read through detached views; nothing
    of it is copied or changed. A sharded leaf's gradient is sharded alike
    (:class:`~repro_torch.distributed.GradTape`)."""

    def vg(params, *args):
        tape = GradTape()
        tree = tree_map(tape.watch, params)
        with torch.enable_grad(), tape:
            value = fn(tree, *args)
            grads = tape.grad(value, allow_unused=True)

        def finish(leaf, g):
            if isinstance(leaf, ShardedTensor):
                return g.finish()
            return torch.zeros_like(leaf) if g is None else g

        it = iter(finish(l, g) for l, g in zip(tape.watched, grads))
        return value.detach(), tree_map(lambda _: next(it), tree)

    return vg
