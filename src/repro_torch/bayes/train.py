"""LM-scale subsampled MH: the port of ``repro.bayes.train``. One train
step is one approximate MH transition over all of a model's parameters
theta under p(theta) prod_i p(seq_i | theta).

Mapping onto the paper:
  - local section i = one training sequence; l_i = log p(seq_i | theta') -
    log p(seq_i | theta) (two forward passes, no backward), through
    :func:`repro_torch.models.forward_loglik`;
  - global section = the Gaussian prior ratio (the random walk is
    symmetric);
  - draws without replacement = contiguous slices of the resident pool (the
    stream sampler);
  - accept/reject = Alg. 2's sequential t-test
    (:func:`repro_torch.core.sequential_test`).

A step is factored into :func:`propose` (log u, then theta') and
:func:`subsampled_decide` / :func:`exact_decide` (the test and the choice),
so a caller can hand in a theta' and log u made elsewhere. The decision is
read on the host (the test reads ``done`` every round anyway), so the new
state is theta or theta' as they are, without a ``where`` over every leaf.

Deferred: ``make_cached_train_step`` (the lazy log-likelihood cache threads
``aux`` through the sequential test) and ``proposal="mala"`` (with
``MALA``); both raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from .._device import row_chunks, tree_leaves
from ..core.samplers import StreamSliceState, stream_draw, stream_reset
from ..core.sequential_test import sequential_test
from ..core.subsampled_mh import draw_log_u
from ..models.transformer import ModelConfig, forward_loglik

Params = Any
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    round_batch: int = 64  # sequences per test round
    max_rounds: int | None = None  # default: pool // round_batch
    epsilon: float = 0.05
    sigma: float = 1e-4  # RW proposal std
    prior_var: float = 1.0
    ce_chunk: int = 256
    dataset_size: int | None = None  # N; defaults to the resident pool size
    proposal: str = "rw"  # "rw" | "mala"
    mala_step: float = 1e-6
    # restrict proposals to leaves whose '/'-joined path contains one of these
    # substrings (e.g. ("final_norm",) for a Bayesian last layer); None = all
    propose_paths: tuple | None = None
    cached: bool = False  # the lazy log-likelihood cache


class LMTrainInfo(NamedTuple):
    accepted: torch.Tensor
    rounds: torch.Tensor
    n_evaluated: torch.Tensor
    mu_hat: torch.Tensor
    mu0: torch.Tensor
    pvalue: torch.Tensor
    log_u: torch.Tensor


def _check(tc: TrainConfig) -> None:
    if tc.proposal == "mala":
        raise NotImplementedError("proposal='mala' comes with MALA in a later slice")
    if tc.proposal != "rw":
        raise ValueError(f"unknown proposal {tc.proposal!r}")
    if tc.cached:
        raise NotImplementedError("the cached train step comes with the sequential test's aux")


# Leaves above this many elements get their noise and their prior terms in
# chunks of leading-axis rows of at most this size (one 56 M-element layer of
# chatglm3-6b's stacked MLP leaf, 16384 rows of its embedding table): a
# float32 temporary of the whole MLP leaf would be 6.3 GB, while every chunk
# costs a few launches of host time (~107 chunks for the whole model here;
# 4 M-element chunks left the card idle two thirds of a step).
_CHUNK = 1 << 26


def _perturb_leaf(gen: torch.Generator, leaf: torch.Tensor, sigma: float) -> torch.Tensor:
    """leaf + sigma * N(0, I), in float32, cast back to the leaf's dtype."""
    out = torch.empty_like(leaf)
    for row, dst in zip(row_chunks(leaf, _CHUNK), row_chunks(out, _CHUNK)):
        n = torch.randn(row.shape, generator=gen, dtype=F32, device=row.device)
        dst.copy_(torch.add(row, n, alpha=sigma))
    return out


def _flat_paths(tree: Params, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) in the reference's flattening order (sorted dict keys)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flat_paths(tree[k], f"{prefix}/{k}" if prefix else str(k)))
        return out
    return [(prefix, tree)]


def _tree_rw_propose(gen: torch.Generator, tree: Params, sigma: float,
                     paths: tuple | None = None) -> Params:
    """theta' = theta + sigma * xi on every leaf whose path matches
    ``paths`` (all leaves when None); the other leaves are shared, not
    copied. Noise is drawn leaf by leaf in sorted path order."""
    new = {}
    for name, leaf in _flat_paths(tree):
        if paths is not None and not any(s in name for s in paths):
            new[name] = leaf
        else:
            new[name] = _perturb_leaf(gen, leaf, sigma)
    return _rebuild(tree, new)


def _rebuild(tree: Params, flat: dict, prefix: str = "") -> Params:
    """``tree``'s nesting with the leaves of ``flat`` (keyed by path). A
    module-level function: a recursive closure over ``flat`` would be a
    reference cycle holding every leaf of theta' until the cyclic collector
    runs (12 GB a step at chatglm3-6b's size)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return flat[prefix]


def _sq_total(tree: Params) -> torch.Tensor:
    """The reference's float32 total of squares: over every leaf in its
    flattening order (sorted paths), each leaf's float32 sum of squares
    (by chunks, summed in float32), the leaves' sums added in float32."""
    total = None
    for _, leaf in _flat_paths(tree):
        s = torch.zeros((), dtype=F32, device=leaf.device)
        for row in row_chunks(leaf, _CHUNK):
            r = row.to(F32).reshape(-1)
            s = s + torch.dot(r, r)
        total = s if total is None else total + s
    return total


def _prior_delta(theta: Params, theta_p: Params, prior_var: float) -> torch.Tensor:
    """log p(theta') - log p(theta) under N(0, prior_var I), as the
    reference computes it: the difference of two float32 totals,
    sum(theta'^2) - sum(theta^2), every leaf in both (those theta' shares
    with theta too). The totals' rounding is the reference's own error,
    which the port replicates (ROADMAP, Faults 2)."""
    return (-0.5 / prior_var) * (_sq_total(theta_p) - _sq_total(theta))


def propose(gen: torch.Generator, params: Params, tc: TrainConfig):
    """Steps 2-4 of Alg. 3 for the LM: log u, then the random-walk theta'.
    Returns ``(theta_p, log_u)``."""
    _check(tc)
    log_u = draw_log_u(gen, (), tree_leaves(params)[0].device)
    theta_p = _tree_rw_propose(gen, params, tc.sigma, tc.propose_paths)
    return theta_p, log_u


def _rows_of(batch: dict, start: int, rb: int) -> dict:
    """``rb`` rows from ``start``, the start clamped so the slice fits (as
    ``lax.dynamic_slice_in_dim`` does)."""
    pool = batch["tokens"].shape[0]
    start = max(0, min(start, pool - rb))
    return {k: v[start:start + rb] for k, v in batch.items()}


def subsampled_decide(cfg: ModelConfig, tc: TrainConfig, params: Params, theta_p: Params,
                      log_u: torch.Tensor, batch: dict, *, mode: str = "auto"):
    """The sequential test over the pool's sequences for a given theta' and
    log u, then the choice. Returns ``(new_params, LMTrainInfo)``."""
    pool = batch["tokens"].shape[0]
    rb = min(tc.round_batch, pool)
    rounds_total = tc.max_rounds or -(-pool // rb)
    n_sections = tc.dataset_size or pool
    g = _prior_delta(params, theta_p, tc.prior_var)
    mu0 = (log_u - g) / n_sections

    def eval_fn(idx):
        rows = _rows_of(batch, int(idx[0]), rb)
        lp = forward_loglik(theta_p, rows, cfg, ce_chunk=tc.ce_chunk)
        lc = forward_loglik(params, rows, cfg, ce_chunk=tc.ce_chunk)
        return lp - lc

    state = stream_reset(StreamSliceState(torch.zeros((), dtype=torch.int32,
                                                      device=mu0.device), pool))
    res = sequential_test(None, mu0, stream_draw, eval_fn, state, n_sections, rb,
                          tc.epsilon, max_rounds=rounds_total, mode=mode)
    info = LMTrainInfo(accepted=res.decision, rounds=res.rounds, n_evaluated=res.n_evaluated,
                       mu_hat=res.mu_hat, mu0=mu0, pvalue=res.pvalue, log_u=log_u)
    return (theta_p if bool(res.decision) else params), info


def exact_decide(cfg: ModelConfig, tc: TrainConfig, params: Params, theta_p: Params,
                 log_u: torch.Tensor, batch: dict):
    """Alg. 1 at LM scale: every sequence of the pool, then the exact rule."""
    pool = batch["tokens"].shape[0]
    rb = min(tc.round_batch, pool)
    rounds = -(-pool // rb)
    g = _prior_delta(params, theta_p, tc.prior_var)
    total = torch.zeros((), dtype=F32, device=log_u.device)
    for r in range(rounds):
        rows = _rows_of(batch, r * rb, rb)
        lp = forward_loglik(theta_p, rows, cfg, ce_chunk=tc.ce_chunk)
        lc = forward_loglik(params, rows, cfg, ce_chunk=tc.ce_chunk)
        total = total + (lp - lc).sum()
    accept = log_u < g + total
    dev = log_u.device
    info = LMTrainInfo(
        accepted=accept,
        rounds=torch.tensor(rounds, dtype=torch.int32, device=dev),
        n_evaluated=torch.tensor(pool, dtype=torch.int32, device=dev),
        mu_hat=total / pool,
        mu0=(log_u - g) / pool,
        pvalue=torch.zeros((), dtype=F32, device=dev),
        log_u=log_u,
    )
    return (theta_p if bool(accept) else params), info


def make_train_step(cfg: ModelConfig, tc: TrainConfig, *, mode: str = "auto"):
    """``step(gen, params, batch) -> (params', LMTrainInfo)``: one subsampled
    MH transition. ``mode`` is the kernel dispatch of the test's round op."""
    _check(tc)

    def train_step(gen, params, batch):
        theta_p, log_u = propose(gen, params, tc)
        return subsampled_decide(cfg, tc, params, theta_p, log_u, batch, mode=mode)

    return train_step


def make_exact_step(cfg: ModelConfig, tc: TrainConfig):
    """``step(gen, params, batch) -> (params', LMTrainInfo)``: the O(N)
    baseline over the whole pool."""
    _check(tc)

    def exact_step(gen, params, batch):
        theta_p, log_u = propose(gen, params, tc)
        return exact_decide(cfg, tc, params, theta_p, log_u, batch)

    return exact_step


def make_cached_train_step(cfg: ModelConfig, tc: TrainConfig):
    raise NotImplementedError("the cached train step comes with the sequential test's aux")
