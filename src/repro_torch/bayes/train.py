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

A step is factored into :func:`propose` (log u, then theta': the random walk,
or with ``proposal="mala"`` a Langevin move along the gradient of the
estimated log posterior) and :func:`subsampled_decide` / :func:`exact_decide`
/ :func:`cached_decide` (the test and the choice), so a caller can hand in a
theta' and log u made elsewhere. The decision is read on the host (the test
reads ``done`` every round anyway), so the new state is theta or theta' as
they are, without a ``where`` over every leaf. A round's rows are the
round's slice of the pool, known on the host from the round's number (the
stream sampler's position), so a round reads nothing else from the card.

:func:`make_cached_train_step` keeps a :class:`LogLikCache` of l(theta) per
pooled sequence (the paper's Sec. 3.5 lazy stale-node update at tensor
scale): a round whose whole slice is valid skips the theta forward.

The parameters may be sharded leaves on a mesh of slots
(:class:`repro_torch.distributed.ShardedTensor`), and the batch too
(``data.shard_batch``). The proposal and the prior then read and write the
leaves chunk by chunk on their home device, in the unsharded chunks, and
the forwards gather one layer at a time, so every step is the unsharded
step bit for bit. MALA's gradient over sharded leaves comes back sharded:
autograd sees each gather (:class:`repro_torch.distributed.GradTape`), and
each read's row gradient is written into its owners' pieces.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from .._device import resolve_device, tree_leaves
from ..distributed.sharding import GradTape, ShardedTensor, iter_rows, map_rows
from ..core.samplers import StreamSliceState, stream_draw, stream_reset
from ..core.sequential_test import sequential_test
from ..core.subsampled_mh import draw_log_u
from ..models.transformer import ModelConfig, forward_loglik
from ..obs.trace import span

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
    if tc.proposal not in ("rw", "mala"):
        raise ValueError(f"unknown proposal {tc.proposal!r}")


def _perturb_leaf(gen: torch.Generator, leaf: torch.Tensor, sigma: float) -> torch.Tensor:
    """leaf + sigma * N(0, I), in float32, cast back to the leaf's dtype,
    chunk by chunk of rows (:func:`~repro_torch.distributed.sharding.map_rows`).
    A sharded leaf's noise is drawn on its home device in the unsharded
    chunks' order and shapes, each chunk of rows gathered there, perturbed
    as the unsharded chunk is and scattered into theta''s pieces: the same
    bits."""
    def perturb(row):
        n = torch.randn(row.shape, generator=gen, dtype=F32, device=row.device)
        return torch.add(row, n, alpha=sigma)

    return map_rows(perturb, [leaf], dtypes=leaf.dtype)


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
    (by chunks, summed in float32), the leaves' sums added in float32. A
    sharded leaf's chunks are the unsharded ones, gathered on home: a sum
    over its pieces would change the order of the additions."""
    total = None
    for _, leaf in _flat_paths(tree):
        s = torch.zeros((), dtype=F32, device=leaf.device)
        for row in iter_rows(leaf):
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


def mala_grads(cfg: ModelConfig, tc: TrainConfig, params: Params, batch: dict) -> dict:
    """The gradient of the reference's estimated log posterior,
    ``sum(l(first round_batch rows)) * N / rb - 0.5 sum(theta^2) / prior_var``,
    as ``{path: grad}`` in sorted path order, each in its leaf's dtype.

    Autograd takes the log-likelihood part (the reference's ``jax.grad``);
    the prior's part is the cotangent ``jax.grad`` forms for it, (2 theta)
    times (-1 / prior_var) * 0.5 in float32, cast to the leaf's dtype and
    added to the first, in chunks of rows. Nothing of theta is copied: the
    forward reads the leaves through detached views that require grad. A
    sharded leaf's gradient is a :class:`ShardedTensor` of its layout: the
    backward gathers a layer's rows again rather than keep them from the
    forward (:class:`GradTape`), and the prior's part is added over the
    unsharded row chunks, each gathered on home, computed as the unsharded
    chunk is and scattered back."""
    pool = batch["tokens"].shape[0]
    rb = min(tc.round_batch, pool)
    n_sections = tc.dataset_size or pool
    flat = _flat_paths(params)
    tape = GradTape()
    leaves = {name: tape.watch(leaf) for name, leaf in flat}
    with torch.enable_grad(), tape:
        ll = forward_loglik(_rebuild(params, leaves), _rows_of(batch, 0, rb), cfg,
                            ce_chunk=tc.ce_chunk)
        grads = tape.grad(ll.sum() * (n_sections / rb))
    del ll, leaves, tape
    coef = torch.tensor(-1.0 / tc.prior_var, dtype=F32) * 0.5

    def add_prior(row, g_row):
        return g_row.add_((2 * row.to(F32)).mul_(coef.to(row.device)).to(g_row.dtype))

    out = {}
    for (name, leaf), g in zip(flat, grads):
        # a sharded leaf's gradient is its sink: read by its settled rows,
        # written into its layout's pieces; a plain one is updated in place
        dst = g.grad if isinstance(leaf, ShardedTensor) else g
        out[name] = map_rows(add_prior, [leaf, g], out=dst)
    return out


def mala_move(params: Params, grads: dict, tc: TrainConfig, noise) -> Params:
    """theta' = theta + (step / 2) g + sqrt(step) xi, in float32, cast back
    to each leaf's dtype, leaf by leaf in sorted path order and chunk by
    chunk of rows. ``noise`` is a generator (xi drawn as the random walk
    draws its noise, rounded to the leaf's dtype, as the reference's
    ``_tree_rw_propose`` on zeros rounds it) or ``{path: xi}``. ``grads``
    (from :func:`mala_grads`) is emptied as it goes, so theta, theta', the
    gradient and xi are never all held whole at once. A sharded leaf's
    theta' is sharded as it is, each chunk gathered, moved and scattered."""
    half = 0.5 * tc.mala_step
    root = tc.mala_step ** 0.5
    new = {}
    for name, leaf in _flat_paths(params):
        g = grads.pop(name)

        def move(row, g_row, xi, dtype=leaf.dtype):
            return row.to(F32) + half * g_row.to(F32) + root * xi.to(dtype).to(F32)

        if isinstance(noise, torch.Generator):
            new[name] = map_rows(lambda row, g_row: move(row, g_row, torch.randn(
                row.shape, generator=noise, dtype=F32, device=row.device)), [leaf, g],
                dtypes=leaf.dtype)
        else:
            new[name] = map_rows(move, [leaf, g, noise[name]], dtypes=leaf.dtype)
        del g
    return _rebuild(params, new)


def propose(gen: torch.Generator, params: Params, tc: TrainConfig, batch: dict | None = None,
            cfg: ModelConfig | None = None):
    """Steps 2-4 of Alg. 3 for the LM: log u, then theta'. The random walk
    needs only ``params``; ``proposal="mala"`` needs the ``batch`` and the
    ``cfg`` its gradient is taken over. Returns ``(theta_p, log_u)``."""
    _check(tc)
    log_u = draw_log_u(gen, (), tree_leaves(params)[0].device)
    if tc.proposal == "mala":
        if batch is None or cfg is None:
            raise ValueError("proposal='mala' needs the batch and the model config")
        theta_p = mala_move(params, mala_grads(cfg, tc, params, batch), tc, gen)
    else:
        theta_p = _tree_rw_propose(gen, params, tc.sigma, tc.propose_paths)
    return theta_p, log_u


def _rows_of(batch: dict, start: int, rb: int) -> dict:
    """``rb`` rows from ``start``, the start clamped so the slice fits (as
    ``lax.dynamic_slice_in_dim`` does); a sharded batch's rows are gathered
    on its home device."""
    pool = batch["tokens"].shape[0]
    start = max(0, min(start, pool - rb))
    return {k: v.rows(start, start + rb) if isinstance(v, ShardedTensor) else v[start:start + rb]
            for k, v in batch.items()}


def _test_setup(tc: TrainConfig, params: Params, theta_p: Params, log_u: torch.Tensor,
                batch: dict):
    """(pool, rb, rounds_total, n_sections, mu0, the stream sampler's state)."""
    pool = batch["tokens"].shape[0]
    rb = min(tc.round_batch, pool)
    rounds_total = tc.max_rounds or -(-pool // rb)
    n_sections = tc.dataset_size or pool
    with span("lm.prior", "prior"):
        g = _prior_delta(params, theta_p, tc.prior_var)
    mu0 = (log_u - g) / n_sections
    state = stream_reset(StreamSliceState(torch.zeros((), dtype=torch.int32,
                                                      device=mu0.device), pool))
    return pool, rb, rounds_total, n_sections, mu0, state


def subsampled_decide(cfg: ModelConfig, tc: TrainConfig, params: Params, theta_p: Params,
                      log_u: torch.Tensor, batch: dict, *, mode: str = "auto"):
    """The sequential test over the pool's sequences for a given theta' and
    log u, then the choice. Returns ``(new_params, LMTrainInfo)``."""
    pool, rb, rounds_total, n_sections, mu0, state = _test_setup(tc, params, theta_p, log_u,
                                                                  batch)
    rounds = iter(range(rounds_total))

    def eval_fn(idx):
        rows = _rows_of(batch, next(rounds) * rb, rb)  # the stream's slice of this round
        with span("lm.forward", "forward", params="theta_p"):
            lp = forward_loglik(theta_p, rows, cfg, ce_chunk=tc.ce_chunk)
        with span("lm.forward", "forward", params="theta"):
            lc = forward_loglik(params, rows, cfg, ce_chunk=tc.ce_chunk)
        return lp - lc

    res = sequential_test(None, mu0, stream_draw, eval_fn, state, n_sections, rb,
                          tc.epsilon, max_rounds=rounds_total, mode=mode)
    info = LMTrainInfo(accepted=res.decision, rounds=res.rounds, n_evaluated=res.n_evaluated,
                       mu_hat=res.mu_hat, mu0=mu0, pvalue=res.pvalue, log_u=log_u)
    return (theta_p if bool(res.decision) else params), info


class LogLikCache(NamedTuple):
    """Per-sequence log p(seq_i | theta) of the resident pool with a
    validity mask: the paper's Sec. 3.5 lazy stale-node update at tensor
    scale. An accepted proposal leaves the sections it did not evaluate
    stale (valid False); they are recomputed on first access.

    ``valid_host`` mirrors ``valid`` on the host, so deciding whether a
    round may skip its theta forward reads nothing from the card."""

    ll: torch.Tensor  # (pool,) float32
    valid: torch.Tensor  # (pool,) bool
    valid_host: np.ndarray | None = None  # (pool,) bool; None: read from ``valid``

    @staticmethod
    def empty(pool: int, *, device=None) -> "LogLikCache":
        dev = resolve_device(device)
        return LogLikCache(torch.zeros((pool,), dtype=F32, device=dev),
                           torch.zeros((pool,), dtype=torch.bool, device=dev),
                           np.zeros((pool,), dtype=bool))

    def host_valid(self) -> np.ndarray:
        return self.valid.cpu().numpy() if self.valid_host is None else self.valid_host


def cached_decide(cfg: ModelConfig, tc: TrainConfig, params: Params, theta_p: Params,
                  log_u: torch.Tensor, batch: dict, cache: LogLikCache, *,
                  mode: str = "auto"):
    """:func:`subsampled_decide` over a log-likelihood cache of theta.
    Returns ``(new_params, new_cache, LMTrainInfo)``.

    A round evaluates theta' on its slice, and theta only where the cache is
    stale: not at all when the whole slice is valid. The round writes
    l(theta) into the current cache (the slice becomes valid) and records
    l(theta'). After an accept the evaluated sections carry l(theta') and
    the rest go stale; after a reject the updated current cache is kept.
    ``cache`` itself is not changed."""
    pool, rb, rounds_total, n_sections, mu0, state = _test_setup(tc, params, theta_p, log_u,
                                                                  batch)
    if cache.ll.shape != (pool,):
        raise ValueError(f"a cache of {tuple(cache.ll.shape)} for a pool of {pool}")
    cur_ll, cur_valid = cache.ll.clone(), cache.valid.clone()
    cur_host = cache.host_valid().copy()
    prop_ll = torch.zeros_like(cur_ll)
    evald = torch.zeros_like(cur_valid)
    evald_host = np.zeros((pool,), dtype=bool)
    rounds = iter(range(rounds_total))

    def eval_fn(idx, aux):
        start = min(next(rounds) * rb, pool - rb)  # the stream's slice, clamped to fit
        sl = slice(start, start + rb)
        rows = _rows_of(batch, start, rb)
        with span("lm.forward", "forward", params="theta_p"):
            lp = forward_loglik(theta_p, rows, cfg, ce_chunk=tc.ce_chunk)
        if cur_host[sl].all():  # every cached value is fresh: no theta forward
            lcur = cur_ll[sl].clone()
        else:
            with span("lm.forward", "forward", params="theta"):
                lc = forward_loglik(params, rows, cfg, ce_chunk=tc.ce_chunk)
            lcur = torch.where(cur_valid[sl], cur_ll[sl], lc)
        cur_ll[sl] = lcur
        cur_valid[sl] = True
        cur_host[sl] = True
        prop_ll[sl] = lp
        evald[sl] = True
        evald_host[sl] = True
        return lp - lcur, aux

    res = sequential_test(None, mu0, stream_draw, eval_fn, state, n_sections, rb,
                          tc.epsilon, max_rounds=rounds_total, mode=mode, aux=())
    accept = bool(res.decision)
    new_cache = (LogLikCache(prop_ll, evald, evald_host) if accept
                 else LogLikCache(cur_ll, cur_valid, cur_host))
    info = LMTrainInfo(accepted=res.decision, rounds=res.rounds, n_evaluated=res.n_evaluated,
                       mu_hat=res.mu_hat, mu0=mu0, pvalue=res.pvalue, log_u=log_u)
    return (theta_p if accept else params), new_cache, info


def exact_decide(cfg: ModelConfig, tc: TrainConfig, params: Params, theta_p: Params,
                 log_u: torch.Tensor, batch: dict):
    """Alg. 1 at LM scale: every sequence of the pool, then the exact rule."""
    pool = batch["tokens"].shape[0]
    rb = min(tc.round_batch, pool)
    rounds = -(-pool // rb)
    with span("lm.prior", "prior"):
        g = _prior_delta(params, theta_p, tc.prior_var)
    total = torch.zeros((), dtype=F32, device=log_u.device)
    for r in range(rounds):
        rows = _rows_of(batch, r * rb, rb)
        with span("lm.forward", "forward", params="theta_p"):
            lp = forward_loglik(theta_p, rows, cfg, ce_chunk=tc.ce_chunk)
        with span("lm.forward", "forward", params="theta"):
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
        with span("lm.step", "step", root=True):
            with span("lm.propose", "propose", proposal=tc.proposal):
                theta_p, log_u = propose(gen, params, tc, batch, cfg)
            return subsampled_decide(cfg, tc, params, theta_p, log_u, batch, mode=mode)

    return train_step


def make_exact_step(cfg: ModelConfig, tc: TrainConfig):
    """``step(gen, params, batch) -> (params', LMTrainInfo)``: the O(N)
    baseline over the whole pool."""
    _check(tc)

    def exact_step(gen, params, batch):
        with span("lm.step", "step", root=True):
            with span("lm.propose", "propose", proposal=tc.proposal):
                theta_p, log_u = propose(gen, params, tc, batch, cfg)
            return exact_decide(cfg, tc, params, theta_p, log_u, batch)

    return exact_step


def make_cached_train_step(cfg: ModelConfig, tc: TrainConfig, *, mode: str = "auto"):
    """``step(gen, params, batch, cache) -> (params', cache', LMTrainInfo)``:
    subsampled MH with the lazy log-likelihood cache.

    Each round of the plain step runs two forwards (theta and theta'). With
    the cache the theta forward is skipped whenever the round's slice is
    entirely valid: on a resident pool that stays the same across steps, a
    round's forwards drop from 2 to 1 + the acceptance rate. The proposal
    is the random walk, as in the reference's cached step (which reads
    neither ``proposal`` nor ``mala_step``); start with
    ``LogLikCache.empty(pool, device=...)``."""
    _check(tc)

    def train_step(gen, params, batch, cache: LogLikCache):
        with span("lm.step", "step", root=True):
            with span("lm.propose", "propose", proposal="rw"):
                log_u = draw_log_u(gen, (), tree_leaves(params)[0].device)
                theta_p = _tree_rw_propose(gen, params, tc.sigma, tc.propose_paths)
            return cached_decide(cfg, tc, params, theta_p, log_u, batch, cache, mode=mode)

    return train_step
