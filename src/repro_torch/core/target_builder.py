"""Target construction: one kernel-family registry for every workload.

The port of ``repro.core.target_builder``. A target declares its
local-likelihood family and the builder attaches

  * ``log_local``          the (m,) pair delta of one chain's round,
  * ``log_local_ensemble`` the (K, m) lock-step round, both through the
                           kernel dispatch of :mod:`repro_torch.kernels.ops`,
  * ``log_density``        prior + full local sum, for diagnostics,
  * ``bind``               the round evaluator of one transition (see
                           :meth:`~repro_torch.core.target.PartitionedTarget.local_round`).

Registered families: ``logit`` (BayesLR: data = (x (N, D), y (N,)), params
= w), ``gaussian_ar1`` (stochastic volatility: data = (xt, xp), the
current and previous latent state of each transition factor, as shared (N,)
or per-chain (K, N) pools; params = (phi, sigma^2)), ``ce`` (an LM's
likelihood over its unembedding: data = (h (N, D), targets (N,)), the
frozen final hidden states and next tokens; params = the table (V, D), or
(K, V, D) for K chains; each delta is two passes of the fused CE kernel)
and ``gaussian_mean`` (the conjugate model of the subposterior harness:
data = x (N, D), params = theta (D,); plain torch, as the reference's is
``jnp`` that XLA fuses with no Pallas kernel).
``data`` may be a callable ``theta -> pools`` (latent-dependent sections, as in the stochvol
ensemble, where the pools derive from ``theta["h"]``); the transitions then
evaluate it once per transition through ``bind``. Unlike the reference,
whose single-chain deltas call the plain versions directly, both rounds
dispatch, so no plain version runs on the card.

A target built from concrete section tensors and a ``prior_logpdf``
carries its recipe, a :class:`TargetSpec`: :mod:`repro_torch.partition`
rebuilds it on a data slice under a tempered prior, and
:func:`append_observations` on a grown pool (streaming append). The
``logit`` family also takes per-chain pools, x (K, N, D) and y (K, N), with
(K, m) indices: each chain's rows are gathered on the device (the
reference's ``_gather``) and scored by ``ops.batched_logit_delta``.

Under an ensemble's mesh (:func:`repro_torch.distributed.logical_axis_rules`,
which ``ChainEnsemble.run`` activates for a sharded run) the ensemble round
of ``bind`` splits each (K, m) block chains x data, where the reference
constrains its gather with ``lc``: slot (i, j) scores rows i and columns j
of the block with its rows of theta and theta', through the family's kernel
on the slot's device, and the pieces are assembled on the home device
before the round op. A pool of tensors is placed once on each slot device
(one copy a device, however many slots share it); a callable pool is
computed on the home device and scored there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .._device import tree_leaves, tree_map
from ..distributed import sharding
from ..kernels import ops, ref
from .target import PartitionedTarget

Params = Any


@dataclasses.dataclass(frozen=True)
class TargetSpec:
    """The recipe behind a builder-constructed target: everything
    :func:`build_target` needs to build it again. ``data`` is the section
    pool (tensors, sections along axis 0), ``prior_logpdf`` the untempered
    prior and ``prior_scale`` its exponent: ``p(theta)^(1/P)`` for one of P
    subposteriors, so that the product of the P is the full posterior
    (Scott et al., consensus Monte Carlo).
    """

    family: str
    data: Any
    num_sections: int
    prior_logpdf: Callable[[Params], torch.Tensor]
    params_fn: Callable[[Params], Any] | None = None
    prior_scale: float = 1.0


def spec_of(target: PartitionedTarget) -> TargetSpec:
    """The target's recipe, or a ``ValueError`` for a target that has none."""
    if target.spec is None:
        raise ValueError(
            "target carries no TargetSpec (hand-wired log_global/log_local, callable data, or "
            "family=None): partitioning and streaming append need a build_target(...) "
            "construction with concrete data tensors and prior_logpdf")
    return target.spec


def build_from_spec(spec: TargetSpec) -> PartitionedTarget:
    """Run the builder again on a (sliced, appended or tempered) recipe."""
    return build_target(spec.family, spec.data, spec.num_sections,
                        prior_logpdf=spec.prior_logpdf, params_fn=spec.params_fn,
                        prior_scale=spec.prior_scale)


def _section_count(data: Any) -> int:
    leaves = tree_leaves(data)
    if not leaves:
        return 0
    counts = {int(leaf.shape[0]) for leaf in leaves}
    if len(counts) != 1:
        raise ValueError(f"data leaves disagree on the section axis: {sorted(counts)}")
    return counts.pop()


def _structure(tree: Any):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in sorted(tree.items())}
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, [_structure(v) for v in tree])
    return "*"


def append_observations(target: PartitionedTarget, new_data: Any) -> PartitionedTarget:
    """A new target whose section pool is ``cat([old, new])`` along axis 0,
    on the pool's device and in its dtype, rebuilt by the same builder
    path: the same as building on the concatenated pool from scratch. An
    empty append (no new sections) returns ``target`` itself."""
    spec = spec_of(target)
    n_new = _section_count(new_data)
    if n_new == 0:
        return target
    old, new = _structure(spec.data), _structure(new_data)
    if old != new:
        raise ValueError(f"appended data structure {new} != target data structure {old}")

    def cat(a, b):
        b = torch.as_tensor(b).to(device=a.device, dtype=a.dtype)
        if tuple(a.shape[1:]) != tuple(b.shape[1:]):
            raise ValueError(f"appended section shape {tuple(b.shape[1:])} != existing "
                             f"{tuple(a.shape[1:])}")
        return torch.cat([a, b], dim=0)

    merged = tree_map(cat, spec.data, new_data)
    return build_from_spec(dataclasses.replace(spec, data=merged,
                                               num_sections=spec.num_sections + n_new))


@dataclasses.dataclass(frozen=True)
class KernelFamily:
    """A local-likelihood family: ``loglik(data, params, idx) -> (m,)``,
    ``delta(data, params, params_p, idx, mode=) -> (m,)`` for one chain,
    and ``ensemble_delta(data, params, params_p, idx, mode=) -> (K, m)`` for
    a lock-step round; ``mode`` is the kernel dispatch. ``takes_range``: the
    one-chain ``delta`` also accepts ``range(start, stop)`` for ``idx``.
    ``chain_rows(pools, rows)`` are the pools that chains ``rows`` (a slice)
    read: per-chain pools sliced, shared ones as they are (the default)."""

    name: str
    loglik: Callable[..., torch.Tensor]
    delta: Callable[..., torch.Tensor]
    ensemble_delta: Callable[..., torch.Tensor]
    takes_range: bool = False
    chain_rows: Callable[[Any, slice], Any] = lambda pools, rows: pools


_FAMILIES: dict[str, KernelFamily] = {}


def register_family(family: KernelFamily) -> KernelFamily:
    """Add a family to the registry (overwrites an existing name)."""
    _FAMILIES[family.name] = family
    return family


def get_family(name: str) -> KernelFamily:
    if name not in _FAMILIES:
        raise KeyError(f"unknown kernel family {name!r}; registered: {sorted(_FAMILIES)}")
    return _FAMILIES[name]


def registered_families() -> tuple[str, ...]:
    return tuple(sorted(_FAMILIES))


def _chain_gather(x, y, idx):
    """Each chain's rows ``idx`` (K, m) of per-chain pools x (K, N, D), y
    (K, N), gathered on their device: (K, m, D), (K, m). A (m,) index or a
    ``range`` reads the same rows of every chain."""
    if isinstance(idx, range):
        idx = torch.arange(idx.start, idx.stop, device=x.device)
    idx = idx.long()
    if idx.ndim == 1:
        idx = idx.expand(x.shape[0], -1)
    k = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[k, idx], y[k, idx]


def _per_chain_w(w, k: int):
    return w.expand(k, -1) if w.ndim == 1 else w


def _logit_loglik(data, w, idx):
    x, y = data
    if x.ndim == 3:
        xg, yg = _chain_gather(x, y, idx)
        if w.ndim == 1:
            return ref.logit_loglik(w, xg, yg)
        z = (xg.to(torch.float32) @ w.to(torch.float32)[..., None])[..., 0]  # w (K, D)
        return -ref._softplus(-yg.to(torch.float32) * z)
    idx = idx.long()
    return ref.logit_loglik(w, x[idx], y[idx])


def _logit_delta(data, w, w_p, idx, mode: str = "auto"):
    x, y = data
    if x.ndim == 3:  # per-chain pools: (K, m), as the reference's gathered form
        xg, yg = _chain_gather(x, y, idx)
        k = x.shape[0]
        return ops.batched_logit_delta(xg, yg, _per_chain_w(w, k), _per_chain_w(w_p, k),
                                       mode=mode)
    return ops.logit_delta(x, y, w, w_p, idx=idx, mode=mode)


def _logit_ensemble_delta(data, w, w_p, idx, mode: str = "auto"):
    x, y = data
    if x.ndim == 3:
        return ops.batched_logit_delta(*_chain_gather(x, y, idx), w, w_p, mode=mode)
    return ops.gather_and_delta(x, y, idx, w, w_p, mode=mode)


def _logit_chain_rows(pools, rows):
    x, y = pools
    return (x[rows], y[rows]) if x.ndim == 3 else pools


def _ar1_loglik(data, params, idx):
    phi, s2 = params
    xt, xp = (ref.gather_pool(a, idx) for a in data)
    s2c = torch.clamp_min(s2, ref.S2_FLOOR)
    z2 = (xt - phi * xp) ** 2 / s2c
    return -0.5 * (z2 + torch.log(s2c) + ref.LOG2PI)


def _ar1_delta(data, params, params_p, idx, mode: str = "auto"):
    xt, xp = data
    if isinstance(idx, range):  # a run of the shared pools, read in place
        return ops.gather_ar1_delta(xt, xp, idx, *params, *params_p, mode=mode)[0]
    out = ops.gather_ar1_delta(xt, xp, idx.reshape(1, -1), *params, *params_p, mode=mode)
    return out.reshape(idx.shape)


def _ar1_ensemble_delta(data, params, params_p, idx, mode: str = "auto"):
    xt, xp = data
    return ops.gather_ar1_delta(xt, xp, idx, *params, *params_p, mode=mode)


def _ce_loglik(data, table, idx):
    h, targets = data
    return ops.fused_ce(h, table, targets, idx=idx)


def _ce_delta(data, table, table_p, idx, mode: str = "auto"):
    h, targets = data
    return (ops.fused_ce(h, table_p, targets, idx=idx, mode=mode)
            - ops.fused_ce(h, table, targets, idx=idx, mode=mode))


def _ce_ensemble_delta(data, table, table_p, idx, mode: str = "auto"):
    # Two kernel passes, not a pair-fused one, as in the reference: the two
    # sides score against two different vocabulary tables, so both table
    # streams are irreducible; pair fusion would only share the (m, D) row
    # reads. The kernel gathers the rows itself on each pass.
    h, targets = data
    return (ops.gather_fused_ce(h, targets, idx, table_p, mode=mode)
            - ops.gather_fused_ce(h, targets, idx, table, mode=mode))


def _ar1_chain_rows(pools, rows):
    return tuple(a[rows] if a.ndim == 2 else a for a in pools)


register_family(KernelFamily("logit", _logit_loglik, _logit_delta, _logit_ensemble_delta,
                             takes_range=True, chain_rows=_logit_chain_rows))
register_family(KernelFamily("gaussian_ar1", _ar1_loglik, _ar1_delta, _ar1_ensemble_delta,
                             takes_range=True, chain_rows=_ar1_chain_rows))
register_family(KernelFamily("ce", _ce_loglik, _ce_delta, _ce_ensemble_delta))


def _gm_rows(data, idx):
    """Rows of the shared (N, D) pool: (m, D) for (m,) indices, (K, m, D)
    for (K, m)."""
    return data[idx.long()]


def _gm_loglik(data, theta, idx):
    return -0.5 * ((_gm_rows(data, idx) - theta[..., None, :]) ** 2).sum(-1)


def _gm_delta(data, theta, theta_p, idx, mode: str = "auto"):
    xg = _gm_rows(data, idx)
    return 0.5 * (((xg - theta[..., None, :]) ** 2).sum(-1)
                  - ((xg - theta_p[..., None, :]) ** 2).sum(-1))


def _gm_ensemble_delta(data, theta, theta_p, idx, mode: str = "auto"):
    xg = _gm_rows(data, idx)  # (K, m, D)
    return 0.5 * (((xg - theta[:, None, :]) ** 2).sum(-1)
                  - ((xg - theta_p[:, None, :]) ** 2).sum(-1))


# Unit-variance Gaussian mean model: data = x (N, D), params = theta (D,),
# the factor N(x_i | theta, I) up to its constant. Prior N(0, I) gives the
# closed-form posterior N(n xbar / (n+1), I / (n+1)) the subposterior
# harness holds the combined draws to. Plain torch: the reference's is jnp
# that XLA fuses, with no Pallas kernel (ROADMAP §2).
register_family(KernelFamily("gaussian_mean", _gm_loglik, _gm_delta, _gm_ensemble_delta))


def _mesh_round(mesh, fam: KernelFamily, pools, a, b, mode: str):
    """The ensemble round of one transition split over ``mesh`` (see the
    module docstring). ``pools`` is a callable ``device -> pools`` for a pool
    of tensors, else the pools computed on the home device."""
    home = tree_leaves(a)[0].device
    pieces: dict = {}  # (device, rows) -> that slot's pools, theta rows and theta' rows

    def score(blk, idx):
        rows, dev = blk.index[0], blk.device
        key = (dev, rows.start, rows.stop)
        got = pieces.get(key)
        if got is None:
            if callable(pools):
                on = pools(dev)
            elif dev == sharding.canonical(home):
                on = pools
            else:
                raise ValueError(f"a {fam.name} target with a callable pool is scored on its "
                                 f"home device {home}, not on slot device {dev}")
            got = pieces[key] = (fam.chain_rows(on, rows), sharding.rows_of(a, rows, dev),
                                 sharding.rows_of(b, rows, dev))
        return fam.ensemble_delta(*got, idx, mode=mode)

    return sharding.split_round(*mesh, home, score)


def build_target(
    family: str | None,
    data: Any = None,
    num_sections: int | None = None,
    *,
    prior_logpdf: Callable[[Params], torch.Tensor] | None = None,
    log_global: Callable[[Params, Params], torch.Tensor] | None = None,
    log_local: Callable[[Params, Params, torch.Tensor], torch.Tensor] | None = None,
    log_density: Callable[[Params], torch.Tensor] | None = None,
    params_fn: Callable[[Params], Any] | None = None,
    prior_scale: float = 1.0,
    device=None,
) -> PartitionedTarget:
    """Construct a :class:`~repro_torch.core.target.PartitionedTarget` from a
    registered kernel family.

    ``data`` is the family's section pool, or a callable ``theta -> pool``
    for sections that derive from theta (it must not read a leaf the
    proposal moves); ``params_fn`` maps theta to the family's parameters
    (default: identity). The global section comes from ``prior_logpdf``
    (differenced) or an explicit ``log_global``; the prior must accept a
    leading chain axis and return one value per chain. ``prior_scale``
    tempers the prior to ``prior_scale * log p(theta)``; with 1.0 the
    closures are exactly the untempered ones, which keeps the P = 1 fleet
    the unpartitioned path. ``device`` names where a callable's pools live
    (a pool of tensors carries its own). Given tensors for ``data`` and a
    ``prior_logpdf``, the target carries its :class:`TargetSpec`
    (``target.spec``).

        >>> import torch
        >>> from repro_torch.core import build_target
        >>> g = torch.Generator().manual_seed(0)
        >>> x = torch.randn(100, 3, generator=g)
        >>> y = torch.where(torch.rand(100, generator=g) < 0.5, 1.0, -1.0)
        >>> t = build_target("logit", (x, y), 100,
        ...                  prior_logpdf=lambda w: -5.0 * (w ** 2).sum(-1))
        >>> t.family, t.num_sections, t.log_local_ensemble is not None
        ('logit', 100, True)
        >>> w0, w1 = torch.zeros(3), torch.full((3,), 0.1)
        >>> t.log_local(w0, w1, torch.arange(8, dtype=torch.int32)).shape
        torch.Size([8])
    """
    if num_sections is None:
        raise ValueError("num_sections is required")
    user_prior = prior_logpdf
    if prior_logpdf is not None and prior_scale != 1.0:
        scale, base_prior = float(prior_scale), prior_logpdf
        prior_logpdf = lambda theta: scale * base_prior(theta)
    elif prior_scale != 1.0:
        raise ValueError("prior_scale tempering requires prior_logpdf")
    if log_global is None:
        if prior_logpdf is None:
            raise ValueError("pass prior_logpdf or an explicit log_global")

        def log_global(theta, theta_p):
            return prior_logpdf(theta_p) - prior_logpdf(theta)

    if family is None:
        if log_local is None:
            raise ValueError("family=None requires an explicit log_local")
        return PartitionedTarget(num_sections, log_global, log_local, log_density)

    fam = get_family(family)
    spec = None
    if not callable(data) and data is not None and user_prior is not None:
        # the untempered prior and its exponent, so that tempering composes
        spec = TargetSpec(family=family, data=data, num_sections=num_sections,
                          prior_logpdf=user_prior, params_fn=params_fn,
                          prior_scale=float(prior_scale))
    data_fn = data if callable(data) else (lambda theta: data)
    params_fn = params_fn or (lambda theta: theta)
    user_log_local = log_local

    if log_local is None:

        def log_local(theta, theta_p, idx):
            return fam.delta(data_fn(theta), params_fn(theta), params_fn(theta_p), idx)

    def log_local_ensemble(theta, theta_p, idx, mode: str = "auto"):
        return fam.ensemble_delta(data_fn(theta), params_fn(theta), params_fn(theta_p), idx,
                                  mode=mode)

    placed: dict = {}  # the pool of tensors on each slot device it was placed on

    def pools_on(dev):
        got = placed.get(dev)
        if got is None:
            got = placed.setdefault(dev, tree_map(lambda t: sharding.place(t, dev), data))
            if dev.type == "cuda":  # copied on this thread's stream; used on any thread's
                torch.cuda.synchronize(dev)
        return got

    def bind(theta, theta_p, ensemble: bool = False, mode: str = "auto"):
        if not ensemble and user_log_local is not None:
            return lambda idx: user_log_local(theta, theta_p, idx)
        a, b = params_fn(theta), params_fn(theta_p)
        mesh = sharding.active_mesh() if ensemble else None
        if mesh is not None:
            return _mesh_round(mesh, fam, data_fn(theta) if callable(data) else pools_on,
                               a, b, mode)
        pools = data_fn(theta)
        fn = fam.ensemble_delta if ensemble else fam.delta
        return lambda idx: fn(pools, a, b, idx, mode=mode)

    if not callable(data):
        device = data[0].device if isinstance(data, (tuple, list)) else data.device
    elif device is not None:
        device = torch.device(device)
    if log_density is None and prior_logpdf is not None:

        def log_density(theta):
            pools = data_fn(theta)
            first = pools[0] if isinstance(pools, (tuple, list)) else pools
            idx = torch.arange(num_sections, dtype=torch.int32, device=first.device)
            return prior_logpdf(theta) + fam.loglik(pools, params_fn(theta), idx).sum()

    return PartitionedTarget(
        num_sections=num_sections,
        log_global=log_global,
        log_local=log_local,
        log_density=log_density,
        log_local_ensemble=log_local_ensemble,
        family=fam.name,
        device=device,
        bind=bind,
        range_sections=fam.takes_range and user_log_local is None,
        spec=spec,
    )
