"""Partitioned targets: the tensor form of a partitioned scaffold.

The port of ``repro.core.target``. The MH kernels consume only:

  log_global(theta, theta_prime) -> scalar (or (K,) for batched thetas)
      log p_global(theta') - log p_global(theta).
  log_local(theta, theta_prime, idx) -> (m,)
      l_i for the requested local sections of one chain.
  num_sections
      N, the number of local sections.

In an ensemble every leaf of theta carries a leading (K,) chain axis and the
target's callables receive it as is: the batch dimension is written out, not
mapped over, so ``log_global`` must return (K,) for (K, ...) thetas.

The transitions score their rounds through :meth:`PartitionedTarget
.local_round`, which binds one (theta, theta') pair for the whole sequential
test: a target whose sections derive from theta (the stochvol paths) builds
its pools once per transition, not once per round.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .._device import tree_leaves

Params = Any


@dataclasses.dataclass(frozen=True)
class PartitionedTarget:
    num_sections: int
    log_global: Callable[[Params, Params], torch.Tensor]
    log_local: Callable[[Params, Params, torch.Tensor], torch.Tensor]
    # Optional full-posterior log density (global part + all sections).
    log_density: Callable[[Params], torch.Tensor] | None = None
    # Optional ensemble round: (theta, theta', idx) with a leading (K,) chain
    # axis on every argument -> (K, m) deltas, through the kernel dispatch
    # (repro_torch.kernels.ops); takes mode= ("auto" | "always" | "never").
    log_local_ensemble: Callable[..., torch.Tensor] | None = None
    # Name of the kernel family that built the target, or None.
    family: str | None = None
    # Device of the target's section data, or None for hand-wired targets.
    device: torch.device | None = None
    # Optional (theta, theta', ensemble, mode) -> (idx -> deltas): the round
    # evaluator of one transition, with whatever depends on the pair alone
    # (latent-dependent section pools, the family's parameters) computed once.
    bind: Callable[..., Callable[[torch.Tensor], torch.Tensor]] | None = None
    # True when ``log_local`` also takes ``range(start, stop)`` for ``idx``: a
    # contiguous run of sections, which the exact transition's full pass then
    # scores with no index tensor. Derived, not a setting: ``build_target``
    # sets it from its family's ``takes_range`` when it builds ``log_local``
    # itself; a target built by hand keeps False.
    range_sections: bool = False
    # The recipe ``build_target`` can rebuild this target from (a data slice
    # for a subposterior, appended observations), or None for a hand-wired
    # target, callable section data or an explicit ``log_global``.
    spec: Any = None

    def local_round(self, theta, theta_p, *, ensemble: bool = False, mode: str = "auto"):
        """``idx -> deltas`` for one transition's pair: (m,) for one chain,
        or (K, m) through ``log_local_ensemble`` with ``ensemble=True``.
        ``mode`` is the kernel dispatch."""
        if self.bind is not None:
            return self.bind(theta, theta_p, ensemble, mode)
        if ensemble:
            return lambda idx: self.log_local_ensemble(theta, theta_p, idx, mode=mode)
        return lambda idx: self.log_local(theta, theta_p, idx)


def from_iid_loglik(
    prior_logpdf: Callable[[Params], torch.Tensor],
    loglik_fn: Callable[[Params, torch.Tensor], torch.Tensor],
    data: Any,
    num_sections: int,
) -> PartitionedTarget:
    """The BayesLR-shaped scaffold (Table 1 row 1): theta ~ prior, sections
    are iid observations. ``loglik_fn(theta, idx) -> (m,)``; ``data`` is
    closed over by the caller and kept only for documentation."""
    del data

    def log_global(theta, theta_p):
        return prior_logpdf(theta_p) - prior_logpdf(theta)

    def log_local(theta, theta_p, idx):
        return loglik_fn(theta_p, idx) - loglik_fn(theta, idx)

    def log_density(theta):
        dev = tree_leaves(theta)[0].device
        idx = torch.arange(num_sections, dtype=torch.int32, device=dev)
        return prior_logpdf(theta) + loglik_fn(theta, idx).sum()

    return PartitionedTarget(num_sections, log_global, log_local, log_density)
