"""Serving-workload registry, the port of ``repro.serving.workloads``.

A :class:`ServingWorkload` bundles what the pool needs to keep a posterior
resident: a configured :class:`~repro_torch.core.ensemble.ChainEnsemble`
(whose targets went through ``build_target``, so the hand kernels run its
rounds on the card), the initial parameters and the workload's request
classes (:class:`~repro_torch.serving.resident.QuerySpec`).

The three paper workloads register through their experiment drivers'
``make_serving_workload()`` (imported lazily, so the serving layer imports
without every experiment); the ``ppl`` workload compiles a probabilistic
program through :func:`repro_torch.ppl.compile_partitioned_target`, which
lowers it onto the ``logit`` family. Every builder takes ``device=None``
(the card; raises without one unless given ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from .._device import make_generator, resolve_device
from ..core.ensemble import ChainEnsemble
from .resident import QuerySpec

Params = Any


@dataclasses.dataclass(frozen=True)
class ServingWorkload:
    """One servable posterior: ensemble + initial point + request classes."""

    name: str
    ensemble: ChainEnsemble
    theta0: Params
    query_specs: dict[str, QuerySpec]
    default_class: str
    description: str = ""

    def __post_init__(self):
        if self.default_class not in self.query_specs:
            raise ValueError(f"default_class {self.default_class!r} not in query_specs "
                             f"{sorted(self.query_specs)}")


def row_sampler(rows) -> Callable[[torch.Generator, int], np.ndarray]:
    """A ``QuerySpec.make_queries`` that draws request inputs uniformly from
    a host pool of rows (query points from the held-out set)."""
    rows = rows.detach().cpu().numpy() if isinstance(rows, torch.Tensor) else np.asarray(rows)

    def make_queries(gen: torch.Generator, n: int) -> np.ndarray:
        return rows[torch.randint(0, rows.shape[0], (n,), generator=gen).numpy()]

    return make_queries


def level_sampler(gen: torch.Generator, n: int) -> np.ndarray:
    """Quantile levels uniform on [0.05, 0.95) as float32 request rows."""
    return (0.05 + 0.9 * torch.rand(n, generator=gen)).numpy()


_REGISTRY: dict[str, Callable[..., ServingWorkload]] = {}


def register_serving_workload(name: str, builder: Callable[..., ServingWorkload]):
    """Register (or overwrite) a workload builder under ``name``."""
    _REGISTRY[name] = builder
    return builder


def serving_workloads() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def build_serving_workload(name: str, **kw) -> ServingWorkload:
    """Instantiate a registered workload (builders accept ``smoke=``,
    ``device=`` and size/engine keywords; see each experiment's
    ``make_serving_workload``)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown serving workload {name!r}; registered: {serving_workloads()}")
    return _REGISTRY[name](**kw)


def _bayeslr_builder(**kw) -> ServingWorkload:
    from ..experiments import bayeslr

    return bayeslr.make_serving_workload(**kw)


def _stochvol_builder(**kw) -> ServingWorkload:
    from ..experiments import stochvol

    return stochvol.make_serving_workload(**kw)


def _jointdpm_builder(**kw) -> ServingWorkload:
    from ..experiments import jointdpm

    return jointdpm.make_serving_workload(**kw)


def make_ppl_workload(*, smoke: bool = False, num_chains: int = 4, n: int | None = None,
                      d: int = 3, batch_size: int = 50, epsilon: float = 0.05,
                      sigma: float = 0.08, seed: int = 0, device=None) -> ServingWorkload:
    """Serve a compiled probabilistic program: a plated Bernoulli-logit
    regression written against :mod:`repro_torch.ppl`, lowered by
    ``compile_partitioned_target`` onto the ``logit`` family (whose K-chain
    rounds run the pair-delta kernel), in a stock ``ChainEnsemble``. The
    data comes from a generator seeded with ``seed`` on the device."""
    from ..core import SubsampledMHConfig
    from ..core.proposals import RandomWalk
    from ..ppl import Trace, compile_partitioned_target, dists

    dev = resolve_device(device)
    n = n if n is not None else (300 if smoke else 2000)
    gen = make_generator(seed, dev)
    x = torch.randn((n, d), generator=gen, device=dev)
    w_true = torch.linspace(-1.0, 1.0, d, device=dev)
    yv = torch.where(torch.rand(n, generator=gen, device=dev) < torch.sigmoid(x @ w_true),
                     1.0, -1.0)
    tr = Trace(device=dev)
    w = tr.sample("w", dists.mvnormal_diag, tr.constant("mu_w", torch.zeros(d)),
                  tr.constant("sig_w", math.sqrt(0.1) * torch.ones(d)), value=torch.zeros(d))
    with tr.plate("data", n):
        xn = tr.constant("x", x)
        z = tr.det("z", lambda xx, ww: xx @ ww, xn, w)
        yn = tr.sample("y", dists.bernoulli_logits, z, value=yv)
        tr.observe(yn, yv)
    target = compile_partitioned_target(tr, w)
    ens = ChainEnsemble(target, RandomWalk(sigma), num_chains, device=dev,
                        config=SubsampledMHConfig(batch_size=min(batch_size, n), epsilon=epsilon))
    specs = {
        "predictive": QuerySpec(
            fn=lambda wd, xs: torch.sigmoid(wd @ xs.T),
            aggregate="mean",
            make_queries=row_sampler(x),
            name="predictive",
        ),
        # posterior quantiles of the coefficient norm: request rows are
        # quantile levels, reduced over the draws on the device
        "wnorm_quantile": QuerySpec(
            fn=lambda wd, xs: torch.linalg.vector_norm(wd, dim=-1)[:, None].expand(
                -1, xs.shape[0]),
            aggregate="quantile",
            make_queries=level_sampler,
            name="wnorm_quantile",
        ),
    }
    return ServingWorkload(name="ppl", ensemble=ens, theta0=torch.zeros(d), query_specs=specs,
                           default_class="predictive",
                           description=f"compiled Bernoulli-logit program, N={n}, D={d}")


register_serving_workload("bayeslr", _bayeslr_builder)
register_serving_workload("stochvol", _stochvol_builder)
register_serving_workload("jointdpm", _jointdpm_builder)
register_serving_workload("ppl", make_ppl_workload)
