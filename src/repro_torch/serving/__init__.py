"""Posterior query serving: resident ensembles, batching, SLO freshness.

The port of ``repro.serving``:

    RequestQueue ─▶ EnsemblePool ─▶ ResidentEnsemble ─▶ Snapshot ─▶ values
     batching       freshness        warm ChainEnsemble   posterior
     deadlines      checkpoints      background refresh   window

Front end: ``python -m repro_torch.launch.serve --workload
bayeslr|stochvol|jointdpm|ppl [--device cpu]``.
"""
from .pool import (
    EnsemblePool,
    FreshnessPolicy,
    ServingConfig,
    snapshot_ess,
    snapshot_rhat,
)
from .queue import Request, RequestQueue
from .resident import QuerySpec, ResidentEnsemble, Snapshot
from .workloads import (
    ServingWorkload,
    build_serving_workload,
    make_ppl_workload,
    register_serving_workload,
    serving_workloads,
)

__all__ = [
    "EnsemblePool",
    "FreshnessPolicy",
    "QuerySpec",
    "Request",
    "RequestQueue",
    "ResidentEnsemble",
    "ServingConfig",
    "ServingWorkload",
    "Snapshot",
    "build_serving_workload",
    "make_ppl_workload",
    "register_serving_workload",
    "serving_workloads",
    "snapshot_ess",
    "snapshot_rhat",
]
