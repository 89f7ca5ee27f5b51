"""Sharded serving fleet: writers, delta-streamed replicas, admission
control; the port of ``repro.fleet`` (less the autoscaler, which waits for
the observability slice)::

    FleetRouter ─▶ replica lanes ─▶ ReplicaEnsemble/-Process ─▶ values
     priorities     least-loaded      local window copy
     admission      per workload        ▲ SnapshotDelta stream
     shed/admit       shard             │ (new draws only)
                                   ResidentEnsemble writers
                                   (EnsemblePool: freshness,
                                    checkpoints)

With ``FleetConfig(subposterior=P)`` each partition of the data has its own
writers and the router combines their windows at query time
(:mod:`repro_torch.partition`). Front end: ``python -m
repro_torch.launch.serve --fleet --workload bayeslr``.
"""
from .delta import SnapshotDelta, apply_delta, make_delta, payload_nbytes, wire_bytes
from .replica import ReplicaDeadError, ReplicaEnsemble, ReplicaProcess
from .router import AdmissionConfig, FleetRouter
from .topology import Fleet, FleetConfig, FleetShard, shard_seed

__all__ = [
    "AdmissionConfig",
    "Fleet",
    "FleetConfig",
    "FleetRouter",
    "FleetShard",
    "ReplicaDeadError",
    "ReplicaEnsemble",
    "ReplicaProcess",
    "SnapshotDelta",
    "apply_delta",
    "make_delta",
    "payload_nbytes",
    "shard_seed",
    "wire_bytes",
]
