"""Distribution: logical-axis sharding over a mesh of slots (the port of
``repro.distributed``)."""
from .sharding import (
    DEFAULT_RULES,
    GradTape,
    Mesh,
    NamedSharding,
    PartitionSpec,
    ShardedTensor,
    assemble,
    count_bytes,
    gather_params,
    lc,
    logical_axis_rules,
    named_sharding,
    reset_transfers,
    resolve_spec,
    shard_params,
    shard_tensor,
    shard_tree,
    timed_transfers,
    transfer_counts,
    tree_shardings,
    uncounted_transfers,
    whole,
)
from .slots import force_devices, forced_devices, visible_slots

__all__ = [
    "DEFAULT_RULES",
    "GradTape",
    "ShardedTensor",
    "count_bytes",
    "gather_params",
    "lc",
    "logical_axis_rules",
    "named_sharding",
    "resolve_spec",
    "shard_params",
    "shard_tree",
    "transfer_counts",
    "tree_shardings",
    "whole",
]
