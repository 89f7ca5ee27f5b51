"""Distribution: logical-axis sharding over a mesh of slots (the port of
``repro.distributed``)."""
from .sharding import (
    DEFAULT_RULES,
    Mesh,
    NamedSharding,
    PartitionSpec,
    assemble,
    count_bytes,
    lc,
    logical_axis_rules,
    named_sharding,
    resolve_spec,
    shard_tensor,
    tree_shardings,
)
from .slots import force_devices, forced_devices, visible_slots

__all__ = [
    "DEFAULT_RULES",
    "count_bytes",
    "lc",
    "logical_axis_rules",
    "named_sharding",
    "resolve_spec",
    "tree_shardings",
]
