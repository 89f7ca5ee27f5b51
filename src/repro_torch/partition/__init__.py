"""Data-parallel subposterior MCMC: partition observations, combine draws;
the port of ``repro.partition``.

Split the N observations into P disjoint shards
(:mod:`repro_torch.partition.partitioner`), run an unmodified subsampled-MH
writer fleet per shard against its slice under the tempered prior
``p(theta)^(1/P)``, and recombine the per-shard windows at query time in
the fleet router (:mod:`repro_torch.partition.combine`: consensus weighted
averaging or the Gaussian density product).
"""
from .combine import (
    METHODS,
    combine_draws,
    combine_snapshots,
    consensus_combine,
    flatten_draws,
    product_combine,
    product_moments,
    trim_windows,
    unflatten_draws,
)
from .partitioner import (
    SCHEMES,
    partition_append_indices,
    partition_indices,
    partition_spec,
    partition_target,
    take_sections,
)

__all__ = [
    "METHODS",
    "SCHEMES",
    "combine_draws",
    "combine_snapshots",
    "consensus_combine",
    "flatten_draws",
    "partition_append_indices",
    "partition_indices",
    "partition_spec",
    "partition_target",
    "product_combine",
    "product_moments",
    "take_sections",
    "trim_windows",
    "unflatten_draws",
]
