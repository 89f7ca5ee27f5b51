"""Dataset partitioner: observation shards for subposterior writer fleets,
the port of ``repro.partition.partitioner``.

Split the N observations into P disjoint shards and give each shard to an
unmodified subsampled-MH writer whose target is the local slice under the
tempered prior ``p(theta)^(1/P)`` (Scott et al., consensus Monte Carlo;
Angelino et al., "Patterns of Scalable Bayesian Inference"). The product of
the P subposteriors

    p_p(theta) ∝ p(theta)^(1/P) · prod_{i in shard p} p(x_i | theta)

is the full posterior, which makes recombination at query time
(:mod:`repro_torch.partition.combine`) sound.

Partitioning is structural: it slices the section pool of a target's
:class:`~repro_torch.core.target_builder.TargetSpec` along axis 0 and runs
the builder again, so every registered family partitions with no code of
its own and each slice keeps its family's kernels. Index arrays are numpy
int64, as in the reference; ``partition_target(target, 1)`` returns
``[target]``, the same object, so the P = 1 fleet is the unpartitioned path.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .._device import tree_map
from ..core.target import PartitionedTarget
from ..core.target_builder import TargetSpec, build_from_spec, spec_of

SCHEMES = ("stride", "block")


def partition_indices(n: int, num_partitions: int, scheme: str = "stride") -> list[np.ndarray]:
    """Disjoint index shards covering ``range(n)`` exactly.

    ``stride``: observation i goes to shard ``i % P``, balanced to within one
    row and stable under streaming growth (appending rows extends each
    shard's slice instead of reshuffling it). ``block``: contiguous
    ``ceil(n/P)``-row blocks.
    """
    if num_partitions < 1:
        raise ValueError(f"num_partitions must be >= 1, got {num_partitions}")
    if n < num_partitions:
        raise ValueError(f"cannot split {n} sections into {num_partitions} non-empty shards")
    if scheme == "stride":
        return [np.arange(p, n, num_partitions, dtype=np.int64) for p in range(num_partitions)]
    if scheme == "block":
        return [np.asarray(block, dtype=np.int64)
                for block in np.array_split(np.arange(n, dtype=np.int64), num_partitions)]
    raise ValueError(f"unknown partition scheme {scheme!r}; known: {SCHEMES}")


def partition_append_indices(n_before: int, n_new: int, num_partitions: int,
                             scheme: str = "stride") -> list[np.ndarray]:
    """Which rows of an appended chunk land on which shard: P index arrays
    into the chunk such that appending ``chunk[idx_p]`` to shard p gives
    ``partition_indices`` of the concatenated pool (stride only; block
    partitions are not append-stable)."""
    if scheme != "stride":
        raise ValueError(f"streaming append requires the 'stride' scheme, got {scheme!r}")
    if num_partitions < 1:
        raise ValueError(f"num_partitions must be >= 1, got {num_partitions}")
    offsets = np.arange(n_new, dtype=np.int64) + int(n_before)
    return [np.nonzero(offsets % num_partitions == p)[0].astype(np.int64)
            for p in range(num_partitions)]


def _take(a, idx: np.ndarray):
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(idx, dtype=torch.long, device=a.device)]
    return np.asarray(a)[idx]


def take_sections(data: Any, idx: np.ndarray) -> Any:
    """Slice every leaf of a section pool along axis 0, each tensor on its
    own device (numpy leaves stay numpy)."""
    idx = np.asarray(idx)
    return tree_map(lambda a: _take(a, idx), data)


def partition_spec(spec: TargetSpec, num_partitions: int,
                   scheme: str = "stride") -> list[TargetSpec]:
    """P per-shard recipes: the sliced data, the prior tempered by a further
    1/P."""
    return [dataclasses.replace(spec, data=take_sections(spec.data, idx),
                                num_sections=int(idx.shape[0]),
                                prior_scale=spec.prior_scale / num_partitions)
            for idx in partition_indices(spec.num_sections, num_partitions, scheme)]


def partition_target(target: PartitionedTarget, num_partitions: int,
                     scheme: str = "stride") -> list[PartitionedTarget]:
    """P independent subposterior targets of one builder-constructed
    target; P = 1 returns ``[target]`` unchanged."""
    if num_partitions == 1:
        return [target]
    return [build_from_spec(s) for s in partition_spec(spec_of(target), num_partitions, scheme)]
