"""Exact single-site MH on a partitioned scaffold (Alg. 1 baseline).

The port of ``repro.core.mh``: every local section's l_i is evaluated, O(N)
per transition. The reference's chunked ``lax.map`` is a loop over chunks
here, so peak memory stays bounded for large N.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .._device import tree_leaves, tree_select
from .subsampled_mh import draw_log_u
from .target import PartitionedTarget

Params = Any


class MHInfo(NamedTuple):
    accepted: torch.Tensor  # bool
    n_evaluated: torch.Tensor  # int32, always N here
    rounds: torch.Tensor  # int32: chunks evaluated
    mu_hat: torch.Tensor  # f32: mean of l_i
    mu0: torch.Tensor  # f32
    log_u: torch.Tensor  # f32


def exact_decide(theta: Params, theta_p: Params, g, log_u, target: PartitionedTarget,
                 chunk_size: int | None = None):
    """Accept or keep ``theta_p`` given the global term ``g`` (log_global plus
    the proposal's correction) and ``log_u``: the full pass over all N
    sections, in chunks of ``chunk_size``. A target with ``range_sections``
    scores each chunk as a ``range``, with no index tensor. Returns
    (theta_new, MHInfo)."""
    n = target.num_sections
    dev = tree_leaves(theta)[0].device
    step = n if chunk_size is None or chunk_size >= n else chunk_size
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for start in range(0, n, step):
        idx = range(start, min(start + step, n))
        if not target.range_sections:
            idx = torch.arange(idx.start, idx.stop, dtype=torch.int32, device=dev)
        total = total + target.log_local(theta, theta_p, idx).sum()
    accept = log_u < g + total
    info = MHInfo(
        accepted=accept,
        n_evaluated=torch.tensor(n, dtype=torch.int32, device=dev),
        rounds=torch.tensor(max(1, -(-n // step)), dtype=torch.int32, device=dev),
        mu_hat=total / n,
        mu0=(log_u - g) / n,
        log_u=log_u,
    )
    return tree_select(accept, theta_p, theta), info


def mh_step(gen: torch.Generator, theta: Params, target: PartitionedTarget, proposal,
            chunk_size: int | None = None):
    """One exact MH transition. Returns (theta_new, info)."""
    dev = tree_leaves(theta)[0].device
    log_u = draw_log_u(gen, (), dev)
    theta_p, corr = proposal(gen, theta)
    g = target.log_global(theta, theta_p) + corr
    return exact_decide(theta, theta_p, g, log_u, target, chunk_size)
