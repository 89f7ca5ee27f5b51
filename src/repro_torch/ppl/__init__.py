"""PET layer: probabilistic execution traces, scaffolds, and lowering.

The port of ``repro.ppl``: the paper's Defs. 1–8, plus the ``plate``
vectorization bridge to the core MH kernels. A compiled program whose plate
matches the ``logit`` or ``gaussian_ar1`` family runs its K-chain rounds on
that family's CUDA kernel.
"""
from . import dists
from .compile import compile_partitioned_target
from .trace import (
    Node,
    Plate,
    Scaffold,
    Trace,
    absorbing_set,
    border_node,
    partition,
    scaffold,
    target_set,
    transient_set,
)

__all__ = [
    "Node",
    "Plate",
    "Scaffold",
    "Trace",
    "absorbing_set",
    "border_node",
    "compile_partitioned_target",
    "dists",
    "partition",
    "scaffold",
    "target_set",
    "transient_set",
]
