"""The run's environment: build and tuner caches at fixed paths inside the
checkout, and the check that nothing of JAX or of the JAX package is loaded.

Set before ``torch`` and the port are imported, so every later run of a cell
in the same checkout finds the kernels built and the tuner's winners raced.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

# Top-level module names that may not be loaded in a run: JAX, and the JAX
# package beside the port (``repro``; the port ``repro_torch`` is another
# name) with its benchmarks. Compared with the part before the first dot.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def prepare(root: Path) -> None:
    """Fix where the port builds and tunes (``build/`` of the checkout), keep
    libraries from loading JAX, and keep the host's threads few: one process
    a card, steadier host timing."""
    build = root / "build"
    os.environ.update({
        "REPRO_TORCH_BUILD_DIR": str(build),  # the port's kernels: build/repro_torch_kernels/
        "REPRO_AUTOTUNE_DIR": str(build / "autotune"),
        "USE_FLAX": "0",
        "USE_JAX": "0",
    })
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
