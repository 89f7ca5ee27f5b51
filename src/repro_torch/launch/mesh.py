"""Mesh construction for tests and examples: the port of
``repro.launch.mesh.make_mesh_for_devices``. (Its ``make_production_mesh``,
256 or 512 TPU devices, serves only the LM's dry run and comes with it, with
the LM's sharded parameters: ROADMAP.md §1 item 2.)"""
from __future__ import annotations

import numpy as np

from ..distributed.sharding import Mesh
from ..distributed.slots import visible_slots


def make_mesh_for_devices(n_devices: int | None = None, model_parallel: int | None = None,
                          *, device="cuda") -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` slots of
    ``device``'s type (default: all of them)."""
    slots = visible_slots(device)
    n = n_devices or len(slots)
    mp = model_parallel or 1
    if n % mp or n > len(slots):
        raise ValueError(f"{n} slots of {len(slots)} visible do not split into model={mp}")
    grid = np.empty(n, dtype=object)
    grid[:] = slots[:n]
    return Mesh(grid.reshape(n // mp, mp), ("data", "model"))
