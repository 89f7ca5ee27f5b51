"""Mesh construction: the port of ``repro.launch.mesh``. A function, not a
module-level constant, so importing this module reads no device state (the
dry run forces 512 slots before it calls :func:`make_production_mesh`)."""
from __future__ import annotations

import numpy as np
import torch

from ..distributed.sharding import Mesh
from ..distributed.slots import visible_slots


def _grid(slots: list, shape: tuple[int, ...]) -> np.ndarray:
    grid = np.empty(len(slots), dtype=object)
    grid[:] = slots
    return grid.reshape(shape)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The reference's production mesh: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")`` with ``multi_pod``, over the
    first 256 or 512 slots of ``device``'s type. Raises when fewer are
    visible, as ``jax.make_mesh`` does (the dry run forces 512 meta slots)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    slots = visible_slots(device)
    n = int(np.prod(shape))
    if len(slots) < n:
        raise ValueError(f"the mesh {shape} needs {n} slots; {len(slots)} of "
                         f"{torch.device(device).type} are visible")
    return Mesh(_grid(slots[:n], shape), axes)


def make_mesh_for_devices(n_devices: int | None = None, model_parallel: int | None = None,
                          *, device="cuda") -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` slots of
    ``device``'s type (default: all of them)."""
    slots = visible_slots(device)
    n = n_devices or len(slots)
    mp = model_parallel or 1
    if n % mp or n > len(slots):
        raise ValueError(f"{n} slots of {len(slots)} visible do not split into model={mp}")
    return Mesh(_grid(slots[:n], (n // mp, mp)), ("data", "model"))
