"""The slots a mesh is made of: the counterpart of ``jax.devices()``.

A slot is a ``torch.device``. By default the slots of a device type are its
visible devices: every card for ``cuda``, one for the CPU. Within
:func:`force_devices(n) <force_devices>` there are ``n`` slots that cycle
over those devices (``cuda:0, cuda:1, ..., cuda:0, ...``; ``n`` times the
CPU): the counterpart of ``--xla_force_host_platform_device_count``, which
lets one process drive a mesh of more slots than it has cards. The forcing
is process-wide, so that threads started inside it (a fleet's writers) see
it too, and restores the previous setting on exit.
"""
from __future__ import annotations

import contextlib

import torch

_FORCED: tuple[int, int | None] | None = None  # (slots, physical devices cycled over)


def forced_devices() -> int | None:
    """The forced slot count, or None."""
    return None if _FORCED is None else _FORCED[0]


def visible_slots(device="cuda") -> list[torch.device]:
    """The slots for ``device``'s type, with indices."""
    kind = torch.device(device).type
    if kind == "cuda":
        phys = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        phys = [torch.device(kind)]
    if not phys:
        raise RuntimeError("no CUDA device is visible")
    if _FORCED is None:
        return phys
    n, physical = _FORCED
    phys = phys[:physical] if physical else phys
    return [phys[i % len(phys)] for i in range(n)]


@contextlib.contextmanager
def force_devices(n: int, physical: int | None = None):
    """Make ``n`` slots of every device type visible until the block ends,
    cycling over the first ``physical`` devices (default: all of them)."""
    global _FORCED
    if int(n) < 1 or (physical is not None and int(physical) < 1):
        raise ValueError(f"force_devices needs n >= 1 and physical >= 1, got {n}, {physical}")
    prev, _FORCED = _FORCED, (int(n), physical)
    try:
        yield
    finally:
        _FORCED = prev
