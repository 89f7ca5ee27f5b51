"""Snapshot-delta streaming: what a writer sends its read replicas, the port
of ``repro.fleet.delta``.

A writer's rolling window advances by ``refresh_steps`` draws a refresh
while it holds up to ``window`` draws a chain, so between two syncs only
its tail is new. A :class:`SnapshotDelta` carries that tail (plus the
refreshed diagnostics and a staleness stamp) keyed by the writer's version
(``steps_done``); a replica at ``base_version`` appends it and trims, which
rebuilds the writer's window bit for bit. When the gap reaches the window's
width (a cold replica, a restore, missed syncs) the delta is a full-window
resync: correctness never depends on the replica's history, only the
payload's size does.

Payloads are host numpy arrays: the resident's window already lives on the
host, and a CUDA tensor never crosses the wire. :func:`payload_nbytes`
counts the raw array bytes and :func:`wire_bytes` the pickled size, what
crosses the pipe of a :class:`repro_torch.fleet.replica.ReplicaProcess`.
"""
from __future__ import annotations

import pickle
from typing import Any, NamedTuple

import numpy as np

from .._device import tree_leaves, tree_map
from ..serving.resident import Snapshot

Params = Any


class SnapshotDelta(NamedTuple):
    """One writer -> replica update (every leaf a host numpy array)."""

    name: str  # the shard the delta belongs to
    base_version: int  # the replica's steps_done this applies on (0 = full)
    version: int  # the writer's steps_done after applying
    draws: Params | None  # (K, n_new, ...) new tail of the window; None = empty
    window: int  # the window's limit to trim to after appending
    summary: dict  # the writer's ensemble_summary of its last refresh
    staleness_s: float  # age of the newest draw at emission
    full: bool  # True when draws is the whole window (a resync)


def payload_nbytes(tree: Params | None) -> int:
    """Raw bytes of the array payload (0 for an empty delta)."""
    if tree is None:
        return 0
    return int(sum(np.asarray(leaf).nbytes for leaf in tree_leaves(tree)))


def wire_bytes(obj: Any) -> int:
    """Pickled size: the bytes a process pipe carries."""
    return len(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))


def make_delta(snap: Snapshot, base_version: int, window: int, name: str = "") -> SnapshotDelta:
    """The delta that brings a replica at ``base_version`` up to ``snap``:
    the last ``snap.steps_done - base_version`` window columns, or a
    full-window resync when that gap reaches the window's width, the replica
    is cold (version 0) or ahead of the writer (after a writer restore to an
    older checkpoint)."""
    if snap.draws is None:
        return SnapshotDelta(name, int(base_version), snap.steps_done, None, int(window),
                             snap.summary, snap.staleness_s, False)
    width = int(tree_leaves(snap.draws)[0].shape[1])
    gap = snap.steps_done - base_version
    if gap < 0 or gap >= width or base_version == 0:
        draws = tree_map(np.asarray, snap.draws)
        return SnapshotDelta(name, 0, snap.steps_done, draws, int(window), snap.summary,
                             snap.staleness_s, True)
    if gap == 0:
        return SnapshotDelta(name, int(base_version), snap.steps_done, None, int(window),
                             snap.summary, snap.staleness_s, False)
    draws = tree_map(lambda a: np.asarray(a[:, width - gap:]), snap.draws)
    return SnapshotDelta(name, int(base_version), snap.steps_done, draws, int(window),
                         snap.summary, snap.staleness_s, False)


def apply_delta(window_draws: Params | None, delta: SnapshotDelta) -> Params | None:
    """Fold a delta into a replica's window; returns the new window. The
    caller checks that an incremental delta's ``base_version`` is the
    replica's; this only appends and trims (or replaces)."""
    if delta.draws is None:
        return window_draws
    if delta.full or window_draws is None:
        return tree_map(lambda a: np.asarray(a)[:, -delta.window:], delta.draws)
    merged = tree_map(lambda a, b: np.concatenate([a, np.asarray(b)], axis=1), window_draws,
                      delta.draws)
    return tree_map(lambda a: a[:, -delta.window:], merged)
