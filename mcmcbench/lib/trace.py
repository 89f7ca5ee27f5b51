"""A traced segment: ``torch.profiler`` over a callable, reduced to the
device's busy time (the union of its operations' intervals), the device
operations by total time, each device operation in order (for the readers of
kernel metrics), and the idle gaps labelled by the host operation that was
running through them.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    window_s: float  # the traced segment's length on the host clock
    busy_s: float  # the union of device operations' intervals
    ops: list  # (name, start_s, duration_s) of every device operation, by start
    top_ops: list  # [name, total seconds] by total, the 10 largest
    idle_gaps: list  # [host operation, total seconds of gaps under it], the 10 largest

    def idle_percent(self) -> float | None:
        """100 (1 - busy / window), or None where the device ran nothing."""
        if not self.ops or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_times(self, needle: str) -> list[float]:
        """Durations (s) of the device operations whose name holds ``needle``, in order."""
        return [d for n, _, d in self.ops if needle in n]


def _merge(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of the device's operations: (starts, ends)."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    m_s = s[idx]
    m_e = np.append(run_end[idx[1:] - 1], run_end[-1]) if len(idx) else np.array([])
    return m_s, m_e


def capture(fn, device: torch.device):
    """Run ``fn()`` under the profiler; returns (fn's result, Trace)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    return out, summarize(_records(prof), window)


def _records(prof) -> list:
    """(name, is a device operation, start s, end s) of every event. Read
    from the profiler's raw results: building its Python event tree takes
    minutes for the ~10^6 events of an LM step."""
    dev_type = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        out.append((e.name(), e.device_type() == dev_type, start, start + e.duration_ns() * 1e-9))
    return out


def summarize(records, window_s: float) -> Trace:
    dev, host = [], []
    for name, on_device, start, end in records:
        (dev if on_device else host).append((name[:NAME_CHARS], start, end))
    dev.sort(key=lambda r: r[1])
    ops = [(n, s, max(0.0, t - s)) for n, s, t in dev]
    if not ops:
        return Trace(window_s, 0.0, [], [], [])
    starts = np.array([s for _, s, _ in ops])
    ends = starts + np.array([d for _, _, d in ops])
    m_s, m_e = _merge(starts, ends)
    busy = float(np.sum(m_e - m_s))
    totals: dict[str, float] = {}
    for n, _, d in ops:
        totals[n] = totals.get(n, 0.0) + d
    top_ops = [[n, t] for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:10]]
    gaps_s, gaps_e = m_e[:-1], m_s[1:]
    return Trace(window_s, busy, ops, top_ops, _label_gaps(gaps_s, gaps_e, host))


def _label_gaps(gs: np.ndarray, ge: np.ndarray, host: list, back: int = 16) -> list:
    """The device's idle gaps, each labelled by the innermost host operation
    under its midpoint (the latest-started of those that cover it, looked for
    among the ``back`` host operations that started last before it), or as
    Python between operations where none does; summed by label, the 10
    largest."""
    if len(gs) == 0:
        return []
    mid = 0.5 * (gs + ge)
    label = np.full(len(mid), -1)
    if host:
        order = sorted(range(len(host)), key=lambda i: host[i][1])
        h_s = np.array([host[i][1] for i in order])
        h_e = np.array([host[i][2] for i in order])
        last = np.searchsorted(h_s, mid, side="right") - 1
        for k in range(back):
            cand = last - k
            ok = (label < 0) & (cand >= 0)
            ok[ok] &= h_e[cand[ok]] >= mid[ok]
            label[ok] = cand[ok]
        names = [host[i][0] for i in order]
    by_label: dict[str, float] = {}
    for lab, dur in zip(label, ge - gs):
        name = names[lab] if lab >= 0 else "python between operations"
        by_label[name] = by_label.get(name, 0.0) + float(dur)
    return [[n, t] for n, t in sorted(by_label.items(), key=lambda kv: -kv[1])[:10]]
