"""The program's step spans in a traced segment: the ``lm.step`` trees that
``repro_torch.obs.trace`` keeps in its ring (``default_tracer()``) while the
profiler runs, read after the segment. Each span carries its host interval
on the profiler's clock (``start_s``, ``dur_s``) and, on a card, its stream
time (``dev_dur_s``). A program that records no step spans gives no trees,
and the readers of these metrics return None.
"""
from __future__ import annotations

import numpy as np


def step_trees(run) -> list[list[dict]]:
    """The spans of each ``lm.step`` tree in the ring whose root's host
    interval meets the traced segment's device operations, roots first."""
    try:
        from repro_torch.obs import trace
    except ImportError:
        return []
    ring = getattr(trace, "default_tracer", None)
    if ring is None:
        return []
    spans = [s for s in ring().spans() if s.get("dur_s") is not None]
    roots = [s for s in spans if s["name"] == "lm.step" and s.get("parent_id") is None]
    ops = run.trace.ops if run.trace is not None else []
    if ops:
        lo, hi = ops[0][1], max(s + d for _, s, d in ops)
        roots = [r for r in roots if r["start_s"] <= hi and r["start_s"] + r["dur_s"] >= lo]
    trees = {r["trace_id"]: [r] for r in roots}
    for s in spans:
        if s.get("parent_id") is not None and s.get("trace_id") in trees:
            trees[s["trace_id"]].append(s)
    return list(trees.values())


def _stream_s(spans) -> float | None:
    """The spans' stream seconds summed; None where one has none (no card)."""
    times = [s.get("dev_dur_s") for s in spans]
    return None if any(t is None for t in times) else float(sum(times))


def mean_step_ms(run, name: str) -> float | None:
    """The stream milliseconds of the spans called ``name``, summed a step,
    the mean over the segment's steps."""
    per_step = [_stream_s([s for s in tree if s["name"] == name]) for tree in step_trees(run)]
    if not per_step or any(t is None for t in per_step):
        return None
    return 1e3 * float(np.mean(per_step))


def mean_round_ms(run, part) -> float | None:
    """``part(a test.round's stream s, its lm.forward children's)`` in ms,
    the mean over the segment's rounds."""
    vals = []
    for tree in step_trees(run):
        for r in (s for s in tree if s["name"] == "test.round"):
            own = _stream_s([r])
            kids = _stream_s([s for s in tree
                              if s["name"] == "lm.forward" and s["parent_id"] == r["span_id"]])
            if own is None or kids is None:
                return None
            vals.append(part(own, kids))
    return 1e3 * float(np.mean(vals)) if vals else None
