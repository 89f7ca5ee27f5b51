"""End-to-end request tracing across the serving and fleet stack, the port
of ``repro.obs.trace`` (stdlib only, as there).

A *trace* follows one request from :meth:`RequestQueue.submit` (or
:meth:`FleetRouter.submit`) through batch assembly, across the pickled-pipe
:class:`~repro_torch.fleet.replica.ReplicaProcess` transport, into
:class:`~repro_torch.serving.resident.SnapshotEvaluator` device evaluation
and the subposterior combine path. Each hop is a *span*: a plain dict with

====================  =====================================================
field                 meaning
====================  =====================================================
``trace_id``          the request this span belongs to (shared end-to-end)
``span_id``           this span
``parent_id``         the enclosing span (None for the request root)
``name``              human label (``request:bayeslr.predictive``, ...)
``stage``             one of the stage tags below (the latency-breakdown key)
``start_s``           ``time.monotonic()`` at open — on Linux this clock is
                      CLOCK_MONOTONIC, shared across processes, so writer-
                      and replica-process spans nest on one timeline
``dur_s``             open-to-close duration (present only on closed spans)
``pid``               OS process that produced the span
====================  =====================================================

plus free-form tags. Stage tags used by the serving stack: ``request``
(root), ``queue_wait``, ``assembly``, ``replica_serve``, ``device_eval``,
``combine``.

Spans are plain dicts on purpose: replica worker processes build them with
:func:`span_open`/:func:`span_close` and ship them back over the pipe
inside the query reply — no Tracer, Recorder, or lock crosses the process
boundary. The parent-side :class:`Tracer` then :meth:`~Tracer.emit`\\ s them:
every closed span lands in a bounded in-memory ring (what the Chrome export
reads), on the ``spans`` stream of an attached recorder (any object with
``record(stream, row)``; the reference's ``repro.obs.Recorder`` comes with
the rest of ``obs/``), and, given ``jsonl_path``, in a JSONL file.

Export (Chrome/Perfetto ``trace_event`` JSON — load in ``ui.perfetto.dev``
or ``chrome://tracing``)::

    python -m repro_torch.obs.trace --export /tmp/trace/spans.jsonl --out trace.json
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time
import uuid
from collections import deque

STAGES = ("request", "queue_wait", "assembly", "replica_serve",
          "device_eval", "combine")


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def span_open(trace_id: str | None, name: str, stage: str,
              parent_id: str | None = None, **tags) -> dict:
    """An open span (no ``dur_s`` yet). ``trace_id=None`` makes a *raw*
    span a later :meth:`Tracer.adopt` grafts onto a trace — what components
    that must not depend on a Tracer (evaluator, replica workers) produce."""
    span = {
        "trace_id": trace_id,
        "span_id": new_span_id(),
        "parent_id": parent_id,
        "name": name,
        "stage": stage,
        "start_s": time.monotonic(),
        "pid": os.getpid(),
    }
    span.update(tags)
    return span


def span_close(span: dict, **tags) -> dict:
    """Close an open span in place (sets ``dur_s``); returns it."""
    span["dur_s"] = time.monotonic() - span["start_s"]
    span.update(tags)
    return span


class Tracer:
    """Span collection point for one serving process.

    Thread-safe. Closed spans go two places: a bounded in-memory ring
    (``max_spans`` newest; ``dropped`` counts evictions) that the stats
    endpoint and the exit-time export read, and — when a recorder is
    attached — the ``spans`` stream, whose rollup then carries ``dur_s``
    count/mean/tails per the normal field aggregation. ``jsonl_path``
    additionally tees every span to a standalone JSONL file (what
    ``serve --trace-dir`` points the ``--export`` CLI at).
    """

    def __init__(self, recorder=None, *, stream: str = "spans",
                 max_spans: int = 100_000, jsonl_path: str | None = None):
        self.recorder = recorder
        self.stream = stream
        self.dropped = 0
        self._ring: deque[dict] = deque(maxlen=int(max_spans))
        self._lock = threading.Lock()
        self._file = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._file = open(jsonl_path, "a", buffering=1)

    # -- span lifecycle ----------------------------------------------------

    def new_trace(self, name: str, stage: str = "request", **tags) -> dict:
        """Open a root span under a fresh trace_id."""
        return span_open(new_trace_id(), name, stage, parent_id=None, **tags)

    def start(self, trace_id: str, name: str, stage: str,
              parent_id: str | None = None, **tags) -> dict:
        return span_open(trace_id, name, stage, parent_id=parent_id, **tags)

    def finish(self, span: dict, **tags) -> dict:
        """Close and emit an open span."""
        return self.emit(span_close(span, **tags))

    def emit(self, span: dict) -> dict:
        """Collect an already-closed span (ring + recorder + JSONL tee)."""
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(span)
            if self._file is not None:
                self._file.write(json.dumps(span) + "\n")
        if self.recorder is not None:
            self.recorder.record(self.stream, span)
        return span

    def adopt(self, spans, trace_id: str, parent_id: str | None = None) -> list:
        """Graft raw spans (``trace_id=None``, e.g. produced inside the
        evaluator or shipped back from a replica worker) onto ``trace_id``
        and emit them. Spans without a parent are parented to
        ``parent_id``; internal parent links between the raw spans are
        preserved."""
        out = []
        for span in spans:
            span = dict(span)
            span["trace_id"] = trace_id
            if span.get("span_id") is None:
                span["span_id"] = new_span_id()
            if span.get("parent_id") is None:
                span["parent_id"] = parent_id
            out.append(self.emit(span))
        return out

    # -- reading -----------------------------------------------------------

    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def trace(self, trace_id: str) -> list[dict]:
        return [s for s in self.spans() if s.get("trace_id") == trace_id]

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


# ---------------------------------------------------------------------------
# Chrome/Perfetto trace_event export
# ---------------------------------------------------------------------------

_META_FIELDS = ("trace_id", "span_id", "parent_id", "name", "stage",
                "start_s", "dur_s", "pid", "t", "rel_s")


def chrome_trace_events(spans) -> dict:
    """Closed spans -> Chrome ``trace_event`` JSON (complete "X" events,
    microsecond timestamps relative to the earliest span; one track per
    originating pid, so replica-process spans sit on their own row while
    still nesting on the shared monotonic timeline)."""
    closed = [s for s in spans if s.get("dur_s") is not None]
    t0 = min((s["start_s"] for s in closed), default=0.0)
    events = []
    for s in sorted(closed, key=lambda s: s["start_s"]):
        args = {k: v for k, v in s.items() if k not in _META_FIELDS}
        args["trace_id"] = s.get("trace_id")
        events.append({
            "name": s.get("name", "?"),
            "cat": s.get("stage", "span"),
            "ph": "X",
            "ts": round((s["start_s"] - t0) * 1e6, 3),
            "dur": round(s["dur_s"] * 1e6, 3),
            "pid": s.get("pid", 0),
            "tid": s.get("pid", 0),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def load_spans(path: str) -> list[dict]:
    """Spans from a ``spans.jsonl`` file, or from a directory holding one
    (a Recorder run dir or a ``--trace-dir``)."""
    if os.path.isdir(path):
        path = os.path.join(path, "spans.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def export_chrome_trace(spans, out_path: str) -> str:
    payload = chrome_trace_events(spans)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(payload, f)
    return out_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--export", required=True, metavar="SPANS",
                    help="spans.jsonl file, or a directory containing one")
    ap.add_argument("--out", default=None,
                    help="output trace JSON (default <dir>/trace.json)")
    ap.add_argument("--trace-id", default=None,
                    help="export only this trace's spans")
    args = ap.parse_args(argv)
    spans = load_spans(args.export)
    if args.trace_id:
        spans = [s for s in spans if s.get("trace_id") == args.trace_id]
    src_dir = args.export if os.path.isdir(args.export) \
        else os.path.dirname(args.export)
    out = args.out or os.path.join(src_dir or ".", "trace.json")
    export_chrome_trace(spans, out)
    n_traces = len({s.get("trace_id") for s in spans if s.get("dur_s") is not None})
    print(f"TRACE_EXPORT spans={len(spans)} traces={n_traces} out={out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
