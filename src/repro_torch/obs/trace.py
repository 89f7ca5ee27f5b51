"""End-to-end request tracing across the serving and fleet stack, the port
of ``repro.obs.trace``, and spans inside the LM step (:func:`span`).

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
``start_s``           the open, on the span's clock: ``time.monotonic()``
                      for the serving stack (on Linux CLOCK_MONOTONIC,
                      shared across processes, so writer- and replica-
                      process spans nest on one timeline); a step span's
                      (``clock: "profiler"``) is Unix-epoch seconds, the
                      base of ``torch.profiler``'s events
``dur_s``             open-to-close duration (present only on closed spans)
``pid``               OS process that produced the span
``dev_start_s``       a step span on a CUDA device: the stream's seconds
                      from its root span's open to its own open
``dev_dur_s``         ... and from its open to its close
====================  =====================================================

plus free-form tags. Stage tags used by the serving stack: ``request``
(root), ``queue_wait``, ``assembly``, ``replica_serve``, ``device_eval``,
``combine``; by the step spans, ``step``, ``propose``, ``prior``,
``round`` and ``forward``.

**Step spans** (:func:`span`) mark the LM step's layers: ``lm.step`` (the
root; a new ``trace_id`` each step), ``lm.propose``, ``lm.prior``,
``test.round`` (one round of the sequential test) and ``lm.forward``. They
are recorded only while a ``torch.profiler`` capture runs in the process,
or after an operator's :func:`install` (``launch/train.py --trace-dir``),
and, but for the root, only inside an open ``lm.step`` of the thread: the
test's rounds of a BayesLR ensemble, the safeguard or the serve path record
nothing. Otherwise a span costs one flag check. While the profiler runs, a span is
also a host range of its name in the profiler's trace, and its times are on
the profiler's clock, so a reader of the trace can put a device operation
or an idle gap under the innermost span the host was in. The range is a
function-scope record (``torch._C._profiler._RecordFunctionFast``), not a
``torch.profiler.record_function``: the profiler mirrors a user-scope range
on the device as an annotation event over its kernels, which a reader of
device operations would count as device work (the whole step busy).
On a CUDA device a span also records a timing event on the current stream
at its open and at its close; the pair is resolved to ``dev_start_s`` /
``dev_dur_s`` when the ring is read (:meth:`Tracer.flush`), never while the
step runs. Step spans go to :func:`default_tracer`'s ring.

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

import torch
from torch._C._autograd import _profiler_enabled

STAGES = ("request", "queue_wait", "assembly", "replica_serve",
          "device_eval", "combine")

# A span's clock, by its ``clock`` field (absent: monotonic). Kineto stamps
# the profiler's events in Unix-epoch nanoseconds.
CLOCKS = {"monotonic": time.monotonic, "profiler": lambda: time.time_ns() * 1e-9}


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def span_open(trace_id: str | None, name: str, stage: str,
              parent_id: str | None = None, *, clock: str = "monotonic", **tags) -> dict:
    """An open span (no ``dur_s`` yet). ``trace_id=None`` makes a *raw*
    span a later :meth:`Tracer.adopt` grafts onto a trace — what components
    that must not depend on a Tracer (evaluator, replica workers) produce.
    ``clock`` names the span's entry of :data:`CLOCKS`, kept on the span
    unless it is the monotonic one."""
    span = {
        "trace_id": trace_id,
        "span_id": new_span_id(),
        "parent_id": parent_id,
        "name": name,
        "stage": stage,
        "start_s": CLOCKS[clock](),
        "pid": os.getpid(),
    }
    if clock != "monotonic":
        span["clock"] = clock
    span.update(tags)
    return span


def span_close(span: dict, **tags) -> dict:
    """Close an open span in place (sets ``dur_s``); returns it."""
    span["dur_s"] = CLOCKS[span.get("clock", "monotonic")]() - span["start_s"]
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
    ``serve --trace-dir`` points the ``--export`` CLI at). A step span
    with stream events enters the ring at once and reaches the recorder
    and the file at the next :meth:`flush`.
    """

    def __init__(self, recorder=None, *, stream: str = "spans",
                 max_spans: int = 100_000, jsonl_path: str | None = None):
        self.recorder = recorder
        self.stream = stream
        self.dropped = 0
        self._ring: deque[dict] = deque(maxlen=int(max_spans))
        self._lock = threading.Lock()
        # step spans whose stream events are not resolved yet: (span, (open,
        # close, root's open)), the oldest dropped past the ring's size
        self._pending: deque[tuple] = deque(maxlen=int(max_spans))
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

    def emit(self, span: dict, events: tuple | None = None) -> dict:
        """Collect an already-closed span (ring + recorder + JSONL tee).
        ``events``, a step span's CUDA events (its open, its close, its
        root's open), hold the tee back until :meth:`flush` resolves them."""
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(span)
            if events is not None:
                self._pending.append((span, events))
                return span
        return self._tee(span)

    def _tee(self, span: dict) -> dict:
        with self._lock:
            if self._file is not None:
                self._file.write(json.dumps(span) + "\n")
        if self.recorder is not None:
            self.recorder.record(self.stream, span)
        return span

    def flush(self) -> None:
        """Resolve the stream times (``dev_start_s``, ``dev_dur_s``) of the
        step spans emitted since the last flush, each after its closing
        event has completed, and tee them. What reads the ring calls it."""
        with self._lock:
            pending = list(self._pending)
            self._pending.clear()
        for span, (ev_open, ev_close, root_open) in pending:
            ev_close.synchronize()
            span["dev_start_s"] = root_open.elapsed_time(ev_open) * 1e-3
            span["dev_dur_s"] = ev_open.elapsed_time(ev_close) * 1e-3
            self._tee(span)

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
        self.flush()
        with self._lock:
            return list(self._ring)

    def trace(self, trace_id: str) -> list[dict]:
        return [s for s in self.spans() if s.get("trace_id") == trace_id]

    def close(self) -> None:
        self.flush()
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


# ---------------------------------------------------------------------------
# Step spans
# ---------------------------------------------------------------------------

_default = Tracer()  # where step spans go
_installed = False  # an operator's tracer: spans on with no profiler running
_local = threading.local()  # .stack: this thread's open step spans


def default_tracer() -> Tracer:
    """The tracer step spans go to: the one :func:`install` set, or the
    process's own ring."""
    return _default


def install(tracer: Tracer | None) -> None:
    """The operator's switch: step spans go to ``tracer`` and are recorded
    whether or not the profiler runs. ``None`` puts back a fresh ring of
    the process's own, recorded only under the profiler."""
    global _default, _installed
    _default, _installed = (tracer, True) if tracer is not None else (Tracer(), False)


class _Off:
    """What :func:`span` returns when step spans are off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, stage: str, *, root: bool = False, **tags):
    """A step span over a ``with`` block, the child of the innermost step
    span open in this thread; ``root`` lets it open a new trace where none
    is open. The block gets the span dict. Off (a shared no-op, after one flag check) unless
    the profiler runs or :func:`install` set a tracer, and off for a child
    with no step span open. A span holds no tensor and changes nothing the
    block computes."""
    if not (_installed or _profiler_enabled()):
        return _OFF
    if not (root or getattr(_local, "stack", None)):
        return _OFF
    return _StepSpan(name, stage, tags)


class _StepSpan:
    __slots__ = ("name", "stage", "tags", "span", "_range", "_events")

    def __init__(self, name: str, stage: str, tags: dict):
        self.name, self.stage, self.tags = name, stage, tags

    def __enter__(self) -> dict:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.span = span_open(parent.span["trace_id"] if parent else new_trace_id(),
                              self.name, self.stage,
                              parent.span["span_id"] if parent else None,
                              clock="profiler", **self.tags)
        self._range = None
        if _profiler_enabled():
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        self._events = None
        if torch.cuda.is_initialized():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            root = parent._events[1] if parent is not None and parent._events else ev
            self._events = (ev, root)
        stack.append(self)
        return self.span

    def __exit__(self, *exc) -> bool:
        _local.stack.pop()
        events = None
        if self._events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events = (self._events[0], ev, self._events[1])
        if self._range is not None:
            self._range.__exit__(*exc)
        span_close(self.span)
        _default.emit(self.span, events)
        return False


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
