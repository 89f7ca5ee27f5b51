"""Request queue: batching, per-request deadlines and SLO accounting, the
port of ``repro.serving.queue`` (numpy and threads: no device code here).

The request path is::

    submit() ──▶ pending queue ──▶ batcher ──▶ EnsemblePool.query ──▶ results
                                   (group by workload × request class,
                                    pin ONE fresh snapshot per batch,
                                    concatenate rows, evaluate once,
                                    split results back per request)

Batching is **result-transparent**: the resident evaluates row-wise
functionals at a fixed micro-batch shape, so a request served inside a
batch returns exactly what it would alone (regression-tested). Every
request carries a deadline; completion records latency, deadline
hit/miss, the staleness of the snapshot that served it, and the batch it
rode in — :meth:`RequestQueue.slo_report` aggregates these into the
per-class :func:`repro_torch.core.stats.slo_summary` tables
``repro_torch.launch.serve`` prints.

``drain()`` serves synchronously (deterministic; what tests and the smoke
path use); ``start_worker()`` moves the same loop onto a thread for
always-on serving next to the pool's background refreshes.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time

import numpy as np

from ..core.stats import build_slo_report
from .pool import EnsemblePool

_REQUEST_IDS = itertools.count()


@dataclasses.dataclass
class Request:
    """One posterior query plus its lifecycle/SLO record."""

    workload: str
    query_class: str
    xs: np.ndarray
    deadline_s: float
    submitted_at: float
    id: int = dataclasses.field(default_factory=lambda: next(_REQUEST_IDS))
    # -- filled at completion --
    values: np.ndarray | None = None
    error: str | None = None
    latency_s: float | None = None
    deadline_met: bool | None = None
    staleness_s: float | None = None
    batch_size: int | None = None
    # -- tracing (set by a tracer-enabled queue/router at submit) --
    trace_id: str | None = None
    trace: dict | None = None  # open spans: {"root": ..., "queue": ...}
    done: threading.Event = dataclasses.field(default_factory=threading.Event)

    def result(self, timeout_s: float | None = None) -> np.ndarray:
        if not self.done.wait(timeout=timeout_s):
            raise TimeoutError(f"request {self.id} not served in {timeout_s}s")
        if self.error is not None:
            raise RuntimeError(f"request {self.id} failed: {self.error}")
        return self.values


class RequestQueue:
    """Coalesce requests into batched posterior evaluations on a pool."""

    def __init__(
        self,
        pool: EnsemblePool,
        *,
        max_batch: int | None = None,
        default_deadline_s: float | None = None,
        tracer=None,
    ):
        self.pool = pool
        # Optional tracer (new_trace / start / finish / adopt, as an
        # observability layer provides): when set, every request carries a
        # trace (root span at submit, queue_wait until batched, one assembly
        # + device_eval span per batch). Tracing off = zero new work on the
        # request path.
        self.tracer = tracer
        self.max_batch = int(max_batch or pool.config.max_batch)
        self.default_deadline_s = (
            pool.config.default_deadline_s
            if default_deadline_s is None
            else float(default_deadline_s)
        )
        self._pending: list[Request] = []
        self._completed: list[Request] = []
        self._lock = threading.Lock()
        self._arrived = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- intake ------------------------------------------------------------

    def submit(
        self,
        workload: str,
        query_class: str,
        xs,
        deadline_s: float | None = None,
    ) -> Request:
        req = Request(
            workload=workload,
            query_class=query_class,
            xs=np.asarray(xs),
            deadline_s=self.default_deadline_s if deadline_s is None else deadline_s,
            submitted_at=time.monotonic(),
        )
        if self.tracer is not None:
            root = self.tracer.new_trace(
                f"request:{workload}.{query_class}", "request",
                workload=workload, query_class=query_class, request_id=req.id,
            )
            queue_span = self.tracer.start(
                root["trace_id"], "queue_wait", "queue_wait",
                parent_id=root["span_id"],
            )
            req.trace_id = root["trace_id"]
            req.trace = {"root": root, "queue": queue_span}
        with self._arrived:
            self._pending.append(req)
            self._arrived.notify()
        return req

    @property
    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    @property
    def completed(self) -> list[Request]:
        with self._lock:
            return list(self._completed)

    # -- batched serving ---------------------------------------------------

    def _take_batch(self) -> list[Request]:
        """Pop up to ``max_batch`` same-(workload, class) requests, oldest
        group head first."""
        with self._lock:
            if not self._pending:
                return []
            head = self._pending[0]
            group_key = (head.workload, head.query_class)
            batch, rest = [], []
            for req in self._pending:
                if (req.workload, req.query_class) == group_key and len(batch) < self.max_batch:
                    batch.append(req)
                else:
                    rest.append(req)
            self._pending = rest
        if self.tracer is not None:
            for req in batch:
                if req.trace and "queue" in req.trace:
                    self.tracer.finish(req.trace.pop("queue"))
        return batch

    def _serve_batch(self, batch: list[Request]) -> None:
        name, qclass = batch[0].workload, batch[0].query_class
        # Batch-level spans hang off the batch head's trace: assembly
        # covers concat + snapshot pinning; the evaluator's device_eval
        # span is adopted after the query returns.
        head = batch[0].trace if self.tracer is not None else None
        asm = None
        sink: list | None = [] if head else None
        try:
            if head:
                asm = self.tracer.start(
                    head["root"]["trace_id"], "batch_assembly", "assembly",
                    parent_id=head["root"]["span_id"], batch_size=len(batch),
                )
            # The concatenate is inside the try: one malformed request (e.g.
            # mismatched row width) must fail its batch, not the serve loop.
            sizes = [req.xs.shape[0] if req.xs.ndim else 1 for req in batch]
            xs = np.concatenate([np.atleast_1d(req.xs) for req in batch], axis=0)
            # One fresh snapshot serves the whole batch (consistent draws).
            snap = self.pool.ensure_fresh(name)
            if asm is not None:
                self.tracer.finish(asm, rows=int(xs.shape[0]))
                asm = None
            values, snap = self.pool.query(
                name, qclass, xs, snapshot=snap, span_sink=sink
            )
        except Exception as e:  # noqa: BLE001 — fail the requests, not the server
            now = time.monotonic()
            if asm is not None:
                self.tracer.finish(asm, error=type(e).__name__)
            for req in batch:
                req.error = f"{type(e).__name__}: {e}"
                req.latency_s = now - req.submitted_at
                req.deadline_met = False
                req.batch_size = len(batch)
                self._finish_trace(req)
                req.done.set()
            with self._lock:
                self._completed.extend(batch)
            return
        if head and sink:
            self.tracer.adopt(sink, head["root"]["trace_id"],
                              parent_id=head["root"]["span_id"])
        now = time.monotonic()
        offset = 0
        for req, size in zip(batch, sizes):
            req.values = values[offset:offset + size]
            offset += size
            req.latency_s = now - req.submitted_at
            req.deadline_met = req.latency_s <= req.deadline_s
            req.staleness_s = snap.staleness_s
            req.batch_size = len(batch)
            self._finish_trace(req)
            req.done.set()
        with self._lock:
            self._completed.extend(batch)

    def _finish_trace(self, req: Request) -> None:
        """Close a completing request's open spans (root + any still-open
        queue_wait, e.g. when the batch failed before _take_batch closed
        it)."""
        if self.tracer is None or not req.trace:
            return
        if "queue" in req.trace:
            self.tracer.finish(req.trace.pop("queue"))
        root = req.trace.pop("root", None)
        if root is not None:
            self.tracer.finish(
                root,
                error=req.error,
                deadline_met=req.deadline_met,
                batch_size=req.batch_size,
            )

    def drain(self) -> list[Request]:
        """Serve every pending request (batched) on the calling thread;
        returns the requests completed by this call, in completion order."""
        served: list[Request] = []
        while True:
            batch = self._take_batch()
            if not batch:
                return served
            self._serve_batch(batch)
            served.extend(batch)

    # -- background worker -------------------------------------------------

    def start_worker(self, max_wait_s: float = 0.005) -> None:
        """Serve continuously on a daemon thread. ``max_wait_s`` is how long
        the batcher lingers for more arrivals once the queue is non-empty —
        the latency/batching trade."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                with self._arrived:
                    if not self._pending:
                        self._arrived.wait(timeout=0.05)
                        continue
                if max_wait_s:
                    time.sleep(max_wait_s)  # let a batch accumulate
                self.drain()

        self._thread = threading.Thread(target=loop, name="serve-queue", daemon=True)
        self._thread.start()

    def stop_worker(self, timeout_s: float = 30.0) -> None:
        thread = self._thread
        if thread is None:
            return
        self._stop.set()
        with self._arrived:
            self._arrived.notify_all()
        thread.join(timeout=timeout_s)
        self._thread = None

    # -- SLO accounting ----------------------------------------------------

    def slo_report(self) -> dict:
        """Per-(workload, request-class) latency/deadline/staleness tables
        over everything completed so far, in the unified
        :func:`repro_torch.core.stats.build_slo_report` schema (the queue never
        sheds, so its ``shed`` counters are always zero)."""
        with self._lock:
            done = [r for r in self._completed if r.latency_s is not None]
        return build_slo_report(done).to_dict()
