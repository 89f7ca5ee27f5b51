"""Request routing with per-class priority and overload admission control,
the port of ``repro.fleet.router`` (numpy and threads: the device work is
the replicas' and the combined window's evaluator's).

The fleet's counterpart of :class:`repro_torch.serving.queue.RequestQueue`:
requests enter through :meth:`FleetRouter.submit`, are admitted or shed by
the overload policy, land on the least-loaded replica lane of their
workload's shards, and are served in priority order as same-class batches
against one pinned replica snapshot (the queue's result-transparency
carries over — the evaluator is identical).

Admission control (:class:`AdmissionConfig`) sheds the *lowest* priority
class first: when total queue depth crosses ``max_depth`` — or the
deadline-miss rate predicted from the trailing completions crosses
``max_miss_rate`` — the shed floor rises one priority level per multiple
of ``max_depth``, so progressively more classes are refused while the top
class is always admitted. Shed requests fail fast (``error="shed: ..."``)
instead of queuing toward certain deadline misses, and
:meth:`FleetRouter.slo_report` extends the queue's per-class SLO tables
with ``admitted``/``shed`` counters plus the live admission state.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import defaultdict, deque

import numpy as np

from ..core.stats import build_slo_report
from ..partition.combine import combine_snapshots
from ..serving.queue import Request
from ..serving.resident import Snapshot, SnapshotEvaluator
from .replica import ReplicaDeadError
from .topology import Fleet, FleetShard


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Overload thresholds.

    ``max_depth``: pending requests across the router before the shed floor
    rises (then one more level per additional multiple);
    ``max_miss_rate``: predicted deadline-miss rate (trailing
    ``miss_window`` completions) that raises the floor one level;
    ``min_observations``: completions required before the miss predictor is
    trusted at all.
    """

    max_depth: int = 256
    max_miss_rate: float = 0.5
    miss_window: int = 64
    min_observations: int = 16

    def __post_init__(self):
        if self.max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        if not 0.0 < self.max_miss_rate <= 1.0:
            raise ValueError("max_miss_rate must be in (0, 1]")


class _Lane:
    """One replica's pending queue."""

    __slots__ = ("shard", "replica", "pending", "served", "dead",
                 "retired", "inflight", "win_version", "win_snap")

    def __init__(self, shard: FleetShard, replica):
        self.shard = shard
        self.replica = replica
        self.pending: list[Request] = []
        self.served = 0
        # Set when the replica's transport fails (ReplicaDeadError): the
        # lane stops taking submissions and its backlog is rerouted to the
        # surviving lanes. revive() re-admits it once the replica answers
        # pings again (after ReplicaProcess.restart()).
        self.dead = False
        # Set by detach_lane (autoscaler scale-down): a clean retirement —
        # the lane takes no new batches, its worker thread exits, and
        # detach waits for `inflight` (batches mid-serve) to drain before
        # the replica may be closed.
        self.retired = False
        self.inflight = 0
        # Combine-at-query window cache (subposterior workloads only):
        # the last window this router pulled from the replica and its
        # version, so an unchanged window never re-crosses the transport.
        self.win_version = -1
        self.win_snap: Snapshot | None = None


class FleetRouter:
    """Route requests across a fleet's replicas; shed under overload."""

    def __init__(
        self,
        fleet: Fleet,
        *,
        priorities: dict[str, int] | None = None,
        admission: AdmissionConfig | None = None,
        max_batch: int | None = None,
        default_deadline_s: float | None = None,
        lanes_per_shard: int | None = None,
        tracer=None,
    ):
        self.fleet = fleet
        self.priorities = dict(priorities or {})
        self.admission = admission or AdmissionConfig()
        # Optional repro_torch.obs.trace.Tracer: the same span taxonomy as the
        # RequestQueue, plus replica_serve spans shipped back from replica
        # processes and combine spans on the subposterior path.
        self.tracer = tracer
        cfg = fleet.config.serving
        self.max_batch = int(max_batch or cfg.max_batch)
        self.default_deadline_s = (
            cfg.default_deadline_s if default_deadline_s is None
            else float(default_deadline_s)
        )
        # lanes_per_shard serves only each shard's first N replicas (None =
        # all): a sweep of replica counts over one warmed fleet.
        self._lanes: dict[str, list[_Lane]] = {
            workload: [
                _Lane(shard, replica)
                for shard in fleet.shards(workload)
                for replica in shard.replicas[:lanes_per_shard]
            ]
            for workload in fleet.workloads()
        }
        # Subposterior workloads serve through the combine-at-query path:
        # per-partition lane groups, a per-workload combined-snapshot cache
        # keyed by the partition version tuple, and one evaluator per
        # workload for the combined windows. P=1 workloads never touch any
        # of this — their serve path is byte-identical to before.
        self._partitioned: dict[str, int] = {
            w: fleet.num_partitions(w)
            for w in fleet.workloads()
            if fleet.num_partitions(w) > 1
        }
        self._partition_lanes: dict[str, dict[int, list[_Lane]]] = {}
        for workload, num_p in self._partitioned.items():
            groups: dict[int, list[_Lane]] = {p: [] for p in range(num_p)}
            for lane in self._lanes[workload]:
                groups[lane.shard.partition].append(lane)
            self._partition_lanes[workload] = groups
        self._combine_lock = threading.Lock()
        self._combined_cache: dict[str, tuple[tuple, Snapshot]] = {}
        self._combine_evaluators: dict[str, SnapshotEvaluator] = {
            w: SnapshotEvaluator(cfg.micro_batch, cfg.device) for w in self._partitioned
        }
        # Requests' batches and rows answered from each combined window
        # (warm_combined's are not counted).
        self._combined_served: dict[str, dict[str, int]] = {
            w: {"batches": 0, "rows": 0} for w in self._partitioned
        }
        self._lock = threading.Lock()
        self._arrived = threading.Condition(self._lock)
        self._completed: list[Request] = []
        self._miss_trail: deque[bool] = deque(maxlen=self.admission.miss_window)
        self._counters: dict[tuple[str, str], dict] = defaultdict(
            lambda: {"admitted": 0, "shed": 0}
        )
        self._lane_deaths = 0
        self._rerouted = 0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._max_wait_s = 0.002

    # -- admission ---------------------------------------------------------

    def _priority(self, query_class: str) -> int:
        return self.priorities.get(query_class, 0)

    def _depth_locked(self) -> int:
        return sum(len(l.pending) for lanes in self._lanes.values() for l in lanes)

    def _miss_rate_locked(self) -> float:
        """Deadline-miss rate over the trailing completions (0 until
        ``min_observations`` have been seen). Caller holds ``_lock``."""
        if len(self._miss_trail) < self.admission.min_observations:
            return 0.0
        return float(np.mean(self._miss_trail))

    def predicted_miss_rate(self) -> float:
        with self._lock:
            return self._miss_rate_locked()

    def _shed_floor_locked(self) -> int | None:
        """The priority strictly below which submissions are shed right
        now, or None when everything is admitted."""
        levels = sorted({self._priority(c) for c in self._known_classes()})
        if len(levels) < 2:
            return None  # one class: nothing lower-priority to shed first
        adm = self.admission
        depth = self._depth_locked()
        miss = self._miss_rate_locked()
        cut = 0
        if miss > adm.max_miss_rate:
            cut = 1
        if depth >= adm.max_depth:
            cut = max(cut, int(depth // adm.max_depth))
        cut = min(cut, len(levels) - 1)  # the top class is always admitted
        return None if cut == 0 else levels[cut]

    def _known_classes(self) -> set[str]:
        classes = set(self.priorities)
        for workload in self.fleet.workloads():
            classes.update(self.fleet.workload(workload).query_specs)
        return classes

    # -- intake ------------------------------------------------------------

    def submit(
        self, workload: str, query_class: str, xs, deadline_s: float | None = None
    ) -> Request:
        """Admit (routing to the least-loaded replica lane) or shed."""
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
            req.trace_id = root["trace_id"]
            req.trace = {"root": root}
        with self._arrived:
            counters = self._counters[(workload, query_class)]
            floor = self._shed_floor_locked()
            if floor is not None and self._priority(query_class) < floor:
                req.error = (
                    f"shed: admission floor at priority {floor} "
                    f"(depth={self._depth_locked()}, "
                    f"predicted_miss={np.mean(self._miss_trail) if self._miss_trail else 0.0:.2f})"
                )
                req.latency_s = 0.0
                req.deadline_met = False
                req.batch_size = 0
                counters["shed"] += 1
                self._completed.append(req)
                self._finish_req_trace(req, shed=True)
                req.done.set()
                return req
            counters["admitted"] += 1
            lanes = [l for l in self._lanes[workload] if not l.dead]
            if not lanes:
                req.error = (
                    f"ReplicaDeadError: no live replica lanes for "
                    f"workload {workload!r}"
                )
                req.latency_s = 0.0
                req.deadline_met = False
                req.batch_size = 0
                self._completed.append(req)
                self._finish_req_trace(req)
                req.done.set()
                return req
            if req.trace is not None:
                req.trace["queue"] = self.tracer.start(
                    req.trace_id, "queue_wait", "queue_wait",
                    parent_id=req.trace["root"]["span_id"],
                )
            lane = min(lanes, key=lambda l: (len(l.pending), l.served))
            lane.pending.append(req)
            self._arrived.notify_all()
        return req

    def _finish_req_trace(self, req: Request, **tags) -> None:
        """Close a completing request's open spans (root + any still-open
        queue_wait)."""
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
                **tags,
            )

    @property
    def pending_count(self) -> int:
        with self._lock:
            return self._depth_locked()

    @property
    def completed(self) -> list[Request]:
        with self._lock:
            return list(self._completed)

    # -- serving -----------------------------------------------------------

    def _take_batch(self, lane: _Lane) -> list[Request]:
        """Pop up to ``max_batch`` same-class requests, highest priority
        class first (FIFO within the class). An idle lane steals from the
        deepest backlog of the same workload — replicas of one workload are
        interchangeable, and stealing keeps the tail from being set by the
        slowest replica's private queue."""
        with self._lock:
            if lane.dead or lane.retired:
                return []
            source = lane
            if not source.pending:
                peers = self._lanes[lane.shard.workload]
                source = max(peers, key=lambda l: len(l.pending))
                if not source.pending:
                    return []
            head = max(source.pending,
                       key=lambda r: (self._priority(r.query_class), -r.id))
            key = head.query_class
            batch, rest = [], []
            for req in source.pending:
                if req.query_class == key and len(batch) < self.max_batch:
                    batch.append(req)
                else:
                    rest.append(req)
            source.pending = rest
        if self.tracer is not None:
            for req in batch:
                if req.trace and "queue" in req.trace:
                    self.tracer.finish(req.trace.pop("queue"))
        return batch

    # -- subposterior combine-at-query --------------------------------------

    def _partition_window(self, workload: str, p: int) -> Snapshot:
        """The freshest available window for partition ``p``: first live
        lane that answers, via the version-gated ``window()`` fetch (an
        unchanged window reuses the lane's cached copy). Dead transports
        are marked dead and the next lane tried; a partition with no live
        lane raises — a combined posterior needs *every* partition."""
        for lane in self._partition_lanes[workload][p]:
            if lane.dead:
                continue
            try:
                version, snap = lane.replica.window(lane.win_version)
            except ReplicaDeadError:
                self._on_lane_death(lane, [])
                continue
            if snap is not None:
                lane.win_version, lane.win_snap = version, snap
            if lane.win_snap is not None:
                return lane.win_snap
        raise ReplicaDeadError(
            f"no live replica window for workload {workload!r} "
            f"partition {p}"
        )

    def _combined_snapshot(self, workload: str) -> Snapshot:
        """One full-posterior snapshot from the P per-partition windows,
        cached per partition-version tuple (caller holds ``_combine_lock``).
        ``steps_done`` of the result is the version sum — the strictly
        increasing generation key the shared evaluator caches on."""
        snaps = [
            self._partition_window(workload, p)
            for p in range(self._partitioned[workload])
        ]
        versions = tuple(s.steps_done for s in snaps)
        cached = self._combined_cache.get(workload)
        if cached is not None and cached[0] == versions:
            return cached[1]
        combined = combine_snapshots(snaps, self.fleet.config.combine)
        self._combined_cache[workload] = (versions, combined)
        return combined

    def _serve_combined(
        self, workload: str, qclass: str, xs, trace=None
    ) -> tuple[np.ndarray, float]:
        """Serve a batch from the combined subposterior window (the
        partitioned counterpart of ``lane.replica.serve``). ``trace =
        (trace_id, parent_span_id)`` wraps the window-gather + combine in a
        ``combine`` span with the evaluator's ``device_eval`` span nested
        under it."""
        spec = self.fleet.spec(workload, qclass)
        combine_span = sink = None
        if trace is not None and self.tracer is not None:
            combine_span = self.tracer.start(
                trace[0], f"combine:{workload}", "combine",
                parent_id=trace[1], partitions=self._partitioned[workload],
            )
            sink = []
        with self._combine_lock:
            snap = self._combined_snapshot(workload)
            values = self._combine_evaluators[workload].evaluate(
                spec, snap, xs, span_sink=sink
            )
        if combine_span is not None:
            self.tracer.finish(combine_span)
            if sink:
                self.tracer.adopt(sink, trace[0],
                                  parent_id=combine_span["span_id"])
        return values, snap.staleness_s

    def warm_combined(self, workload: str, qclass: str, xs) -> np.ndarray:
        """Serve one batch from ``workload``'s combined window outside the
        request path (no admission, no counters): the first combination and
        the combined evaluator's first-call set-up, before a measured
        window."""
        return self._serve_combined(workload, qclass, np.asarray(xs))[0]

    def combined_snapshot(self, workload: str) -> Snapshot:
        """The combined window ``workload`` is served from now (built from
        the partitions' current windows if their versions moved)."""
        with self._combine_lock:
            return self._combined_snapshot(workload)

    def combined_served(self, workload: str) -> dict[str, int]:
        """Requests' ``batches`` and ``rows`` answered from ``workload``'s
        combined window so far."""
        with self._lock:
            return dict(self._combined_served[workload])

    # -- serving (continued) ------------------------------------------------

    def _serve_batch(self, lane: _Lane, batch: list[Request]) -> None:
        with self._lock:
            lane.inflight += 1
        try:
            self._serve_batch_inner(lane, batch)
        finally:
            with self._lock:
                lane.inflight -= 1

    def _serve_batch_inner(self, lane: _Lane, batch: list[Request]) -> None:
        workload, qclass = batch[0].workload, batch[0].query_class
        # Batch-level spans hang off the batch head's trace (same convention
        # as RequestQueue._serve_batch); the replica leg is traced by the
        # replica itself — in its own process for the proc transport — and
        # its spans ride back inside the query reply.
        head = batch[0].trace if self.tracer is not None else None
        trace = (head["root"]["trace_id"], head["root"]["span_id"]) \
            if head else None
        asm = None
        try:
            if trace is not None:
                asm = self.tracer.start(
                    trace[0], "batch_assembly", "assembly",
                    parent_id=trace[1], batch_size=len(batch),
                    lane=lane.replica.name,
                )
            sizes = [req.xs.shape[0] if req.xs.ndim else 1 for req in batch]
            xs = np.concatenate([np.atleast_1d(req.xs) for req in batch], axis=0)
            if asm is not None:
                self.tracer.finish(asm, rows=int(xs.shape[0]))
                asm = None
            if workload in self._partitioned:
                # Rerouting cannot help a combine that is missing a whole
                # partition, so a ReplicaDeadError here fails the batch
                # (the generic handler below) instead of cascading lane
                # deaths through _on_lane_death.
                values, staleness = self._serve_combined(
                    workload, qclass, xs, trace=trace
                )
            else:
                spec = self.fleet.spec(workload, qclass)
                if trace is None:
                    values, staleness = lane.replica.serve(spec, qclass, xs)
                else:
                    values, staleness, spans = lane.replica.serve(
                        spec, qclass, xs, trace=trace
                    )
                    for span in spans:
                        self.tracer.emit(span)
        except ReplicaDeadError:
            if asm is not None:
                self.tracer.finish(asm, error="ReplicaDeadError")
            if workload in self._partitioned:
                now = time.monotonic()
                with self._lock:
                    for req in batch:
                        req.error = (
                            "ReplicaDeadError: a subposterior partition has "
                            f"no live replica window for {workload!r}"
                        )
                        req.latency_s = now - req.submitted_at
                        req.deadline_met = False
                        req.batch_size = len(batch)
                        self._miss_trail.append(True)
                        self._finish_req_trace(req)
                        req.done.set()
                    self._completed.extend(batch)
                return
            # The replica (not the request) failed: the batch is still
            # servable, so reroute it — plus the lane's whole backlog —
            # to the surviving lanes instead of failing it. Root spans stay
            # open; the serving lane closes them when the request finishes.
            self._on_lane_death(lane, batch)
            return
        except Exception as e:  # noqa: BLE001 — fail the requests, not the server
            now = time.monotonic()
            if asm is not None:
                self.tracer.finish(asm, error=type(e).__name__)
            with self._lock:
                for req in batch:
                    req.error = f"{type(e).__name__}: {e}"
                    req.latency_s = now - req.submitted_at
                    req.deadline_met = False
                    req.batch_size = len(batch)
                    self._miss_trail.append(True)
                    self._finish_req_trace(req)
                    req.done.set()
                self._completed.extend(batch)
            return
        now = time.monotonic()
        offset = 0
        with self._lock:
            for req, size in zip(batch, sizes):
                req.values = values[offset:offset + size]
                offset += size
                req.latency_s = now - req.submitted_at
                req.deadline_met = req.latency_s <= req.deadline_s
                req.staleness_s = staleness
                req.batch_size = len(batch)
                self._miss_trail.append(not req.deadline_met)
                self._finish_req_trace(req)
                req.done.set()
            lane.served += len(batch)
            if workload in self._partitioned:
                self._combined_served[workload]["batches"] += 1
                self._combined_served[workload]["rows"] += int(xs.shape[0])
            self._completed.extend(batch)

    def _on_lane_death(self, lane: _Lane, batch: list[Request]) -> None:
        """Mark a lane dead and reroute its in-flight batch plus backlog.

        Requests keep their original ``submitted_at`` — the extra latency a
        failover costs is real and must show in the SLO tables. Only when no
        live lane remains do the stranded requests fail."""
        with self._arrived:
            if not lane.dead:
                lane.dead = True
                self._lane_deaths += 1
            stranded = batch + lane.pending
            lane.pending = []
            live = [l for l in self._lanes[lane.shard.workload] if not l.dead]
            if not live:
                now = time.monotonic()
                for req in stranded:
                    req.error = (
                        f"ReplicaDeadError: no live replica lanes for "
                        f"workload {lane.shard.workload!r}"
                    )
                    req.latency_s = now - req.submitted_at
                    req.deadline_met = False
                    req.batch_size = 0
                    self._miss_trail.append(True)
                    self._finish_req_trace(req)
                    req.done.set()
                self._completed.extend(stranded)
                return
            for req in stranded:
                target = min(live, key=lambda l: (len(l.pending), l.served))
                target.pending.append(req)
                self._rerouted += 1
            self._arrived.notify_all()

    # -- runtime lane scaling ----------------------------------------------

    def attach_lane(self, shard: FleetShard, replica) -> None:
        """Add a serving lane for a runtime-spawned replica (the scale-up
        actuation; pair of :meth:`repro_torch.fleet.Fleet.add_replica`).

        The lane joins the workload's least-loaded selection immediately;
        when background workers are running it gets its own serving thread,
        so attach works mid-load without a router restart."""
        lane = _Lane(shard, replica)
        with self._arrived:
            self._lanes[shard.workload].append(lane)
            groups = self._partition_lanes.get(shard.workload)
            if groups is not None:
                groups[shard.partition].append(lane)
            spawn = bool(self._threads)
            self._arrived.notify_all()
        if spawn:
            self._spawn_worker(lane)

    def detach_lane(self, workload: str, replica_name: str,
                    timeout_s: float = 30.0) -> bool:
        """Cleanly retire one lane without dropping requests (the
        scale-down actuation; call **before**
        :meth:`repro_torch.fleet.Fleet.remove_replica` closes the replica).

        The lane is removed from the routing set, its backlog is rerouted
        to the surviving lanes (or failed, only if none remain — the
        min-replica bound upstream prevents that), its worker thread exits,
        and this method blocks until any batch the lane is serving right
        now has completed, so the caller may close the replica the moment
        it returns. Returns False when no live lane matches."""
        with self._arrived:
            lanes = self._lanes[workload]
            lane = next(
                (l for l in lanes if l.replica.name == replica_name), None
            )
            if lane is None:
                return False
            lane.retired = True
            stranded = lane.pending
            lane.pending = []
            lanes.remove(lane)
            groups = self._partition_lanes.get(workload)
            if groups is not None and lane in groups[lane.shard.partition]:
                groups[lane.shard.partition].remove(lane)
            live = [l for l in lanes if not l.dead]
            if stranded and live:
                for req in stranded:
                    target = min(live, key=lambda l: (len(l.pending), l.served))
                    target.pending.append(req)
                    self._rerouted += 1
            elif stranded:
                now = time.monotonic()
                for req in stranded:
                    req.error = (
                        f"ReplicaDeadError: no live replica lanes for "
                        f"workload {workload!r}"
                    )
                    req.latency_s = now - req.submitted_at
                    req.deadline_met = False
                    req.batch_size = 0
                    self._miss_trail.append(True)
                    self._finish_req_trace(req)
                    req.done.set()
                self._completed.extend(stranded)
            self._arrived.notify_all()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not lane.inflight:
                    return True
            time.sleep(0.005)
        return True  # timed out waiting; caller's close() will surface it

    def revive(self) -> int:
        """Re-admit dead lanes whose replica answers pings again (after a
        :meth:`ReplicaProcess.restart` + resync); returns how many."""
        revived = 0
        for lanes in self._lanes.values():
            for lane in lanes:
                if lane.dead and lane.replica.ping():
                    with self._lock:
                        lane.dead = False
                    revived += 1
        return revived

    @property
    def dead_lanes(self) -> int:
        with self._lock:
            return sum(
                l.dead for lanes in self._lanes.values() for l in lanes
            )

    def drain(self) -> list[Request]:
        """Serve everything pending on the calling thread (deterministic;
        what tests and the smoke path use), round-robin over lanes."""
        served: list[Request] = []
        while True:
            any_served = False
            for lanes in self._lanes.values():
                for lane in lanes:
                    batch = self._take_batch(lane)
                    if batch:
                        self._serve_batch(lane, batch)
                        # A batch that hit a dead lane was rerouted, not
                        # completed — count each request where it finishes.
                        served.extend(r for r in batch if r.done.is_set())
                        any_served = True
            if not any_served:
                return served

    # -- background workers ------------------------------------------------

    def _lane_loop(self, lane: _Lane) -> None:
        while not self._stop.is_set() and not lane.retired:
            with self._arrived:
                if not lane.pending:
                    self._arrived.wait(timeout=0.02)
            if self._max_wait_s:
                time.sleep(self._max_wait_s)  # let a batch accumulate first
            # One take AFTER the linger: _take_batch already caps at
            # max_batch and keeps the batch single-class (a second take
            # could return a different class, and truncating a merged
            # batch would orphan popped requests).
            batch = self._take_batch(lane)
            if batch:
                self._serve_batch(lane, batch)

    def _spawn_worker(self, lane: _Lane) -> None:
        t = threading.Thread(
            target=self._lane_loop, args=(lane,),
            name=f"route-{lane.replica.name}", daemon=True,
        )
        t.start()
        self._threads.append(t)

    def start_workers(self, max_wait_s: float = 0.002) -> None:
        """One serving thread per replica lane — with process-transport
        replicas each lane's RPC blocks GIL-free, so lanes genuinely serve
        in parallel. Lanes attached later (:meth:`attach_lane`) get their
        own worker on attach."""
        if self._threads:
            return
        self._stop.clear()
        self._max_wait_s = max_wait_s
        for lanes in self._lanes.values():
            for lane in lanes:
                self._spawn_worker(lane)

    def stop_workers(self, timeout_s: float = 30.0) -> None:
        self._stop.set()
        with self._arrived:
            self._arrived.notify_all()
        for t in self._threads:
            t.join(timeout=timeout_s)
        self._threads = []

    # -- SLO accounting ----------------------------------------------------

    def slo_report(self) -> dict:
        """The queue's per-class SLO tables (same unified
        :func:`repro_torch.core.stats.build_slo_report` schema) extended with
        admission-control counters per class plus the router-wide admission
        and lane-recovery state."""
        with self._lock:
            done = [r for r in self._completed if r.latency_s is not None]
            counters = {k: dict(v) for k, v in self._counters.items()}
            depth = self._depth_locked()
            floor = self._shed_floor_locked()
            miss = self._miss_rate_locked()
            recovery = {
                "lane_deaths": self._lane_deaths,
                "rerouted": self._rerouted,
                "dead_lanes": sum(
                    l.dead for lanes in self._lanes.values() for l in lanes
                ),
            }
        priorities = {qc: self._priority(qc) for qc in self._known_classes()}
        return build_slo_report(
            done,
            priorities=priorities,
            class_counters=counters,
            admission={
                "depth": depth,
                "predicted_miss_rate": miss,
                "shed_floor": floor,
            },
            recovery=recovery,
        ).to_dict()
