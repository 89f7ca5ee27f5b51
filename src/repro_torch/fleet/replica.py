"""Read replicas: local posterior windows answering queries, the port of
``repro.fleet.replica``.

A :class:`ReplicaEnsemble` is the read half of a fleet shard: it holds a
delta-streamed copy of its writer's window (host numpy) and answers
posterior functionals from it through its own
:class:`repro_torch.serving.resident.SnapshotEvaluator` on the replica's
device, the same code the writer serves with, so a replica's answers are
bit for bit the writer's from the same version.

:class:`ReplicaProcess` hosts one ReplicaEnsemble in an OS process of its
own (the ``proc`` transport). Deltas and query batches cross a pipe
pickled, as numpy (:func:`repro_torch.fleet.delta.wire_bytes` is what
crosses); each replica process has its own interpreter, GIL and CUDA
context. The process starts from a **spawn** context (a forked child cannot
use CUDA) and builds its workload's query specs from the serving registry
by name (specs hold closures, which do not pickle), which puts a copy of
the workload's data on the replica's device. A replica whose device is the
card and cannot reach it fails its start; it does not go on on the CPU.
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import threading
import time
from typing import Any

import numpy as np

from .._device import tree_leaves
from ..obs.trace import new_span_id, span_close, span_open
from ..serving.resident import QuerySpec, Snapshot, SnapshotEvaluator
from .delta import SnapshotDelta, apply_delta, wire_bytes

Params = Any


class ReplicaDeadError(ConnectionError):
    """The replica itself (not the request) failed: its process died, its
    pipe broke, or it was killed. The fleet's sync skips such a replica and
    keeps broadcasting; the router marks its lane dead and sends the batch
    to the surviving lanes instead of failing it."""


class ReplicaEnsemble:
    """An in-process read replica: a local window and an evaluator on
    ``device`` (``None`` means the card).

    Thread-safe: ``apply_delta`` replaces (never mutates) the window under a
    lock; snapshots are immutable once taken.
    """

    def __init__(self, name: str, *, micro_batch: int = 64, device=None):
        self.name = name
        self.version = 0  # the writer's steps_done our window mirrors
        self._draws = None
        self._summary: dict = {}
        self._base_staleness = 0.0  # the writer's staleness at the last sync
        self._last_update: float | None = None
        self._evaluator = SnapshotEvaluator(micro_batch, device)
        self.device = self._evaluator.device
        self._lock = threading.RLock()
        self._dead = False
        self.deltas_applied = 0
        self.full_syncs = 0
        self.bytes_received = 0

    def apply_delta(self, delta: SnapshotDelta, *, nbytes: int | None = None) -> int:
        """Fold a writer's delta into the local window; returns the version.
        An incremental delta whose ``base_version`` is not the replica's
        raises ``ValueError``; the fleet's sync then sends a full resync."""
        with self._lock:
            if self._dead:
                raise ReplicaDeadError(f"replica {self.name!r} is down (killed)")
            if not delta.full and delta.draws is not None \
                    and delta.base_version != self.version:
                raise ValueError(
                    f"replica {self.name!r} at version {self.version} cannot apply incremental "
                    f"delta from base {delta.base_version}; full resync required")
            self._draws = apply_delta(self._draws, delta)
            self.version = delta.version
            self._summary = delta.summary
            self._base_staleness = delta.staleness_s
            self._last_update = time.monotonic()
            self.deltas_applied += 1
            self.full_syncs += int(delta.full)
            self.bytes_received += int(nbytes if nbytes is not None else wire_bytes(delta))
            if delta.draws is not None:
                # The window can change under the same (steps_done, num_draws)
                # key on a resync after a restore; dropping the device copy is
                # cheap and always safe.
                self._evaluator.invalidate()
            return self.version

    def reset(self) -> None:
        """Forget the local copy (the next sync is then full)."""
        with self._lock:
            self._draws = None
            self.version = 0
            self._summary = {}
            self._base_staleness = 0.0
            self._last_update = None
            self._evaluator.invalidate()

    def snapshot(self) -> Snapshot:
        """The replica's local view. Its staleness is the writer's at
        emission plus the time since the delta arrived: a replica never
        reports its draws younger than they are."""
        with self._lock:
            now = time.monotonic()
            staleness = (float("inf") if self._last_update is None
                         else self._base_staleness + (now - self._last_update))
            num = 0
            if self._draws is not None:
                lead = tree_leaves(self._draws)[0].shape
                num = int(lead[0] * lead[1])
            return Snapshot(draws=self._draws, num_draws=num, steps_done=self.version,
                            staleness_s=staleness, summary=self._summary, created_at=now)

    def query(self, spec: QuerySpec, xs, *, snapshot: Snapshot | None = None,
              span_sink: list | None = None) -> tuple[np.ndarray, Snapshot]:
        if self._dead:
            raise ReplicaDeadError(f"replica {self.name!r} is down (killed)")
        snap = snapshot if snapshot is not None else self.snapshot()
        if snap.draws is None:
            raise RuntimeError(f"replica {self.name!r} has no window yet; sync a delta first")
        return self._evaluator.evaluate(spec, snap, xs, span_sink=span_sink), snap

    def serve(self, spec: QuerySpec, query_class: str, xs, trace=None):
        """The router's entry: ``(values, staleness_s)``, or, given ``trace
        = (trace_id, parent_span_id)``, ``(values, staleness_s, spans)`` with
        the replica's ``replica_serve`` span and its ``device_eval`` child.
        ``query_class`` is unused in-process (the spec comes along); the
        process transport resolves it from the registry instead."""
        del query_class
        if trace is None:
            values, snap = self.query(spec, xs)
            return values, snap.staleness_s
        values, snap, spans = _traced_query(self, spec, xs, trace)
        return values, snap.staleness_s, spans

    def window(self, known_version: int = -1) -> tuple[int, Snapshot | None]:
        """``(version, snapshot)`` for combine-at-query, or ``(version,
        None)`` when the caller already holds ``known_version``: the
        router's window cache then skips fetching an unchanged window."""
        with self._lock:
            if self._dead:
                raise ReplicaDeadError(f"replica {self.name!r} is down (killed)")
            if self.version == known_version and self._draws is not None:
                return self.version, None
            return self.version, self.snapshot()

    def stats(self) -> dict:
        with self._lock:
            return {"name": self.name, "version": self.version, "alive": not self._dead,
                    "deltas_applied": self.deltas_applied, "full_syncs": self.full_syncs,
                    "bytes_received": self.bytes_received}

    # -- fault injection (the same surface as ReplicaProcess) -----------------

    @property
    def alive(self) -> bool:
        return not self._dead

    def ping(self) -> bool:
        return not self._dead

    def kill(self) -> None:
        """A simulated crash: every later ``apply_delta`` or ``query`` raises
        :class:`ReplicaDeadError` until :meth:`restart`."""
        with self._lock:
            self._dead = True

    def restart(self) -> None:
        """Come back empty (the next sync is a full resync)."""
        with self._lock:
            self._dead = False
        self.reset()

    def close(self) -> None:  # the same surface as ReplicaProcess
        pass


def _traced_query(replica: ReplicaEnsemble, spec: QuerySpec, xs, trace):
    """A replica query under a ``replica_serve`` span with its
    ``device_eval`` child, both keyed to ``trace = (trace_id,
    parent_span_id)``: ``(values, snap, spans)``, closed span dicts (which
    the process transport pickles back)."""
    trace_id, parent_id = trace
    serve_span = span_open(trace_id, f"replica_serve:{replica.name}", "replica_serve",
                           parent_id=parent_id, replica=replica.name)
    sink: list = []
    values, snap = replica.query(spec, xs, span_sink=sink)
    span_close(serve_span, version=replica.version)
    spans = [serve_span]
    for raw in sink:
        raw = dict(raw)
        raw["trace_id"] = trace_id
        if raw.get("span_id") is None:
            raw["span_id"] = new_span_id()
        raw["parent_id"] = serve_span["span_id"]
        spans.append(raw)
    return values, snap, spans


# ---------------------------------------------------------------------------
# The process transport
# ---------------------------------------------------------------------------


def _device_memory(device) -> dict:
    """The device memory this process holds on ``device`` (CUDA only)."""
    import torch

    if device.type != "cuda":
        return {}
    return {"device_bytes_allocated": int(torch.cuda.memory_allocated(device)),
            "device_bytes_reserved": int(torch.cuda.memory_reserved(device))}


def _replica_worker(conn, name: str, workload_name: str, build_kw: dict, micro_batch: int,
                    threads: int | None) -> None:
    """The replica process's loop: build the workload's query specs from the
    registry, then answer pickled ``(cmd, ...)`` frames until ``stop``."""
    import torch

    if threads:
        # One intra-op thread a replica lets N replicas share an M-core host
        # instead of contending for one pool.
        torch.set_num_threads(int(threads))
    from ..serving.workloads import build_serving_workload

    try:
        workload = build_serving_workload(workload_name, **build_kw)
        replica = ReplicaEnsemble(name, micro_batch=micro_batch, device=build_kw.get("device"))
        conn.send_bytes(pickle.dumps(("ready", name)))
    except Exception as e:  # noqa: BLE001 - report the failure, then exit
        conn.send_bytes(pickle.dumps(("err", f"{type(e).__name__}: {e}")))
        return
    while True:
        try:
            msg = pickle.loads(conn.recv_bytes())
        except EOFError:
            return
        cmd = msg[0]
        if cmd == "stop":
            conn.send_bytes(pickle.dumps(("ok",)))
            return
        try:
            if cmd == "delta":
                out = ("ok", replica.apply_delta(msg[1], nbytes=msg[2]))
            elif cmd == "query":
                # 3-tuple: untraced; a 4th element carries (trace_id,
                # parent_span_id) and asks for the replica's spans back.
                _, query_class, xs, *rest = msg
                trace = rest[0] if rest else None
                spec = workload.query_specs[query_class]
                if trace is None:
                    values, snap = replica.query(spec, xs)
                    out = ("ok", values, snap.staleness_s, replica.version)
                else:
                    values, snap, spans = _traced_query(replica, spec, xs, trace)
                    out = ("ok", values, snap.staleness_s, replica.version, spans)
            elif cmd == "window":
                version, snap = replica.window(msg[1])
                out = ("ok", version, snap)
            elif cmd == "reset":
                replica.reset()
                out = ("ok", replica.version)
            elif cmd == "stats":
                out = ("ok", {**replica.stats(), **_device_memory(replica.device)})
            elif cmd == "ping":
                out = ("ok",)
            else:
                out = ("err", f"unknown command {cmd!r}")
        except Exception as e:  # noqa: BLE001 - fail the request, not the loop
            out = ("err", f"{type(e).__name__}: {e}")
        conn.send_bytes(pickle.dumps(out))


class ReplicaProcess:
    """A read replica in an OS process of its own.

    The surface of :class:`ReplicaEnsemble` (``apply_delta``, ``serve``,
    ``window``, ``stats``, ``version``), each call an RPC over a spawn
    context's pipe; ``bytes_sent`` counts the pickled payload and
    ``start_s`` the seconds from spawn to the worker's ready message. One
    RPC runs at a time a replica (the pipe is the queue).

    A script that creates one (directly or through ``FleetConfig(transport=
    "proc")``) must do so under ``if __name__ == "__main__":``: the spawned
    child imports the main module again.
    """

    def __init__(self, name: str, workload_name: str, build_kw: dict | None = None, *,
                 micro_batch: int = 64, threads: int | None = 1,
                 start_timeout_s: float = 120.0):
        self.name = name
        self.version = 0
        self.bytes_sent = 0
        self.start_s: float | None = None
        # Re-entrant: restart() holds it across close() + _spawn() (close takes
        # it again for the stop handshake), so no concurrent _rpc can read the
        # fresh pipe's "ready" message.
        self._lock = threading.RLock()
        self._workload_name = workload_name
        self._build_kw = dict(build_kw or {})
        self._micro_batch = micro_batch
        self._threads = threads
        self._start_timeout_s = start_timeout_s
        self._proc = None
        self._conn = None
        self._spawn()

    def _spawn(self) -> None:
        t0 = time.perf_counter()
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(
            target=_replica_worker,
            args=(child, self.name, self._workload_name, dict(self._build_kw),
                  self._micro_batch, self._threads),
            name=f"replica-{self.name}",
            daemon=True,
        )
        self._proc.start()
        child.close()
        if not self._conn.poll(self._start_timeout_s):
            self.close()
            raise TimeoutError(f"replica process {self.name!r} did not start")
        first = pickle.loads(self._conn.recv_bytes())
        if first[0] != "ready":
            self.close()
            raise RuntimeError(f"replica process {self.name!r} failed: {first[1]}")
        self.start_s = time.perf_counter() - t0

    def _rpc(self, *msg):
        payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        try:
            with self._lock:
                if self._proc is None or not self._proc.is_alive():
                    raise ReplicaDeadError(f"replica {self.name!r} process is down")
                self.bytes_sent += len(payload)
                self._conn.send_bytes(payload)
                out = pickle.loads(self._conn.recv_bytes())
        except ReplicaDeadError:
            raise
        except (EOFError, BrokenPipeError, ConnectionResetError, OSError) as e:
            # The transport failed (a killed process shows as EOF), not the
            # request: the worker's ("err", ...) replies stay RuntimeError.
            raise ReplicaDeadError(
                f"replica {self.name!r} transport failed: {type(e).__name__}: {e}") from e
        if out[0] == "err":
            raise RuntimeError(f"replica {self.name!r}: {out[1]}")
        return out

    def apply_delta(self, delta: SnapshotDelta, *, nbytes: int | None = None) -> int:
        nb = nbytes if nbytes is not None else wire_bytes(delta)
        self.version = self._rpc("delta", delta, nb)[1]
        return self.version

    def reset(self) -> None:
        self.version = self._rpc("reset")[1]

    def serve(self, spec, query_class: str, xs, trace=None):
        """As :meth:`ReplicaEnsemble.serve`; the spans, given ``trace``, are
        built in the worker (their ``pid`` is the replica's)."""
        del spec  # resolved from the registry in the worker
        if trace is None:
            out = self._rpc("query", query_class, np.asarray(xs))
            self.version = out[3]
            return out[1], out[2]
        out = self._rpc("query", query_class, np.asarray(xs), tuple(trace))
        self.version = out[3]
        return out[1], out[2], out[4]

    def window(self, known_version: int = -1) -> tuple[int, Snapshot | None]:
        """As :meth:`ReplicaEnsemble.window`: the snapshot crosses the pipe
        only when ``known_version`` is out of date."""
        out = self._rpc("window", known_version)
        self.version = out[1]
        return out[1], out[2]

    def stats(self) -> dict:
        stats = self._rpc("stats")[1]
        stats["bytes_sent"] = self.bytes_sent
        stats["start_s"] = self.start_s
        return stats

    # -- fault injection ------------------------------------------------------

    @property
    def alive(self) -> bool:
        return self._proc is not None and self._proc.is_alive()

    def ping(self) -> bool:
        """True when the worker answers, False on a dead transport (never
        raises: the router's revive() probe)."""
        try:
            self._rpc("ping")
            return True
        except ReplicaDeadError:
            return False

    def kill(self, timeout_s: float = 10.0) -> None:
        """SIGKILL the worker: in-flight RPCs raise ReplicaDeadError."""
        proc = self._proc
        if proc is not None and proc.is_alive():
            proc.kill()
            proc.join(timeout=timeout_s)

    def restart(self) -> None:
        """Spawn the worker again in place (an empty window at version 0;
        the next sync is full). Holds the RPC lock for the whole bounce, so
        a concurrent ``_rpc`` cannot take the new pipe's ready message; a
        caller blocked on the old pipe fails fast (EOF) and lets go."""
        with self._lock:
            self.close(timeout_s=1.0)
            self.version = 0
            self._spawn()

    def close(self, timeout_s: float = 10.0) -> None:
        proc, conn = self._proc, self._conn
        if proc is None:
            return
        try:
            if proc.is_alive():
                try:
                    with self._lock:
                        conn.send_bytes(pickle.dumps(("stop",)))
                        if conn.poll(timeout_s):
                            conn.recv_bytes()
                except (BrokenPipeError, OSError):
                    pass
            proc.join(timeout=timeout_s)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=timeout_s)
        finally:
            conn.close()
            self._proc = None
