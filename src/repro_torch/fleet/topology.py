"""Fleet topology: workload shards, writers, replica pools and sync, the
port of ``repro.fleet.topology``.

The fleet splits the two halves of posterior serving that one pool fuses
(the parallel-transition against replicated-serving split of Angelino et
al., *Patterns of Scalable Bayesian Inference*)::

    Fleet
      └─ shard "bayeslr@0"   writer ResidentEnsemble (advances the chains)
      │     ├─ replica #r0   ReplicaEnsemble | ReplicaProcess
      │     └─ replica #r1     (answer queries from a delta-streamed
      │                          copy of the writer's window)
      └─ shard "bayeslr@1"   ...

Each workload gets ``shards`` independent writers over the same data, each
seeded :func:`shard_seed`, and each writer broadcasts
:mod:`repro_torch.fleet.delta` snapshot deltas to ``replicas`` read
replicas. Writers live in one :class:`repro_torch.serving.EnsemblePool`, so
its freshness policy, warm checkpoints and refreshes apply unchanged;
replicas resync (a full-window delta) after a restore, then ride
incremental deltas again. With ``subposterior = P > 1`` each workload's
observations are split into P stride shards, each with its own writers
(:mod:`repro_torch.partition`).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, NamedTuple

import numpy as np

from .._device import tree_leaves
from ..partition.combine import METHODS as COMBINE_METHODS
from ..partition.partitioner import partition_append_indices, partition_target, take_sections
from ..serving.pool import EnsemblePool, ServingConfig
from ..serving.resident import QuerySpec, ResidentEnsemble
from ..serving.workloads import ServingWorkload, build_serving_workload
from .delta import make_delta, payload_nbytes, wire_bytes
from .replica import ReplicaDeadError, ReplicaEnsemble, ReplicaProcess


def shard_seed(seed: int, index: int, partition: int | None = None) -> int:
    """The generator seed of writer ``index`` (of data partition
    ``partition``, in a partitioned fleet), where the reference folds the
    shard (and first the partition) into its key with ``fold_in``. Built on
    ``numpy.random.SeedSequence`` with the spawn key ``(index,)`` or
    ``(partition, index)``, so partition p's writer i and partition i's
    writer p draw apart. 63 bits: what ``torch.Generator.manual_seed``
    takes."""
    key = (int(index),) if partition is None else (int(partition), int(index))
    words = np.random.SeedSequence(int(seed), spawn_key=key).generate_state(2, np.uint32)
    return (int(words[0]) | (int(words[1]) << 32)) & (2 ** 63 - 1)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """The fleet's static shape.

    ``replicas``: read replicas a shard; ``shards``: independent writers a
    workload; ``mesh``: the writers' ensembles' ``shard=``: ``"auto"``
    keeps each workload's own setting (the workloads' ensembles keep
    ``ChainEnsemble``'s ``"auto"``, whose rule decides when their chains
    spread over cards), anything else (``False``, ``True``,
    a ``("chains", "data")`` tuple or a dict of axis sizes) replaces it, as
    in the reference (replicas only evaluate and never shard);
    ``transport``: ``"inproc"`` replicas share the process, ``"proc"``
    replicas each get an OS process; ``sync_interval_s``: pause between
    background refresh-and-broadcast rounds;
    ``replica_threads``: ``torch.set_num_threads`` in each replica
    process (None keeps torch's default); ``subposterior``: data partitions
    P a workload (P = 1 is the unpartitioned fleet, bit for bit);
    ``combine``: ``"consensus"`` or ``"product"``.
    """

    replicas: int = 2
    shards: int = 1
    serving: ServingConfig = ServingConfig()
    mesh: Any = "auto"
    transport: str = "inproc"  # "inproc" | "proc"
    sync_interval_s: float = 0.0
    replica_threads: int | None = 1
    subposterior: int = 1
    combine: str = "consensus"

    def __post_init__(self):
        if self.replicas < 1 or self.shards < 1:
            raise ValueError("replicas and shards must be >= 1")
        if self.transport not in ("inproc", "proc"):
            raise ValueError(f"unknown transport {self.transport!r}")
        if self.subposterior < 1:
            raise ValueError(f"subposterior must be >= 1, got {self.subposterior}")
        if self.combine not in COMBINE_METHODS:
            raise ValueError(f"unknown combine method {self.combine!r}; known: {COMBINE_METHODS}")


class FleetShard(NamedTuple):
    """One workload shard: a writer and its read replicas."""

    name: str  # "<workload>@<index>" or "<workload>@p<partition>@<index>"
    workload: str
    writer: ResidentEnsemble
    replicas: tuple
    partition: int = 0  # the data partition its writer samples


class Fleet:
    """Writers, replicas and delta streams behind one management surface."""

    def __init__(self, config: FleetConfig | None = None):
        self.config = config or FleetConfig()
        self.pool = EnsemblePool(self.config.serving)
        self._workloads: dict[str, ServingWorkload] = {}
        self._shards: dict[str, list[FleetShard]] = {}
        self._partitions: dict[str, int] = {}  # workload -> P
        self._data_sizes: dict[str, int] = {}  # workload -> total sections
        # What add_replica replays: the builder's keywords, and a name counter
        # a shard, so that a retired replica's name is never used again.
        self._build_kw: dict[str, dict] = {}
        self._replica_seq: dict[str, int] = {}
        self._sync_lock = threading.Lock()
        self.sync_stats = {
            "syncs": 0,
            "delta_wire_bytes": 0,
            "full_wire_bytes": 0,  # what streaming full snapshots would cost
            "delta_payload_bytes": 0,
            "full_payload_bytes": 0,
            "full_deltas": 0,  # syncs that were full-window resyncs
            "skipped_dead": 0,  # replicas skipped because their transport was down
        }
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # The last background refresh or broadcast error a shard (cleared on
        # the next success), shown in report().
        self._shard_errors: dict[str, str] = {}

    # -- registration ------------------------------------------------------

    def add_workload(self, name: str, **build_kw) -> list[FleetShard]:
        """Register ``shards`` writers and ``replicas`` replicas each for a
        registry workload; ``build_kw`` reaches its builder (every shard gets
        the same data; writer i is seeded ``shard_seed(seed, i)``).

        With ``subposterior = P > 1`` the workload's observation pool is
        partitioned first and each partition gets ``shards`` writers, named
        ``"<workload>@p<partition>@<index>"``. P = 1 is the unpartitioned
        fleet: the same names, seeds and targets.
        """
        if name in self._shards:
            raise ValueError(f"workload {name!r} already in this fleet")
        cfg = self.config
        scfg = cfg.serving
        build_kw.setdefault("num_chains", scfg.num_chains)
        build_kw.setdefault("seed", scfg.seed)
        build_kw.setdefault("device", scfg.device)
        base = build_serving_workload(name, **build_kw)
        self._workloads[name] = base
        self._build_kw[name] = dict(build_kw)
        if cfg.subposterior > 1:
            return self._add_partitioned(name, base, build_kw)
        shards: list[FleetShard] = []
        for i in range(cfg.shards):
            shard_name = f"{name}@{i}"  # "@": shard names are checkpoint file stems too
            ensemble = base.ensemble
            if cfg.mesh != "auto":
                ensemble = dataclasses.replace(ensemble, shard=cfg.mesh)
            shard_wl = dataclasses.replace(base, name=shard_name, ensemble=ensemble)
            writer = self.pool.add_workload(shard_wl, seed=shard_seed(scfg.seed, i))
            replicas = tuple(self._make_replica(f"{shard_name}#r{j}", name, build_kw)
                             for j in range(cfg.replicas))
            self._replica_seq[shard_name] = cfg.replicas
            shards.append(FleetShard(shard_name, name, writer, replicas))
        self._shards[name] = shards
        self._partitions[name] = 1
        if base.ensemble.target is not None:
            self._data_sizes[name] = int(base.ensemble.target.num_sections)
        return shards

    def _add_partitioned(self, name: str, base: ServingWorkload,
                         build_kw: dict) -> list[FleetShard]:
        """The subposterior fan-out: P tempered slice targets, each with its
        own writers. Raises ``ValueError`` for a workload whose target has no
        :class:`~repro_torch.core.target_builder.TargetSpec` (a composite
        transition, a compiled program)."""
        cfg = self.config
        scfg = cfg.serving
        num_p = cfg.subposterior
        if base.ensemble.target is None:
            raise ValueError(
                f"workload {name!r} runs a composite transition with no single target; "
                "subposterior partitioning needs a builder-constructed target")
        sub_targets = partition_target(base.ensemble.target, num_p)
        shards: list[FleetShard] = []
        for p in range(num_p):
            for i in range(cfg.shards):
                shard_name = f"{name}@p{p}@{i}"
                ensemble = dataclasses.replace(base.ensemble, target=sub_targets[p])
                if cfg.mesh != "auto":
                    ensemble = dataclasses.replace(ensemble, shard=cfg.mesh)
                shard_wl = dataclasses.replace(base, name=shard_name, ensemble=ensemble)
                writer = self.pool.add_workload(shard_wl, seed=shard_seed(scfg.seed, i, p))
                replicas = tuple(self._make_replica(f"{shard_name}#r{j}", name, build_kw)
                                 for j in range(cfg.replicas))
                self._replica_seq[shard_name] = cfg.replicas
                shards.append(FleetShard(shard_name, name, writer, replicas, p))
        self._shards[name] = shards
        self._partitions[name] = num_p
        self._data_sizes[name] = int(base.ensemble.target.num_sections)
        return shards

    def _make_replica(self, replica_name: str, workload: str, build_kw: dict):
        scfg = self.config.serving
        if self.config.transport == "proc":
            return ReplicaProcess(replica_name, workload, build_kw, micro_batch=scfg.micro_batch,
                                  threads=self.config.replica_threads)
        return ReplicaEnsemble(replica_name, micro_batch=scfg.micro_batch, device=scfg.device)

    # -- lookups -----------------------------------------------------------

    def workloads(self) -> tuple[str, ...]:
        return tuple(sorted(self._shards))

    def shards(self, workload: str) -> list[FleetShard]:
        return self._shards[workload]

    def workload(self, name: str) -> ServingWorkload:
        return self._workloads[name]

    def spec(self, workload: str, query_class: str) -> QuerySpec:
        return self._workloads[workload].query_specs[query_class]

    def num_partitions(self, workload: str) -> int:
        """Data partitions P of the workload (1 when unpartitioned)."""
        return self._partitions.get(workload, 1)

    def replica_count(self, workload: str) -> int:
        """Live replicas across the workload's shards."""
        return sum(len(s.replicas) for s in self._shards[workload])

    # -- runtime scaling ---------------------------------------------------

    def add_replica(self, workload: str, shard_index: int = 0):
        """One more read replica on a running shard, built as its siblings
        were (the shard's next unused ``#rN`` name); the shard entry is
        swapped for one that includes it and one :meth:`sync_shard` seeds it
        (a full window: it serves bit for bit the writer's on return). The
        background sync reads the shard anew every round. Returns ``(shard,
        replica)``; hand both to :meth:`FleetRouter.attach_lane`."""
        shards = self._shards[workload]
        shard = shards[shard_index]
        seq = self._replica_seq.get(shard.name, len(shard.replicas))
        self._replica_seq[shard.name] = seq + 1
        replica = self._make_replica(f"{shard.name}#r{seq}", workload,
                                     self._build_kw.get(workload, {}))
        new_shard = shard._replace(replicas=shard.replicas + (replica,))
        shards[shard_index] = new_shard
        self.sync_shard(new_shard)  # version 0 -> the full window
        return new_shard, replica

    def remove_replica(self, workload: str, replica_name: str | None = None):
        """Retire one replica: drop it from its shard's broadcast set, then
        close it. Detach its router lane first (:meth:`FleetRouter.detach_lane`).
        Without ``replica_name`` the first shard's newest goes. Each shard
        keeps at least one replica. Returns the retired replica's name."""
        shards = self._shards[workload]
        if replica_name is None:
            shard_index, shard = 0, shards[0]
            replica = shard.replicas[-1]
        else:
            for shard_index, shard in enumerate(shards):
                replica = next((r for r in shard.replicas if r.name == replica_name), None)
                if replica is not None:
                    break
            else:
                raise KeyError(f"no replica {replica_name!r} in workload {workload!r}")
        if len(shard.replicas) <= 1:
            raise ValueError(f"cannot remove the last replica of shard {shard.name!r}")
        remaining = tuple(r for r in shard.replicas if r is not replica)
        with self._sync_lock:  # never take a replica away mid-broadcast
            shards[shard_index] = shard._replace(replicas=remaining)
        self._shard_errors.pop(f"{shard.name}/{replica.name}", None)
        replica.close()
        return replica.name

    # -- streaming append --------------------------------------------------

    def append_observations(self, workload: str, new_data) -> int:
        """Fold an appended observation chunk into every running writer of
        ``workload``. Unpartitioned, every writer gets the whole chunk;
        partitioned, the rows go by :func:`partition_append_indices`, so
        each slice grows as a stride partition of the concatenated pool
        would. Writers that get rows read as stale
        (:meth:`ResidentEnsemble.append`). Returns the sections appended."""
        shards = self._shards[workload]
        num_p = self._partitions.get(workload, 1)
        leaves = tree_leaves(new_data)
        if not leaves:
            raise ValueError("empty append chunk (no array leaves)")
        n_new = int(leaves[0].shape[0])
        if n_new == 0:
            return 0
        if num_p == 1:
            for shard in shards:
                shard.writer.append(new_data)
        else:
            parts = partition_append_indices(self._data_sizes[workload], n_new, num_p)
            for shard in shards:
                idx = parts[shard.partition]
                if idx.shape[0]:
                    shard.writer.append(take_sections(new_data, idx))
        self._data_sizes[workload] = self._data_sizes.get(workload, 0) + n_new
        return n_new

    # -- delta streaming ---------------------------------------------------

    def sync_shard(self, shard: FleetShard) -> int:
        """Send the writer's snapshot to every replica as deltas; returns the
        wire bytes sent. Also counts what streaming the full window would
        have cost."""
        snap = shard.writer.snapshot()
        window = shard.writer.window
        sent = 0
        with self._sync_lock:
            for replica in shard.replicas:
                try:
                    delta = make_delta(snap, replica.version, window, shard.name)
                    nbytes = wire_bytes(delta)
                    try:
                        replica.apply_delta(delta, nbytes=nbytes)
                    except (ValueError, RuntimeError):
                        # Version drift (a reset raced the snapshot): resync in
                        # full. A process replica reports the worker's
                        # ValueError as RuntimeError; a broken replica raises
                        # again here and propagates.
                        delta = make_delta(snap, 0, window, shard.name)
                        nbytes = wire_bytes(delta)
                        replica.apply_delta(delta, nbytes=nbytes)
                except ReplicaDeadError as e:
                    # A crashed replica must not stall its healthy peers: skip
                    # it (the router routes round its lane) and keep the error
                    # in report() until a sync reaches it again.
                    self.sync_stats["skipped_dead"] += 1
                    self._shard_errors[f"{shard.name}/{replica.name}"] = \
                        f"{type(e).__name__}: {e}"
                    continue
                self._shard_errors.pop(f"{shard.name}/{replica.name}", None)
                delta_payload = payload_nbytes(delta.draws)
                if delta.full:
                    full_wire, full_payload = nbytes, delta_payload
                else:
                    # The full window's cost without pickling it each sync: the
                    # frame (name, summary, ints) is shared, so it is the
                    # delta's plus the payload's difference.
                    full_payload = payload_nbytes(snap.draws)
                    full_wire = nbytes + (full_payload - delta_payload)
                self.sync_stats["syncs"] += 1
                self.sync_stats["full_deltas"] += int(delta.full)
                self.sync_stats["delta_wire_bytes"] += nbytes
                self.sync_stats["delta_payload_bytes"] += delta_payload
                self.sync_stats["full_wire_bytes"] += full_wire
                self.sync_stats["full_payload_bytes"] += full_payload
                sent += nbytes
        return sent

    def sync_all(self) -> int:
        return sum(self.sync_shard(s) for shards in self._shards.values() for s in shards)

    def pump(self, workload: str | None = None) -> None:
        """One refresh and broadcast round on the calling thread (what tests
        and the smoke path drive; :meth:`start` runs the same on threads)."""
        names = [workload] if workload else list(self._shards)
        for name in names:
            for shard in self._shards[name]:
                shard.writer.refresh()
                self.sync_shard(shard)

    # -- lifecycle ---------------------------------------------------------

    def warm(self) -> None:
        """Bring every writer to a servable snapshot, then seed every replica
        with its first (full) delta."""
        self.pool.warm()
        self.sync_all()

    def start(self) -> None:
        """Background refresh and broadcast, one thread a shard."""
        if self._threads:
            return
        self._stop.clear()
        for name, shards in self._shards.items():
            for idx, shard in enumerate(shards):
                def loop(name=name, idx=idx):
                    while not self._stop.is_set():
                        # Read the shard entry anew every round: add_replica and
                        # remove_replica swap it for one with other replicas.
                        shard = self._shards[name][idx]
                        try:
                            shard.writer.refresh()
                            self.sync_shard(shard)
                            self._shard_errors.pop(shard.name, None)
                        except Exception as e:  # noqa: BLE001 - record, back off, retry
                            self._shard_errors[shard.name] = f"{type(e).__name__}: {e}"
                            self._stop.wait(0.5)
                            continue
                        if self.config.sync_interval_s:
                            self._stop.wait(self.config.sync_interval_s)

                t = threading.Thread(target=loop, name=f"fleet-{shard.name}", daemon=True)
                t.start()
                self._threads.append(t)

    def stop(self, timeout_s: float = 30.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout_s)
        self._threads = []

    def close(self) -> None:
        """Stop the background sync and close every replica."""
        self.stop()
        for shards in self._shards.values():
            for shard in shards:
                for replica in shard.replicas:
                    replica.close()

    # -- persistence -------------------------------------------------------

    def save(self, ckpt_dir: str, keep: int = 3) -> str:
        """Persist every writer (replicas are derived state: they resync)."""
        return self.pool.save(ckpt_dir, keep=keep)

    def restore(self, ckpt_dir: str, step: int | None = None) -> int:
        """Restore the writers warm, then resync every replica in full: the
        restored generators continue exactly, and the replicas mirror the
        restored windows."""
        step = self.pool.restore(ckpt_dir, step=step)
        for shards in self._shards.values():
            for shard in shards:
                for replica in shard.replicas:
                    replica.reset()
                self.sync_shard(shard)
        return step

    # -- reporting ---------------------------------------------------------

    def report(self) -> dict:
        out = {"sync": dict(self.sync_stats), "shards": {}, "errors": dict(self._shard_errors)}
        for name, shards in sorted(self._shards.items()):
            for shard in shards:
                out["shards"][shard.name] = {
                    "writer_steps": shard.writer.steps_done,
                    "replica_versions": [r.version for r in shard.replicas],
                    "replicas": [self._replica_stats(r) for r in shard.replicas],
                }
        return out

    @staticmethod
    def _replica_stats(replica) -> dict:
        try:
            return replica.stats()
        except ReplicaDeadError:
            return {"name": replica.name, "alive": False}
