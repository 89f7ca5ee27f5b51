"""The port's serving fleet (``repro_torch.fleet``), its request tracer
(``repro_torch.obs.trace``) and the fleet path of the front end, against
the JAX package's.

Snapshot deltas are host numpy on both sides and are held exactly: the same
windows and versions give the same payload arrays, flags and byte counts.
The fleet's own contracts are held as the reference holds them
(``tests/test_fleet.py``, ``tests/test_subposterior.py``): replicas mirror
their writers bit for bit, the router's batches are transparent, priorities
and admission shed the low classes first, replicas and lanes come and go
at runtime, and a checkpoint round trip continues the run exactly. Writers
are seeded by ``shard_seed`` where the reference folds keys, so the P = 1
fleet is held to a lone resident seeded alike. Everything runs on the CPU;
one process replica is spawned.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.fleet import delta as j_delta
from repro.fleet import router as j_router
from repro.obs import trace as j_trace
from repro.serving.resident import Snapshot as JSnapshot
from repro_torch.core import spec_of
from repro_torch.fleet import (AdmissionConfig, Fleet, FleetConfig, FleetRouter, ReplicaEnsemble,
                               SnapshotDelta, apply_delta, make_delta, payload_nbytes, shard_seed,
                               wire_bytes)
from repro_torch.launch import serve
from repro_torch.obs import trace
from repro_torch.partition import partition_append_indices, partition_indices, take_sections
from repro_torch.serving import FreshnessPolicy, ResidentEnsemble, ServingConfig
from repro_torch.serving.resident import Snapshot
from repro_torch.serving.workloads import build_serving_workload

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WL = dict(smoke=True, n_train=400, d=3, batch_size=50)
_PART_WL = dict(n_train=96, d=3, batch_size=32)


def _config(replicas=2, shards=1, subposterior=1, transport="inproc", window=16,
            refresh_steps=8, num_chains=2, **kw):
    return FleetConfig(
        replicas=replicas, shards=shards, subposterior=subposterior, transport=transport,
        serving=ServingConfig(num_chains=num_chains, refresh_steps=refresh_steps, window=window,
                              micro_batch=8, max_batch=4,
                              freshness=FreshnessPolicy(max_staleness_s=1e9,
                                                        min_draws=num_chains * 4),
                              seed=0, device="cpu"),
        **kw)


def _tiny_fleet(**kw) -> Fleet:
    fleet = Fleet(_config(**kw))
    fleet.add_workload("bayeslr", **_WL)
    return fleet


@pytest.fixture(scope="module")
def warm_fleet():
    fleet = _tiny_fleet()
    fleet.warm()
    yield fleet
    fleet.close()


def _rows(fleet, cls, seed, n):
    return fleet.spec("bayeslr", cls).make_queries(torch.Generator().manual_seed(seed), n)


# ---------------------------------------------------------------------------
# Delta algebra: exact against the reference
# ---------------------------------------------------------------------------


def _window(k, w, offset=0.0, tree=False):
    seq = np.arange(k * 80, dtype=np.float32).reshape(k, 80) + offset
    if tree:
        return lambda v: None if not v else {"phi": seq[:, max(v - w, 0):v],
                                             "h": np.stack([seq, -seq], -1)[:, max(v - w, 0):v]}
    return lambda v: None if not v else seq[:, max(v - w, 0):v]


def _both(draws, version, staleness=0.1):
    num = 0 if draws is None else 1
    return (Snapshot(draws, num, version, staleness, {"a": 1.0}, 0.0),
            JSnapshot(draws, num, version, staleness, {"a": 1.0}, 0.0))


def _same_tree(got, want):
    if want is None:
        assert got is None
        return
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
            assert got[key].dtype == np.asarray(want[key]).dtype
        return
    np.testing.assert_array_equal(got, np.asarray(want))


# (chains K, window, replica version, writer advance): cold, still filling,
# incremental, gap past the window, a replica ahead of the writer (a
# restore), zero gap
_DELTA_CASES = [(2, 6, 0, 8), (2, 6, 5, 3), (3, 12, 20, 5), (1, 4, 2, 18), (2, 4, 30, -10),
                (4, 8, 7, 0), (2, 8, 9, 7)]


@pytest.mark.parametrize("tree", [False, True], ids=["array", "dict"])
@pytest.mark.parametrize("k,window,base,advance", _DELTA_CASES)
def test_make_and_apply_delta_equal_reference(k, window, base, advance, tree):
    version = base + advance
    win_at = _window(k, window, tree=tree)
    snap, jsnap = _both(win_at(version), version)
    got, want = make_delta(snap, base, window, "w"), j_delta.make_delta(jsnap, base, window, "w")
    for field in ("name", "base_version", "version", "window", "summary", "staleness_s", "full"):
        assert getattr(got, field) == getattr(want, field)
    _same_tree(got.draws, want.draws)
    assert payload_nbytes(got.draws) == j_delta.payload_nbytes(want.draws)
    assert wire_bytes(got) >= payload_nbytes(got.draws)
    applied = apply_delta(win_at(base), got)
    _same_tree(applied, j_delta.apply_delta(win_at(base), want))
    _same_tree(applied, win_at(version))  # the writer's window, bit for bit


def test_replica_rejects_mismatched_incremental_and_window_rpc_is_version_gated():
    replica = ReplicaEnsemble("w0#r0", micro_batch=4, device="cpu")
    version, snap = replica.window()
    assert version == 0 and snap.draws is None
    source = Snapshot(np.random.default_rng(0).normal(size=(2, 4, 3)), 8, 16, 0.1, {}, 0.0)
    replica.apply_delta(make_delta(source, 0, 4, "w0"))
    version, snap = replica.window(-1)
    assert version == 16 and snap is not None
    np.testing.assert_array_equal(snap.draws, source.draws)
    assert replica.window(16) == (16, None)  # the caller is current
    bad = SnapshotDelta("", base_version=99, version=101, draws=np.ones((2, 2), np.float32),
                        window=4, summary={}, staleness_s=0.0, full=False)
    with pytest.raises(ValueError, match="full resync required"):
        replica.apply_delta(bad)
    stale = make_delta(source, 0, 4)._replace(staleness_s=1.5)
    fresh = ReplicaEnsemble("r", device="cpu")
    assert fresh.snapshot().staleness_s == float("inf")
    fresh.apply_delta(stale)
    assert fresh.snapshot().staleness_s >= 1.5  # never younger than the writer's stamp


# ---------------------------------------------------------------------------
# Writers, seeds and partitions
# ---------------------------------------------------------------------------


def test_shard_seed_is_deterministic_and_partitions_never_collide():
    assert shard_seed(0, 3) == shard_seed(0, 3) and 0 <= shard_seed(0, 3) < 2 ** 63
    seeds = {("p", p, i): shard_seed(0, i, p) for p in range(6) for i in range(6)}
    seeds.update({("i", None, i): shard_seed(0, i) for i in range(6)})
    assert len(set(seeds.values())) == len(seeds)  # (p, i) != (i, p), != unpartitioned
    assert shard_seed(1, 0) != shard_seed(0, 0)


def test_p1_fleet_equals_a_lone_resident_bit_for_bit():
    """P = 1 is the unpartitioned path: shard 0's writer equals a lone
    resident over the same workload seeded ``shard_seed(0, 0)``."""
    scfg = _config(replicas=1).serving
    fleet = Fleet(_config(replicas=1))
    (shard,) = fleet.add_workload("bayeslr", **_PART_WL)
    assert shard.name == "bayeslr@0" and shard.partition == 0
    assert fleet.num_partitions("bayeslr") == 1
    wl = build_serving_workload("bayeslr", num_chains=2, seed=0, device="cpu", **_PART_WL)
    lone = ResidentEnsemble(wl.ensemble, wl.theta0, seed=shard_seed(0, 0), window=scfg.window,
                            refresh_steps=scfg.refresh_steps, micro_batch=scfg.micro_batch)
    for _ in range(3):
        shard.writer.refresh()
        lone.refresh()
    np.testing.assert_array_equal(shard.writer.snapshot().draws, lone.snapshot().draws)
    assert torch.equal(shard.writer.state.theta, lone.state.theta)
    fleet.close()


def test_two_shards_have_independent_chains():
    fleet = _tiny_fleet(shards=2)
    fleet.warm()
    s0, s1 = fleet.shards("bayeslr")
    assert s0.writer.snapshot().draws.shape == s1.writer.snapshot().draws.shape
    assert not np.array_equal(s0.writer.snapshot().draws, s1.writer.snapshot().draws)
    fleet.close()


def test_p2_partitions_data_and_seeds():
    fleet = Fleet(_config(replicas=1, subposterior=2))
    shards = fleet.add_workload("bayeslr", **_PART_WL)
    assert [s.name for s in shards] == ["bayeslr@p0@0", "bayeslr@p1@0"]
    assert [s.partition for s in shards] == [0, 1]
    assert sum(s.writer.ensemble.target.num_sections for s in shards) == _PART_WL["n_train"]
    assert all(spec_of(s.writer.ensemble.target).prior_scale == pytest.approx(0.5)
               for s in shards)
    fleet.pump("bayeslr")
    a, b = (s.writer.snapshot().draws for s in shards)
    assert not np.array_equal(a, b)
    fleet.close()


def test_p2_combined_serving_is_deterministic():
    """Combine-at-query: finite answers, equal on a repeat against unchanged
    windows, the partitions' largest staleness; still served after a pump.
    ``warm_combined`` answers as a request does and is not counted in
    ``combined_served``; ``combined_snapshot`` is the window served."""
    fleet = Fleet(_config(replicas=2, subposterior=2, combine="consensus"))
    fleet.add_workload("bayeslr", **_PART_WL)
    fleet.warm()
    router = FleetRouter(fleet)
    xs = _rows(fleet, "predictive", 5, 8)
    warm = router.warm_combined("bayeslr", "predictive", xs)
    assert router.combined_served("bayeslr") == {"batches": 0, "rows": 0}
    snap = router.combined_snapshot("bayeslr")
    assert snap.steps_done == sum(s.writer.steps_done for s in fleet.shards("bayeslr"))

    def ask():
        req = router.submit("bayeslr", "predictive", xs)
        router.drain()
        assert req.error is None, req.error
        return np.asarray(req.values), req.staleness_s

    v1, stale1 = ask()
    v2, _ = ask()
    assert v1.shape == (8,) and np.all(np.isfinite(v1)) and stale1 >= 0.0
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(warm, v1)
    assert router.combined_served("bayeslr") == {"batches": 2, "rows": 16}
    assert router.combined_snapshot("bayeslr") is snap  # unchanged windows: the cached one
    fleet.pump("bayeslr")
    assert np.all(np.isfinite(ask()[0]))
    fleet.close()


def test_append_routes_rows_to_partitions():
    fleet = Fleet(_config(replicas=1, subposterior=2))
    shards = fleet.add_workload("bayeslr", **_PART_WL)
    n = _PART_WL["n_train"]
    before = [s.writer.ensemble.target.num_sections for s in shards]
    data = spec_of(fleet.workload("bayeslr").ensemble.target).data
    idx = np.random.default_rng(0).integers(0, n, size=7)
    chunk = tuple(a.numpy()[idx] for a in data)
    assert fleet.append_observations("bayeslr", chunk) == 7
    grown = [s.writer.ensemble.target.num_sections - b for s, b in zip(shards, before)]
    assert grown == [len(p) for p in partition_append_indices(n, 7, 2)]
    merged = tuple(np.concatenate([a.numpy(), c]) for a, c in zip(data, chunk))
    for shard in shards:
        want = take_sections(merged, partition_indices(n + 7, 2)[shard.partition])
        for g, w in zip(spec_of(shard.writer.ensemble.target).data, want):
            np.testing.assert_array_equal(g.numpy(), w)
        assert shard.writer.snapshot().staleness_s == float("inf")
    fleet.close()


@pytest.mark.parametrize("workload", ["stochvol", "ppl"])
def test_subposterior_refuses_targets_without_a_recipe(workload):
    """stochvol runs a composite cycle; a compiled program passes
    ``log_global``: neither carries a TargetSpec, as in the reference."""
    fleet = Fleet(_config(replicas=1, subposterior=2))
    with pytest.raises(ValueError):
        fleet.add_workload(workload, smoke=True)


# ---------------------------------------------------------------------------
# Replicas mirror writers
# ---------------------------------------------------------------------------


def test_replica_mirrors_and_serves_as_its_writer(warm_fleet):
    fleet = warm_fleet
    for _ in range(3):
        fleet.pump("bayeslr")
    spec = fleet.spec("bayeslr", "predictive")
    xs = _rows(fleet, "predictive", 3, 8)
    for shard in fleet.shards("bayeslr"):
        wsnap = shard.writer.snapshot()
        want, _ = shard.writer.query(spec, xs)
        for replica in shard.replicas:
            assert replica.snapshot().steps_done == wsnap.steps_done
            np.testing.assert_array_equal(replica.snapshot().draws, wsnap.draws)
            got, staleness = replica.serve(spec, "predictive", xs)
            np.testing.assert_array_equal(got, want)
            assert np.isfinite(staleness)
    stats = fleet.sync_stats
    assert stats["delta_wire_bytes"] < stats["full_wire_bytes"]
    assert stats["delta_payload_bytes"] < stats["full_payload_bytes"]


# ---------------------------------------------------------------------------
# Router: transparency, load, priority, admission
# ---------------------------------------------------------------------------


def test_router_batch_result_transparent_and_spreads_load(warm_fleet):
    fleet = warm_fleet
    fleet.sync_all()
    router = FleetRouter(fleet, max_batch=4, default_deadline_s=30.0)
    spec = fleet.spec("bayeslr", "predictive")
    xs_list = [_rows(fleet, "predictive", i, 3) for i in range(8)]
    reqs = [router.submit("bayeslr", "predictive", xs) for xs in xs_list]
    depths = [len(lane.pending) for lane in router._lanes["bayeslr"]]
    assert max(depths) - min(depths) <= 1  # least-loaded placement
    router.drain()
    shard = fleet.shards("bayeslr")[0]
    for req, xs in zip(reqs, xs_list):
        np.testing.assert_array_equal(req.result(1.0), shard.writer.query(spec, xs)[0])
    report = router.slo_report()
    assert report["classes"]["bayeslr.predictive"]["admitted"] == 8
    assert report["shed"] == 0 and report["errors"] == 0


def test_router_serves_high_priority_first(warm_fleet):
    fleet = warm_fleet
    router = FleetRouter(fleet, priorities={"predictive": 2, "vote": 0}, max_batch=8,
                         default_deadline_s=30.0)
    low = [router.submit("bayeslr", "vote", _rows(fleet, "vote", i, 2)) for i in range(3)]
    high = [router.submit("bayeslr", "predictive", _rows(fleet, "predictive", 10 + i, 2))
            for i in range(3)]
    served = router.drain()
    assert all(r.query_class == "predictive" for r in served[:len(high)])
    assert all(r.done.is_set() for r in low + high)


def test_admission_sheds_the_lowest_class_first(warm_fleet):
    fleet = warm_fleet
    router = FleetRouter(fleet, priorities={"predictive": 1, "vote": 0},
                         admission=AdmissionConfig(max_depth=6, min_observations=10 ** 9),
                         max_batch=4, default_deadline_s=30.0)
    reqs = [router.submit("bayeslr", "predictive" if i % 2 else "vote",
                          _rows(fleet, "predictive", i, 2)) for i in range(24)]
    router.drain()
    report = router.slo_report()
    assert report["classes"]["bayeslr.vote"]["shed"] > 0
    assert report["classes"]["bayeslr.predictive"]["shed"] == 0
    assert report["shed"] == report["classes"]["bayeslr.vote"]["shed"]
    shed = next(r for r in reqs if (r.error or "").startswith("shed"))
    with pytest.raises(RuntimeError, match="shed"):
        shed.result(timeout_s=1.0)


def test_admission_trips_on_predicted_miss_rate(warm_fleet):
    fleet = warm_fleet
    router = FleetRouter(fleet, priorities={"predictive": 1, "vote": 0},
                         admission=AdmissionConfig(max_depth=10 ** 6, max_miss_rate=0.5,
                                                   miss_window=8, min_observations=4),
                         max_batch=4, default_deadline_s=30.0)
    for i in range(6):  # deadline 0: every completion misses
        router.submit("bayeslr", "predictive", _rows(fleet, "predictive", i, 2), deadline_s=0.0)
    router.drain()
    assert router.predicted_miss_rate() > 0.5
    low = router.submit("bayeslr", "vote", _rows(fleet, "vote", 99, 2))
    high = router.submit("bayeslr", "predictive", _rows(fleet, "predictive", 100, 2))
    assert (low.error or "").startswith("shed") and high.error is None
    router.drain()
    report = router.slo_report()
    assert report["admission"]["shed_floor"] == 1
    assert report["classes"]["bayeslr.vote"]["shed"] == 1
    equal = FleetRouter(fleet, priorities={"predictive": 0, "vote": 0},
                        admission=AdmissionConfig(max_depth=2, min_observations=10 ** 9))
    for i in range(10):  # one priority level: nothing lower to shed
        equal.submit("bayeslr", "predictive", _rows(fleet, "predictive", i, 2))
    equal.drain()
    assert equal.slo_report()["shed"] == 0


def test_admission_floor_steps_at_max_depth_multiples(warm_fleet):
    fleet = warm_fleet
    depth = 4
    router = FleetRouter(fleet, priorities={"predictive": 2, "vote": 1, "bulk": 0},
                         admission=AdmissionConfig(max_depth=depth, min_observations=10 ** 9),
                         max_batch=4, default_deadline_s=30.0)
    qs = lambda i: _rows(fleet, "predictive", i, 2)
    assert router.slo_report()["admission"]["shed_floor"] is None
    assert router.submit("bayeslr", "bulk", qs(0)).error is None
    floors = {}
    for i in range(1, 2 * depth + 1):
        router.submit("bayeslr", "predictive", qs(i))
        floors[router.pending_count] = router.slo_report()["admission"]["shed_floor"]
    assert floors[depth - 1] is None and floors[depth] == 1 and floors[2 * depth] == 2
    low = router.submit("bayeslr", "bulk", qs(100))
    mid = router.submit("bayeslr", "vote", qs(101))
    top = router.submit("bayeslr", "predictive", qs(102))
    assert (low.error or "").startswith("shed") and (mid.error or "").startswith("shed")
    assert top.error is None
    router.drain()  # the bulk request admitted first fails at serve time (no such class)
    report = router.slo_report()
    assert report["admission"]["shed_floor"] is None
    assert report["classes"]["bayeslr.bulk"]["shed"] == 1
    assert report["classes"]["bayeslr.vote"]["shed"] == 1
    assert report["classes"]["bayeslr.predictive"]["shed"] == 0
    assert router.submit("bayeslr", "vote", qs(103)).error is None


def _router_script(seed, n=48):
    """A seeded sequence of submissions (class, rows, deadline 30 s or 0 s:
    a sure miss) with drains between; ``bulk`` is a class the workload does
    not answer, so its batches fail at serve time."""
    rng = np.random.default_rng(seed)
    script = []
    for _ in range(n):
        if rng.random() < 0.2:
            script.append(("drain",))
        cls = str(rng.choice(["predictive", "vote", "bulk"], p=[0.4, 0.35, 0.25]))
        script.append(("submit", cls, int(rng.integers(1, 4)),
                       float(rng.choice([30.0, 0.0], p=[0.7, 0.3]))))
    return script + [("drain",)]


def _drive_router(router, script, rows):
    """Run ``script`` through ``router``: for each submission its shed
    error, the lane it landed on and the admission state after it; for each
    drain the order it served in (as submission indices); then every
    request's outcome and the lanes' served counts."""
    reqs, log, index = [], [], {}
    lanes = router._lanes["bayeslr"]
    for step in script:
        if step[0] == "drain":
            log.append(("drain", [index[id(r)] for r in router.drain()]))
            continue
        _, cls, _, deadline = step
        req = router.submit("bayeslr", cls, rows[len(reqs)], deadline_s=deadline)
        index[id(req)] = len(reqs)
        reqs.append(req)
        lane = next((j for j, l in enumerate(lanes) if any(r is req for r in l.pending)), None)
        log.append(("submit", req.error, lane, router.pending_count,
                    router.predicted_miss_rate()))
    outcomes = [(r.done.is_set(), r.error, r.deadline_met, r.batch_size) for r in reqs]
    return log, outcomes, [r.values for r in reqs], [l.served for l in lanes]


def _slo_counts(report):
    """A router's SLO report without the host's clock in it (latencies and
    staleness)."""
    keep = ("count", "errors", "admitted", "shed", "priority", "deadline_hit_rate",
            "mean_batch_size")
    return ({k: report[k] for k in ("count", "errors", "shed", "admission", "recovery")},
            {c: {k: e[k] for k in keep} for c, e in report["classes"].items()})


_ADMISSIONS = {
    "depth": dict(max_depth=3, min_observations=10 ** 9),
    "miss": dict(max_depth=10 ** 6, max_miss_rate=0.25, miss_window=6, min_observations=3),
    "both": dict(max_depth=4, max_miss_rate=0.5, miss_window=12, min_observations=6),
}
# three priority levels, or two with vote tied to predictive (the batch's
# class is then the oldest request's)
_PRIORITIES = {"distinct": {"predictive": 2, "vote": 1, "bulk": 0},
               "tied": {"predictive": 1, "vote": 1, "bulk": 0}}


@pytest.mark.parametrize("admission,priorities,lanes,seed", [
    ("depth", "distinct", 2, 0), ("depth", "tied", 3, 1), ("miss", "distinct", 3, 0),
    ("miss", "tied", 2, 1), ("both", "distinct", 2, 1), ("both", "tied", 3, 0)])
def test_router_decides_as_the_reference_router(warm_fleet, admission, priorities, lanes, seed):
    """The port's router and the reference's, on the same warm fleet (two
    replica lanes, or three) and the same seeded submissions (sure misses, a
    class that fails at serve time, drains between): the same shed
    decisions and admission state after every submission, the same lane for
    every request, the same drain order, outcomes and values, and the same
    SLO counters. The fleet is numpy-facing, so the reference router drives
    the port's replicas as they are."""
    fleet = warm_fleet
    added = fleet.add_replica("bayeslr")[1] if lanes == 3 else None
    try:
        fleet.sync_all()
        script = _router_script(seed)
        rows = [np.asarray(_rows(fleet, "predictive", 1000 * seed + i, step[2]))
                for i, step in enumerate(s for s in script if s[0] == "submit")]
        kw = dict(priorities=_PRIORITIES[priorities], max_batch=4, default_deadline_s=30.0)
        ours = FleetRouter(fleet, admission=AdmissionConfig(**_ADMISSIONS[admission]), **kw)
        theirs = j_router.FleetRouter(
            fleet, admission=j_router.AdmissionConfig(**_ADMISSIONS[admission]), **kw)
        got, want = _drive_router(ours, script, rows), _drive_router(theirs, script, rows)
    finally:
        if added is not None:
            fleet.remove_replica("bayeslr", replica_name=added.name)
    assert got[0] == want[0]  # shed decisions, lanes, admission state, drain order
    assert got[1] == want[1]  # outcomes
    for a, b in zip(got[2], want[2]):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    assert got[3] == want[3] and len(got[3]) == lanes  # requests served a lane
    assert _slo_counts(ours.slo_report()) == _slo_counts(theirs.slo_report())
    shed = sum(e is not None and e.startswith("shed") for _, e, *_ in got[1])
    assert shed > 0 and any(b for _, _, b, _ in got[1])  # the script sheds and serves


def test_router_workers_serve_mixed_classes(warm_fleet):
    fleet = warm_fleet
    fleet.sync_all()
    router = FleetRouter(fleet, priorities={"predictive": 1, "vote": 0}, max_batch=4,
                         default_deadline_s=30.0)
    shard = fleet.shards("bayeslr")[0]
    router.start_workers(max_wait_s=0.001)
    try:
        reqs = []
        for i in range(16):
            cls = "predictive" if i % 2 else "vote"
            xs = _rows(fleet, cls, i, 3)
            reqs.append((cls, xs, router.submit("bayeslr", cls, xs)))
        for cls, xs, req in reqs:
            want, _ = shard.writer.query(fleet.spec("bayeslr", cls), xs)
            np.testing.assert_array_equal(req.result(timeout_s=30.0), want)
    finally:
        router.stop_workers()


def test_router_tracer_spans_match_the_reference_taxonomy(warm_fleet):
    """A traced request through the router: the span names, stages and tree
    of the reference router (request > queue_wait, assembly, replica_serve >
    device_eval), and the Chrome export equal to the reference's on the
    same spans."""
    fleet = warm_fleet
    tracer = trace.Tracer()
    router = FleetRouter(fleet, max_batch=4, tracer=tracer)
    req = router.submit("bayeslr", "predictive", _rows(fleet, "predictive", 1, 3))
    router.drain()
    spans = tracer.trace(req.trace_id)
    by_id = {s["span_id"]: s for s in spans}
    tree = sorted((s["stage"], by_id[s["parent_id"]]["stage"] if s["parent_id"] else None)
                  for s in spans)
    assert tree == [("assembly", "request"), ("device_eval", "replica_serve"),
                    ("queue_wait", "request"), ("replica_serve", "request"), ("request", None)]
    assert set(s["stage"] for s in spans) <= set(trace.STAGES) == set(j_trace.STAGES)
    assert trace.chrome_trace_events(spans) == j_trace.chrome_trace_events(spans)


# ---------------------------------------------------------------------------
# Runtime scaling and persistence
# ---------------------------------------------------------------------------


def test_add_and_remove_replica():
    fleet = _tiny_fleet()
    fleet.warm()
    try:
        before = fleet.shards("bayeslr")[0]
        shard, replica = fleet.add_replica("bayeslr")
        assert fleet.replica_count("bayeslr") == 3 and fleet.shards("bayeslr")[0] is shard
        assert shard.replicas[:-1] == before.replicas and replica.name == f"{shard.name}#r2"
        assert replica.version == shard.writer.steps_done  # seeded with the full window
        spec, xs = fleet.spec("bayeslr", "predictive"), _rows(fleet, "predictive", 0, 8)
        np.testing.assert_array_equal(replica.serve(spec, "predictive", xs)[0],
                                      shard.writer.query(spec, xs)[0])
        assert fleet.remove_replica("bayeslr", replica_name=replica.name) == replica.name
        _, again = fleet.add_replica("bayeslr")
        assert again.name == f"{shard.name}#r3"  # a name is never used again
        with pytest.raises(KeyError):
            fleet.remove_replica("bayeslr", replica_name=replica.name)
        newest = fleet.shards("bayeslr")[0].replicas[-1].name
        assert fleet.remove_replica("bayeslr") == newest
        fleet.remove_replica("bayeslr")
        assert fleet.replica_count("bayeslr") == 1
        with pytest.raises(ValueError, match="last replica"):
            fleet.remove_replica("bayeslr")
    finally:
        fleet.close()


def test_attach_lane_serves_and_detach_reroutes_cleanly():
    fleet = _tiny_fleet(replicas=1)
    fleet.warm()
    try:
        spec = fleet.spec("bayeslr", "predictive")
        router = FleetRouter(fleet, priorities={"predictive": 0}, max_batch=4,
                             default_deadline_s=30.0)
        shard, replica = fleet.add_replica("bayeslr")
        router.attach_lane(shard, replica)
        reqs = [(xs, router.submit("bayeslr", "predictive", xs))
                for xs in (_rows(fleet, "predictive", i, 2) for i in range(12))]
        router.drain()
        for xs, req in reqs:
            np.testing.assert_array_equal(req.result(), shard.writer.query(spec, xs)[0])
        assert len(router._lanes["bayeslr"]) == 2
        assert all(lane.served > 0 for lane in router._lanes["bayeslr"])
        tail = [(xs, router.submit("bayeslr", "predictive", xs))
                for xs in (_rows(fleet, "predictive", 100 + i, 2) for i in range(6))]
        assert router.detach_lane("bayeslr", replica.name) is True
        fleet.remove_replica("bayeslr", replica_name=replica.name)
        router.drain()
        for xs, req in tail:
            np.testing.assert_array_equal(req.result(), shard.writer.query(spec, xs)[0])
        assert router.slo_report()["errors"] == 0
    finally:
        fleet.close()


def test_dead_lane_reroutes_and_revives(warm_fleet):
    fleet = warm_fleet
    fleet.sync_all()
    router = FleetRouter(fleet, max_batch=4, default_deadline_s=30.0)
    shard = fleet.shards("bayeslr")[0]
    victim = shard.replicas[1]
    victim.kill()
    try:
        reqs = [router.submit("bayeslr", "predictive", _rows(fleet, "predictive", i, 2))
                for i in range(6)]
        router.drain()
        assert all(r.error is None for r in reqs) and router.dead_lanes == 1
        assert router.slo_report()["recovery"]["lane_deaths"] == 1
    finally:
        victim.restart()
    fleet.sync_shard(shard)
    assert router.revive() == 1 and router.dead_lanes == 0


def test_checkpoint_round_trip_continues_the_run(tmp_path):
    fleet1 = _tiny_fleet()
    fleet1.warm()
    fleet1.save(str(tmp_path))
    fleet2 = _tiny_fleet()
    step = fleet2.restore(str(tmp_path))
    s1, s2 = fleet1.shards("bayeslr")[0], fleet2.shards("bayeslr")[0]
    assert step == s1.writer.steps_done == s2.writer.steps_done
    np.testing.assert_array_equal(s1.replicas[0].snapshot().draws,
                                  s2.replicas[0].snapshot().draws)
    fleet1.pump("bayeslr")
    fleet2.pump("bayeslr")
    np.testing.assert_array_equal(s1.writer.snapshot().draws, s2.writer.snapshot().draws)
    for r1, r2 in zip(s1.replicas, s2.replicas):
        np.testing.assert_array_equal(r1.snapshot().draws, r2.snapshot().draws)
        np.testing.assert_array_equal(r2.snapshot().draws, s2.writer.snapshot().draws)


def test_fleet_config_validation():
    with pytest.raises(ValueError, match="replicas and shards"):
        FleetConfig(replicas=0)
    with pytest.raises(ValueError, match="unknown transport"):
        FleetConfig(transport="carrier-pigeon")
    with pytest.raises(ValueError, match="combine"):
        FleetConfig(combine="median")
    with pytest.raises(NotImplementedError, match="distributed slice"):
        FleetConfig(mesh=("chains", "data"))
    with pytest.raises(ValueError, match="max_depth"):
        AdmissionConfig(max_depth=0)
    with pytest.raises(ValueError, match="max_miss_rate"):
        AdmissionConfig(max_miss_rate=0.0)
    fleet = Fleet(_config(replicas=1, mesh=False))
    (shard,) = fleet.add_workload("bayeslr", **_PART_WL)
    assert shard.writer.ensemble.shard is False


# ---------------------------------------------------------------------------
# The process transport and the front end
# ---------------------------------------------------------------------------

_PROC_SCRIPT = r"""
import json
import numpy as np, torch
from repro_torch.fleet import Fleet, FleetConfig
from repro_torch.serving import FreshnessPolicy, ServingConfig

def main():
    cfg = FleetConfig(replicas=1, transport="proc", serving=ServingConfig(
        num_chains=2, refresh_steps=8, window=16, micro_batch=8, seed=0, device="cpu",
        freshness=FreshnessPolicy(max_staleness_s=1e9, min_draws=8)))
    fleet = Fleet(cfg)
    fleet.add_workload("bayeslr", smoke=True, n_train=400, d=3, batch_size=50)
    fleet.warm()
    fleet.pump()
    shard = fleet.shards("bayeslr")[0]
    spec = fleet.spec("bayeslr", "predictive")
    xs = spec.make_queries(torch.Generator().manual_seed(9), 8)
    want, _ = shard.writer.query(spec, xs)
    got, _ = shard.replicas[0].serve(spec, "predictive", xs)
    version, snap = shard.replicas[0].window()
    stats = shard.replicas[0].stats()
    pid = shard.replicas[0]._proc.pid
    fleet.close()
    print(json.dumps({"equal": bool(np.array_equal(want, got)),
                      "window_equal": bool(np.array_equal(snap.draws,
                                                          shard.writer.snapshot().draws)),
                      "deltas_applied": stats["deltas_applied"],
                      "bytes_received": stats["bytes_received"], "start_s": stats["start_s"],
                      "other_pid": pid != __import__("os").getpid()}))

if __name__ == "__main__":
    main()
"""


def test_process_replica_serves_as_its_writer():
    """A spawned replica, fed only pickled deltas over its pipe, serves bit
    for bit what its writer serves."""
    env = dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _PROC_SCRIPT], capture_output=True, text=True,
                         env=env, cwd=_REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["equal"] and res["window_equal"] and res["other_pid"]
    assert res["deltas_applied"] >= 2 and res["bytes_received"] > 0 and res["start_s"] > 0


@pytest.mark.parametrize("argv,lines", [
    (["--fleet", "--smoke"], ["SERVE_OK workload=bayeslr fleet=1 shards=1 replicas=2 queries=120"]),
    (["--subposterior", "2", "--stream", "--smoke"],
     ["STREAM_OK appended=125 rows mid-serve; 2/2 writer(s) marked stale",
      "SERVE_OK workload=bayeslr fleet=1 shards=1 replicas=2 queries=120"]),
    (["--fleet", "--smoke", "--background"],
     ["background refresh:", "SERVE_OK workload=bayeslr fleet=1 shards=1 replicas=2 queries=120"]),
])
def test_serve_front_end_fleet_smoke(argv, lines, capsys):
    assert serve.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in lines:
        assert line in out
    last = out.strip().splitlines()[-1]
    assert last.startswith("SERVE_OK") and "parity=ok(bitexact)" in last
    assert f"subposterior={1 if '--fleet' in argv else 2}" in last
    if "--stream" in argv:
        assert last.endswith("stream_rows=125")


@pytest.mark.parametrize("argv,where", [
    (["--fleet", "--mesh", "2d"], "distributed slice"),
    (["--fleet", "--devices", "4"], "distributed slice"),
    (["--fleet", "--autoscale"], "observability slice"),
    (["--fleet", "--soak"], "observability slice"),
    (["--fleet", "--stats-addr", "127.0.0.1:0"], "observability slice"),
    (["--fleet", "--obs-dir", "x"], "observability slice"),
    (["--fleet", "--alerts"], "observability slice"),
    (["--subposterior", "2", "--trace-dir", "x"], "observability slice"),
])
def test_fleet_flags_of_later_slices_raise(argv, where, monkeypatch):
    if where == "observability slice":
        # the observability slice has come: each of its flags now reaches the
        # fleet's serve path (the soak's, with --soak) instead of raising
        seen = []
        monkeypatch.setattr(serve, "serve_fleet", lambda args: seen.append("fleet") or 0)
        monkeypatch.setattr(serve, "serve_soak", lambda args: seen.append("soak") or 0)
        assert serve.main(argv + ["--device", "cpu"]) == 0
        assert seen == ["soak" if "--soak" in argv else "fleet"]
        return
    with pytest.raises(NotImplementedError, match=where):
        serve.main(argv + ["--device", "cpu"])
