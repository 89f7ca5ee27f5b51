"""The port's posterior serving (``repro_torch.serving`` and the front end
``repro_torch.launch.serve``) against the JAX package's.

The same numpy windows and request rows go through the reference's and the
port's ``SnapshotEvaluator`` for every request class of the four workloads;
the freshness gates, the SLO and EWMA helpers are held value for value on
the same inputs. Refreshes resume by carrying the resident's generator, so
chunked refreshes are held bit for bit to one offline run of the port's own
ensemble where chunking does not move the draws, and in distribution where
it does (masked stepping with Fisher–Yates). The served posterior itself is
random on both sides and is held by a Monte Carlo bound. Everything runs on
the CPU: the port's wrappers take their plain PyTorch versions there.
"""
import dataclasses
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as j_ckpt
from repro.core import stats as j_stats
from repro.experiments import bayeslr as j_bayeslr
from repro.inference.niw import ClusterStats as JClusterStats
from repro.serving import EnsemblePool as JPool
from repro.serving import FreshnessPolicy as JFreshness
from repro.serving import ResidentEnsemble as JResident
from repro.serving import ServingConfig as JConfig
from repro.serving import build_serving_workload as j_build
from repro.serving import queue as j_queue
from repro.serving import snapshot_ess as j_ess
from repro.serving import snapshot_rhat as j_rhat
from repro.serving.resident import Snapshot as JSnapshot
from repro.serving.resident import SnapshotEvaluator as JEvaluator
from repro_torch import convert
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import (ChainEnsemble, RandomWalk, ScheduleConfig, SubsampledMHConfig,
                              from_iid_loglik, multichain_ess)
from repro_torch.core import stats
from repro_torch.experiments import bayeslr
from repro_torch.inference.niw import ClusterStats
from repro_torch.launch import serve
from repro_torch.serving import (EnsemblePool, FreshnessPolicy, RequestQueue, ResidentEnsemble,
                                 ServingConfig, build_serving_workload, serving_workloads,
                                 snapshot_ess, snapshot_rhat)
from repro_torch.serving import queue as p_queue
from repro_torch.serving.resident import Snapshot, SnapshotEvaluator, quantile_per_row

torch.set_num_threads(1)

# (workload, request class, relative tolerance against the reference: fp32
# sums in another order; the 0/1 vote and the cluster count are means of
# exact per-draw values, so only the mean's rounding differs)
CLASSES = [("bayeslr", "predictive", 1e-5), ("bayeslr", "vote", 1e-6),
           ("ppl", "predictive", 1e-5), ("ppl", "wnorm_quantile", 1e-5),
           ("stochvol", "vol_quantile", 1e-5), ("stochvol", "phi_mean", 1e-5),
           # lgamma terms held to 1e-4 in test_torch_jointdpm.py
           ("jointdpm", "cluster_predictive", 1e-4), ("jointdpm", "k_active", 1e-6)]
SMALL = {"bayeslr": dict(n_train=200, d=3), "ppl": dict(n=100),
         "stochvol": dict(num_series=20, length=4, num_particles=5), "jointdpm": dict(n=200)}


@pytest.fixture(scope="module")
def workloads():
    """Each workload built by both packages at a small size (specs only)."""
    out = {}
    for name, kw in SMALL.items():
        out[name] = (j_build(name, smoke=True, num_chains=2, **kw),
                     build_serving_workload(name, smoke=True, num_chains=2, device="cpu", **kw))
    return out


def _window(name, rng, k=3, w=5):
    """A (K, W, ...) numpy window for ``name`` and 11 request rows; the
    mixture's statistics are those of random assignments of real points."""
    if name in ("bayeslr", "ppl"):
        return rng.normal(0, 0.7, (k, w, 3)).astype(np.float32), \
            rng.normal(0, 1, (11, 3)).astype(np.float32)
    if name == "stochvol":
        return {"phi": rng.uniform(0.5, 0.99, (k, w)).astype(np.float32),
                "sigma2": rng.uniform(0.01, 0.1, (k, w)).astype(np.float32)}, \
            rng.uniform(0.05, 0.95, 11).astype(np.float32)
    km, n = 20, 300
    x = rng.normal(0, 2, (n, 2))
    z = rng.integers(0, 4, (k * w, n))
    oh = np.eye(km)[z]  # (S, n, km)
    stats_ = (oh.sum(1), np.einsum("snk,nd->skd", oh, x), np.einsum("snk,nd,ne->skde", oh, x, x))
    shape = lambda a: a.astype(np.float32).reshape((k, w) + a.shape[1:])
    return {"w": rng.normal(0, 1, (k, w, km, 3)).astype(np.float32),
            "alpha": rng.uniform(0.5, 2, (k, w)).astype(np.float32),
            "stats": [shape(a) for a in stats_]}, rng.normal(0, 2, (11, 2)).astype(np.float32)


def _snaps(draws, k=3, w=5):
    """The same window as the reference's and the port's Snapshot."""
    def typed(cls):
        if isinstance(draws, dict) and "stats" in draws:
            return {**draws, "stats": cls(*draws["stats"])}
        return draws
    return (JSnapshot(typed(JClusterStats), k * w, w, 0.0, {}, 0.0),
            Snapshot(typed(ClusterStats), k * w, w, 0.0, {}, 0.0))


# ---------------------------------------------------------------------------
# The evaluator against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,cls,rtol", CLASSES)
def test_evaluator_matches_reference(workloads, name, cls, rtol):
    """Every request class of the four workloads on one window: the port's
    batched ``fn`` and reductions (mean, per-row linear quantile) against the
    reference's vmapped ones, at a micro-batch of 4 (three chunks, the last
    padded)."""
    rng = np.random.default_rng(zlib.crc32(f"{name}.{cls}".encode()))
    draws, xs = _window(name, rng)
    if cls == "wnorm_quantile":  # rows are quantile levels
        xs = rng.uniform(0.05, 0.95, 11).astype(np.float32)
    jsnap, psnap = _snaps(draws)
    (jwl, pwl) = workloads[name]
    want = JEvaluator(4).evaluate(jwl.query_specs[cls], jsnap, xs)
    got = SnapshotEvaluator(4, "cpu").evaluate(pwl.query_specs[cls], psnap, xs)
    assert got.dtype == np.float64 and got.shape == (11,)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * 1e-1)


def test_quantile_per_row_matches_jnp_quantile():
    """The per-row quantile against ``jnp.quantile`` applied column by
    column: levels 0, 1 and between, ties, and a column holding a NaN."""
    rng = np.random.default_rng(0)
    per = rng.normal(0, 1, (37, 9)).astype(np.float32)
    per[:, 3] = 0.5  # all tied
    per[5, 4] = np.nan
    levels = np.array([0.0, 1.0, 0.5, 0.25, 0.3, 0.999, 0.001, 0.7, 0.05], np.float32)
    want = np.array([np.asarray(jnp.quantile(jnp.asarray(per[:, b]), levels[b]))
                     for b in range(9)])
    got = quantile_per_row(torch.from_numpy(per), torch.from_numpy(levels)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, equal_nan=True)
    assert np.isnan(got[4])


@pytest.mark.parametrize("name,cls", [(n, c) for n, c, _ in CLASSES])
def test_micro_batching_is_invisible(workloads, name, cls):
    """Batch transparency, exactly: 13 rows at once equal them in chunks of
    4 and one by one, at micro-batches of 4 and 64 (padding and position in
    the chunk never change a row)."""
    draws, xs = _window(name, np.random.default_rng(1), k=4, w=8)
    if cls == "wnorm_quantile":
        xs = np.random.default_rng(2).uniform(0.05, 0.95, 11).astype(np.float32)
    xs = np.concatenate([xs, xs[:2]])
    _, snap = _snaps(draws, k=4, w=8)
    spec = workloads[name][1].query_specs[cls]
    for mb in (4, 64):
        ev = SnapshotEvaluator(mb, "cpu")
        whole = ev.evaluate(spec, snap, xs)
        parts = np.concatenate([ev.evaluate(spec, snap, xs[i:i + 4]) for i in range(0, 13, 4)])
        ones = np.concatenate([ev.evaluate(spec, snap, xs[i:i + 1]) for i in range(13)])
        np.testing.assert_array_equal(whole, parts)
        np.testing.assert_array_equal(whole, ones)


# ---------------------------------------------------------------------------
# The pool and queue on a warm resident (the reference's serving tests)
# ---------------------------------------------------------------------------


def _tiny_pool(max_batch=4, min_draws=16, max_staleness_s=60.0, window=16, refresh_steps=8,
               num_chains=2, **freshness_kw):
    cfg = ServingConfig(num_chains=num_chains, refresh_steps=refresh_steps, window=window,
                        micro_batch=8, max_batch=max_batch, seed=0, device="cpu",
                        freshness=FreshnessPolicy(max_staleness_s=max_staleness_s,
                                                  min_draws=min_draws, **freshness_kw))
    pool = EnsemblePool(cfg)
    pool.add_workload("bayeslr", smoke=True, n_train=400, d=3, batch_size=50)
    return pool


@pytest.fixture(scope="module")
def warm_pool():
    pool = _tiny_pool()
    pool.warm()
    return pool


def _rows(pool, cls, seed, n):
    return pool.workload("bayeslr").query_specs[cls].make_queries(
        torch.Generator().manual_seed(seed), n)


def test_queue_batching_preserves_per_request_results(warm_pool):
    requests_xs = [_rows(warm_pool, "predictive", i, 3 + i) for i in range(5)]
    queue = RequestQueue(warm_pool, max_batch=5)
    reqs = [queue.submit("bayeslr", "predictive", xs) for xs in requests_xs]
    queue.drain()
    assert all(r.batch_size == 5 for r in reqs)
    snap = warm_pool.resident("bayeslr").snapshot()
    for req, xs in zip(reqs, requests_xs):
        solo, _ = warm_pool.query("bayeslr", "predictive", xs, snapshot=snap)
        np.testing.assert_array_equal(req.values, solo)
        assert req.deadline_met is not None and req.latency_s >= 0.0


def test_queue_groups_by_class_and_worker_serves(warm_pool):
    queue = RequestQueue(warm_pool, max_batch=8)
    for i in range(4):
        cls = "predictive" if i % 2 == 0 else "vote"
        queue.submit("bayeslr", cls, _rows(warm_pool, cls, i, 2))
    served = queue.drain()
    assert len(served) == 4 and all(r.batch_size == 2 for r in served)
    report = queue.slo_report()
    assert set(report["classes"]) == {"bayeslr.predictive", "bayeslr.vote"}
    for entry in report["classes"].values():
        assert {"p50_ms", "p95_ms", "p99_ms", "deadline_hit_rate"} <= set(entry)
    queue.start_worker(max_wait_s=0.0)
    try:
        req = queue.submit("bayeslr", "predictive", _rows(warm_pool, "predictive", 9, 4))
        assert req.result(timeout_s=30.0).shape == (4,)
    finally:
        queue.stop_worker()
    assert queue._thread is None


def test_zero_row_and_malformed_requests(warm_pool):
    """An empty request returns an empty result beside healthy ones; a
    request of the wrong width fails its batch, not the server."""
    queue = RequestQueue(warm_pool, max_batch=3)
    healthy1 = queue.submit("bayeslr", "predictive", _rows(warm_pool, "predictive", 0, 3))
    empty = queue.submit("bayeslr", "predictive", np.empty((0, 3), np.float32))
    healthy2 = queue.submit("bayeslr", "predictive", _rows(warm_pool, "predictive", 1, 2))
    queue.drain()
    assert empty.error is None and empty.values.shape == (0,)
    assert healthy1.values.shape == (3,) and healthy2.values.shape == (2,)
    queue = RequestQueue(warm_pool, max_batch=4)
    bad = queue.submit("bayeslr", "predictive", np.zeros((2, 99), np.float32))
    queue.drain()  # must not raise out of the serve loop
    assert bad.error is not None and bad.deadline_met is False
    entry = queue.slo_report()["classes"]["bayeslr.predictive"]
    assert entry["errors"] == 1 and entry["deadline_hit_rate"] == 0.0 and entry["p50_ms"] is None


def test_freshness_refreshes_and_bounds():
    pool = _tiny_pool(min_draws=32, refresh_steps=4, window=16)
    resident = pool.resident("bayeslr")
    assert pool.config.freshness.stale_reason(resident.snapshot()) == "no draws yet"
    snap = pool.ensure_fresh("bayeslr")
    assert snap.num_draws >= 32 and resident.steps_done >= 16
    with pytest.raises(RuntimeError, match="no draws yet"):
        _tiny_pool().resident("bayeslr").query(pool.spec("bayeslr", "predictive"),
                                               np.zeros((2, 3), np.float32))
    pool = _tiny_pool(min_draws=10**9)
    pool.config = dataclasses.replace(pool.config, max_refreshes_per_query=2)
    with pytest.raises(RuntimeError, match="freshness unreachable"):
        pool.ensure_fresh("bayeslr")
    pool = _tiny_pool(min_draws=8, max_staleness_s=0.2)
    pool.resident("bayeslr").refresh()
    before = pool.resident("bayeslr").steps_done
    time.sleep(0.3)
    pool.query("bayeslr", "predictive", _rows(pool, "predictive", 0, 2))
    assert pool.resident("bayeslr").steps_done > before


def test_background_refresh_advances_and_stops():
    pool = _tiny_pool(refresh_steps=4, window=8, min_draws=4)
    resident = pool.resident("bayeslr")
    resident.start_background(interval_s=0.001)
    deadline = time.monotonic() + 30.0
    while resident.steps_done < 8 and time.monotonic() < deadline:
        time.sleep(0.01)
    resident.stop_background()
    assert resident.steps_done >= 8
    after = resident.steps_done
    time.sleep(0.05)
    assert resident.steps_done == after and resident._thread is None


def _span_tree(spans):
    """Spans as (name, stage, parent's name, tag keys), sorted: the trace's
    shape without its ids and clocks; every span must be closed."""
    by_id = {s["span_id"]: s for s in spans}
    assert all("dur_s" in s and s["dur_s"] >= 0.0 for s in spans)
    skip = {"trace_id", "span_id", "parent_id", "start_s", "dur_s", "pid", "request_id"}
    return sorted((s["name"], s["stage"], by_id[s["parent_id"]]["name"] if s["parent_id"] else None,
                   tuple(sorted(set(s) - skip))) for s in spans)


def test_queue_tracer_spans_match_reference(warm_pool):
    """With a tracer (the reference's ``repro.obs.trace.Tracer``, which the
    port does not have yet), the port's queue opens and closes the spans the
    reference's queue does on the same requests and pool: a root and a
    queue_wait per request, an assembly and the evaluator's device_eval per
    batch under its head, and on a failed batch the error tags; the stage
    breakdown of those spans equals the reference's helper's."""
    from repro.obs.trace import Tracer

    trees, spans = [], {}
    for name, module in (("ref", j_queue), ("port", p_queue)):
        tracer = Tracer()
        queue = module.RequestQueue(warm_pool, max_batch=3, tracer=tracer)
        for i in range(4):
            queue.submit("bayeslr", "predictive", _rows(warm_pool, "predictive", i, 2))
        queue.submit("bayeslr", "vote", _rows(warm_pool, "vote", 5, 3))
        bad = queue.submit("bayeslr", "vote", np.zeros((2, 99), np.float32))
        queue.drain()
        assert bad.error is not None and not bad.trace
        spans[name] = tracer.spans()
        trees.append(_span_tree(spans[name]))
    assert trees[0] == trees[1]
    stages = [s["stage"] for s in spans["port"]]
    assert stages.count("request") == stages.count("queue_wait") == 6
    assert stages.count("assembly") == 3 and stages.count("device_eval") == 2
    roots = {s["trace_id"] for s in spans["port"] if s["stage"] == "request"}
    assert {s["trace_id"] for s in spans["port"]} == roots
    want = j_stats.stage_latency_breakdown(spans["port"])
    assert stats.stage_latency_breakdown(spans["port"]) == want and want


def test_evaluator_span_matches_reference(workloads):
    """``span_sink`` receives one raw device_eval span from each package's
    evaluator on the same window and rows, with the same fields."""
    rng = np.random.default_rng(8)
    draws, xs = _window("bayeslr", rng)
    jsnap, psnap = _snaps(draws)
    sinks = ([], [])
    JEvaluator(micro_batch=4).evaluate(workloads["bayeslr"][0].query_specs["predictive"], jsnap,
                                       xs, span_sink=sinks[0])
    SnapshotEvaluator(micro_batch=4, device="cpu").evaluate(
        workloads["bayeslr"][1].query_specs["predictive"], psnap, xs, span_sink=sinks[1])
    (want,), (got,) = sinks
    assert set(got) == set(want)
    assert {k: got[k] for k in ("trace_id", "span_id", "parent_id", "name", "stage", "rows",
                                "draws")} == \
        {k: want[k] for k in ("trace_id", "span_id", "parent_id", "name", "stage", "rows",
                              "draws")}
    assert got["dur_s"] >= 0.0


def test_arm_profile_captures_one_refresh_and_survives_a_failing_profiler(tmp_path,
                                                                          monkeypatch):
    """``arm_profile`` writes one torch.profiler trace of the next refresh
    and disarms; when the profiler itself fails, the refresh is redone
    unprofiled from the same committed state: bit for bit an unprofiled
    refresh."""
    import json
    from contextlib import contextmanager

    from repro_torch.serving import resident as p_resident

    pools = [_tiny_pool(refresh_steps=4) for _ in range(3)]
    res = [p.resident("bayeslr") for p in pools]
    res[0].arm_profile(str(tmp_path / "ok"))
    res[0].refresh()
    assert res[0].last_profile_dir == str(tmp_path / "ok")
    with open(tmp_path / "ok" / "refresh_trace.json") as f:
        assert any(e.get("name", "").startswith("aten::") for e in json.load(f)["traceEvents"])
    res[0].refresh()  # disarmed: no second capture
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ok"]

    @contextmanager
    def broken(profile_dir, cuda):
        raise RuntimeError("profiler busy")
        yield

    monkeypatch.setattr(p_resident, "_torch_profile", broken)
    res[1].arm_profile(str(tmp_path / "broken"))
    res[1].refresh()
    res[1].refresh()
    res[2].refresh()
    res[2].refresh()
    assert res[1].last_profile_dir is None and not (tmp_path / "broken").exists()
    for r in (res[1], res[0]):
        assert r.steps_done == 8
        assert torch.equal(r.state.theta, res[2].state.theta)
        np.testing.assert_array_equal(r.snapshot().draws, res[2].snapshot().draws)


# ---------------------------------------------------------------------------
# Freshness gates against the reference's
# ---------------------------------------------------------------------------


def _fresh_windows():
    rng = np.random.default_rng(3)
    mixed = rng.normal(0, 1, (3, 12, 2))
    unmixed = np.concatenate([np.zeros((1, 8, 3)), 10 + np.zeros((1, 8, 3))]) \
        + 0.01 * rng.standard_normal((2, 8, 3))
    short = rng.normal(0, 1, (2, 3, 2))
    sv = {"sigma2": rng.uniform(0, 1, (3, 10)), "phi": np.cumsum(rng.normal(0, 1, (3, 10)), 1)}
    jd, _ = _window("jointdpm", rng, k=3, w=6)
    return {"mixed": mixed, "unmixed": unmixed, "short": short, "stochvol": sv,
            "jointdpm": jd}


@pytest.mark.parametrize("window", ["mixed", "unmixed", "short", "stochvol", "jointdpm"])
def test_freshness_gates_match_reference(window):
    """``stale_reason``, ``snapshot_ess`` and ``snapshot_rhat`` on the same
    window give the reference's (the scalar trace is the first component of
    the first leaf in the reference's pytree order: dict keys sorted), under
    the draw-count, staleness, ESS and R-hat gates."""
    draws = _fresh_windows()[window]
    leaf = draws if not isinstance(draws, dict) else draws[sorted(draws)[0]]
    k, w = np.shape(leaf)[:2]
    jsnap, psnap = _snaps(draws, k, w)
    if window == "jointdpm":
        want_leaf = np.asarray(draws["alpha"], np.float64)
        assert np.array_equal(stats.split_rhat(want_leaf), snapshot_rhat(psnap))
    assert snapshot_ess(psnap) == pytest.approx(j_ess(jsnap), rel=1e-12)
    want_r, got_r = j_rhat(jsnap), snapshot_rhat(psnap)
    assert (want_r is None and got_r is None) or got_r == pytest.approx(want_r, rel=1e-12)
    for kw in [dict(min_draws=1), dict(min_draws=10**6), dict(max_rhat=1.1, min_draws=1),
               dict(max_rhat=5.0, min_draws=1), dict(min_ess=1e9, min_draws=1),
               dict(min_ess=0.5, min_draws=1)]:
        assert FreshnessPolicy(**kw).stale_reason(psnap) == JFreshness(**kw).stale_reason(jsnap)
    stale = psnap._replace(staleness_s=99.0)
    assert FreshnessPolicy(max_staleness_s=1.0, min_draws=1).stale_reason(stale) == \
        JFreshness(max_staleness_s=1.0, min_draws=1).stale_reason(jsnap._replace(staleness_s=99.0))
    none = psnap._replace(draws=None)
    assert FreshnessPolicy().stale_reason(none) == "no draws yet" and snapshot_rhat(none) is None


# ---------------------------------------------------------------------------
# SLO and EWMA helpers against the reference's
# ---------------------------------------------------------------------------


def _requests(module, rows):
    out = []
    for wl, qc, lat, err, met, stale, bs in rows:
        r = module.Request(workload=wl, query_class=qc, xs=np.zeros(1), deadline_s=1.0,
                           submitted_at=0.0)
        r.latency_s, r.error, r.deadline_met, r.staleness_s, r.batch_size = \
            lat, err, met, stale, bs
        out.append(r)
    return out


_SLO_CASES = {
    "empty": ([], {}),
    "all_shed": ([("w", "fast", 0.001, "shed: overload", False, None, None)] * 5, {}),
    "single": ([("w", "fast", 0.012, None, True, 0.5, 1)], {}),
    "counters": ([("w", "fast", 0.010, None, True, None, 2),
                  ("w", "fast", 0.030, "RuntimeError: boom", False, None, None)],
                 dict(priorities={"fast": 2, "bulk": 0},
                      class_counters={("w", "fast"): {"admitted": 7, "shed": 3},
                                      ("w", "bulk"): {"admitted": 0, "shed": 4}})),
    "mixed": ([("a", "p", 0.001 * (i % 17 + 1), None if i % 5 else "E: x", i % 3 > 0,
                0.01 * i, 1 + i % 4) for i in range(60)]
              + [("a", "q", 0.002 * (i + 1), None, i % 2 == 0, None, 2) for i in range(7)]
              + [("a", "p", None, None, None, None, None)], {}),
}


@pytest.mark.parametrize("case", list(_SLO_CASES))
def test_slo_report_matches_reference(case):
    """``build_slo_report`` (and the ``slo_summary`` under it) on the same
    completed requests, empty, all shed, a single sample, submit-time
    counters and a mixed load, gives the reference's report, an
    ``SLOReportDict`` as the reference's is."""
    rows, kw = _SLO_CASES[case]
    want = j_stats.build_slo_report(_requests(j_queue, rows), **kw).to_dict()
    got = stats.build_slo_report(_requests(p_queue, rows), **kw).to_dict()
    assert got == want and type(got) is stats.SLOReportDict
    assert type(want).__name__ == "SLOReportDict"
    if case == "single":
        entry = got["classes"]["w.fast"]
        assert entry["p50_ms"] == entry["p99_ms"] == pytest.approx(12.0)
        assert got["count"] == 1


def test_slo_summary_stages_and_ewma_match_reference():
    rng = np.random.default_rng(4)
    lat = rng.exponential(0.01, 200)
    dl = rng.uniform(0.005, 0.03, 200)
    assert stats.slo_summary(lat, dl) == j_stats.slo_summary(lat, dl)
    assert stats.slo_summary([0.01, 0.02, 0.03], [0.025] * 3, percentiles=(10, 90)) == \
        j_stats.slo_summary([0.01, 0.02, 0.03], [0.025] * 3, percentiles=(10, 90))
    for fn in (stats.slo_summary, j_stats.slo_summary):
        with pytest.raises(ValueError, match="at least one request"):
            fn([])
    spans = [{"stage": s, "dur_s": float(d), "trace_id": f"t{i % 7}"}
             for i, (s, d) in enumerate(zip(rng.choice(["queue_wait", "assembly", "device_eval"],
                                                        50), rng.exponential(0.002, 50)))]
    spans += [{"stage": None, "dur_s": 1.0}, {"stage": "x", "dur_s": "bad"}, {"dur_s": 0.1}]
    assert stats.stage_latency_breakdown(spans) == j_stats.stage_latency_breakdown(spans)
    assert stats.stage_latency_breakdown([]) == j_stats.stage_latency_breakdown([])
    p, j = stats.EwmaState(0, 0.0, 0.0), j_stats.EwmaState(0, 0.0, 0.0)
    for x in rng.normal(5, 2, 40):
        assert stats.ewma_zscore(p, x) == j_stats.ewma_zscore(j, x)
        p, j = stats.ewma_update(p, x, 0.2), j_stats.ewma_update(j, x, 0.2)
        assert tuple(p) == tuple(j)
    assert stats.ewma_zscore(stats.EwmaState(5, 1.0, 0.0), 2.0) == \
        j_stats.ewma_zscore(j_stats.EwmaState(5, 1.0, 0.0), 2.0)
    for bad, budget in [(0.01, 0.001), (0.0, 0.1), (0.5, 0.0)]:
        assert stats.burn_rate(bad, budget) == j_stats.burn_rate(bad, budget)


# ---------------------------------------------------------------------------
# Resumption: the carried generator
# ---------------------------------------------------------------------------


def _gauss_ensemble(k=3, n=200, batch=50, seed=0, **kw):
    x = torch.from_numpy(0.5 + np.random.default_rng(seed).standard_normal(n).astype(np.float32))
    target = from_iid_loglik(lambda th: -0.5 * th ** 2, lambda th, idx: -0.5 * (x[idx] - th) ** 2,
                             None, n)
    sampler = kw.pop("sampler", "fy")
    return ChainEnsemble(target, RandomWalk(0.1), k, device="cpu",
                         config=SubsampledMHConfig(batch_size=batch, epsilon=0.05,
                                                   sampler=sampler), **kw), x


@pytest.mark.parametrize("kw", [
    dict(sampler="fy"),
    dict(sampler="stream"),
    dict(sampler="stream", stepping="masked"),
    dict(sampler="stream", stepping="masked", schedule=ScheduleConfig()),
], ids=["lockstep-fy", "lockstep-stream", "masked-stream", "masked-stream-schedule"])
def test_resident_refresh_matches_offline_run(kw):
    """Refreshes of 5, 4 and 3 steps equal one offline ``run`` of 12 steps on
    a generator seeded alike, bit for bit: window, theta, sampler state,
    controller and the generator's position."""
    ens, _ = _gauss_ensemble(**kw)
    resident = ResidentEnsemble(ens, torch.zeros(()), seed=7, window=32, refresh_steps=5)
    for n in (None, 4, 3):
        resident.refresh(n)
    gen = torch.Generator().manual_seed(7)
    state, samples, _ = ens.run(gen, ens.init(torch.zeros(())), 12)
    snap = resident.snapshot()
    np.testing.assert_array_equal(snap.draws, samples.numpy())
    assert state.controller is None or resident.state.controller is not None
    pairs = zip(ckpt._flatten(resident.state).values(), ckpt._flatten(state).values())
    for got, want in pairs:
        assert (got is None and want is None) or torch.equal(torch.as_tensor(got),
                                                             torch.as_tensor(want))
    assert torch.equal(resident._gen_state, gen.get_state())
    assert snap.steps_done == 12 and snap.num_draws == 36


def test_masked_fisher_yates_refresh_in_distribution():
    """Masked stepping with Fisher–Yates: a chunk boundary moves where
    chains start their steps, so chunked refreshes and one offline run
    differ in their bits; both sample the conjugate posterior (N(sum x /
    (n + 1), 1 / (n + 1))): each window mean lies within 5 Monte Carlo
    standard errors (posterior sd / sqrt(ESS)) of the closed form, and each
    window variance within a factor of 2 of it."""
    ens, x = _gauss_ensemble(k=4, stepping="masked")
    mu, sd = float(x.double().sum() / (len(x) + 1)), (1.0 / (len(x) + 1)) ** 0.5
    resident = ResidentEnsemble(ens, torch.zeros(()), seed=3, window=160, refresh_steps=40)
    for _ in range(5):
        resident.refresh()
    chunked = resident.snapshot().draws.astype(np.float64)
    _, one_shot, _ = ens.run(torch.Generator().manual_seed(3), ens.init(torch.zeros(())), 200)
    one_shot = one_shot.numpy()[:, 40:].astype(np.float64)
    assert not np.array_equal(chunked, one_shot)
    for w in (chunked, one_shot):
        se = sd / np.sqrt(max(multichain_ess(w), 1.0))
        assert abs(w.mean() - mu) < 5 * se, (w.mean(), mu, se)
        assert 0.5 < w.var() / sd ** 2 < 2.0


def test_run_timed_resumes_and_streams_blocks():
    """``run_timed`` on a carried generator: 6 then 4 steps equal one run of
    10; ``on_block`` sees blocks [(3, 3), (6, 3), (7, 1)]."""
    ens, _ = _gauss_ensemble(k=2, n=150, batch=30)
    s0 = ens.init(torch.zeros(()))
    _, one_shot, _ = ens.run(torch.Generator().manual_seed(3), ens.init(torch.zeros(())), 10)
    gen = torch.Generator().manual_seed(3)
    state, out1 = ens.run_timed(gen, s0, 6, block_every=4)
    assert out1["next_step"] == 6
    _, out2 = ens.run_timed(gen, state, 4, block_every=4, start_step=out1["next_step"])
    assert out2["next_step"] == 10
    np.testing.assert_array_equal(torch.cat([out1["samples"], out2["samples"]], 1).numpy(),
                                  one_shot.numpy())
    seen = []
    ens.run_timed(4, ens.init(torch.zeros(())), 7, block_every=3,
                  on_block=lambda st, samples, infos, done: seen.append((done, samples.shape[1])))
    assert seen == [(3, 3), (6, 3), (7, 1)]


# ---------------------------------------------------------------------------
# Warm restart and state carried across
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_restores_warm_pool(tmp_path):
    pool = _tiny_pool()
    pool.warm()
    r1 = pool.resident("bayeslr")
    pool.save(str(tmp_path))
    pool2 = _tiny_pool()
    assert pool2.restore(str(tmp_path)) == r1.steps_done == pool2.resident("bayeslr").steps_done
    r2 = pool2.resident("bayeslr")
    assert torch.equal(r1.state.theta, r2.state.theta)
    assert torch.equal(r1.state.sampler_state.pos, r2.state.sampler_state.pos)
    assert r1.state.sampler_state.n == r2.state.sampler_state.n
    np.testing.assert_array_equal(r1.snapshot().draws, r2.snapshot().draws)
    r1.refresh(4)
    r2.refresh(4)  # the restored generator continues the stream bit for bit
    assert torch.equal(r1.state.theta, r2.state.theta)
    np.testing.assert_array_equal(r1.snapshot().draws, r2.snapshot().draws)


def test_restore_refuses_other_pools(tmp_path):
    """A checkpoint without the resident, a pool of another size, and a
    generator state of another device type (a CUDA one's 16 bytes) each
    raise instead of reseeding."""
    pool = _tiny_pool()
    pool.warm()
    pool.save(str(tmp_path))
    other = EnsemblePool(ServingConfig(num_chains=2, refresh_steps=4, window=8, device="cpu"))
    other.add_workload("ppl", smoke=True, n=100)
    with pytest.raises(KeyError, match="no state for resident"):
        other.restore(str(tmp_path))
    with pytest.raises(ValueError, match="configured"):
        _tiny_pool(num_chains=3).restore(str(tmp_path))
    flat = {k.removeprefix("residents__bayeslr__"): v
            for k, v in ckpt.restore(str(tmp_path))[1].items()}
    flat["gen_state"] = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(ValueError, match="device type"):
        _tiny_pool().resident("bayeslr").load_flat(flat)


def test_save_async_writes_uint8_and_float64(tmp_path):
    state = {"g": torch.Generator().manual_seed(1).get_state(), "f": np.arange(3.0),
             "n": {"k": torch.arange(4, dtype=torch.int32)}}
    ckpt.save_async(str(tmp_path), 5, state).join(timeout=30)
    step, flat = ckpt.restore(str(tmp_path))
    assert step == 5 and flat["g"].dtype == torch.uint8 and flat["f"].dtype == torch.float64
    assert torch.equal(flat["g"], state["g"]) and torch.equal(flat["n__k"], state["n"]["k"])


def _reference_pool(**kw):
    cfg = JConfig(num_chains=2, refresh_steps=8, window=16, micro_batch=8, max_batch=4, seed=0,
                  freshness=JFreshness(max_staleness_s=60.0, min_draws=16))
    pool = JPool(cfg)
    pool.add_workload("bayeslr", smoke=True, n_train=400, d=3, batch_size=50, **kw)
    return pool


def test_resident_state_carries_reference_pool_across(tmp_path):
    """A reference pool's checkpoint, through ``convert.resident_state``,
    restores into the port's pool: theta, sampler and window carry over,
    and the port serves the reference's predictive from the same window."""
    jpool = _reference_pool()
    jpool.warm()
    jpool.save(str(tmp_path))
    _, jflat = j_ckpt.restore(str(tmp_path))
    sub = {k.removeprefix("residents__bayeslr__"): v for k, v in jflat.items()}
    pool = _tiny_pool()
    pool.resident("bayeslr").load_flat(convert.resident_state(sub, seed=0, device="cpu"))
    r, jr = pool.resident("bayeslr"), jpool.resident("bayeslr")
    assert r.steps_done == jr.steps_done
    np.testing.assert_array_equal(r.state.theta.numpy(), np.asarray(jr.state.theta))
    np.testing.assert_array_equal(r.snapshot().draws, np.asarray(jr.snapshot().draws))
    xs = np.random.default_rng(5).normal(0, 1, (9, 3)).astype(np.float32)
    want, _ = jpool.query("bayeslr", "predictive", xs, snapshot=jr.snapshot())
    got, _ = pool.query("bayeslr", "predictive", xs, snapshot=r.snapshot())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    r.refresh(4)  # and its chains go on from there
    assert r.steps_done == jr.steps_done + 4


def test_served_posterior_matches_reference_in_distribution():
    """The served BayesLR posterior-mean predictive of both packages, each
    on the reference's data (``convert.lr_data``), K = 4 chains from w = 0,
    300 steps with the last 200 of each chain in the window. Per test row,
    the two estimates differ by less than 5 Monte Carlo standard errors,
    sqrt(var_a / ESS_a + var_b / ESS_b) with the ESS of that row's
    predictive trace across chains, plus 2e-3 for the approximate test's
    bias (epsilon 0.05)."""
    n_train, d, k = 400, 3, 4
    jwl = j_build("bayeslr", smoke=True, n_train=n_train, d=d, num_chains=k, sigma=0.15)
    jres = JResident(jwl.ensemble, jwl.theta0, key=jax.random.key(1), window=200,
                     refresh_steps=150)
    jres.refresh()
    jres.refresh()
    data = j_bayeslr.synth_mnist_like(jax.random.key(0), n_train=n_train, n_test=512, d=d)
    port = convert.lr_data(*(np.asarray(a) for a in data), device="cpu")
    pwl = build_serving_workload("bayeslr", smoke=True, n_train=n_train, d=d, num_chains=k,
                                 sigma=0.15, device="cpu")
    ens = dataclasses.replace(pwl.ensemble, target=bayeslr.make_target(port.x_train,
                                                                       port.y_train))
    res = ResidentEnsemble(ens, torch.zeros(d), seed=1, window=200, refresh_steps=150)
    res.refresh()
    res.refresh()
    xs = np.asarray(data.x_test[:16])
    traces = []
    for draws in (np.asarray(jres.snapshot().draws), res.snapshot().draws):
        traces.append(1.0 / (1.0 + np.exp(-(draws.astype(np.float64) @ xs.T))))  # (K, W, B)
    est = [t.mean((0, 1)) for t in traces]
    se = np.sqrt(sum(t.reshape(-1, 16).var(0) / np.array(
        [max(multichain_ess(t[..., b]), 1.0) for b in range(16)]) for t in traces))
    assert np.all(np.abs(est[0] - est[1]) < 5 * se + 2e-3), (np.abs(est[0] - est[1]), se)


# ---------------------------------------------------------------------------
# Registry and front end
# ---------------------------------------------------------------------------


def test_registry_builds_every_workload_and_needs_a_device(monkeypatch):
    assert {"bayeslr", "stochvol", "jointdpm", "ppl"} <= set(serving_workloads())
    with pytest.raises(KeyError, match="unknown serving workload"):
        build_serving_workload("nope")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, kw in SMALL.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_serving_workload(name, smoke=True, num_chains=2, **kw)


def test_serve_front_end_smoke(capsys):
    """``python -m repro_torch.launch.serve --workload bayeslr --smoke
    --device cpu``: >= 100 requests, parity against float64, SERVE_OK."""
    assert serve.main(["--workload", "bayeslr", "--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    last = out.strip().splitlines()[-1]
    assert last.startswith("SERVE_OK workload=bayeslr queries=120") and "parity=ok(" in last


def test_serve_front_end_profile_dir(tmp_path, capsys):
    """``--profile-dir`` captures the first refresh (inside the warm-up) with
    torch.profiler and the run still ends in SERVE_OK."""
    argv = ["--workload", "bayeslr", "--smoke", "--device", "cpu", "--profile-dir",
            str(tmp_path)]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert f"profile: torch.profiler capture in {tmp_path}" in out
    assert out.strip().splitlines()[-1].startswith("SERVE_OK workload=bayeslr")
    assert (tmp_path / "refresh_trace.json").stat().st_size > 0


# --fleet, --subposterior and --stream are ported (tests/test_torch_fleet.py),
# and so are the observability flags (tests/test_torch_obs.py,
# tests/test_torch_autoscale.py), --mesh 2d / --devices
# (tests/test_torch_distributed.py) and --workload lm
# (tests/test_torch_decode.py): those cases now check which serve path each
# reaches (--devices without --fleet is ignored, as in the reference), and
# --soak without the fleet is refused as the reference refuses it
@pytest.mark.parametrize("argv", [["--workload", "lm"], ["--fleet", "--mesh", "2d"],
                                  ["--devices", "2"], ["--stream", "--soak"], ["--autoscale"],
                                  ["--stats-addr", "127.0.0.1:0"], ["--obs-dir", "x"],
                                  ["--alerts"], ["--soak"], ["--trace-dir", "x"]])
def test_serve_flags_of_later_slices_raise(argv, monkeypatch):
    if argv == ["--soak"]:
        with pytest.raises(SystemExit):
            serve.main(argv + ["--device", "cpu"])
        return
    seen = []
    for path in ("serve_posterior", "serve_fleet", "serve_soak", "serve_lm"):
        monkeypatch.setattr(serve, path, lambda args, path=path: seen.append(path) or 0)
    assert serve.main(argv + ["--device", "cpu"]) == 0
    want = {"--stream": "serve_soak", "--autoscale": "serve_fleet", "--fleet": "serve_fleet",
            "--workload": "serve_lm"}.get(argv[0], "serve_posterior")
    assert seen == [want]
