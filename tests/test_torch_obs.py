"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs`` on the same inputs, and the front end's obs flags.

The recorder, the P² quantiles, the sampler, the adapters, the alert engine,
the health model, the history ring and the dash renderer are host Python
in both packages: fed the same values they must give the same records,
transitions and text, exactly (time stamps and run ids apart). The port's
side is fed torch tensors where the serving stack hands it tensors; the
reference's side gets the same values as numpy. The stats server is held
to the reference's routes and payload keys, and the alert and health
modules must load lazily. Everything runs on the CPU.
"""
import io
import json
import os
import subprocess
import sys
import types
import urllib.error
import urllib.request
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro.obs import alerts as j_alerts
from repro.obs import dash as j_dash
from repro.obs import health as j_health
from repro.obs import history as j_history
from repro.obs import recorder as j_recorder
from repro.obs import server as j_server
from repro.obs import sources as j_sources
from repro.obs import trace as j_trace
from repro.serving.resident import Snapshot as JSnapshot
from repro_torch.launch import serve
from repro_torch.obs import alerts, dash, health, history, recorder, server, sources, trace
from repro_torch.serving.resident import Snapshot

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_STAMPS = ("t", "rel_s")


def _strip(rec: dict) -> dict:
    """A record without its time stamps."""
    return {k: v for k, v in rec.items() if k not in _STAMPS}


def _strip_rollup(roll: dict) -> dict:
    """A rollup without run id, uptime and the time-stamp fields."""
    return {name: {"count": s["count"], "last": _strip(s["last"]),
                   "fields": {f: a for f, a in s["fields"].items() if f not in _STAMPS}}
            for name, s in roll["streams"].items()}


def _fake_time(values):
    """A stand-in for a module's ``time``: ``monotonic`` steps through
    ``values``."""
    it = iter(values)
    return types.SimpleNamespace(monotonic=lambda: next(it))


# ---------------------------------------------------------------------------
# Recorder and P² quantiles: exact against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [0.5, 0.95])
@pytest.mark.parametrize("n", [3, 5, 4000])
def test_p2_quantile_equals_reference(p, n):
    xs = np.random.default_rng(n).standard_t(3, size=n) * 2.0 + 5.0
    mine, ref = recorder._P2Quantile(p), j_recorder._P2Quantile(p)
    for x in xs:
        mine.add(float(x))
        ref.add(float(x))
    assert mine.value() == ref.value()  # the same float operations: exact


def test_rollup_equals_reference_with_torch_values():
    """The same records (torch 0-d tensors and arrays on the port's side,
    numpy on the reference's) give the same rollup, run id and times
    apart."""
    rng = np.random.default_rng(1)
    mine, ref = recorder.Recorder(), j_recorder.Recorder()
    for i in range(40):
        lat, hit = float(rng.exponential(3.0)), bool(rng.random() < 0.9)
        depth = int(rng.integers(0, 9))
        ref.record("slo", {"p95_ms": np.float32(lat), "hit": hit, "depth": np.int64(depth),
                           "arr": np.ones(2), "label": "x", "nan": float("nan")})
        mine.record("slo", {"p95_ms": torch.tensor(lat, dtype=torch.float32),
                            "hit": torch.tensor(hit), "depth": torch.tensor(depth),
                            "arr": torch.ones(2, dtype=torch.float64), "label": "x",
                            "nan": torch.tensor(float("nan"))})
        if i % 3 == 0:
            ref.record("snapshot", staleness_s=0.1 * i)
            mine.record("snapshot", staleness_s=0.1 * i)
    got, want = mine.rollup(), ref.rollup()
    assert got["meta"] == want["meta"] == {}
    got, want = _strip_rollup(got), _strip_rollup(want)
    np.testing.assert_array_equal(got["slo"]["last"].pop("arr"), want["slo"]["last"].pop("arr"))
    assert np.isnan(got["slo"]["last"].pop("nan")) and np.isnan(want["slo"]["last"].pop("nan"))
    assert got == want
    assert "arr" not in got["slo"]["fields"] and "nan" not in got["slo"]["fields"]


def test_recorder_streams_roundtrip_with_tensors(tmp_path):
    """Streams, meta.json and summary.json on disk; a tensor in a record is
    written as its number (0-d) or its list, as the reference writes numpy."""
    with recorder.Recorder(str(tmp_path), run_id="r1", meta={"workload": "t"}) as rec:
        rec.record("slo", {"count": torch.tensor(1), "p95_ms": torch.tensor(10.0)})
        rec.record("slo", count=3, p95_ms=30.0, arr=torch.arange(3))
        rec.record("snapshot", {"staleness_s": 0.5})
        roll = rec.rollup()
    agg = roll["streams"]["slo"]["fields"]["p95_ms"]
    assert {k: agg[k] for k in ("count", "mean", "min", "max", "last")} == {
        "count": 2, "mean": 20.0, "min": 10.0, "max": 30.0, "last": 30.0}
    back = rec.read_stream("slo")
    assert [r["count"] for r in back] == [1, 3] and back[1]["arr"] == [0, 1, 2]
    run_dir = tmp_path / "r1"
    assert json.loads((run_dir / "meta.json").read_text())["run_id"] == "r1"
    assert json.loads((run_dir / "summary.json").read_text())["streams"]["snapshot"]["count"] == 1
    assert recorder.json_default(torch.tensor(2.5)) == 2.5
    assert recorder._as_scalar(torch.tensor(True)) == 1.0
    assert recorder._as_scalar(torch.ones(2)) is None  # not a scalar, as an array
    with pytest.raises(RuntimeError, match="closed"):
        rec.record("s", {"x": 1})


# ---------------------------------------------------------------------------
# Source adapters: the same records from the same values
# ---------------------------------------------------------------------------


class _FakeSource:
    """A scripted ``slo_report()`` source (the reference's test's, with a
    counter reset and shed-floor changes)."""

    def __init__(self):
        self.count, self.floor = 0, None

    def slo_report(self):
        return {
            "count": self.count, "errors": 0, "shed": 2,
            "admission": {"depth": 5, "predicted_miss_rate": 0.1, "shed_floor": self.floor},
            "recovery": {"lane_deaths": 1, "rerouted": 3, "dead_lanes": 0},
            "classes": {
                "w.fast": {"count": self.count, "errors": 0, "admitted": 9, "shed": 0,
                           "priority": 1, "p50_ms": 1.0, "p95_ms": 4.0, "p99_ms": 5.0,
                           "deadline_hit_rate": 1.0, "mean_batch_size": 2.0,
                           "staleness_mean_s": 0.25},
                "w.slow": {"count": 0, "errors": 0, "admitted": 0, "shed": 2, "priority": 0,
                           "p50_ms": None, "p95_ms": 9.0, "p99_ms": None,
                           "deadline_hit_rate": 0.0, "mean_batch_size": None,
                           "staleness_mean_s": None},
            },
        }


_SAMPLES = [(10, None), (20, None), (150, 1), (10, 1), (30, None), (30, None), (70, 0)]


def _run_sampler(mod, rec_mod, monkeypatch):
    clock = [0.0, 0.5, 1.25, 2.0, 2.0, 3.5, 4.0]
    monkeypatch.setattr(mod, "time", _fake_time(clock))
    rec, src = rec_mod.Recorder(), _FakeSource()
    sampler = mod.SLOSampler(rec, src)
    out = []
    for count, floor in _SAMPLES:
        src.count, src.floor = count, floor
        out.append(_strip(sampler.sample()))
    return out, _strip_rollup(rec.rollup())


def test_slo_sampler_equals_reference(monkeypatch):
    """Rates, the worst class lifted, the counter-reset marker and the
    admission transitions: equal records over the same source sequence with
    ``time.monotonic`` patched alike in both modules."""
    got = _run_sampler(sources, recorder, monkeypatch)
    want = _run_sampler(j_sources, j_recorder, monkeypatch)
    assert got == want
    records, roll = got
    assert records[1]["req_per_s"] == 20.0 and records[3]["req_per_s"] == 0.0
    assert roll["admission"]["count"] == 3 and roll["slo"]["fields"]["counter_reset"]["count"] == 1


def _draws(k=3, w=8):
    return np.cumsum(np.random.default_rng(0).normal(size=(k, w)), axis=1).astype(np.float32)


@pytest.mark.parametrize("w", [2, 8, 32])
def test_record_snapshot_equals_reference(w):
    """Staleness, window size, split R-hat and window ESS (R-hat and ESS
    through each package's own diagnostics: 1e-9 relative)."""
    mine = sources.record_snapshot(recorder.Recorder(), "bayeslr", Snapshot(
        draws=_draws(w=w), num_draws=3 * w, steps_done=64, staleness_s=0.5, summary={},
        created_at=0.0))
    want = j_sources.record_snapshot(j_recorder.Recorder(), "bayeslr", JSnapshot(
        draws=_draws(w=w), num_draws=3 * w, steps_done=64, staleness_s=0.5, summary={},
        created_at=0.0))
    mine, want = _strip(mine), _strip(want)
    assert mine.keys() == want.keys() and ("rhat" in mine) == (w >= 4)
    for k in mine:
        assert mine[k] == pytest.approx(want[k], rel=1e-9), k


def test_record_adaptation_equals_reference():
    """Per-chain arrays as their mean, scalars direct, nested dicts dotted,
    nested arrays dropped; the port's side holds tensors."""
    ref = {"accept_rate": np.array([0.2, 0.4], np.float32), "mean_batch_frac": 0.125,
           "schedule": {"epsilon": np.float32(0.01)}, "edges": {"hist": np.arange(5)},
           "final_epsilon": np.array([0.05, 0.07, 0.06]), "note": "text"}
    mine = {"accept_rate": torch.tensor([0.2, 0.4]), "mean_batch_frac": torch.tensor(0.125),
            "schedule": {"epsilon": torch.tensor(0.01)}, "edges": {"hist": torch.arange(5)},
            "final_epsilon": torch.tensor([0.05, 0.07, 0.06], dtype=torch.float64),
            "note": "text"}
    got = sources.record_adaptation(recorder.Recorder(), "sv", mine)
    want = j_sources.record_adaptation(j_recorder.Recorder(), "sv", ref)
    assert _strip(got) == _strip(want)
    assert sources.record_adaptation(recorder.Recorder(), "sv", {}) is None
    assert sources.record_adaptation(recorder.Recorder(), "sv", {"note": "x"}) is None


def test_record_fleet_sync_equals_reference():
    class _FakeFleet:
        sync_stats = {"syncs": 4, "full_deltas": 1, "skipped_dead": 0,
                      "delta_wire_bytes": 100, "full_wire_bytes": 400,
                      "delta_payload_bytes": 80, "full_payload_bytes": 300}

        def report(self):
            return {"shards": {"b@0": {"writer_steps": 64, "replica_versions": [64, 48]},
                               "b@1": {"writer_steps": 8, "replica_versions": []}},
                    "errors": {"b@0/b@0#r1": "dead"}}

    got = sources.record_fleet_sync(recorder.Recorder(), _FakeFleet())
    want = j_sources.record_fleet_sync(j_recorder.Recorder(), _FakeFleet())
    assert _strip(got) == _strip(want) and got["delta_ratio"] == 0.25


_COST_CASES = {
    "single": ({"accept_rate_overall": 0.4, "mean_n_evaluated_overall": 12.5,
                "mean_rounds_overall": 2.0}, 100),
    "composite": ({"theta": {"mean_n_evaluated_overall": 10.0, "mean_rounds_overall": 1.5},
                   "z": {"mean_n_evaluated_overall": 40.0},
                   "sweep": {"accept_rate_overall": 1.0}}, {"theta": 100, "z": 80}),
    "unsubsampled": ({"accept_rate_overall": 1.0}, None),
    "no_sections": ({"mean_n_evaluated_overall": 3.0}, None),
}


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.tensor(tree, dtype=torch.float64)


@pytest.mark.parametrize("case", sorted(_COST_CASES))
def test_record_transition_cost_equals_reference(case):
    """Fraction of data touched per op and overall; the port's summary holds
    0-d tensors (float64: the same numbers as the reference's floats)."""
    summary, ns = _COST_CASES[case]
    got = sources.record_transition_cost(recorder.Recorder(), "w", _tensors(summary),
                                         num_sections=ns)
    want = j_sources.record_transition_cost(j_recorder.Recorder(), "w", summary,
                                            num_sections=ns)
    assert (got is None) == (want is None) == (case == "unsubsampled")
    if got is not None:
        assert _strip(got) == _strip(want)


class _Infos(NamedTuple):
    accepted: object
    n_evaluated: object
    epsilon: object
    batch_eff: object


def _on_block_records(mod, rec_mod, as_tensor, monkeypatch):
    monkeypatch.setattr(mod, "time", _fake_time([0.0, 0.02, 0.05, 0.05]))
    rng = np.random.default_rng(4)
    rec = rec_mod.Recorder()
    hook = mod.make_on_block(rec, "gauss")
    for block in range(4):
        samples = {"w": rng.normal(size=(3, 2, 5)).astype(np.float32)}
        infos = _Infos(rng.random((3, 2)) < 0.4, rng.integers(1, 90, (3, 2)),
                       rng.random((3, 2)).astype(np.float32),
                       rng.integers(10, 40, (3, 2)).astype(np.float32))
        if as_tensor:
            samples = {"w": torch.from_numpy(samples["w"])}
            infos = _Infos(*(torch.from_numpy(np.asarray(a)) for a in infos))
        hook(None, samples, infos, 2 * (block + 1) if block < 3 else 6)
    return _strip_rollup(rec.rollup())


def test_make_on_block_equals_reference(monkeypatch):
    """Per-block throughput (K from the first sample leaf), acceptance,
    sections and the schedule's knobs: the port's hook fed tensors records
    what the reference's records from numpy."""
    got = _on_block_records(sources, recorder, True, monkeypatch)
    want = _on_block_records(j_sources, j_recorder, False, monkeypatch)
    assert got == want
    refresh = got["refresh"]
    assert refresh["count"] == 4 and refresh["fields"]["transitions_per_sec"]["count"] == 2


def test_host_fields_split_the_joined_copy_back_exactly():
    """The one device-to-host copy of a block's infos: each field comes back
    with its dtype, shape and bits."""
    gen = torch.Generator().manual_seed(0)
    infos = _Infos(torch.rand(4, 3, generator=gen) < 0.5,
                   torch.randint(0, 100, (4, 3), generator=gen),
                   torch.rand(4, 3, generator=gen), torch.rand(4, 3, generator=gen).double())
    host = sources._host_fields(infos)
    assert list(host) == list(sources._INFO_FIELDS)
    for name in sources._INFO_FIELDS:
        want = getattr(infos, name).numpy()
        assert host[name].dtype == want.dtype and host[name].shape == want.shape
        np.testing.assert_array_equal(host[name], want)


def test_make_on_block_through_run_timed():
    """The hook on the port's ``run_timed``: one record a block, throughput
    from the second block on."""
    from repro_torch.core import ChainEnsemble, RandomWalk, SubsampledMHConfig, from_iid_loglik

    x = torch.from_numpy(np.random.default_rng(5).standard_normal(400).astype(np.float32))
    target = from_iid_loglik(lambda th: -0.5 * th ** 2,
                             lambda th, idx: -0.5 * (x[idx] - th) ** 2, None, 400)
    ens = ChainEnsemble(target, RandomWalk(0.1), 2, device="cpu",
                        config=SubsampledMHConfig(batch_size=50, epsilon=0.05))
    rec = recorder.Recorder()
    _, out = ens.run_timed(0, ens.init(torch.zeros(())), num_steps=6, block_every=2,
                           on_block=sources.make_on_block(rec, "gauss"))
    refresh = rec.rollup()["streams"]["refresh"]
    assert out["next_step"] == 6 and refresh["count"] == 3
    assert refresh["last"]["steps_done"] == 6 and refresh["last"]["workload"] == "gauss"
    assert refresh["fields"]["transitions_per_sec"]["count"] == 2
    assert 0.0 <= refresh["last"]["accept_rate"] <= 1.0


# ---------------------------------------------------------------------------
# Alerts and health: the same transitions and status
# ---------------------------------------------------------------------------


def _rollups(n=60):
    """A scripted sequence of rollups over every stream the default rules
    read: a latency excursion, a shed episode, a backlog, a burn, a
    throughput collapse, an acceptance shift, a lost sublinearity and a
    diverging window."""
    rng = np.random.default_rng(7)
    cls = "bayeslr.predictive"
    out = []
    for i in range(n):
        hot = 20 <= i < 30
        edge = i in (5, 6, 12)  # every threshold met exactly: > against >= decides
        fields = {
            ("slo", "p95_ms"): 300.0 if hot else 40.0 + rng.normal(),
            ("slo", "admission_shed_floor"): 0 if 25 <= i < 28 else -1,
            ("slo", "admission_depth"): 300 if 26 <= i < 29 else int(rng.integers(0, 9)),
            ("slo", f"{cls}.deadline_hit_rate"): 0.5 if hot else 0.99,
            ("slo", "req_per_s"): 5.0 if 40 <= i < 44 else 800.0 + 10 * rng.normal(),
            ("refresh", "accept_rate"): 0.9 if 45 <= i < 48 else 0.3 + 0.01 * rng.normal(),
            ("transition_cost", "frac_data_touched"): 1.0 if 50 <= i < 53 else 0.13,
            ("snapshot", "rhat"): 1.5 if 33 <= i < 37 else 1.01,
            ("snapshot", "ess"): 2.0 if 55 <= i < 58 else 500.0 + rng.normal(),
        }
        if edge:
            fields.update({("slo", "p95_ms"): 250.0, ("slo", "admission_depth"): 256,
                           ("snapshot", "rhat"): 1.2,
                           ("transition_cost", "frac_data_touched"): 0.999})
        streams: dict = {}
        for (stream, field), value in fields.items():
            if i < 3 and stream == "snapshot":
                continue  # a stream not recorded yet: rules leave their state
            agg = {"last": value, "mean": value, "min": value, "max": value, "p50": value,
                   "p95": value, "count": i + 1}
            streams.setdefault(stream, {"count": i + 1, "last": {}, "fields": {}})
            streams[stream]["fields"][field] = agg
        out.append({"streams": streams})
    return out


def _run_engine(mod, rec_mod):
    clock = [0.0]
    rec = rec_mod.Recorder()
    rules = mod.default_rules("bayeslr", "predictive", deadline_ms=250.0, max_depth=256)
    rules = rules + (mod.AlertRule(name="cooled", stream="slo", field="p95_ms", op=">",
                                   threshold=100.0, for_samples=1, clear_samples=1,
                                   cooldown_s=5.0),)
    engine = mod.AlertEngine(rec, rules, clock=lambda: clock[0])
    events, statuses = [], []
    for roll in _rollups():
        clock[0] += 0.5
        events.append(engine.evaluate(roll))
        statuses.append(engine.status())
    return events, statuses, _strip_rollup(rec.rollup())


def test_alert_engine_with_default_rules_equals_reference():
    """The same transitions, recorded events and ``status()`` at every step
    over one scripted rollup sequence and an injected clock."""
    got, want = _run_engine(alerts, recorder), _run_engine(j_alerts, j_recorder)
    assert got == want
    events, statuses = got[0], got[1]
    fired = {e["rule"] for step in events for e in step if e["to"] == "firing"}
    assert {"p95_over_budget", "admission_overload", "queue_depth_high", "deadline_burn",
            "req_rate_anomaly", "accept_rate_anomaly", "sublinear_regression",
            "rhat_regression", "ess_anomaly", "cooled"} <= fired
    assert statuses[-1]["evaluations"] == 60 and statuses[-1]["resolved_total"] >= 1


def test_alert_rule_validation_equals_reference():
    for kw in ({"kind": "nope"}, {"op": "=="}, {"source": "p99"}, {"direction": "up"},
               {"objective": 1.0}, {"short_window": 5, "long_window": 3},
               {"for_samples": 0}):
        for mod in (alerts, j_alerts):
            with pytest.raises(ValueError):
                mod.AlertRule(name="r", stream="s", field="f", **kw)
    with pytest.raises(ValueError, match="duplicate"):
        alerts.AlertEngine(None, [alerts.AlertRule(name="r", stream="s", field="f")] * 2)
    with pytest.raises(ValueError, match="no rollup"):
        alerts.AlertEngine(None, []).evaluate()


def _health_inputs():
    slo = {"admission_shed_floor": -1, "admission_depth": 64, "shed": 0, "dead_lanes": 0,
           "lane_deaths": 0, "rerouted": 0}
    roll = lambda slo_last, snap_last, frac: {  # noqa: E731
        "run_id": "h", "uptime_s": 3.0,
        "streams": {"slo": {"last": slo_last, "fields": {}},
                    "snapshot": {"last": snap_last, "fields": {}},
                    **({"transition_cost": {"last": {}, "fields": {"frac_data_touched": {
                        "mean": frac, "count": 4}}}} if frac is not None else {})}}
    fleet_report = {"shards": {"b@0": {"writer_steps": 100, "replica_versions": [100, 40],
                                       "replicas": [{"alive": True}, {"alive": False}]}},
                    "errors": {"b@0/b@0#r1": "dead"}}
    status = {"firing": ["hot"], "rules": {"hot": {"severity": "page"}}}
    warn = {"firing": ["w"], "rules": {"w": {"severity": "warning"}}}
    return {
        "clean": (roll(slo, {"rhat": 1.01, "num_draws": 64, "ess": 30.0}, 0.13), {}),
        "empty": ({"streams": {}}, {}),
        "shedding": (roll({**slo, "admission_shed_floor": 0, "dead_lanes": 1, "lane_deaths": 2},
                          {"rhat": 1.15}, 0.95), {"max_depth": 256}),
        "pressure": (roll({**slo, "lane_deaths": 1}, {"rhat": 1.3}, 0.9995), {"max_depth": 100}),
        "page_alert": (roll(slo, {}, 0.1), {"alert_status": status}),
        "warning_alert": (roll(slo, {}, None), {"alert_status": warn}),
        "replicas": (roll(slo, {"rhat": 1.6}, None), {"fleet_report": fleet_report}),
    }


@pytest.mark.parametrize("case", sorted(_health_inputs()))
def test_health_report_equals_reference(case):
    roll, kw = _health_inputs()[case]
    assert health.health_report(roll, **kw) == j_health.health_report(roll, **kw)


# ---------------------------------------------------------------------------
# Dash, history, the stats server, lazy loading
# ---------------------------------------------------------------------------


def _recorded_run(tmp_path, close=True):
    """A run directory written by the port's recorder: slo, transition cost,
    alerts, autoscale and spans streams."""
    rec = recorder.Recorder(str(tmp_path), run_id="dashrun")
    tracer = trace.Tracer(recorder=rec)
    for i in range(6):
        rec.record("slo", {"count": 4 * i, "req_per_s": torch.tensor(120.0 + i),
                           "p95_ms": 8.0 + i, "shed": 2, "errors": 0, "dead_lanes": 0})
        root = tracer.new_trace("request:w.q", workload="w")
        child = tracer.start(root["trace_id"], "queue_wait", "queue_wait",
                             parent_id=root["span_id"])
        tracer.finish(child)
        tracer.finish(root)
    sources.record_transition_cost(rec, "w", {"mean_n_evaluated_overall": 5.0},
                                   num_sections=50)
    rec.record("alerts", {"rule": "hot", "from": "pending", "to": "firing",
                          "severity": "page", "value": 99.0})
    rec.record("alerts", {"rule": "cold", "from": "ok", "to": "firing",
                          "severity": "warning", "value": 1.0})
    rec.record("alerts", {"rule": "cold", "from": "firing", "to": "resolved",
                          "severity": "warning", "value": 0.0})
    rec.record("autoscale", {"action": "scale_up", "replica": "w@0#r1", "replicas_before": 1,
                             "replicas_after": 2, "reason": "alert:hot"})
    rec.record("autoscale", {"action": "blocked", "reason": "cooldown"})
    run_dir = rec.dir
    if close:
        rec.close()
    else:  # a crash: the streams flushed, no summary
        rec._closed = True
        for f in rec._files.values():
            f.close()
    return run_dir


@pytest.mark.parametrize("closed", [True, False])
def test_dash_main_text_equals_reference(tmp_path, closed):
    """Byte-identical text from both packages' ``dash.main`` on one run
    directory, from ``summary.json`` or rebuilt from the raw streams."""
    run_dir = _recorded_run(tmp_path, close=closed)
    assert os.path.exists(os.path.join(run_dir, "summary.json")) == closed
    got, want = io.StringIO(), io.StringIO()
    assert dash.main([run_dir], out=got) == 0
    assert j_dash.main([run_dir], out=want) == 0
    assert got.getvalue() == want.getvalue()
    text = got.getvalue()
    assert "run dashrun" in text and "frac_data_touched mean=0.1000" in text
    assert "STILL FIRING at exit: hot" in text and "stage latency (ms):" in text
    assert dash.main([str(tmp_path / "nope")]) == 2
    (tmp_path / "empty").mkdir()
    assert dash.main([str(tmp_path / "empty")]) == 2


def _write_bench(path, qps):
    path.mkdir(parents=True, exist_ok=True)
    (path / "BENCH_serving.json").write_text(json.dumps({"records": [{"qps": qps}]}))
    (path / "BENCH_multichain.json").write_text(json.dumps({"records": []}))


def test_history_store_index_equals_reference(tmp_path):
    """The same appends give the same ring (ids, artifacts, pruning), and a
    corrupt index is rebuilt alike; ``saved_at`` stamps apart."""
    index = lambda store: [{k: v for k, v in r.items() if k != "saved_at"}  # noqa: E731
                           for r in store.runs()]
    stores = {}
    for name, mod in (("mine", history), ("ref", j_history)):
        store = mod.HistoryStore(str(tmp_path / name), capacity=3)
        for i in range(5):
            art = tmp_path / f"art{i}"
            _write_bench(art, 1000.0 + i)
            if i % 2:
                (art / "GATE_verdict.json").write_text(json.dumps({"status": "pass"}))
            store.append(str(art), run_id=f"r{i}", meta={"commit": f"c{i}"})
        with pytest.raises(FileNotFoundError):
            store.append(str(tmp_path / "no_such_artifacts_dir_" / ".."))
        stores[name] = store
    assert index(stores["mine"]) == index(stores["ref"])
    assert len(stores["mine"]) == 3 and stores["mine"].last(1)[0]["id"].startswith("000004-r4")
    for name, mod in (("mine", history), ("ref", j_history)):
        (tmp_path / name / "index.json").write_text("{not json")
        stores[name] = mod.HistoryStore(str(tmp_path / name))
    assert index(stores["mine"]) == index(stores["ref"])
    with pytest.raises(ValueError):
        history.HistoryStore(str(tmp_path / "x"), capacity=0)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.headers["Content-Type"], json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, err.headers["Content-Type"], json.loads(err.read())


def _keys(obj, depth=2):
    """The payload's key structure to ``depth`` levels (the values are live
    measurements: times, ids)."""
    if isinstance(obj, dict) and depth:
        return {k: _keys(v, depth - 1) for k, v in obj.items()}
    return type(obj).__name__


def _server(mod, rec_mod, trace_mod, alerts_mod, sources_mod):
    rec = rec_mod.Recorder(run_id="probe")
    tracer = trace_mod.Tracer(recorder=rec)
    root = tracer.new_trace("request:w.q", workload="w")
    tracer.finish(tracer.start(root["trace_id"], "queue_wait", "queue_wait",
                               parent_id=root["span_id"]))
    tracer.finish(root)
    sources_mod.record_transition_cost(rec, "w", {"mean_n_evaluated_overall": 5.0},
                                       num_sections=50)
    rec.record("slo", {"p95_ms": 99.0, "req_per_s": 10.0})
    srv = mod.StatsServer(rec, "127.0.0.1:0", tracer=tracer)
    engine = alerts_mod.AlertEngine(rec, [alerts_mod.AlertRule(
        name="hot", stream="slo", field="p95_ms", op=">", threshold=10.0, for_samples=1,
        clear_samples=1, severity="page")])
    engine.evaluate()
    srv.alerts = engine
    return srv, rec


@pytest.fixture(scope="module")
def server_pair():
    """The port's and the reference's stats servers over recorders holding
    the same records, a tracer and an alert engine each."""
    pair = (_server(server, recorder, trace, alerts, sources),
            _server(j_server, j_recorder, j_trace, j_alerts, j_sources))
    yield pair[0][0], pair[1][0]
    for srv, rec in pair:
        srv.close()
        rec.close()


@pytest.mark.parametrize("path", ["/", "/healthz", "/health", "/alerts", "/spans", "/stages",
                                  "/sublinear", "/nope"])
def test_stats_server_routes_equal_reference(path, server_pair):
    """Each route answers with the reference's status, content type and
    payload keys (to two levels), from recorders holding the same records;
    an unknown path is the same JSON 404 listing the routes."""
    assert server.ROUTES == j_server.ROUTES
    mine, ref = server_pair
    got = _get(mine.url.rstrip("/") + path)
    want = _get(ref.url.rstrip("/") + path)
    assert got[:2] == want[:2]
    assert _keys(got[2]) == _keys(want[2])
    if path in ("/healthz", "/nope"):
        assert got[2] == want[2]
    if path == "/sublinear":
        got[2]["last"], want[2]["last"] = _strip(got[2]["last"]), _strip(want[2]["last"])
        assert got[2] == want[2]
    if path == "/alerts":
        assert got[2]["firing"] == want[2]["firing"] == ["hot"]
    if path == "/health":
        assert got[2]["status"] == want[2]["status"] == "critical"


def test_alert_and_health_modules_load_lazily():
    """Every serve path imports ``repro_torch.obs``; a run with every flag
    off must not load the alert engine or the health model until asked."""
    code = (
        "import sys, repro_torch.obs, repro_torch.obs.trace, repro_torch.obs.server\n"
        "import repro_torch.launch.serve, repro_torch.fleet\n"
        "assert 'repro_torch.obs.alerts' not in sys.modules, 'alerts eager'\n"
        "assert 'repro_torch.obs.health' not in sys.modules, 'health eager'\n"
        "from repro_torch.obs import AlertEngine, health_report\n"
        "assert 'repro_torch.obs.alerts' in sys.modules\n"
        "assert 'repro_torch.obs.health' in sys.modules\n"
        "assert not any(m == 'jax' or m.startswith('repro.') for m in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


# ---------------------------------------------------------------------------
# The front end's obs flags on the CPU
# ---------------------------------------------------------------------------


def test_serve_front_end_obs_flags(tmp_path, capsys):
    """``--stats-addr --obs-dir --alerts --trace-dir --smoke --device cpu``:
    the four self-check lines, the streams and summary on disk, the
    transition cost equal to the snapshot's sections over N, and the run
    renders with ``python -m repro_torch.obs.dash``."""
    obs_dir, trace_dir = tmp_path / "obs", tmp_path / "trace"
    argv = ["--workload", "bayeslr", "--smoke", "--device", "cpu", "--stats-addr",
            "127.0.0.1:0", "--obs-dir", str(obs_dir), "--alerts", "--trace-dir", str(trace_dir)]
    out: dict = {}
    args = serve.build_parser().parse_args(argv)
    assert serve.serve_posterior(args, out) == 0
    text = capsys.readouterr().out
    for line in ("STATS_OK ", "ALERTS_OK ", "TRACE_OK ", "SERVE_OK workload=bayeslr"):
        assert any(ln.startswith(line) for ln in text.splitlines()), line
    last = text.strip().splitlines()[-1]
    assert "parity=ok(" in last and " alerts_fired=" in last
    (run_dir,) = obs_dir.iterdir()
    for name in ("summary.json", "meta.json", "slo.jsonl", "snapshot.jsonl",
                 "transition_cost.jsonl", "adaptation.jsonl", "spans.jsonl", "alerts.jsonl"):
        assert (run_dir / name).stat().st_size > 0, name
    assert (trace_dir / "trace.json").stat().st_size > 0
    cost = [json.loads(ln) for ln in (run_dir / "transition_cost.jsonl").read_text().splitlines()]
    want = out["obs_summary"]["mean_n_evaluated_overall"] / out["num_sections"]
    assert cost[-1]["frac_data_touched"] == pytest.approx(want, rel=1e-12) and want < 1.0
    assert out["stats_ok"] and out["alerts_ok"]
    page = io.StringIO()
    assert dash.main([str(run_dir)], out=page) == 0
    assert "sublinear: frac_data_touched" in page.getvalue()


def test_serve_front_end_without_obs_flags_builds_no_recorder(capsys, monkeypatch):
    """With no obs flag the front end builds no recorder (``REPRO_OBS_DIR``
    unset) and its output has no obs line."""
    monkeypatch.delenv("REPRO_OBS_DIR", raising=False)
    args = serve.build_parser().parse_args(["--smoke", "--device", "cpu"])
    assert serve._setup_obs(args) == (None, None, None, None)
    monkeypatch.setenv("REPRO_OBS_DIR", "/nonexistent-obs-root")
    assert serve.build_parser().parse_args([]).obs_dir == "/nonexistent-obs-root"
