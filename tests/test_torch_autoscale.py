"""The port's autoscaler (``repro_torch.fleet.autoscale``) against the JAX
package's, the closed loop on the port's fleet, and the chaos soak of the
front end.

The control loop is host Python in both packages: over the same stub router
and fleet (the reference's own stubs, ``tests/test_alerts.py``) and an
injected clock, the two scalers must make the same decisions, in the same
order, with the same records. The closed loop then runs on a small port
fleet on the CPU: an overload fires ``admission_overload``, the scaler turns
it into a replica that answers bit for bit as its writer, and the quiesce
retires exactly that replica. The front end's ``--fleet --soak --autoscale``
ends in ``SOAK_OK``; the same soak over process replicas with a real
SIGKILL is marked ``slow``, as the reference's is.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.fleet import autoscale as j_autoscale
from repro.obs import recorder as j_recorder
from repro_torch.fleet import (AdmissionConfig, AutoScaleConfig, AutoScaler, Fleet, FleetConfig,
                               FleetRouter)
from repro_torch.fleet import autoscale
from repro_torch.launch import serve
from repro_torch.obs import AlertEngine, Recorder, SLOSampler, default_rules, recorder
from repro_torch.serving import FreshnessPolicy, ServingConfig

torch.set_num_threads(1)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# The control loop against the reference, over the reference's stubs
# ---------------------------------------------------------------------------


class _StubReplica:
    def __init__(self, name):
        self.name = name


class _StubFleet:
    def __init__(self, n=1):
        self.replicas = [_StubReplica(f"w@0#r{i}") for i in range(n)]
        self._seq = n
        self.added, self.removed = [], []

    def replica_count(self, workload):
        return len(self.replicas)

    def add_replica(self, workload, shard_index=0):
        rep = _StubReplica(f"w@0#r{self._seq}")
        self._seq += 1
        self.replicas.append(rep)
        self.added.append(rep.name)
        return ("shard-stub", rep)

    def remove_replica(self, workload, replica_name=None):
        rep = next(r for r in self.replicas if r.name == replica_name)
        self.replicas.remove(rep)
        self.removed.append(rep.name)
        return rep.name


class _StubRouter:
    def __init__(self):
        self.depth = 0
        self.shed = 0
        self.shed_floor = None
        self.p95_ms = None
        self.attached, self.detached = [], []

    def slo_report(self):
        return {
            "shed": self.shed,
            "admission": {"depth": self.depth, "shed_floor": self.shed_floor,
                          "predicted_miss_rate": 0.0},
            "classes": {"w.q": {"p95_ms": self.p95_ms}},
        }

    def attach_lane(self, shard, replica):
        self.attached.append(replica.name)

    def detach_lane(self, workload, name, timeout_s=30.0):
        self.detached.append(name)
        return True


class _StubEngine:
    def __init__(self):
        self.names: list[str] = []

    def firing(self):
        return list(self.names)


# Each scenario: config overrides, then ticks as (advance the clock by, router
# and engine settings for the tick); None entries call observe() instead.
_SCENARIOS = {
    "depth_pressure": ({}, [(0.0, {"depth": 12}), (1.0, {"depth": 12})]),
    "cooldown_and_max": ({"max_replicas": 2}, [
        (0.0, {"depth": 50}), (1.0, {"depth": 50}), (10.0, {"depth": 50}),
        (10.0, {"depth": 50})]),
    "lifo_scale_down": ({"cooldown_s": 0.0, "max_replicas": 4}, [
        (0.0, {"depth": 50}), (1.0, {"depth": 50}), (1.0, {"depth": 3}),
        (1.0, {"depth": 0}), (1.0, {"depth": 0}), (1.0, {"depth": 0}),
        (1.0, {"depth": 0}), (1.0, {"depth": 0}), (1.0, {"depth": 0})]),
    "pressure_reasons": ({"cooldown_s": 0.0, "max_replicas": 9, "scale_up_p95_ms": 100.0}, [
        (0.0, {"firing": ["admission_overload", "p95_over_budget"]}),
        (1.0, {"firing": ["p95_over_budget"], "shed_floor": 0}),
        (1.0, {"shed_floor": None, "shed": 5}),
        (1.0, {"shed": 5, "p95_ms": 150.0}),
        (1.0, {"p95_ms": 50.0, "depth": 3}),
        (1.0, {"firing": ["queue_depth_high"]})]),
    "observe_absorbs_shed": ({"cooldown_s": 0.0}, [
        (0.0, {"shed": 7}), None, (1.0, {"shed": 7}), (1.0, {"shed": 7}),
        (1.0, {"shed": 7})]),
}


def _run_scenario(mod, rec_mod, name):
    cfg_kw, steps = _SCENARIOS[name]
    cfg = dict(min_replicas=1, max_replicas=3, scale_up_depth=10, scale_down_depth=2,
               quiesce_ticks=2, cooldown_s=5.0)
    cfg.update(cfg_kw)
    fleet, router, engine, clock = _StubFleet(), _StubRouter(), _StubEngine(), [0.0]
    rec = rec_mod.Recorder()
    scaler = mod.AutoScaler(fleet, router, "w", mod.AutoScaleConfig(**cfg), recorder=rec,
                            engine=engine, clock=lambda: clock[0])
    decisions = []
    for step in steps:
        if step is None:
            decisions.append(("observe", sorted(scaler.observe().items())))
            continue
        dt, setting = step
        clock[0] += dt
        engine.names = setting.get("firing", [])
        for attr in ("depth", "shed", "shed_floor", "p95_ms"):
            if attr in setting:
                setattr(router, attr, setting[attr])
        decisions.append(scaler.tick())
    stream = rec.rollup()["streams"].get("autoscale", {})
    recorded = (stream.get("count", 0),
                {k: v for k, v in stream.get("last", {}).items() if k not in ("t", "rel_s")})
    return (decisions, dict(scaler.events), scaler.ticks, scaler.outstanding, fleet.added,
            fleet.removed, router.attached, router.detached, recorded)


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_autoscaler_decisions_equal_reference(name):
    """The same decision list (actions, reasons, replica counts, the alerts
    firing), events, actuations and ``autoscale`` records."""
    got = _run_scenario(autoscale, recorder, name)
    want = _run_scenario(j_autoscale, j_recorder, name)
    assert got == want
    decisions, events = got[0], got[1]
    if name == "depth_pressure":
        assert [d["action"] for d in decisions] == ["scale_up", "hold"]
    if name == "cooldown_and_max":
        assert events == {"scale_up": 1, "scale_down": 0, "blocked": 3}
    if name == "lifo_scale_down":
        assert got[5] == ["w@0#r2", "w@0#r1"] and got[3] == 0  # newest first, only its own
    if name == "pressure_reasons":
        assert [d["reason"] for d in decisions[:4]] == [
            "alert:admission_overload", "shed_floor=0", "shed_delta=5", "p95_ms=150.0"]


def test_autoscale_config_validates_bounds():
    for kw in ({"min_replicas": 0}, {"min_replicas": 3, "max_replicas": 2},
               {"quiesce_ticks": 0}, {"scale_up_depth": 0}, {"scale_down_depth": -1}):
        for mod in (autoscale, j_autoscale):
            with pytest.raises(ValueError):
                mod.AutoScaleConfig(**kw)
    assert AutoScaleConfig().overload_alerts == j_autoscale.AutoScaleConfig().overload_alerts


# ---------------------------------------------------------------------------
# The closed loop on the port's fleet (the reference's tests/test_chaos.py)
# ---------------------------------------------------------------------------


def _tiny_fleet(replicas=1) -> Fleet:
    fleet = Fleet(FleetConfig(
        replicas=replicas, transport="inproc",
        serving=ServingConfig(num_chains=2, refresh_steps=8, window=16, micro_batch=8,
                              max_batch=4, seed=0, device="cpu",
                              freshness=FreshnessPolicy(max_staleness_s=1e9, min_draws=8))))
    fleet.add_workload("bayeslr", smoke=True, n_train=400, d=3, batch_size=50)
    fleet.warm()
    return fleet


def test_closed_loop_overload_scales_up_then_quiesce_scales_down(tmp_path):
    """An admission overload recorded on the slo stream fires
    ``admission_overload``; the scaler turns that alert into a scale-up
    whose replica serves bit for bit its writer; after the queue drains the
    quiesce retires exactly that replica, with the whole decision history on
    the ``autoscale`` stream."""
    fleet = _tiny_fleet(replicas=1)
    rec = Recorder(str(tmp_path), run_id="loop")
    try:
        router = FleetRouter(fleet, priorities={"predictive": 1, "vote": 0}, max_batch=4,
                             default_deadline_s=30.0, admission=AdmissionConfig(max_depth=8))
        sampler = SLOSampler(rec, router)
        engine = AlertEngine(rec, default_rules("bayeslr", "predictive", max_depth=8))
        scaler = AutoScaler(fleet, router, "bayeslr",
                            AutoScaleConfig(min_replicas=1, max_replicas=2, scale_up_depth=8,
                                            scale_down_depth=2, quiesce_ticks=2, cooldown_s=0.0),
                            recorder=rec, engine=engine)
        spec_v = fleet.spec("bayeslr", "vote")
        shed = 0
        for i in range(32):  # flood the low class until the shed floor rises
            req = router.submit("bayeslr", "vote",
                                spec_v.make_queries(torch.Generator().manual_seed(i), 2))
            shed += bool(req.error and req.error.startswith("shed"))
        assert shed >= 1
        sampler.sample()
        engine.evaluate()
        assert "admission_overload" in engine.firing()

        decision = scaler.tick()  # the alert becomes the scale-up
        assert decision["action"] == "scale_up"
        assert decision["reason"] == "alert:admission_overload"
        assert fleet.replica_count("bayeslr") == 2
        shard = fleet.shards("bayeslr")[0]
        newcomer = shard.replicas[-1]
        spec_p = fleet.spec("bayeslr", "predictive")
        xs = spec_p.make_queries(torch.Generator().manual_seed(99), 4)
        want, _ = shard.writer.query(spec_p, xs)
        got, _ = newcomer.serve(spec_p, "predictive", xs)
        np.testing.assert_array_equal(np.asarray(want), np.asarray(got))

        router.drain()  # through both lanes; then the alert resolves
        sampler.sample()
        engine.evaluate()
        assert "admission_overload" not in engine.firing()
        assert scaler.tick()["action"] == "hold"  # calm 1 of 2
        down = scaler.tick()
        assert down["action"] == "scale_down" and down["replica"] == newcomer.name
        assert fleet.replica_count("bayeslr") == 1
        assert scaler.events == {"scale_up": 1, "scale_down": 1, "blocked": 0}

        rec.close()
        assert any(e["rule"] == "admission_overload" and e["to"] == "firing"
                   for e in rec.read_stream("alerts"))
        decisions = rec.read_stream("autoscale")
        assert [d["action"] for d in decisions] == ["scale_up", "scale_down"]
        assert decisions[0]["alerts_firing"] != ""
    finally:
        rec.close()
        fleet.close()


# ---------------------------------------------------------------------------
# The front end's soak
# ---------------------------------------------------------------------------


def test_serve_front_end_soak_closes_the_loop(capsys):
    """``--fleet --soak --autoscale --alerts --smoke --soak-seconds 4
    --device cpu``: a replica killed and restarted mid-load, an overload
    burst scaled up, a quiesce scaled down, every replica bit for bit its
    writer after the chaos."""
    out: dict = {}
    args = serve.build_parser().parse_args(
        ["--fleet", "--soak", "--autoscale", "--alerts", "--smoke", "--soak-seconds", "4",
         "--stats-addr", "127.0.0.1:0", "--device", "cpu"])
    assert serve.serve_soak(args, out) == 0
    text = capsys.readouterr().out
    last = text.strip().splitlines()[-1]
    assert last.startswith("SOAK_OK workload=bayeslr") and "kills=1 recovered=1" in last
    assert "parity=ok(bitexact)" in last and "top_class_errors=0" in last
    fields = dict(f.split("=", 1) for f in last.split() if "=" in f)
    assert int(fields["scale_up"]) >= 1 and int(fields["scale_down"]) >= 1
    assert int(fields["resyncs"]) >= 1 and int(fields["alerts_fired"]) >= 1
    assert "STATS_OK " in text and "ALERTS_OK " in text
    assert out["burst_shed"] >= 1 and out["parity_ok"]
    assert len(out["replicas"]) == 2  # the scaler's replica retired, the launch ones kept


def test_serve_main_routes_soak_and_autoscale(monkeypatch):
    """``--autoscale`` implies ``--fleet``; ``--soak`` needs the fleet."""
    seen = []
    monkeypatch.setattr(serve, "serve_soak", lambda args: seen.append(("soak", args.fleet)) or 0)
    monkeypatch.setattr(serve, "serve_fleet", lambda args: seen.append(("fleet", args.fleet)) or 0)
    assert serve.main(["--soak", "--fleet"]) == 0
    assert serve.main(["--soak", "--autoscale"]) == 0
    assert serve.main(["--autoscale", "--autoscale-max", "5"]) == 0
    assert seen == [("soak", True), ("soak", True), ("fleet", True)]
    with pytest.raises(SystemExit):
        serve.main(["--soak"])


@pytest.mark.slow
def test_soak_sigkills_replica_process_and_recovers():
    """The soak over one process per replica: a live ``ReplicaProcess`` is
    SIGKILLed mid-load, the router reroutes, the respawned worker
    full-resyncs, and the run ends ``SOAK_OK`` with bit-exact writer parity
    (the reference's ``tests/test_chaos.py`` case, on the CPU)."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--fleet", "--soak", "--smoke",
         "--workload", "bayeslr", "--soak-seconds", "8", "--replica-transport", "proc",
         "--stats-addr", "127.0.0.1:0", "--device", "cpu"],
        capture_output=True, text=True, timeout=900, cwd=_REPO,
        env={**os.environ, "PYTHONPATH": "src"})
    out = proc.stdout
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{proc.stderr[-4000:]}"
    soak_line = next(line for line in out.splitlines() if line.startswith("SOAK_OK"))
    assert "kills=1" in soak_line and "recovered=1" in soak_line
    assert "top_class_errors=0" in soak_line and "parity=ok(bitexact)" in soak_line
    assert "resyncs=0" not in soak_line
    assert "STATS_OK" in out
