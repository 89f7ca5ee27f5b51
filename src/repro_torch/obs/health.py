"""Component health scoring over the recorder's rollup, the port of
``repro.obs.health`` (pure Python, as there).

One number per subsystem in [0, 1] plus an overall grade — what the
``/health`` endpoint serves and what a fleet operator (or the chaos soak)
reads to decide whether the service is actually OK. Nothing here samples
anything: every score is derived from the **rollup** the
:mod:`repro_torch.obs.sources` adapters already maintain, optionally joined with
a live ``Fleet.report()`` for per-replica liveness.

Components (each scored independently, missing signals score as healthy —
absence of a stream means the subsystem isn't in play, not that it is
broken):

``queue``      admission state: active shed floor / backlog vs ``max_depth``
``router``     lane recovery state: dead lanes now, deaths observed
``replicas``   per-replica liveness + version lag vs the writer (needs a
               ``Fleet.report()``)
``writer``     window convergence: split R-hat and draw depth
``sublinear``  the paper's contract: mean ``frac_data_touched`` < 1.0

Grades: ``ok`` >= 0.8, ``degraded`` >= 0.5, else ``critical``. The overall
score is the *minimum* component score — health is a conjunction; averaging
would let a dead replica pool hide behind a healthy queue.
"""
from __future__ import annotations


def _grade(score: float) -> str:
    if score >= 0.8:
        return "ok"
    if score >= 0.5:
        return "degraded"
    return "critical"


def _last(rollup: dict, stream: str) -> dict:
    return rollup.get("streams", {}).get(stream, {}).get("last", {})


def _fields(rollup: dict, stream: str) -> dict:
    return rollup.get("streams", {}).get(stream, {}).get("fields", {})


def _component(score: float, **detail) -> dict:
    score = max(0.0, min(1.0, float(score)))
    return {"score": score, "status": _grade(score), **detail}


def _queue_health(rollup: dict, max_depth: int | None) -> dict:
    slo = _last(rollup, "slo")
    floor = slo.get("admission_shed_floor", -1)
    depth = slo.get("admission_depth", 0) or 0
    score = 1.0
    if isinstance(floor, (int, float)) and floor >= 0:
        score = 0.4  # actively shedding: degraded by definition
    elif max_depth:
        # Linear pressure penalty as the backlog approaches the shed point.
        score = 1.0 - 0.5 * min(float(depth) / float(max_depth), 1.0)
    return _component(score, depth=depth, shed_floor=floor,
                      shed_total=slo.get("shed", 0))


def _router_health(rollup: dict) -> dict:
    slo = _last(rollup, "slo")
    dead = slo.get("dead_lanes", 0) or 0
    deaths = slo.get("lane_deaths", 0) or 0
    score = 1.0
    if dead:
        score = 0.3  # a lane is down *right now*
    elif deaths:
        score = 0.9  # recovered from deaths: slightly scarred, serving
    return _component(score, dead_lanes=dead, lane_deaths=deaths,
                      rerouted=slo.get("rerouted", 0))


def _replica_health(fleet_report: dict | None) -> dict:
    if not fleet_report:
        return _component(1.0, available=False)
    shards = fleet_report.get("shards", {})
    total = alive = 0
    max_lag = 0
    for shard in shards.values():
        steps = shard.get("writer_steps", 0)
        for stats in shard.get("replicas", []):
            total += 1
            ok = stats.get("alive", True)
            alive += int(bool(ok))
        for version in shard.get("replica_versions", []):
            max_lag = max(max_lag, int(steps) - int(version))
    if not total:
        return _component(1.0, available=False)
    score = alive / total
    if max_lag > 0 and score > 0.0:
        # Replicas alive but trailing the writer: mild staleness penalty,
        # saturating — a stuck delta stream reads as degraded, not critical.
        score *= max(0.6, 1.0 - 0.001 * max_lag)
    sync_errors = len(fleet_report.get("errors", {}))
    if sync_errors:
        score = min(score, 0.7)
    return _component(score, replicas=total, alive=alive, max_version_lag=max_lag,
                      sync_errors=sync_errors)


def _writer_health(rollup: dict) -> dict:
    snap = _last(rollup, "snapshot")
    rhat = snap.get("rhat")
    draws = snap.get("num_draws", 0)
    score = 1.0
    if isinstance(rhat, (int, float)):
        if rhat > 1.5:
            score = 0.3
        elif rhat > 1.2:
            score = 0.6
        elif rhat > 1.1:
            score = 0.9
    return _component(score, rhat=rhat, num_draws=draws,
                      ess=snap.get("ess"))


def _sublinear_health(rollup: dict) -> dict:
    agg = _fields(rollup, "transition_cost").get("frac_data_touched")
    if not agg:
        return _component(1.0, available=False)
    mean = float(agg.get("mean", 0.0))
    # frac == 1.0 means every transition touched all the data — the
    # sublinearity contract is gone, not merely degraded.
    score = 1.0 if mean < 0.9 else (0.6 if mean < 0.999 else 0.2)
    return _component(score, frac_data_touched_mean=mean,
                      samples=int(agg.get("count", 0)))


def health_report(rollup: dict, *, fleet_report: dict | None = None,
                  alert_status: dict | None = None,
                  max_depth: int | None = None) -> dict:
    """The ``/health`` payload: per-component scores, the min-score
    overall grade, and (when an alert engine is attached) the firing
    alerts dragging the grade down — a page-severity alert caps the
    overall score at ``degraded``."""
    components = {
        "queue": _queue_health(rollup, max_depth),
        "router": _router_health(rollup),
        "replicas": _replica_health(fleet_report),
        "writer": _writer_health(rollup),
        "sublinear": _sublinear_health(rollup),
    }
    score = min(c["score"] for c in components.values())
    firing: list[str] = []
    if alert_status and alert_status.get("firing"):
        firing = list(alert_status["firing"])
        severities = {
            name: alert_status.get("rules", {}).get(name, {}).get("severity")
            for name in firing
        }
        cap = 0.4 if "page" in severities.values() else 0.7
        score = min(score, cap)
    return {
        "score": score,
        "status": _grade(score),
        "components": components,
        "firing": firing,
        "run_id": rollup.get("run_id"),
        "uptime_s": rollup.get("uptime_s"),
    }
