"""Obs-driven replica autoscaling: the closed loop from signals to fleet,
the port of ``repro.fleet.autoscale`` (pure Python over the port's fleet
and router).

An :class:`AutoScaler` is a pull-based control loop over the signals the
observability layer already records — router queue depth, shed/admission
counters, worst-class p95 — plus (optionally) the firing set of an
:class:`~repro_torch.obs.alerts.AlertEngine`, actuating through
:meth:`repro_torch.fleet.Fleet.add_replica` /
:meth:`repro_torch.fleet.Fleet.remove_replica` and
:meth:`repro_torch.fleet.FleetRouter.attach_lane` /
:meth:`~repro_torch.fleet.FleetRouter.detach_lane`::

    streams (slo/admission) ──▶ AlertEngine ──▶ firing("admission_overload")
                 │                                   │
                 ▼                                   ▼
    router.slo_report() ────────────────▶ AutoScaler.tick()
                                            │ scale_up:   Fleet.add_replica
                                            │             (full resync join)
                                            │             router.attach_lane
                                            │ scale_down: router.detach_lane
                                            │             Fleet.remove_replica
                                            ▼
                                          `autoscale` stream (every decision,
                                          with the alert that triggered it)

Like the :class:`~repro_torch.obs.SLOSampler`, nothing here owns a thread: the
serve loop calls :meth:`AutoScaler.tick` at its sampling cadence, so with
``--autoscale`` off the object is never built and the request path is
untouched.

Scale-down only retires replicas this scaler added (newest first), never a
launch-time replica — the operator's configured floor is the floor.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass(frozen=True)
class AutoScaleConfig:
    """Control-loop thresholds and bounds.

    Scale **up** when any pressure signal trips: router depth at/above
    ``scale_up_depth``, new sheds since the last tick, an active admission
    shed floor, worst-class p95 above ``scale_up_p95_ms`` (when set), or an
    ``overload_alerts`` rule firing. Scale **down** only after
    ``quiesce_ticks`` consecutive calm ticks (depth at/below
    ``scale_down_depth``, no pressure). ``cooldown_s`` spaces *any* two
    actuations — a scale-up is never followed by a flapping scale-down one
    tick later.
    """

    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_depth: int = 64
    scale_up_p95_ms: float | None = None
    scale_down_depth: int = 4
    quiesce_ticks: int = 3
    cooldown_s: float = 5.0
    # Only *instantaneous* overload rules belong here: the router's p95 is
    # cumulative over the completion history, so a latency alert keeps
    # firing long after the overload drained and would pin the pool at max
    # (p95-based scaling is opt-in via scale_up_p95_ms, which reads the
    # live report, not an alert).
    overload_alerts: tuple[str, ...] = (
        "admission_overload", "queue_depth_high",
    )

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.scale_up_depth < 1 or self.scale_down_depth < 0:
            raise ValueError("bad depth thresholds")
        if self.quiesce_ticks < 1:
            raise ValueError("quiesce_ticks must be >= 1")


class AutoScaler:
    """Scale one workload's replica pool from its observed load."""

    def __init__(self, fleet, router, workload: str,
                 config: AutoScaleConfig | None = None, *,
                 recorder=None, engine=None, clock=time.monotonic):
        self.fleet = fleet
        self.router = router
        self.workload = workload
        self.config = config or AutoScaleConfig()
        self.recorder = recorder  # decisions land on the `autoscale` stream
        self.engine = engine  # optional AlertEngine: alert-to-action link
        self.clock = clock
        self.events = {"scale_up": 0, "scale_down": 0, "blocked": 0}
        self.ticks = 0
        self._added: list[str] = []  # replica names we spawned (LIFO retire)
        self._last_action_s: float | None = None
        self._last_shed = 0
        self._calm = 0

    @property
    def outstanding(self) -> int:
        """Replicas this scaler has added and not yet retired."""
        return len(self._added)

    def observe(self) -> dict:
        """Read the signals without acting. Refreshes the shed-delta
        baseline — call before a quiesce phase so sheds from an already-
        handled burst don't read as fresh pressure on the next tick."""
        return self._signals()

    # -- signal read-out -----------------------------------------------------

    def _signals(self) -> dict:
        report = self.router.slo_report()
        adm = report.get("admission") or {}
        p95s = [
            entry.get("p95_ms")
            for entry in report.get("classes", {}).values()
            if entry.get("p95_ms") is not None
        ]
        shed = report.get("shed", 0)
        shed_delta = max(shed - self._last_shed, 0)
        self._last_shed = shed
        firing = set(self.engine.firing()) if self.engine is not None else set()
        return {
            "depth": adm.get("depth", 0),
            "shed_floor": adm.get("shed_floor"),
            "shed_delta": shed_delta,
            "p95_ms": max(p95s) if p95s else None,
            "firing": firing,
        }

    def _pressure(self, sig: dict) -> str | None:
        """The first pressure reason tripping, or None when calm."""
        cfg = self.config
        overload = sorted(sig["firing"] & set(cfg.overload_alerts))
        if overload:
            return f"alert:{overload[0]}"
        if sig["shed_floor"] is not None:
            return f"shed_floor={sig['shed_floor']}"
        if sig["shed_delta"]:
            return f"shed_delta={sig['shed_delta']}"
        if sig["depth"] >= cfg.scale_up_depth:
            return f"depth={sig['depth']}"
        if cfg.scale_up_p95_ms is not None and sig["p95_ms"] is not None \
                and sig["p95_ms"] > cfg.scale_up_p95_ms:
            return f"p95_ms={sig['p95_ms']:.1f}"
        return None

    def _cooled(self, now: float) -> bool:
        return (self._last_action_s is None
                or now - self._last_action_s >= self.config.cooldown_s)

    # -- the control loop ----------------------------------------------------

    def tick(self) -> dict:
        """One control-loop pass: read signals, maybe actuate. Returns the
        decision record (``action`` of ``scale_up`` / ``scale_down`` /
        ``hold``). Actuations and *blocked* intents (pressure with the pool
        at max, or inside cooldown) are recorded on the ``autoscale``
        stream; calm holds are not — the stream is a decision history, not
        a heartbeat."""
        self.ticks += 1
        cfg = self.config
        sig = self._signals()
        now = self.clock()
        n = self.fleet.replica_count(self.workload)
        reason = self._pressure(sig)
        decision = {
            "action": "hold",
            "reason": reason or "calm",
            "replicas_before": n,
            "replicas_after": n,
            "depth": sig["depth"],
            "shed_delta": sig["shed_delta"],
            "p95_ms": sig["p95_ms"],
            "alerts_firing": ",".join(sorted(sig["firing"])),
        }
        record = False
        if reason is not None:
            self._calm = 0
            if n >= cfg.max_replicas:
                decision["reason"] = f"{reason} (blocked: at max_replicas)"
                self.events["blocked"] += 1
                record = True
            elif not self._cooled(now):
                decision["reason"] = f"{reason} (blocked: cooldown)"
                self.events["blocked"] += 1
                record = True
            else:
                shard, replica = self.fleet.add_replica(self.workload)
                self.router.attach_lane(shard, replica)
                self._added.append(replica.name)
                self._last_action_s = now
                self.events["scale_up"] += 1
                decision.update(action="scale_up", replica=replica.name,
                                replicas_after=n + 1)
                record = True
        else:
            calm = sig["depth"] <= cfg.scale_down_depth
            self._calm = self._calm + 1 if calm else 0
            if (self._calm >= cfg.quiesce_ticks and self._added
                    and n > cfg.min_replicas and self._cooled(now)):
                name = self._added.pop()
                self.router.detach_lane(self.workload, name)
                self.fleet.remove_replica(self.workload, replica_name=name)
                self._last_action_s = now
                self._calm = 0
                self.events["scale_down"] += 1
                decision.update(action="scale_down", replica=name,
                                replicas_after=n - 1,
                                reason=f"quiesce ({cfg.quiesce_ticks} calm "
                                       f"ticks)")
                record = True
        if record and self.recorder is not None:
            self.recorder.record("autoscale", decision)
        return decision
