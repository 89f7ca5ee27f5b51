"""Declarative alerting over live :class:`~repro_torch.obs.Recorder` rollups,
the port of ``repro.obs.alerts`` (on the port's ``core.stats`` EWMA and
burn-rate helpers).

The active half of the observability layer: a set of :class:`AlertRule`\\ s
is evaluated against the recorder's incremental rollup (no stream is ever
re-read), each rule runs a pending → firing → resolved state machine with
per-rule hysteresis and cooldown, and every state *transition* is recorded
on the ``alerts`` stream — so the alert history is itself a stream, and
the autoscaler (:mod:`repro_torch.fleet.autoscale`) can trace an action back to
the alert that triggered it.

Three rule kinds:

``threshold``
    Compare one rollup aggregate (``last``/``mean``/``p50``/``p95``/...)
    of ``<stream>.<field>`` against a fixed bound, e.g.
    ``slo.p95_ms > deadline budget``.
``burn_rate``
    Multi-window SLO error-budget burn (:func:`repro_torch.core.stats.burn_rate`):
    the rule keeps short and long sliding windows of the observed bad
    fraction (``1 - field`` for good-rate metrics like
    ``deadline_hit_rate``); it breaches only when *both* windows burn the
    budget faster than ``max_burn`` — the short window catches the spike,
    the long window keeps a single bad sample from paging.
``anomaly``
    Streaming EWMA z-score (:func:`repro_torch.core.stats.ewma_zscore`) on the
    field's latest value — req/s collapses, accept-rate shifts,
    ``frac_data_touched`` drifting toward full passes, ESS regressions.
    The baseline only absorbs non-breaching observations, so a sustained
    regression keeps firing instead of teaching the baseline to accept it.

State machine per rule::

    ok ──breach──▶ pending ──for_samples breaches──▶ firing
    ▲                 │ clear                           │ clear_samples clears
    │                 ▼                                 ▼
    └───────────── resolved ◀───────────────────────────┘
        (next evaluation; re-entry within cooldown_s is suppressed)

Evaluation is pull-based — callers decide the cadence (the serve loop
ticks it alongside the :class:`~repro_torch.obs.SLOSampler`), nothing here
spawns threads or touches the request path.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

from ..core.stats import EwmaState, burn_rate, ewma_update, ewma_zscore
from .recorder import Recorder, _as_scalar

_KINDS = ("threshold", "burn_rate", "anomaly")
_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}
_SOURCES = ("last", "mean", "min", "max", "p50", "p95")
STATES = ("ok", "pending", "firing", "resolved")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative rule over ``<stream>.<field>`` of the rollup.

    Only the parameters of the rule's ``kind`` are read; the rest keep
    their defaults. ``for_samples``/``clear_samples`` are the entry/exit
    hysteresis (consecutive breaching/clear evaluations), ``cooldown_s``
    suppresses re-entry into ``pending`` after a resolve.
    """

    name: str
    stream: str
    field: str
    kind: str = "threshold"
    # threshold:
    op: str = ">"
    threshold: float = 0.0
    source: str = "last"  # which rollup aggregate to compare
    # burn_rate:
    objective: float = 0.99  # target good fraction (error budget = 1 - this)
    max_burn: float = 2.0
    short_window: int = 6  # samples, not seconds — cadence is the caller's
    long_window: int = 24
    good_metric: bool = True  # field measures goodness (bad = 1 - value)
    # anomaly:
    alpha: float = 0.3
    z_threshold: float = 4.0
    min_samples: int = 8
    direction: str = "both"  # "above" | "below" | "both"
    # state machine:
    for_samples: int = 2
    clear_samples: int = 2
    cooldown_s: float = 0.0
    severity: str = "warning"  # "info" | "warning" | "page"
    description: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown rule kind {self.kind!r}; known: {_KINDS}")
        if self.op not in _OPS:
            raise ValueError(f"unknown op {self.op!r}; known: {sorted(_OPS)}")
        if self.source not in _SOURCES:
            raise ValueError(
                f"unknown source {self.source!r}; known: {_SOURCES}"
            )
        if self.direction not in ("above", "below", "both"):
            raise ValueError(f"unknown direction {self.direction!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if self.short_window < 1 or self.long_window < self.short_window:
            raise ValueError("need 1 <= short_window <= long_window")
        if self.for_samples < 1 or self.clear_samples < 1:
            raise ValueError("for_samples and clear_samples must be >= 1")


class _RuleState:
    """Mutable evaluation state for one rule."""

    __slots__ = ("state", "breaches", "clears", "fired_count", "since_s",
                 "resolved_at", "ewma", "window", "value", "measure")

    def __init__(self):
        self.state = "ok"
        self.breaches = 0  # consecutive breaching evaluations
        self.clears = 0  # consecutive clear evaluations while firing
        self.fired_count = 0
        self.since_s: float | None = None  # clock() of the last transition
        self.resolved_at: float | None = None
        self.ewma = EwmaState(0, 0.0, 0.0)
        self.window: deque[float] = deque()
        self.value: float | None = None  # last observed field value
        self.measure: float | None = None  # z-score / burn rate / value


class AlertEngine:
    """Evaluate a ruleset against rollups; record transitions to a stream."""

    def __init__(self, recorder: Recorder | None, rules, *,
                 stream: str = "alerts", clock=time.monotonic):
        rules = tuple(rules)
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names in {names}")
        self.recorder = recorder
        self.rules = rules
        self.stream = stream
        self.clock = clock
        self.evaluations = 0
        self.transitions = 0
        self.fired_total = 0
        self.resolved_total = 0
        self._states = {r.name: _RuleState() for r in rules}

    # -- signal extraction ---------------------------------------------------

    @staticmethod
    def _field_value(rule: AlertRule, rollup: dict) -> float | None:
        stream = rollup.get("streams", {}).get(rule.stream)
        if not stream:
            return None
        agg = stream.get("fields", {}).get(rule.field)
        if not agg:
            return None
        return _as_scalar(agg.get(rule.source))

    def _breach(self, rule: AlertRule, st: _RuleState, value: float
                ) -> tuple[bool, float]:
        """(is the signal breaching, the measured statistic)."""
        if rule.kind == "threshold":
            return _OPS[rule.op](value, rule.threshold), value
        if rule.kind == "burn_rate":
            bad = (1.0 - value) if rule.good_metric else value
            st.window.append(float(bad))
            while len(st.window) > rule.long_window:
                st.window.popleft()
            if len(st.window) < rule.short_window:
                return False, 0.0
            budget = 1.0 - rule.objective
            short = list(st.window)[-rule.short_window:]
            fast = burn_rate(sum(short) / len(short), budget)
            slow = burn_rate(sum(st.window) / len(st.window), budget)
            return (fast > rule.max_burn and slow > rule.max_burn), fast
        # anomaly
        z = ewma_zscore(st.ewma, value)
        breach = st.ewma.count >= rule.min_samples and (
            (rule.direction in ("above", "both") and z > rule.z_threshold)
            or (rule.direction in ("below", "both") and z < -rule.z_threshold)
        )
        if not breach:
            # Only a non-anomalous observation teaches the baseline, so a
            # sustained regression keeps firing instead of being absorbed.
            st.ewma = ewma_update(st.ewma, value, rule.alpha)
        return breach, z

    # -- state machine -------------------------------------------------------

    def _transition(self, rule: AlertRule, st: _RuleState, to: str,
                    now: float) -> dict:
        event = {
            "rule": rule.name,
            "from": st.state,
            "to": to,
            "kind": rule.kind,
            "severity": rule.severity,
            "stream": rule.stream,
            "field": rule.field,
            "value": st.value,
            "measure": st.measure,
        }
        st.state = to
        st.since_s = now
        self.transitions += 1
        if to == "firing":
            st.fired_count += 1
            self.fired_total += 1
        if to == "resolved":
            st.resolved_at = now
            self.resolved_total += 1
        if self.recorder is not None:
            self.recorder.record(self.stream, event)
        return event

    def evaluate(self, rollup: dict | None = None) -> list[dict]:
        """One evaluation pass; returns the state transitions it caused
        (each already recorded on the ``alerts`` stream)."""
        if rollup is None:
            if self.recorder is None:
                raise ValueError("no rollup given and no recorder attached")
            rollup = self.recorder.rollup()
        now = self.clock()
        self.evaluations += 1
        events: list[dict] = []
        for rule in self.rules:
            st = self._states[rule.name]
            if st.state == "resolved":
                # "resolved" is held for exactly one evaluation so readers
                # of /alerts see it; then the rule returns to ok.
                events.append(self._transition(rule, st, "ok", now))
            value = self._field_value(rule, rollup)
            if value is None:
                continue  # stream/field not recorded yet: state untouched
            st.value = value
            breach, st.measure = self._breach(rule, st, value)
            if breach:
                st.clears = 0
                st.breaches += 1
                if st.state == "ok":
                    if st.resolved_at is not None and rule.cooldown_s > 0 \
                            and now - st.resolved_at < rule.cooldown_s:
                        continue  # re-entry suppressed by cooldown
                    st.breaches = 1
                    events.append(self._transition(rule, st, "pending", now))
                if st.state == "pending" and st.breaches >= rule.for_samples:
                    events.append(self._transition(rule, st, "firing", now))
            else:
                st.breaches = 0
                if st.state == "pending":
                    events.append(self._transition(rule, st, "ok", now))
                elif st.state == "firing":
                    st.clears += 1
                    if st.clears >= rule.clear_samples:
                        st.clears = 0
                        events.append(
                            self._transition(rule, st, "resolved", now)
                        )
        return events

    # -- views ---------------------------------------------------------------

    def firing(self) -> list[str]:
        """Names of the rules currently firing."""
        return [n for n, st in self._states.items() if st.state == "firing"]

    def state(self, rule_name: str) -> str:
        return self._states[rule_name].state

    def status(self) -> dict:
        """The ``/alerts`` endpoint payload: per-rule state + engine
        counters."""
        now = self.clock()
        rules = {}
        for rule in self.rules:
            st = self._states[rule.name]
            rules[rule.name] = {
                "state": st.state,
                "kind": rule.kind,
                "severity": rule.severity,
                "stream": rule.stream,
                "field": rule.field,
                "value": st.value,
                "measure": st.measure,
                "fired_count": st.fired_count,
                "since_s": None if st.since_s is None else now - st.since_s,
                "description": rule.description,
            }
        return {
            "available": True,
            "rules": rules,
            "firing": self.firing(),
            "evaluations": self.evaluations,
            "transitions": self.transitions,
            "fired_total": self.fired_total,
            "resolved_total": self.resolved_total,
        }


def default_rules(workload: str, default_class: str, *,
                  deadline_ms: float = 250.0,
                  max_depth: int = 256) -> tuple[AlertRule, ...]:
    """The serve front-end's standard ruleset over the streams the
    :mod:`repro_torch.obs.sources` adapters already record.

    ``admission_overload`` / ``queue_depth_high`` are the overload pair the
    autoscaler treats as scale-up triggers (see
    :class:`repro_torch.fleet.autoscale.AutoScaleConfig.overload_alerts`);
    ``sublinear_regression`` / ``rhat_regression`` watch the paper's
    accuracy-vs-cost contract itself.
    """
    cls = f"{workload}.{default_class}"
    return (
        AlertRule(
            name="p95_over_budget", stream="slo", field="p95_ms",
            kind="threshold", op=">", threshold=float(deadline_ms),
            for_samples=2, clear_samples=2, severity="page",
            description="worst-class p95 above the deadline budget",
        ),
        AlertRule(
            name="admission_overload", stream="slo",
            field="admission_shed_floor", kind="threshold", op=">=",
            threshold=0.0, for_samples=1, clear_samples=1, severity="page",
            description="the admission shed floor is active (load is being "
                        "refused)",
        ),
        AlertRule(
            name="queue_depth_high", stream="slo", field="admission_depth",
            kind="threshold", op=">=", threshold=float(max_depth),
            for_samples=1, clear_samples=1, severity="warning",
            description="router backlog at/above the admission depth bound",
        ),
        AlertRule(
            name="deadline_burn", stream="slo",
            field=f"{cls}.deadline_hit_rate", kind="burn_rate",
            objective=0.9, max_burn=1.5, short_window=3, long_window=12,
            for_samples=1, clear_samples=2, severity="page",
            description="top-class deadline error budget burning >1.5x "
                        "over both windows",
        ),
        AlertRule(
            name="req_rate_anomaly", stream="slo", field="req_per_s",
            kind="anomaly", z_threshold=4.0, min_samples=8,
            direction="below", for_samples=2, clear_samples=2,
            description="request throughput collapsed vs its EWMA baseline",
        ),
        AlertRule(
            name="accept_rate_anomaly", stream="refresh",
            field="accept_rate", kind="anomaly", z_threshold=4.0,
            min_samples=8, direction="both", for_samples=2, clear_samples=2,
            description="MH acceptance rate shifted vs its EWMA baseline",
        ),
        AlertRule(
            name="sublinear_regression", stream="transition_cost",
            field="frac_data_touched", kind="threshold", op=">=",
            threshold=0.999, for_samples=2, clear_samples=2,
            severity="warning",
            description="transitions degraded to full data passes "
                        "(sublinearity lost)",
        ),
        AlertRule(
            name="rhat_regression", stream="snapshot", field="rhat",
            kind="threshold", op=">", threshold=1.2, for_samples=2,
            clear_samples=2, severity="warning",
            description="window split R-hat above 1.2: chains diverging",
        ),
        AlertRule(
            name="ess_anomaly", stream="snapshot", field="ess",
            kind="anomaly", z_threshold=4.0, min_samples=8,
            direction="below", for_samples=2, clear_samples=2,
            description="window ESS collapsed vs its EWMA baseline",
        ),
    )
