"""Adapters from the port's signal sources into a Recorder, the port of
``repro.obs.sources``.

Nothing here computes new statistics — each adapter samples a surface that
already exists (``slo_report()``, ``Snapshot``, ``Fleet.sync_stats``,
``ensemble_summary`` adaptation traces, ``run_timed(on_block=)``) and
flattens it into one record on a named stream, so a run's whole signal set
lands in one place instead of vanishing with the process:

====================  =====================================================
stream                source
====================  =====================================================
``slo``               :class:`SLOSampler` over a RequestQueue/FleetRouter
``admission``         shed-floor *transitions* (same sampler)
``snapshot``          :func:`record_snapshot` — staleness, R-hat, window ESS
``adaptation``        :func:`record_adaptation` — epsilon/batch/sigma traces
``fleet``             :func:`record_fleet_sync` — delta-vs-full byte accounting
``refresh``           :func:`make_on_block` — per-block transition throughput
``transition_cost``   :func:`record_transition_cost` — fraction of data
                      touched per transition (the live sublinear evidence)
====================  =====================================================
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .._device import tree_leaves
from .recorder import Recorder, _as_scalar

# Per-class fields lifted into the flattened slo record.
_CLASS_FIELDS = (
    "count", "errors", "admitted", "shed", "priority",
    "p50_ms", "p95_ms", "p99_ms", "deadline_hit_rate",
    "mean_batch_size", "staleness_mean_s",
)


class SLOSampler:
    """Periodically flatten a queue's / router's unified ``slo_report()``
    into the ``slo`` stream.

    Derives interval request throughput (``req_per_s``) from the completion
    count delta between consecutive samples, lifts the worst per-class tail
    into top-level ``p95_ms``/``staleness_mean_s`` (the single numbers the
    stats endpoint check and the soak harness read), and records admission
    *state transitions* (shed-floor changes) on the ``admission`` stream.
    """

    def __init__(self, recorder: Recorder, source, stream: str = "slo"):
        self.recorder = recorder
        self.source = source  # anything with .slo_report()
        self.stream = stream
        self._prev: tuple[float, int] | None = None
        self._last_floor: object = "__unset__"

    def sample(self) -> dict:
        report = self.source.slo_report()
        now = time.monotonic()
        rec: dict = {
            "count": report["count"],
            "errors": report["errors"],
            "shed": report.get("shed", 0),
        }
        if self._prev is not None:
            dt = now - self._prev[0]
            delta = report["count"] - self._prev[1]
            if delta < 0:
                # The source's completion counters went backwards — a
                # router rebuild or pool restart reset them. A negative
                # delta would poison the req_per_s aggregates, so clamp to
                # zero and leave an explicit marker record instead.
                self.recorder.record(self.stream, {
                    "counter_reset": True,
                    "count_before": self._prev[1],
                    "count_after": report["count"],
                })
                delta = 0
            rec["req_per_s"] = delta / dt if dt > 0 else 0.0
        self._prev = (now, report["count"])
        admission = report.get("admission")
        if admission:
            rec["admission_depth"] = admission["depth"]
            rec["admission_miss_rate"] = admission["predicted_miss_rate"]
            floor = admission["shed_floor"]
            rec["admission_shed_floor"] = -1 if floor is None else floor
            if floor != self._last_floor:
                if self._last_floor != "__unset__":
                    self.recorder.record("admission", {
                        "shed_floor": -1 if floor is None else floor,
                        "depth": admission["depth"],
                        "predicted_miss_rate": admission["predicted_miss_rate"],
                    })
                self._last_floor = floor
        recovery = report.get("recovery")
        if recovery:
            rec["lane_deaths"] = recovery["lane_deaths"]
            rec["rerouted"] = recovery["rerouted"]
            rec["dead_lanes"] = recovery["dead_lanes"]
        p95s, stales = [], []
        for cls, entry in report["classes"].items():
            for field in _CLASS_FIELDS:
                value = entry.get(field)
                if value is not None:
                    rec[f"{cls}.{field}"] = value
            if entry.get("p95_ms") is not None:
                p95s.append(entry["p95_ms"])
            if entry.get("staleness_mean_s") is not None:
                stales.append(entry["staleness_mean_s"])
        if p95s:
            rec["p95_ms"] = float(max(p95s))  # worst class tail
        if stales:
            rec["staleness_mean_s"] = float(max(stales))
        self.recorder.record(self.stream, rec)
        return rec


def record_snapshot(recorder: Recorder, name: str, snap,
                    stream: str = "snapshot") -> dict:
    """One ``snapshot`` record from a Snapshot (resident, pool, or replica
    view): staleness, window size, and — when the window is deep enough —
    the split-R-hat and cross-chain window ESS freshness diagnostics."""
    from ..serving.pool import snapshot_ess, snapshot_rhat

    rec: dict = {
        "workload": name,
        "staleness_s": snap.staleness_s,
        "num_draws": snap.num_draws,
        "steps_done": snap.steps_done,
    }
    if snap.draws is not None:
        rhat = snapshot_rhat(snap)
        if rhat is not None:
            rec["rhat"] = rhat
        rec["ess"] = snapshot_ess(snap)
    return recorder.record(stream, rec)


def record_adaptation(recorder: Recorder, name: str, summary: dict,
                      stream: str = "adaptation") -> dict | None:
    """One ``adaptation`` record from an ``ensemble_summary`` dict (a
    snapshot's ``summary``): the schedule controller's epsilon / effective
    batch / acceptance traces, flattened to scalars (per-chain arrays are
    recorded as their ensemble mean; nested dicts get dotted keys)."""
    if not summary:
        return None
    rec: dict = {"workload": name}

    def put(prefix: str, mapping: dict) -> None:
        for key, value in mapping.items():
            if isinstance(value, dict):
                put(f"{prefix}{key}.", value)
                continue
            if isinstance(value, torch.Tensor):  # to the host, as numpy
                value = value.detach().cpu().numpy()
                value = value[()] if value.ndim == 0 else value
            if _as_scalar(value) is not None:
                rec[f"{prefix}{key}"] = float(value)
            elif isinstance(value, np.ndarray) and value.dtype.kind in "fiub" \
                    and value.size and not prefix:
                # Per-chain top-level traces (accept_rate, final_epsilon, ...);
                # nested arrays (histogram edges etc.) are not metrics.
                rec[f"{key}_mean"] = float(np.mean(value))

    put("", summary)
    if len(rec) == 1:  # nothing numeric — don't write an empty record
        return None
    return recorder.record(stream, rec)


def record_fleet_sync(recorder: Recorder, fleet, stream: str = "fleet") -> dict:
    """One ``fleet`` record: the cumulative delta-vs-full byte accounting
    (``Fleet.sync_stats``) plus per-shard writer/replica progress."""
    sync = dict(fleet.sync_stats)
    rec: dict = dict(sync)
    rec["delta_ratio"] = (
        sync["delta_wire_bytes"] / max(sync["full_wire_bytes"], 1)
    )
    report = fleet.report()
    for shard_name, shard in report["shards"].items():
        rec[f"{shard_name}.writer_steps"] = shard["writer_steps"]
        rec[f"{shard_name}.min_replica_version"] = (
            min(shard["replica_versions"]) if shard["replica_versions"] else 0
        )
    rec["sync_errors"] = len(report["errors"])
    return recorder.record(stream, rec)


def record_transition_cost(recorder: Recorder, name: str, summary: dict,
                           num_sections=None,
                           stream: str = "transition_cost") -> dict | None:
    """One ``transition_cost`` record from a snapshot's ``summary``: the
    live sublinear-cost evidence, per refresh block.

    ``summary`` is what :func:`repro_torch.core.stats.ensemble_summary` returns
    (already on every :class:`~repro_torch.serving.resident.Snapshot`), either a
    single-op dict carrying ``mean_n_evaluated_overall`` or — for
    ``cycle()`` transitions — a dict of such summaries keyed by component
    op name. ``num_sections`` is the partitioned target's section count
    (an ``{op_name: count}`` dict for composites); when known, each op's
    ``frac_data_touched`` = sections evaluated / sections total is the
    paper's headline ratio — strictly below 1.0 means the transition is
    genuinely sublinear. The top-level ``frac_data_touched`` of a
    composite record is the mean across its subsampled ops."""
    def num(v):  # a Python number, or a 0-d tensor read on the host
        if isinstance(v, torch.Tensor) and v.ndim == 0:
            return v.item()
        return v

    def one(prefix: str, s: dict, ns) -> float | None:
        ne = num(s.get("mean_n_evaluated_overall"))
        if not isinstance(ne, (int, float)):
            return None
        rec[f"{prefix}mean_n_evaluated"] = float(ne)
        rounds = num(s.get("mean_rounds_overall"))
        if isinstance(rounds, (int, float)):
            rec[f"{prefix}mean_rounds"] = float(rounds)
        if ns:
            rec[f"{prefix}num_sections"] = int(ns)
            frac = float(ne) / float(ns)
            rec[f"{prefix}frac_data_touched"] = frac
            return frac
        return None

    rec: dict = {"workload": name}
    if "mean_n_evaluated_overall" in summary:
        one("", summary, num_sections)
    else:  # composite: {op_name: ensemble_summary}
        fracs = []
        for op, s in summary.items():
            if not isinstance(s, dict):
                continue
            ns = num_sections.get(op) if isinstance(num_sections, dict) \
                else num_sections
            frac = one(f"{op}.", s, ns)
            if frac is not None:
                fracs.append(frac)
        if fracs:
            rec["frac_data_touched"] = float(np.mean(fracs))
    if len(rec) == 1:  # no subsampled op anywhere — nothing to record
        return None
    return recorder.record(stream, rec)


_INFO_FIELDS = ("accepted", "n_evaluated", "epsilon", "batch_eff")


def _host_fields(infos) -> dict[str, np.ndarray]:
    """The ``_INFO_FIELDS`` that ``infos`` carries, as host numpy arrays of
    their own dtypes, in one device-to-host copy: the fields' bytes are
    joined on the device and split again on the host, so a block on the
    card pays one synchronisation, not one a field."""
    names = [f for f in _INFO_FIELDS if hasattr(infos, f)]
    fields = [getattr(infos, f) for f in names]
    if not any(isinstance(t, torch.Tensor) for t in fields):
        return {f: np.asarray(t) for f, t in zip(names, fields)}
    fields = [torch.as_tensor(t).detach().contiguous() for t in fields]
    raw = torch.cat([t.reshape(-1).view(torch.uint8) for t in fields]).cpu().numpy()
    out, at = {}, 0
    for f, t in zip(names, fields):
        n = t.numel() * t.element_size()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out[f] = raw[at:at + n].view(dtype).reshape(tuple(t.shape))
        at += n
    return out


def make_on_block(recorder: Recorder, name: str = "",
                  stream: str = "refresh"):
    """An ``on_block`` hook for :meth:`ChainEnsemble.run_timed`: records
    each block's transition throughput and acceptance/adaptation state on
    the ``refresh`` stream. The hook keeps its own clock, so throughput is
    per block, not cumulative. K is the first sample leaf's leading size;
    the infos come to the host once a block (:func:`_host_fields`)."""
    state = {"t": None, "step": None}

    def on_block(_state, samples, infos, steps_done) -> None:
        now = time.monotonic()
        leaves = tree_leaves(samples)
        k = int(leaves[0].shape[0]) if leaves else 1
        rec: dict = {"steps_done": int(steps_done)}
        if name:
            rec["workload"] = name
        if state["t"] is not None and steps_done > state["step"]:
            dt = now - state["t"]
            if dt > 0:
                rec["transitions_per_sec"] = (
                    (steps_done - state["step"]) * k / dt
                )
        state["t"], state["step"] = now, steps_done
        host = _host_fields(infos)
        if "accepted" in host:
            rec["accept_rate"] = float(np.mean(host["accepted"]))
        if "n_evaluated" in host:
            rec["mean_n_evaluated"] = float(np.mean(host["n_evaluated"]))
        for field in ("epsilon", "batch_eff"):
            if field in host:
                rec[f"mean_{field}"] = float(np.mean(host[field]))
        recorder.record(stream, rec)

    return on_block
