"""One-shot terminal summary of a recorded run directory, the port of
``repro.obs.dash``: the same text from the same run directory.

``python -m repro_torch.obs.dash <obs-dir>/<run-id>`` renders the headlines of a
finished (or crashed) run from its on-disk artifacts alone — no live
endpoint required — so a soak/CI artifact is inspectable straight from the
download:

* rollup headlines (uptime, per-stream counts, req/s, worst p95, shed)
* the sublinear fraction (``transition_cost``), the paper's live evidence
* the per-stage latency table when ``spans.jsonl`` was recorded
* alert history: rules that fired, and anything still firing at exit

The rollup comes from ``summary.json`` when the recorder closed cleanly;
otherwise it is rebuilt by folding the raw ``*.jsonl`` streams through the
same per-field aggregation the live rollup uses — a crashed run still
renders.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .recorder import _as_scalar, _FieldAgg


def load_rollup(run_dir: str) -> dict:
    """``summary.json`` if the run closed cleanly, else a rollup rebuilt
    from the stream files."""
    summary = os.path.join(run_dir, "summary.json")
    if os.path.exists(summary):
        with open(summary) as f:
            return json.load(f)
    streams: dict = {}
    for fname in sorted(os.listdir(run_dir)):
        if not fname.endswith(".jsonl"):
            continue
        name = fname[: -len(".jsonl")]
        agg: dict = {"count": 0, "fields": {}, "last": {}}
        for rec in read_stream(run_dir, name):
            agg["count"] += 1
            agg["last"] = rec
            for field, value in rec.items():
                v = _as_scalar(value)
                if v is not None:
                    agg["fields"].setdefault(field, _FieldAgg()).add(v)
        if agg["count"]:
            streams[name] = {
                "count": agg["count"],
                "last": agg["last"],
                "fields": {f: a.summary()
                           for f, a in agg["fields"].items()},
            }
    meta: dict = {}
    meta_path = os.path.join(run_dir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    last_rel = max(
        (s["last"].get("rel_s", 0.0) for s in streams.values()), default=0.0
    )
    return {"run_id": meta.get("run_id", os.path.basename(run_dir)),
            "uptime_s": last_rel, "meta": meta, "streams": streams}


def read_stream(run_dir: str, stream: str) -> list[dict]:
    path = os.path.join(run_dir, f"{stream}.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _fmt(value, spec: str = ".2f") -> str:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return "n/a" if value is None else str(value)
    return format(value, spec)


def _headlines(rollup: dict, out) -> None:
    streams = rollup.get("streams", {})
    print(f"run {rollup.get('run_id')}  "
          f"uptime={_fmt(rollup.get('uptime_s'), '.1f')}s  "
          f"streams={len(streams)}", file=out)
    counts = "  ".join(f"{n}={s.get('count', 0)}"
                       for n, s in sorted(streams.items()))
    if counts:
        print(f"  records: {counts}", file=out)
    slo = streams.get("slo", {})
    if slo:
        f = slo.get("fields", {})
        last = slo.get("last", {})
        print(f"  slo: req_per_s~{_fmt(f.get('req_per_s', {}).get('mean'), '.0f')} "
              f"p95_ms(worst)={_fmt(f.get('p95_ms', {}).get('max'))} "
              f"shed={_fmt(last.get('shed'), 'd')} "
              f"errors={_fmt(last.get('errors'), 'd')} "
              f"dead_lanes={_fmt(last.get('dead_lanes'), 'd')}", file=out)


def _sublinear(rollup: dict, out) -> None:
    from .server import _sublinear_view

    view = _sublinear_view(rollup)
    if not view.get("available"):
        print("  sublinear: no transition_cost records", file=out)
        return
    agg = view.get("frac_data_touched") or {}
    print(f"  sublinear: frac_data_touched mean={_fmt(agg.get('mean'), '.4f')} "
          f"last={_fmt(agg.get('last'), '.4f')} "
          f"over {view['samples']} refreshes"
          + (f"; per-op: " + ", ".join(
              f"{op}={_fmt(a.get('mean'), '.3f')}"
              for op, a in sorted(view["per_op"].items()))
             if view.get("per_op") else ""), file=out)


def _stages(run_dir: str, out) -> None:
    spans = read_stream(run_dir, "spans")
    if not spans:
        return
    from ..core.stats import stage_latency_breakdown

    table = stage_latency_breakdown(spans).get("stages", {})
    if not table:
        return
    print("  stage latency (ms):", file=out)
    print(f"    {'stage':14s} {'count':>6s} {'mean':>8s} {'p50':>8s} "
          f"{'p95':>8s} {'max':>8s}", file=out)
    for stage, row in table.items():
        print(f"    {stage:14s} {row.get('count', 0):6d} "
              f"{_fmt(row.get('mean_ms')):>8s} {_fmt(row.get('p50_ms')):>8s} "
              f"{_fmt(row.get('p95_ms')):>8s} {_fmt(row.get('max_ms')):>8s}",
              file=out)


def _alerts(run_dir: str, out) -> None:
    events = read_stream(run_dir, "alerts")
    if not events:
        print("  alerts: none recorded", file=out)
        return
    state: dict[str, dict] = {}
    fired: dict[str, int] = {}
    for ev in events:
        rule = ev.get("rule", "?")
        state[rule] = ev
        if ev.get("to") == "firing":
            fired[rule] = fired.get(rule, 0) + 1
    firing = sorted(r for r, ev in state.items() if ev.get("to") == "firing")
    print(f"  alerts: {len(events)} transitions, "
          f"{sum(fired.values())} fire(s) across {len(fired)} rule(s)",
          file=out)
    for rule, n in sorted(fired.items()):
        ev = state[rule]
        print(f"    {rule:24s} fired x{n}  last={ev.get('to')} "
              f"severity={ev.get('severity')} "
              f"value={_fmt(ev.get('value'), '.4g')}", file=out)
    if firing:
        print(f"    STILL FIRING at exit: {', '.join(firing)}", file=out)


def _autoscale(run_dir: str, out) -> None:
    events = read_stream(run_dir, "autoscale")
    if not events:
        return
    ups = sum(1 for e in events if e.get("action") == "scale_up")
    downs = sum(1 for e in events if e.get("action") == "scale_down")
    print(f"  autoscale: {len(events)} decisions "
          f"(scale_up={ups} scale_down={downs})", file=out)
    for ev in events:
        if ev.get("action") in ("scale_up", "scale_down"):
            print(f"    t+{_fmt(ev.get('rel_s'), '.1f')}s {ev['action']} "
                  f"{ev.get('replica', '')} replicas "
                  f"{ev.get('replicas_before')}->{ev.get('replicas_after')} "
                  f"({ev.get('reason', '')})", file=out)


def main(argv=None, out=None) -> int:
    out = out or sys.stdout
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.dash", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("run_dir", help="a recorder run directory "
                                    "(<obs-dir>/<run-id>)")
    args = ap.parse_args(argv)
    run_dir = args.run_dir
    if not os.path.isdir(run_dir):
        print(f"dash: no such run directory: {run_dir}", file=sys.stderr)
        return 2
    rollup = load_rollup(run_dir)
    if not rollup.get("streams"):
        print(f"dash: {run_dir} holds no metric streams", file=sys.stderr)
        return 2
    _headlines(rollup, out)
    _sublinear(rollup, out)
    _stages(run_dir, out)
    _alerts(run_dir, out)
    _autoscale(run_dir, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
