"""Observability, the port of ``repro.obs``: metric streams, request traces,
rollups, the live endpoint, alerts and the health model.

The recording layer over the serving and fleet stack::

    signal sources ──▶ sources.py adapters ──▶ Recorder ──▶ <run>/<stream>.jsonl
     slo_report()        SLOSampler              │             summary.json
     Snapshot            record_snapshot         └─▶ rollup() ──▶ StatsServer
     sync_stats          record_fleet_sync                        (HTTP JSON:
     run_timed           make_on_block                             /  /spans
     adaptation trace    record_adaptation                         /stages
     SubsampledMHInfo    record_transition_cost                    /sublinear)
    request path     ──▶ trace.Tracer spans  ──▶ spans stream + ring
     (queue/router/replica/evaluator)            └─▶ Chrome trace export
    LM step          ──▶ trace.span step spans ──▶ default_tracer() ring
     (propose/prior/rounds/forwards; under the profiler or install())

Front end: ``python -m repro_torch.launch.serve --stats-addr 127.0.0.1:8787
--obs-dir /tmp/obs --trace-dir /tmp/trace``; a recorded run renders with
``python -m repro_torch.obs.dash <obs-dir>/<run-id>``; trace export via
``python -m repro_torch.obs.trace --export ...``. Records hold host values:
a torch tensor in one is copied to the host when it is written.
"""
from .recorder import Recorder, json_default
from .server import StatsServer
from .sources import (
    SLOSampler,
    make_on_block,
    record_adaptation,
    record_fleet_sync,
    record_snapshot,
    record_transition_cost,
)
from .trace import (
    STAGES,
    Tracer,
    chrome_trace_events,
    default_tracer,
    export_chrome_trace,
    install,
    load_spans,
    new_span_id,
    new_trace_id,
    span,
    span_close,
    span_open,
)

# The alerting/health layer loads lazily: every serve path imports this
# package (via .trace / .recorder), and a run with every flag off must not
# pay for, or even load, the alert engine.
_LAZY = {
    "AlertEngine": "alerts",
    "AlertRule": "alerts",
    "default_rules": "alerts",
    "health_report": "health",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{module}", __name__), name)


__all__ = [
    "AlertEngine",
    "AlertRule",
    "Recorder",
    "SLOSampler",
    "STAGES",
    "StatsServer",
    "Tracer",
    "chrome_trace_events",
    "default_rules",
    "default_tracer",
    "export_chrome_trace",
    "health_report",
    "install",
    "json_default",
    "load_spans",
    "make_on_block",
    "new_span_id",
    "new_trace_id",
    "record_adaptation",
    "record_fleet_sync",
    "record_snapshot",
    "record_transition_cost",
    "span",
    "span_close",
    "span_open",
]
