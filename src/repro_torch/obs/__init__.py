"""Observability, the port of ``repro.obs``: so far request tracing
(:mod:`repro_torch.obs.trace`), which the fleet's replicas and router use.
The recorder, stats endpoint, alerts, health model and dashboards come with
the rest of the observability slice.
"""
from .trace import (
    STAGES,
    Tracer,
    chrome_trace_events,
    export_chrome_trace,
    load_spans,
    new_span_id,
    new_trace_id,
    span_close,
    span_open,
)

__all__ = [
    "STAGES",
    "Tracer",
    "chrome_trace_events",
    "export_chrome_trace",
    "load_spans",
    "new_span_id",
    "new_trace_id",
    "span_close",
    "span_open",
]
