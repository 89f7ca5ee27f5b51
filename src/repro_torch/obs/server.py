"""Live stats endpoint: the recorder's rollup (and trace views) over HTTP,
the port of ``repro.obs.server`` (stdlib only, as there).

A :class:`StatsServer` binds a tiny :class:`ThreadingHTTPServer` on a
daemon thread and answers GETs with JSON — what ``serve --stats-addr
host:port`` exposes so a dashboard (or ``curl``) can watch the service
while it is under load. Port 0 binds an ephemeral port (tests); the bound
address is in :attr:`url`. Paths:

====================  =====================================================
path                  payload
====================  =====================================================
``/``                 the owning :meth:`repro_torch.obs.Recorder.rollup` —
                      req/s, latency tails (incl. streaming p50/p95),
                      shed counts, snapshot staleness
``/healthz``          cheap liveness probe: ``{"ok": true, "run_id": ...}``
                      (no rollup computed — safe for tight probe loops)
``/health``           the component health model
                      (:func:`repro_torch.obs.health.health_report`): per-
                      component scores + the min-score overall grade
``/alerts``           the attached :class:`repro_torch.obs.alerts.AlertEngine`'s
                      per-rule state (``{"available": false}`` without one)
``/spans``            the attached :class:`repro_torch.obs.trace.Tracer`'s
                      in-memory span ring (newest ``max_spans``)
``/stages``           per-stage latency breakdown of those spans (queue
                      wait vs batch assembly vs device eval vs combine;
                      :func:`repro_torch.core.stats.stage_latency_breakdown`)
``/sublinear``        the live "fraction of data touched per transition"
                      rollup from the ``transition_cost`` stream, with the
                      per-op breakdown for ``cycle()`` transitions
====================  =====================================================

Any other path is a **404** with a JSON body listing the valid routes (a
typo'd dashboard URL used to silently get the full rollup with a 200 —
indistinguishable from the intended answer).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .recorder import Recorder, json_default

ROUTES = ("/", "/alerts", "/health", "/healthz", "/spans", "/stages",
          "/sublinear")


def _sublinear_view(rollup: dict) -> dict:
    """The ``/sublinear`` payload from a rollup: overall and per-op
    ``frac_data_touched`` aggregates of the ``transition_cost`` stream."""
    stream = rollup.get("streams", {}).get("transition_cost")
    if not stream:
        return {"available": False, "samples": 0}
    fields = stream.get("fields", {})
    suffix = ".frac_data_touched"
    per_op = {
        key[: -len(suffix)]: agg
        for key, agg in fields.items()
        if key.endswith(suffix)
    }
    return {
        "available": True,
        "samples": stream.get("count", 0),
        "frac_data_touched": fields.get("frac_data_touched"),
        "per_op": per_op,
        "last": stream.get("last", {}),
    }


class StatsServer:
    """Serve ``recorder.rollup()`` (plus alert/health/trace views) as JSON.

    ``alerts`` (an :class:`~repro_torch.obs.alerts.AlertEngine`), ``health`` (a
    zero-arg callable returning the ``/health`` payload), and ``tracer``
    are all optional and may also be attached after construction by
    assigning the public attributes — the serve front-end builds the
    engine after the server is already listening.
    """

    def __init__(self, recorder: Recorder, addr: str = "127.0.0.1:0",
                 tracer=None, alerts=None, health=None):
        host, _, port = addr.partition(":")
        self.recorder = recorder
        self.tracer = tracer
        self.alerts = alerts
        self.health = health
        server_ref = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                status = 200
                if path == "/":
                    payload = server_ref.recorder.rollup()
                elif path == "/healthz":
                    payload = {"ok": True,
                               "run_id": server_ref.recorder.run_id}
                elif path == "/health":
                    payload = server_ref._health_view()
                elif path == "/alerts":
                    engine = server_ref.alerts
                    payload = engine.status() if engine is not None \
                        else {"available": False}
                elif path == "/spans":
                    tracer = server_ref.tracer
                    spans = tracer.spans() if tracer else []
                    payload = {
                        "spans": spans,
                        "count": len(spans),
                        "dropped": tracer.dropped if tracer else 0,
                    }
                elif path == "/stages":
                    from ..core.stats import stage_latency_breakdown

                    tracer = server_ref.tracer
                    payload = stage_latency_breakdown(
                        tracer.spans() if tracer else []
                    )
                elif path == "/sublinear":
                    payload = _sublinear_view(server_ref.recorder.rollup())
                else:
                    status = 404
                    payload = {"error": f"unknown path {path!r}",
                               "routes": list(ROUTES)}
                body = json.dumps(payload, default=json_default).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr spam
                pass

        self._server = ThreadingHTTPServer(
            (host or "127.0.0.1", int(port or 0)), _Handler
        )
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="stats-http", daemon=True
        )
        self._thread.start()

    def _health_view(self) -> dict:
        if self.health is not None:
            return self.health()
        from .health import health_report

        engine = self.alerts
        return health_report(
            self.recorder.rollup(),
            alert_status=engine.status() if engine is not None else None,
        )

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10.0)
