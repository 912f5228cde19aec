"""The port's copy of ``lakesoul_tpu/obs/exporter.py``.

THE Prometheus HTTP endpoint (parity with the reference server's
PrometheusBuilder, bin/flight_sql_server.rs:21-22): one ``/metrics`` serving
everything the process recorded — gateway streams, page cache, SQL stage
latencies, meta commits, compaction, loader throughput — from one registry.

``/metrics`` content-negotiates: ``Accept: application/json`` gets the
``snapshot()`` document (for a fleet aggregator source, the FULL aggregate
doc with members/SLOs), anything else the Prometheus text format.  A
raising source produces a ``500`` with the error in the body — a scraper
sees WHY, instead of a dropped socket it must guess about.  ``/healthz``
answers the fleet's heartbeat probes with this process's identity.
"""

from __future__ import annotations

import json
import threading

from lakesoul_tpu_torch.obs.metrics import registry as _default_registry

__all__ = ["serve_prometheus"]


def serve_prometheus(source=None, port: int = 0, host: str = "0.0.0.0"):
    """Serve ``GET /metrics`` (+ ``/healthz``) in a daemon thread; returns
    the HTTPServer (``.shutdown()`` to stop, ``.server_address[1]`` for the
    bound port).

    ``source`` is anything with ``prometheus_text()``; default is the
    process-wide registry, which is what servers should expose — a
    per-component object narrows the endpoint to that component.  A source
    that also has ``snapshot()`` (the registry, a FleetAggregator) serves
    JSON to ``Accept: application/json`` callers."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    metrics = source if source is not None else _default_registry()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?", 1)[0].rstrip("/")
            if path == "/healthz":
                # liveness for fleet heartbeat probes: identity, no metrics
                # production (a wedged collector must not fail liveness)
                try:
                    from lakesoul_tpu_torch.obs.fleet import identity

                    ident = identity()
                    doc = {
                        "status": "ok",
                        "role": ident.role,
                        "service_id": ident.service_id,
                        "pid": ident.pid,
                    }
                except Exception:
                    doc = {"status": "ok"}
                self._reply(200, json.dumps(doc).encode(), "application/json")
                return
            if path not in ("", "/metrics"):
                self.send_error(404)
                return
            accept = self.headers.get("Accept", "")
            as_json = "application/json" in accept and hasattr(metrics, "snapshot")
            try:
                if as_json:
                    body = json.dumps(metrics.snapshot()).encode()
                    ctype = "application/json"
                else:
                    body = metrics.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4"
            except Exception as e:  # a raising collector: tell the scraper
                self._reply(
                    500,
                    f"metrics collection failed: {type(e).__name__}: {e}\n".encode(),
                    "text/plain",
                )
                return
            self._reply(200, body, ctype)

    srv = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(
        target=srv.serve_forever, name="lakesoul-metrics-exporter", daemon=True
    )
    srv._serve_thread = thread
    real_shutdown = srv.shutdown

    def _shutdown() -> None:
        # the documented stop path also retires the serve thread — without
        # the join, shutdown() returns while serve_forever is still draining
        # and the thread races whatever teardown the caller does next
        real_shutdown()
        thread.join(timeout=5.0)

    srv.shutdown = _shutdown
    thread.start()
    return srv
