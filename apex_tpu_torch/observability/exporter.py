"""Live telemetry export (``apex_tpu/observability/exporter.py``, copied,
not imported): a stdlib HTTP endpoint over the registry.

- ``GET /metrics`` — OpenMetrics text of the registry snapshot
  (:mod:`~apex_tpu_torch.observability.openmetrics`): counters, gauges,
  sketches as native histogram buckets, deque histograms as summaries.
- ``GET /healthz`` — ``200 {"status":"ok"}`` until any anomaly
  detector fires, then ``503`` with the anomaly count and kinds
  (latched until the process restarts or telemetry is reconfigured:
  the signal a load balancer or autoscaler acts on).
- ``GET /statusz`` — JSON: uptime, the live registry summary, and the
  anomaly log.

Constructed only by ``configure(export_port=...)`` (or
``APEX_TPU_TELEMETRY_PORT``); ``port=0`` binds an ephemeral port (read
it back from :attr:`TelemetryExporter.port`).  The server is a
daemon-thread ``ThreadingHTTPServer`` bound to localhost by default;
``shutdown()`` and a re-``configure()`` close it.  Without a port this
module is never imported and no thread or socket exists.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from apex_tpu_torch.observability import openmetrics

__all__ = ["TelemetryExporter", "THREAD_NAME"]

THREAD_NAME = "apex-tpu-telemetry-exporter"


class TelemetryExporter:
    """Daemon-thread HTTP server exposing one registry's live state."""

    def __init__(self, registry, port: int = 0,
                 host: str = "127.0.0.1"):
        self._registry = registry
        self._t0 = time.time()
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            # the exporter must never stall a serving loop that shares
            # the process: tiny responses, no keep-alive state
            protocol_version = "HTTP/1.0"

            def do_GET(self):                      # noqa: N802 (stdlib)
                exporter._handle(self)

            def log_message(self, *args):          # silence per-request
                pass                               # stderr spam

        self._server = ThreadingHTTPServer((host, int(port)), _Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=THREAD_NAME,
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- request handling --------------------------------------------------

    def _respond(self, h, status: int, body: str,
                 content_type: str) -> None:
        payload = body.encode("utf-8")
        h.send_response(status)
        h.send_header("Content-Type", content_type)
        h.send_header("Content-Length", str(len(payload)))
        h.end_headers()
        h.wfile.write(payload)

    def _handle(self, h) -> None:
        path = h.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                text = openmetrics.render(self._registry.snapshot())
                self._respond(h, 200, text, openmetrics.CONTENT_TYPE)
            elif path == "/healthz":
                status, doc = self._health()
                self._respond(h, status, json.dumps(doc),
                              "application/json")
            elif path == "/statusz":
                self._respond(h, 200, json.dumps(self._status()),
                              "application/json")
            else:
                self._respond(h, 404, json.dumps(
                    {"error": f"unknown path {path!r}", "paths":
                     ["/metrics", "/healthz", "/statusz"]}),
                    "application/json")
        except Exception as e:                     # pragma: no cover -
            # a scrape must never kill the server thread    defensive
            try:
                self._respond(h, 500, json.dumps({"error": repr(e)}),
                              "application/json")
            except Exception:
                pass

    def _health(self):
        bank = getattr(self._registry, "detectors", None)
        if bank is not None and bank.anomalies:
            kinds = sorted({a.kind for a in bank.anomalies})
            return 503, {"status": "unhealthy",
                         "anomalies": len(bank.anomalies) + bank._dropped,
                         "kinds": kinds,
                         "first": bank.anomalies[0].to_dict()}
        return 200, {"status": "ok", "anomalies": 0}

    def _status(self) -> dict:
        bank = getattr(self._registry, "detectors", None)
        return {
            "uptime_s": round(time.time() - self._t0, 3),
            "summary": self._registry.summary(),
            "anomalies": bank.summary() if bank is not None else None,
        }

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Stop serving and release the socket (idempotent).

        Ordering matters: ``shutdown()`` stops the accept loop, the JOIN waits out the
        serve thread, and only then does ``server_close()`` release
        the socket — closing first races an in-flight scrape that is
        still rendering the registry through this server.  Handler
        threads are reaped by ``server_close`` itself
        (``ThreadingHTTPServer.block_on_close``; daemon_threads only
        marks them for interpreter exit).
        """
        server, self._server = self._server, None
        if server is None:
            return
        server.shutdown()
        self._thread.join(timeout=2.0)
        server.server_close()
