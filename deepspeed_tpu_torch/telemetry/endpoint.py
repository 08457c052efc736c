"""Live scrape endpoint: ``GET /metrics`` + ``GET /healthz``.

A stdlib ``ThreadingHTTPServer`` on a daemon thread — no new
dependencies, nothing on the training hot path (the registry snapshot is
taken under its own lock per scrape). Enabled by the
``telemetry.http_port`` config key (engine + serving frontend both wire
it); port 0 binds an ephemeral port (tests read ``server.port``).

``/metrics``  → 200, Prometheus text exposition of the process-wide
registry (``telemetry.metrics_text()``), so Prometheus/Grafana scrape
the same numbers the flight recorder snapshots.

``/healthz``  → liveness for load balancers / k8s probes. With a
watchdog heartbeat file configured (the watchdog writes one atomically
per step), stale-or-stalled heartbeats return 503 so a hung-but-alive
process is taken out of rotation; without one, reaching the server at
all is the liveness signal (200).

Copy of ``deepspeed_tpu/telemetry/endpoint.py`` (pure Python).
"""

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from deepspeed_tpu_torch.utils.logging import logger

#: heartbeats older than this are stale → /healthz 503
DEFAULT_FRESH_S = 120.0


class MetricsServer:
    """Daemon-thread HTTP server exposing /metrics and /healthz."""

    def __init__(self, port: int, host: str = "0.0.0.0",
                 heartbeat_file: Optional[str] = None,
                 fresh_s: float = DEFAULT_FRESH_S,
                 clock=time.time):
        self.heartbeat_file = heartbeat_file or \
            os.environ.get("DSTPU_HEARTBEAT_FILE")
        self.fresh_s = float(fresh_s)
        self._clock = clock
        #: degraded reasons keyed by source — the serving failure domain
        #: (while requeued requests drain) and the SLO burn-rate engine
        #: flip this independently: /healthz answers 503 while ANY source
        #: holds it, so a balancer stops routing NEW traffic to a replica
        #: that is still recovering or blowing its error budget
        self._degraded: Dict[str, str] = {}
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):     # scrapes stay quiet
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/metrics":
                    code, ctype, body = server._metrics()
                elif path == "/healthz":
                    code, ctype, body = server._healthz()
                else:
                    code, ctype, body = 404, "text/plain", "not found\n"
                payload = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dstpu-metrics-http",
            daemon=True)
        self._thread.start()
        logger.info(f"metrics endpoint on :{self.port} "
                    f"(/metrics, /healthz"
                    + (f", heartbeat={self.heartbeat_file}"
                       if self.heartbeat_file else "") + ")")

    def _metrics(self):
        try:
            from deepspeed_tpu_torch.telemetry import metrics_text
            body = metrics_text()
            # histogram buckets may carry OpenMetrics exemplar suffixes
            # (`# {trace_id="..."} value`, from request tracing) —
            # advertise the OpenMetrics content type when they do, so
            # exemplar-aware scrapers ingest them; plain Prometheus
            # parsers read the same body either way (dstpu-top's parser
            # strips the suffix)
            ctype = ("application/openmetrics-text; version=1.0.0; "
                     "charset=utf-8" if " # {" in body
                     else "text/plain; version=0.0.4")
            return 200, ctype, body
        except Exception as e:                       # noqa: BLE001
            return 500, "text/plain", f"metrics error: {e}\n"

    def set_degraded(self, degraded: bool, reason: Optional[str] = None,
                     source: str = "serving") -> None:
        """Flip /healthz into (or out of) degraded 503 for one
        ``source`` (e.g. ``"serving"`` while engine-fault retries drain,
        ``"slo"`` while an objective burns) — the process is alive (no
        restart wanted) but should be out of rotation. Clearing one
        source leaves the others' degradation standing."""
        if degraded:
            self._degraded[source] = reason or "degraded"
        else:
            self._degraded.pop(source, None)

    def _healthz(self):
        """200 when healthy; 503 when degraded, the heartbeat is stale,
        or the watchdog marked the process stalled."""
        if self._degraded:
            return 503, "application/json", json.dumps(
                {"status": "degraded",
                 "reason": "; ".join(self._degraded[k]
                                     for k in sorted(self._degraded))}
            ) + "\n"
        if not self.heartbeat_file:
            return 200, "application/json", '{"status": "ok"}\n'
        try:
            with open(self.heartbeat_file) as fh:
                hb = json.load(fh)
        except Exception as e:                       # noqa: BLE001
            return 503, "application/json", json.dumps(
                {"status": "no_heartbeat", "error": str(e)}) + "\n"
        age = self._clock() - float(hb.get("ts", 0.0))
        doc = {"status": "ok", "age_s": round(age, 3),
               "step": hb.get("step"), "phase": hb.get("phase")}
        if hb.get("phase") == "stalled":
            doc["status"] = "stalled"
            return 503, "application/json", json.dumps(doc) + "\n"
        if age > self.fresh_s:
            doc["status"] = "stale"
            return 503, "application/json", json.dumps(doc) + "\n"
        return 200, "application/json", json.dumps(doc) + "\n"

    def close(self) -> None:
        """Stop serving and release the port (idempotent)."""
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        try:
            httpd.shutdown()
            httpd.server_close()
        except Exception:                            # noqa: BLE001
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
