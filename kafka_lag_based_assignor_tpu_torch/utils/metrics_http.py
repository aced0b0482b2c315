"""Plain-HTTP ``/metrics`` listener (opt-in): stock-Prometheus scrapes.

A copy of ``kafka_lag_based_assignor_tpu/utils/metrics_http.py``, whole,
over the port's registry.  The registry (utils/metrics) is queryable over
the JSON wire as ``{"method": "metrics"}``, but a stock Prometheus server
speaks HTTP GET, not newline-JSON over TCP.  This module serves the SAME
registry as the standard text exposition (version 0.0.4) on a plain HTTP
port:

* ``GET /metrics``  -> 200, ``text/plain; version=0.0.4``,
  :meth:`Registry.prometheus` of the process-wide registry;
* ``GET /healthz``  -> 200 ``ok`` (liveness for the scrape target);
* anything else     -> 404.

Opt-in: the sidecar binds it only when a metrics port is configured
(``AssignorService(metrics_port=...)`` / the ``--metrics-port`` flag /
``tpu.assignor.metrics.port``).  Port 0 asks the OS for a free port
(tests); the bound address is exposed as :attr:`MetricsHTTPServer.address`.

Read-only by construction: the handler renders a snapshot and never
touches service state, so exposing it on an observability network is
safe (the JSON wire stays the only mutating surface).
"""

from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from . import metrics

LOGGER = logging.getLogger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_GET(self) -> None:  # noqa: N802 — http.server's contract
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = metrics.REGISTRY.prometheus().encode()
            self._reply(200, body, CONTENT_TYPE)
        elif path == "/healthz":
            self._reply(200, b"ok\n", "text/plain; charset=utf-8")
        else:
            self._reply(
                404, b"not found (try /metrics)\n",
                "text/plain; charset=utf-8",
            )

    def _reply(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args) -> None:
        # Route http.server's stderr chatter through logging instead.
        LOGGER.debug("metrics-http %s", fmt % args)


class MetricsHTTPServer:
    """Threaded HTTP front end over the process-wide registry."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._http = ThreadingHTTPServer((host, port), _Handler)
        self._http.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self._http.server_address[:2]
        return str(host), int(port)

    def start(self) -> "MetricsHTTPServer":
        self._thread = threading.Thread(
            target=self._http.serve_forever,
            name="klba-metrics-http", daemon=True,
        )
        self._thread.start()
        LOGGER.info("metrics listener on http://%s:%d/metrics",
                    *self.address)
        return self

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()

    def __enter__(self) -> "MetricsHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
