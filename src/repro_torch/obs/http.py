"""Stdlib HTTP endpoint serving the metrics registry.

``MetricsServer`` wraps ``http.server.ThreadingHTTPServer`` on a daemon
thread.  Routes:

* ``GET /metrics``       — Prometheus text exposition
* ``GET /metrics.json``  — JSON snapshot (instruments + provider values)

Pass ``port=0`` to bind an ephemeral port (read it back from ``.port``
after ``start()``) — tests and the CI scrape step rely on this.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .export import json_snapshot, prometheus_text
from .registry import MetricsRegistry

__all__ = ["MetricsServer"]


class _Handler(BaseHTTPRequestHandler):
    registry: MetricsRegistry = None  # set per-server via subclassing

    def do_GET(self):  # noqa: N802 - stdlib naming
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = prometheus_text(self.registry).encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/metrics.json":
            body = json_snapshot(self.registry).encode()
            ctype = "application/json"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, format, *args):  # silence per-request stderr
        pass


class MetricsServer:
    """Threaded scrape endpoint over a :class:`MetricsRegistry`."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1"):
        self.registry = registry
        handler = type("_BoundHandler", (_Handler,), {"registry": registry})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http",
            daemon=True,
        )
        self._started = False

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "MetricsServer":
        if not self._started:
            self._thread.start()
            self._started = True
        return self

    def stop(self) -> None:
        if self._started:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._started = False
        self._httpd.server_close()

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
