"""Pull-based Prometheus scrape endpoint for long-lived sessions: the
port's own copy of ``paddle_tpu/observability/server.py`` (stdlib only).

A ``http.server`` serving two routes:

  * ``GET /metrics``  -> ``REGISTRY.to_prometheus()`` (text exposition
    format 0.0.4), rendered at request time;
  * ``GET /healthz``  -> readiness: ``200 {"status": "ok"}`` while every
    registered health provider is content, ``503 {"status": "degraded",
    "reasons": [...]}`` when any reports pressure (serving sessions
    register queue-depth / slot-pressure providers through
    :func:`register_health_provider`).

The lifecycle is reference-counted and owned by the serving sessions
(``inference.decode.DecodeSession`` / ``ContinuousBatchingSession``): each
session constructed while ``PADDLE_TPU_METRICS_PORT`` is set calls
:func:`session_started` (the first binds the port and starts the daemon
thread) and :func:`session_finished` from its ``close()`` (the last shuts
the server down and releases the port). Processes that never set the env
var never touch a socket.

Env contract:
  * ``PADDLE_TPU_METRICS_PORT`` — unset/empty: disabled; ``0``: bind an
    ephemeral port (read it back from ``server.port``); otherwise the
    literal port.
  * ``PADDLE_TPU_METRICS_HOST`` — bind host, default ``0.0.0.0``.

A bind failure is logged and swallowed: telemetry never takes down
serving. ``MetricsServer`` is also usable directly.
"""
from __future__ import annotations

import http.server
import json
import os
import sys
import threading
from typing import Optional

from . import metrics as _met

_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

PORT_ENV = "PADDLE_TPU_METRICS_PORT"
HOST_ENV = "PADDLE_TPU_METRICS_HOST"


class _Handler(http.server.BaseHTTPRequestHandler):
    # one registry per process; the handler reads it at request time
    server_version = "paddle_tpu_metrics"

    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            _met.REGISTRY.counter("metrics.scrapes").inc()
            body = _met.REGISTRY.to_prometheus().encode("utf-8")
            self._reply(200, _CONTENT_TYPE, body)
        elif path == "/healthz":
            ok, payload = health_status()
            body = json.dumps(payload).encode("utf-8")
            self._reply(200 if ok else 503, "application/json", body)
        else:
            self._reply(404, "text/plain; charset=utf-8",
                        b"not found: try /metrics or /healthz\n")

    def _reply(self, code: int, ctype: str, body: bytes):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        pass  # scrapes every few seconds must not spam the log


class MetricsServer:
    """One bound scrape endpoint; ``start()`` spawns the daemon
    serving thread, ``stop()`` shuts it down and closes the socket
    (the port is released synchronously — a new bind succeeds as soon
    as stop() returns)."""

    def __init__(self, port: int, host: Optional[str] = None):
        host = host if host is not None else \
            os.environ.get(HOST_ENV, "0.0.0.0")
        self._httpd = http.server.ThreadingHTTPServer(
            (host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        #: actual bound port (meaningful when constructed with port=0)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name=f"paddle-tpu-metrics-:{self.port}", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._httpd.server_close()

    @property
    def url(self) -> str:
        host = "127.0.0.1" if self.host in ("0.0.0.0", "") else self.host
        return f"http://{host}:{self.port}"


# ---------------------------------------------------------------------
# readiness providers: callables returning a (possibly empty) list of
# degradation reasons — or None/[] while healthy. Serving sessions
# register one for their queue/slot pressure; /healthz aggregates.
_health_lock = threading.Lock()
_health_providers: list = []


def register_health_provider(fn):
    """Register a readiness provider; returns its unregister callable
    (idempotent). A provider that raises is skipped for that probe —
    a broken provider must never flap readiness on its own."""
    with _health_lock:
        _health_providers.append(fn)

    def _unregister():
        with _health_lock:
            try:
                _health_providers.remove(fn)
            except ValueError:
                pass
    return _unregister


def health_status():
    """Aggregate readiness: ``(True, {"status": "ok"})`` or
    ``(False, {"status": "degraded", "reasons": [...]})``."""
    with _health_lock:
        providers = list(_health_providers)
    reasons = []
    for fn in providers:
        try:
            r = fn()
        except Exception:
            continue
        if r:
            reasons.extend(r if isinstance(r, (list, tuple)) else [r])
    if reasons:
        return False, {"status": "degraded", "reasons": reasons}
    return True, {"status": "ok"}


# ---------------------------------------------------------------------
# session-scoped shared server (refcounted)
_lock = threading.Lock()
_shared: Optional[MetricsServer] = None
_refs = 0


def session_started() -> Optional[MetricsServer]:
    """Called by a serving-session constructor. Returns the shared
    server (starting it on first use) when ``PADDLE_TPU_METRICS_PORT``
    is set, else None. The caller must pass a non-None return to
    :func:`session_finished` exactly once (sessions do this from
    ``close()``)."""
    global _shared, _refs
    port = os.environ.get(PORT_ENV, "").strip()
    if not port:
        return None
    with _lock:
        if _shared is None:
            try:
                _shared = MetricsServer(int(port)).start()
            except (OSError, ValueError) as e:
                print(f"[observability] metrics endpoint disabled: "
                      f"cannot bind {PORT_ENV}={port!r}: {e}",
                      file=sys.stderr)
                return None
        _refs += 1
        return _shared


def session_finished() -> None:
    """Release one session's reference; the last release stops the
    shared server and frees the port."""
    global _shared, _refs
    with _lock:
        if _refs > 0:
            _refs -= 1
        if _refs == 0 and _shared is not None:
            srv, _shared = _shared, None
            srv.stop()


def shared_server() -> Optional[MetricsServer]:
    """The currently-running session-scoped server, if any."""
    return _shared
