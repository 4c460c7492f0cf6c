"""Persistent keep-alive HTTP connections for every egress path (the
port's copy of the JAX package's module of the same name).

urllib.request opens a fresh TCP connection per call, so a streaming
client would pay a connect (plus slow-start) on every single request
against a server that already speaks HTTP/1.1 keep-alive.  This pool
checks connections out per (host, port), reuses them across requests, and
caps the idle set per host; connection opens and reuses are counted per
logical target so the reuse ratio is visible on /metrics.

Semantics:

  - ``request()`` returns ``(status, headers, body_bytes)`` with the
    response fully read (keep-alive framing requires it); it NEVER
    raises on an HTTP error status -- callers that want the
    urllib/retry-policy contract use ``raise_for_status``.
  - a REUSED connection that fails before any response bytes arrive is
    retried once on a fresh connection, transparently: the server
    closing an idle keep-alive socket between our requests is normal
    churn, not a request failure.  A fresh connection failing is a real
    transport error and propagates.  (All pooled calls here are
    idempotent match/report/health requests.)
  - connections the server marks ``Connection: close`` are not pooled.
"""

from __future__ import annotations

import http.client
import io
import threading
import urllib.error
import urllib.parse
from typing import Dict, List, Optional, Tuple

from ..obs import metrics as obs

C_CONN_OPENED = obs.counter(
    "reporter_http_connections_opened_total",
    "New TCP connections opened by the keep-alive pool, per logical "
    "target (matcher / router / replica / loadgen)",
    ("target",))
C_CONN_REUSED = obs.counter(
    "reporter_http_connection_reuse_total",
    "Requests served over an already-open pooled connection, per target "
    "(the keep-alive win: each one is a connect that did not happen)",
    ("target",))

_DEFAULT_TIMEOUT = 10.0


class HttpPool:
    """A small thread-safe keep-alive pool, keyed by (host, port)."""

    def __init__(self, max_idle_per_host: int = 8):
        self.max_idle = max(1, int(max_idle_per_host))
        self._lock = threading.Lock()
        self._idle: Dict[Tuple[str, int], List[http.client.HTTPConnection]] = {}

    def _checkout(self, host: str, port: int, timeout: float, target: str,
                  fresh: bool = False) -> Tuple[http.client.HTTPConnection, bool]:
        conn = None
        if not fresh:
            with self._lock:
                stack = self._idle.get((host, port))
                conn = stack.pop() if stack else None
        if conn is not None:
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            return conn, True
        C_CONN_OPENED.labels(target).inc()
        return http.client.HTTPConnection(host, port, timeout=timeout), False

    def _checkin(self, host: str, port: int,
                 conn: http.client.HTTPConnection) -> None:
        with self._lock:
            stack = self._idle.setdefault((host, port), [])
            if len(stack) < self.max_idle:
                stack.append(conn)
                return
        conn.close()

    def close(self) -> None:
        """Drop every idle connection (tests; replica teardown)."""
        with self._lock:
            idle, self._idle = self._idle, {}
        for stack in idle.values():
            for conn in stack:
                conn.close()

    def request(self, method: str, url: str, body: Optional[bytes] = None,
                headers: Optional[dict] = None,
                timeout: float = _DEFAULT_TIMEOUT,
                target: str = "http"):
        """One round-trip; returns ``(status, headers, body_bytes)``.
        HTTP error statuses are returned, not raised (raise_for_status
        restores the urllib contract where the retry policy needs it)."""
        parsed = urllib.parse.urlsplit(url)
        if parsed.scheme not in ("http", ""):
            raise ValueError("HttpPool speaks plain http (got %r)" % url)
        host = parsed.hostname or "127.0.0.1"
        port = parsed.port or 80
        path = parsed.path or "/"
        if parsed.query:
            path += "?" + parsed.query
        hdrs = dict(headers or {})
        for attempt in (0, 1):
            # the retry opens a new connection: the other idle sockets to
            # this host went quiet as long and may be closed too
            conn, reused = self._checkout(host, port, timeout, target, fresh=attempt == 1)
            try:
                conn.request(method, path, body=body, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
            except (http.client.HTTPException, ConnectionError,
                    BrokenPipeError, OSError):
                # a reused socket the server quietly closed: retry ONCE on
                # a fresh connection; a fresh connection failing is real
                conn.close()
                if not reused or attempt:
                    raise
                continue
            if reused:
                C_CONN_REUSED.labels(target).inc()
            if resp.will_close:
                conn.close()
            else:
                self._checkin(host, port, conn)
            return resp.status, resp.headers, data
        raise AssertionError("unreachable")  # pragma: no cover


def raise_for_status(url: str, status: int, headers, body: bytes) -> None:
    """Re-raise an HTTP error status as urllib.error.HTTPError, carrying
    the headers (Retry-After!) and body -- the exception type the shared
    retry policy (utils/retry.py) classifies on."""
    if status >= 400:
        raise urllib.error.HTTPError(
            url, status, http.client.responses.get(status, "error"),
            headers, io.BytesIO(body))


# the process-wide default pool: every stream client shares it (distinct
# hosts never contend -- the pool is keyed per (host, port))
POOL = HttpPool()
