"""Per-request trace context: a ``trace_id`` + per-stage ``Span`` timings.

A trace is born at ingestion — the HTTP handler accepts a client-supplied
``X-Reporter-Trace`` header (validated) or generates an id — and is carried
via ``contextvars`` through the MicroBatcher, matcher dispatch, report
rendering, and the batch pipeline's micro-batches.  Always on: every
request gets a ``Span`` stamped at each pipeline stage (queue wait,
dispatch, device step, report rendering) and is offered to the flight
recorder (``obs.flight``) on completion; ``?debug=1`` only controls
whether the breakdown additionally rides back on the response.

The contextvar is the correlation backbone: ``obs.log``'s structured
formatter auto-attaches ``current_trace_id()`` to every log line, and the
MicroBatcher binds its dispatch thread to the batch's lead span so a
compile stall logged deep in the matcher still carries a request's id.
"""

from __future__ import annotations

import contextlib
import contextvars
import re
import time
import uuid
from typing import Iterator, Optional

# ids safe to echo in a header, a log line, and a Prometheus exemplar;
# anything else from the wire is discarded and replaced with a fresh id
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

_CURRENT: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "reporter_trace_span", default=None
)


def new_trace_id() -> str:
    return uuid.uuid4().hex


def accept_trace_id(raw: Optional[str]) -> Optional[str]:
    """Validate a wire-supplied trace id; None when absent or unusable."""
    if not raw:
        return None
    raw = raw.strip()
    if _TRACE_ID_RE.match(raw):
        return raw
    return None


class Span:
    __slots__ = ("name", "trace_id", "span_id", "t0", "t0_unix", "timings",
                 "meta", "status", "error")

    def __init__(self, name: str = "", trace_id: Optional[str] = None):
        self.name = name
        # the root span of a generated trace shares its id prefix with the
        # trace (one uuid per request, not two): span_id stays 16 hex chars
        self.trace_id = trace_id or new_trace_id()
        self.span_id = self.trace_id[:16] if len(self.trace_id) >= 16 \
            else uuid.uuid4().hex[:16]
        self.t0 = time.monotonic()
        self.t0_unix = time.time()
        self.timings: dict = {}
        self.meta: dict = {}
        self.status = "ok"
        self.error: Optional[str] = None

    def mark(self, key: str, seconds: float) -> None:
        self.timings[key] = round(float(seconds), 6)

    def fail(self, error, status: str = "error") -> None:
        """Flag the span; errored spans are always retained by the flight
        recorder's tail sampling."""
        self.status = status
        self.error = str(error)[:400]

    def finish(self) -> None:
        self.timings["total_s"] = round(time.monotonic() - self.t0, 6)

    @property
    def total_s(self) -> float:
        return self.timings.get("total_s", 0.0)

    def breakdown(self) -> dict:
        out = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.name:
            out["name"] = self.name
        out.update(self.meta)
        out["timings"] = dict(self.timings)
        return out


# -- context ---------------------------------------------------------------


def current_span() -> Optional[Span]:
    return _CURRENT.get()


def current_trace_id() -> Optional[str]:
    span = _CURRENT.get()
    return span.trace_id if span is not None else None


@contextlib.contextmanager
def bind(span: Optional[Span]) -> Iterator[Optional[Span]]:
    """Make ``span`` the current trace context for the block.  ``None`` is
    a no-op so call sites can bind unconditionally (not every submission
    carries a span)."""
    if span is None:
        yield None
        return
    token = _CURRENT.set(span)
    try:
        yield span
    finally:
        _CURRENT.reset(token)
