"""Structured event logging with automatic trace correlation.

One ``configure()`` shared by every entrypoint (serve / stream / batch
CLIs, bench.py, the tile tools) replaces the scattered
``logging.basicConfig`` calls, so a single pair of env switches governs
the whole fleet:

  REPORTER_LOG_FORMAT=json|text   one-line-JSON events, or the classic
                                  "%(asctime)s %(name)s %(levelname)s"
                                  text lines (default: text)
  REPORTER_LOG_LEVEL=DEBUG|INFO|...  root level (default: INFO)

Both formatters auto-attach the current trace id
(``obs.trace.current_trace_id()``), so any log line emitted while a
request's span is bound — including deep inside the matcher on another
thread that bound the batch's lead span — lands next to that request's
flight-recorder entry with zero call-site changes.

``event(logger, name, **fields)`` emits a machine-parseable event: in
JSON mode the fields become top-level keys; in text mode they render as
``name key=value ...``.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import IO, Optional

from . import trace as _trace

TEXT_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts, level, logger, msg, trace_id, plus any
    event fields attached via ``event()``."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        ev = getattr(record, "event", None)
        if ev:
            out["event"] = ev
        fields = getattr(record, "event_fields", None)
        if fields:
            for k, v in fields.items():
                out.setdefault(k, v)
        tid = getattr(record, "trace_id", None) or _trace.current_trace_id()
        if tid:
            out["trace_id"] = tid
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info).replace(
                "\n", " | ")
        return json.dumps(out, separators=(",", ":"), default=str)


class TextFormatter(logging.Formatter):
    """The classic line, with event fields and the trace id appended."""

    def format(self, record: logging.LogRecord) -> str:
        s = super().format(record)
        fields = getattr(record, "event_fields", None)
        if fields:
            s += " " + " ".join(
                "%s=%s" % (k, v) for k, v in sorted(fields.items()))
        tid = getattr(record, "trace_id", None) or _trace.current_trace_id()
        if tid:
            s += " trace_id=%s" % tid
        return s


_configured = False


def configure(level: Optional[str] = None, fmt: Optional[str] = None,
              stream: Optional[IO] = None, force: bool = False) -> None:
    """Install the shared root handler (idempotent: entrypoints call it
    unconditionally; embedders that configured logging themselves are left
    alone unless ``force``).  ``fmt``/``level`` default to the
    REPORTER_LOG_FORMAT / REPORTER_LOG_LEVEL env switches."""
    global _configured
    if _configured and not force:
        return
    fmt = (fmt or os.environ.get("REPORTER_LOG_FORMAT", "text")).lower()
    level_name = (level or os.environ.get("REPORTER_LOG_LEVEL", "INFO")).upper()
    handler = logging.StreamHandler(stream if stream is not None else sys.stderr)
    handler.setFormatter(
        JsonFormatter() if fmt == "json" else TextFormatter(TEXT_FORMAT))
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(getattr(logging, level_name, logging.INFO))
    _configured = True


def event(logger: logging.Logger, name: str, level: int = logging.INFO,
          **fields) -> None:
    """Emit a structured event: ``name`` is the message and the ``event``
    key; ``fields`` ride as JSON keys (json mode) / ``key=value`` (text).
    ``None``-valued fields are dropped (optional context like trace_id)."""
    fields = {k: v for k, v in fields.items() if v is not None}
    logger.log(level, name, extra={"event": name, "event_fields": fields})
