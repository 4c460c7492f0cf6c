"""Always-on flight recorder: a bounded in-memory ring of recent traces
with tail sampling, for post-mortem attribution of individual requests.

Every finished ``Span`` is offered via ``record()``.  Tail sampling
decides retention AFTER the outcome is known:

  - every errored span is kept (``span.status != "ok"``),
  - every SLO-violating span is kept (``span.meta["slo_violation"]`` —
    the serve tier marks budget-burning and tail-contributing requests
    per obs/slo.py, so a 200 that blew the latency objective is
    retained even when it sits under the generic slow threshold),
  - every explicitly pinned span is kept (``span.meta["flight_keep"]``
    — the fleet router marks its own multi-attempt/hedged hop spans AND
    sends ``X-Reporter-Flight-Keep`` on re-dispatched replica legs, so
    both sides of a failed-over request survive for cross-hop trace
    stitching, docs/observability.md "Fleet observability"),
  - every low-margin span is kept (``span.meta["low_margin"]`` — the
    serve tier marks traces whose winner-vs-runner-up viterbi margin
    fell below the keep threshold, docs/match-quality.md: an ambiguous
    decode is retained like a slow one),
  - every span slower than the slow threshold is kept,
  - 1-in-N of the healthy rest is kept,
  - everything else only increments a counter.

Kept-by-right traces (errors + slow) and sampled traffic live in two
separate rings so a flood of healthy requests can never evict the error
you are trying to explain.  Both rings are bounded deques, so memory is
bounded under any load.

Read paths: ``GET /debug/traces?n=`` (serve/service.py), a summary block
in ``/statusz``, and ``dump()`` — written to disk by the serve entry point's SIGTERM drain
(``install_shutdown_dump`` at boot, ``shutdown_dump`` after the server
closes) so a stopped process leaves its last traces behind.  ``dump``/``snapshot`` read the rings
without taking the writer lock: they may run from a signal handler that
interrupted a ``record()`` holding it, and CPython deque iteration is
safe against concurrent appends (worst case: one trace torn off an end).

Env knobs (all read at recorder construction):
  REPORTER_FLIGHT_CAPACITY      ring size per class (default 256)
  REPORTER_FLIGHT_SLOW_MS       slow-trace threshold (default 250)
  REPORTER_FLIGHT_SAMPLE_EVERY  keep 1-in-N healthy traces (default 10)
  REPORTER_FLIGHT_DUMP          dump path ("" disables; a DIRECTORY gets
                                the default filename inside it — N
                                replicas on one host can share one dump
                                dir without clobbering each other).  The
                                default filename embeds
                                $REPORTER_REPLICA_ID when set, then the
                                pid: reporter_flight_<replica>_<pid>.json
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
from collections import deque
from typing import List, Optional

from . import metrics as obs
from .trace import Span

C_FLIGHT = obs.counter(
    "reporter_flight_traces_total",
    "Flight-recorder tail-sampling decisions "
    "(error / slo / pinned / low_margin / slow / sampled / dropped)",
    ("decision",))

_FILE_SAFE_RE = re.compile(r"[^A-Za-z0-9._-]")


def default_dump_name() -> str:
    """The per-process dump filename: replica-qualified so N replicas
    sharing a host (or an explicit shared dump directory) never clobber
    each other's shutdown dumps (a fleet runs one process per
    replica; pid alone vanishes on respawn, the replica id persists)."""
    rid = _FILE_SAFE_RE.sub("_", os.environ.get("REPORTER_REPLICA_ID",
                                                "").strip())
    tag = ("%s_%d" % (rid, os.getpid())) if rid else str(os.getpid())
    return "reporter_flight_%s.json" % tag


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


class FlightRecorder:
    def __init__(self, capacity: Optional[int] = None,
                 slow_ms: Optional[float] = None,
                 sample_every: Optional[int] = None):
        self.capacity = max(1, capacity if capacity is not None
                            else _env_int("REPORTER_FLIGHT_CAPACITY", 256))
        self.slow_ms = float(slow_ms if slow_ms is not None
                             else _env_int("REPORTER_FLIGHT_SLOW_MS", 250))
        self.sample_every = max(1, sample_every if sample_every is not None
                                else _env_int("REPORTER_FLIGHT_SAMPLE_EVERY", 10))
        # errors + slow in their own ring: sampled traffic cannot evict them
        self._keep: "deque[dict]" = deque(maxlen=self.capacity)
        self._sampled: "deque[dict]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seen = 0

    # -- write path --------------------------------------------------------

    def record(self, span: Span) -> str:
        """Offer a finished span; returns the sampling decision."""
        if "total_s" not in span.timings:
            span.finish()
        if span.status != "ok":
            decision = "error"
        elif span.meta.get("slo_violation"):
            decision = "slo"
        elif span.meta.get("flight_keep"):
            decision = "pinned"
        elif span.meta.get("low_margin") is not None:
            # ambiguous decode (winner-vs-runner-up viterbi margin below
            # the keep threshold, docs/match-quality.md): retained like a
            # slow trace so the quality plane's suspects are explainable
            # by trace_id
            decision = "low_margin"
        elif span.total_s * 1000.0 >= self.slow_ms:
            decision = "slow"
        else:
            with self._lock:
                self._seen += 1
                keep = self._seen % self.sample_every == 0
            decision = "sampled" if keep else "dropped"
        if decision != "dropped":
            entry = span.breakdown()
            entry["status"] = span.status
            if span.error:
                entry["error"] = span.error
            entry["retained"] = decision
            entry["t_end"] = round(span.t0_unix + span.total_s, 3)
            ring = self._sampled if decision == "sampled" else self._keep
            with self._lock:
                ring.append(entry)
        C_FLIGHT.labels(decision).inc()
        return decision

    # -- read paths (lock-free: see module docstring) ----------------------

    def snapshot(self, n: int = 50) -> List[dict]:
        """Most recent retained traces, newest first, errors/slow included
        ahead of sampled traffic when ``n`` forces a cut."""
        keep = list(self._keep)
        sampled = list(self._sampled)
        merged = sorted(keep + sampled, key=lambda e: e.get("t_end", 0.0),
                        reverse=True)
        if len(merged) > n:
            # never cut a kept-by-right trace in favour of a sampled one
            kept_ids = {id(e) for e in keep}
            merged.sort(key=lambda e: (id(e) not in kept_ids,
                                       -e.get("t_end", 0.0)))
            merged = merged[:n]
            merged.sort(key=lambda e: e.get("t_end", 0.0), reverse=True)
        return merged

    def find(self, trace_id: str) -> List[dict]:
        """Every retained entry for one trace_id, oldest first (the
        cross-hop stitching read path: the router asks a replica for the
        spans it retained under the shared id).  Lock-free like the other
        read paths."""
        out = [e for e in list(self._keep) + list(self._sampled)
               if e.get("trace_id") == trace_id]
        out.sort(key=lambda e: e.get("t_end", 0.0))
        return out

    def summary(self) -> dict:
        return {
            "capacity": self.capacity,
            "slow_ms": self.slow_ms,
            "sample_every": self.sample_every,
            "retained_errors_slow": len(self._keep),
            "retained_sampled": len(self._sampled),
        }

    def dump(self, path: Optional[str] = None) -> Optional[str]:
        """Write retained traces to disk; returns the path, or None when
        disabled (REPORTER_FLIGHT_DUMP="") or nothing was retained.  A
        directory path (explicit or via the env knob) gets the
        replica-qualified default filename inside it."""
        if path is None:
            path = os.environ.get(
                "REPORTER_FLIGHT_DUMP",
                os.path.join(tempfile.gettempdir(), default_dump_name()))
        if not path:
            return None
        if os.path.isdir(path):
            path = os.path.join(path, default_dump_name())
        traces = self.snapshot(2 * self.capacity)
        if not traces:
            return None
        try:
            with open(path, "w") as f:
                json.dump({"summary": self.summary(), "traces": traces}, f,
                          separators=(",", ":"))
        except OSError:
            return None
        return path


# the process-wide recorder: the service, the batch pipeline, and the
# stream runtime all record into this one
RECORDER = FlightRecorder()


def record(span: Span) -> str:
    return RECORDER.record(span)


_dump_installed = False


def install_shutdown_dump() -> None:
    """Ask for the ring to be written to disk when the process shuts down
    (idempotent).  Entrypoints call this once at boot; the serve entry
    point's SIGTERM drain then calls ``shutdown_dump`` after the server
    closes (no signal handler is installed here: the drain owns the
    process's handlers and restores them)."""
    global _dump_installed
    _dump_installed = True


def shutdown_dump() -> Optional[str]:
    """The shutdown hook: ``RECORDER.dump()`` when ``install_shutdown_dump``
    ran, else nothing.  Returns the path written, or None."""
    if not _dump_installed:
        return None
    return RECORDER.dump()
