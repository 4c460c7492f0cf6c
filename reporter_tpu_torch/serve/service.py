"""HTTP matching service.

Wire-compatible with the reference's reporter service on its main route:

  GET  /report?json={...}   and   POST /report
      -> {"datastore": ..., "segment_matcher": ..., "shape_used": ...,
          "stats": ...}
      with the same validation errors (uuid required, >= 2 points,
      report_levels / transition_levels required).  A trace of any length
      is matched; those over the largest length bucket stream through
      windows with carried state.
  POST /report with "stream": true
      -> the same report over the vehicle's session window (its rolling
      tail plus the new points), plus a "session" block; one point is
      enough.
  POST /trace_attributes_batch   {"traces": [trace, ...]}
      -> {"results": [report, ...]} in request order; a bad trace is a
      400 that names its index ("trace %d: ...").
  GET  /health -> {"status": "ok", "capabilities": [...], ...}
  GET  /sessions[?uuid=U | ?export=1], POST /sessions {"sessions" | "drop"
      | "pop": [...]}: the session store's summary, one session, every
      session's wire snapshot (the handoff's export), and its import,
      drop and atomic pop.

Observability, as the JAX package's service has it (docs/observability.md):

  GET  /metrics          Prometheus text of every registered family
  GET  /statusz          JSON ops snapshot: config, fault-domain state,
                         flight / attrib / slo / quality / sparse /
                         sessions / slab / tier / adaptive / checkpoint /
                         economics / memory blocks, and every family
  GET  /debug/traces?n=K | ?id=T   the flight recorder's retained traces
  GET  /debug/slo[?window=S]       the SLO engine's verdict (+ quality)
  GET  /debug/profile?seconds=N    a torch.profiler capture's directory
  GET  /debug/attrib[?capture=1&reps=N]   the per-stage device-time table
  GET  /debug/cost, /debug/history[?window=S]   the cost ledger and the
                         demand-history ring

Every response echoes X-Reporter-Trace (the client's id, or one minted at
ingestion); every /report and /trace_attributes_batch request carries a
span stamped at each stage, offered to the flight recorder and the SLO
engine, and put on the response under ``?debug=1``.  The config's "slo",
"quality" and "economics" blocks (and their $REPORTER_* knobs) tune the
SLO engine, the shadow-oracle sampler (off unless sample_every or
$REPORTER_QUALITY_SAMPLE_EVERY is set) and the cost ledger.  Both
batchers steer their fill window and width by the live queue-wait and
device-step p95s ($REPORTER_ADAPTIVE=0 holds them at the configured
values).

Both matching routes take gzip bodies (Content-Encoding: gzip, inflated
within $REPORTER_MAX_INFLATE_MB, 256 by default; another encoding than
identity is a 415) and the binary columnar wire (serve/wire.py):
Content-Type application/x-reporter-columnar bodies decode as frames, and
Accept: application/x-reporter-columnar gets a frame back on a 200 (every
error stays JSON).  $REPORTER_WIRE=0 turns the binary wire off (binary
bodies get a 415).  A decoded trace keeps the frame's float64 columns
(``"_columns"``) through the match, whose columnar packer reads them in
place of the point dicts; they are dropped before anything renders,
echoes, records or samples the trace.

Fault domains (the "robustness" config block; each knob's $REPORTER_*
variable overrides it):

  admission   the submit queue holds at most max_queue traces (1024) and
              sheds past it with a 429 and a Retry-After header; a trace
              waits at most deadline_ms in the queue (30000; <= 0 turns
              the server's default off), or the client's
              X-Reporter-Deadline-Ms from ingestion, and is answered 504
              before dispatch once that has passed.
  poison      a failed batch is bisect-retried, so one bad trace fails
              alone (500 "failed its device batch alone") while its
              neighbours are answered; a uuid isolated quarantine_after
              times (2) is refused 422 for quarantine_ttl_s (300).
  watchdog    every device-blocking section is bounded by watchdog_s
              (120; <= 0 off).  A trip wedges the batcher and enters
              degraded mode: requests are answered by the CPU baseline
              over the same arrays and table with "degraded": true (in
              /health too) until a probe every reattach_probe_s (15)
              finds the device healthy and fresh batchers take over.
              The matcher config's cpu_fallback false answers a wedge
              with 503.  Only a trip enters degraded mode: a failed
              launch is a failed batch.
  crash       a batcher loop thread that dies fails every pending request
              (503) and turns /health into 503 "unhealthy".
  drain       ``begin_drain`` (the serve entry point's SIGTERM) refuses
              new matching work with 503 "draining" and Retry-After,
              /health answers 503 "draining", inflight requests finish.
  sessions    with session_checkpoint_s > 0 and session_checkpoint_dir
              set, dirty sessions are checkpointed to
              <dir>/<replica id> (session_checkpoint_sync: at every
              commit); $REPORTER_REPLICA_ID names the replica.

A single shared matcher owns the device.  One MicroBatcher aggregates
concurrent windowed requests into padded [B, T] batches; a second one, with
a much shorter fill window, aggregates streaming submits into session
steps (matching/session.py).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import queue
import socket as _socket
import threading
import time as _time
import zlib
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Set, Tuple
from urllib.parse import parse_qs, urlsplit

from .. import faults
from ..matching import SegmentMatcher, SessionEngine, SessionStore
from ..matching.matcher import C_POINTS as C_POINTS_MATCHED
from ..matching.session import SessionCheckpointer
from ..obs import adaptive as obs_adaptive
from ..obs import attrib as obs_attrib
from ..obs import economics as obs_econ
from ..obs import flight as obs_flight
from ..obs import log as obs_log
from ..obs import metrics as obs
from ..obs import quality as obs_quality
from ..obs import slo as obs_slo
from ..obs import trace as obs_trace
from ..obs.trace import Span
from ..report import report as report_fn
from . import wire

log = logging.getLogger(__name__)

ACTIONS = {"report", "trace_attributes_batch", "health", "sessions",
           "metrics", "statusz", "profile", "traces", "attrib", "slo",
           "cost", "history"}

# gzip request bodies: bound on the DECOMPRESSED size so a tiny zip bomb
# cannot balloon a handler thread, refused with a 400 beyond it
# ($REPORTER_MAX_INFLATE_MB overrides)
try:
    _MAX_INFLATE = int(float(os.environ["REPORTER_MAX_INFLATE_MB"])) << 20
except (KeyError, ValueError):
    _MAX_INFLATE = 256 << 20

# metric families (docs/observability.md): the batch-fill/wait tradeoff and
# the device-step tail are the operating signals of a batched-device
# service — aggregate throughput alone cannot show a queue-wait regression
M_QUEUE_WAIT = obs.histogram(
    "reporter_microbatch_queue_wait_seconds",
    "Per-trace wait from submit to micro-batch formation")
M_BATCH_FILL = obs.histogram(
    "reporter_microbatch_batch_fill",
    "Traces per dispatched device micro-batch",
    buckets=obs.BATCH_FILL_BUCKETS)
M_DEVICE_STEP = obs.histogram(
    "reporter_microbatch_device_step_seconds",
    "Per-batch finish() wall: device wait + host segment association")
G_INFLIGHT = obs.gauge(
    "reporter_microbatch_inflight",
    "Micro-batches dispatched to the device and not yet finished")
G_QDEPTH = obs.gauge(
    "reporter_microbatch_queue_depth",
    "Submit-queue depth sampled at each batch formation")
C_BATCHES = obs.counter(
    "reporter_microbatch_batches_total",
    "Device micro-batches dispatched")
C_REQUESTS = obs.counter(
    "reporter_requests_total",
    "Requests by endpoint and outcome (ok / invalid / error / shed / "
    "expired / quarantined / degraded)",
    ("endpoint", "outcome"))
# the fault domains (docs/robustness.md): shedding, queue expiry, poison
# isolation, the watchdog and the degraded CPU fallback each have a family
C_SHED = obs.counter(
    "reporter_requests_shed_total",
    "Requests rejected 429 at admission (submit queue full)")
C_EXPIRED = obs.counter(
    "reporter_requests_expired_total",
    "Requests whose deadline expired in the queue, dropped before "
    "dispatch (504)")
C_POISON = obs.counter(
    "reporter_poison_isolated_total",
    "Traces isolated as batch poison by the bisect-retry quarantine")
C_QUAR_REJ = obs.counter(
    "reporter_quarantine_rejected_total",
    "Requests rejected at admission because their uuid is quarantined "
    "as a repeat poison offender")
C_WD_TRIPS = obs.counter(
    "reporter_watchdog_trips_total",
    "Device-step watchdog trips (a finish() exceeded the bound; the "
    "batcher is wedged and the service degrades to the CPU fallback)")
C_CRASHES = obs.counter(
    "reporter_batcher_crashes_total",
    "MicroBatcher loop-thread crashes (dispatch worker or finisher died "
    "on an unexpected error; pending futures failed, /health unhealthy)")
G_DEGRADED = obs.gauge(
    "reporter_degraded_mode",
    "1 while the service answers from the CPU fallback after a device "
    "watchdog trip, 0 when the accelerator engine is attached")
C_DEGRADED_REQ = obs.counter(
    "reporter_degraded_requests_total",
    "Requests answered by the CPU fallback (responses carry "
    "degraded: true)")
C_REATTACH = obs.counter(
    "reporter_engine_reattach_total",
    "Successful engine re-attach events after degraded-mode probes found "
    "the device healthy again")
# the drain's lifecycle (docs/serving-fleet.md)
G_DRAINING = obs.gauge(
    "reporter_draining",
    "1 from SIGTERM (drain start) until the process exits: new work is "
    "refused 503 \"draining\" while inflight requests finish")
C_DRAIN_REFUSED = obs.counter(
    "reporter_drain_refused_total",
    "Requests refused 503 \"draining\" after drain start (retryable: the "
    "router re-dispatches them to a live replica)")

# the fault domains' events in this process, by name: each is read from its
# family, but degraded-mode entries, which have none
_COUNT_FAMILIES = {"watchdog_trips": C_WD_TRIPS, "poison_isolations": C_POISON,
                   "quarantine_rejections": C_QUAR_REJ,
                   "batcher_crashes": C_CRASHES,
                   "degraded_requests": C_DEGRADED_REQ,
                   "reattaches": C_REATTACH, "drain_refusals": C_DRAIN_REFUSED}
_COUNT_NAMES = ("watchdog_trips", "poison_isolations", "quarantine_rejections",
                "batcher_crashes", "degraded_entries", "degraded_requests",
                "reattaches", "drain_refusals")
_degraded_entries = [0]
_counts_lock = threading.Lock()


def _count(name: str, n: int = 1) -> None:
    if name != "degraded_entries":
        _COUNT_FAMILIES[name].inc(n)
        return
    with _counts_lock:
        _degraded_entries[0] += n


def counts() -> dict:
    """The fault domains' event counts in this process."""
    out = {name: int(fam.value) for name, fam in _COUNT_FAMILIES.items()}
    with _counts_lock:
        out["degraded_entries"] = _degraded_entries[0]
    return {name: out[name] for name in _COUNT_NAMES}


def _gunzip(raw: bytes, limit: int = 0) -> bytes:
    """Bounded gzip-body inflate (16 + MAX_WBITS accepts the gzip
    header).  Raises ValueError past ``limit`` decompressed bytes."""
    limit = limit or _MAX_INFLATE
    d = zlib.decompressobj(16 + zlib.MAX_WBITS)
    out = d.decompress(raw, limit)
    if d.unconsumed_tail:
        raise ValueError("gzip body exceeds %d decompressed bytes" % limit)
    return out + d.flush()


def _resolve_num(env_name: str, param, default: float) -> float:
    """A fault-domain knob: the environment's value (a malformed one falls
    back to the default) over the config's or constructor's, over the
    default."""
    fallback = float(default if param is None else param)
    if os.environ.get(env_name, "").strip():
        try:
            return float(os.environ[env_name])
        except ValueError:
            return fallback
    return fallback


def _on_card(matcher) -> bool:
    """Whether ``matcher`` (or a SessionEngine's matcher) computes on a
    CUDA device rather than on host cores."""
    m = getattr(matcher, "matcher", matcher)
    dev = getattr(m, "device", None)
    return (getattr(m, "backend", "cpu") != "cpu"
            and getattr(dev, "type", str(dev)).startswith("cuda"))


class Overloaded(RuntimeError):
    """Submit queue full: shed with 429 + Retry-After (retryable)."""


class DeadlineExpired(RuntimeError):
    """The request's deadline passed while it sat in the queue: 504,
    dropped before it could take a device slot."""


class TraceQuarantined(RuntimeError):
    """The uuid is a repeat poison offender: refused at admission with a
    non-retryable 422."""


class PoisonTrace(RuntimeError):
    """This trace made its device batch fail while its co-batched
    neighbours succeeded on bisect-retry."""


class DeviceWedged(RuntimeError):
    """The watchdog tripped: the device step is wedged and this batcher
    takes no more work (the service answers from the CPU baseline)."""


class BatcherCrashed(RuntimeError):
    """A MicroBatcher loop thread died on an unexpected error; the batcher
    is dead and /health reports unhealthy."""


class MicroBatcher:
    """Aggregates traces from concurrent requests into one device batch.

    Traces are enqueued with a Future; a dispatch thread drains the queue,
    waits up to ``max_wait_ms`` to fill ``max_batch`` slots and queues the
    device work (``matcher.match_many_async``: a SegmentMatcher's, or a
    SessionEngine's for streaming submits); a finisher thread blocks on
    the device, runs host association and resolves the futures, so
    association of batch N overlaps device work of batch N+1.  The hand-off
    queue holds at most ``max_inflight`` batches, which bounds the
    device-pinned inputs and outputs of batches not yet associated: 4 by
    default when the matcher computes on the card, 2 when it computes on
    host cores (where it shares them with association), at least 1.

    Fault domains.  Admission: the submit queue holds at most
    ``max_queue`` traces and ``submit`` sheds past it with Overloaded;
    every entry carries a deadline (``deadline_ms`` from submit, or the
    server's; <= 0 sets none unless the caller gives one), and entries
    whose deadline has passed are resolved with DeadlineExpired before
    dispatch, so they never take a device slot.  Poison: a failed batch is
    bisect-retried with ``match_many`` on the finisher (at most 2 B + 4
    retries), so a poison trace fails alone with PoisonTrace while its
    neighbours get their results; a uuid isolated ``quarantine_after``
    times is refused with TraceQuarantined for ``quarantine_ttl_s``.  The
    watchdog: every device-blocking section (the finisher's ``finish()``,
    bisect's ``match_many``) runs under ``_watched``; one that outlasts
    ``watchdog_s`` trips it, the batcher wedges (``submit`` raises
    DeviceWedged), ``on_wedged`` runs first, then the stuck batch and
    everything queued fail with DeviceWedged (a late finish of a failed
    batch resolves nothing: resolutions are idempotent).  Crash-loud
    loops: a loop thread that dies fails every pending future with
    BatcherCrashed, marks the batcher dead and calls ``on_crashed``; the
    hand-off ``put`` gives up once the batcher is dead, so no thread waits
    on a queue nobody drains.  ``trips`` (1 once the watchdog tripped)
    and ``quarantined()`` say what happened here, the module's ``counts()``
    what happened in the process; ``close`` stops every thread.

    Observability: each entry may carry its request's Span, stamped with
    its queue wait, batch size, dispatch and device-step walls; the
    batches feed the reporter_microbatch_* families.  The adaptive
    controls (obs/adaptive.py, on unless $REPORTER_ADAPTIVE=0): the live windowed p95s of queue wait and device
    step steer ``max_wait`` within [0.2x, 4x] the configured window and
    ``max_batch`` within [max_batch / 4, max_batch].
    """

    def __init__(self, matcher, max_batch: int = 64, max_wait_ms: float = 10.0,
                 max_inflight: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 watchdog_s: Optional[float] = None,
                 quarantine_after: Optional[int] = None,
                 quarantine_ttl_s: Optional[float] = None,
                 on_wedged=None, on_crashed=None, name: str = "batch"):
        if max_inflight is None:
            max_inflight = 4 if _on_card(matcher) else 2
        # a queue.Queue of maxsize <= 0 is unbounded: clamp a configured 0
        # to the strictest bound instead
        self.max_inflight = max(1, int(max_inflight))
        self.matcher = matcher
        self.max_batch = max(1, int(max_batch))
        self.max_wait = max_wait_ms / 1000.0
        # the adaptive fill window and batch width: absent (the static
        # knobs, bit for bit) with REPORTER_ADAPTIVE=0
        self._wait_ctl = self._batch_ctl = None
        self._h_qwait = self._h_dstep = None
        self._static_max_batch = self.max_batch
        if obs_adaptive.enabled() and self.max_wait > 0:
            static = self.max_wait
            self._wait_ctl = obs_adaptive.Controller(
                "%s_wait_s" % name, static,
                lo=max(0.0005, 0.2 * static), hi=4.0 * static,
                cooldown_s=1.0)
            self._h_qwait = obs_adaptive.WindowedQuantile(window_s=30.0)
            self._h_dstep = obs_adaptive.WindowedQuantile(window_s=60.0)
            if self.max_batch > 1:
                self._batch_ctl = obs_adaptive.Controller(
                    "%s_max_batch" % name, float(self.max_batch),
                    lo=max(1.0, self.max_batch / 4.0), hi=float(self.max_batch),
                    cooldown_s=1.0)
        self.max_queue = max(1, int(_resolve_num("REPORTER_MAX_QUEUE", max_queue, 1024)))
        self.deadline_s = _resolve_num("REPORTER_DEADLINE_MS", deadline_ms, 30000.0) / 1000.0
        self.watchdog_s = _resolve_num("REPORTER_WATCHDOG_S", watchdog_s, 120.0)
        self.quarantine_after = int(_resolve_num("REPORTER_QUARANTINE_AFTER",
                                                 quarantine_after, 2))
        self.quarantine_ttl_s = _resolve_num("REPORTER_QUARANTINE_TTL_S",
                                             quarantine_ttl_s, 300.0)
        # wedged: the watchdog tripped; crashed: a loop thread died.  Both
        # are terminal: the service makes new batchers on re-attach
        self.wedged = False
        self._wedge_reason: Optional[str] = None
        self._crashed = False
        self._crash_reason: Optional[str] = None
        self._on_wedged = on_wedged
        self._on_crashed = on_crashed
        self._offender_lock = threading.Lock()
        self._offenders: dict = {}    # uuid -> poison isolations
        self._quarantine: dict = {}   # uuid -> monotonic expiry
        # device-blocking sections under watch: thread id -> (t0, batch)
        self._step_lock = threading.Lock()
        self._steps: dict = {}
        self._q: "queue.Queue" = queue.Queue(maxsize=self.max_queue)
        self._finish_q: "queue.Queue" = queue.Queue(maxsize=self.max_inflight)
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="%s-dispatch" % name)
        self._finisher = threading.Thread(target=self._finish_worker,
                                          daemon=True, name="%s-finish" % name)
        self._thread.start()
        self._finisher.start()
        self._watchdog_thread = None
        if self.watchdog_s > 0:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog, daemon=True, name="%s-watchdog" % name)
            self._watchdog_thread.start()

    def submit(self, trace: dict, deadline: Optional[float] = None,
               span: Optional[Span] = None) -> Future:
        """Queue one trace.  Refuses when the batcher is closed, dead
        (BatcherCrashed), wedged (DeviceWedged) or the uuid quarantined
        (TraceQuarantined); sheds with Overloaded when the queue is full.
        ``deadline`` is an absolute ``time.monotonic()`` bound; None applies
        the server's default.  ``span`` (the request's) gets the entry's
        stage marks."""
        if self._closed.is_set():
            raise RuntimeError("batcher closed")
        if self._crashed:
            raise BatcherCrashed(self._crash_reason or "batcher thread died")
        if self.wedged:
            raise DeviceWedged(self._wedge_reason or "device step wedged")
        uuid = str(trace.get("uuid") or "") if isinstance(trace, dict) else ""
        if uuid and self._is_quarantined(uuid):
            _count("quarantine_rejections")
            raise TraceQuarantined("uuid %r is quarantined after repeated "
                                   "poison-batch isolation" % uuid)
        now = _time.monotonic()
        if deadline is None and self.deadline_s > 0:
            deadline = now + self.deadline_s
        f: Future = Future()
        try:
            self._q.put_nowait((trace, f, now, deadline, span))
        except queue.Full:
            C_SHED.inc()
            raise Overloaded("submit queue full (%d waiting)" % self._q.qsize()) from None
        return f

    def match(self, trace: dict, deadline: Optional[float] = None,
              span: Optional[Span] = None) -> dict:
        return self.submit(trace, deadline, span).result()

    def match_many(self, traces: List[dict], deadline: Optional[float] = None) -> List[dict]:
        futures = [self.submit(t, deadline) for t in traces]
        return [f.result() for f in futures]

    def _adapt_wait(self, fill: int) -> None:
        """One adaptive tick for the fill window (no-op with
        REPORTER_ADAPTIVE=0): queue wait dominating the device step means
        holding the window open is the tail — shrink it; a device step
        that dwarfs the wait on batches that fill means amortisation wins
        — grow it.  The Controller clamps, ignores in-deadband noise and
        rate-limits moves."""
        ctl = self._wait_ctl
        if ctl is None:
            return
        if self._h_qwait.count() < 32 or self._h_dstep.count() < 8:
            return  # not enough live signal to steer by
        q95 = self._h_qwait.quantile(0.95)
        d95 = self._h_dstep.quantile(0.95)
        if q95 is None or d95 is None:
            return
        if q95 > 2.0 * d95 and q95 > self.max_wait:
            self.max_wait = ctl.propose(0.7 * self.max_wait)
        elif d95 > 4.0 * max(q95, self.max_wait) \
                and fill >= max(2, self.max_batch // 2):
            self.max_wait = ctl.propose(1.3 * self.max_wait)
        self._adapt_batch(fill, q95, d95)

    def _adapt_batch(self, fill: int, q95: float, d95: float) -> None:
        """One adaptive tick for the batch width: a device-step p95 that
        dominates the queue tail on batches that fill to the cap narrows
        it; once the step stops dominating it glides back to the
        configured cap, never past it."""
        ctl = self._batch_ctl
        if ctl is None:
            return
        if d95 > 4.0 * max(q95, 1e-4) and fill >= self.max_batch:
            self.max_batch = max(1, int(round(
                ctl.propose(0.7 * ctl.value))))
        elif d95 < 2.0 * max(q95, 1e-4) \
                and ctl.value < self._static_max_batch:
            self.max_batch = max(1, int(round(
                ctl.propose(1.3 * ctl.value))))

    def retry_after_s(self) -> int:
        """Backoff hint of a 429: the deeper the queue, the longer, capped
        so that clients re-probe within their retry budget."""
        return max(1, min(30, 1 + self._q.qsize() // self.max_batch))

    def quarantined(self) -> int:
        """uuids in quarantine now."""
        with self._offender_lock:
            return len(self._quarantine)

    def close(self, timeout: float = 5.0) -> None:
        """Stop the threads after the work already queued (a wedged
        finisher stays behind: it cannot be interrupted)."""
        self._closed.set()
        try:
            self._q.put(None, timeout=timeout)
        except queue.Full:
            log.warning("batcher queue still full at close; its threads stay behind")
            return
        for th in (self._thread, self._finisher, self._watchdog_thread):
            if th is not None:
                th.join(timeout)

    # -- future resolution: idempotent, since the watchdog may have failed
    # a future that a stuck thread later resolves ----------------------------

    @staticmethod
    def _resolve_exc(f: Future, e: BaseException) -> None:
        try:
            if not f.done() and f.set_running_or_notify_cancel():
                f.set_exception(e)
        except Exception:  # noqa: BLE001 - resolved elsewhere meanwhile
            pass

    @staticmethod
    def _resolve_result(f: Future, r) -> None:
        try:
            if not f.done() and f.set_running_or_notify_cancel():
                f.set_result(r)
        except Exception:  # noqa: BLE001 - resolved elsewhere meanwhile
            pass

    @classmethod
    def _fail_batch(cls, batch, e: BaseException) -> None:
        for entry in batch:
            cls._resolve_exc(entry[1], e)

    def _live(self, batch):
        """The entries whose deadline has not passed; the others are
        answered with DeadlineExpired now.  The clock_skew fault seam
        scales each entry's elapsed time (1.0 when disarmed)."""
        now = _time.monotonic()
        skew = faults.scale("clock_skew")
        live = []
        for entry in batch:
            dl = entry[3]
            eff = now if skew == 1.0 else entry[2] + (now - entry[2]) * skew
            if dl is not None and eff > dl:
                C_EXPIRED.inc()
                self._resolve_exc(entry[1], DeadlineExpired(
                    "deadline expired after %.3fs in queue" % (now - entry[2])))
            else:
                live.append(entry)
        return live

    # -- loop threads (crash-loud) -------------------------------------------

    def _worker(self):
        try:
            self._worker_loop()
        except BaseException as e:  # noqa: BLE001 - crash-loud by design
            self._crash("dispatch worker", e)

    def _finish_worker(self):
        try:
            self._finisher_loop()
        except BaseException as e:  # noqa: BLE001 - crash-loud by design
            self._crash("finisher", e)

    def _hand_off(self, item) -> bool:
        """Put ``item`` on the bounded hand-off queue, blocking while the
        finisher lags; False once the batcher is dead."""
        while True:
            try:
                self._finish_q.put(item, timeout=0.25)
                return True
            except queue.Full:
                if self.wedged or self._crashed:
                    return False

    def _worker_loop(self):
        while True:
            entry = self._q.get()
            if entry is None:
                self._hand_off(None)
                return
            batch = [entry]
            deadline = _time.monotonic() + self.max_wait
            stop = False
            while len(batch) < self.max_batch:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                batch.append(nxt)
            batch = self._live(batch)
            if batch:
                self._dispatch(batch)
            if stop:
                self._hand_off(None)
                return

    def _dispatch(self, batch) -> None:
        """Stamp and count a formed batch, queue its device work and hand
        it to the finisher."""
        now = _time.monotonic()
        # the batch's lead span: its trace_id is the exemplar of the
        # batch-level observations, and the dispatch binds it so a first
        # dispatch's log line names a real request
        lead = next((e[4] for e in batch if e[4] is not None), None)
        G_QDEPTH.set(self._q.qsize())
        M_BATCH_FILL.observe(len(batch),
                             exemplar=lead.trace_id if lead else None)
        C_BATCHES.inc()
        for _t, _f, t_enq, _dl, sp in batch:
            wait = now - t_enq
            M_QUEUE_WAIT.observe(wait, exemplar=sp.trace_id if sp else None)
            if self._h_qwait is not None:
                self._h_qwait.observe(wait)
            if sp is not None:
                sp.mark("queue_wait_s", wait)
                sp.meta["batch_size"] = len(batch)
        self._adapt_wait(len(batch))
        try:
            t_d0 = _time.monotonic()
            with obs_trace.bind(lead):
                finish = self.matcher.match_many_async([e[0] for e in batch])
            dispatch_s = _time.monotonic() - t_d0
        except Exception as e:  # noqa: BLE001 - contained per request
            log.exception("batch dispatch failed")
            self._contain_failure(batch, e)
            return
        for entry in batch:
            if entry[4] is not None:
                entry[4].mark("dispatch_s", dispatch_s)
        G_INFLIGHT.inc()
        if not self._hand_off((batch, finish)):
            self._fail_batch(batch, DeviceWedged(self._wedge_reason or "batcher dead"))
            G_INFLIGHT.dec()

    def _finisher_loop(self):
        while True:
            item = self._finish_q.get()
            if item is None:
                return
            batch, finish = item
            try:
                t0 = _time.monotonic()
                with self._watched(batch):
                    results = finish()
                step_s = _time.monotonic() - t0
                if self._h_dstep is not None:
                    self._h_dstep.observe(step_s)
                lead = next((e[4] for e in batch if e[4] is not None), None)
                M_DEVICE_STEP.observe(step_s,
                                      exemplar=lead.trace_id if lead else None)
                for entry, r in zip(batch, results):
                    if entry[4] is not None:
                        entry[4].mark("device_step_s", step_s)
                    self._resolve_result(entry[1], r)
            except Exception as e:  # noqa: BLE001 - bisect for poison, else fail
                log.exception("batch match failed")
                self._contain_failure(batch, e)
            finally:
                G_INFLIGHT.dec()

    # -- the device watchdog --------------------------------------------------

    @contextlib.contextmanager
    def _watched(self, batch):
        """Register the calling thread's device-blocking section with the
        watchdog (finish() on the finisher, match_many in bisect-retry)."""
        tid = threading.get_ident()
        with self._step_lock:
            self._steps[tid] = (_time.monotonic(), batch)
        try:
            yield
        finally:
            with self._step_lock:
                self._steps.pop(tid, None)

    def _watchdog(self):
        """Bound every device-blocking section: a wedged step becomes a
        visible, contained failure, not a silently hung server."""
        tick = max(0.02, min(1.0, self.watchdog_s / 8.0))
        while not (self.wedged or self._crashed):
            if self._closed.wait(tick):
                return
            now = _time.monotonic()
            with self._step_lock:
                stuck = [b for (t0, b) in self._steps.values()
                         if now - t0 > self.watchdog_s]
            if stuck:
                self._trip("device step exceeded the %.1fs watchdog" % self.watchdog_s,
                           stuck)
                return

    @property
    def trips(self) -> int:
        """1 once the watchdog tripped this batcher (it trips at most
        once: a wedged batcher is terminal)."""
        return int(self.wedged)

    def _trip(self, reason: str, stuck_batches=()) -> None:
        _count("watchdog_trips")
        self.wedged = True
        self._wedge_reason = reason
        obs_log.event(log, "watchdog_trip", level=logging.ERROR, reason=reason)
        exc = DeviceWedged(reason)
        # the service turns degraded FIRST: handlers whose futures fail
        # below see it and answer from the CPU baseline instead of a 503
        if self._on_wedged is not None:
            try:
                self._on_wedged(reason)
            except Exception:  # noqa: BLE001 - never lose the trip itself
                log.exception("on_wedged callback failed")
        # the stuck thread cannot be interrupted (it blocks in the device
        # runtime); its batch's futures fail now, and its late
        # resolutions are no-ops
        for b in stuck_batches:
            self._fail_batch(b, exc)
        self._drain_fail(exc)

    def _crash(self, who: str, e: BaseException) -> None:
        if self._crashed:
            return
        self._crashed = True
        self._crash_reason = "%s thread died: %s" % (who, e)
        _count("batcher_crashes")
        log.critical("MicroBatcher %s; failing all pending futures",
                     self._crash_reason, exc_info=True)
        obs_log.event(log, "batcher_crash", level=logging.CRITICAL,
                      thread=who, error=str(e)[:200])
        # the submit queue always fails (its only consumer is gone or the
        # batcher is dead to new work); the hand-off queue only when the
        # finisher died, since a live finisher completes what was
        # dispatched
        self._drain_fail(BatcherCrashed(self._crash_reason),
                         include_dispatched=(who == "finisher"))
        if self._on_crashed is not None:
            try:
                self._on_crashed(who, e)
            except Exception:  # noqa: BLE001
                log.exception("on_crashed callback failed")

    def _drain_fail(self, exc: Exception, include_dispatched: bool = True) -> None:
        """Fail everything queued in the batcher: the submit queue, and
        (unless the finisher lives to complete them) the dispatched
        batches on the hand-off queue."""
        while True:
            try:
                entry = self._q.get_nowait()
            except queue.Empty:
                break
            if entry is not None:
                self._resolve_exc(entry[1], exc)
        if not include_dispatched:
            return
        while True:
            try:
                item = self._finish_q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._fail_batch(item[0], exc)
                G_INFLIGHT.dec()

    # -- poison containment ---------------------------------------------------

    def _contain_failure(self, batch, exc: Exception) -> None:
        """A dispatched batch failed.  One malformed trace must not fail its
        co-batched neighbours: bisect-retry to isolate the poison, fail
        only the offender(s) and answer everyone else."""
        if (self.wedged or self._crashed
                or isinstance(exc, (DeviceWedged, BatcherCrashed))):
            self._fail_batch(batch, exc)
            return
        if len(batch) == 1:
            self._fail_poison(batch[0], exc)
            return
        obs_log.event(log, "poison_bisect", level=logging.WARNING,
                      batch_size=len(batch), error=str(exc)[:200])
        self._bisect(batch, exc, [2 * len(batch) + 4])

    def _bisect(self, batch, exc: Exception, budget) -> None:
        if len(batch) == 1:
            self._fail_poison(batch[0], exc)
            return
        if budget[0] <= 0:
            # a systemic failure (every retry fails): stop paying for
            # retries and fail the rest with the underlying error
            self._fail_batch(batch, exc)
            return
        mid = len(batch) // 2
        for half in (batch[:mid], batch[mid:]):
            budget[0] -= 1
            try:
                with self._watched(half):
                    results = self.matcher.match_many([e[0] for e in half])
            except Exception as e2:  # noqa: BLE001 - recurse to isolate
                self._bisect(half, e2, budget)
            else:
                for entry, r in zip(half, results):
                    self._resolve_result(entry[1], r)

    def _fail_poison(self, entry, exc: Exception) -> None:
        trace, f, sp = entry[0], entry[1], entry[4]
        uuid = str(trace.get("uuid") or "") if isinstance(trace, dict) else ""
        _count("poison_isolations")
        if uuid:
            self._record_offender(uuid)
        if sp is not None:
            sp.meta["poison"] = True
        obs_log.event(log, "poison_trace", level=logging.ERROR, uuid=uuid[:64],
                      trace_id=sp.trace_id if sp else None, error=str(exc)[:200])
        self._resolve_exc(f, PoisonTrace(
            "trace %r failed its device batch alone (co-batched requests "
            "succeeded): %s" % (uuid, exc)))

    def _record_offender(self, uuid: str) -> None:
        with self._offender_lock:
            n = self._offenders.get(uuid, 0) + 1
            self._offenders[uuid] = n
            if n >= self.quarantine_after:
                self._quarantine[uuid] = _time.monotonic() + self.quarantine_ttl_s
                obs_log.event(log, "uuid_quarantined", level=logging.WARNING,
                              uuid=uuid[:64], offences=n,
                              ttl_s=self.quarantine_ttl_s)

    def _is_quarantined(self, uuid: str) -> bool:
        with self._offender_lock:
            exp = self._quarantine.get(uuid)
            if exp is None:
                return False
            if _time.monotonic() > exp:
                del self._quarantine[uuid]
                self._offenders.pop(uuid, None)
                return False
            return True


class ReporterService:
    """Owns the matcher and the batchers and implements /report,
    /trace_attributes_batch, /health, /sessions and the observability
    endpoints.

    ``matcher`` None defers the engine, as the reference's does: the
    socket can bind and /health answer (200, "warming": true, "backend":
    null) before the matcher is built; /report, /trace_attributes_batch
    and /sessions answer 503 "service initialising" until
    ``attach_matcher`` runs.

    ``slo`` (the config's "slo" block) declares the serving objectives the
    SLO engine measures every terminal outcome against (None keeps the
    $REPORTER_SLO_* defaults without touching an engine another embedder
    configured); ``quality`` (the "quality" block) tunes the shadow-oracle
    sampler, off unless its sample_every or $REPORTER_QUALITY_SAMPLE_EVERY
    is above 0; ``economics`` (the "economics" block) prices the cost
    ledger and places the demand history ($REPORTER_HISTORY_DIR over its
    history_dir)."""

    # the "robustness" keys the reference reads, all carried; any other
    # key is dropped with one warning per key
    ROBUSTNESS_KEYS = ("max_queue", "deadline_ms", "watchdog_s", "quarantine_after",
                       "quarantine_ttl_s", "reattach_probe_s", "session_checkpoint_s",
                       "session_checkpoint_sync", "session_checkpoint_dir")
    # the MicroBatcher's share of them
    BATCHER_KEYS = ROBUSTNESS_KEYS[:5]

    def __init__(self, matcher: Optional[SegmentMatcher],
                 threshold_sec: Optional[int] = None,
                 max_batch: int = 64, max_wait_ms: float = 10.0,
                 max_inflight: Optional[int] = None, robustness: Optional[dict] = None,
                 session_max_batch: int = 256, session_wait_ms: float = 2.0,
                 slo: Optional[dict] = None, quality: Optional[dict] = None,
                 economics: Optional[dict] = None):
        from ..matching.config import warn_dropped

        self._threshold_arg = threshold_sec
        self.threshold_sec: Optional[int] = None
        rb = dict(robustness or {})
        for k in rb:
            if k not in self.ROBUSTNESS_KEYS:
                warn_dropped("robustness config", k)
        self._batch_params = dict(max_batch=max_batch, max_wait_ms=max_wait_ms,
                                  max_inflight=max_inflight)
        self._session_params = dict(max_batch=session_max_batch,
                                    max_wait_ms=session_wait_ms)
        self._robust_params = {k: rb[k] for k in self.BATCHER_KEYS if k in rb}
        self._reattach_probe_s = _resolve_num("REPORTER_REATTACH_PROBE_S",
                                              rb.get("reattach_probe_s"), 15.0)
        self._ckpt_s = _resolve_num("REPORTER_SESSION_CHECKPOINT_S",
                                    rb.get("session_checkpoint_s"), 0.0)
        sync_raw = os.environ.get("REPORTER_SESSION_CHECKPOINT_SYNC", "").strip()
        self._ckpt_sync = (sync_raw.lower() not in ("0", "off", "false", "no") if sync_raw
                           else bool(rb.get("session_checkpoint_sync", False)))
        self._ckpt_dir = (os.environ.get("REPORTER_SESSION_CHECKPOINT_DIR", "").strip()
                          or rb.get("session_checkpoint_dir"))
        # the replica's name: the checkpoint directory's, and echoed as
        # X-Reporter-Replica on every answer
        self.replica_id = (os.environ.get("REPORTER_REPLICA_ID", "").strip()
                           or "%s-%d" % (_socket.gethostname()[:32], os.getpid()))
        if slo is not None:
            obs_slo.configure(slo)
        self._quality_spec = dict(quality or {})
        self.quality: "Optional[obs_quality.QualityEngine]" = None
        self._margin_keep = _resolve_num("REPORTER_QUALITY_MARGIN_KEEP",
                                         self._quality_spec.get("margin_keep"), 1.0)
        # the cost ledger, demand history and capacity estimator behind
        # /debug/cost and /debug/history; its tick thread and scrape-time
        # collectors arm in make_server()
        econ_spec = dict(economics or {})
        hist_dir = (os.environ.get("REPORTER_HISTORY_DIR", "").strip()
                    or econ_spec.get("history_dir"))
        self.economics = obs_econ.EconomicsEngine(
            self.replica_id, chips=1, spec=econ_spec,
            history_path=(os.path.join(hist_dir, "%s.jsonl" % self.replica_id)
                          if hist_dir else None))
        # degraded mode: after a watchdog trip requests are answered by the
        # CPU baseline with "degraded": true until a probe re-attaches
        self.degraded = False
        self._degraded_lock = threading.Lock()
        self._cpu_matcher: Optional[SegmentMatcher] = None
        self._cpu_lock = threading.Lock()
        self.unhealthy_reason: Optional[str] = None
        self.reattach_s: Optional[float] = None  # the last re-attach's time
        self._t_degraded = 0.0
        self._closing = threading.Event()
        self._retired: List[MicroBatcher] = []
        # graceful drain: new matching work is refused once set; the
        # inflight handler count is what the drain waits on
        self.draining = False
        self._active_lock = threading.Lock()
        self._n_active = 0
        self._counter_lock = threading.Lock()
        self._n_requests = 0
        self._n_errors = 0
        # the binary columnar wire, accepted and emitted when a client
        # negotiates it; $REPORTER_WIRE=0 turns it off (binary bodies get a
        # 415 and /health stops advertising it)
        self.wire_enabled = (os.environ.get("REPORTER_WIRE", "").strip().lower()
                             not in ("0", "false", "off", "no"))
        # the engine's half: built by attach_matcher (``batcher`` last)
        self.matcher: Optional[SegmentMatcher] = None
        self.batcher: Optional[MicroBatcher] = None
        self.session_store: Optional[SessionStore] = None
        self.session_checkpointer: Optional[SessionCheckpointer] = None
        self.session_engine: Optional[SessionEngine] = None
        self.session_batcher: Optional[MicroBatcher] = None
        # boot-time work in flight (the engine build, a warmup pass): the
        # serve entry point sets it; /health and /statusz report it
        self.warming = False
        self._t_boot = _time.time()
        self._collect = None
        if matcher is not None:
            self.attach_matcher(matcher)

    def attach_matcher(self, matcher: SegmentMatcher) -> None:
        """Bring a deferred service live: resolve the report threshold,
        build the session store (its checkpointer), the session engine
        and both batchers over ``matcher``.  ``matcher`` and ``batcher``
        are assigned last: handlers read the batcher once, so a request
        races either to 503 or to a fully wired engine, never halfway,
        and /health names a backend only once requests are taken."""
        threshold = self._threshold_arg
        if threshold is None:
            threshold = int(os.environ.get("THRESHOLD_SEC", matcher.cfg.threshold_sec))
        self.threshold_sec = int(threshold)
        # chip-seconds accrue for every card of the matcher's mesh
        try:
            chips = int(matcher.capacity_summary().get("devices", 1))
        except AttributeError:  # a stand-in engine without the summary
            chips = int(getattr(matcher.cfg, "devices", 1) or 1)
        self.economics.ledger.set_chips(max(1, chips))
        cfg = matcher.cfg
        if self.session_store is None:
            self.session_store = SessionStore(cfg.max_sessions, cfg.session_ttl_s)
            if self._ckpt_s > 0 and self._ckpt_dir:
                self.session_checkpointer = SessionCheckpointer(
                    self.session_store, os.path.join(self._ckpt_dir, self.replica_id),
                    cadence_s=self._ckpt_s, sync=self._ckpt_sync)
                self.session_checkpointer.start()
        self.session_engine = SessionEngine(matcher, self.session_store,
                                            tail_points=cfg.session_tail_points)
        # streaming submits batch on their own MicroBatcher with a short
        # fill window: a session's point is answered at point latency
        self.session_batcher = self._make_session_batcher()
        try:
            self.quality = obs_quality.configure(matcher, self._quality_spec)
        except Exception:  # noqa: BLE001 - diagnostics must not block boot
            log.exception("quality engine configure failed; sampling off")
            self.quality = None
        # /health names the backend once the windowed batcher can take work
        batcher = self._make_batcher(matcher)
        self.matcher = matcher
        self.batcher = batcher

    def _make_batcher(self, matcher) -> MicroBatcher:
        return MicroBatcher(matcher, **self._batch_params, **self._robust_params,
                            on_wedged=self._enter_degraded, on_crashed=self._note_crash)

    def _make_session_batcher(self) -> MicroBatcher:
        """The streaming twin: the same fault domains over the
        SessionEngine."""
        return MicroBatcher(self.session_engine, **self._session_params,
                            **self._robust_params, name="session",
                            on_wedged=self._enter_degraded, on_crashed=self._note_crash)

    def close(self) -> None:
        """Stop every thread the service started (a finisher wedged in the
        device runtime stays behind)."""
        self._closing.set()
        for b in [self.batcher, self.session_batcher] + self._retired:
            if b is not None:
                b.close()
        if self.session_checkpointer is not None:
            self.session_checkpointer.stop()
        self.economics.stop()
        if self._collect is not None:
            obs.REGISTRY.unregister_collect(self._collect)
            self._collect = None

    # -- drain ----------------------------------------------------------------

    def begin_drain(self) -> None:
        """Refuse new matching work (503 "draining"), turn /health to 503
        "draining" and let inflight requests finish (idempotent)."""
        if self.draining:
            return
        self.draining = True
        G_DRAINING.set(1)
        self.economics.ledger.set_draining(True)
        obs_log.event(log, "drain_begin", level=logging.WARNING,
                      replica=self.replica_id)

    @contextlib.contextmanager
    def _track_active(self):
        with self._active_lock:
            self._n_active += 1
        # the cost ledger bills chip-seconds as "serving" while a matching
        # handler is inflight
        self.economics.ledger.note_active(True)
        try:
            yield
        finally:
            self.economics.ledger.note_active(False)
            with self._active_lock:
                self._n_active -= 1

    def idle(self) -> bool:
        """No /report or /trace_attributes_batch handler is inflight."""
        with self._active_lock:
            return self._n_active == 0

    # -- degraded mode and re-attach -------------------------------------------

    def _note_crash(self, who: str, e: BaseException) -> None:
        """A batcher loop thread died: /health turns unhealthy (a bug, not a
        device fault: no CPU fallback), and session steps in flight commit
        nothing when they finish."""
        self.unhealthy_reason = "batcher %s thread died: %s" % (who, e)
        self.session_engine.invalidate_inflight()

    def _enter_degraded(self, reason: str) -> None:
        """A watchdog trip: answer from the CPU baseline with "degraded":
        true, and probe for re-attach in the background."""
        with self._degraded_lock:
            if self.degraded:
                return
            self.degraded = True
            self._t_degraded = _time.monotonic()
        # a wedged step may wake long after its futures failed: its finish
        # must commit nothing (the degraded path re-applies the points)
        self.session_engine.invalidate_inflight()
        _count("degraded_entries")
        G_DEGRADED.set(1)
        self.economics.ledger.set_degraded(True)
        obs_log.event(log, "degraded_enter", level=logging.ERROR, reason=reason)
        if self._reattach_probe_s > 0:
            threading.Thread(target=self._probe_loop, daemon=True,
                             name="reattach-probe").start()

    def _cpu_fallback(self) -> SegmentMatcher:
        """The degraded-mode engine: the CPU baseline over the same graph
        arrays and table (no rebuild, no device), built on first use."""
        m = self.matcher
        if not getattr(m.cfg, "cpu_fallback", True):
            raise DeviceWedged("device wedged and cpu_fallback disabled")
        with self._cpu_lock:
            if self._cpu_matcher is None:
                self._cpu_matcher = SegmentMatcher(arrays=m.arrays, ubodt=m.ubodt,
                                                   config=m.cfg, backend="cpu")
                self._cpu_matcher._quality_aux = m._quality_aux
            return self._cpu_matcher

    def _probe_loop(self) -> None:
        """Every ``reattach_probe_s``, probe the device with a dummy
        dispatch through the real match path; on an answer within the
        watchdog bound, re-attach."""
        wd = self.batcher.watchdog_s
        timeout = max(1.0, wd if wd > 0 else 120.0)
        while self.degraded and not self.draining:
            if self._closing.wait(self._reattach_probe_s):
                return
            if not self.degraded or self.draining:
                return
            if self._probe_device(timeout):
                self._reattach()
                return

    def _probe_device(self, timeout_s: float) -> bool:
        m = self.matcher
        ok: list = []
        done = threading.Event()

        def _try():
            try:
                m.match_many(m.dummy_traces(4, 1))
                ok.append(True)
            except Exception as e:  # noqa: BLE001 - a failed probe stays degraded
                log.info("re-attach probe failed: %s", e)
            finally:
                done.set()

        # the probe may hang as the wedged step did: a disposable daemon
        # thread, given up at the watchdog bound
        threading.Thread(target=_try, daemon=True, name="reattach-probe-dispatch").start()
        done.wait(timeout=timeout_s)
        return bool(ok)

    def _reattach(self) -> None:
        """Fresh batchers over the same matcher, engine and store (open
        sessions kept their replay buffers and rebuild on their next
        step); the wedged ones close with the service."""
        self._retired += [self.batcher, self.session_batcher]
        self.batcher = self._make_batcher(self.matcher)
        self.session_batcher = self._make_session_batcher()
        with self._degraded_lock:
            self.degraded = False
            self.reattach_s = _time.monotonic() - self._t_degraded
        G_DEGRADED.set(0)
        self.economics.ledger.set_degraded(False)
        _count("reattaches")
        obs_log.event(log, "engine_reattach", level=logging.WARNING,
                      backend=self.matcher.backend,
                      degraded_s=round(self.reattach_s, 3))

    # -- requests ---------------------------------------------------------------

    @staticmethod
    def validate(trace: dict) -> Tuple[Optional[str], Optional[Set], Optional[Set]]:
        """Returns (error, report_levels, transition_levels).  A streaming
        submit ("stream": true) may carry a single point; windowed
        requests need at least two."""
        if trace.get("uuid") is None:
            return "uuid is required", None, None
        try:
            trace["trace"][0 if trace.get("stream") else 1]
        except Exception:  # noqa: BLE001 - any malformed shape is a 400
            return (
                "trace must be a non zero length array of object each of which must "
                "have at least lat, lon and time"
            ), None, None
        try:
            rl = set(trace["match_options"]["report_levels"])
        except Exception:  # noqa: BLE001
            return "match_options must include report_levels array", None, None
        try:
            tl = set(trace["match_options"]["transition_levels"])
        except Exception:  # noqa: BLE001
            return "match_options must include transition_levels array", None, None
        mo = trace["match_options"]
        if isinstance(mo, dict):
            for key in ("sigma_z", "beta", "search_radius", "gps_accuracy"):
                if key not in mo:
                    continue
                try:
                    v = float(mo[key])
                except (TypeError, ValueError):
                    v = float("nan")
                if not (v > 0 and v == v and v != float("inf")):
                    return ("match_options.%s must be a positive finite "
                            "number" % key), None, None
            sm = mo.get("shape_match")
            if sm is not None and sm != "map_snap":
                return ("match_options.shape_match %r is not supported "
                        "(this matcher map-snaps; use \"map_snap\" or omit "
                        "the key)" % (sm,)), None, None
            # route-consistent interpolation: booleans only, so a typo'd
            # string cannot silently pick a default
            ip = mo.get("interpolate")
            if ip is not None and not isinstance(ip, bool):
                return "match_options.interpolate must be a boolean", None, None
        return None, rl, tl

    # -- requests: every terminal outcome is counted, offered to the SLO
    # engine and recorded in the flight recorder ---------------------------

    @staticmethod
    def _terminal(route: str, code: int, span: Span, degraded: bool = False) -> None:
        """A request's terminal outcome: the SLO engine classifies it, the
        objectives it violates mark the span (so a 200 that blew the
        latency objective is retained like an error), and the flight
        recorder gets it."""
        if "total_s" not in span.timings:
            span.finish()
        violated = obs_slo.observe(route, code, span.timings.get("total_s"),
                                   degraded=degraded, trace_id=span.trace_id)
        if violated:
            span.meta["slo_violation"] = violated
        obs_flight.record(span)

    def _refusal(self, e: Exception, batcher: MicroBatcher, route: str,
                 span: Span) -> Tuple[int, dict]:
        """The answer to a batcher's refusal or a failed request's error,
        counted and terminal."""
        if isinstance(e, Overloaded):
            code, out, status = 429, {"error": str(e),
                                      "retry_after": batcher.retry_after_s()}, "shed"
        elif isinstance(e, DeadlineExpired):
            code, out, status = 504, {"error": str(e)}, "expired"
        elif isinstance(e, TraceQuarantined):
            code, out, status = 422, {"error": str(e)}, "quarantined"
        elif isinstance(e, (DeviceWedged, BatcherCrashed)):
            code, out, status = 503, {"error": str(e), "retry_after": 1}, "unavailable"
        else:
            code, out, status = 500, {"error": str(e)}, "error"
        span.fail(e, status=status)
        self._terminal(route, code, span)
        if code in (503, 500):
            self._note_request(ok=False)
        C_REQUESTS.labels(route, "error" if code in (503, 500) else status).inc()
        return code, out

    def _drain_refusal(self, route: str, span: Span) -> Tuple[int, dict]:
        _count("drain_refusals")
        span.fail("draining", status="draining")
        self._terminal(route, 503, span)
        return 503, {"error": "draining", "status": "draining", "retry_after": 1}

    def _init_refusal(self, route: str, span: Span) -> Tuple[int, dict]:
        """Before ``attach_matcher``: a retryable 503."""
        span.fail("service initialising", status="unavailable")
        self._terminal(route, 503, span)
        return 503, {"error": "service initialising", "retry_after": 1}

    def _note_request(self, ok: bool) -> None:
        with self._counter_lock:
            self._n_requests += 1
            self._n_errors += not ok

    def _note_quality(self, trace, match, span: Span) -> Optional[dict]:
        """Pop the matcher's "_quality" block off a match dict (it never
        reaches the wire), feed the confidence metrics, mark a low-margin
        span for the flight recorder, and offer the request to the
        shadow-oracle sampler (one non-blocking enqueue at most).  The
        trace's binary-wire "_columns", which the match packed from, goes
        first: it never reaches a serializer."""
        if isinstance(trace, dict):
            trace.pop("_columns", None)
        if not isinstance(match, dict):
            return None
        q = match.pop("_quality", None)
        if not isinstance(q, dict):
            return None
        mm = q.get("margin_mean")
        if mm is not None:
            obs_quality.H_MARGIN.observe(mm, exemplar=span.trace_id)
            # the mean margin: the minimum is routinely 0 on two-way
            # streets, while a low mean means the whole decode was ambiguous
            if mm < self._margin_keep:
                obs_quality.C_LOW_MARGIN.inc()
                span.meta["low_margin"] = round(float(mm), 4)
        if self.quality is not None:
            self.quality.maybe_sample(trace, q)
        return q

    def handle_report(self, trace: dict, deadline: Optional[float] = None,
                      debug: bool = False) -> Tuple[int, dict]:
        """One trace.  ``deadline`` is the absolute ``time.monotonic()``
        bound parsed from X-Reporter-Deadline-Ms at ingestion (None: the
        server's default); ``debug`` puts the span's breakdown (and the
        quality block and effective match options) on the answer.  A
        streaming submit is its own route, "report_stream", for the SLO
        engine and the request counts."""
        stream = isinstance(trace, dict) and bool(trace.get("stream"))
        route = "report_stream" if stream else "report"
        span = obs_trace.current_span() or Span(route)
        span.meta.setdefault("endpoint", route)
        if isinstance(trace, dict) and trace.get("uuid") is not None:
            span.meta.setdefault("uuid", str(trace["uuid"])[:64])
        if self.draining:
            return self._drain_refusal(route, span)
        batcher = self.session_batcher if stream else self.batcher
        if batcher is None:
            return self._init_refusal(route, span)
        # fault seam: an injected admission shed
        if faults.fire("replica_shed") is not None:
            span.fail("injected admission shed", status="shed")
            self._terminal(route, 429, span)
            C_REQUESTS.labels(route, "shed").inc()
            return 429, {"error": "injected admission shed", "retry_after": 1}
        err, rl, tl = self.validate(trace)
        if err:
            C_REQUESTS.labels(route, "invalid").inc()
            span.fail(err, status="invalid")
            self._terminal(route, 400, span)
            return 400, {"error": err}
        # the binary wire's "_columns" (numpy arrays) stays on the trace
        # through the match, which packs from it; _finish_report pops it
        # before anything renders, echoes, records or samples the trace
        if self.degraded:
            return self._finish_report(trace, rl, tl, span, debug, degraded=True,
                                       route=route)
        try:
            with obs_trace.bind(span):
                match = batcher.match(trace, deadline, span)
        except (DeviceWedged, BatcherCrashed) as e:
            if self.degraded:  # raced the watchdog trip: the CPU answers
                return self._finish_report(trace, rl, tl, span, debug,
                                           degraded=True, route=route)
            return self._refusal(e, batcher, route, span)
        except Exception as e:  # noqa: BLE001 - the request gets the error
            trace.pop("_columns", None)
            if not isinstance(e, (Overloaded, DeadlineExpired, TraceQuarantined)):
                log.exception("match failed")
            return self._refusal(e, batcher, route, span)
        return self._finish_report(trace, rl, tl, span, debug, match=match,
                                   route=route)

    def _finish_report(self, trace, rl, tl, span: Span, debug: bool = False,
                       match: Optional[dict] = None, degraded: bool = False,
                       route: str = "report") -> Tuple[int, dict]:
        """Render the report, matching first on the CPU baseline when
        degraded (a streaming submit through the session engine's
        degraded step); a degraded answer carries "degraded": true.  A
        streaming answer renders over the session window (its rolling tail
        + the new points) and carries a "session" block."""
        stream = route == "report_stream"
        try:
            with obs_trace.bind(span):
                if degraded:
                    m = self._cpu_fallback()
                    t_m = _time.monotonic()
                    with self._cpu_lock:
                        match = (self.session_engine.degraded_step(m, trace) if stream
                                 else m.match_many([trace])[0])
                    span.mark("cpu_fallback_s", _time.monotonic() - t_m)
                # matched: the binary wire's transport state goes
                trace.pop("_columns", None)
                st = match.pop("_stream", None)
                render = trace if st is None else {
                    "uuid": trace.get("uuid"), "trace": st["trace"],
                    "match_options": trace.get("match_options") or {}}
                quality = self._note_quality(render, match, span)
                t_rep = _time.monotonic()
                data = report_fn(match, render, self.threshold_sec, rl, tl,
                                 mode=(trace.get("match_options") or {}).get("mode", "auto"))
            span.mark("report_fn_s", _time.monotonic() - t_rep)
            span.finish()
        except Exception as e:  # noqa: BLE001 - the request gets the error
            log.exception("match failed")
            return self._refusal(e, self.batcher, route, span)
        if st is not None:
            data["session"] = st["session"]
        if degraded:
            data["degraded"] = True
            span.meta["degraded"] = True
            _count("degraded_requests")
        if debug:
            data["debug"] = span.breakdown()
            if quality is not None:
                data["debug"]["quality"] = {k: v for k, v in quality.items()
                                            if k != "edge"}
            # the HMM parameters this request ran with (its match_options
            # applied and clamped)
            data["debug"]["match_options"] = self.matcher.effective_match_options(
                trace.get("match_options") or {})
        self._terminal(route, 200, span, degraded=degraded)
        self._note_request(ok=True)
        C_REQUESTS.labels(route, "degraded" if degraded else "ok").inc()
        return 200, data

    def handle_batch(self, body: dict,
                     deadline: Optional[float] = None) -> Tuple[int, dict]:
        """{"traces": [...]}: every trace validated first (a bad one is a
        400 naming its index), then one ``match_many`` on the windowed
        batcher (on the CPU baseline when degraded) and one report per
        trace, in request order.  One span covers the whole request."""
        route = "trace_attributes_batch"
        span = obs_trace.current_span() or Span(route)
        span.meta.setdefault("endpoint", route)
        if self.draining:
            return self._drain_refusal(route, span)
        batcher = self.batcher
        if batcher is None:
            return self._init_refusal(route, span)
        traces = body.get("traces")
        if not isinstance(traces, list) or not traces:
            span.fail("traces must be a non-empty array", status="invalid")
            self._terminal(route, 400, span)
            return 400, {"error": "traces must be a non-empty array"}
        span.meta["n_traces"] = len(traces)
        validated = []
        for i, trace in enumerate(traces):
            err, rl, tl = self.validate(trace)
            if err:
                C_REQUESTS.labels(route, "invalid").inc()
                span.fail("trace %d: %s" % (i, err), status="invalid")
                self._terminal(route, 400, span)
                return 400, {"error": "trace %d: %s" % (i, err)}
            validated.append((trace, rl, tl))
        degraded = self.degraded
        try:
            with obs_trace.bind(span):
                t0 = _time.monotonic()
                if degraded:
                    m = self._cpu_fallback()
                    with self._cpu_lock:
                        matches = m.match_many([t for t, _rl, _tl in validated])
                    span.meta["degraded"] = True
                else:
                    matches = batcher.match_many([t for t, _rl, _tl in validated],
                                                 deadline)
                span.mark("match_s", _time.monotonic() - t0)
                for m_, (t, _rl, _tl) in zip(matches, validated):
                    self._note_quality(t, m_, span)
                t0 = _time.monotonic()
                results = [report_fn(m_, t, self.threshold_sec, rl, tl,
                                     mode=t.get("match_options", {}).get("mode", "auto"))
                           for m_, (t, rl, tl) in zip(matches, validated)]
                span.mark("report_fn_s", _time.monotonic() - t0)
        except Exception as e:  # noqa: BLE001 - the request gets the error
            for t, _rl, _tl in validated:
                t.pop("_columns", None)
            if not isinstance(e, (Overloaded, DeadlineExpired, TraceQuarantined,
                                  DeviceWedged, BatcherCrashed)):
                log.exception("batch failed")
            return self._refusal(e, batcher, route, span)
        self._terminal(route, 200, span, degraded=degraded)
        self._note_request(ok=True)
        out = {"results": results}
        if degraded:
            out["degraded"] = True
            _count("degraded_requests")
        C_REQUESTS.labels(route, "degraded" if degraded else "ok").inc()
        return 200, out

    def handle_health(self) -> Tuple[int, dict]:
        """503 "unhealthy" when a batcher thread died (or the health_flap
        seam fires), 503 "draining" with the inflight count while
        draining, else 200 "ok" with the matcher's state; degraded mode
        stays 200 (the service answers) with "degraded": true.  Before
        ``attach_matcher`` the answer is 200 "ok" with "warming": true and
        the matcher's fields null (the router holds such a replica out of
        its ring); "warming" also stays true while a warmup pass runs.
        "capacity" is ``SegmentMatcher.capacity_summary()``.  The keys are
        the reference's, plus "device", "mesh", "max_trace_points",
        "sessions" and, where they exist, "ubodt_tier" and
        "session_arena"."""
        m = self.matcher
        b = self.batcher
        uptime = round(_time.time() - self._t_boot, 1)
        if self.unhealthy_reason or (b is not None and b._crashed):
            return 503, {"status": "unhealthy",
                         "reason": self.unhealthy_reason or (
                             b._crash_reason if b is not None else None),
                         "replica": self.replica_id, "uptime_s": uptime}
        if faults.fire("health_flap") is not None:
            return 503, {"status": "unhealthy", "reason": "injected health flap",
                         "replica": self.replica_id, "uptime_s": uptime}
        if self.draining:
            with self._active_lock:
                inflight = self._n_active
            return 503, {"status": "draining", "replica": self.replica_id,
                         "inflight": inflight, "uptime_s": uptime}
        out = {
            "status": "ok",
            "replica": self.replica_id,
            # wire-level opt-ins a client may negotiate: gzip request bodies
            # always, the binary columnar wire unless $REPORTER_WIRE=0
            "capabilities": ["gzip", "wire-columnar"] if self.wire_enabled else ["gzip"],
            "degraded": bool(self.degraded),
            "warming": bool(self.warming) or m is None,
            "device": str(m.device) if m else None,
            "backend": m.backend if m else None,
            "mesh": ({"dp": m._mesh.n_dp, "gp": m._mesh.n_gp}
                     if m is not None and m._mesh is not None else None),
            "max_trace_points": m.max_trace_points if m else None,
            "viterbi_kernel": m._kernel_mode if m else None,
            "devices": int(m.cfg.devices) if m else None,
            "graph_devices": int(m.cfg.graph_devices) if m else None,
            "capacity": (m.capacity_summary()
                         if m is not None and hasattr(m, "capacity_summary") else None),
            "edges": int(m.arrays.num_edges) if m else None,
            "ubodt_rows": int(m.ubodt.num_rows) if m else None,
            "ubodt_shard": ("%d/%d" % m.ubodt_shard) if m and m.ubodt_shard else None,
            "ubodt_tiered": (m.tiering is not None) if m else None,
            "sessions": (self.session_store.summary()
                         if self.session_store is not None else None),
            "uptime_s": uptime,
            "requests": self._n_requests,
            "errors": self._n_errors,
        }
        if m is not None and m.tiering is not None:
            out["ubodt_tier"] = m.tiering.summary()
        if m is not None and m.session_arena is not None:
            out["session_arena"] = m.session_arena.summary()
        return 200, out

    def handle_sessions(self, query: dict,
                        body: Optional[dict] = None) -> Tuple[int, dict]:
        """The session store's surface:

          GET  /sessions              the store's summary
          GET  /sessions?uuid=U       one session's meta (404 if absent)
          GET  /sessions?export=1     the summary + every live session's
                                      wire snapshot (the handoff's
                                      export; while draining, taken once
                                      the matching handlers are idle)
          POST /sessions {"sessions": [...]}   import (merging a uuid that
                                      is live here); {"drop": [...]};
                                      {"pop": [...]} (remove and
                                      serialise in one locked sweep)
        """
        store = self.session_store
        if store is None:
            return 503, {"error": "service initialising", "retry_after": 1}
        if body is not None:
            drop = body.get("drop")
            if drop is not None:
                if not isinstance(drop, list):
                    return 400, {"error": "drop must be an array of uuids"}
                dropped = sum(1 for u in drop if store.drop(str(u)))
                return 200, {"dropped": dropped, "replica": self.replica_id}
            pop = body.get("pop")
            if pop is not None:
                if not isinstance(pop, list):
                    return 400, {"error": "pop must be an array of uuids"}
                return 200, {"sessions": store.pop_wire(pop), "replica": self.replica_id}
            wires = body.get("sessions")
            if not isinstance(wires, list):
                return 400, {"error": "sessions must be an array"}
            return 200, dict(store.import_wire(wires), replica=self.replica_id)
        uuid = (query.get("uuid") or [None])[0]
        if uuid:
            s = store.peek(str(uuid))
            if s is None:
                return 404, {"error": "no session for uuid %r" % uuid}
            return 200, dict(s.meta(), replica=self.replica_id)
        if query.get("export", ["0"])[0] not in ("", "0", "false"):
            # fault seam: a crawling drain's export
            faults.hang("slow_drain")
            if self.draining:
                # steps admitted before the drain may still be committing:
                # snapshot once the handlers are idle (bounded), so the
                # beams carry every answered point
                until = _time.monotonic() + 2.0
                while not self.idle() and _time.monotonic() < until:
                    _time.sleep(0.02)
            out = dict(store.summary(), replica=self.replica_id,
                       draining=bool(self.draining))
            out["sessions"] = store.export_all()
            return 200, out
        return 200, dict(store.summary(), replica=self.replica_id,
                         draining=bool(self.draining))

    # -- observability endpoints ----------------------------------------------

    def _econ_sample(self) -> dict:
        """The economics tick's signal read: live registry and state reads
        only (the engine differences the cumulative counters itself).
        Admitted = terminal ok + degraded, shed = terminal 429s; the
        device-step histogram feeds the capacity ceiling's windowed p95."""
        b = self.batcher
        step = None
        try:
            samp = M_DEVICE_STEP._default()._sample()
            if samp["count"] or b is not None:
                step = (samp["buckets"], samp["counts"])
        except Exception:  # noqa: BLE001 - a sensor read must never raise
            pass
        burn = max_burn = None
        try:
            burn = {}
            for name, st in obs_slo.engine().summary()["objectives"].items():
                rates = [float(v) for v in (st.get("burn") or {}).values()
                         if isinstance(v, (int, float))]
                burn[name] = round(max(rates), 4) if rates else None
            rates = [v for v in burn.values() if v is not None]
            max_burn = max(rates) if rates else None
        except Exception:  # noqa: BLE001
            pass
        return {
            "queue_depth": b._q.qsize() if b is not None else 0,
            "admitted_total": obs_econ.counter_total(
                C_REQUESTS, {"outcome": ("ok", "degraded")}),
            "shed_total": obs_econ.counter_total(C_REQUESTS, {"outcome": "shed"}),
            "points_total": C_POINTS_MATCHED.value,
            "device_step": step,
            "max_batch": float(b.max_batch) if b is not None else None,
            "burn": burn,
            "max_burn": max_burn,
            "sessions": (self.session_store.summary()["sessions"]
                         if self.session_store is not None else None),
            "session_tiers": self._session_tiers(),
        }

    def _session_tiers(self) -> Optional[dict]:
        """Resident sessions by tier for the economics tick: hot / cold
        from the slab's maps, host = every other session the store holds;
        None before the engine attaches."""
        if self.session_store is None:
            return None
        total = self.session_store.summary()["sessions"]
        arena = getattr(self.matcher, "session_arena", None)
        if arena is None:
            return {"hot": 0, "cold": 0, "host": total}
        t = arena.tier_counts()
        return {"hot": t["hot"], "cold": t["cold"],
                "host": max(0, total - t["hot"] - t["cold"])}

    def handle_cost(self, query: dict) -> Tuple[int, dict]:
        """GET /debug/cost: chip-seconds by lifecycle state, accrued
        dollars, $ per million matched points, the measured capacity and
        the demand-history ring's place and size."""
        return 200, self.economics.cost_report()

    def handle_history(self, query: dict) -> Tuple[int, dict]:
        """GET /debug/history[?window=S]: the demand-history ring's records
        (oldest first), optionally the last ``window`` seconds only; an
        empty series with its reason when the history is off."""
        window = None
        raw = query.get("window", [None])[0]
        if raw is not None:
            try:
                window = max(1.0, float(raw))
            except (TypeError, ValueError):
                return 400, {"error": "window must be a number (seconds)"}
        return 200, self.economics.history_report(window_s=window)

    def handle_statusz(self) -> Tuple[int, dict]:
        """GET /statusz: uptime, configuration, fault-domain state, every
        plane's summary and every metric family (the dict form of
        /metrics)."""
        m = self.matcher
        b = self.batcher
        sb = self.session_batcher
        return 200, {
            "uptime_s": round(_time.time() - self._t_boot, 1),
            "replica": self.replica_id,
            "draining": bool(self.draining),
            "warming": bool(self.warming) or m is None,
            "backend": m.backend if m else None,
            "viterbi_kernel": getattr(m, "_kernel_mode", None) if m else None,
            "threshold_sec": self.threshold_sec,
            "batch": dict(self._batch_params),
            "degraded": bool(self.degraded),
            "wedged": bool(b.wedged) if b is not None else None,
            "crashed": bool(b._crashed) if b is not None else None,
            "robustness": {
                "max_queue": b.max_queue,
                "deadline_ms": round(b.deadline_s * 1000.0, 1),
                "watchdog_s": b.watchdog_s,
                "quarantine_after": b.quarantine_after,
                "quarantine_ttl_s": b.quarantine_ttl_s,
                "reattach_probe_s": self._reattach_probe_s,
                "quarantined_uuids": b.quarantined(),
            } if b is not None else None,
            "latency_buckets_s": list(obs.LATENCY_BUCKETS_S),
            "batch_fill_buckets": list(obs.BATCH_FILL_BUCKETS),
            "flight": obs_flight.RECORDER.summary(),
            "attrib": obs_attrib.summary(),
            "slo": obs_slo.engine().summary(),
            "quality": self.quality.summary() if self.quality is not None else None,
            "sparse": (m.sparse.summary()
                       if getattr(m, "sparse", None) is not None else None),
            "sessions": (self.session_store.summary()
                         if self.session_store is not None else None),
            "session_arena": (m.session_arena.summary()
                              if getattr(m, "session_arena", None) is not None
                              else None),
            "ubodt_tier": (m.tiering.summary()
                           if getattr(m, "tiering", None) is not None else None),
            "adaptive": {
                "enabled": obs_adaptive.enabled(),
                "batch_wait_s": round(b.max_wait, 5) if b is not None else None,
                "session_wait_s": round(sb.max_wait, 5) if sb is not None else None,
                "max_batch": b.max_batch if b is not None else None,
                "session_max_batch": sb.max_batch if sb is not None else None,
            },
            "checkpoint": (self.session_checkpointer.summary()
                           if self.session_checkpointer is not None else None),
            "economics": self.economics.summary(),
            "memory": obs_econ.memory_summary(m, self.session_store),
            "metrics": obs.REGISTRY.snapshot(),
        }

    def handle_traces(self, query: dict) -> Tuple[int, dict]:
        """GET /debug/traces?n=K: the flight recorder's newest retained
        traces (errors and slow ones always, plus the sample), newest
        first; ``?id=<trace_id>`` every retained entry of that trace (404
        with an empty list when none was kept)."""
        rec = obs_flight.RECORDER
        tid = obs_trace.accept_trace_id(query.get("id", [None])[0])
        if tid:
            entries = rec.find(tid)
            out = {"trace_id": tid, "replica": self.replica_id, "traces": entries}
            if not entries:
                out["error"] = "trace %r not retained" % tid
            return (200 if entries else 404), out
        try:
            n = int(query.get("n", ["50"])[0])
        except (TypeError, ValueError):
            return 400, {"error": "n must be an integer"}
        n = max(1, min(n, 2 * rec.capacity))
        return 200, {"summary": rec.summary(), "traces": rec.snapshot(n)}

    def handle_slo(self, query: dict) -> Tuple[int, dict]:
        """GET /debug/slo[?window=S]: every objective's value against its
        target, multi-window burn rates, remaining budget, per-route
        traffic and quantiles, the retained violating trace_ids, and the
        quality section when sampling is on."""
        window = None
        raw = query.get("window", [None])[0]
        if raw is not None:
            try:
                window = max(1.0, float(raw))
            except (TypeError, ValueError):
                return 400, {"error": "window must be a number (seconds)"}
        out = obs_slo.engine().report(window_s=window)
        if self.quality is not None:
            out["quality"] = self.quality.report()
        return 200, out

    def handle_profile(self, query: dict) -> Tuple[int, dict]:
        """GET /debug/profile?seconds=N: a torch.profiler capture of the
        live process for N seconds; answers its trace directory (409 while
        another capture runs)."""
        from ..obs import profiler

        try:
            seconds = float(query.get("seconds", ["2"])[0])
        except (TypeError, ValueError):
            return 400, {"error": "seconds must be a number"}
        if self.matcher is None:
            return 503, {"error": "service initialising"}
        if self.matcher.backend != "jax":
            return 501, {"error": "profiling needs the device backend (got %r)"
                                  % self.matcher.backend}
        try:
            trace_dir, recorded = profiler.capture(seconds)
        except profiler.ProfilerBusy as e:
            return 409, {"error": str(e), "inflight": e.inflight}
        except Exception as e:  # noqa: BLE001 - surfaced to the caller
            log.exception("profiler capture failed")
            return 500, {"error": str(e)}
        return 200, {"trace_dir": trace_dir, "seconds": recorded}

    def handle_attrib(self, query: dict) -> Tuple[int, dict]:
        """GET /debug/attrib: the last parsed per-stage attribution and its
        age; with ``?capture=1[&reps=N]`` a capture now: N dummy dispatches
        through the real dispatch path under a profiler window, parsed and
        published to the gauges (409 while another capture runs)."""
        from ..obs import profiler

        if query.get("capture", ["0"])[0] in ("", "0", "false"):
            return 200, {"attrib": obs_attrib.last(), "summary": obs_attrib.summary()}
        if self.matcher is None:
            return 503, {"error": "service initialising"}
        if self.matcher.backend != "jax":
            return 501, {"error": "attribution needs the device backend (got %r)"
                                  % self.matcher.backend}
        try:
            reps = int(query.get("reps", ["3"])[0])
        except (TypeError, ValueError):
            return 400, {"error": "reps must be an integer"}
        try:
            res = obs_attrib.capture_matcher(self.matcher, reps=max(1, min(reps, 20)))
        except profiler.ProfilerBusy as e:
            return 409, {"error": str(e), "inflight": e.inflight}
        except Exception as e:  # noqa: BLE001 - surfaced to the caller
            log.exception("attribution capture failed")
            return 500, {"error": str(e)}
        return 200, {"attrib": res, "summary": obs_attrib.summary()}

    def make_server(self, host: str = "0.0.0.0", port: int = 8002) -> ThreadingHTTPServer:
        service = self
        # the economics sensors arm with the server: the tick thread and
        # the scrape-time memory collector (``close`` removes both)
        if self._collect is None:
            self._collect = lambda: obs_econ.publish_memory(self.matcher,
                                                            self.session_store)
            self.economics.start(self._econ_sample, collect=(self._collect,))

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # idle keep-alive connections time out, so a drain that joins
            # the handler threads is bounded
            timeout = 30

            def _answer(self, code: int, payload: dict):
                t0s = _time.monotonic()
                body = None
                ctype = "application/json;charset=utf-8"
                if code == 200 and self._accept_wire:
                    # the client negotiated the binary wire: only 200 report
                    # payloads encode, every error stays JSON
                    try:
                        body = wire.encode_response(payload, single=self._wire_single)
                        ctype = wire.CONTENT_TYPE
                    except Exception:  # noqa: BLE001 - fall back to JSON
                        log.warning("binary response encode failed; answering JSON",
                                    exc_info=True)
                if body is None:
                    body = json.dumps(payload, separators=(",", ":")).encode("utf-8")
                if self._timed_route:
                    obs_attrib.host_add("serialize", _time.monotonic() - t0s)
                self.send_response(code)
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if code in (429, 503):
                    # the backoff hint as a header too (RFC 9110), for
                    # generic clients
                    try:
                        ra = max(1, int(payload.get("retry_after")))
                    except (TypeError, ValueError):
                        ra = 1
                    self.send_header("Retry-After", str(ra))
                self._echo_headers()
                self.end_headers()
                self.wfile.write(body)

            def _answer_text(self, code: int, text: str):
                """Prometheus exposition is text, not JSON."""
                body = text.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self._echo_headers()
                self.end_headers()
                self.wfile.write(body)

            def _echo_headers(self):
                """Every response echoes the request's trace id (accepted
                from X-Reporter-Trace, or minted at ingestion) and names
                the replica."""
                self.send_header("X-Reporter-Trace", self._trace_id)
                self.send_header("X-Reporter-Replica", service.replica_id)

            def _decode(self, raw: bytes):
                """A POST body: gzip inflated (bounded), then a binary
                frame by Content-Type, else JSON.  Returns the payload, or
                an answer (code, error payload)."""
                enc = (self.headers.get("Content-Encoding") or "").strip().lower()
                if enc == "gzip":
                    raw = _gunzip(raw)
                elif enc not in ("", "identity"):
                    return None, (415, {"error": "unsupported Content-Encoding %r "
                                        "(gzip or identity)" % enc})
                if wire.is_wire(self.headers.get("Content-Type")):
                    if not service.wire_enabled:
                        return None, (415, {"error": "binary wire disabled (REPORTER_WIRE=0)"})
                    return wire.decode_request(raw), None
                return json.loads(raw.decode("utf-8")), None

            def _deadline(self) -> Optional[float]:
                """X-Reporter-Deadline-Ms, the client's remaining budget, as
                an absolute monotonic bound from ingestion (so queue time
                counts against it); a malformed value is ignored."""
                raw = self.headers.get("X-Reporter-Deadline-Ms")
                if not raw:
                    return None
                try:
                    return _time.monotonic() + max(0.0, float(raw)) / 1000.0
                except ValueError:
                    return None

            def _route(self, post: bool):
                if service.draining:
                    self.close_connection = True  # answer, then drain out
                # the trace id: the client's, or one minted here; echoed on
                # every response
                self._trace_id = (obs_trace.accept_trace_id(
                    self.headers.get("X-Reporter-Trace")) or obs_trace.new_trace_id())
                # per-request wire state: the handler lives for the whole
                # keep-alive connection, so one binary request must not
                # turn later requests on the socket binary
                self._accept_wire = self._wire_single = self._timed_route = False
                n = 0
                if post:
                    try:
                        n = int(self.headers.get("Content-Length", "0"))
                    except ValueError:
                        n = -1
                    if n < 0:  # body extent unknown: answer, then close
                        self.close_connection = True
                        return self._answer(400, {"error": "invalid Content-Length"})
                try:
                    # the whole body is read before any answer, so no
                    # unread byte is parsed as the next request line
                    raw = self.rfile.read(n) if n else b""
                    split = urlsplit(self.path)
                    action = split.path.split("/")[-1]
                    query = parse_qs(split.query)
                    if action not in ACTIONS:
                        return self._answer(
                            400, {"error": "Try a valid action: %s" % sorted(ACTIONS)})
                    if action == "health":
                        return self._answer(*service.handle_health())
                    if action == "metrics":
                        return self._answer_text(200, obs.REGISTRY.render())
                    if action == "statusz":
                        return self._answer(*service.handle_statusz())
                    if action in ("profile", "attrib"):
                        # bound to a span, so a concurrent capture's 409
                        # names this request's trace_id
                        with obs_trace.bind(Span(action, trace_id=self._trace_id)):
                            handler = (service.handle_profile if action == "profile"
                                       else service.handle_attrib)
                            return self._answer(*handler(query))
                    handler = {"traces": service.handle_traces,
                               "slo": service.handle_slo,
                               "cost": service.handle_cost,
                               "history": service.handle_history}.get(action)
                    if handler is not None:
                        return self._answer(*handler(query))
                    if action == "sessions":
                        body = None
                        if post:
                            body = json.loads(raw.decode("utf-8"))
                            if not isinstance(body, dict):
                                return self._answer(
                                    400, {"error": "request body must be a json object"})
                        return self._answer(*service.handle_sessions(query, body))
                    # fault seam: a slow-accepting replica
                    faults.hang("replica_slow_accept")
                    self._timed_route = True
                    if service.wire_enabled and wire.CONTENT_TYPE in (
                            self.headers.get("Accept") or ""):
                        self._accept_wire = True
                        self._wire_single = action == "report"
                    if post:
                        t0p = _time.monotonic()
                        payload, answer = self._decode(raw)
                        if answer is not None:
                            return self._answer(*answer)
                        obs_attrib.host_add("parse", _time.monotonic() - t0p)
                    else:
                        if "json" not in query:
                            return self._answer(400, {"error": "No json provided"})
                        payload = json.loads(query["json"][0])
                except OSError as e:
                    self.close_connection = True
                    try:
                        return self._answer(400, {"error": str(e)})
                    except OSError:
                        return None
                except Exception as e:  # noqa: BLE001 - parse errors are 400s
                    return self._answer(400, {"error": str(e)})
                if not isinstance(payload, dict):
                    return self._answer(400, {"error": "request body must be a json object"})
                # the request's span, picked up by the handlers from the
                # context; X-Reporter-Flight-Keep (validated like a trace
                # id) pins it in the flight recorder
                span = Span(action, trace_id=self._trace_id)
                keep = obs_trace.accept_trace_id(self.headers.get("X-Reporter-Flight-Keep"))
                if keep:
                    span.meta["flight_keep"] = keep
                # the drain waits for this count to reach zero, so it spans
                # the answer's write too: a drain never cuts a body short
                with service._track_active():
                    try:
                        with obs_trace.bind(span):
                            if action == "report":
                                debug = query.get("debug", ["0"])[0] not in ("", "0",
                                                                             "false")
                                code, out = service.handle_report(payload,
                                                                  self._deadline(), debug)
                            else:
                                code, out = service.handle_batch(payload, self._deadline())
                    except Exception as e:  # noqa: BLE001 - never drop the socket
                        log.exception("unhandled request error")
                        code, out = 500, {"error": str(e)}
                    self._answer(code, out)

            def setup(self):
                super().setup()
                self.server._track(self.connection)

            def finish(self):
                self.server._untrack(self.connection)
                super().finish()

            def do_GET(self):
                self._route(post=False)

            def do_POST(self):
                self._route(post=True)

            def log_message(self, fmt, *args):
                log.debug("http: " + fmt, *args)

        class Server(ThreadingHTTPServer):
            request_queue_size = 128
            daemon_threads = True

            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self._conn_lock = threading.Lock()
                self._conns: set = set()

            def _track(self, sock) -> None:
                with self._conn_lock:
                    self._conns.add(sock)

            def _untrack(self, sock) -> None:
                with self._conn_lock:
                    self._conns.discard(sock)

            def close_lingering(self) -> None:
                """Shut every tracked connection down, so a drain does not
                wait out idle keep-alive clients' timeout (called once the
                inflight count is zero: only idle connections are left)."""
                with self._conn_lock:
                    conns = list(self._conns)
                for sock in conns:
                    try:
                        sock.shutdown(_socket.SHUT_RDWR)
                    except OSError:
                        pass

        return Server((host, port), Handler)


# the "batch" keys this port reads (every key of the reference's block)
BATCH_KEYS = ("max_batch", "max_wait_ms", "max_inflight", "session_max_batch",
              "session_wait_ms")


def batch_options(conf: dict) -> dict:
    """ReporterService's batching arguments from a service config's
    "batch" block (max_inflight None: the batcher's default for the
    matcher's device); any other key of the block is dropped with one
    warning per key per process."""
    from ..matching.config import warn_dropped

    batch = conf.get("batch", {})
    for k in batch:
        if k not in BATCH_KEYS:
            warn_dropped("batch config", k)
    return {"max_batch": int(batch.get("max_batch", 64)),
            "max_wait_ms": float(batch.get("max_wait_ms", 10.0)),
            "max_inflight": (int(batch["max_inflight"]) if "max_inflight" in batch
                             else None),
            "session_max_batch": int(batch.get("session_max_batch", 256)),
            "session_wait_ms": float(batch.get("session_wait_ms", 2.0))}


def parse_service_config(path: str):
    """(MatcherConfig, conf dict) from a service config JSON of the
    reference's shape: {"network": {...}, "matcher": {...}, "backend":
    "jax" | "cpu", "batch": {...}, "robustness": {...}}.  Network types:
    "grid" (rows, cols, spacing_m, origin), "file" (a RoadNetwork JSON, as
    ``python -m reporter_tpu_torch.tiles.osm ... --json`` writes it) and
    "tiles" (an RPTT tile directory, as ``... -o dir`` writes it).
    "backend": "jax" (the reference configs' word, and the default) is the
    port's device program, "cpu" the CPU baseline."""
    from ..matching import MatcherConfig

    with open(path) as f:
        conf = json.load(f)
    mconf = conf.get("matcher", {})
    if "meili" in mconf or "default" in mconf:
        cfg = MatcherConfig.from_meili(mconf)
    else:
        cfg = MatcherConfig.from_dict(mconf)
    kind = conf.get("network", {"type": "grid"}).get("type", "grid")
    if kind not in ("grid", "file", "tiles"):
        raise ValueError("network type %r is not supported by this port "
                         "(grid, file or tiles)" % (kind,))
    if conf.get("backend", "jax") not in ("jax", "cpu"):
        raise ValueError("backend %r is not one of jax, cpu" % (conf["backend"],))
    return cfg, conf


def build_matcher(cfg, conf: dict, device="cuda") -> SegmentMatcher:
    """Load or build the network, build the UBODT and move both to
    ``device`` (with the config's ``devices`` / ``graph_devices`` above 1,
    a list of the mesh's devices, or "cuda" for the visible cards)."""
    from ..tiles.network import RoadNetwork, grid_city

    netspec = conf.get("network", {"type": "grid"})
    kind = netspec.get("type", "grid")
    if kind == "grid":
        net = grid_city(
            rows=netspec.get("rows", 8),
            cols=netspec.get("cols", 8),
            spacing_m=netspec.get("spacing_m", 200.0),
            origin=tuple(netspec.get("origin", (37.75, -122.45))),
        )
    elif kind == "file":
        with open(netspec["path"]) as f:
            net = RoadNetwork.from_dict(json.load(f))
    else:  # "tiles": parse_service_config refused every other type
        from ..tiles.codec import load_network_tiles

        net = load_network_tiles(netspec["path"])
    return SegmentMatcher(network=net, config=cfg, device=device,
                          backend=conf.get("backend", "jax"))
