"""HTTP matching service (lean slice).

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

Both matching routes take gzip bodies (Content-Encoding: gzip, inflated
within $REPORTER_MAX_INFLATE_MB, 256 by default; another encoding than
identity is a 415) and the binary columnar wire (serve/wire.py):
Content-Type application/x-reporter-columnar bodies decode as frames, and
Accept: application/x-reporter-columnar gets a frame back on a 200 (every
error stays JSON).  $REPORTER_WIRE=0 turns the binary wire off (binary
bodies get a 415).

Admission (docs/robustness.md): the submit queue holds at most max_queue
traces ($REPORTER_MAX_QUEUE, 1024) and sheds past it with a 429 and a
Retry-After header; a trace waits at most deadline_ms in the queue
($REPORTER_DEADLINE_MS, 30000; <= 0 turns the server's default off), or
the client's X-Reporter-Deadline-Ms from ingestion, and is answered 504
before dispatch once that has passed.

A single shared matcher owns the device.  One MicroBatcher aggregates
concurrent windowed requests into padded [B, T] batches; a second one, with
a much shorter fill window, aggregates streaming submits into session
steps (matching/session.py).  The watchdog, the degraded CPU fallback,
poison quarantine, SLO accounting, quality sampling, the /sessions export
and the router are not part of this slice.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time as _time
import zlib
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Set, Tuple
from urllib.parse import parse_qs, urlsplit

from ..matching import SegmentMatcher, SessionEngine, SessionStore
from ..report import report as report_fn
from . import wire

log = logging.getLogger(__name__)

ACTIONS = {"report", "trace_attributes_batch", "health"}

# gzip request bodies: bound on the DECOMPRESSED size so a tiny zip bomb
# cannot balloon a handler thread, refused with a 400 beyond it
# ($REPORTER_MAX_INFLATE_MB overrides)
try:
    _MAX_INFLATE = int(float(os.environ["REPORTER_MAX_INFLATE_MB"])) << 20
except (KeyError, ValueError):
    _MAX_INFLATE = 256 << 20


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
    """An admission knob: the environment's value (a malformed one falls
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

    Admission: the submit queue holds at most ``max_queue`` traces
    ($REPORTER_MAX_QUEUE, 1024) and ``submit`` sheds past it with
    Overloaded; every entry carries a deadline (``deadline_ms`` from
    submit, $REPORTER_DEADLINE_MS, 30000; <= 0 sets none unless the caller
    gives one), and entries whose deadline has passed are resolved with
    DeadlineExpired before dispatch, so they never take a device slot.
    """

    def __init__(self, matcher, max_batch: int = 64, max_wait_ms: float = 10.0,
                 max_inflight: Optional[int] = None, max_queue: Optional[int] = None,
                 deadline_ms: Optional[float] = None):
        if max_inflight is None:
            max_inflight = 4 if _on_card(matcher) else 2
        # a queue.Queue of maxsize <= 0 is unbounded: clamp a configured 0
        # to the strictest bound instead
        self.max_inflight = max(1, int(max_inflight))
        self.matcher = matcher
        self.max_batch = max(1, int(max_batch))
        self.max_wait = max_wait_ms / 1000.0
        self.max_queue = max(1, int(_resolve_num("REPORTER_MAX_QUEUE", max_queue, 1024)))
        self.deadline_s = _resolve_num("REPORTER_DEADLINE_MS", deadline_ms, 30000.0) / 1000.0
        self._q: "queue.Queue" = queue.Queue(maxsize=self.max_queue)
        self._finish_q: "queue.Queue" = queue.Queue(maxsize=self.max_inflight)
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="batch-dispatch")
        self._finisher = threading.Thread(target=self._finish_worker,
                                          daemon=True, name="batch-finish")
        self._thread.start()
        self._finisher.start()

    def submit(self, trace: dict, deadline: Optional[float] = None) -> Future:
        """Queue one trace; sheds with Overloaded when the queue is full.
        ``deadline`` is an absolute ``time.monotonic()`` bound; None applies
        the server's default."""
        if self._closed.is_set():
            raise RuntimeError("batcher closed")
        now = _time.monotonic()
        if deadline is None and self.deadline_s > 0:
            deadline = now + self.deadline_s
        f: Future = Future()
        try:
            self._q.put_nowait((trace, f, now, deadline))
        except queue.Full:
            raise Overloaded("submit queue full (%d waiting)" % self._q.qsize()) from None
        return f

    def match(self, trace: dict, deadline: Optional[float] = None) -> dict:
        return self.submit(trace, deadline).result()

    def match_many(self, traces: List[dict], deadline: Optional[float] = None) -> List[dict]:
        futures = [self.submit(t, deadline) for t in traces]
        return [f.result() for f in futures]

    def retry_after_s(self) -> int:
        """Backoff hint of a 429: the deeper the queue, the longer, capped
        so that clients re-probe within their retry budget."""
        return max(1, min(30, 1 + self._q.qsize() // self.max_batch))

    def close(self, timeout: float = 5.0) -> None:
        """Stop both threads after the work already queued."""
        self._closed.set()
        try:
            self._q.put(None, timeout=timeout)
        except queue.Full:
            log.warning("batcher queue still full at close; its threads stay behind")
            return
        self._thread.join(timeout)
        self._finisher.join(timeout)

    @staticmethod
    def _fail(batch, e: BaseException) -> None:
        for entry in batch:
            if not entry[1].done():
                entry[1].set_exception(e)

    def _live(self, batch):
        """The entries whose deadline has not passed; the others are
        answered with DeadlineExpired now."""
        now = _time.monotonic()
        live = []
        for entry in batch:
            dl = entry[3]
            if dl is not None and now > dl:
                entry[1].set_exception(DeadlineExpired(
                    "deadline expired after %.3fs in queue" % (now - entry[2])))
            else:
                live.append(entry)
        return live

    def _worker(self):
        while True:
            entry = self._q.get()
            if entry is None:
                self._finish_q.put(None)
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
                try:
                    finish = self.matcher.match_many_async([e[0] for e in batch])
                except Exception as e:  # noqa: BLE001 - answered per request
                    log.exception("batch dispatch failed")
                    self._fail(batch, e)
                else:
                    self._finish_q.put((batch, finish))
            if stop:
                self._finish_q.put(None)
                return

    def _finish_worker(self):
        while True:
            item = self._finish_q.get()
            if item is None:
                return
            batch, finish = item
            try:
                results = finish()
            except Exception as e:  # noqa: BLE001 - answered per request
                log.exception("batch match failed")
                self._fail(batch, e)
                continue
            for entry, r in zip(batch, results):
                entry[1].set_result(r)


class ReporterService:
    """Owns the matcher and the batchers and implements /report,
    /trace_attributes_batch and /health."""

    # the "robustness" keys this port carries; the reference's others
    # (the watchdog, poison quarantine, session checkpoints, the degraded
    # mode's re-attach probe) are dropped with one warning per key
    ROBUSTNESS_KEYS = ("max_queue", "deadline_ms")

    def __init__(self, matcher: SegmentMatcher, threshold_sec: Optional[int] = None,
                 max_batch: int = 64, max_wait_ms: float = 10.0,
                 max_inflight: Optional[int] = None, robustness: Optional[dict] = None,
                 session_max_batch: int = 256, session_wait_ms: float = 2.0):
        from ..matching.config import warn_dropped

        if threshold_sec is None:
            threshold_sec = int(os.environ.get("THRESHOLD_SEC",
                                               matcher.cfg.threshold_sec))
        self.threshold_sec = int(threshold_sec)
        self.matcher = matcher
        rb = dict(robustness or {})
        for k in rb:
            if k not in self.ROBUSTNESS_KEYS:
                warn_dropped("robustness config", k)
        admission = {k: rb[k] for k in self.ROBUSTNESS_KEYS if k in rb}
        self.batcher = MicroBatcher(matcher, max_batch=max_batch, max_wait_ms=max_wait_ms,
                                    max_inflight=max_inflight, **admission)
        cfg = matcher.cfg
        self.session_store = SessionStore(cfg.max_sessions, cfg.session_ttl_s)
        self.session_engine = SessionEngine(matcher, self.session_store,
                                            tail_points=cfg.session_tail_points)
        # streaming submits batch on their own MicroBatcher with a short
        # fill window: a session's point is answered at point latency
        self.session_batcher = MicroBatcher(
            self.session_engine, max_batch=session_max_batch,
            max_wait_ms=session_wait_ms, **admission)
        # the binary columnar wire, accepted and emitted when a client
        # negotiates it; $REPORTER_WIRE=0 turns it off (binary bodies get a
        # 415 and /health stops advertising it)
        self.wire_enabled = (os.environ.get("REPORTER_WIRE", "").strip().lower()
                             not in ("0", "false", "off", "no"))
        self._t_boot = _time.time()

    def close(self) -> None:
        self.batcher.close()
        self.session_batcher.close()

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

    @staticmethod
    def _admission_error(e: Exception, batcher: MicroBatcher) -> Optional[Tuple[int, dict]]:
        """The answer to an admission failure, None for any other error."""
        if isinstance(e, Overloaded):
            return 429, {"error": str(e), "retry_after": batcher.retry_after_s()}
        if isinstance(e, DeadlineExpired):
            return 504, {"error": str(e)}
        return None

    def handle_report(self, trace: dict,
                      deadline: Optional[float] = None) -> Tuple[int, dict]:
        """One trace.  ``deadline`` is the absolute ``time.monotonic()``
        bound parsed from X-Reporter-Deadline-Ms at ingestion (None: the
        server's default)."""
        err, rl, tl = self.validate(trace)
        if err:
            return 400, {"error": err}
        # transport state of the binary wire (numpy arrays): never matched,
        # rendered or echoed
        trace.pop("_columns", None)
        batcher = self.session_batcher if trace.get("stream") else self.batcher
        try:
            match = batcher.match(trace, deadline)
        except Exception as e:  # noqa: BLE001 - the request gets the error
            answer = self._admission_error(e, batcher)
            if answer is not None:
                return answer
            log.exception("match failed")
            return 500, {"error": str(e)}
        match.pop("_quality", None)  # diagnostics never reach the wire
        # a streaming answer renders over the session window: the rolling
        # tail + this submit's points
        st = match.pop("_stream", None)
        render = trace if st is None else {
            "uuid": trace.get("uuid"), "trace": st["trace"],
            "match_options": trace.get("match_options") or {}}
        data = report_fn(match, render, self.threshold_sec, rl, tl,
                         mode=(trace.get("match_options") or {}).get("mode", "auto"))
        if st is not None:
            data["session"] = st["session"]
        return 200, data

    def handle_batch(self, body: dict,
                     deadline: Optional[float] = None) -> Tuple[int, dict]:
        """{"traces": [...]}: every trace validated first (a bad one is a
        400 naming its index), then one ``match_many`` on the windowed
        batcher and one report per trace, in request order."""
        traces = body.get("traces")
        if not isinstance(traces, list) or not traces:
            return 400, {"error": "traces must be a non-empty array"}
        validated = []
        for i, trace in enumerate(traces):
            err, rl, tl = self.validate(trace)
            if err:
                return 400, {"error": "trace %d: %s" % (i, err)}
            trace.pop("_columns", None)
            validated.append((trace, rl, tl))
        try:
            matches = self.batcher.match_many([t for t, _rl, _tl in validated], deadline)
            results = []
            for m, (t, rl, tl) in zip(matches, validated):
                m.pop("_quality", None)
                results.append(report_fn(m, t, self.threshold_sec, rl, tl,
                                         mode=t.get("match_options", {}).get("mode", "auto")))
        except Exception as e:  # noqa: BLE001 - the request gets the error
            answer = self._admission_error(e, self.batcher)
            if answer is not None:
                return answer
            log.exception("batch failed")
            return 500, {"error": str(e)}
        return 200, {"results": results}

    def handle_health(self) -> Tuple[int, dict]:
        m = self.matcher
        out = {
            "status": "ok",
            # wire-level opt-ins a client may negotiate: gzip request bodies
            # always, the binary columnar wire unless $REPORTER_WIRE=0
            "capabilities": ["gzip", "wire-columnar"] if self.wire_enabled else ["gzip"],
            "device": str(m.device),
            "backend": m.backend,
            "mesh": ({"dp": m._mesh.n_dp, "gp": m._mesh.n_gp}
                     if m._mesh is not None else None),
            "max_trace_points": m.max_trace_points,
            "viterbi_kernel": m._kernel_mode,
            "ubodt_shard": ("%d/%d" % m.ubodt_shard) if m.ubodt_shard else None,
            "ubodt_tiered": m.tiering is not None,
            "sessions": self.session_store.summary(),
            "uptime_s": round(_time.time() - self._t_boot, 1),
        }
        if m.tiering is not None:
            out["ubodt_tier"] = m.tiering.summary()
        if m.session_arena is not None:
            out["session_arena"] = m.session_arena.summary()
        return 200, out

    def make_server(self, host: str = "0.0.0.0", port: int = 8002) -> ThreadingHTTPServer:
        service = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            timeout = 30  # idle keep-alive connections time out

            def _answer(self, code: int, payload: dict):
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
                self.send_response(code)
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if code == 429:
                    # the backoff hint as a header too (RFC 9110), for
                    # generic clients
                    try:
                        ra = max(1, int(payload.get("retry_after")))
                    except (TypeError, ValueError):
                        ra = 1
                    self.send_header("Retry-After", str(ra))
                self.end_headers()
                self.wfile.write(body)

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
                # per-request wire state: the handler lives for the whole
                # keep-alive connection, so one binary request must not
                # turn later requests on the socket binary
                self._accept_wire = self._wire_single = False
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
                    raw = self.rfile.read(n) if n else b""
                    split = urlsplit(self.path)
                    action = split.path.split("/")[-1]
                    query = parse_qs(split.query)
                    if action not in ACTIONS:
                        return self._answer(
                            400, {"error": "Try a valid action: %s" % sorted(ACTIONS)})
                    if action == "health":
                        return self._answer(*service.handle_health())
                    if service.wire_enabled and wire.CONTENT_TYPE in (
                            self.headers.get("Accept") or ""):
                        self._accept_wire = True
                        self._wire_single = action == "report"
                    if post:
                        payload, answer = self._decode(raw)
                        if answer is not None:
                            return self._answer(*answer)
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
                try:
                    handler = (service.handle_report if action == "report"
                               else service.handle_batch)
                    code, out = handler(payload, self._deadline())
                except Exception as e:  # noqa: BLE001 - never drop the socket
                    log.exception("unhandled request error")
                    code, out = 500, {"error": str(e)}
                self._answer(code, out)

            def do_GET(self):
                self._route(post=False)

            def do_POST(self):
                self._route(post=True)

            def log_message(self, fmt, *args):
                log.debug("http: " + fmt, *args)

        class Server(ThreadingHTTPServer):
            request_queue_size = 128
            daemon_threads = True

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
