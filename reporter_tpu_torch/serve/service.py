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
  GET  /health -> {"status": "ok", ...}

A single shared matcher owns the device.  One MicroBatcher aggregates
concurrent windowed requests into padded [B, T] batches; a second one, with
a much shorter fill window, aggregates streaming submits into session
steps (matching/session.py).  Fault domains, SLO accounting, quality
sampling, the /sessions export, the binary wire and the router are not
part of this slice.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time as _time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Set, Tuple
from urllib.parse import parse_qs, urlsplit

from ..matching import SegmentMatcher, SessionEngine, SessionStore
from ..report import report as report_fn

log = logging.getLogger(__name__)

ACTIONS = {"report", "health"}
# dispatched batches allowed to wait for the finisher: bounds the
# device-pinned inputs and outputs of batches not yet associated
MAX_INFLIGHT = 2


class MicroBatcher:
    """Aggregates traces from concurrent requests into one device batch.

    Traces are enqueued with a Future; a dispatch thread drains the queue,
    waits up to ``max_wait_ms`` to fill ``max_batch`` slots and queues the
    device work (``matcher.match_many_async``: a SegmentMatcher's, or a
    SessionEngine's for streaming submits); a finisher thread blocks on
    the device, runs host association and resolves the futures, so
    association of batch N overlaps device work of batch N+1.  The hand-off
    queue is bounded (MAX_INFLIGHT) to bound device-pinned memory.
    """

    def __init__(self, matcher, max_batch: int = 64,
                 max_wait_ms: float = 10.0):
        self.matcher = matcher
        self.max_batch = max(1, int(max_batch))
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._finish_q: "queue.Queue" = queue.Queue(maxsize=MAX_INFLIGHT)
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="batch-dispatch")
        self._finisher = threading.Thread(target=self._finish_worker,
                                          daemon=True, name="batch-finish")
        self._thread.start()
        self._finisher.start()

    def submit(self, trace: dict) -> Future:
        if self._closed.is_set():
            raise RuntimeError("batcher closed")
        f: Future = Future()
        self._q.put((trace, f))
        return f

    def match(self, trace: dict) -> dict:
        return self.submit(trace).result()

    def close(self, timeout: float = 5.0) -> None:
        """Stop both threads after the work already queued."""
        self._closed.set()
        self._q.put(None)
        self._thread.join(timeout)
        self._finisher.join(timeout)

    @staticmethod
    def _fail(batch, e: BaseException) -> None:
        for _t, f in batch:
            if not f.done():
                f.set_exception(e)

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
            try:
                finish = self.matcher.match_many_async([t for t, _f in batch])
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
            for (_t, f), r in zip(batch, results):
                f.set_result(r)


class ReporterService:
    """Owns the matcher and the batcher and implements /report."""

    def __init__(self, matcher: SegmentMatcher, threshold_sec: Optional[int] = None,
                 max_batch: int = 64, max_wait_ms: float = 10.0,
                 session_max_batch: int = 256, session_wait_ms: float = 2.0):
        if threshold_sec is None:
            threshold_sec = int(os.environ.get("THRESHOLD_SEC",
                                               matcher.cfg.threshold_sec))
        self.threshold_sec = int(threshold_sec)
        self.matcher = matcher
        self.batcher = MicroBatcher(matcher, max_batch=max_batch,
                                    max_wait_ms=max_wait_ms)
        cfg = matcher.cfg
        self.session_store = SessionStore(cfg.max_sessions, cfg.session_ttl_s)
        self.session_engine = SessionEngine(matcher, self.session_store,
                                            tail_points=cfg.session_tail_points)
        # streaming submits batch on their own MicroBatcher with a short
        # fill window: a session's point is answered at point latency
        self.session_batcher = MicroBatcher(
            self.session_engine, max_batch=session_max_batch,
            max_wait_ms=session_wait_ms)
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

    def handle_report(self, trace: dict) -> Tuple[int, dict]:
        err, rl, tl = self.validate(trace)
        if err:
            return 400, {"error": err}
        batcher = self.session_batcher if trace.get("stream") else self.batcher
        try:
            match = batcher.match(trace)
        except Exception as e:  # noqa: BLE001 - the request gets the error
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

    def handle_health(self) -> Tuple[int, dict]:
        m = self.matcher
        out = {
            "status": "ok",
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
                body = json.dumps(payload, separators=(",", ":")).encode("utf-8")
                self.send_response(code)
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Content-Type", "application/json;charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _route(self, post: bool):
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
                    if post:
                        payload = json.loads(raw.decode("utf-8"))
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
                    code, out = service.handle_report(payload)
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


# the "batch" keys this port reads; the reference's others (max_inflight)
# are dropped with a warning
BATCH_KEYS = ("max_batch", "max_wait_ms", "session_max_batch", "session_wait_ms")


def batch_options(conf: dict) -> dict:
    """ReporterService's batching arguments from a service config's
    "batch" block; every other key of the block is dropped with one
    warning per key per process."""
    from ..matching.config import warn_dropped

    batch = conf.get("batch", {})
    for k in batch:
        if k not in BATCH_KEYS:
            warn_dropped("batch config", k)
    return {"max_batch": int(batch.get("max_batch", 64)),
            "max_wait_ms": float(batch.get("max_wait_ms", 10.0)),
            "session_max_batch": int(batch.get("session_max_batch", 256)),
            "session_wait_ms": float(batch.get("session_wait_ms", 2.0))}


def parse_service_config(path: str):
    """(MatcherConfig, conf dict) from a service config JSON of the
    reference's shape: {"network": {...}, "matcher": {...}, "backend":
    "jax" | "cpu", "batch": {...}}.  Network types: "grid" (rows, cols,
    spacing_m, origin) and "file" (a RoadNetwork JSON, as
    ``python -m reporter_tpu_torch.tiles.osm ... --json`` writes it); the
    native tile codec ("tiles") is not ported yet.  "backend": "jax" (the
    reference configs' word, and the default) is the port's device
    program, "cpu" the CPU baseline."""
    from ..matching import MatcherConfig

    with open(path) as f:
        conf = json.load(f)
    mconf = conf.get("matcher", {})
    if "meili" in mconf or "default" in mconf:
        cfg = MatcherConfig.from_meili(mconf)
    else:
        cfg = MatcherConfig.from_dict(mconf)
    kind = conf.get("network", {"type": "grid"}).get("type", "grid")
    if kind not in ("grid", "file"):
        raise ValueError("network type %r is not supported by this port "
                         "(grid or file)" % (kind,))
    if conf.get("backend", "jax") not in ("jax", "cpu"):
        raise ValueError("backend %r is not one of jax, cpu" % (conf["backend"],))
    return cfg, conf


def build_matcher(cfg, conf: dict, device="cuda") -> SegmentMatcher:
    """Load or build the network, build the UBODT and move both to
    ``device`` (with the config's ``devices`` / ``graph_devices`` above 1,
    a list of the mesh's devices, or "cuda" for the visible cards)."""
    from ..tiles.network import RoadNetwork, grid_city

    netspec = conf.get("network", {"type": "grid"})
    if netspec.get("type", "grid") == "grid":
        net = grid_city(
            rows=netspec.get("rows", 8),
            cols=netspec.get("cols", 8),
            spacing_m=netspec.get("spacing_m", 200.0),
            origin=tuple(netspec.get("origin", (37.75, -122.45))),
        )
    else:
        with open(netspec["path"]) as f:
            net = RoadNetwork.from_dict(json.load(f))
    return SegmentMatcher(network=net, config=cfg, device=device,
                          backend=conf.get("backend", "jax"))
