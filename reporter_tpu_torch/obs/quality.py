"""Match-quality observability plane: shadow-oracle sampling and the
online agreement surfaces (docs/match-quality.md).

Latency, errors and burn rates say how the service answers; this
module says how WELL: agreement falls at the long sampling gaps real
probe fleets emit, and nothing in production would notice that
regression until someone reruns an offline sweep.  It is the sensor
layer:

  * **Shadow-oracle sampling.**  1-in-N served requests
    (``REPORTER_QUALITY_SAMPLE_EVERY``; 0 disables) are re-matched on a
    background worker through the brute-force f64 oracle
    (baseline/brute_matcher.py — exhaustive candidates, exact Dijkstra,
    none of the device kernels' shared machinery) and scored for
    segment-level agreement against the answer the client actually
    received.  The hand-off is a bounded queue: a slow oracle drops
    samples (counted), it never backs the serving path up.

  * **Cohort gauges.**  Each comparison lands in per-cohort sliding
    windows labeled by sampling-gap bucket, trace-length bucket, viterbi
    kernel, UBODT layout, and params group (default vs per-request
    match_options) — so the sparse-gap accuracy cliff shows up as a
    falling ``reporter_quality_agreement{gap="45-60"}`` gauge in
    production instead of a rerun offline sweep.

  * **The agreement SLO.**  Every comparison feeds the SLO engine's
    "agreement" sample series (obs/slo.observe_sample); ``configure``
    ensures an ``agreement`` objective exists (target
    ``REPORTER_QUALITY_TARGET`` / config, default 0.90), so windowed
    mean agreement gets the same multi-window burn-rate alerting,
    /debug/slo surface and reporter_slo_* families as availability and
    latency.

  * **Gate snapshots.**  ``report()`` is the quality section of
    GET /debug/slo; its ``overall``/``cohorts`` shape is exactly what
    tools/quality_gate.py judges against a pinned baseline profile
    (QUALITY_BASELINE.json) in the gating quality-rehearsal CI leg.

Kernel confidence diagnostics (the other quality signal: per-trace
winner-vs-runner-up viterbi margins, candidate-pool exhaustion) are
computed on the device (the kernels' [B, 4] aux) and surfaced here as
the ``reporter_match_margin`` histogram + low-margin counter; the serve
tier retains low-margin traces in the flight recorder like slow ones.

Env knobs (all also settable via the service config "quality" block):
  REPORTER_QUALITY_SAMPLE_EVERY  shadow-sample 1-in-N requests (0 = off)
  REPORTER_QUALITY_QUEUE         bounded sample queue depth (default 64)
  REPORTER_QUALITY_WINDOW_S      cohort sliding window (default 600)
  REPORTER_QUALITY_TARGET        agreement objective target (default 0.90)
  REPORTER_QUALITY_MARGIN_KEEP   flight-keep margin threshold (default 1.0)
  REPORTER_QUALITY_PACE          worker self-throttle: sleep PACE x each
                                 compare's cost, bounding the oracle's
                                 CPU/GIL duty cycle to 1/(1+PACE)
                                 (default 3 -> <=25%)
"""

from __future__ import annotations

import logging
import math
import os
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import log as obs_log
from . import metrics as obs
from . import slo as obs_slo

log = logging.getLogger(__name__)

# gap buckets follow the offline delta-sweep cohorts: the reference's
# BatchingProcessor operating point (>= 45 s) gets its own two buckets so
# the open-item-4 cliff is a labeled gauge, not an aggregate
GAP_BUCKETS: Tuple[Tuple[float, str], ...] = (
    (15.0, "lt15"), (30.0, "15-30"), (45.0, "30-45"),
    (60.0, "45-60"), (math.inf, "ge60"),
)

C_SAMPLES = obs.counter(
    "reporter_quality_samples_total",
    "Shadow-oracle sampling decisions (sampled / dropped_queue = bounded "
    "hand-off full / compared / error / skipped = no per-point edges)",
    ("outcome",))
C_QPOINTS = obs.counter(
    "reporter_quality_points_total",
    "Shadow-compared trace points by verdict (agree / disagree on the "
    "matched OSMLR segment vs the brute-force f64 oracle)",
    ("verdict",))
G_AGREE = obs.gauge(
    "reporter_quality_agreement",
    "Windowed mean shadow-oracle segment agreement per cohort: sampling-"
    "gap bucket, trace-length bucket, viterbi kernel, UBODT layout, and "
    "params group (default config vs per-request match_options)",
    ("gap", "len", "kernel", "layout", "params"))
G_QDEPTH = obs.gauge(
    "reporter_quality_queue_depth",
    "Shadow-oracle sample queue depth (bounded; overflow drops are "
    "counted, never block the serving path)")
H_ORACLE_S = obs.histogram(
    "reporter_quality_oracle_seconds",
    "Wall seconds per shadow-oracle re-match (brute-force f64, off the "
    "hot path on the quality worker thread)")
H_MARGIN = obs.histogram(
    "reporter_match_margin",
    "Per-trace mean winner-vs-runner-up viterbi score margin (log-prob "
    "units; small = the decode was nearly ambiguous — "
    "docs/match-quality.md)",
    buckets=(0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0, 300.0, 1000.0))
C_LOW_MARGIN = obs.counter(
    "reporter_match_low_margin_total",
    "Traces whose mean winner-vs-runner-up margin fell below the "
    "REPORTER_QUALITY_MARGIN_KEEP threshold (retained by the flight "
    "recorder like slow traces; the min margin is reported but not "
    "thresholded — two-way streets tie it to 0 routinely)")


def _env_num(name: str, default: float) -> float:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return float(default)


def _resolve(env: str, spec_val, default: float) -> float:
    if os.environ.get(env, "").strip():
        return _env_num(env, default if spec_val is None else spec_val)
    return float(default if spec_val is None else spec_val)


def gap_bucket(times: List[float]) -> str:
    """Cohort label from a trace's median inter-point gap (seconds)."""
    if len(times) < 2:
        return GAP_BUCKETS[0][1]
    gaps = np.diff(np.asarray(times, np.float64))
    med = float(np.median(gaps))
    for bound, label in GAP_BUCKETS:
        if med < bound:
            return label
    return GAP_BUCKETS[-1][1]


def len_bucket(n: int) -> str:
    return "short" if n <= 32 else ("med" if n <= 128 else "long")


class QualityEngine:
    """Owns the sample queue, the oracle worker, and the cohort windows.
    One per process (module-level ``configure``/``engine``), fed by
    serve/service.py after each successful match."""

    def __init__(self, matcher, sample_every: Optional[int] = None,
                 queue_max: Optional[int] = None,
                 window_s: Optional[float] = None,
                 target: Optional[float] = None,
                 slo_feed=None, clock=time.monotonic,
                 start_worker: bool = True):
        self.matcher = matcher
        self.sample_every = int(_resolve(
            "REPORTER_QUALITY_SAMPLE_EVERY", sample_every, 0))
        self.queue_max = max(1, int(_resolve(
            "REPORTER_QUALITY_QUEUE", queue_max, 64)))
        self.window_s = max(1.0, _resolve(
            "REPORTER_QUALITY_WINDOW_S", window_s, 600.0))
        self.target = _resolve("REPORTER_QUALITY_TARGET", target, 0.90)
        self.pace = _resolve("REPORTER_QUALITY_PACE", None, 3.0)
        self._clock = clock
        # default SLO feed: the process-wide engine, resolved per call so
        # a later obs_slo.configure() swap keeps receiving samples
        self._slo_feed = slo_feed if slo_feed is not None else (
            lambda v, w: obs_slo.engine().observe_sample("agreement", v, w))
        self._q: "queue.Queue[tuple]" = queue.Queue(maxsize=self.queue_max)
        self._lock = threading.Lock()
        self._n_seen = 0
        self._n_compared = 0
        self._n_dropped = 0
        # cohort label tuple -> deque[(t, agree_points, total_points)]
        self._windows: Dict[tuple, deque] = {}
        # one brute oracle per effective-params key; route caches grow
        # with use, so the map is bounded
        self._oracles: Dict[tuple, object] = {}
        self._worker: Optional[threading.Thread] = None
        if self.sample_every > 0 and start_worker:
            self._worker = threading.Thread(
                target=self._worker_loop, daemon=True, name="quality-oracle")
            self._worker.start()
        obs.REGISTRY.register_collect(
            lambda: G_QDEPTH.set(self._q.qsize()))

    # -- hot-path side (the serving thread) --------------------------------

    def maybe_sample(self, trace: dict, prod_quality: Optional[dict]) -> bool:
        """Offer one served request for shadow comparison.  Strictly off
        the hot path: a counter check plus (1-in-N) a non-blocking
        enqueue; a full queue drops the sample and counts it."""
        if self.sample_every <= 0:
            return False
        if not prod_quality or not prod_quality.get("edge"):
            C_SAMPLES.labels("skipped").inc()
            return False
        with self._lock:
            self._n_seen += 1
            take = self._n_seen % self.sample_every == 0
        if not take:
            return False
        try:
            self._q.put_nowait((trace, list(prod_quality["edge"])))
        except queue.Full:
            with self._lock:
                self._n_dropped += 1
            C_SAMPLES.labels("dropped_queue").inc()
            return False
        C_SAMPLES.labels("sampled").inc()
        return True

    # -- oracle side (the background worker) -------------------------------

    def _worker_loop(self) -> None:
        # best-effort: drop this thread's scheduling priority (Linux
        # setpriority acts per-thread when given a native tid) — when the
        # oracle and a serving thread are both runnable, serving wins
        try:
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 10)
        except (AttributeError, OSError):  # pragma: no cover - platform
            pass
        while True:
            item = self._q.get()
            t0 = time.monotonic()
            try:
                self.compare(*item)
            except Exception:  # noqa: BLE001 - one bad sample, not the loop
                C_SAMPLES.labels("error").inc()
                log.exception("shadow-oracle comparison failed")
            finally:
                self._q.task_done()
            # self-throttle: sleep ``pace`` x the compare cost so the
            # worker's CPU (and GIL) duty cycle stays under 1/(1+pace)
            # regardless of oracle cost (the serving threads win the GIL)
            if self.pace > 0:
                time.sleep(min(self.pace * (time.monotonic() - t0), 1.0))

    def _oracle_for(self, pkey: tuple, slabel: str = ""):
        """The f64 oracle twin for one (params group, sparse cohort).  A
        sparse-cohort trace was served by the time-adaptive model with
        that cohort's (possibly calibrated) parameters — the oracle must
        re-derive the SAME model in f64, or a model improvement would
        score as a regression (docs/match-quality.md "Sparse gaps")."""
        key = (pkey, slabel)
        oracle = self._oracles.get(key)
        if oracle is None:
            import dataclasses

            from ..baseline.brute_matcher import BruteForceMatcher

            if len(self._oracles) >= 8:
                self._oracles.clear()
            cfg = self.matcher.cfg
            sparse = None
            if slabel:
                vals = self.matcher.sparse.oracle_values(slabel, pkey)
                cfg = dataclasses.replace(
                    cfg, sigma_z=vals["sigma_z"], beta=vals["beta"],
                    search_radius=vals["search_radius"])
                sparse = vals
            elif pkey:
                cfg = dataclasses.replace(
                    cfg, sigma_z=pkey[0], beta=pkey[1], search_radius=pkey[2])
            oracle = BruteForceMatcher(self.matcher.arrays, cfg,
                                       sparse=sparse)
            self._oracles[key] = oracle
        return oracle

    def compare(self, trace: dict, prod_edges: List[int]) -> Optional[float]:
        """Re-match one trace through the brute-force oracle and score
        segment-level agreement against the served per-point edges.
        Returns the agreement fraction (None when nothing comparable)."""
        pts = trace.get("trace") or []
        n = min(len(pts), len(prod_edges))
        if n < 2:
            C_SAMPLES.labels("skipped").inc()
            return None
        a = self.matcher.arrays
        lats = np.array([p["lat"] for p in pts[:n]], np.float64)
        lons = np.array([p["lon"] for p in pts[:n]], np.float64)
        times = [float(p["time"]) for p in pts[:n]]
        xs, ys = a.proj.to_xy(lats, lons)
        pkey = self.matcher._params_key(trace)
        sm = getattr(self.matcher, "sparse", None)
        slabel = ""
        if sm is not None and sm.enabled and self.matcher.backend == "jax":
            slabel = sm.label_for_times(times) or ""
        oracle = self._oracle_for(pkey, slabel)
        t0 = time.monotonic()
        oracle_edge, _off, _brk = oracle.match_points(xs, ys, times)
        H_ORACLE_S.observe(time.monotonic() - t0)

        # segment-level agreement, the bench/BASELINE metric: compare the
        # matched OSMLR segment ids (unmatched = -1 on both sides agrees)
        prod = np.asarray(prod_edges[:n], np.int64)
        seg_prod = np.where(prod >= 0, a.edge_seg[np.maximum(prod, 0)], -1)
        seg_oracle = np.where(oracle_edge >= 0,
                              a.edge_seg[np.maximum(oracle_edge, 0)], -1)
        agree_pts = int((seg_prod == seg_oracle).sum())
        frac = agree_pts / n
        C_QPOINTS.labels("agree").inc(agree_pts)
        C_QPOINTS.labels("disagree").inc(n - agree_pts)

        labels = self._labels(trace, times, n, pkey)
        now = self._clock()
        with self._lock:
            self._n_compared += 1
            win = self._windows.get(labels)
            if win is None:
                win = self._windows[labels] = deque()
            win.append((now, agree_pts, n))
            self._prune(win, now)
            mean = self._window_mean(win)
        G_AGREE.labels(*labels).set(mean)
        C_SAMPLES.labels("compared").inc()
        try:
            self._slo_feed(frac, float(n))
        except Exception:  # noqa: BLE001 - the gauge plane must survive
            log.exception("agreement SLO feed failed")
        if frac < self.target:
            obs_log.event(
                log, "quality_disagreement", level=logging.WARNING,
                uuid=str(trace.get("uuid", ""))[:64], agreement=round(frac, 4),
                points=n, gap=labels[0], params=labels[4])
        return frac

    def _labels(self, trace: dict, times: List[float], n: int,
                pkey: tuple) -> tuple:
        m = self.matcher
        try:
            kernel = m._kernel_for(m._bucket_len(n))
        except Exception:  # noqa: BLE001 - cpu backend etc.
            kernel = getattr(m, "_kernel_mode", "scan")
        layout = getattr(m, "_ubodt_layout",
                         getattr(m.ubodt, "layout", "cuckoo"))
        return (gap_bucket(times), len_bucket(n), kernel, layout,
                "custom" if pkey else "default")

    @staticmethod
    def _window_mean(win: deque) -> float:
        total = sum(t for _ts, _a, t in win)
        agree = sum(a for _ts, a, _t in win)
        return agree / total if total else 0.0

    def _prune(self, win: deque, now: float) -> None:
        horizon = now - self.window_s
        while win and win[0][0] < horizon:
            win.popleft()

    # -- read paths --------------------------------------------------------

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until the sample queue is empty (tests / the rehearsal
        poll this between load and snapshot)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._q.qsize() == 0 and self._q.unfinished_tasks == 0:
                return True
            time.sleep(0.02)
        return False

    def report(self) -> dict:
        """The quality section of GET /debug/slo — and, verbatim, the
        snapshot tools/quality_gate.py judges against the pinned
        baseline profile."""
        now = self._clock()
        cohorts = {}
        tot_agree = 0
        tot_pts = 0
        with self._lock:
            for labels, win in sorted(self._windows.items()):
                self._prune(win, now)
                pts = sum(t for _ts, _a, t in win)
                agree = sum(a for _ts, a, _t in win)
                if pts <= 0:
                    continue
                key = "gap=%s|len=%s|kernel=%s|layout=%s|params=%s" % labels
                cohorts[key] = {
                    "agreement": round(agree / pts, 4),
                    "points": pts,
                    "samples": len(win),
                }
                tot_agree += agree
                tot_pts += pts
            seen, compared, dropped = (self._n_seen, self._n_compared,
                                       self._n_dropped)
        return {
            "enabled": self.sample_every > 0,
            "sample_every": self.sample_every,
            "window_s": self.window_s,
            "target": self.target,
            "queue_depth": self._q.qsize(),
            "queue_max": self.queue_max,
            "requests_seen": seen,
            "samples_compared": compared,
            "samples_dropped": dropped,
            "overall": ({"agreement": round(tot_agree / tot_pts, 4),
                         "points": tot_pts} if tot_pts else
                        {"agreement": None, "points": 0}),
            "cohorts": cohorts,
        }

    def summary(self) -> dict:
        """The /statusz one-liner."""
        rep = self.report()
        return {
            "enabled": rep["enabled"],
            "sample_every": rep["sample_every"],
            "agreement": rep["overall"]["agreement"],
            "points": rep["overall"]["points"],
            "queue_depth": rep["queue_depth"],
            "dropped": rep["samples_dropped"],
        }


# -- module-level wiring (the serve tier's one engine) -----------------------

_ENGINE: Optional[QualityEngine] = None


def engine() -> Optional[QualityEngine]:
    return _ENGINE


def ensure_agreement_objective(target: float) -> None:
    """Make sure the process SLO engine carries an ``agreement``
    objective (idempotent): sampling without a stated objective would
    measure quality while alerting on nothing."""
    eng = obs_slo.engine()
    if not any(o.kind == "agreement" for o in eng.objectives):
        eng.objectives.append(
            obs_slo.Objective("agreement", "agreement", float(target)))


def configure(matcher, spec: Optional[dict] = None) -> Optional[QualityEngine]:
    """Build (or disable) the process quality engine from the service
    config "quality" block + env knobs.  Returns the engine, or None when
    sampling is off.  Enables the matcher's confidence-aux programs when
    sampling needs the per-point edges they carry."""
    global _ENGINE
    spec = spec or {}
    sample_every = int(_resolve("REPORTER_QUALITY_SAMPLE_EVERY",
                                spec.get("sample_every"), 0))
    if sample_every <= 0:
        _ENGINE = None
        return None
    if not getattr(matcher, "_quality_aux", False):
        # sampling needs the per-point edges the aux-enabled dispatch
        # attaches; flipping the flag compiles the aux program variants
        # lazily (the jit cache keys on it)
        matcher._quality_aux = True
    eng = QualityEngine(
        matcher,
        sample_every=sample_every,
        queue_max=spec.get("queue_max"),
        window_s=spec.get("window_s"),
        target=spec.get("target"),
    )
    ensure_agreement_objective(eng.target)
    _ENGINE = eng
    obs_log.event(log, "quality_engine_configured", sample_every=sample_every,
                  window_s=eng.window_s, target=eng.target)
    return eng
