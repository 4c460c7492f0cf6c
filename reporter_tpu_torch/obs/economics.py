"""Fleet economics sensors: chip-second cost ledger, persistent demand
history, and measured capacity headroom (docs/economics.md).

A serving replica is not free: this module measures what it COSTS and
how close it is to its ceiling.  It is the sensor half — three instruments, no policy:

  CostLedger          every replica accrues chip-seconds (wall-clock x
                      device count) attributed to the service's existing
                      lifecycle states — serving / idle / degraded /
                      draining — and prices them against a configurable
                      $/chip-hour (REPORTER_COST_PER_CHIP_HOUR > config
                      "economics" block > default).  $-per-million-
                      matched-points derives from the points ledger
                      (reporter_points_matched_total).

  DemandHistory       an append-only on-disk JSONL ring: one record per
                      tick (burn, queue depth, admitted/shed rates,
                      headroom), bounded by size with atomic two-epoch
                      rotation (os.replace), tolerant of crash-truncated
                      tails, continuous across restarts and SIGKILL.
                      This is the training/eval series the future
                      forecaster consumes (tools/demand_export.py turns
                      a window of it back into a loadgen profile).

  CapacityEstimator   the replica's serving ceiling as a MEASURED number
                      (arXiv:1910.10032's batched-throughput accounting,
                      not a config guess): windowed device-step p95 x
                      effective max_batch, re-anchored by the observed
                      admitted rate at shed onset (the one moment the
                      true ceiling is directly visible).  headroom =
                      ceiling - demand; time-to-exhaustion extrapolates
                      the demand slope.

EconomicsEngine owns all three plus the sampling tick; the service
exposes it at GET /debug/cost and /debug/history?window=S and the
router federates a fleet roll-up.  FleetCostLedger is the fleet
supervisor's ledger across replica incarnations.  Everything here is
pure stdlib and injectable-clock testable (the SLOEngine/Autoscaler
idiom).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from . import metrics as obs
from .quantile import hist_quantile

# default $/chip-hour when neither env nor config prices the fleet: a
# placeholder (the JAX package's default, so both packages bill alike),
# not the card's price — set REPORTER_COST_PER_CHIP_HOUR or the config's
# "economics" block.  Every surface echoes the price in use.
DEFAULT_PRICE_PER_CHIP_HOUR = 1.20

# metric families (docs/observability.md "Fleet economics").  Counters
# are published as deltas from ledger high-water marks at scrape time
# (register_collect), so they stay monotone while the ledger itself
# remains the source of truth.
C_CHIP_SECONDS = obs.counter(
    "reporter_cost_chip_seconds_total",
    "Chip-seconds accrued (wall-clock x device count), attributed to the "
    "service lifecycle state (serving / idle / degraded / draining)",
    ("state",))
C_USD = obs.counter(
    "reporter_cost_usd_total",
    "Accrued cost in dollars: total chip-seconds / 3600 x the configured "
    "price per chip-hour")
G_PRICE = obs.gauge(
    "reporter_cost_price_per_chip_hour",
    "Configured price per chip-hour (REPORTER_COST_PER_CHIP_HOUR > "
    "config \"economics\" block > default)")
G_CHIPS = obs.gauge(
    "reporter_cost_chips",
    "Devices this replica is billed for (matcher.cfg.devices; 1 before "
    "the engine attaches)")
G_USD_PER_M = obs.gauge(
    "reporter_cost_usd_per_million_points",
    "Accrued dollars per million matched points (derived from the "
    "points ledger; 0 until points have been matched)")
G_CEILING = obs.gauge(
    "reporter_capacity_ceiling_traces_per_sec",
    "Measured serving ceiling: effective max_batch / windowed device-"
    "step p95, re-anchored by the admitted rate observed at shed onset")
G_DEMAND = obs.gauge(
    "reporter_capacity_demand_traces_per_sec",
    "Offered demand estimate: admitted rate + shed rate over the last "
    "history tick")
G_HEADROOM = obs.gauge(
    "reporter_capacity_headroom_traces_per_sec",
    "Serving headroom: measured ceiling - offered demand (negative = "
    "overloaded, shedding is structural)")
G_EXHAUST = obs.gauge(
    "reporter_capacity_exhaustion_seconds",
    "Time until headroom crosses zero at the current demand slope "
    "(-1 = no exhaustion in sight: flat/falling demand or no estimate)")
C_TICKS = obs.counter(
    "reporter_history_ticks_total",
    "Demand-history records appended to the on-disk JSONL ring")
G_HIST_BYTES = obs.gauge(
    "reporter_history_bytes",
    "On-disk size of the demand-history ring (current epoch + rotated "
    "epoch), bounded by REPORTER_HISTORY_MAX_BYTES")
G_MEMORY = obs.gauge(
    "reporter_device_memory_bytes",
    "Memory accounting by space (device|host) and subsystem: the card's "
    "torch.cuda memory (in_use / limit) plus exact-by-construction bytes for "
    "the UBODT hot arena, cold pages, and the session store",
    ("space", "subsystem"))
G_SESS_PER_CHIP = obs.gauge(
    "reporter_sessions_resident_per_chip",
    "Open streaming sessions divided by billed devices, by residency "
    "tier: hot = device-slab slots, cold = pinned_host pages, host = "
    "wire-form carries in the SessionStore (the session-arena sizing "
    "signal)",
    ("tier",))


def _env_num(name: str, default: float) -> float:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return float(default)


def _resolve_num(env_name: str, param, default: float) -> float:
    """env > config > default — the service's knob convention."""
    if os.environ.get(env_name, "").strip():
        return _env_num(env_name, default if param is None else param)
    return float(default if param is None else param)


def resolve_price(spec: Optional[dict] = None) -> float:
    """$/chip-hour: REPORTER_COST_PER_CHIP_HOUR > config "economics"
    price_per_chip_hour > default."""
    spec = spec or {}
    return _resolve_num("REPORTER_COST_PER_CHIP_HOUR",
                        spec.get("price_per_chip_hour"),
                        DEFAULT_PRICE_PER_CHIP_HOUR)


def counter_total(family, match: Optional[dict] = None) -> float:
    """Sum a family's child values, optionally filtered by label values
    ({"outcome": ("ok", "degraded")} — a tuple means any-of)."""
    total = 0.0
    for labelvalues, child in family._items():
        if match:
            d = dict(zip(family.labelnames, labelvalues))
            ok = True
            for k, want in match.items():
                got = d.get(k)
                if isinstance(want, (tuple, list, set)):
                    ok = got in want
                else:
                    ok = got == want
                if not ok:
                    break
            if not ok:
                continue
        total += child.value
    return total


class CostLedger:
    """Chip-seconds by lifecycle state, priced.

    State precedence mirrors the service seams that feed it: draining >
    degraded > (serving when a matching handler is inflight, else idle).
    Accrual is lazy — every read or transition first bills the elapsed
    span to the state it was spent in — so the ledger is exact at any
    instant without its own thread."""

    STATES = ("serving", "idle", "degraded", "draining")

    def __init__(self, chips: int = 1,
                 price_per_chip_hour: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self.chips = max(1, int(chips))
        self.price = (resolve_price() if price_per_chip_hour is None
                      else float(price_per_chip_hour))
        self._cs = {s: 0.0 for s in self.STATES}
        self._mark = clock()
        self._active = 0
        self._degraded = False
        self._draining = False
        # published high-water marks: the monotone counters advance by
        # the delta since the last publish (scrape-time collect)
        self._pub = {s: 0.0 for s in self.STATES}
        self._pub_usd = 0.0

    def _state(self) -> str:
        if self._draining:
            return "draining"
        if self._degraded:
            return "degraded"
        return "serving" if self._active > 0 else "idle"

    def _accrue(self) -> None:
        now = self._clock()
        dt = now - self._mark
        if dt > 0:
            self._cs[self._state()] += dt * self.chips
        self._mark = now

    # -- the service seams --------------------------------------------------

    def set_chips(self, n: int) -> None:
        with self._lock:
            self._accrue()
            self.chips = max(1, int(n))

    def note_active(self, entering: bool) -> None:
        """A matching handler entered (True) / left (False) the service;
        the 0<->1 edges flip serving/idle attribution."""
        with self._lock:
            self._accrue()
            self._active += 1 if entering else -1
            if self._active < 0:
                self._active = 0

    def set_degraded(self, flag: bool) -> None:
        with self._lock:
            self._accrue()
            self._degraded = bool(flag)

    def set_draining(self, flag: bool) -> None:
        with self._lock:
            self._accrue()
            self._draining = bool(flag)

    # -- reads --------------------------------------------------------------

    def chip_seconds(self) -> dict:
        with self._lock:
            self._accrue()
            out = dict(self._cs)
        out["total"] = sum(out.values())
        return out

    def snapshot(self, points: Optional[float] = None) -> dict:
        cs = self.chip_seconds()
        usd = cs["total"] / 3600.0 * self.price
        out = {
            "chips": self.chips,
            "price_per_chip_hour": self.price,
            "state": self._state(),
            "chip_seconds": {k: round(v, 3) for k, v in cs.items()},
            "usd": round(usd, 6),
        }
        if points is not None:
            out["points_total"] = int(points)
            out["usd_per_million_points"] = (
                round(usd / points * 1e6, 6) if points > 0 else None)
        return out

    def publish(self, points: Optional[float] = None) -> None:
        """Advance the monotone reporter_cost_* families to the ledger's
        current truth (delta-inc against high-water marks)."""
        with self._lock:
            self._accrue()
            cs = dict(self._cs)
            for s, v in cs.items():
                d = v - self._pub[s]
                if d > 0:
                    C_CHIP_SECONDS.labels(s).inc(d)
                    self._pub[s] = v
            usd = sum(cs.values()) / 3600.0 * self.price
            if usd > self._pub_usd:
                C_USD.inc(usd - self._pub_usd)
                self._pub_usd = usd
            G_PRICE.set(self.price)
            G_CHIPS.set(self.chips)
        if points is not None and points > 0:
            G_USD_PER_M.set(usd / points * 1e6)


class DemandHistory:
    """Append-only size-bounded JSONL ring on disk.

    Two epochs: the live file and one rotated predecessor.  When the
    live epoch passes half the byte budget it is atomically renamed
    (os.replace) to ``<path>.1`` and a fresh epoch starts, so total disk
    stays under ``max_bytes`` and rotation never loses the window a
    reader needs.  Appends flush to the OS on every record — a SIGKILL
    loses at most the record being written, and a crash-truncated final
    line is skipped (not fatal) on read.  Reopening the same path
    continues the ring (restart continuity)."""

    def __init__(self, path: str, max_bytes: Optional[int] = None,
                 wall: Callable[[], float] = time.time):
        self.path = path
        self.rotated = path + ".1"
        self.max_bytes = int(_resolve_num(
            "REPORTER_HISTORY_MAX_BYTES", max_bytes, 8 * 1024 * 1024))
        self._wall = wall
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # heal a torn tail before appending: a SIGKILL mid-append leaves
        # a partial line, and continuing on it would corrupt the NEXT
        # record too — terminate it so only the torn record is lost
        torn = False
        try:
            with open(path, "rb") as fh:
                fh.seek(-1, os.SEEK_END)
                torn = fh.read(1) != b"\n"
        except (OSError, ValueError):
            pass  # missing or empty file: nothing to heal
        self._f = open(path, "a", encoding="utf-8")
        if torn:
            self._f.write("\n")
            self._f.flush()
        self.ticks = 0

    def append(self, record: dict) -> None:
        rec = dict(record)
        rec.setdefault("t", round(self._wall(), 3))
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        with self._lock:
            if self._f.tell() + len(line) > self.max_bytes // 2:
                self._rotate_locked()
            self._f.write(line)
            self._f.flush()
            self.ticks += 1

    def _rotate_locked(self) -> None:
        self._f.close()
        os.replace(self.path, self.rotated)  # atomic: readers see old or new
        self._f = open(self.path, "a", encoding="utf-8")

    def size_bytes(self) -> int:
        total = 0
        for p in (self.rotated, self.path):
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
        return total

    def read(self, window_s: Optional[float] = None,
             now: Optional[float] = None) -> List[dict]:
        """Records oldest-first (rotated epoch then live), tolerant of a
        torn final line; ``window_s`` keeps only records newer than
        ``now - window_s``."""
        with self._lock:
            self._f.flush()
        out: List[dict] = []
        for p in (self.rotated, self.path):
            try:
                with open(p, encoding="utf-8") as f:
                    for line in f:
                        try:
                            rec = json.loads(line)
                        except (json.JSONDecodeError, ValueError):
                            continue  # torn tail from a SIGKILL mid-append
                        if isinstance(rec, dict):
                            out.append(rec)
            except OSError:
                continue
        if window_s is not None:
            cut = (self._wall() if now is None else now) - float(window_s)
            out = [r for r in out if float(r.get("t", 0.0)) >= cut]
        return out

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except Exception:  # noqa: BLE001 - teardown must not raise
                pass


class CapacityEstimator:
    """The measured serving ceiling and its headroom.

    Model ceiling = effective max_batch / device-step p95 over a sliding
    window (the batched-decoder throughput identity).  The model is
    re-anchored at SHED ONSET — the first tick where shedding begins is
    the one observation where the true ceiling equals the admitted rate,
    so anchor = admitted/model there (clamped: a wild step histogram
    must not swing the ceiling 10x).  Headroom = ceiling - demand;
    time-to-exhaustion extrapolates a least-squares demand slope."""

    ANCHOR_LO, ANCHOR_HI = 0.25, 4.0

    def __init__(self, window_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        # ring of (t, cumulative per-slot bucket counts) device-step
        # histogram samples; the windowed p95 is the delta across it
        self._hist: "collections.deque" = collections.deque()
        self._bounds: Tuple[float, ...] = ()
        self._demand: "collections.deque" = collections.deque()
        self.anchor = 1.0
        self._was_shedding = False
        self._last: dict = {
            "ceiling_traces_per_sec": None,
            "demand_traces_per_sec": None,
            "headroom_traces_per_sec": None,
            "exhaustion_s": None,
            "step_p95_s": None,
            "anchor": 1.0,
            "max_batch": None,
        }

    def observe_hist(self, bounds, counts, now: Optional[float] = None) -> None:
        """Feed one cumulative device-step histogram sample (the
        reporter_microbatch_device_step_seconds per-slot counts)."""
        now = self._clock() if now is None else now
        with self._lock:
            self._bounds = tuple(bounds)
            self._hist.append((now, tuple(counts)))
            cut = now - self.window_s
            while len(self._hist) > 2 and self._hist[1][0] <= cut:
                self._hist.popleft()

    def step_p95(self) -> Optional[float]:
        with self._lock:
            if len(self._hist) < 2 or not self._bounds:
                return None
            old, new = self._hist[0][1], self._hist[-1][1]
        delta = [max(0.0, b - a) for a, b in zip(old, new)]
        if sum(delta) <= 0:
            return None
        cum, pairs = 0.0, []
        for bound, d in zip(self._bounds, delta):
            cum += d
            pairs.append((bound, cum))
        pairs.append((float("inf"), cum + delta[-1]))
        return hist_quantile(pairs, 0.95)

    def update(self, max_batch: Optional[float],
               admitted_rate: float, shed_rate: float,
               now: Optional[float] = None) -> dict:
        """One tick: fold the demand sample in, re-anchor on a shed
        onset, and refresh the ceiling/headroom/exhaustion estimate."""
        now = self._clock() if now is None else now
        demand = max(0.0, float(admitted_rate)) + max(0.0, float(shed_rate))
        with self._lock:
            self._demand.append((now, demand))
            cut = now - self.window_s
            while len(self._demand) > 2 and self._demand[0][0] < cut:
                self._demand.popleft()
        p95 = self.step_p95()
        model = (float(max_batch) / p95
                 if p95 and p95 > 0 and max_batch else None)
        shedding = shed_rate > 0
        if (shedding and not self._was_shedding and model
                and admitted_rate > 0):
            # shed onset: the admitted rate IS the ceiling right now
            self.anchor = min(self.ANCHOR_HI,
                              max(self.ANCHOR_LO, admitted_rate / model))
        self._was_shedding = shedding
        ceiling = model * self.anchor if model else None
        headroom = ceiling - demand if ceiling is not None else None
        slope = self._demand_slope()
        exhaustion = None
        if headroom is not None:
            if headroom <= 0:
                exhaustion = 0.0
            elif slope is not None and slope > 1e-9:
                exhaustion = headroom / slope
        self._last = {
            "ceiling_traces_per_sec": ceiling,
            "demand_traces_per_sec": demand,
            "headroom_traces_per_sec": headroom,
            "exhaustion_s": exhaustion,
            "step_p95_s": p95,
            "anchor": self.anchor,
            "max_batch": max_batch,
        }
        return self._last

    def _demand_slope(self) -> Optional[float]:
        """Least-squares demand slope (traces/s per s) over the window."""
        with self._lock:
            pts = list(self._demand)
        if len(pts) < 3:
            return None
        t0 = pts[0][0]
        xs = [t - t0 for t, _ in pts]
        ys = [d for _, d in pts]
        n = float(len(pts))
        mx, my = sum(xs) / n, sum(ys) / n
        den = sum((x - mx) ** 2 for x in xs)
        if den <= 0:
            return None
        return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / den

    def snapshot(self) -> dict:
        out = dict(self._last)
        for k in ("ceiling_traces_per_sec", "demand_traces_per_sec",
                  "headroom_traces_per_sec", "exhaustion_s", "step_p95_s"):
            if out.get(k) is not None:
                out[k] = round(float(out[k]), 4)
        return out

    def publish(self) -> None:
        s = self._last
        if s["ceiling_traces_per_sec"] is not None:
            G_CEILING.set(s["ceiling_traces_per_sec"])
        if s["demand_traces_per_sec"] is not None:
            G_DEMAND.set(s["demand_traces_per_sec"])
        if s["headroom_traces_per_sec"] is not None:
            G_HEADROOM.set(s["headroom_traces_per_sec"])
        # -1 = "no exhaustion in sight", the federation staleness
        # sentinel convention (a gauge cannot be absent per-scrape)
        G_EXHAUST.set(-1.0 if s["exhaustion_s"] is None
                      else s["exhaustion_s"])


class EconomicsEngine:
    """Ledger + history + capacity behind one sampling tick.

    ``sampler`` (injected by the service) returns the per-tick signal
    dict; the engine differences the cumulative counters itself so the
    sampler stays a cheap read of live registry state:

        {"queue_depth": int, "admitted_total": float, "shed_total": float,
         "points_total": float, "device_step": (bounds, counts) | None,
         "max_batch": float | None, "burn": {objective: rate},
         "max_burn": float | None, "sessions": int | None}
    """

    def __init__(self, replica_id: str, chips: int = 1,
                 spec: Optional[dict] = None,
                 history_path: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time):
        spec = dict(spec or {})
        self.replica_id = replica_id
        self._clock = clock
        self._wall = wall
        self.ledger = CostLedger(chips=chips,
                                 price_per_chip_hour=resolve_price(spec),
                                 clock=clock)
        self.capacity = CapacityEstimator(
            window_s=_resolve_num("REPORTER_CAPACITY_WINDOW_S",
                                  spec.get("capacity_window_s"), 60.0),
            clock=clock)
        self.tick_s = _resolve_num("REPORTER_HISTORY_TICK_S",
                                   spec.get("tick_s"), 1.0)
        self.history: Optional[DemandHistory] = None
        if history_path:
            try:
                self.history = DemandHistory(
                    history_path, max_bytes=spec.get("history_max_bytes"),
                    wall=wall)
            except OSError:
                self.history = None  # an unwritable dir must not kill boot
        self._sampler: Optional[Callable[[], dict]] = None
        self._prev: Optional[dict] = None
        self._prev_t: Optional[float] = None
        self._points = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._collects: List[Callable[[], None]] = []

    # -- lifecycle ----------------------------------------------------------

    def start(self, sampler: Callable[[], dict],
              collect: Tuple[Callable[[], None], ...] = ()) -> None:
        """Arm the sensor plane: the tick thread plus the scrape-time
        collectors (so a /metrics pull between ticks still sees accrued
        chip-seconds — the ledger bills lazily on read).  Collectors
        register HERE, not at construction, so a service object that
        never serves (tests build hundreds) adds no per-scrape work;
        stop() removes them again."""
        self._sampler = sampler
        if self._collects:
            return  # already armed
        self._collects = [lambda: self.ledger.publish(self._points or None)]
        self._collects.extend(collect)
        for fn in self._collects:
            obs.REGISTRY.register_collect(fn)
        if self.tick_s <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="economics-tick")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        for fn in self._collects:
            obs.REGISTRY.unregister_collect(fn)
        self._collects = []
        if self.history is not None:
            self.history.close()

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - a sensor must never kill serving
                pass

    # -- one tick -----------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        if self._sampler is None:
            return None
        now = self._clock() if now is None else now
        s = self._sampler() or {}
        self._points = float(s.get("points_total") or 0.0)
        dt = (now - self._prev_t) if self._prev_t is not None else None
        admitted_rate = shed_rate = 0.0
        if dt and dt > 0 and self._prev is not None:
            admitted_rate = max(0.0, (float(s.get("admitted_total") or 0.0)
                                      - float(self._prev.get("admitted_total")
                                              or 0.0))) / dt
            shed_rate = max(0.0, (float(s.get("shed_total") or 0.0)
                                  - float(self._prev.get("shed_total")
                                          or 0.0))) / dt
        step = s.get("device_step")
        if step:
            self.capacity.observe_hist(step[0], step[1], now=now)
        cap = self.capacity.update(s.get("max_batch"), admitted_rate,
                                   shed_rate, now=now)
        self.ledger.publish(self._points or None)
        self.capacity.publish()
        chips = self.ledger.chips
        if s.get("sessions") is not None:
            tiers = s.get("session_tiers") or {"hot": 0, "cold": 0,
                                               "host": s["sessions"]}
            for tier in ("hot", "cold", "host"):
                G_SESS_PER_CHIP.labels(tier).set(
                    float(tiers.get(tier) or 0) / max(1, chips))
        offered = admitted_rate + shed_rate
        record = {
            "t": round(self._wall(), 3),
            "replica": self.replica_id,
            "queue_depth": s.get("queue_depth"),
            "admitted_rps": round(admitted_rate, 4),
            "shed_rps": round(shed_rate, 4),
            "shed_fraction": (round(shed_rate / offered, 4)
                              if offered > 0 else 0.0),
            "burn": s.get("burn"),
            "max_burn": s.get("max_burn"),
            "ceiling": cap["ceiling_traces_per_sec"],
            "demand": cap["demand_traces_per_sec"],
            "headroom": cap["headroom_traces_per_sec"],
            "exhaustion_s": cap["exhaustion_s"],
            "chip_seconds_total": round(
                self.ledger.chip_seconds()["total"], 3),
        }
        if self.history is not None:
            self.history.append(record)
            C_TICKS.inc()
            G_HIST_BYTES.set(self.history.size_bytes())
        self._prev = s
        self._prev_t = now
        return record

    # -- the HTTP surfaces --------------------------------------------------

    def cost_report(self) -> dict:
        out = {"replica": self.replica_id}
        out.update(self.ledger.snapshot(points=self._points))
        out["capacity"] = self.capacity.snapshot()
        out["history"] = (
            {"path": self.history.path,
             "bytes": self.history.size_bytes(),
             "ticks": self.history.ticks,
             "tick_s": self.tick_s}
            if self.history is not None else None)
        return out

    def history_report(self, window_s: Optional[float] = None) -> dict:
        if self.history is None:
            return {"replica": self.replica_id, "enabled": False,
                    "ticks": [],
                    "error": "history disabled (set REPORTER_HISTORY_DIR)"}
        ticks = self.history.read(window_s=window_s)
        return {"replica": self.replica_id, "enabled": True,
                "window_s": window_s, "n": len(ticks), "ticks": ticks}

    def summary(self) -> dict:
        """The /statusz economics line: cost + headroom at a glance."""
        led = self.ledger.snapshot(points=self._points)
        cap = self.capacity.snapshot()
        return {
            "chips": led["chips"],
            "price_per_chip_hour": led["price_per_chip_hour"],
            "chip_seconds_total": led["chip_seconds"]["total"],
            "usd": led["usd"],
            "usd_per_million_points": led.get("usd_per_million_points"),
            "ceiling_traces_per_sec": cap["ceiling_traces_per_sec"],
            "headroom_traces_per_sec": cap["headroom_traces_per_sec"],
            "exhaustion_s": cap["exhaustion_s"],
            "history": self.history is not None,
        }


def _cuda_devices(matcher) -> list:
    """The CUDA devices a device-backed matcher computes on (its mesh's dp
    ranks, or its one device); [] for the CPU baseline or a matcher on
    host cores."""
    if matcher is None or getattr(matcher, "backend", "cpu") == "cpu":
        return []
    mesh = getattr(matcher, "_mesh", None)
    devs = list(mesh.dp_devices) if mesh is not None else [
        getattr(matcher, "device", None)]
    out = []
    for d in devs:
        if getattr(d, "type", None) == "cuda" and d not in out:
            out.append(d)
    return out


def publish_memory(matcher=None, session_store=None) -> None:
    """Refresh reporter_device_memory_bytes: the card's memory as PyTorch's
    caching allocator sees it (in_use = ``torch.cuda.memory_allocated``,
    reserved = ``memory_reserved``, limit = the total of
    ``torch.cuda.mem_get_info``, summed over the matcher's cards; nothing
    when the matcher computes on host cores) plus exact-by-construction
    host bytes for the UBODT tiers and the session store."""
    devices = _cuda_devices(matcher)
    if devices:
        try:
            import torch

            in_use = reserved = limit = 0.0
            for d in devices:
                in_use += float(torch.cuda.memory_allocated(d))
                reserved += float(torch.cuda.memory_reserved(d))
                limit += float(torch.cuda.mem_get_info(d)[1])
            G_MEMORY.labels("device", "in_use").set(in_use)
            G_MEMORY.labels("device", "reserved").set(reserved)
            G_MEMORY.labels("device", "limit").set(limit)
        except Exception:  # noqa: BLE001 - a scrape must never fail
            pass
    tiering = getattr(matcher, "tiering", None) if matcher is not None else None
    if tiering is not None:
        try:
            ts = tiering.summary()
            # hot_bytes is the PER-CHIP budget; the device gauge aggregates
            # across the mesh like the summed bytes_in_use above
            G_MEMORY.labels("device", "ubodt_hot").set(
                float(ts.get("hot_bytes_total") or ts.get("hot_bytes") or 0.0))
            G_MEMORY.labels("host", "ubodt_cold").set(
                float(ts.get("table_bytes") or 0.0))
        except Exception:  # noqa: BLE001
            pass
    if session_store is not None:
        try:
            G_MEMORY.labels("host", "sessions").set(
                float(session_store.resident_bytes()))
        except Exception:  # noqa: BLE001
            pass
    arena = (getattr(matcher, "session_arena", None)
             if matcher is not None else None)
    if arena is not None:
        try:
            asum = arena.summary()
            G_MEMORY.labels("device", "session_arena_hot").set(
                float(asum.get("hot_bytes") or 0.0))
            G_MEMORY.labels("host", "session_arena_cold").set(
                float(asum.get("cold_bytes") or 0.0))
        except Exception:  # noqa: BLE001
            pass


def memory_summary(matcher=None, session_store=None) -> dict:
    """The memory plane as one flat dict ("space.subsystem" -> bytes):
    publish_memory refreshed, then the G_MEMORY family folded — the
    /statusz and bench-artifact rendering of
    reporter_device_memory_bytes."""
    publish_memory(matcher, session_store)
    out = {}
    for lv, child in G_MEMORY._items():
        out[".".join(lv)] = child.value
    if session_store is not None:
        out["sessions_resident"] = sum(
            child.value for _lv, child in G_SESS_PER_CHIP._items())
    return out


class FleetCostLedger:
    """Supervisor-side chip-second accounting that survives replica
    incarnations (the port's copy of the JAX package's class).

    A replica's in-process ledger dies with its process: a SIGKILLed,
    respawned replica restarts ``reporter_cost_chip_seconds_total`` from
    zero, so naively summing the last-observed per-replica totals loses
    every earlier incarnation's spend.  The supervisor fixes that with
    high-water accumulation — an observation that goes BACKWARD is a
    counter reset (a respawn), and the dead incarnation's final total is
    banked into a base before the new one starts counting.

    ``observe(rid, ...)`` on every federation tick; ``report(expected)``
    renders the ``<workdir>/cost_ledger.json`` payload, judging the
    accumulated ledger against the supervisor's own supervised-uptime ×
    chips expectation, which must hold across a SIGKILL + respawn.
    ``expected`` maps rid → supervised WALL seconds; chips scaling
    happens here.  Consistency
    allows ``tolerance`` relative error plus a flat per-incarnation
    boot-latency slack (the supervisor's clock starts at fork; the
    child's ledger starts after imports).
    """

    BOOT_SLACK_S = 5.0  # per incarnation per chip, fork-to-ledger latency

    def __init__(self, tolerance: float = 0.15):
        self.tolerance = _env_num("REPORTER_COST_LEDGER_TOL", tolerance)
        self._r: Dict[str, dict] = {}

    def observe(self, rid: str, chip_seconds, usd=None, points=None,
                chips=1) -> None:
        e = self._r.setdefault(rid, {
            "base_cs": 0.0, "last_cs": 0.0, "base_usd": 0.0,
            "last_usd": 0.0, "base_pts": 0.0, "last_pts": 0.0,
            "incarnations": 1, "chips": int(chips or 1)})
        cs = float(chip_seconds or 0.0)
        if cs + 1e-9 < e["last_cs"]:
            # the counter went backward: a respawn — bank the dead
            # incarnation before the watch restarts from zero
            e["base_cs"] += e["last_cs"]
            e["base_usd"] += e["last_usd"]
            e["base_pts"] += e["last_pts"]
            e["incarnations"] += 1
        e["last_cs"] = cs
        e["last_usd"] = float(usd or 0.0)
        e["last_pts"] = float(points or 0.0)
        e["chips"] = int(chips or e["chips"] or 1)

    def report(self, expected_uptime: Optional[dict] = None,
               price: Optional[float] = None) -> dict:
        expected_uptime = expected_uptime or {}
        per = {}
        tot_cs = tot_usd = tot_pts = tot_exp = 0.0
        incarnations = 0
        for rid in sorted(self._r):
            e = self._r[rid]
            cs = e["base_cs"] + e["last_cs"]
            usd = e["base_usd"] + e["last_usd"]
            pts = e["base_pts"] + e["last_pts"]
            up = expected_uptime.get(rid)
            exp = None if up is None else float(up) * e["chips"]
            per[rid] = {
                "chip_seconds": round(cs, 3),
                "usd": round(usd, 6),
                "points": int(pts),
                "incarnations": e["incarnations"],
                "chips": e["chips"],
                "expected_chip_seconds": (None if exp is None
                                          else round(exp, 3)),
            }
            tot_cs += cs
            tot_usd += usd
            tot_pts += pts
            tot_exp += exp or 0.0
            incarnations += e["incarnations"]
        err = abs(tot_cs - tot_exp)
        slack = self.tolerance * tot_exp + self.BOOT_SLACK_S * incarnations
        return {
            "replicas": per,
            "totals": {
                "chip_seconds": round(tot_cs, 3),
                "usd": round(tot_usd, 6),
                "points": int(tot_pts),
                "usd_per_million_points": (
                    round(tot_usd / tot_pts * 1e6, 6)
                    if tot_pts > 0 else None),
            },
            "price_per_chip_hour": price,
            "expected_chip_seconds": round(tot_exp, 3),
            "abs_err": round(err, 3),
            "rel_err": (round(err / tot_exp, 4) if tot_exp > 0 else 0.0),
            "tolerance": self.tolerance,
            "incarnations": incarnations,
            "consistent": bool(tot_exp <= 0.0 or err <= slack),
        }


def memory_summary(matcher=None, session_store=None) -> dict:
    """The memory plane as one flat dict ("space.subsystem" -> bytes):
    publish_memory refreshed, then the G_MEMORY family folded — the
    /statusz and bench-artifact rendering of
    reporter_device_memory_bytes."""
    publish_memory(matcher, session_store)
    out = {}
    for lv, child in G_MEMORY._items():
        out[".".join(lv)] = child.value
    if session_store is not None:
        out["sessions_resident"] = sum(
            child.value for _lv, child in G_SESS_PER_CHIP._items())
    return out


def read_ring(path: str, window_s: Optional[float] = None,
              now: Optional[float] = None) -> List[dict]:
    """Read a demand-history ring WITHOUT owning it: rotated epoch then
    live file, torn-tail tolerant — the tools/demand_export.py reader
    for a ring another process (or a dead one) wrote."""
    out: List[dict] = []
    for p in (path + ".1", path):
        try:
            with open(p, encoding="utf-8") as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except (json.JSONDecodeError, ValueError):
                        continue
                    if isinstance(rec, dict):
                        out.append(rec)
        except OSError:
            continue
    if window_s is not None:
        cut = (time.time() if now is None else now) - float(window_s)
        out = [r for r in out if float(r.get("t", 0.0)) >= cut]
    return out


def read_ring(path: str, window_s: Optional[float] = None,
              now: Optional[float] = None) -> List[dict]:
    """Read a demand-history ring WITHOUT owning it: rotated epoch then
    live file, torn-tail tolerant — the tools/demand_export.py reader
    for a ring another process (or a dead one) wrote."""
    out: List[dict] = []
    for p in (path + ".1", path):
        try:
            with open(p, encoding="utf-8") as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except (json.JSONDecodeError, ValueError):
                        continue
                    if isinstance(rec, dict):
                        out.append(rec)
        except OSError:
            continue
    if window_s is not None:
        cut = (time.time() if now is None else now) - float(window_s)
        out = [r for r in out if float(r.get("t", 0.0)) >= cut]
    return out
