"""Adaptive tail control: live windowed quantiles driving the serving
knobs that used to be frozen at boot (docs/serving-fleet.md
"Self-driving fleet").

Every surface shares ONE quantile implementation (obs/quantile.py); the
thresholds the batchers steer by would otherwise be static knobs tuned
for whichever traffic shape the operator last measured.  This module
closes that gap with two small, composable pieces:

  WindowedQuantile   a thread-safe sliding-window histogram on the shared
                     ``SLO_BUCKETS_S`` axis (same per-second epoch rings
                     as obs/slo.py, same interpolation rule), cheap
                     enough to feed from a hot loop: the live p95/p99 a
                     controller steers by.

  Controller         a clamped, hysteresis-damped scalar: ``propose()``
                     moves the effective value toward a target only when
                     the target sits outside the deadband, by at most
                     ``max_step`` per adjustment, at most once per
                     ``cooldown_s`` — so a noisy quantile cannot flap the
                     knob.  Every effective value is a gauge
                     (``reporter_adaptive_control``) and every accepted
                     move a counter, so the control loop's behaviour is
                     as observable as the traffic it reacts to.

The whole plane is gated by ``REPORTER_ADAPTIVE`` (default on): with
``REPORTER_ADAPTIVE=0`` every consumer (the MicroBatchers' fill window
and batch width) holds its static configured value and no controller
state is even allocated — the static knobs reproduce the fixed
behaviour bit-for-bit.
"""

from __future__ import annotations

import os
import threading
import time as _time
from typing import Dict, Optional

from . import metrics as obs
from .quantile import SLO_BUCKETS_S, bucket_index, cumulate, hist_quantile

G_CONTROL = obs.gauge(
    "reporter_adaptive_control",
    "Effective value of each adaptive serving control in seconds "
    "(hedge_s = the router's live hedge threshold, batch_wait_s / "
    "session_wait_s = each MicroBatcher's fill window); equals the "
    "static knob while REPORTER_ADAPTIVE=0 or before enough samples "
    "accumulate (docs/serving-fleet.md \"Self-driving fleet\")",
    ("control",))
C_ADJUST = obs.counter(
    "reporter_adaptive_adjustments_total",
    "Accepted adaptive-control moves by control and direction (grow / "
    "shrink); a move is accepted only outside the deadband, clamped, "
    "and rate-limited by the controller's cooldown",
    ("control", "direction"))


def enabled() -> bool:
    """The master switch: REPORTER_ADAPTIVE=0 freezes every adaptive
    control at its static configured value (the strictly-additive
    contract — rehearsals that predate the control loop must reproduce
    bit-for-bit)."""
    return os.environ.get("REPORTER_ADAPTIVE", "1").strip().lower() \
        not in ("0", "off", "false", "no")


class WindowedQuantile:
    """Sliding-window latency quantiles on the shared SLO bucket axis.

    Per-second epoch buckets in a bounded dict (the obs/slo.py shape,
    without routes/classes): ``observe`` is a bisect + increment under a
    lock, ``quantile`` aggregates the trailing window through the shared
    ``hist_quantile`` math.  ``clock`` is injectable for deterministic
    tests."""

    def __init__(self, window_s: float = 60.0, epoch_s: float = 1.0,
                 clock=_time.monotonic):
        self.window_s = float(window_s)
        self.epoch_s = max(0.05, float(epoch_s))
        self._clock = clock
        self._lock = threading.Lock()
        self._epochs: Dict[int, list] = {}

    def observe(self, v: float, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        key = int(now / self.epoch_s)
        idx = bucket_index(SLO_BUCKETS_S, v)
        with self._lock:
            h = self._epochs.get(key)
            if h is None:
                h = self._epochs[key] = [0] * (len(SLO_BUCKETS_S) + 1)
                horizon = key - int(self.window_s / self.epoch_s) - 1
                for k in [k for k in self._epochs if k < horizon]:
                    del self._epochs[k]
            h[idx] += 1

    def _window_counts(self, now: Optional[float] = None) -> list:
        now = self._clock() if now is None else now
        lo = int((now - self.window_s) / self.epoch_s)
        hi = int(now / self.epoch_s)
        out = [0] * (len(SLO_BUCKETS_S) + 1)
        with self._lock:
            for k, h in self._epochs.items():
                if lo < k <= hi:
                    for i, c in enumerate(h):
                        out[i] += c
        return out

    def count(self, now: Optional[float] = None) -> int:
        return sum(self._window_counts(now))

    def quantile(self, q: float,
                 now: Optional[float] = None) -> Optional[float]:
        counts = self._window_counts(now)
        if not sum(counts):
            return None
        return hist_quantile(cumulate(SLO_BUCKETS_S, counts), q)


class Controller:
    """One clamped, hysteresis-damped adaptive scalar.

    ``propose(target)`` returns the (possibly unchanged) effective
    value:

      * targets inside the deadband (±``deadband`` fraction of the
        current value) are ignored — quantile noise must not jiggle the
        knob;
      * an accepted move is limited to ``max_step`` fraction per call
        and to one move per ``cooldown_s`` — the knob glides, never
        jumps;
      * the result is always clamped to [lo, hi] — an adaptive control
        can drift from its static value, never escape its envelope.

    ``revert()`` snaps back to the static value (the consumer calls it
    when its signal goes stale)."""

    def __init__(self, name: str, static: float, lo: float, hi: float,
                 deadband: float = 0.10, max_step: float = 0.30,
                 cooldown_s: float = 1.0, clock=_time.monotonic):
        self.name = name
        self.static = float(static)
        self.lo = float(lo)
        self.hi = float(hi)
        self.deadband = float(deadband)
        self.max_step = float(max_step)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self.value = min(max(self.static, self.lo), self.hi)
        self._t_last = -float("inf")
        G_CONTROL.labels(name).set(self.value)

    def propose(self, target: Optional[float],
                now: Optional[float] = None) -> float:
        if target is None:
            return self.value
        now = self._clock() if now is None else now
        with self._lock:
            if now - self._t_last < self.cooldown_s:
                return self.value
            target = min(max(float(target), self.lo), self.hi)
            cur = self.value
            if cur > 0 and abs(target - cur) <= self.deadband * cur:
                return cur
            step = self.max_step * max(cur, 1e-9)
            nxt = min(max(target, cur - step), cur + step)
            if nxt == cur:
                return cur
            self.value = nxt
            self._t_last = now
        C_ADJUST.labels(self.name, "grow" if nxt > cur else "shrink").inc()
        G_CONTROL.labels(self.name).set(nxt)
        return nxt

    def revert(self) -> float:
        with self._lock:
            self.value = min(max(self.static, self.lo), self.hi)
            G_CONTROL.labels(self.name).set(self.value)
            return self.value
