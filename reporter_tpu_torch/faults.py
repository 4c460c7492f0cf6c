"""Env-selectable fault injection: the port's copy of the JAX package's
module of the same name (same points, same spec grammar, same behaviour).

Production failure classes -- a poisoned trace, a wedged device step, a
flaky probe program, a slow or flapping replica -- are rare enough that
the containment machinery around them rots unless it is exercised on
every change.  Each failure class has a named *injection point* that tests
and ``chip_smoke.py`` arm with ``REPORTER_FAULT_<POINT>`` environment
variables; with every variable unset a check is a single dict lookup and
the outputs are bit-identical to a build without this module.

Points and spec grammar (value of ``REPORTER_FAULT_<POINT>``):

  dispatch      "N" | "always" | "uuid:<substr>"
                raise InjectedFault at matcher.match_many_async entry --
                N times total, every time, or whenever the batch contains
                a uuid matching <substr> (the poison-trace fixture)
  device_hang   "<seconds>[:N]"
                sleep <seconds> inside the device-step finish() -- the
                wedged-device fixture the serve watchdog must catch
  ubodt_probe   "N" | "always"
                raise InjectedFault inside the per-chunk device dispatch
                (a UBODT probe program failure mid-batch)
  store_put     "5xx[:N]" | "timeout[:N]"
                fail a storage upload attempt with an HTTP 503 or a
                timeout (N attempts total; default every attempt)
  client_post   "reset[:N]"
                raise ConnectionResetError inside a stream client's POST
  router_connect
                "refused[:N]"
                raise ConnectionRefusedError inside a fleet router's
                replica dispatch
  replica_slow_accept
                "<seconds>[:N]"
                sleep <seconds> at the replica's HTTP routing entry of
                /report and /trace_attributes_batch
  health_flap   "N" | "always"
                make the replica's /health answer 503 "unhealthy" while
                armed
  replica_shed  "N" | "always"
                shed a /report at the replica's admission with 429
  clock_skew    "<factor>[:N]"   (decimal form, e.g. "4.0" -- a bare
                integer parses as the raise-N grammar)
                scale the MicroBatcher's deadline clock: during the
                batch-formation deadline scrub each queued entry's
                elapsed time is multiplied by <factor>, so deadlines
                expire early (factor > 1) or late (< 1)
  slow_drain    "<seconds>[:N]"
                stall the GET /sessions?export=1 beam-handoff export
                <seconds> before it snapshots
  quality_skew  "<metres>[:N]"
                perturb the device batch's projected coordinates (no
                seam in the port yet: the quality plane is not ported)

Counts are consumed per (point, spec) pair, so changing the spec re-arms
the point and clearing the variable disarms it; ``reset()`` re-arms
everything (test isolation).  Every fired fault adds one to its point's
count, ``injected(point)``, which ``reset()`` leaves alone: a run's
injections stay visible beside their effects.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from .obs import metrics as obs
from .obs.economics import counter_total

POINTS = ("dispatch", "device_hang", "ubodt_probe", "store_put",
          "client_post", "router_connect", "replica_slow_accept",
          "health_flap", "replica_shed", "quality_skew", "clock_skew",
          "slow_drain")

_lock = threading.Lock()
_consumed: dict = {}  # (point, raw_spec) -> times fired

# faults fired by point in this process; ``injected`` reads it
C_INJECTED = obs.counter(
    "reporter_faults_injected_total",
    "Faults fired by injection point (REPORTER_FAULT_* env knobs; "
    "docs/robustness.md)",
    ("point",))


class InjectedFault(RuntimeError):
    """An error raised by an armed injection point (never in production:
    all REPORTER_FAULT_* unset means no code path can construct one)."""

    def __init__(self, point: str, detail: str = ""):
        super().__init__(
            "injected fault at %s%s" % (point, ": " + detail if detail else ""))
        self.point = point


def spec(point: str) -> str:
    """The raw env spec for a point ('' when unset/disarmed)."""
    raw = os.environ.get("REPORTER_FAULT_" + point.upper(), "").strip()
    if raw.lower() in ("0", "off", "false", "no"):
        return ""
    return raw


def reset() -> None:
    """Re-arm every count-limited spec (test isolation between cases)."""
    with _lock:
        _consumed.clear()


def injected(point: str) -> int:
    """Faults fired at ``point`` in this process."""
    return int(counter_total(C_INJECTED, {"point": point}))


def fire(point: str, key: Optional[str] = None) -> Optional[str]:
    """Consume one firing of ``point`` if its spec arms it for ``key``.

    Returns the mode token ("raise", "5xx", "timeout", "reset", or the
    hang-seconds string) when the fault fires, else None.  ``key`` is the
    subject identity the uuid: form matches against (e.g. the batch's
    joined uuids)."""
    raw = spec(point)
    if not raw:
        return None
    parts = raw.split(":")
    head = parts[0].strip().lower()
    count: float
    if head == "uuid":
        sub = parts[1] if len(parts) > 1 else ""
        if not sub or not key or sub not in key:
            return None
        mode, count = "raise", float("inf")
    elif head == "always":
        mode, count = "raise", float("inf")
    elif head.isdigit():
        mode, count = "raise", int(head)
    elif head in ("5xx", "timeout", "reset", "refused"):
        mode = head
        count = (int(parts[1]) if len(parts) > 1 and parts[1].isdigit()
                 else float("inf"))
    else:
        try:
            float(head)  # device_hang: "<seconds>[:N]"
        except ValueError:
            return None  # unparseable spec: disarmed, never half-armed
        mode = head
        count = (int(parts[1]) if len(parts) > 1 and parts[1].isdigit()
                 else float("inf"))
    k = (point, raw)
    with _lock:
        fired = _consumed.get(k, 0)
        if fired >= count:
            return None
        _consumed[k] = fired + 1
    C_INJECTED.labels(point).inc()
    return mode


def maybe_raise(point: str, key: Optional[str] = None) -> None:
    """Raise InjectedFault when the point fires (the raise-mode points)."""
    if fire(point, key) is not None:
        raise InjectedFault(point, key or "")


def scale(point: str, default: float = 1.0) -> float:
    """The spec'd multiplier when a scale-mode point (clock_skew) fires,
    else ``default`` (disarmed = identity)."""
    tok = fire(point)
    if tok is None:
        return default
    try:
        return float(tok)
    except ValueError:
        return default


def hang(point: str = "device_hang") -> float:
    """Sleep for the spec'd seconds when the hang point fires.  Returns the
    seconds slept (0.0 when disarmed)."""
    tok = fire(point)
    if tok is None:
        return 0.0
    try:
        seconds = float(tok)
    except ValueError:
        seconds = 1.0
    time.sleep(seconds)
    return seconds
