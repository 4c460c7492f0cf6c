"""Fleet autoscaler + crash-loop backoff: the control side of the
self-driving fleet (the port's copy of the JAX package's module of the
same name: same decisions, families and log events).

The sensors (burn rates, federation, queue-depth gauges) and the
actuators (shedding, drain, respawn, warmup hold-out) live elsewhere;
this module is the wire between them, run inside the fleet supervisor
(reporter_tpu_torch/tools/fleet.py) against the router's federated
surfaces:

  Autoscaler  a poll loop over two AND-gated conditions:

                * the FLEET is burning — some availability/latency
                  objective of the router's client-truth SLO engine has
                  its multi-window AND-gated alert up (obs/slo.py
                  ``pair_alerting``: a burst alone cannot page), and
                * the queues are SUSTAINED deep — the summed replica
                  queue depth exceeds the threshold persistently, judged
                  by the very same obs/slo.py machinery (a dedicated
                  SLOEngine whose "bad" outcome is "queue over
                  threshold", with its own fast/slow AND-gated pair).

              Scale-UP only when both hold (latency pain without queue
              pressure means the traffic mix changed, not the volume;
              queue pressure without burn means the batcher is
              absorbing it — neither justifies a replica).  Scale-DOWN
              only after a sustained calm window, strictly via SIGTERM
              drain + beam handoff.  Min/max bounds and a cooldown
              after every action keep the loop from flapping; every
              decision is a structured event and a
              ``reporter_fleet_scale_events_total`` increment at the
              router's admin surface.

  RespawnBackoff  exponential backoff + full jitter for the
              supervisor's respawn loop: a replica dying at boot
              would respawn hot in a tight loop; each consecutive
              quick death doubles the pause (observable as
              ``reporter_fleet_respawn_backoff_seconds``), and a replica
              that stays up resets its streak.

Both pieces are decision engines with injected signal/action callables
and an injectable clock — the unit suite drives them deterministically,
the supervisor wires them to HTTP and processes.
"""

from __future__ import annotations

import logging
import random
import threading
import time as _time
from typing import Callable, Dict, Optional, Tuple

from ..obs import log as obs_log
from ..obs import metrics as obs
from ..obs import slo as obs_slo

log = logging.getLogger(__name__)

G_RESPAWN_BACKOFF = obs.gauge(
    "reporter_fleet_respawn_backoff_seconds",
    "Current crash-loop respawn backoff per supervised child (0 = the "
    "next death respawns immediately; doubles per consecutive quick "
    "death up to the cap, full-jittered, reset after a healthy "
    "lifetime — docs/serving-fleet.md \"Self-driving fleet\")",
    ("child",))
G_AUTOSCALE_REPLICAS = obs.gauge(
    "reporter_fleet_autoscale_replicas",
    "Replica count the supervisor's autoscaler currently maintains "
    "(between its --min-replicas/--max-replicas bounds); exported by "
    "the supervisor process and mirrored into <workdir>/fleet.json")


class Autoscaler:
    """Grow/shrink decisions from the router's federated signals.

    ``signals()`` returns one poll's view (or None when the router is
    unreachable — no decision is ever made blind)::

        {"replicas": int,          # current fleet size
         "queue_depth": float,     # summed replica submit-queue depth
         "burn_alerting": bool,    # any fleet availability/latency
                                   # objective's AND-gated alert is up
         "max_burn": float}        # max burn rate across objectives and
                                   # windows (the calm detector)

    ``scale_up(reason)`` / ``scale_down(reason)`` perform the actuation
    and return True on success; the autoscaler owns only WHEN."""

    def __init__(self, signals: Callable[[], Optional[dict]],
                 scale_up: Callable[[str], bool],
                 scale_down: Callable[[str], bool],
                 min_replicas: int = 1, max_replicas: int = 8,
                 poll_s: float = 1.0, cooldown_s: float = 20.0,
                 queue_high: float = 8.0, window_s: float = 30.0,
                 down_after_s: Optional[float] = None,
                 down_burn: float = 0.1,
                 clock=_time.monotonic):
        self.signals = signals
        self.scale_up = scale_up
        self.scale_down = scale_down
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.poll_s = max(0.05, float(poll_s))
        self.cooldown_s = float(cooldown_s)
        self.queue_high = float(queue_high)
        self.window_s = max(2.0, float(window_s))
        self.down_after_s = (2.0 * self.window_s if down_after_s is None
                             else float(down_after_s))
        self.down_burn = float(down_burn)
        self._clock = clock
        # the sustained-queue gate: the SAME sliding-window burn-rate
        # and multi-window AND-gating machinery the SLO engine pages
        # with (obs/slo.py), applied to "queue depth over threshold" as
        # the bad outcome.  availability target 0.5 => burn > 1.0 on a
        # window means the queue sat deep for >50% of it; the pair
        # requires that on BOTH the fast and the slow window, so a
        # burst alone can't trigger a replica spawn.
        self._gate_obj = obs_slo.Objective(
            "queue_pressure", "availability", 0.5)
        self._gate = obs_slo.SLOEngine(
            [self._gate_obj], window_s=self.window_s,
            burn_pairs=((max(1.0, self.window_s / 6.0),
                         self.window_s, 1.0),),
            instrument=False, clock=clock)
        now = clock()
        self._t_last_scale = now
        self._t_last_hot = now   # calm timer: no scale-down off the boot
        self.last_decision: Optional[dict] = None

    # -- the decision core (deterministic; unit-tested directly) ------------

    def effective_queue_high(self, sig: dict) -> float:
        """The queue-depth threshold, scaled by the fleet's mean chips
        per replica (each replica's advertised /health "capacity"
        devices, summed by the supervisor): a mesh-inside-replica admits
        n_chips x the per-chip batch budget, so the fleet legitimately
        absorbs proportionally deeper queues before a new replica is
        justified (docs/performance.md "One logical matcher per pod").
        Absent capacity signals (legacy supervisors) this is exactly
        ``queue_high``."""
        n = float(sig.get("replicas") or 0.0)
        chips = float(sig.get("devices") or 0.0)
        if n > 0 and chips > n:
            return self.queue_high * chips / n
        return self.queue_high

    def observe(self, sig: dict, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        depth = float(sig.get("queue_depth") or 0.0)
        high = self.effective_queue_high(sig)
        self._gate.observe("queue", 503 if depth > high else 200,
                           None, now=now)

    def gate_alerting(self, now: Optional[float] = None
                      ) -> Tuple[bool, Dict[str, float]]:
        return self._gate.pair_alerting(self._gate_obj, now)

    def decide(self, sig: dict,
               now: Optional[float] = None) -> Optional[Tuple[str, str]]:
        now = self._clock() if now is None else now
        n = int(sig.get("replicas") or 0)
        burn_alert = bool(sig.get("burn_alerting"))
        gate_alert, gate_burns = self.gate_alerting(now)
        if burn_alert or gate_alert \
                or float(sig.get("max_burn") or 0.0) > self.down_burn:
            self._t_last_hot = now
        if now - self._t_last_scale < self.cooldown_s:
            return None
        if burn_alert and gate_alert:
            if n >= self.max_replicas:
                obs_log.event(log, "autoscale_at_max",
                              level=logging.WARNING, replicas=n,
                              gate_burns=gate_burns)
                return None
            return ("up", "burn_and_queue")
        if n > self.min_replicas \
                and now - self._t_last_hot >= self.down_after_s:
            return ("down", "idle")
        return None

    def tick(self, now: Optional[float] = None) -> Optional[Tuple[str, str]]:
        sig = self.signals()
        if not sig:
            return None
        now = self._clock() if now is None else now
        self.observe(sig, now)
        decision = self.decide(sig, now)
        if decision is None:
            return None
        direction, reason = decision
        obs_log.event(log, "autoscale_decision", level=logging.WARNING,
                      direction=direction, reason=reason,
                      replicas=sig.get("replicas"),
                      queue_depth=sig.get("queue_depth"),
                      max_burn=sig.get("max_burn"))
        ok = (self.scale_up if direction == "up" else self.scale_down)(reason)
        if ok:
            # cooldown from COMPLETION (a drain can take many seconds):
            # the next decision sees the resized fleet's behaviour, not
            # the transition's
            self._t_last_scale = self._clock()
            self._t_last_hot = self._clock()
            self.last_decision = {"direction": direction, "reason": reason,
                                  "t_unix": round(_time.time(), 3)}
        return decision if ok else None

    # -- the supervisor's loop ----------------------------------------------

    def run(self, stop: threading.Event) -> None:
        while not stop.wait(self.poll_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the loop must survive polls
                log.exception("autoscaler tick failed")

    def state(self) -> dict:
        alert, burns = self.gate_alerting()
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "cooldown_s": self.cooldown_s,
            "queue_high": self.queue_high,
            "window_s": self.window_s,
            "down_after_s": self.down_after_s,
            "queue_gate": {"alerting": alert, "burn": burns},
            "last_decision": self.last_decision,
        }


class RespawnBackoff:
    """Exponential backoff + full jitter for crash-loop respawns.

    ``next_delay(child, uptime_s)`` is called when a child died
    unexpectedly: a child that lived past ``healthy_reset_s`` starts a
    fresh streak (first respawn immediate — the fast recovery of a
    one-off death is kept), while consecutive quick deaths double the
    pause up to ``max_s``, full-jittered so a herd of crash-looping
    replicas does not respawn in phase."""

    def __init__(self, base_s: float = 0.5, max_s: float = 30.0,
                 healthy_reset_s: float = 30.0,
                 rng: Optional[random.Random] = None):
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.healthy_reset_s = float(healthy_reset_s)
        self._rng = rng or random.Random()
        self._streak: Dict[str, int] = {}

    def streak(self, child: str) -> int:
        return self._streak.get(child, 0)

    def next_delay(self, child: str, uptime_s: float) -> float:
        if uptime_s >= self.healthy_reset_s:
            self._streak[child] = 0
        n = self._streak.get(child, 0)
        self._streak[child] = n + 1
        if n == 0:
            delay = 0.0
        else:
            delay = min(self.max_s, self.base_s * (2.0 ** (n - 1)))
            delay *= 1.0 + self._rng.uniform(0.0, 1.0)  # full jitter
            delay = min(delay, 2.0 * self.max_s)
        G_RESPAWN_BACKOFF.labels(child).set(round(delay, 3))
        if n >= 2:
            obs_log.event(log, "crash_loop", level=logging.ERROR,
                          child=child, consecutive_deaths=n + 1,
                          backoff_s=round(delay, 3))
        return delay

    def note_healthy(self, child: str) -> None:
        self._streak[child] = 0
        G_RESPAWN_BACKOFF.labels(child).set(0.0)
