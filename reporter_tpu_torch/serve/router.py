"""Fleet router: the session-affine HTTP front over N serve replicas (the
port's copy of the JAX package's module of the same name: same ranking,
policies, families, labels, log events and environment variables).

One serving process with one MicroBatcher is one fault domain: a single
wedge or restart takes the whole ingest path down.  This router makes
the replicas cattle (the TF-Serving posture, arXiv:1605.08695): the front
tier owns routing, health, and failover; a replica owns nothing but its
card.  Topology, knobs, and runbook: docs/serving-fleet.md.

  Affinity    /report requests are routed by RENDEZVOUS HASH (highest
              random weight) on the vehicle uuid: every vehicle has a
              stable ranked order of replicas, traffic goes to the
              highest-ranked AVAILABLE one, and when a replica dies only
              ITS vehicles remap (everyone else's ranking is untouched —
              the property that makes carried per-vehicle beam state
              worth pinning).  /trace_attributes_batch
              routes by its first trace's uuid (bulk clients pre-group).

  Health      an active prober GETs every replica's /health on an interval:
              200 -> healthy, 503 {"status": "draining"} -> rotate
              traffic off (deliberate exit, no ejection), anything else
              counts an unhealthy streak (debounced: one flapped probe
              never drops a replica).  Passively, consecutive transport
              errors on live traffic eject a replica outlier-style
              before the next probe even runs.

  Failover    a failed dispatch re-runs against the next-ranked replica
              under the SHARED retry budget (utils/retry.py): replica
              429/503 rotate onward immediately (the Retry-After hint is
              for THAT replica, not the fleet), transport errors back
              off with jitter, and non-retryable 4xx plus poison 500s
              return to the client verbatim — the request reached a
              replica and failed deterministically; re-dispatching it
              would just poison the next replica.

  Hedging     optionally (REPORTER_HEDGE_MS) a /report that has not
              answered within the hedge delay is raced against the
              second-ranked replica; first success wins, the straggler
              is abandoned.  Safe because /report is idempotent pure
              matching.

  Shedding    the router bounds its own inflight (REPORTER_ROUTER_MAX_
              INFLIGHT); past it, requests shed 429 with Retry-After
              rather than queueing unboundedly, and a fleet-wide 429
              (every replica shedding) propagates as a router 429 —
              backpressure reaches the client, queues stay bounded.

  One pane    the router is ALSO the fleet's observability plane
              (docs/observability.md "Fleet observability"): GET
              /metrics serves every replica's snapshot federated under a
              ``replica`` label (obs/federation.py; a dead replica's
              last snapshot stays, labeled stale), /statusz compares the
              replicas side by side, /debug/slo is the CLIENT-TRUTH
              fleet SLO (a failed-over success is fleet-good; the
              masking-debt gauge bills what failover hid), /debug/traces
              records the router's own hop spans — admission, ranking,
              every dispatch attempt, hedge legs with the loser marked
              cancelled — and ?id= splices the serving replica's span
              tree under them, and /debug/attrib + /debug/profile proxy
              to one replica via ``?replica=<id>``.

Run standalone:  python -m reporter_tpu_torch.serve.router \
                     --port 8002 --replicas http://h1:8010,http://h2:8010
or supervised with the replicas by ``python -m reporter_tpu_torch.tools.fleet``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import math
import os
import random
import re
import threading
import time as _time
import urllib.error
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlencode, urlsplit

from .. import faults
from ..obs import adaptive as obs_adaptive
from ..obs import federation as obs_fed
from ..obs import flight as obs_flight
from ..obs import log as obs_log
from ..obs import metrics as obs
from ..obs import slo as obs_slo
from ..obs import trace as obs_trace
from ..obs.quantile import SLO_BUCKETS_S
from ..obs.trace import Span
from ..utils import retry
from ..utils.httppool import HttpPool, raise_for_status
from . import wire
from .service import _resolve_num

log = logging.getLogger(__name__)

ACTIONS = {"report", "trace_attributes_batch", "health", "metrics", "fleet",
           "statusz", "traces", "slo", "attrib", "profile", "sessions",
           "cost"}

# the router pins re-dispatched / hedged replica legs with this header so
# the replica-side flight recorder retains its half of the trace for
# cross-hop stitching (serve/service.py reads it; docs/http-api.md)
KEEP_HEADER = "X-Reporter-Flight-Keep"

C_REQS = obs.counter(
    "reporter_router_requests_total",
    "Router requests by endpoint and outcome (ok / failover_ok / shed / "
    "no_replica / saturated / unreachable / invalid / passthrough)",
    ("endpoint", "outcome"))
H_LAT = obs.histogram(
    "reporter_router_request_seconds",
    "Router end-to-end latency per endpoint (failover + hedging included)",
    ("endpoint",), buckets=SLO_BUCKETS_S)
C_BACKEND = obs.counter(
    "reporter_router_replica_requests_total",
    "Replica-leg outcomes by replica and status (HTTP code or 'error' "
    "for a transport failure)",
    ("replica", "status"))
C_FAILOVER = obs.counter(
    "reporter_router_failovers_total",
    "Re-dispatches to the next rendezvous-ranked replica, by cause "
    "(network / 5xx / 429)",
    ("cause",))
C_HEDGES = obs.counter(
    "reporter_router_hedges_total",
    "Hedge requests fired after the primary exceeded REPORTER_HEDGE_MS")
C_HEDGE_WINS = obs.counter(
    "reporter_router_hedge_wins_total",
    "Hedge requests whose response beat the straggling primary")
G_REPLICAS = obs.gauge(
    "reporter_router_replicas",
    "Fleet composition by probe-derived state (healthy / draining / "
    "unhealthy / init)",
    ("state",))
C_PROBE_FAIL = obs.counter(
    "reporter_router_probe_failures_total",
    "Active /health probe failures per replica (a streak past the "
    "debounce threshold marks the replica unhealthy)",
    ("replica",))
C_EJECT = obs.counter(
    "reporter_router_ejections_total",
    "Replica ejections by replica and cause (passive = consecutive "
    "transport errors on live traffic, probe = unhealthy streak)",
    ("replica", "cause"))
G_INFLIGHT = obs.gauge(
    "reporter_router_inflight",
    "Requests currently inside the router's bounded proxy section")
C_SHED = obs.counter(
    "reporter_router_shed_total",
    "Requests shed 429 at the router because the fleet-wide inflight "
    "bound was reached")
C_REMAP = obs.counter(
    "reporter_router_affinity_remaps_total",
    "Requests routed off their rendezvous-primary replica because it "
    "was unavailable (the affinity disruption a replica loss causes)")
C_HANDOFF = obs.counter(
    "reporter_router_session_handoffs_total",
    "Per-vehicle session beam handoffs driven by the router (drain "
    "export -> inheriting-replica import, plus recovery rebalance and "
    "the supervisor's checkpoint re-home after a SIGKILL), by outcome "
    "(moved / skipped / rebalanced / rehomed / no_target / "
    "export_failed / import_failed; docs/serving-fleet.md \"Beam "
    "handoff\")",
    ("outcome",))
C_GEO = obs.counter(
    "reporter_router_geo_requests_total",
    "Requests ranked with the flag-gated geo-aware term "
    "(REPORTER_ROUTER_GEO), by outcome: steered = the geo term changed "
    "the primary replica vs the plain rendezvous hash, aligned = it "
    "agreed (docs/serving-fleet.md \"Sharded tables\")",
    ("outcome",))
C_SCALE = obs.counter(
    "reporter_fleet_scale_events_total",
    "Fleet scale events accepted at the router's admin surface (POST "
    "/fleet {\"add\"|\"remove\"}), by direction (up / down) and the "
    "caller's reason tag (the autoscaler sends burn_and_queue / idle; "
    "manual is the default — docs/serving-fleet.md \"Self-driving "
    "fleet\")",
    ("direction", "reason"))


def rendezvous_score(uuid: str, replica_url: str) -> int:
    """Highest-random-weight hash: each (vehicle, replica) pair gets an
    independent stable score, so removing a replica never reorders the
    scores of the surviving ones — a dead replica remaps ONLY its own
    vehicles."""
    h = hashlib.blake2b(("%s|%s" % (uuid, replica_url)).encode("utf-8"),
                        digest_size=8)
    return int.from_bytes(h.digest(), "big")


def geo_cell(lat: float, lon: float, cell_deg: float) -> int:
    """Stable id of the ``cell_deg``-degree geographic cell containing a
    point — the locality key of the optional geo-aware ranking term
    (docs/serving-fleet.md "Sharded tables").  Hashed so consecutive
    cells spread across shard indices instead of striping."""
    cell_deg = max(1e-6, float(cell_deg))
    key = "%d|%d" % (int(lat // cell_deg), int(lon // cell_deg))
    h = hashlib.blake2b(key.encode("utf-8"), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class Replica:
    """One backend serve process, as the router sees it."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.id: Optional[str] = None       # learned from X-Reporter-Replica
        # UBODT shard assignment "i/N" learned from the /health payload
        # (docs/serving-fleet.md "Sharded tables"); None = unsharded
        self.shard: Optional[str] = None
        # mesh/admission capacity advertised by /health ("capacity" block,
        # docs/http-api.md): device count, dp x gp mesh shape, scaled
        # byte/batch budgets.  Drives the weighted rendezvous ranking —
        # a replica spanning more chips inherits proportionally more
        # vehicles, with zero client-visible change.
        self.capacity: Optional[dict] = None
        self.state = "init"                  # init|healthy|draining|unhealthy
        self.probe_fail_streak = 0
        self.probe_ok_streak = 0
        self.fail_streak = 0                 # passive transport-error streak
        self.ejected_until = 0.0             # monotonic; passive ejection
        self.last_probe: Optional[dict] = None
        # beam-handoff bookkeeping: one export/import sweep per drain
        # transition, one rebalance per recovery (reset on the opposite
        # transition so a replica that drains repeatedly hands off each
        # time).  was_lost survives the warming hold-out (which resets
        # state to init), so a respawned replica still counts as a
        # RECOVERY — the rebalance must fire for it.
        self.handoff_started = False
        self.was_lost = False
        # per-replica probe schedule (jittered so N replicas are never
        # probed in lockstep; a draining replica's Retry-After pushes it
        # back explicitly).  0.0 = due immediately.
        self.next_probe_at = 0.0

    @property
    def label(self) -> str:
        return self.id or self.url

    def available(self, now: Optional[float] = None) -> bool:
        if now is None:
            now = _time.monotonic()
        return self.state == "healthy" and now >= self.ejected_until

    def snapshot(self) -> dict:
        now = _time.monotonic()
        return {
            "url": self.url, "id": self.id, "state": self.state,
            "shard": self.shard,
            "devices": ((self.capacity or {}).get("devices")
                        if isinstance(self.capacity, dict) else None),
            "available": self.available(now),
            "fail_streak": self.fail_streak,
            "probe_fail_streak": self.probe_fail_streak,
            "ejected_for_s": round(max(0.0, self.ejected_until - now), 2),
            "last_probe": self.last_probe,
        }


class FleetRouter:
    """Owns the replica set, the prober, and the dispatch policy."""

    def __init__(self, replica_urls: List[str],
                 probe_interval_s: Optional[float] = None,
                 probe_timeout_s: Optional[float] = None,
                 unhealthy_after: Optional[int] = None,
                 healthy_after: Optional[int] = None,
                 eject_streak: Optional[int] = None,
                 eject_s: Optional[float] = None,
                 hedge_ms: Optional[float] = None,
                 max_inflight: Optional[int] = None,
                 budget_s: Optional[float] = None,
                 request_timeout_s: Optional[float] = None,
                 pool: Optional[HttpPool] = None):
        if not replica_urls:
            raise ValueError("router needs at least one replica url")
        self.replicas = [Replica(u) for u in replica_urls]
        # knob resolution: env > constructor > default (the service
        # convention, docs/serving-fleet.md knob table)
        self.probe_interval_s = _resolve_num(
            "REPORTER_ROUTER_PROBE_S", probe_interval_s, 1.0)
        self.probe_timeout_s = _resolve_num(
            "REPORTER_ROUTER_PROBE_TIMEOUT_S", probe_timeout_s, 2.0)
        # debounce: one flapped probe must not drop a replica, and one
        # lucky probe must not resurrect a flapping one
        self.unhealthy_after = max(1, int(_resolve_num(
            "REPORTER_ROUTER_UNHEALTHY_AFTER", unhealthy_after, 2)))
        self.healthy_after = max(1, int(_resolve_num(
            "REPORTER_ROUTER_HEALTHY_AFTER", healthy_after, 2)))
        self.eject_streak = max(1, int(_resolve_num(
            "REPORTER_ROUTER_EJECT_STREAK", eject_streak, 3)))
        self.eject_s = _resolve_num("REPORTER_ROUTER_EJECT_S", eject_s, 5.0)
        self.hedge_s = _resolve_num("REPORTER_HEDGE_MS", hedge_ms, 0.0) / 1000.0
        # adaptive hedge threshold (docs/serving-fleet.md "Self-driving
        # fleet"): with hedging configured AND REPORTER_ADAPTIVE on, the
        # delay tracks k x the live fleet p95 of the report route
        # (clamped to [0.1x, 10x] the static knob, hysteresis-damped)
        # instead of freezing at REPORTER_HEDGE_MS; hedging stays OFF
        # entirely when the static knob is 0 — the controller retunes a
        # reflex, it never turns one on
        self.hedge_k = _resolve_num("REPORTER_ADAPTIVE_HEDGE_K", None, 2.0)
        self._hedge_ctl = None
        if self.hedge_s > 0 and obs_adaptive.enabled():
            self._hedge_ctl = obs_adaptive.Controller(
                "hedge_s", self.hedge_s,
                lo=max(0.001, 0.1 * self.hedge_s), hi=10.0 * self.hedge_s,
                cooldown_s=1.0)
        self.max_inflight = max(1, int(_resolve_num(
            "REPORTER_ROUTER_MAX_INFLIGHT", max_inflight, 256)))
        self.budget_s = _resolve_num(
            "REPORTER_ROUTER_BUDGET_S", budget_s, retry.BUDGET_S)
        self.request_timeout_s = _resolve_num(
            "REPORTER_ROUTER_REQUEST_TIMEOUT_S", request_timeout_s, 30.0)
        self.pool = pool or HttpPool(max_idle_per_host=16)
        self._gate = threading.BoundedSemaphore(self.max_inflight)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._prober: Optional[threading.Thread] = None
        self._t_boot = _time.time()
        # the fleet observability plane (docs/observability.md "Fleet
        # observability"): the federator pulls every replica's mergeable
        # snapshot; the fleet SLO engine classifies the CLIENT-VISIBLE
        # terminal outcome of every proxied request into the
        # reporter_fleet_slo_* families (a failed-over success is
        # fleet-good), and the masking-debt collector bills the delta
        # between summed replica burn and fleet burn at scrape time
        self.slo = obs_slo.SLOEngine(
            window_s=obs_slo._env_float("REPORTER_SLO_WINDOW_S", 300.0),
            families=obs_fed.FLEET_SLO)
        # the federator relays each replica's windowed agreement into the
        # fleet engine's sample series on every pull, so the match-quality
        # objective rides the reporter_fleet_slo_* plane like the others
        # (docs/match-quality.md "Fleet view")
        self.federator = obs_fed.Federator(
            [r.url for r in self.replicas], pool=self.pool,
            fleet_engine=self.slo)
        # optional geo-aware ranking term (docs/serving-fleet.md "Sharded
        # tables"): OFF by default — with the flag off the ranking is the
        # plain rendezvous hash bit-for-bit.  On, a request carrying a
        # usable first coordinate prefers replicas whose advertised UBODT
        # shard covers its geographic cell (cell id mod shard count), so
        # vehicles in one region concentrate their probe traffic on the
        # replica whose hot arena holds that region's bucket partition;
        # the rendezvous hash still breaks ties, so per-vehicle affinity
        # inside a cell is stable.
        self.geo_routing = os.environ.get(
            "REPORTER_ROUTER_GEO", "").strip().lower() in (
                "1", "true", "on", "yes")
        self.geo_cell_deg = _resolve_num(
            "REPORTER_ROUTER_GEO_CELL_DEG", None, 0.25)
        # probe-phase jitter fraction: each replica's next probe lands at
        # interval * (1 + U[0, jitter]) so N replicas spread out instead
        # of being probed in lockstep every tick
        self.probe_jitter = max(0.0, _resolve_num(
            "REPORTER_ROUTER_PROBE_JITTER", None, 0.25))
        self._rng = random.Random()
        # the autoscale admin ring: every accepted POST /fleet add/remove
        # (direction, url, reason, epoch), surfaced in /statusz and
        # fleet dashboards next to the scale-events counter
        self.scale_events: "deque[dict]" = deque(maxlen=64)
        obs.REGISTRY.register_collect(self._export_fleet_gauges)

    def _export_fleet_gauges(self) -> None:
        self.federator.export_gauges()
        self.slo.export_gauges()
        self.federator.export_masking_debt(self.slo)
        self.federator.export_fleet_quality()

    # -- health: active probing + passive outlier ejection -----------------

    def start(self) -> None:
        """Probe every replica once synchronously (routing works from the
        first request), then keep probing on the interval; the
        federation pull loop starts alongside."""
        self.probe_all()
        self.federator.start()
        self._prober = threading.Thread(target=self._probe_loop,
                                        daemon=True, name="fleet-prober")
        self._prober.start()

    def stop(self) -> None:
        self._stop.set()
        self.federator.stop()
        self.pool.close()
        # a stopped router's scrape-time collector goes with it: the
        # registry is process-global, and a later router's scrape must
        # not re-export this one's replicas
        obs.REGISTRY.unregister_collect(self._export_fleet_gauges)

    def _probe_loop(self) -> None:
        # fine-grained ticks over per-replica schedules: each replica's
        # next probe is jittered (and a draining Retry-After pushes it
        # back), so N replicas are probed spread out, never in lockstep
        tick = max(0.02, self.probe_interval_s / 5.0)
        while not self._stop.wait(tick):
            now = _time.monotonic()
            due = [r for r in self.replicas if now >= r.next_probe_at]
            for r in due:
                self._probe_one(r)
            if due:
                self._publish_states()

    def probe_all(self) -> None:
        """Probe EVERY replica synchronously, schedules notwithstanding
        (boot, tests, and admin transitions want a point-in-time view)."""
        for r in list(self.replicas):
            self._probe_one(r)
        self._publish_states()

    def _schedule_probe(self, r: Replica,
                        delay_s: Optional[float] = None) -> None:
        if delay_s is None:
            delay_s = self.probe_interval_s * (
                1.0 + self._rng.uniform(0.0, self.probe_jitter))
        r.next_probe_at = _time.monotonic() + delay_s

    def _publish_states(self) -> None:
        counts: Dict[str, int] = {"healthy": 0, "draining": 0,
                                  "unhealthy": 0, "init": 0}
        for r in self.replicas:
            counts[r.state] = counts.get(r.state, 0) + 1
        for state, n in counts.items():
            G_REPLICAS.labels(state).set(n)

    def _probe_one(self, r: Replica) -> None:
        """One probe + the next-probe scheduling (jittered default; a
        draining replica's Retry-After pushes ITS next probe back
        explicitly instead of ever counting toward the unhealthy
        streak)."""
        self._schedule_probe(r, self._probe_once(r))

    def _probe_once(self, r: Replica) -> Optional[float]:
        try:
            status, headers, body = self.pool.request(
                "GET", r.url + "/health", timeout=self.probe_timeout_s,
                target="probe")
            info = json.loads(body.decode("utf-8")) if body else {}
        except Exception as e:  # noqa: BLE001 - a dead replica is data
            self._probe_failed(r, "unreachable: %s" % (e,))
            return None
        rid = headers.get("X-Reporter-Replica") or info.get("replica")
        if rid:
            r.id = str(rid)
        shard = info.get("ubodt_shard")
        if shard:
            r.shard = str(shard)
        cap = info.get("capacity")
        if isinstance(cap, dict):
            r.capacity = cap
        r.last_probe = {"status": status,
                        "state": info.get("status"),
                        "t": round(_time.time(), 3)}
        if status == 200 and info.get("backend") is None \
                and info.get("warming"):
            # booted but the engine (and session store) is still
            # attaching: every /report would 503 "service initialising",
            # so the replica is NOT routable yet — hold it out of
            # rotation without ejection bookkeeping.  The recovery
            # transition (and its session rebalance) fires only once the
            # backend is live, so rebalanced traffic never ping-pongs
            # through a replica that cannot serve it.
            r.probe_fail_streak = 0
            r.probe_ok_streak = 0
            if r.state == "healthy":
                obs_log.event(log, "replica_warming", level=logging.WARNING,
                              replica=r.label, url=r.url)
            if r.state != "draining":
                r.state = "init"
            return
        if status == 200:
            r.probe_fail_streak = 0
            r.probe_ok_streak += 1
            if r.state != "healthy" and (
                    r.probe_ok_streak >= self.healthy_after
                    or r.state in ("init", "draining")):
                # draining -> 200 means a fresh process took the slot
                # (rolling restart); trust it immediately like a boot
                recovered = r.state != "init" or r.was_lost
                r.was_lost = False
                if recovered:
                    obs_log.event(log, "replica_recovered",
                                  level=logging.WARNING, replica=r.label,
                                  url=r.url)
                r.state = "healthy"
                r.fail_streak = 0
                r.ejected_until = 0.0
                r.handoff_started = False
                if recovered:
                    # beam rebalance (docs/serving-fleet.md "Beam
                    # handoff"): the fresh process inherits its vehicles
                    # back by rendezvous rank but has no session state —
                    # pull the sessions its vehicles parked on the other
                    # replicas during the outage
                    threading.Thread(
                        target=self._rebalance_to, args=(r,), daemon=True,
                        name="session-rebalance").start()
            elif r.state == "healthy":
                r.fail_streak = 0
            return
        if status == 503 and info.get("status") == "draining":
            # deliberate exit: rotate traffic off, no ejection
            # bookkeeping, no unhealthy streak — and the drainer's
            # Retry-After is honored as THIS replica's next-probe delay
            # (it told us when to come back; hammering it mid-drain only
            # competes with the handoff export)
            retry_after = None
            try:
                raw_ra = headers.get("Retry-After")
                if raw_ra:
                    retry_after = max(self.probe_interval_s, float(raw_ra))
            except (TypeError, ValueError):
                retry_after = None
            if r.state != "draining":
                obs_log.event(log, "replica_draining", level=logging.WARNING,
                              replica=r.label, url=r.url)
            r.state = "draining"
            r.was_lost = True
            r.probe_ok_streak = 0
            r.probe_fail_streak = 0
            if not r.handoff_started:
                # drain-safe beam handoff: pull the drainer's serialised
                # sessions while it finishes its inflight work and push
                # each to the replica that now inherits its uuid — the
                # vehicle's next point continues its decode bit-exact
                # instead of restarting the HMM
                r.handoff_started = True
                threading.Thread(
                    target=self._handoff_from, args=(r,), daemon=True,
                    name="session-handoff").start()
            return retry_after
        self._probe_failed(r, "status %s (%s)" % (status, info.get("status")))
        return None

    def _probe_failed(self, r: Replica, why: str) -> None:
        C_PROBE_FAIL.labels(r.label).inc()
        r.probe_ok_streak = 0
        r.probe_fail_streak += 1
        if r.probe_fail_streak >= self.unhealthy_after \
                and r.state != "unhealthy":
            C_EJECT.labels(r.label, "probe").inc()
            obs_log.event(log, "replica_unhealthy", level=logging.ERROR,
                          replica=r.label, url=r.url, reason=why,
                          streak=r.probe_fail_streak)
            r.state = "unhealthy"
            r.was_lost = True

    def _note_transport_failure(self, r: Replica) -> None:
        """Passive outlier ejection: consecutive transport errors on live
        traffic take a replica out of rotation before the next probe."""
        with self._lock:
            r.fail_streak += 1
            if r.fail_streak >= self.eject_streak:
                r.fail_streak = 0
                r.ejected_until = _time.monotonic() + self.eject_s
                C_EJECT.labels(r.label, "passive").inc()
                obs_log.event(log, "replica_ejected", level=logging.ERROR,
                              replica=r.label, url=r.url,
                              eject_s=self.eject_s)

    # -- beam handoff (docs/serving-fleet.md "Beam handoff") -----------------
    #
    # Rendezvous-hash affinity already pins a vehicle to one replica, so
    # that replica's pinned-host session store is the natural home of its
    # carried Viterbi beam.  When a replica exits deliberately (graceful
    # drain) the router moves each of its serialised sessions to the
    # replica that now inherits the uuid — the beam rides an exact-f32
    # wire snapshot, so the vehicle's next point continues the decode
    # bit-exact.  When a replica RETURNS (rolling restart, respawn after a
    # kill), the reverse sweep pulls its vehicles' sessions back from
    # wherever they parked.  A session that could not travel (export/
    # import failure, or it raced a re-dispatched point) degrades to the
    # rebuild-from-replay path on the inheriting side — continuity over a
    # short replay instead of an HMM restart.

    def _fetch_sessions(self, r: Replica) -> Optional[List[dict]]:
        # bounded retries: the first pull after a drain begins routinely
        # lands on a stale pooled keep-alive socket (the drainer closed
        # its connections when admission shut), and ONE failed export
        # would strand every beam on the dying replica
        deadline = _time.monotonic() + 5.0
        last_err: "Exception | None" = None
        while _time.monotonic() < deadline:
            try:
                status, _hdrs, body = self.pool.request(
                    "GET", r.url + "/sessions?export=1",
                    timeout=self.request_timeout_s, target="replica")
                if status != 200:
                    raise RuntimeError("export status %d" % status)
                return json.loads(body.decode("utf-8")).get("sessions") or []
            except Exception as e:  # noqa: BLE001 - retried until deadline
                last_err = e
                if self._stop.wait(0.2):
                    break
        C_HANDOFF.labels("export_failed").inc()
        obs_log.event(log, "session_export_failed",
                      level=logging.WARNING, replica=r.label,
                      error=str(last_err)[:200])
        return None

    def _import_sessions(self, target: Replica, wires: List[dict],
                         outcome: str) -> int:
        return self._import_sessions_tracked(target, wires, outcome)[0]

    def _import_sessions_tracked(
            self, target: Replica, wires: List[dict],
            outcome: str) -> Tuple[int, List[str]]:
        # a freshly-respawned target answers /health 200 while its engine
        # (and session store) is still attaching, so the import retries
        # through 503s for a bounded window instead of failing the handoff
        # on the race
        deadline = _time.monotonic() + 60.0
        last_err: "Exception | None" = None
        res = None
        while _time.monotonic() < deadline:
            try:
                status, _hdrs, body = self.pool.request(
                    "POST", target.url + "/sessions",
                    body=json.dumps({"sessions": wires},
                                    separators=(",", ":")).encode("utf-8"),
                    headers={"Content-Type": "application/json"},
                    timeout=self.request_timeout_s, target="replica")
                if status == 503:
                    raise RuntimeError("store not attached yet (503)")
                if status != 200:
                    raise RuntimeError("import status %d" % status)
                res = json.loads(body.decode("utf-8"))
                break
            except Exception as e:  # noqa: BLE001 - retried until deadline
                last_err = e
                if self._stop.wait(1.0):
                    break
        if res is None:
            C_HANDOFF.labels("import_failed").inc(len(wires))
            obs_log.event(log, "session_import_failed",
                          level=logging.WARNING, replica=target.label,
                          n=len(wires), error=str(last_err)[:200])
            return 0, []
        moved = int(res.get("imported", 0)) + int(res.get("merged", 0))
        C_HANDOFF.labels(outcome).inc(moved)
        C_HANDOFF.labels("skipped").inc(int(res.get("skipped", 0)))
        return moved, [str(u) for u in res.get("imported_uuids", ())]

    def _handoff_from(self, r: Replica) -> None:
        """Drain-time sweep: export the drainer's sessions, import each on
        the replica its uuid now rendezvous-ranks to."""
        wires = self._fetch_sessions(r)
        if not wires:
            return
        groups: Dict[int, Tuple[Replica, List[dict]]] = {}
        for w in wires:
            uuid = str(w.get("uuid") or "")
            order, _ = self.route_order(uuid)  # drainer already excluded
            order = [x for x in order if x is not r]
            if not order:
                C_HANDOFF.labels("no_target").inc()
                continue
            groups.setdefault(id(order[0]), (order[0], []))[1].append(w)
        moved = 0
        for target, ws in groups.values():
            moved += self._import_sessions(target, ws, "moved")
        obs_log.event(log, "session_handoff", level=logging.WARNING,
                      replica=r.label, exported=len(wires), moved=moved)

    def _pop_sessions(self, src: Replica,
                      uuids: List[str]) -> List[dict]:
        """Atomically remove-and-fetch sessions from a source replica
        (POST /sessions {"pop": [...]}) — export and delete in one locked
        sweep, so no point can commit into a copy that is about to be
        dropped (the export+delete TOCTOU a plain drop would have)."""
        try:
            status, _hdrs, body = self.pool.request(
                "POST", src.url + "/sessions",
                body=json.dumps({"pop": uuids},
                                separators=(",", ":")).encode("utf-8"),
                headers={"Content-Type": "application/json"},
                timeout=self.request_timeout_s, target="replica")
            if status != 200:
                raise RuntimeError("pop status %d" % status)
            return json.loads(body.decode("utf-8")).get("sessions") or []
        except Exception as e:  # noqa: BLE001 - nothing moved, nothing lost
            C_HANDOFF.labels("export_failed").inc()
            obs_log.event(log, "session_pop_failed",
                          level=logging.WARNING, replica=src.label,
                          error=str(e)[:200])
            return []

    def _rebalance_to(self, r: Replica) -> None:
        """Recovery sweep: move the recovered replica's vehicles' sessions
        back from the replicas they parked on — an atomic POP at each
        source (so late in-flight commits re-account themselves instead
        of riding a doomed copy) followed by a merge-capable import at
        the recovered replica.  If the import ultimately fails, the
        popped payload is re-imported at its source so no beam (or ledger
        count) is ever stranded in flight."""
        total = 0
        for src in self.replicas:
            if src is r or not src.available():
                continue
            wires = self._fetch_sessions(src)
            if not wires:
                continue
            mine = []
            for w in wires:
                order, _ = self.route_order(str(w.get("uuid") or ""))
                if order and order[0] is r:
                    mine.append(str(w.get("uuid")))
            if not mine:
                continue
            popped = self._pop_sessions(src, mine)
            if not popped:
                continue
            moved, _uuids = self._import_sessions_tracked(
                r, popped, "rebalanced")
            total += moved
            if not moved:
                # land the popped beams back home (merge-capable): better
                # a stale copy than a lost one
                self._import_sessions_tracked(src, popped, "moved")
        if total:
            obs_log.event(log, "session_rebalance", level=logging.WARNING,
                          replica=r.label, moved=total)

    # -- fleet scaling (docs/serving-fleet.md "Self-driving fleet") ----------
    #
    # The router owns the rendezvous ring, so growing/shrinking the fleet
    # is a router admin operation: the supervisor's autoscaler spawns or
    # drains the PROCESS and then tells the router via POST /fleet.  A
    # replica added cold is held out of rotation by the existing warming
    # hold-out (its /health reports warming until the engine attaches),
    # so zero requests ever land on an unwarmed replica; its first
    # healthy transition counts as a recovery, which fires the session
    # rebalance that pulls its vehicles' beams over.

    @staticmethod
    def _reason_slug(reason) -> str:
        return re.sub(r"[^a-zA-Z0-9_.-]", "_",
                      str(reason or "manual"))[:32] or "manual"

    def add_replica(self, url: str,
                    reason: str = "manual") -> Tuple[bool, str]:
        url = url.rstrip("/")
        with self._lock:
            if any(r.url == url for r in self.replicas):
                return False, "replica %s already in the fleet" % url
            r = Replica(url)
            # cold entry: not routable until the warming hold-out clears,
            # and the first healthy transition is a RECOVERY (was_lost)
            # so the rebalance moves its vehicles' sessions over
            r.was_lost = True
            self.replicas = self.replicas + [r]
        self.federator.add_target(url)
        reason = self._reason_slug(reason)
        C_SCALE.labels("up", reason).inc()
        self.scale_events.append({
            "t_unix": round(_time.time(), 3), "direction": "up",
            "url": url, "reason": reason})
        obs_log.event(log, "fleet_scale", level=logging.WARNING,
                      direction="up", url=url, reason=reason,
                      replicas=len(self.replicas))
        self._probe_one(r)
        self._publish_states()
        return True, "added %s (%d replicas)" % (url, len(self.replicas))

    def remove_replica(self, key: str,
                       reason: str = "manual") -> Tuple[bool, str]:
        key = str(key).rstrip("/")
        with self._lock:
            r = next((x for x in self.replicas
                      if x.url == key or x.id == key), None)
            if r is None:
                return False, "no replica %r in the fleet" % key
            if len(self.replicas) <= 1:
                return False, "refusing to remove the last replica"
            self.replicas = [x for x in self.replicas if x is not r]
        self.federator.remove_target(r.url)
        reason = self._reason_slug(reason)
        C_SCALE.labels("down", reason).inc()
        self.scale_events.append({
            "t_unix": round(_time.time(), 3), "direction": "down",
            "url": r.url, "reason": reason})
        obs_log.event(log, "fleet_scale", level=logging.WARNING,
                      direction="down", url=r.url, reason=reason,
                      replicas=len(self.replicas))
        self._publish_states()
        return True, "removed %s (%d replicas)" % (r.url,
                                                  len(self.replicas))

    def handle_fleet_admin(self, body: dict) -> Tuple[int, dict]:
        """``POST /fleet``: the scale-event surface.  Body carries
        ``{"add": "<url>"}`` or ``{"remove": "<url|replica-id>"}`` plus
        an optional ``"reason"`` tag that rides the scale-events counter
        and the /statusz ring."""
        reason = body.get("reason")
        add = body.get("add")
        rem = body.get("remove")
        if isinstance(add, str) and add.strip():
            ok, msg = self.add_replica(add.strip(), reason)
        elif isinstance(rem, str) and rem.strip():
            ok, msg = self.remove_replica(rem.strip(), reason)
        else:
            return 400, {"error": "body must carry add: <url> or "
                                  "remove: <url|replica-id>"}
        code = 200 if ok else 409
        _st, fleet = self.fleet()
        fleet["admin"] = msg
        fleet["ok"] = ok
        return code, fleet

    def handle_sessions_import(self, body: dict) -> Tuple[int, dict]:
        """``POST /sessions`` at the ROUTER: re-home serialised sessions
        to whichever replica each uuid rendezvous-ranks to now — the
        supervisor's recovery path for a SIGKILL'd replica's checkpoint
        files (merge-on-conflict import absorbs any race with the
        vehicles' own re-streamed points)."""
        wires = body.get("sessions")
        if not isinstance(wires, list):
            return 400, {"error": "sessions must be an array"}
        # "exclude": the dead replica's id/url — the supervisor calls the
        # re-home the instant it sees the death, which can be BEFORE the
        # prober's streak marks the replica unavailable; without the
        # explicit exclusion the wires would route straight back to the
        # corpse and stall the whole restore on its timeouts
        excl = str(body.get("exclude") or "").rstrip("/")
        groups: Dict[int, Tuple[Replica, List[dict]]] = {}
        no_target = 0
        for w in wires:
            uuid = str((w or {}).get("uuid") or "")
            order, _ = self.route_order(uuid)
            if excl:
                order = [r for r in order
                         if r.id != excl and r.url != excl]
            if not order:
                no_target += 1
                C_HANDOFF.labels("no_target").inc()
                continue
            groups.setdefault(id(order[0]), (order[0], []))[1].append(w)
        rehomed = 0
        imported: List[str] = []
        for target, ws in groups.values():
            n, us = self._import_sessions_tracked(target, ws, "rehomed")
            rehomed += n
            imported.extend(us)
        if wires:
            obs_log.event(log, "session_rehome", level=logging.WARNING,
                          received=len(wires), rehomed=rehomed,
                          no_target=no_target)
        return 200, {"received": len(wires), "rehomed": rehomed,
                     "no_target": no_target, "imported_uuids": imported}

    def handle_sessions(self, query: dict) -> Tuple[int, dict]:
        """Router ``GET /sessions``: the fleet's session plane on one
        screen — per-replica store summaries plus fleet totals (the
        fleet's zero-lost/zero-duplicated accounting reads this)."""
        fleet: Dict[str, dict] = {}
        sessions = points = 0
        for r in self.replicas:
            try:
                status, _hdrs, body = self.pool.request(
                    "GET", r.url + "/sessions",
                    timeout=self.probe_timeout_s, target="replica")
                info = json.loads(body.decode("utf-8"))
                if status != 200:
                    raise RuntimeError(info.get("error") or status)
            except Exception as e:  # noqa: BLE001 - a dead replica is data
                fleet[r.label] = {"error": str(e)[:200]}
                continue
            fleet[r.label] = {"sessions": info.get("sessions"),
                              "points_total": info.get("points_total"),
                              "draining": info.get("draining")}
            sessions += int(info.get("sessions") or 0)
            points += int(info.get("points_total") or 0)
        return 200, {"scope": "fleet", "sessions": sessions,
                     "points_total": points, "replicas": fleet}

    # -- routing ------------------------------------------------------------

    def _geo_pref(self, r: Replica, cell: int) -> int:
        """1 when replica ``r``'s advertised shard covers geographic cell
        ``cell`` (cell id mod shard count == shard index), else 0."""
        shard = r.shard
        if not shard:
            return 0
        try:
            idx_s, n_s = str(shard).split("/", 1)
            idx, n = int(idx_s), int(n_s)
        except ValueError:
            return 0
        return 1 if n > 0 and cell % n == idx else 0

    def _capacity_weight(self, r: Replica) -> float:
        """Ranking weight of a replica = its advertised local device
        count (the /health "capacity" block) — a mesh-inside-replica
        spanning N chips inherits ~N times the vehicles of a 1-chip
        replica.  1.0 when nothing is advertised (unprobed / legacy)."""
        cap = r.capacity if isinstance(r.capacity, dict) else None
        try:
            return max(1.0, float((cap or {}).get("devices") or 1))
        except (TypeError, ValueError):
            return 1.0

    def _capacity_score(self, uuid: str, r: Replica, w: float) -> float:
        """Weighted rendezvous score (highest-random-weight with weights):
        map the 64-bit hash to u in (0,1) and score w / -ln(u).  Strictly
        monotone in the hash, so for EQUAL weights the ordering is the
        plain rendezvous ordering bit-for-bit — weighting only engages
        when some replica advertises more chips — and the minimal-
        remapping property survives: a capacity change on one replica
        only remaps vehicles toward/away from THAT replica."""
        h = rendezvous_score(uuid, r.url)
        u = (h + 0.5) / 2.0 ** 64
        return w / -math.log(u)

    def ranked(self, uuid: str,
               geo: Optional[Tuple[float, float]] = None) -> List[Replica]:
        """Replicas in rendezvous order, capacity-weighted.  With the geo
        flag ON and a usable coordinate, the shard-covering replica ranks
        first and the weighted hash breaks ties; with the flag off (the
        default) and a homogeneous fleet the ranking is the plain
        rendezvous hash bit-for-bit — ``geo`` is never even computed by
        the callers then, and equal weights reduce the weighted score to
        the plain hash ordering."""
        weights = {id(r): self._capacity_weight(r) for r in self.replicas}
        if len(set(weights.values())) > 1:
            score = lambda r: self._capacity_score(  # noqa: E731
                uuid, r, weights[id(r)])
        else:
            score = lambda r: rendezvous_score(uuid, r.url)  # noqa: E731
        if geo is not None and self.geo_routing:
            cell = geo_cell(geo[0], geo[1], self.geo_cell_deg)
            ranked = sorted(
                self.replicas,
                key=lambda r: (self._geo_pref(r, cell), score(r)),
                reverse=True)
            plain_top = max(self.replicas, key=score)
            C_GEO.labels("aligned" if ranked[0] is plain_top
                         else "steered").inc()
            return ranked
        return sorted(self.replicas, key=score, reverse=True)

    def route_order(self, uuid: str,
                    geo: Optional[Tuple[float, float]] = None,
                    ) -> Tuple[List[Replica], bool]:
        """(available replicas in rendezvous order, remapped?) — remapped
        is True when the vehicle's true primary is out and its traffic is
        landing elsewhere (the affinity disruption the remap counter and
        the chaos suite measure)."""
        ranked = self.ranked(uuid, geo)
        now = _time.monotonic()
        order = [r for r in ranked if r.available(now)]
        remapped = bool(order) and order[0] is not ranked[0]
        return order, remapped

    def _one(self, r: Replica, path: str, body: bytes,
             headers: dict) -> Tuple[int, object, bytes, Replica]:
        """One replica leg.  Returns pass-through responses (2xx, plain
        4xx, 500, 504) and RAISES what the failover policy rotates on:
        transport errors, 429 (replica shedding), 503 (draining /
        unattached / wedged)."""
        if faults.fire("router_connect") is not None:
            self._note_transport_failure(r)
            C_BACKEND.labels(r.label, "error").inc()
            raise ConnectionRefusedError(
                "injected router->replica connect refusal")
        try:
            status, rhdrs, rbody = self.pool.request(
                "POST", r.url + path, body=body, headers=headers,
                timeout=self.request_timeout_s, target="replica")
        except Exception:
            self._note_transport_failure(r)
            C_BACKEND.labels(r.label, "error").inc()
            raise
        with self._lock:
            r.fail_streak = 0
        rid = rhdrs.get("X-Reporter-Replica")
        if rid:
            r.id = str(rid)
        C_BACKEND.labels(r.label, str(status)).inc()
        if status in (429, 503):
            # retryable on ANOTHER replica: hand the error to the shared
            # retry policy (Retry-After and cause classification ride the
            # HTTPError); the final one, if every replica sheds, becomes
            # the router's own 429/503
            raise_for_status(r.url + path, status, rhdrs, rbody)
        return status, rhdrs, rbody, r

    def current_hedge_s(self) -> float:
        """The live hedge threshold: static ``REPORTER_HEDGE_MS`` when
        adaptive control is off (or hedging is off entirely), else k x
        the fleet's windowed report-route p95 (the router's own
        client-truth SLO engine, 60 s window), clamped and damped by the
        controller.  With too little traffic to trust a quantile the
        controller holds its last value — a thin tail must not yank the
        reflex around."""
        ctl = self._hedge_ctl
        if ctl is None:
            return self.hedge_s
        agg = self.slo.window(60.0)
        if agg.eligible("report") < 32:
            return ctl.value
        p95 = agg.quantile(0.95, "report")
        return ctl.propose(None if p95 is None else self.hedge_k * p95)

    def _hedged(self, first: Replica, second: Replica, path: str,
                body: bytes, headers: dict, note=None,
                delay: Optional[float] = None):
        """Race the primary against the next-ranked replica after the
        hedge delay; first SUCCESS wins, a lone failure waits for its
        peer, two failures re-raise the primary's.  ``note`` (the
        dispatch span's hop recorder) gets one hop per leg; the losing
        leg — whichever side it is — is marked cancelled at decision
        time, exactly once."""
        cond = threading.Condition()
        results: List[Tuple[Replica, object, bool]] = []
        note_lock = threading.Lock()
        noted: set = set()  # legs (by is_hedge) whose hop is recorded
        t_race = _time.monotonic()

        def _note(is_hedge: bool, r: Replica, outcome: str,
                  cancelled: bool = False) -> None:
            if note is None:
                return
            with note_lock:
                if is_hedge in noted:
                    return
                noted.add(is_hedge)
            note(span="hedge" if is_hedge else "dispatch", attempt=0,
                 replica=r.label, outcome=outcome, cancelled=cancelled,
                 ms=round((_time.monotonic() - t_race) * 1000.0, 1))

        def run(r: Replica, is_hedge: bool):
            hdrs = headers if not is_hedge else dict(
                headers, **{KEEP_HEADER: "hedge"})
            try:
                out = self._one(r, path, body, hdrs)
            except BaseException as e:  # noqa: BLE001 - collected below
                out = e
            _note(is_hedge, r,
                  ("error: %s" % out) if isinstance(out, BaseException)
                  else str(out[0]))
            with cond:
                results.append((r, out, is_hedge))
                cond.notify_all()

        threading.Thread(target=run, args=(first, False), daemon=True,
                         name="hedge-primary").start()
        with cond:
            cond.wait_for(lambda: results,
                          timeout=self.hedge_s if delay is None else delay)
            if not results:
                C_HEDGES.inc()
                threading.Thread(target=run, args=(second, True),
                                 daemon=True, name="hedge-second").start()
                hedged = True
            else:
                hedged = False
            deadline = _time.monotonic() + self.request_timeout_s
            want = 2 if hedged else 1
            while True:
                done = len(results)
                ok = [o for o in results if not isinstance(o[1], BaseException)]
                if ok:
                    winner = ok[0]
                    if winner[2]:
                        C_HEDGE_WINS.inc()
                    if hedged:
                        # the straggling leg is abandoned: record it as a
                        # cancelled hop (its thread's own note, if the
                        # response ever arrives, is suppressed by the
                        # noted set)
                        loser_is_hedge = not winner[2]
                        _note(loser_is_hedge,
                              second if loser_is_hedge else first,
                              "cancelled", cancelled=True)
                    return winner[1]
                if done >= want:
                    break
                remaining = deadline - _time.monotonic()
                if remaining <= 0 or not cond.wait(timeout=remaining):
                    break
        # no success: surface the primary's failure (hedge failures are
        # secondary evidence; the retry loop rotates onward either way)
        for r, out, is_hedge in results:
            if not is_hedge and isinstance(out, BaseException):
                raise out
        for _r, out, _h in results:
            if isinstance(out, BaseException):
                raise out
        raise TimeoutError("hedged request: no replica answered in time")

    def dispatch(self, endpoint: str, body: bytes, uuid: str,
                 fwd_headers: dict, span: Optional[Span] = None,
                 geo: Optional[Tuple[float, float]] = None):
        """Route one request: rendezvous order, failover under the shared
        retry budget, optional hedging.  Returns (status, headers, body,
        outcome) — outcome feeds the router request counter.  ``span``
        (the router's own hop span, recorded into the flight recorder by
        the HTTP front) collects one hop per dispatch attempt — replica,
        outcome, duration, hedge/cancelled flags — plus the ranking time,
        so ``GET /debug/traces?id=`` can show which replicas were tried
        and why."""
        t_rank = _time.monotonic()
        order, remapped = self.route_order(uuid, geo)
        hops: List[dict] = []
        hop_lock = threading.Lock()

        def note_hop(**kw) -> None:
            with hop_lock:
                hops.append(kw)

        if span is not None:
            span.mark("ranking_s", _time.monotonic() - t_rank)
            span.meta["hops"] = hops
            if remapped:
                span.meta["remapped"] = True
        if not order:
            return (503, None,
                    json.dumps({"error": "no replica available",
                                "retry_after": 1}).encode("utf-8"),
                    "no_replica")
        if remapped:
            C_REMAP.inc()
        path = "/" + endpoint
        hedge = (self.hedge_s > 0 and len(order) > 1
                 and endpoint == "report")
        # resolved ONCE per request: the adaptive threshold must not
        # shift between the race start and its timeout bookkeeping
        hedge_delay = self.current_hedge_s() if hedge else 0.0
        attempts = {"n": 0}

        def attempt(i: int) -> Tuple[int, object, bytes, Replica]:
            attempts["n"] = i + 1
            r = order[i % len(order)]
            if i == 0 and hedge:
                return self._hedged(order[0], order[1], path, body,
                                    fwd_headers, note=note_hop,
                                    delay=hedge_delay)
            # re-dispatched legs carry the flight-keep hint: the winning
            # replica must retain ITS spans for the stitched trace
            hdrs = fwd_headers if i == 0 else dict(
                fwd_headers, **{KEEP_HEADER: "failover"})
            t0 = _time.monotonic()
            try:
                out = self._one(r, path, body, hdrs)
            except BaseException as e:
                note_hop(span="dispatch", attempt=i, replica=r.label,
                         outcome=("%d" % e.code
                                  if isinstance(e, urllib.error.HTTPError)
                                  else "error: %s" % e),
                         ms=round((_time.monotonic() - t0) * 1000.0, 1))
                raise
            note_hop(span="dispatch", attempt=i, replica=r.label,
                     outcome=str(out[0]),
                     ms=round((_time.monotonic() - t0) * 1000.0, 1))
            return out

        # wrap to count failover causes without re-implementing the policy
        def attempt_counted(i: int):
            try:
                return attempt(i)
            except urllib.error.HTTPError as e:
                if i + 1 < max(2, len(order)) + 1:
                    C_FAILOVER.labels(
                        "429" if e.code == 429 else "5xx").inc()
                raise
            except Exception:
                if i + 1 < max(2, len(order)) + 1:
                    C_FAILOVER.labels("network").inc()
                raise

        try:
            status, rhdrs, rbody, r = retry.call_with_failover(
                attempt_counted, target="router",
                retries=max(2, len(order)) + 1,
                budget_s=self.budget_s, hold_429=False)
        except urllib.error.HTTPError as e:
            # every tried replica shed (429) or refused (503): propagate
            # the backpressure with the replica's own Retry-After hint
            hint = retry._retry_after_s(e)
            payload = {"error": ("fleet saturated" if e.code == 429
                                 else "no replica accepted the request"),
                       "retry_after": max(1, int(hint or 1))}
            if span is not None:
                span.meta["attempts"] = attempts["n"]
            return (e.code, getattr(e, "headers", None),
                    json.dumps(payload).encode("utf-8"), "saturated")
        except Exception as e:  # noqa: BLE001 - transport-level exhaustion
            if span is not None:
                span.meta["attempts"] = attempts["n"]
            return (503, None,
                    json.dumps({"error": "fleet unreachable: %s" % (e,),
                                "retry_after": 1}).encode("utf-8"),
                    "unreachable")
        outcome = "ok" if attempts["n"] <= 1 else "failover_ok"
        if status >= 400:
            outcome = "passthrough"
        if span is not None:
            span.meta["attempts"] = attempts["n"]
            span.meta["replica"] = r.label
        return status, rhdrs, rbody, outcome

    # -- surfaces ------------------------------------------------------------

    def health(self) -> Tuple[int, dict]:
        states = {r.url: r.snapshot() for r in self.replicas}
        n_avail = sum(1 for r in self.replicas if r.available())
        code = 200 if n_avail else 503
        return code, {
            "status": "ok" if n_avail else "unavailable",
            "role": "router",
            "available": n_avail,
            "replicas": {u: {"id": s["id"], "state": s["state"],
                             "available": s["available"]}
                         for u, s in states.items()},
            "uptime_s": round(_time.time() - self._t_boot, 1),
        }

    def fleet(self) -> Tuple[int, dict]:
        return 200, {
            "replicas": [r.snapshot() for r in self.replicas],
            "knobs": {
                "probe_interval_s": self.probe_interval_s,
                "probe_timeout_s": self.probe_timeout_s,
                "unhealthy_after": self.unhealthy_after,
                "healthy_after": self.healthy_after,
                "eject_streak": self.eject_streak,
                "eject_s": self.eject_s,
                "hedge_ms": round(self.hedge_s * 1000.0, 1),
                "hedge_effective_ms": round(
                    self.current_hedge_s() * 1000.0, 1),
                "adaptive": obs_adaptive.enabled(),
                "probe_jitter": self.probe_jitter,
                "max_inflight": self.max_inflight,
                "budget_s": self.budget_s,
                "request_timeout_s": self.request_timeout_s,
            },
            "scale_events": list(self.scale_events),
        }

    # -- the fleet observability plane (docs/observability.md) ---------------

    def render_metrics(self, pull: bool = False) -> str:
        """Router ``GET /metrics``: the router's own families (incl. the
        staleness gauges and the reporter_fleet_slo_* verdict, pushed by
        the scrape-time collector) followed by every replica's federated
        snapshot under a ``replica`` label.  ``?pull=1`` forces a
        synchronous federation pull first (drills assert against a
        point-in-time fleet state)."""
        if pull:
            self.federator.pull_all()
        own = obs.REGISTRY.render()
        # suppress duplicate # HELP/# TYPE for family names the router's
        # own registry already rendered (import-time registrations from
        # serve/service.py exist here too, sample-less)
        own_names = set(obs.REGISTRY.snapshot())
        return own + self.federator.render(skip_meta=own_names)

    def _replica_by_id(self, rid: str) -> Optional[Replica]:
        return next((r for r in self.replicas if r.id == rid), None)

    def fleet_statusz(self) -> Tuple[int, dict]:
        """One screen for N replicas: per-replica probe state, snapshot
        age, queue depth, inflight, degraded/draining flags and burn
        rates side by side, plus the fleet SLO summary, the masking
        debt, and the router's own metrics snapshot."""
        feeds = {f.label: f for f in self.federator.feeds()}
        ages = self.federator.ages()
        rows = []
        for r in self.replicas:
            rid = r.id or r.url
            feed = feeds.get(rid) or feeds.get(r.url)
            statusz = feed.statusz if feed is not None else None
            snap = (statusz or {}).get("metrics") or {}
            slo_sum = (statusz or {}).get("slo") or {}
            age = ages.get(rid) or ages.get(r.url) or {}
            rows.append({
                "id": r.id,
                "url": r.url,
                "state": r.state,
                "available": r.available(),
                "snapshot_age_s": age.get("age_s"),
                "snapshot_stale": age.get("stale", True),
                "draining": (statusz or {}).get("draining"),
                "degraded": (statusz or {}).get("degraded"),
                "warming": (statusz or {}).get("warming"),
                # advertised local mesh size (the /health "capacity"
                # block): what the weighted ranking and the supervisor's
                # capacity-aware queue gate consume
                "devices": ((r.capacity or {}).get("devices")
                            if isinstance(r.capacity, dict) else None),
                "queue_depth": obs_fed.snapshot_scalar(
                    snap, "reporter_microbatch_queue_depth"),
                "inflight": obs_fed.snapshot_scalar(
                    snap, "reporter_microbatch_inflight"),
                "burn": {
                    name: st.get("burn")
                    for name, st in (slo_sum.get("objectives")
                                     or {}).items()},
                # the economics line off the replica's own statusz
                # (docs/economics.md): cost + measured headroom per row
                "economics": (statusz or {}).get("economics"),
            })
        return 200, {
            "role": "router",
            "uptime_s": round(_time.time() - self._t_boot, 1),
            "fleet": rows,
            "economics": self.fleet_economics(rows),
            "slo": self.slo.summary(),
            # the self-driving plane on the one-screen view: current
            # replica count, the adaptive hedge's live value, and the
            # recent scale decisions (docs/serving-fleet.md)
            "autoscale": {
                "replicas": len(self.replicas),
                "adaptive": obs_adaptive.enabled(),
                "hedge_effective_ms": round(
                    self.current_hedge_s() * 1000.0, 1),
                "events": list(self.scale_events)[-8:],
            },
            "masking_debt": self.federator.masking_debt(self.slo),
            "federation": {
                "pull_interval_s": self.federator.pull_interval_s,
                "stale_after_s": self.federator.stale_after_s,
                "replicas": ages,
            },
            "metrics": obs.REGISTRY.snapshot(),
        }

    def fleet_economics(self, rows: Optional[list] = None) -> dict:
        """The fleet cost roll-up (docs/economics.md): total chip-
        seconds / dollars / headroom summed over every replica's last
        federated snapshot, fleet $-per-million-matched-points from the
        summed points ledger.  A dead replica's LAST snapshot still
        counts — its spend happened — and the supervisor's cross-
        incarnation ledger (the fleet supervisor's FleetCostLedger)
        owns SIGKILL exactness."""
        total_cs = total_usd = total_points = 0.0
        headroom = ceiling = None
        chips = 0
        for f in self.federator.feeds():
            statusz = f.statusz or {}
            econ = statusz.get("economics") or {}
            snap = statusz.get("metrics") or {}
            total_cs += float(econ.get("chip_seconds_total") or 0.0)
            total_usd += float(econ.get("usd") or 0.0)
            chips += int(econ.get("chips") or 0)
            total_points += float(obs_fed.snapshot_scalar(
                snap, "reporter_points_matched_total") or 0.0)
            hr = econ.get("headroom_traces_per_sec")
            if hr is not None:
                headroom = (headroom or 0.0) + float(hr)
            cl = econ.get("ceiling_traces_per_sec")
            if cl is not None:
                ceiling = (ceiling or 0.0) + float(cl)
        return {
            "replicas": len(self.replicas),
            "chips": chips,
            "chip_seconds_total": round(total_cs, 3),
            "usd": round(total_usd, 6),
            "points_total": int(total_points),
            "usd_per_million_points": (
                round(total_usd / total_points * 1e6, 6)
                if total_points > 0 else None),
            "ceiling_traces_per_sec": (round(ceiling, 4)
                                       if ceiling is not None else None),
            "headroom_traces_per_sec": (round(headroom, 4)
                                        if headroom is not None else None),
        }

    def handle_cost(self, query: dict) -> Tuple[int, dict]:
        """Router ``GET /debug/cost``: the fleet roll-up plus each
        replica's full cost block out of its last federated statusz
        snapshot (``?pull=1`` forces a synchronous federation pull
        first, a drill's point-in-time read)."""
        if query.get("pull", ["0"])[0] not in ("", "0", "false"):
            self.federator.pull_all()
        per_replica = {}
        for f in self.federator.feeds():
            econ = (f.statusz or {}).get("economics")
            if econ is not None:
                per_replica[f.label] = econ
        return 200, {
            "scope": "fleet",
            "fleet": self.fleet_economics(),
            "replicas": per_replica,
        }

    def handle_slo(self, query: dict) -> Tuple[int, dict]:
        """Router ``GET /debug/slo[?window=S]``: the CLIENT-TRUTH fleet
        verdict (same report shape as a replica's /debug/slo, rendered
        from the router-side engine) plus the per-objective masking debt
        — the replica budget failover is spending invisibly."""
        window = None
        raw = query.get("window", [None])[0]
        if raw is not None:
            try:
                window = max(1.0, float(raw))
            except (TypeError, ValueError):
                return 400, {"error": "window must be a number (seconds)"}
        out = self.slo.report(window_s=window)
        out["scope"] = "fleet"
        out["masking_debt"] = self.federator.masking_debt(self.slo)
        # the fleet quality view: per-replica windowed agreement + mean
        # and min (min diverging from mean = ONE replica mismatching)
        out["quality"] = self.federator.fleet_quality()
        return 200, out

    def handle_traces(self, query: dict) -> Tuple[int, dict]:
        """Router ``GET /debug/traces``: ``?n=K`` lists the router's own
        retained hop spans; ``?id=<trace_id>`` stitches — the router
        entry's hop spans (admission, ranking, every dispatch attempt)
        with the serving replica's span tree (fetched live from the
        replica recorded in ``X-Reporter-Replica``) spliced under them
        as ``children``."""
        rec = obs_flight.RECORDER
        tid = obs_trace.accept_trace_id(query.get("id", [None])[0])
        if not tid:
            try:
                n = int(query.get("n", ["50"])[0])
            except (TypeError, ValueError):
                return 400, {"error": "n must be an integer"}
            n = max(1, min(n, 2 * rec.capacity))
            return 200, {"summary": rec.summary(), "traces": rec.snapshot(n)}
        entries = rec.find(tid)
        if not entries:
            return 404, {"error": "trace %r not retained at the router"
                                  % tid, "trace_id": tid}
        # newest ROUTER hop span for the id (an embedded single-process
        # fleet shares one recorder, so replica spans can sit alongside)
        router_entry = next(
            (e for e in reversed(entries) if e.get("hop") == "router"),
            entries[-1])
        rid = router_entry.get("replica")
        replica_spans: List[dict] = []
        note = None
        rep = self._replica_by_id(rid) if rid else None
        if rep is None:
            note = ("no serving replica recorded" if not rid
                    else "replica %r not in the fleet" % rid)
        else:
            try:
                status, _hdrs, body = self.pool.request(
                    "GET", rep.url + "/debug/traces?id=" + tid,
                    timeout=self.probe_timeout_s, target="replica")
                if status == 200:
                    replica_spans = json.loads(
                        body.decode("utf-8")).get("traces", [])
                else:
                    note = ("replica %s did not retain the trace (%d)"
                            % (rid, status))
            except Exception as e:  # noqa: BLE001 - stitch what we have
                note = "replica fetch failed: %s" % (e,)
        stitched = dict(router_entry)
        stitched["children"] = replica_spans
        out = {
            "trace_id": tid,
            "stitched": stitched,
            "router_entries": entries,
            "replica": {"id": rid, "spans": replica_spans},
        }
        if note:
            out["replica"]["note"] = note
        return 200, out

    def proxy_debug(self, action: str, query: dict,
                    trace_id: Optional[str] = None):
        """Proxy ``GET /debug/attrib`` / ``GET /debug/profile`` to ONE
        replica selected by ``?replica=<id>`` (400 without the selector,
        404 listing the known ids on a bad one).  The replica's answer —
        including its single-flight 409 with the owning capture's
        trace_id — passes through verbatim.  Returns (status, headers,
        body_bytes)."""
        rid = (query.get("replica") or [None])[0]
        known = sorted(r.id for r in self.replicas if r.id)
        if not rid:
            return (400, None, json.dumps(
                {"error": "replica query parameter required "
                          "(profiling targets ONE replica)",
                 "replicas": known}).encode("utf-8"))
        rep = self._replica_by_id(rid)
        if rep is None:
            return (404, None, json.dumps(
                {"error": "unknown replica %r" % rid,
                 "replicas": known}).encode("utf-8"))
        qs = urlencode({k: v for k, v in query.items()
                        if k != "replica"}, doseq=True)
        path = "/debug/%s" % action + ("?" + qs if qs else "")
        hdrs = {"X-Reporter-Trace": trace_id} if trace_id else {}
        try:
            # capture windows run for seconds (profile ?seconds=N is
            # clamped to 60 replica-side): give the leg room on top of
            # the normal dispatch timeout
            status, rhdrs, body = self.pool.request(
                "GET", rep.url + path, headers=hdrs,
                timeout=self.request_timeout_s + 90.0, target="replica")
        except Exception as e:  # noqa: BLE001 - surfaced to the caller
            return (502, None, json.dumps(
                {"error": "replica %s unreachable: %s" % (rid, e)}
            ).encode("utf-8"))
        return status, rhdrs, body

    # -- HTTP front ----------------------------------------------------------

    def make_server(self, host: str = "0.0.0.0",
                    port: int = 8002) -> ThreadingHTTPServer:
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            timeout = 30

            def _answer(self, code: int, payload: dict,
                        replica_hdrs=None):
                body = json.dumps(
                    payload, separators=(",", ":")).encode("utf-8")
                self._answer_bytes(code, body, replica_hdrs,
                                   "application/json;charset=utf-8")

            def _answer_bytes(self, code: int, body: bytes, replica_hdrs,
                              ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if replica_hdrs is not None:
                    # the winning replica's identity rides through the
                    # hop — load generators' distributions and the
                    # affinity checks key on it
                    rid = replica_hdrs.get("X-Reporter-Replica")
                    if rid:
                        self.send_header("X-Reporter-Replica", rid)
                if code in (429, 503):
                    ra = 1
                    if replica_hdrs is not None:
                        try:
                            ra = max(1, int(float(
                                replica_hdrs.get("Retry-After") or 1)))
                        except (TypeError, ValueError):
                            ra = 1
                    self.send_header("Retry-After", str(ra))
                tid = getattr(self, "_trace_id", None)
                if tid:
                    self.send_header("X-Reporter-Trace", tid)
                self.end_headers()
                self.wfile.write(body)

            def _content_length(self):
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                except (TypeError, ValueError):
                    self.close_connection = True
                    return None
                if n < 0:
                    self.close_connection = True
                    return None
                return n

            def _proxy(self, endpoint: str, payload_bytes: bytes,
                       uuid: str, geo=None, stream=None):
                t0 = _time.monotonic()
                # fleet-SLO route: streaming session submits classify
                # under "report_stream" like they do replica-side, so the
                # per-POINT latency objective is a fleet objective too
                # (best-effort sniff; both compact and spaced JSON forms.
                # binary columnar bodies pass the flag explicitly — the
                # byte sniff cannot see into the frame)
                slo_route = endpoint
                if endpoint == "report" and (
                        stream if stream is not None else (
                            b'"stream":true' in payload_bytes
                            or b'"stream": true' in payload_bytes)):
                    slo_route = "report_stream"
                # the router's own hop span: admission, ranking, every
                # dispatch attempt, total router residency — recorded
                # into the router-side flight recorder under the SAME
                # trace_id the replica records its spans under, which is
                # what GET /debug/traces?id= stitches back together
                span = Span("router." + endpoint, trace_id=self._trace_id)
                span.meta["hop"] = "router"
                span.meta["endpoint"] = endpoint
                if uuid:
                    span.meta["uuid"] = uuid[:64]
                if not router._gate.acquire(blocking=False):
                    C_SHED.inc()
                    C_REQS.labels(endpoint, "shed").inc()
                    span.fail("router saturated", status="shed")
                    span.finish()
                    router.slo.observe(slo_route, 429, span.total_s,
                                       trace_id=span.trace_id)
                    obs_flight.record(span)
                    return self._answer(
                        429, {"error": "router saturated (%d inflight)"
                              % router.max_inflight, "retry_after": 1})
                G_INFLIGHT.inc()
                span.mark("admission_s", _time.monotonic() - t0)
                try:
                    # wire passthrough: the body forwards verbatim, so
                    # its Content-Type (binary columnar frames), the
                    # client's Accept preference, and any gzip
                    # Content-Encoding must ride the hop untouched —
                    # negotiation is end to end, the router only relays
                    fwd = {"Content-Type": (self.headers.get("Content-Type")
                                            or "application/json"),
                           "X-Reporter-Trace": self._trace_id}
                    for h in ("Accept", "Content-Encoding"):
                        v = self.headers.get(h)
                        if v:
                            fwd[h] = v
                    dl = self.headers.get("X-Reporter-Deadline-Ms")
                    if dl:
                        fwd["X-Reporter-Deadline-Ms"] = dl
                    # a client-supplied flight-keep hint pins the request
                    # END TO END: the router's own span and every replica
                    # leg (the re-dispatch hint below still overrides on
                    # retries — "failover" is the more specific story)
                    fk = obs_trace.accept_trace_id(
                        self.headers.get(KEEP_HEADER))
                    if fk:
                        fwd[KEEP_HEADER] = fk
                        span.meta["flight_keep"] = fk
                    status, rhdrs, rbody, outcome = router.dispatch(
                        endpoint, payload_bytes, uuid, fwd, span=span,
                        geo=geo)
                    C_REQS.labels(endpoint, outcome).inc()
                    span.meta["outcome"] = outcome
                    if outcome in ("no_replica", "unreachable",
                                   "saturated"):
                        span.fail(outcome, status=outcome)
                    span.finish()
                    # the CLIENT-TRUTH fleet SLO: classify what the
                    # client actually received, failover and hedging
                    # already absorbed (a failed-over 200 is fleet-good).
                    # degraded rides the replica's own response body.
                    rb = rbody or b""
                    router.slo.observe(
                        slo_route, status, span.total_s,
                        degraded=(wire.response_degraded(rb)
                                  if rb[:4] == wire.MAGIC
                                  else b'"degraded":true' in rb),
                        trace_id=span.trace_id)
                    # multi-attempt / hedged spans are pinned: the
                    # stitched view of a failover must survive sampling
                    if span.meta.get("attempts", 1) > 1 or any(
                            h.get("span") == "hedge"
                            for h in span.meta.get("hops", ())):
                        span.meta.setdefault("flight_keep", "failover")
                    obs_flight.record(span)
                    self._answer_bytes(
                        status, rbody, rhdrs,
                        (rhdrs or {}).get("Content-Type")
                        or "application/json;charset=utf-8")
                finally:
                    G_INFLIGHT.dec()
                    router._gate.release()
                    H_LAT.labels(endpoint).observe(
                        _time.monotonic() - t0, exemplar=self._trace_id)

            def _route(self, post: bool):
                self._trace_id = (
                    obs_trace.accept_trace_id(
                        self.headers.get("X-Reporter-Trace"))
                    or obs_trace.new_trace_id())
                try:
                    split = urlsplit(self.path)
                    action = split.path.split("/")[-1]
                    query = parse_qs(split.query)
                    if action not in ACTIONS:
                        return self._answer(
                            400, {"error": "Try a valid action: %s"
                                  % sorted(ACTIONS)})
                    if action == "health":
                        return self._answer(*router.health())
                    if action in ("fleet", "sessions") and post:
                        # the admin surfaces: POST /fleet add/remove (the
                        # supervisor's scale events) and POST /sessions
                        # (checkpoint re-home to the inheriting replicas)
                        n = self._content_length()
                        if n is None:
                            return self._answer(
                                400, {"error": "invalid Content-Length"})
                        try:
                            body = json.loads(
                                self.rfile.read(n).decode("utf-8"))
                        except OSError as e:
                            self.close_connection = True
                            try:
                                return self._answer(400, {"error": str(e)})
                            except OSError:
                                return None
                        except Exception as e:  # noqa: BLE001
                            return self._answer(400, {"error": str(e)})
                        if not isinstance(body, dict):
                            return self._answer(
                                400, {"error": "request body must be a "
                                      "json object"})
                        handler = (router.handle_fleet_admin
                                   if action == "fleet"
                                   else router.handle_sessions_import)
                        return self._answer(*handler(body))
                    if action == "fleet":
                        return self._answer(*router.fleet())
                    if action == "statusz":
                        return self._answer(*router.fleet_statusz())
                    if action == "sessions":
                        return self._answer(*router.handle_sessions(query))
                    if action == "traces":
                        return self._answer(*router.handle_traces(query))
                    if action == "slo":
                        return self._answer(*router.handle_slo(query))
                    if action == "cost":  # GET /debug/cost[?pull=1]
                        return self._answer(*router.handle_cost(query))
                    if action in ("attrib", "profile"):
                        status, rhdrs, body = router.proxy_debug(
                            action, query, self._trace_id)
                        return self._answer_bytes(
                            status, body, rhdrs,
                            "application/json;charset=utf-8")
                    if action == "metrics":
                        pull = query.get("pull", ["0"])[0] \
                            not in ("", "0", "false")
                        return self._answer_bytes(
                            200,
                            router.render_metrics(pull=pull).encode("utf-8"),
                            None,
                            "text/plain; version=0.0.4; charset=utf-8")
                    if post:
                        n = self._content_length()
                        if n is None:
                            return self._answer(
                                400, {"error": "invalid Content-Length"})
                        raw = self.rfile.read(n)
                    else:
                        if "json" not in query:
                            return self._answer(
                                400, {"error": "No json provided"})
                        raw = query["json"][0].encode("utf-8")
                    # binary columnar bodies (serve/wire.py) forward
                    # verbatim; the affinity/geo extraction reads the
                    # frame's sniff view instead of parsing JSON.  gzip
                    # bodies also forward verbatim (the REPLICA inflates)
                    # — their affinity fields are unreadable here, so
                    # they route by the rendezvous hash of "".
                    sniff = None
                    payload = None
                    gz = (self.headers.get("Content-Encoding")
                          or "").strip().lower() == "gzip"
                    if post and raw[:4] == wire.MAGIC:
                        sniff = wire.sniff_request(raw)
                    elif not gz:
                        payload = json.loads(raw.decode("utf-8"))
                except OSError as e:
                    self.close_connection = True
                    try:
                        return self._answer(400, {"error": str(e)})
                    except OSError:
                        return None
                except Exception as e:
                    return self._answer(400, {"error": str(e)})
                try:
                    if sniff is not None:
                        lead = sniff[0] if sniff else {}
                        uuid = str(lead.get("uuid") or "")
                        geo = None
                        if (router.geo_routing
                                and lead.get("lat") is not None):
                            geo = (lead["lat"], lead["lon"])
                        return self._proxy(action, raw, uuid, geo,
                                           stream=bool(lead.get("stream")))
                    if payload is None:
                        # gzip passthrough: opaque here, inflated by the
                        # replica; no affinity key to extract
                        return self._proxy(action, raw, "", None)
                    if not isinstance(payload, dict):
                        return self._answer(
                            400,
                            {"error": "request body must be a json object"})
                    # affinity key: the vehicle uuid ( batch requests
                    # route by their first trace's uuid — bulk clients
                    # pre-group by vehicle)
                    if action == "report":
                        uuid = str(payload.get("uuid") or "")
                        lead = payload
                    else:
                        traces = payload.get("traces") or [{}]
                        lead = (traces[0] or {}) \
                            if isinstance(traces, list) else {}
                        uuid = str(lead.get("uuid") or "") \
                            if isinstance(lead, dict) else ""
                    # geo term (flag-gated; None keeps the ranking the
                    # plain rendezvous hash): the request's first
                    # coordinate names the geographic cell whose shard
                    # owner should serve it
                    geo = None
                    if router.geo_routing and isinstance(lead, dict):
                        pts = lead.get("trace")
                        p0 = pts[0] if (isinstance(pts, list) and pts
                                        and isinstance(pts[0], dict)) \
                            else None
                        try:
                            if p0 is not None:
                                geo = (float(p0["lat"]), float(p0["lon"]))
                        except (KeyError, TypeError, ValueError):
                            geo = None
                    self._proxy(action, raw, uuid, geo)
                except Exception as e:  # noqa: BLE001 - never drop the socket
                    log.exception("unhandled router error")
                    self._answer(500, {"error": str(e)})

            def do_GET(self):
                self._route(post=False)

            def do_POST(self):
                self._route(post=True)

            def log_request(self, code="-", size="-"):
                obs_log.event(
                    log, "router_request", level=logging.DEBUG,
                    method=self.command, path=self.path,
                    status=int(code) if isinstance(code, int) else str(code),
                    trace_id=getattr(self, "_trace_id", None))

            def log_message(self, fmt, *args):
                log.debug("router http: " + fmt, *args)

        class Server(ThreadingHTTPServer):
            request_queue_size = 128

        return Server((host, port), Handler)


def main(argv=None) -> int:
    obs_log.configure()
    # the router's hop spans are written on the way out exactly like a
    # replica's (REPORTER_REPLICA_ID, when the supervisor pins one,
    # rides the dump filename — obs/flight.py)
    obs_flight.install_shutdown_dump()
    ap = argparse.ArgumentParser(description="fleet router "
                                 "(docs/serving-fleet.md)")
    ap.add_argument("--port", type=int, default=8002)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--replicas", required=True,
                    help="comma-separated replica base urls")
    ap.add_argument("--hedge-ms", type=float, default=None,
                    help="hedge delay for straggling /report primaries "
                         "(0/unset = off; REPORTER_HEDGE_MS overrides)")
    args = ap.parse_args(argv)
    urls = [u.strip() for u in args.replicas.split(",") if u.strip()]
    router = FleetRouter(urls, hedge_ms=args.hedge_ms)
    router.start()
    httpd = router.make_server(args.host, args.port)
    log.info("fleet router on %s:%d over %d replicas",
             args.host, args.port, len(urls))

    import signal

    def _stop(signum, frame):
        try:
            signal.signal(signum, signal.SIG_DFL)
        except (ValueError, OSError):  # pragma: no cover
            pass
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, _stop)
        except ValueError:  # pragma: no cover
            pass
    try:
        httpd.serve_forever()
    finally:
        router.stop()
        httpd.server_close()
        # the retained hop spans, once nothing records
        obs_flight.shutdown_dump()
        for sig, handler in previous.items():
            if handler is not None:
                signal.signal(sig, handler)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
