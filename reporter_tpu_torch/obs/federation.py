"""Fleet metrics federation: N per-replica observability surfaces read
as ONE system (the port's copy of the JAX package's module of the same
name: same families, labels and behaviour).

Every replica's ``/metrics``, ``/debug/slo`` and ``/statusz`` see one
process, so "what is fleet p99 right now" would take N terminals and a
failover-masked request would be invisible everywhere.  This module is
the aggregation layer, run inside the router (serve/router.py) and the
fleet supervisor (tools/fleet.py):

  Federator     periodically pulls each replica's ``GET /statusz`` —
                which already carries the registry's MERGEABLE JSON
                snapshot (obs/metrics.py snapshot(), the same form the
                batch pipeline merges across spawn workers) plus the
                replica's drain/degraded/SLO state — and keeps the last
                good snapshot per replica.  A dead or draining replica's
                final snapshot is KEPT and labeled stale (rising
                ``reporter_federation_snapshot_age_seconds``), never
                silently dropped: the moment a replica wedges is exactly
                the moment its last numbers matter.

  render        the federated Prometheus text exposition: every family
                from every replica snapshot re-rendered with a
                ``replica`` label prepended, served by the router's
                ``GET /metrics`` next to the router's own families —
                one scrape, one pane of glass.

  FLEET_SLO     the ``reporter_fleet_slo_*`` family bundle the router's
                client-truth SLOEngine pushes (obs/slo.py SLOFamilies):
                the fleet engine classifies the CLIENT-VISIBLE terminal
                outcome, so a request that failed over and succeeded is
                fleet-good even though one replica burned it.

  masking_debt  the delta between the summed replica-level burn rates
                and the fleet-level burn rate, per objective
                (``reporter_fleet_slo_masking_debt``).  Failover hides
                replica badness from clients BY DESIGN; this gauge is
                the explicit bill, so failover churn cannot silently
                hide a rotting replica — a healthy fleet with a rising
                masking debt is one replica loss away from burning for
                real.

Pure stdlib + the sibling obs modules; everything here degrades to
"stale, labeled" on any pull failure — a scrape must never fail because
a replica did.
"""

from __future__ import annotations

import json
import os
import threading
import time as _time
from typing import Dict, List, Optional, Tuple

from . import metrics as obs
from . import slo as obs_slo
from .metrics import _escape, _fmt
from ..utils.httppool import HttpPool

# -- federation surfaces ----------------------------------------------------

G_SNAP_AGE = obs.gauge(
    "reporter_federation_snapshot_age_seconds",
    "Seconds since each replica's metrics snapshot was last pulled "
    "successfully (rises while a replica is dead/unreachable; its last "
    "snapshot stays in the federated render, labeled stale)",
    ("replica",))
G_SNAP_STALE = obs.gauge(
    "reporter_federation_snapshot_stale",
    "1 while a replica's federated snapshot is older than the staleness "
    "bound (REPORTER_FEDERATION_STALE_S, default 3x the pull interval), "
    "0 while it is fresh",
    ("replica",))
C_PULLS = obs.counter(
    "reporter_federation_pulls_total",
    "Federation snapshot pull attempts per replica and outcome "
    "(ok / error)",
    ("replica", "outcome"))

# -- the client-truth fleet SLO families ------------------------------------
# same shapes as the per-replica reporter_slo_* families (obs/slo.py), a
# different truth: the router observes the CLIENT-VISIBLE terminal outcome
# of every proxied request, failover and hedging already absorbed.

FLEET_SLO = obs_slo.SLOFamilies(
    obs.counter(
        "reporter_fleet_slo_requests_total",
        "Client-visible terminal outcomes at the router by route and "
        "budget class (good / bad / excluded) — a request that failed "
        "over and succeeded is fleet-good even though one replica "
        "burned it",
        ("route", "slo_class")),
    obs.histogram(
        "reporter_fleet_slo_latency_seconds",
        "Client-visible router latency per route on the shared "
        "SLO_BUCKETS_S axis (failover + hedging included)",
        ("route",), buckets=obs_slo.SLO_BUCKETS_S),
    obs.gauge(
        "reporter_fleet_slo_ok",
        "1 while every fleet objective currently meets its target over "
        "the fleet SLO window, else 0"),
    obs.gauge(
        "reporter_fleet_slo_objective_ok",
        "Per-objective fleet verdict over the SLO window (1 ok / 0 "
        "violating)",
        ("objective",)),
    obs.gauge(
        "reporter_fleet_slo_burn_rate",
        "Fleet error-budget burn rate per objective and window (client "
        "truth: what the fleet actually served, not what any replica "
        "suffered)",
        ("objective", "window")),
    obs.gauge(
        "reporter_fleet_slo_error_budget_remaining",
        "Fraction of the fleet objective's error budget left in the "
        "main SLO window (0 = exhausted)",
        ("objective",)),
)

G_MASKING_DEBT = obs.gauge(
    "reporter_fleet_slo_masking_debt",
    "Summed replica-level burn rate minus the fleet-level burn rate per "
    "objective over the main SLO window — the replica budget that "
    "failover masking is spending invisibly to clients (0 = nothing "
    "masked; rising = a replica is rotting behind successful failovers)",
    ("objective",))

G_FLEET_QUALITY = obs.gauge(
    "reporter_fleet_quality_agreement",
    "Fleet-wide shadow-oracle agreement aggregated from every replica's "
    "statusz quality line (docs/match-quality.md): stat=mean is the "
    "across-replica mean, stat=min the worst replica — a fleet whose min "
    "diverges from its mean has ONE replica mismatching, not a model "
    "regression",
    ("stat",))


def _env_num(name: str, default: float) -> float:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return float(default)


def snapshot_scalar(snap: dict, name: str,
                    labels: Tuple[str, ...] = ()) -> Optional[float]:
    """One scalar sample out of a registry snapshot dict (None when the
    family or the label combination is absent)."""
    fam = (snap or {}).get(name)
    if not fam:
        return None
    want = [str(v) for v in labels]
    for lv, sample in fam.get("samples", ()):
        if list(lv) == want and not isinstance(sample, dict):
            return float(sample)
    return None


def snapshot_total(snap: dict, name: str,
                   match: Optional[Dict[str, str]] = None) -> Optional[float]:
    """Sum every scalar sample of a family in a registry snapshot,
    optionally filtered by label values ({"state": "serving"}) — how the
    router rolls a replica's per-state cost counters up to one number.
    None when the family is absent entirely."""
    fam = (snap or {}).get(name)
    if not fam:
        return None
    names = list(fam.get("labelnames", ()))
    total = 0.0
    seen = False
    for lv, sample in fam.get("samples", ()):
        if isinstance(sample, dict):
            continue
        if match:
            d = dict(zip(names, lv))
            if any(d.get(k) != str(v) for k, v in match.items()):
                continue
        total += float(sample)
        seen = True
    return total if seen else None


def render_snapshots(snaps: Dict[str, dict],
                     skip_meta: Optional[set] = None) -> str:
    """Federated Prometheus text: every family from every replica's
    registry snapshot, with a ``replica`` label prepended to each
    sample.  ``skip_meta`` suppresses duplicate # HELP/# TYPE lines for
    families the caller already rendered from its own registry (the
    router's /metrics concatenates both)."""
    skip_meta = skip_meta or set()
    # family name -> (kind, help, labelnames, [(replica, labelvalues, sample)])
    fams: Dict[str, list] = {}
    for rid in sorted(snaps):
        snap = snaps[rid] or {}
        for name in sorted(snap):
            fam = snap[name]
            ent = fams.get(name)
            if ent is None:
                ent = fams[name] = [fam.get("type", "gauge"),
                                    fam.get("help", ""),
                                    list(fam.get("labelnames", [])), []]
            elif ent[0] != fam.get("type", "gauge"):
                continue  # mixed-version fleet: skip the odd one out
            for lv, sample in fam.get("samples", ()):
                ent[3].append((rid, list(lv), sample))
    out: List[str] = []
    for name in sorted(fams):
        kind, help_, labelnames, rows = fams[name]
        if name not in skip_meta:
            out.append("# HELP %s %s" % (name, help_.replace("\n", " ")))
            out.append("# TYPE %s %s" % (name, kind))
        for rid, lv, sample in rows:
            pairs = ['replica="%s"' % _escape(rid)] + [
                '%s="%s"' % (n, _escape(v))
                for n, v in zip(labelnames, lv)]
            base = ",".join(pairs)
            if kind == "histogram" and isinstance(sample, dict):
                cum = 0
                for bound, c in zip(sample["buckets"], sample["counts"]):
                    cum += c
                    out.append('%s_bucket{%s,le="%s"} %s'
                               % (name, base, _fmt(bound), _fmt(cum)))
                out.append('%s_bucket{%s,le="+Inf"} %s'
                           % (name, base, _fmt(sample["count"])))
                out.append("%s_sum{%s} %s" % (name, base,
                                              _fmt(sample["sum"])))
                out.append("%s_count{%s} %s" % (name, base,
                                                _fmt(sample["count"])))
            elif not isinstance(sample, dict):
                out.append("%s{%s} %s" % (name, base, _fmt(sample)))
    return "\n".join(out) + ("\n" if out else "")


class ReplicaFeed:
    """One replica's last-known observability state, as federated."""

    __slots__ = ("url", "rid", "statusz", "t_ok", "t_unix", "ok", "error")

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.rid: Optional[str] = None       # learned from the statusz body
        self.statusz: Optional[dict] = None  # last GOOD pull, kept on failure
        self.t_ok: Optional[float] = None    # monotonic of the last good pull
        self.t_unix: Optional[float] = None
        self.ok = False                      # did the LAST attempt succeed
        self.error: Optional[str] = None

    @property
    def label(self) -> str:
        return self.rid or self.url

    def age_s(self, now: Optional[float] = None) -> Optional[float]:
        if self.t_ok is None:
            return None
        return max(0.0, (_time.monotonic() if now is None else now)
                   - self.t_ok)

    def metrics_snapshot(self) -> dict:
        return (self.statusz or {}).get("metrics") or {}


class Federator:
    """Owns the pull loop and the per-replica feeds.  ``export_gauges``
    (a scrape-time collector) publishes the staleness surfaces; the
    caller renders ``render_snapshots(self.snapshots())`` next to its own
    registry."""

    def __init__(self, urls: List[str],
                 pull_interval_s: Optional[float] = None,
                 timeout_s: Optional[float] = None,
                 stale_after_s: Optional[float] = None,
                 pool: Optional[HttpPool] = None,
                 fleet_engine: "Optional[obs_slo.SLOEngine]" = None):
        self.pull_interval_s = max(0.05, _env_num(
            "REPORTER_FEDERATION_PULL_S",
            2.0 if pull_interval_s is None else pull_interval_s))
        self.timeout_s = _env_num(
            "REPORTER_FEDERATION_TIMEOUT_S",
            5.0 if timeout_s is None else timeout_s)
        self.stale_after_s = _env_num(
            "REPORTER_FEDERATION_STALE_S",
            3.0 * self.pull_interval_s if stale_after_s is None
            else stale_after_s)
        self.pool = pool or HttpPool(max_idle_per_host=4)
        self._own_pool = pool is None
        # the router's client-truth fleet SLOEngine: each pull feeds every
        # replica's windowed agreement value into its "agreement" sample
        # series, so the quality objective federates onto the
        # reporter_fleet_slo_* plane next to availability/latency
        # (docs/match-quality.md "Fleet view")
        self.fleet_engine = fleet_engine
        self._feeds = [ReplicaFeed(u) for u in urls]
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self.pull_all()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="federation-pull")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._own_pool:
            self.pool.close()

    def add_target(self, url: str) -> None:
        """Grow the federation to a scaled-up replica (idempotent); its
        first pull happens on the next loop tick."""
        url = url.rstrip("/")
        with self._lock:
            if not any(f.url == url for f in self._feeds):
                self._feeds = self._feeds + [ReplicaFeed(url)]

    def remove_target(self, key: str) -> None:
        """Drop a scaled-down replica's feed (by url or learned replica
        id).  Its last-rendered numbers disappear from the federated
        scrape — deliberate for a scale-DOWN: the replica left the fleet
        on purpose, unlike a death, which keeps its stale snapshot."""
        key = str(key).rstrip("/")
        with self._lock:
            self._feeds = [f for f in self._feeds
                           if f.url != key and f.label != key]

    def _loop(self) -> None:
        while not self._stop.wait(self.pull_interval_s):
            self.pull_all()

    # -- pulls --------------------------------------------------------------

    def pull_all(self) -> None:
        with self._lock:
            feeds = list(self._feeds)
        for feed in feeds:
            self._pull_one(feed)

    def _pull_one(self, feed: ReplicaFeed) -> None:
        try:
            status, _hdrs, body = self.pool.request(
                "GET", feed.url + "/statusz", timeout=self.timeout_s,
                target="federation")
            if status != 200:
                raise RuntimeError("statusz answered %d" % status)
            statusz = json.loads(body.decode("utf-8"))
        except Exception as e:  # noqa: BLE001 - a dead replica is data
            feed.ok = False
            feed.error = str(e)[:200]
            C_PULLS.labels(feed.label, "error").inc()
            return
        with self._lock:
            feed.statusz = statusz
            rid = statusz.get("replica")
            if rid:
                feed.rid = str(rid)
            feed.t_ok = _time.monotonic()
            feed.t_unix = _time.time()
            feed.ok = True
            feed.error = None
        C_PULLS.labels(feed.label, "ok").inc()
        self._feed_fleet_quality(statusz)

    def _feed_fleet_quality(self, statusz: dict) -> None:
        """Relay a freshly-pulled replica's windowed agreement value into
        the fleet SLO engine's sample series (one sample per pull per
        replica, so the fleet mean weights replicas equally regardless of
        their sampling cadence).  Ensures the fleet engine carries an
        agreement objective at the replica's own target."""
        eng = self.fleet_engine
        if eng is None:
            return
        try:
            agr = ((statusz.get("slo") or {}).get("objectives")
                   or {}).get("agreement")
            if not agr or agr.get("value") is None:
                return
            if not any(o.kind == "agreement" for o in eng.objectives):
                eng.objectives.append(obs_slo.Objective(
                    "agreement", "agreement",
                    float(agr.get("target") or 0.9)))
            eng.observe_sample("agreement", float(agr["value"]))
        except Exception:  # noqa: BLE001 - a pull must never fail on this
            pass

    # -- read paths ----------------------------------------------------------

    def feeds(self) -> List[ReplicaFeed]:
        return list(self._feeds)

    def snapshots(self) -> Dict[str, dict]:
        """replica_id -> metrics snapshot (the last GOOD one per replica:
        a dead replica keeps contributing its final numbers, labeled
        stale by the gauges — never silently dropped).  When two feeds
        claim one replica id (a respawn at a new url) the freshest
        wins."""
        by_rid: Dict[str, ReplicaFeed] = {}
        with self._lock:
            for feed in self._feeds:
                if feed.statusz is None:
                    continue
                cur = by_rid.get(feed.label)
                if cur is None or (feed.t_ok or 0) > (cur.t_ok or 0):
                    by_rid[feed.label] = feed
        return {rid: f.metrics_snapshot() for rid, f in by_rid.items()}

    def ages(self, known_only: bool = False) -> Dict[str, dict]:
        """Per-replica snapshot freshness.  ``known_only`` drops feeds
        that have never answered (no replica id yet): the gauge exporter
        uses it so a not-yet-pulled feed cannot mint a url-labeled gauge
        child that then lingers on /metrics forever."""
        now = _time.monotonic()
        out = {}
        for feed in self._feeds:
            if known_only and feed.rid is None:
                continue
            age = feed.age_s(now)
            out[feed.label] = {
                "url": feed.url,
                "age_s": round(age, 3) if age is not None else None,
                "stale": (age is None or age > self.stale_after_s),
                "last_error": feed.error,
            }
        return out

    def render(self, skip_meta: Optional[set] = None) -> str:
        return render_snapshots(self.snapshots(), skip_meta=skip_meta)

    # -- published gauges ----------------------------------------------------

    def export_gauges(self) -> None:
        """Scrape-time collector: staleness per replica.  Never raises —
        a scrape must not fail because a replica did."""
        try:
            for rid, st in self.ages(known_only=True).items():
                age = st["age_s"]
                G_SNAP_AGE.labels(rid).set(-1.0 if age is None else age)
                G_SNAP_STALE.labels(rid).set(1.0 if st["stale"] else 0.0)
        except Exception:  # noqa: BLE001
            pass

    def masking_debt(self, engine: obs_slo.SLOEngine) -> Dict[str, float]:
        """Per objective: sum of the replicas' own burn rates (their
        ``reporter_slo_burn_rate`` gauges over the main window, read out
        of the federated snapshots) minus the fleet engine's burn rate
        over the same window, floored at 0.  The replica sum counts
        every burn each replica suffered; the fleet rate counts only
        what clients saw — the difference is what failover masked."""
        win = "%ds" % int(engine.window_s)
        out: Dict[str, float] = {}
        snaps = self.snapshots()
        for o in engine.objectives:
            replica_sum = 0.0
            for snap in snaps.values():
                v = snapshot_scalar(snap, "reporter_slo_burn_rate",
                                    (o.name, win))
                if v is not None:
                    replica_sum += v
            fleet = engine.burn_rate(o, engine.window_s)
            out[o.name] = round(max(0.0, replica_sum - fleet), 4)
        return out

    def export_masking_debt(self, engine: obs_slo.SLOEngine) -> None:
        try:
            for name, debt in self.masking_debt(engine).items():
                G_MASKING_DEBT.labels(name).set(debt)
        except Exception:  # noqa: BLE001 - a scrape must never fail
            pass

    def fleet_quality(self) -> dict:
        """Per-replica windowed agreement (each feed's last statusz
        quality/slo line — a dead replica's final value stays, like the
        snapshots) plus the across-replica mean and min.  The min matters
        operationally: one replica mismatching (bad table shard, stale
        build) drags min, not mean."""
        per: Dict[str, Optional[float]] = {}
        with self._lock:
            feeds = [(f.label, f.statusz) for f in self._feeds
                     if f.statusz is not None]
        for label, statusz in feeds:
            agr = ((statusz.get("slo") or {}).get("objectives")
                   or {}).get("agreement") or {}
            per[label] = agr.get("value")
        vals = [v for v in per.values() if v is not None]
        return {
            "replicas": per,
            "mean": round(sum(vals) / len(vals), 4) if vals else None,
            "min": round(min(vals), 4) if vals else None,
        }

    def export_fleet_quality(self) -> None:
        """Scrape-time collector for the reporter_fleet_quality_agreement
        gauge pair (-1 = no replica has reported agreement yet, matching
        the attrib-age convention for \"no data\")."""
        try:
            fq = self.fleet_quality()
            G_FLEET_QUALITY.labels("mean").set(
                -1.0 if fq["mean"] is None else fq["mean"])
            G_FLEET_QUALITY.labels("min").set(
                -1.0 if fq["min"] is None else fq["min"])
        except Exception:  # noqa: BLE001 - a scrape must never fail
            pass

    # -- the fleet supervisor's dump (tools/fleet.py) ------------------------

    def dump(self, path: str, extra: Optional[dict] = None) -> None:
        """Write one federated JSON artifact (per-replica ages + merged
        snapshot + per-replica snapshots) atomically — the supervisor's
        file-based pane of glass for harnesses that cannot scrape."""
        snaps = self.snapshots()
        merged: dict = {}
        try:
            merged = obs.merge(*snaps.values()) if snaps else {}
        except ValueError:
            merged = {}  # mixed-version fleet: per-replica still rides
        state = {
            "t_unix": round(_time.time(), 3),
            "pull_interval_s": self.pull_interval_s,
            "stale_after_s": self.stale_after_s,
            "replicas": self.ages(),
            "merged": merged,
            "snapshots": snaps,
        }
        if extra:
            state.update(extra)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, separators=(",", ":"))
        os.replace(tmp, path)
