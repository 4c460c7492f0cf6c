"""Server-side SLO engine: declarative objectives, sliding-window
accounting, and error-budget burn rates over every terminal request
outcome (docs/observability.md "The SLO engine").

Metrics, tracing and fault containment say what happened; this module
STATES an objective and measures against it continuously:

  * **Objectives** are declarative: availability (fraction of
    against-budget-eligible requests that succeeded), latency (a pinned
    quantile per route must sit under a target), and degraded-mode
    fraction (how much of the traffic the CPU fallback may carry).
    Defaults are modest and every knob has a config + env override.

  * **Classification** of each terminal outcome is a documented policy
    (``classify``): 2xx burns nothing, 429/500/503/504 burn budget, and
    client faults (400 invalid, 422 quarantined) are excluded — the
    full table lives in docs/observability.md, and serve/service.py
    feeds every terminal outcome (success, degraded, shed, expired,
    quarantined, poison) through ``observe``.  A shed 429 deliberately
    burns budget: admission control protects the latency objective by
    SPENDING availability budget, and an SLO that excluded sheds could
    be trivially met by shedding everything.

  * **Windows** are sliding: per-second epoch buckets in a bounded ring,
    aggregated on demand over any window up to the configured maximum —
    counts per (route, class) plus a log-bucketed latency histogram per
    route on the shared ``quantile.SLO_BUCKETS_S`` axis, so windowed
    quantiles here, the loadgen's client-side quantiles, and trace_top
    all share one bucket table and one interpolation rule.

  * **Error budget** accounting is multi-window: ``burn_rate`` is
    budget consumption speed (1.0 = exactly spending the window's
    budget), and alerting uses fast/slow *pairs* AND-gated the SRE-book
    way — a pair fires only when BOTH its short and long window burn
    above the pair's factor, so a single bad second cannot page and a
    slow leak still does.

  * **Verdict**: ``report()`` renders every objective's current value,
    target, burn rates, remaining budget and ok-flag plus the AND of
    them all — served at ``GET /debug/slo``, summarised as a burn-rate
    line in ``/statusz``, exported as ``reporter_slo_*`` gauge families,
    and asserted by the CI slo-rehearsal leg via tools/loadgen.py.

Violating trace_ids are retained: each against-budget or
tail-contributing request's id lands in a bounded ring (surfaced in the
``report()``), and the caller gets the violated objective names back so
it can mark the span for the flight recorder's keep-ring
(``obs/flight.py`` retains ``slo_violation``-marked spans like errors).
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from . import metrics as obs
from .quantile import SLO_BUCKETS_S, bucket_index, cumulate, hist_quantile

# -- budget classes ---------------------------------------------------------

GOOD = "good"          # served correctly (incl. degraded: the service answered)
BAD = "bad"            # burns error budget
EXCLUDED = "excluded"  # client faults: never burns budget, never counts

# metric families (docs/observability.md "The SLO engine")
C_SLO_REQ = obs.counter(
    "reporter_slo_requests_total",
    "Terminal request outcomes by route and budget class (good / bad / "
    "excluded, per the documented classification policy)",
    ("route", "slo_class"))
H_SLO_LAT = obs.histogram(
    "reporter_slo_latency_seconds",
    "Terminal request latency per route on the shared SLO bucket axis "
    "(budget-eligible outcomes only; excluded client faults do not "
    "pollute the tail)",
    ("route",), buckets=SLO_BUCKETS_S)
G_SLO_OK = obs.gauge(
    "reporter_slo_ok",
    "1 while every configured objective currently meets its target over "
    "the SLO window, else 0")
G_OBJ_OK = obs.gauge(
    "reporter_slo_objective_ok",
    "Per-objective verdict over the SLO window (1 ok / 0 violating)",
    ("objective",))
G_BURN = obs.gauge(
    "reporter_slo_burn_rate",
    "Error-budget burn rate per objective and window (1.0 = spending "
    "exactly the window's budget; the alert pairs AND-gate a fast and a "
    "slow window)",
    ("objective", "window"))
G_BUDGET = obs.gauge(
    "reporter_slo_error_budget_remaining",
    "Fraction of the objective's error budget left in the main SLO "
    "window (0 = exhausted)",
    ("objective",))


class SLOFamilies:
    """The metric families one engine instruments.  The per-replica serve
    engine pushes the ``reporter_slo_*`` defaults below; the router's
    client-truth fleet engine passes its own ``reporter_fleet_slo_*``
    bundle (obs/federation.py) so both verdicts live side by side on one
    scrape without colliding."""

    __slots__ = ("requests", "latency", "ok", "objective_ok", "burn",
                 "budget")

    def __init__(self, requests, latency, ok, objective_ok, burn, budget):
        self.requests = requests
        self.latency = latency
        self.ok = ok
        self.objective_ok = objective_ok
        self.burn = burn
        self.budget = budget


FAMILIES = SLOFamilies(C_SLO_REQ, H_SLO_LAT, G_SLO_OK, G_OBJ_OK, G_BURN,
                       G_BUDGET)


def classify(code: int, degraded: bool = False) -> str:
    """HTTP status -> budget class, the documented policy
    (docs/observability.md "SLO budget policy"):

      2xx                    good  (degraded:true stays good for
                                    availability — the service DID answer
                                    — and is tracked by the
                                    degraded-fraction objective)
      429 shed               bad   (shedding protects latency by
                                    spending availability budget)
      500 poison/error       bad
      503 unattached/wedged  bad
      504 deadline expired   bad
      422 quarantined        excluded (repeat-poison client fault)
      400 invalid            excluded (malformed request)
      other 4xx              excluded (client fault)
      anything else          bad
    """
    code = int(code)
    if 200 <= code < 300:
        return GOOD
    if code == 429:
        return BAD
    if 400 <= code < 500:
        return EXCLUDED
    return BAD


@dataclass(frozen=True)
class Objective:
    """One declarative objective.

    kind "availability":      good / (good + bad) >= target
    kind "latency":           quantile(q) of eligible latencies <= target
                              seconds
    kind "degraded_fraction": degraded / (good + bad) <= target
    kind "agreement":         weighted mean of the "agreement" sample
                              series (shadow-oracle match agreement fed by
                              obs/quality.py via ``observe_sample``) >=
                              target — the match-QUALITY objective: burn
                              is mean disagreement over the allowed
                              disagreement budget (1 - target)
    ``route=None`` spans all routes."""

    name: str
    kind: str
    target: float
    route: Optional[str] = None
    quantile: float = 0.99

    def __post_init__(self):
        if self.kind not in ("availability", "latency", "degraded_fraction",
                             "agreement"):
            raise ValueError("unknown objective kind %r" % (self.kind,))
        if self.kind == "latency" and not (0.0 < self.quantile < 1.0):
            raise ValueError("latency quantile must be in (0, 1)")

    def budget_fraction(self) -> float:
        """The fraction of eligible traffic this objective allows to be
        non-compliant — the denominator of its burn rate."""
        if self.kind in ("availability", "agreement"):
            return max(1e-9, 1.0 - self.target)
        if self.kind == "latency":
            return max(1e-9, 1.0 - self.quantile)
        return max(1e-9, self.target)  # degraded_fraction


class _Epoch:
    """One epoch bucket of the sliding window: per-(route, class) counts,
    per-route degraded counts, per-route latency bucket counts, and named
    weighted value series (the quality plane's agreement samples)."""

    __slots__ = ("counts", "degraded", "hist", "samples")

    def __init__(self):
        self.counts: Dict[Tuple[str, str], int] = {}
        self.degraded: Dict[str, int] = {}
        self.hist: Dict[str, List[int]] = {}
        self.samples: Dict[str, List[float]] = {}  # name -> [v*w sum, w sum]


class _Agg:
    """Window aggregate: the epoch sum ``report``/``burn_rate`` read."""

    __slots__ = ("counts", "degraded", "hist", "samples")

    def __init__(self):
        self.counts: Dict[Tuple[str, str], int] = {}
        self.degraded: Dict[str, int] = {}
        self.hist: Dict[str, List[int]] = {}
        self.samples: Dict[str, List[float]] = {}

    def _routes(self) -> set:
        return {r for r, _c in self.counts}

    def n(self, cls: str, route: Optional[str] = None) -> int:
        return sum(v for (r, c), v in self.counts.items()
                   if c == cls and (route is None or r == route))

    def eligible(self, route: Optional[str] = None) -> int:
        return self.n(GOOD, route) + self.n(BAD, route)

    def n_degraded(self, route: Optional[str] = None) -> int:
        return sum(v for r, v in self.degraded.items()
                   if route is None or r == route)

    def hist_sum(self, route: Optional[str] = None) -> List[int]:
        out = [0] * (len(SLO_BUCKETS_S) + 1)
        for r, h in self.hist.items():
            if route is None or r == route:
                for i, c in enumerate(h):
                    out[i] += c
        return out

    def quantile(self, q: float, route: Optional[str] = None) -> Optional[float]:
        return hist_quantile(cumulate(SLO_BUCKETS_S, self.hist_sum(route)), q)

    def sample_mean(self, name: str) -> Optional[float]:
        """Weighted mean of a value series over the window; None with no
        samples (vacuously compliant, like an idle route)."""
        vw = self.samples.get(name)
        if not vw or vw[1] <= 0:
            return None
        return vw[0] / vw[1]

    def sample_weight(self, name: str) -> float:
        vw = self.samples.get(name)
        return vw[1] if vw else 0.0

    def over_target(self, target_s: float, route: Optional[str] = None) -> int:
        """Observations in buckets strictly above the bucket containing
        ``target_s`` — the threshold-count form of a latency objective
        (conservative by at most one bucket, documented)."""
        h = self.hist_sum(route)
        cut = bucket_index(SLO_BUCKETS_S, target_s)
        return sum(h[cut + 1:])


class SLOEngine:
    """Sliding-window SLO accounting.  Thread-safe; ``clock`` is
    injectable (property tests drive window roll-off deterministically).

    ``burn_pairs`` is a sequence of ``(short_s, long_s, factor)``
    triples: the pair alerts only when burn(short) > factor AND
    burn(long) > factor (multi-window AND-gating)."""

    def __init__(self, objectives: Optional[Sequence[Objective]] = None,
                 window_s: float = 300.0, epoch_s: float = 1.0,
                 burn_pairs: Optional[Sequence[Tuple[float, float, float]]] = None,
                 ring: int = 64, instrument: bool = True,
                 clock=time.monotonic,
                 families: Optional[SLOFamilies] = None):
        self.objectives: List[Objective] = list(
            default_objectives() if objectives is None else objectives)
        self.window_s = float(window_s)
        self.epoch_s = max(0.05, float(epoch_s))
        if burn_pairs is None:
            # fast pair catches a sharp burn (factor 6 over window/10),
            # slow pair catches steady exhaustion (factor 1 over the
            # full window); both AND-gate against the long window
            burn_pairs = (
                (max(self.epoch_s, self.window_s / 10.0), self.window_s, 6.0),
                (max(self.epoch_s, self.window_s / 2.0), self.window_s, 1.0),
            )
        self.burn_pairs = tuple(
            (float(s), float(l), float(f)) for s, l, f in burn_pairs)
        self._max_window = max(
            [self.window_s] + [l for _s, l, _f in self.burn_pairs]
            + [s for s, _l, _f in self.burn_pairs])
        self._clock = clock
        # which families this engine pushes: explicit bundle > the global
        # reporter_slo_* defaults (instrument=True) > none (client-side
        # evaluation, e.g. tools/loadgen.py)
        self._families = families if families is not None else (
            FAMILIES if instrument else None)
        self._lock = threading.Lock()
        self._epochs: "OrderedDict[int, _Epoch]" = OrderedDict()
        self.violating: "deque[dict]" = deque(maxlen=max(1, ring))
        self._t_start = clock()

    # -- write path --------------------------------------------------------

    def observe(self, route: str, code: int, latency_s: Optional[float],
                degraded: bool = False, trace_id: Optional[str] = None,
                now: Optional[float] = None) -> List[str]:
        """Feed one terminal request outcome.  Returns the names of the
        objectives this single request violated or contributed tail to
        (empty for compliant traffic) — callers mark the span so the
        flight recorder retains the trace_id."""
        now = self._clock() if now is None else now
        cls = classify(code, degraded)
        route = str(route)
        ep_key = int(now / self.epoch_s)
        with self._lock:
            ep = self._epochs.get(ep_key)
            if ep is None:
                ep = self._epochs[ep_key] = _Epoch()
                self._prune(now)
            k = (route, cls)
            ep.counts[k] = ep.counts.get(k, 0) + 1
            if degraded:
                ep.degraded[route] = ep.degraded.get(route, 0) + 1
            if cls != EXCLUDED and latency_s is not None:
                h = ep.hist.get(route)
                if h is None:
                    h = ep.hist[route] = [0] * (len(SLO_BUCKETS_S) + 1)
                h[bucket_index(SLO_BUCKETS_S, latency_s)] += 1
        fams = self._families
        if fams is not None:
            fams.requests.labels(route, cls).inc()
            if cls != EXCLUDED and latency_s is not None:
                fams.latency.labels(route).observe(latency_s,
                                                   exemplar=trace_id)
        violated = self._violations(route, code, cls, latency_s)
        if violated:
            self.violating.append({
                "trace_id": trace_id,
                "route": route,
                "code": int(code),
                "latency_ms": (round(latency_s * 1000.0, 1)
                               if latency_s is not None else None),
                "objectives": violated,
                "t_unix": round(time.time(), 3),
            })
        return violated

    def observe_sample(self, name: str, value: float, weight: float = 1.0,
                       now: Optional[float] = None) -> None:
        """Feed one weighted value sample into a named series — the
        non-request signal plane (shadow-oracle agreement: value = the
        sample's agreement fraction, weight = points compared).  Series
        aggregate as weighted means over the same sliding epochs the
        request counters use, so the agreement objective gets the same
        multi-window burn-rate machinery for free."""
        if weight <= 0:
            return
        now = self._clock() if now is None else now
        ep_key = int(now / self.epoch_s)
        with self._lock:
            ep = self._epochs.get(ep_key)
            if ep is None:
                ep = self._epochs[ep_key] = _Epoch()
                self._prune(now)
            vw = ep.samples.get(name)
            if vw is None:
                vw = ep.samples[name] = [0.0, 0.0]
            vw[0] += float(value) * float(weight)
            vw[1] += float(weight)

    def _violations(self, route: str, code: int, cls: str,
                    latency_s: Optional[float]) -> List[str]:
        out = []
        for o in self.objectives:
            if o.route is not None and o.route != route:
                continue
            if o.kind == "availability" and cls == BAD:
                out.append(o.name)
            elif (o.kind == "latency" and cls != EXCLUDED
                    and latency_s is not None and latency_s > o.target):
                # a single request cannot violate a quantile, but it IS a
                # tail contributor over the objective's target — retained
                # so the tail is explainable by trace_id
                out.append(o.name)
        return out

    def _prune(self, now: float) -> None:
        # called under self._lock: drop epochs older than the largest
        # window anyone can ask about (roll-off)
        horizon = int((now - self._max_window) / self.epoch_s) - 1
        while self._epochs:
            k = next(iter(self._epochs))
            if k >= horizon:
                break
            del self._epochs[k]

    # -- read paths --------------------------------------------------------

    def window(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> _Agg:
        """Aggregate the epochs inside the trailing window."""
        now = self._clock() if now is None else now
        w = self.window_s if window_s is None else min(
            float(window_s), self._max_window)
        lo = int((now - w) / self.epoch_s)
        hi = int(now / self.epoch_s)
        agg = _Agg()
        with self._lock:
            for k, ep in self._epochs.items():
                if k <= lo or k > hi:
                    continue
                for kk, v in ep.counts.items():
                    agg.counts[kk] = agg.counts.get(kk, 0) + v
                for r, v in ep.degraded.items():
                    agg.degraded[r] = agg.degraded.get(r, 0) + v
                for r, h in ep.hist.items():
                    dst = agg.hist.get(r)
                    if dst is None:
                        dst = agg.hist[r] = [0] * len(h)
                    for i, c in enumerate(h):
                        dst[i] += c
                for name, vw in ep.samples.items():
                    dst_vw = agg.samples.get(name)
                    if dst_vw is None:
                        dst_vw = agg.samples[name] = [0.0, 0.0]
                    dst_vw[0] += vw[0]
                    dst_vw[1] += vw[1]
        return agg

    def _bad_fraction(self, o: Objective, agg: _Agg) -> Optional[float]:
        """The objective's non-compliant traffic fraction in ``agg``;
        None with no eligible traffic (vacuously compliant)."""
        if o.kind == "agreement":
            # mean disagreement — an objective over the sample series, not
            # the request counters, so it needs no request traffic
            mean = agg.sample_mean("agreement")
            if mean is None:
                return None
            return min(1.0, max(0.0, 1.0 - mean))
        n = agg.eligible(o.route)
        if n <= 0:
            return None
        if o.kind == "availability":
            return agg.n(BAD, o.route) / n
        if o.kind == "degraded_fraction":
            return agg.n_degraded(o.route) / n
        return agg.over_target(o.target, o.route) / n  # latency

    def burn_rate(self, o: Objective, window_s: float,
                  now: Optional[float] = None) -> float:
        """Budget consumption speed over the window: 1.0 = spending
        exactly the window's budget, >1 = on track to exhaust it early.
        0.0 with no traffic (an idle service burns nothing)."""
        frac = self._bad_fraction(o, self.window(window_s, now))
        if frac is None:
            return 0.0
        return frac / o.budget_fraction()

    def pair_alerting(self, o: Objective,
                      now: Optional[float] = None) -> Tuple[bool, Dict[str, float]]:
        """The multi-window AND gate, reusable outside ``report()`` (the
        fleet autoscaler steers by exactly this math): for each
        ``(short, long, factor)`` pair, BOTH windows must burn above the
        pair's factor for it to page — a burst alone cannot, a slow leak
        still does.  Returns (alerting, {window_label: burn_rate})."""
        now = self._clock() if now is None else now
        burns: Dict[str, float] = {}
        alerting = False
        for short_s, long_s, factor in self.burn_pairs:
            bs = self.burn_rate(o, short_s, now)
            bl = self.burn_rate(o, long_s, now)
            burns["%ds" % int(short_s)] = round(bs, 4)
            burns["%ds" % int(long_s)] = round(bl, 4)
            alerting = alerting or (bs > factor and bl > factor)
        return alerting, burns

    def _objective_state(self, o: Objective, now: float) -> dict:
        agg = self.window(None, now)
        if o.kind == "latency":
            value = agg.quantile(o.quantile, o.route)
            ok = value is None or value <= o.target
        elif o.kind == "availability":
            frac = self._bad_fraction(o, agg)
            value = None if frac is None else 1.0 - frac
            ok = value is None or value >= o.target
        elif o.kind == "agreement":
            value = agg.sample_mean("agreement")
            ok = value is None or value >= o.target
        else:
            value = self._bad_fraction(o, agg)
            ok = value is None or value <= o.target
        alerting, burns = self.pair_alerting(o, now)
        budget_remaining = max(0.0, 1.0 - self.burn_rate(o, self.window_s, now))
        out = {
            "name": o.name,
            "kind": o.kind,
            "route": o.route,
            "target": o.target,
            "quantile": o.quantile if o.kind == "latency" else None,
            "value": (round(value, 6) if isinstance(value, float) else value),
            "ok": bool(ok),
            "burn": burns,
            "budget_remaining": round(budget_remaining, 4),
            "alerting": bool(alerting),
        }
        if o.kind == "agreement":
            # compared-point weight behind the mean: a gate reading this
            # verdict can judge statistical strength, not just the value
            out["sample_weight"] = round(agg.sample_weight("agreement"), 1)
        return out

    def report(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> dict:
        """The full verdict: per-route traffic + quantiles, per-objective
        state, the AND verdict, and the violating-trace ring."""
        now = self._clock() if now is None else now
        agg = self.window(window_s, now)
        routes = {}
        for r in sorted(agg._routes()):
            routes[r] = {
                GOOD: agg.n(GOOD, r),
                BAD: agg.n(BAD, r),
                EXCLUDED: agg.n(EXCLUDED, r),
                "degraded": agg.n_degraded(r),
            }
            for q, key in ((0.50, "p50_ms"), (0.95, "p95_ms"),
                           (0.99, "p99_ms"), (0.999, "p999_ms")):
                v = agg.quantile(q, r)
                routes[r][key] = round(v * 1000.0, 1) if v is not None else None
        objectives = [self._objective_state(o, now) for o in self.objectives]
        ok = all(o["ok"] for o in objectives)
        return {
            "window_s": self.window_s if window_s is None else float(window_s),
            "uptime_s": round(now - self._t_start, 1),
            "ok": ok,
            "verdict": "ok" if ok else "violating",
            "objectives": objectives,
            "routes": routes,
            "burn_pairs": [list(p) for p in self.burn_pairs],
            "violating_traces": list(self.violating),
            "buckets_per_decade": 12,
        }

    def summary(self, now: Optional[float] = None) -> dict:
        """The /statusz burn-rate line: one compact row per objective."""
        rep = self.report(now=now)
        return {
            "ok": rep["ok"],
            "window_s": rep["window_s"],
            "objectives": {
                o["name"]: {
                    "value": o["value"], "target": o["target"],
                    "ok": o["ok"], "burn": o["burn"],
                    "budget_remaining": o["budget_remaining"],
                    "alerting": o["alerting"],
                }
                for o in rep["objectives"]
            },
            "violating_retained": len(self.violating),
        }

    def export_gauges(self) -> None:
        """Push the verdict/burn gauges into this engine's families
        (registered as a scrape-time collector for the global engine and
        for the router's fleet engine)."""
        fams = self._families
        if fams is None:
            return
        try:
            now = self._clock()
            all_ok = True
            for o in self.objectives:
                st = self._objective_state(o, now)
                all_ok = all_ok and st["ok"]
                fams.objective_ok.labels(o.name).set(1.0 if st["ok"] else 0.0)
                fams.budget.labels(o.name).set(st["budget_remaining"])
                for win, rate in st["burn"].items():
                    fams.burn.labels(o.name, win).set(rate)
            fams.ok.set(1.0 if all_ok else 0.0)
        except Exception:  # noqa: BLE001 - a scrape must never fail
            pass


# -- configuration ----------------------------------------------------------

def _env_float(name: str, default: Optional[float]) -> Optional[float]:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


def default_objectives() -> List[Objective]:
    """The stock objectives, env-tunable so the CI rehearsal can state
    modest CPU-scale targets without a config file:

      REPORTER_SLO_AVAILABILITY   min good fraction      (default 0.99)
      REPORTER_SLO_P99_MS         p99 latency target ms  (default 2500)
      REPORTER_SLO_P999_MS        p99.9 target ms        (default 10000)
      REPORTER_SLO_DEGRADED_FRAC  max degraded fraction  (default 0.25)
      REPORTER_SLO_STREAM_P99_MS  per-POINT p99 target ms for the
                                  streaming session route
                                  ("report_stream"; default 0 = off) —
                                  the objective the session matcher's
                                  point-latency win is gated against
                                  (docs/performance.md "The session
                                  matcher")

    A value <= 0 drops that objective."""
    out: List[Objective] = []
    avail = _env_float("REPORTER_SLO_AVAILABILITY", 0.99)
    if avail and avail > 0:
        out.append(Objective("availability", "availability", float(avail)))
    p99 = _env_float("REPORTER_SLO_P99_MS", 2500.0)
    if p99 and p99 > 0:
        out.append(Objective("p99_latency", "latency", p99 / 1000.0,
                             quantile=0.99))
    sp99 = _env_float("REPORTER_SLO_STREAM_P99_MS", 0.0)
    if sp99 and sp99 > 0:
        out.append(Objective("stream_p99_latency", "latency", sp99 / 1000.0,
                             route="report_stream", quantile=0.99))
    p999 = _env_float("REPORTER_SLO_P999_MS", 10000.0)
    if p999 and p999 > 0:
        out.append(Objective("p999_latency", "latency", p999 / 1000.0,
                             quantile=0.999))
    degr = _env_float("REPORTER_SLO_DEGRADED_FRAC", 0.25)
    if degr and degr > 0:
        out.append(Objective("degraded_fraction", "degraded_fraction",
                             float(degr)))
    # the match-QUALITY objective (docs/match-quality.md): off by default
    # — it only means something with shadow-oracle sampling feeding the
    # "agreement" series, and obs/quality.configure() ensures it exists
    # whenever sampling is on (at this env target, default 0.90 there)
    agree = _env_float("REPORTER_SLO_AGREEMENT", 0.0)
    if agree and agree > 0:
        out.append(Objective("agreement", "agreement", float(agree)))
    return out


def objectives_from_spec(spec: Optional[dict]) -> List[Objective]:
    """Service-config "slo" block -> objectives.  Shape
    (docs/http-api.md "Service config"):

      {"window_s": 300, "availability": 0.99, "degraded_fraction": 0.25,
       "agreement": 0.90,
       "latency": {"report": {"p99_ms": 2500, "p999_ms": 10000},
                   "*": {"p95_ms": 1000}}}

    The env knobs of ``default_objectives`` override a spec-less boot
    only; an explicit spec is authoritative for the keys it sets."""
    if not spec:
        return default_objectives()
    out: List[Objective] = []
    avail = spec.get("availability")
    if avail:
        out.append(Objective("availability", "availability", float(avail)))
    for route, targets in (spec.get("latency") or {}).items():
        r = None if route in ("*", "") else str(route)
        for key, ms in targets.items():
            if not key.startswith("p") or not key.endswith("_ms"):
                raise ValueError("latency target key %r (want p<q>_ms)" % key)
            q = float("0." + key[1:-3])
            name = "%s_%s" % (route, key[:-3]) if r else key[:-3] + "_latency"
            out.append(Objective(name, "latency", float(ms) / 1000.0,
                                 route=r, quantile=q))
    degr = spec.get("degraded_fraction")
    if degr:
        out.append(Objective("degraded_fraction", "degraded_fraction",
                             float(degr)))
    agree = spec.get("agreement")
    if agree:
        out.append(Objective("agreement", "agreement", float(agree)))
    return out or default_objectives()


# the process-wide engine: serve/service.py feeds it, /debug/slo and
# /statusz read it, and the gauge collector exports it at scrape time
ENGINE = SLOEngine(window_s=_env_float("REPORTER_SLO_WINDOW_S", 300.0))
obs.REGISTRY.register_collect(lambda: ENGINE.export_gauges())


def engine() -> SLOEngine:
    return ENGINE


def configure(spec: Optional[dict]) -> SLOEngine:
    """Replace the global engine's objectives/window from a service-config
    "slo" block (None keeps the env-tuned defaults).  Returns the engine."""
    global ENGINE
    window = _env_float("REPORTER_SLO_WINDOW_S",
                        float((spec or {}).get("window_s", 300.0)))
    ENGINE = SLOEngine(objectives_from_spec(spec), window_s=window)
    return ENGINE


def observe(route: str, code: int, latency_s: Optional[float],
            degraded: bool = False, trace_id: Optional[str] = None) -> List[str]:
    """Feed the global engine (the serve tier's one-liner)."""
    return ENGINE.observe(route, code, latency_s, degraded=degraded,
                          trace_id=trace_id)
