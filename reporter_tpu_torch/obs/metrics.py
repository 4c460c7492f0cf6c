"""Dependency-free, thread-safe metrics registry.

Three instrument kinds — ``Counter``, ``Gauge``, ``Histogram`` — grouped
into labeled *families* (one family per metric name, one child per label
combination), exactly the Prometheus data model, without the client
library: the registry is pure stdlib (the port adds no dependency for
it) and every hot-path operation is one lock + one
float update.

Three read paths:

  render()    Prometheus text exposition (served at ``GET /metrics``)
  snapshot()  a plain-dict form (served at ``GET /statusz``, dumped by the
              batch head's ``--metrics`` flag)
  merge()     combine snapshots from several processes into one — the
              batch pipeline's spawn workers each dump their own registry
              and the head merges them (counters/histograms sum; gauges
              sum too, documented in docs/observability.md)

Metric names are validated at registration; re-registering the same name
with the same kind returns the existing family (modules register at import
time and may be re-imported), a different kind raises.
"""

from __future__ import annotations

import re
import threading
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# fixed log-spaced latency buckets: half-decade steps, 100 us .. ~30 s.
# Wide enough for a single queue-wait tick and a first dispatch that builds
# the CUDA kernels on the same axis; coarse enough that a scrape stays small.
LATENCY_BUCKETS_S = (
    0.0001, 0.000316, 0.001, 0.00316, 0.01, 0.0316,
    0.1, 0.316, 1.0, 3.16, 10.0, 31.6,
)

# batch-fill buckets: the matcher's batch-dimension padding ladder rungs
# (matching/matcher.py _BATCH_LADDER) so the fill histogram reads directly
# against the shapes the device actually compiles
BATCH_FILL_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _fmt(v: float) -> str:
    """Exact Prometheus-valid number rendering (no %g precision loss)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


class Counter:
    """Monotonically increasing float."""

    kind = "counter"

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up (got %r)" % (n,))
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v

    def _sample(self):
        return self._v

    def _merge_sample(self, a, b):
        return a + b


class Gauge:
    """Settable value.  Cross-process merge sums (queue depths, inflight
    counts — the aggregations this codebase needs); document per family."""

    kind = "gauge"

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._v -= n

    @property
    def value(self) -> float:
        return self._v

    def _sample(self):
        return self._v

    def _merge_sample(self, a, b):
        return a + b


class Histogram:
    """Fixed-bucket histogram (upper bounds; +Inf implicit).

    ``observe`` optionally takes an exemplar (a trace id): per bucket, the
    SLOWEST observation's id is kept, linking the histogram tail to a
    flight-recorder trace.  Exemplars ride ``snapshot()`` (→ /statusz,
    tools/trace_top.py) but not ``render()`` — the 0.0.4 text exposition
    has no exemplar syntax."""

    kind = "histogram"

    def __init__(self, buckets: Sequence[float] = LATENCY_BUCKETS_S):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(nxt <= prev for nxt, prev in zip(bounds[1:], bounds)):
            raise ValueError("buckets must be non-empty and increasing")
        self._bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)  # last slot = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._exemplars: Dict[int, Tuple[float, str]] = {}

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        v = float(v)
        i = bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar is not None:
                ex = self._exemplars.get(i)
                if ex is None or v > ex[0]:
                    self._exemplars[i] = (v, exemplar)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _sample(self):
        with self._lock:
            out = {
                "buckets": list(self._bounds),
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
            }
            if self._exemplars:
                # [bucket_index, value, trace_id], JSON-safe and mergeable
                out["exemplars"] = [
                    [i, v, tid] for i, (v, tid) in sorted(self._exemplars.items())
                ]
            return out

    def _merge_sample(self, a, b):
        return _merge_hist_samples(a, b)


class Family:
    """One metric name; children per label-value combination."""

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 make_child: Callable):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._make_child = make_child
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        self.kind = make_child().kind
        if not self.labelnames:
            self._children[()] = make_child()

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("labels() takes positional OR keyword values")
            try:
                values = tuple(kv[n] for n in self.labelnames)
            except KeyError as e:
                raise ValueError("missing label %s for %s" % (e, self.name))
            if len(kv) != len(self.labelnames):
                raise ValueError("unexpected labels for %s: %r" % (self.name, kv))
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                "%s expects labels %r, got %r" % (self.name, self.labelnames, values)
            )
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values, self._make_child())
        return child

    # -- unlabeled convenience: the family proxies its single child --------

    def _default(self):
        if self.labelnames:
            raise ValueError("%s is labeled %r; use .labels()" % (self.name, self.labelnames))
        return self._children[()]

    def inc(self, n: float = 1.0):
        self._default().inc(n)

    def dec(self, n: float = 1.0):
        self._default().dec(n)

    def set(self, v: float):
        self._default().set(v)

    def observe(self, v: float, exemplar: Optional[str] = None):
        self._default().observe(v, exemplar)

    @property
    def value(self):
        return self._default().value

    def _items(self):
        with self._lock:
            return sorted(self._children.items())


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, Family] = {}
        self._collectors: List[Callable[[], None]] = []

    def _register(self, name: str, help: str, labelnames, make_child) -> Family:
        if not _NAME_RE.match(name):
            raise ValueError("invalid metric name %r" % (name,))
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError("invalid label name %r" % (ln,))
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != make_child().kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        "metric %s already registered as %s%r"
                        % (name, fam.kind, fam.labelnames)
                    )
                return fam
            fam = Family(name, help, labelnames, make_child)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Family:
        return self._register(name, help, labelnames, Counter)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Family:
        return self._register(name, help, labelnames, Gauge)

    def histogram(self, name: str, help: str = "", labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_S) -> Family:
        return self._register(name, help, labelnames, lambda: Histogram(buckets))

    def register_collect(self, fn: Callable[[], None]) -> None:
        """``fn`` runs before every render/snapshot — for gauges that read
        live state (queue depths) rather than being pushed."""
        with self._lock:
            self._collectors.append(fn)

    def unregister_collect(self, fn: Callable[[], None]) -> None:
        """Remove a collector registered with register_collect (no-op if
        absent) — a component with a bounded lifetime (a stopped
        EconomicsEngine, a torn-down test service) must not leave its
        collector running on every future scrape."""
        with self._lock:
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass

    def _collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:  # noqa: BLE001 - a scrape must never fail
                pass

    # -- read paths --------------------------------------------------------

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        self._collect()
        with self._lock:
            families = list(self._families.values())
        out: List[str] = []
        for fam in families:
            out.append("# HELP %s %s" % (fam.name, fam.help.replace("\n", " ")))
            out.append("# TYPE %s %s" % (fam.name, fam.kind))
            for labelvalues, child in fam._items():
                pairs = [
                    '%s="%s"' % (n, _escape(v))
                    for n, v in zip(fam.labelnames, labelvalues)
                ]
                base = ",".join(pairs)
                if fam.kind == "histogram":
                    s = child._sample()
                    cum = 0
                    for bound, c in zip(s["buckets"], s["counts"]):
                        cum += c
                        lbl = base + ("," if base else "") + 'le="%s"' % _fmt(bound)
                        out.append("%s_bucket{%s} %s" % (fam.name, lbl, _fmt(cum)))
                    lbl = base + ("," if base else "") + 'le="+Inf"'
                    out.append("%s_bucket{%s} %s" % (fam.name, lbl, _fmt(s["count"])))
                    suffix = "{%s}" % base if base else ""
                    out.append("%s_sum%s %s" % (fam.name, suffix, _fmt(s["sum"])))
                    out.append("%s_count%s %s" % (fam.name, suffix, _fmt(s["count"])))
                else:
                    suffix = "{%s}" % base if base else ""
                    out.append("%s%s %s" % (fam.name, suffix, _fmt(child._sample())))
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        """Plain-dict form, JSON-safe and mergeable with ``merge``."""
        self._collect()
        with self._lock:
            families = list(self._families.values())
        snap = {}
        for fam in families:
            snap[fam.name] = {
                "type": fam.kind,
                "help": fam.help,
                "labelnames": list(fam.labelnames),
                "samples": [
                    [list(lv), child._sample()] for lv, child in fam._items()
                ],
            }
        return snap


def merge(*snapshots: dict) -> dict:
    """Combine ``Registry.snapshot()`` dicts from several processes.
    Counters and histograms sum; gauges sum (see module docstring)."""
    out: dict = {}
    for snap in snapshots:
        for name, fam in snap.items():
            dst = out.get(name)
            if dst is None:
                out[name] = {
                    "type": fam["type"],
                    "help": fam.get("help", ""),
                    "labelnames": list(fam.get("labelnames", [])),
                    "samples": [[list(lv), _copy_sample(s)] for lv, s in fam["samples"]],
                }
                continue
            if dst["type"] != fam["type"]:
                raise ValueError("metric %s kind mismatch in merge" % name)
            index = {tuple(lv): i for i, (lv, _s) in enumerate(dst["samples"])}
            for lv, s in fam["samples"]:
                key = tuple(lv)
                if key in index:
                    i = index[key]
                    dst["samples"][i][1] = _merge_sample(
                        fam["type"], dst["samples"][i][1], s
                    )
                else:
                    dst["samples"].append([list(lv), _copy_sample(s)])
            dst["samples"].sort(key=lambda p: p[0])
    return out


def _copy_sample(s):
    return dict(s) if isinstance(s, dict) else s


def _merge_sample(kind, a, b):
    if kind == "histogram":
        return _merge_hist_samples(a, b)
    return a + b


def _merge_hist_samples(a, b):
    if a["buckets"] != b["buckets"]:
        raise ValueError("histogram bucket mismatch in merge")
    out = {
        "buckets": list(a["buckets"]),
        "counts": [x + y for x, y in zip(a["counts"], b["counts"])],
        "sum": a["sum"] + b["sum"],
        "count": a["count"] + b["count"],
    }
    # exemplars: keep the slowest observation per bucket across processes
    ex: Dict[int, list] = {}
    for src in (a.get("exemplars"), b.get("exemplars")):
        for i, v, tid in src or ():
            if i not in ex or v > ex[i][1]:
                ex[i] = [i, v, tid]
    if ex:
        out["exemplars"] = [ex[i] for i in sorted(ex)]
    return out


# the process-wide default registry: instrumented modules register their
# families against this at import time; /metrics and --metrics read it
REGISTRY = Registry()


def counter(name: str, help: str = "", labelnames: Sequence[str] = ()) -> Family:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames: Sequence[str] = ()) -> Family:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Sequence[float] = LATENCY_BUCKETS_S) -> Family:
    return REGISTRY.histogram(name, help, labelnames, buckets)
