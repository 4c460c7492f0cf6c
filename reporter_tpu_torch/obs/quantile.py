"""Shared histogram-quantile math: ONE implementation of bucket parsing
and Prometheus ``histogram_quantile`` semantics for every surface that
turns bucket counts into a latency number.

Grown out of ``tools/trace_top.py`` (which now imports from here) so the
SLO engine (``obs/slo.py``), the load generator (``tools/loadgen.py``)
and the live terminal view all compute the SAME quantile from the same
counts — a client-side p99 and the server's own p99 can disagree about
traffic, but never about arithmetic.  Semantics are pinned by unit tests
(tests/test_slo.py):

  * linear interpolation inside the landing bucket, exactly Prometheus's
    ``histogram_quantile``;
  * a quantile landing in the +Inf bucket clamps to the last finite
    bound;
  * an empty histogram yields ``None``.

``SLO_BUCKETS_S`` is the shared log-spaced bucket table for SLO latency
accounting: 12 buckets per decade, 1 ms .. 100 s (adjacent bounds differ
by 10^(1/12) ~ 1.212x), fine enough that a bucketed p99 sits within one
bucket ratio of the true p99 while staying cheap to scrape and merge.
The quantile of the BUCKETED distribution is computed exactly — the
bucketing itself is the only approximation, and every consumer shares
the same bucket bounds so the numbers are comparable across surfaces.

Pure stdlib.
"""

from __future__ import annotations

import math
import re
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple


def log_bucket_bounds(lo: float, hi: float, per_decade: int = 12) -> Tuple[float, ...]:
    """Log-spaced upper bounds from ``lo`` to at least ``hi``; adjacent
    bounds differ by ``10^(1/per_decade)``."""
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError("need 0 < lo < hi and per_decade >= 1")
    n = int(math.ceil(per_decade * math.log10(hi / lo))) + 1
    return tuple(round(lo * 10.0 ** (i / per_decade), 9) for i in range(n))


# the shared SLO latency axis: every reporter_slo_* histogram, the load
# generator's client-side accounting, and the SLO engine's windowed
# quantiles all bucket on these bounds
SLO_BUCKETS_S = log_bucket_bounds(0.001, 100.0, per_decade=12)


def bucket_index(bounds: Sequence[float], v: float) -> int:
    """The bucket slot for an observation — index into a counts array of
    ``len(bounds) + 1`` slots (last slot = +Inf overflow).  Matches
    ``obs.metrics.Histogram.observe`` exactly (bisect_left: a value equal
    to a bound lands IN that bound's bucket)."""
    return bisect_left(bounds, float(v))


def cumulate(bounds: Sequence[float], counts: Sequence[float]) -> List[Tuple[float, float]]:
    """Per-bucket counts (``len(bounds) + 1`` slots, +Inf last) ->
    sorted cumulative ``(upper_bound, cumulative_count)`` pairs with the
    +Inf bucket included — the shape ``hist_quantile`` consumes."""
    out: List[Tuple[float, float]] = []
    cum = 0.0
    for le, c in zip(bounds, counts):
        cum += c
        out.append((float(le), cum))
    cum += sum(counts[len(bounds):])
    out.append((float("inf"), cum))
    return out


_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(-?[0-9.eE+-]+|NaN)$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:\\.|[^"\\])*)"')


def parse_metrics(text: str) -> Dict[str, Dict[Tuple[Tuple[str, str], ...], float]]:
    """Prometheus text exposition -> {name: {labels: value}} with labels a
    sorted tuple of (k, v) pairs (histogram _bucket/_sum/_count stay
    separate names, exactly as exposed)."""
    out: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, _g, labels_raw, value = m.groups()
        labels = tuple(sorted(_LABEL_RE.findall(labels_raw or "")))
        try:
            out.setdefault(name, {})[labels] = float(value)
        except ValueError:
            continue
    return out


def hist_buckets(metrics: dict, family: str,
                 match: Optional[dict] = None,
                 merge_children: bool = False) -> List[Tuple[float, float]]:
    """Sorted (upper_bound, cumulative_count) pairs for a histogram
    family, +Inf included.  ``match`` filters labeled families: only
    samples whose label set contains every (k, v) pair in it contribute.
    Without ``merge_children``, samples from several children of one
    family are NOT merged — pass a match precise enough to select one
    child.  With it, matching children are SUMMED per bucket bound —
    the fleet view: a replica-labeled federated scrape (or several
    targets merged by ``merge_parsed``) collapses into one fleet-wide
    histogram, valid because cumulative bucket counts over identical
    bounds are additive."""
    rows = []
    for labels, v in metrics.get(family + "_bucket", {}).items():
        d = dict(labels)
        le = d.get("le")
        if le is None:
            continue
        if match and any(d.get(k) != v2 for k, v2 in match.items()):
            continue
        rows.append((float("inf") if le == "+Inf" else float(le), v))
    if merge_children:
        summed: Dict[float, float] = {}
        for le, v in rows:
            summed[le] = summed.get(le, 0.0) + v
        rows = list(summed.items())
    rows.sort()
    return rows


def merge_parsed(frames: Sequence[dict]) -> Dict[str, Dict[Tuple[Tuple[str, str], ...], float]]:
    """Merge several ``parse_metrics`` results into one by summing values
    per (family, label set) — the multi-target path of tools/trace_top.py
    and tools/fleet_top.py.  Counters and histogram buckets sum exactly;
    gauges sum too, matching ``obs.metrics.merge``'s cross-process
    semantics (queue depths and inflight counts aggregate by addition)."""
    out: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    for fr in frames:
        for name, samples in (fr or {}).items():
            dst = out.setdefault(name, {})
            for labels, v in samples.items():
                dst[labels] = dst.get(labels, 0.0) + v
    return out


def delta_buckets(cur: List[Tuple[float, float]],
                  prev: Optional[List[Tuple[float, float]]]) -> List[Tuple[float, float]]:
    """Bucket-wise difference (interval histogram); falls back to ``cur``
    when there is no previous frame or the server restarted (negative
    deltas)."""
    if not prev or len(prev) != len(cur):
        return cur
    out = []
    for (le, c), (_ple, p) in zip(cur, prev):
        d = c - p
        if d < 0:
            return cur
        out.append((le, d))
    return out


def hist_quantile(buckets: List[Tuple[float, float]], q: float) -> Optional[float]:
    """Quantile from cumulative buckets with linear interpolation inside
    the landing bucket (Prometheus histogram_quantile semantics); None on
    an empty histogram.  The +Inf bucket clamps to the last finite bound."""
    if not buckets:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_cum = 0.0, 0.0
    for le, cum in buckets:
        if cum >= rank:
            if le == float("inf"):
                return prev_le
            if cum == prev_cum:
                return le
            return prev_le + (le - prev_le) * (rank - prev_cum) / (cum - prev_cum)
        prev_le, prev_cum = le, cum
    return prev_le
