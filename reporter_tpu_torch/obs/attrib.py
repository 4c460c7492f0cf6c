"""Named-stage device-time attribution from ``torch.profiler`` captures.

Every kernel launch and every plain version runs inside a
``torch.profiler.record_function`` range named ``rs.<stage>`` (``stage``;
``ops/_kernels.Kernel.launch`` names the launching kernel too, as
``rs.<stage>/<kernel name>``).  This module turns a capture of such ranges
into a per-stage device-time table:

  capture()        single-flight profiler window around N calls of a
                   runnable (obs/profiler.py's process-global lock guards
                   it against /debug/profile and concurrent captures)
  parse_*()        bucketing of the capture's Chrome trace:
                     * on the card, a ``kernel`` event takes its stage from
                       the ``rs.*`` range around the runtime (or driver)
                       launch call it correlates with, else from the
                       ``gpu_user_annotation`` over it; a kernel with
                       neither goes to ``(unattributed)`` — PyTorch's own
                       elementwise ops and copies do, and that share is
                       part of the result;
                     * on host cores (no ``kernel`` event: the plain
                       versions ran), each ``rs.*`` range's own wall, less
                       the ``rs.*`` ranges nested in it.

Labels.  Several of the port's kernels fuse more than one of the JAX
package's twelve stages; such a kernel's range carries those stages
joined by ``+`` (each ``Kernel`` of ops/_kernels.py carries its label as
``Kernel.stage``), and ``STAGES`` lists the labels the kernels carry, in
pipeline order.  Each of the JAX package's stages
(``REFERENCE_STAGES``) appears in exactly one label: the assoc kernels'
backtrace and gather run inside their own launch and are counted under
``assoc-recursion``.  Three labels name kernels the JAX package has no
stage for: the mesh's histogram and slot-sharded slab, and the sampled
probe diagnostic.

Surfaces: ``reporter_stage_device_seconds{stage}`` +
``reporter_attrib_age_seconds`` gauges, ``GET /debug/attrib``
(serve/service.py) and a ``/statusz`` summary line.  ``HOST_STAGES`` is the
host mirror: wall seconds per host pipeline stage, accrued where the
serving path crosses them.

``REPORTER_STAGE_SCOPES=0`` (read at import; ``set_scopes`` changes it at
run time) makes ``stage`` a null context (the outputs
are bit-identical either way: a range only marks the profiler's
timeline and synchronises nothing).  torch is imported lazily: the module
(and the gauges) stay usable where torch is absent.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import glob
import gzip
import json
import logging
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional

from . import metrics

log = logging.getLogger(__name__)

STAGE_PREFIX = "rs."
# the JAX package's stage labels, in its pipeline order
REFERENCE_STAGES = (
    "candidate-sweep", "emission", "transition-build", "ubodt-probe",
    "select", "dedup-sort", "dedup-compact", "dedup-scatter",
    "scan-recursion", "assoc-recursion", "backtrace", "compact-gather",
)
# the labels the port's kernels carry (``Kernel.stage`` in ops/_kernels.py),
# in pipeline order
STAGES = (
    "candidate-sweep",
    "dedup-sort+dedup-compact",        # the dedup claim
    "ubodt-probe+select",              # kernel 2 and its instantiations
    "dedup-scatter",                   # the dedup scatter-back
    "emission+transition-build",       # kernel 3
    "scan-recursion+backtrace+compact-gather",  # the scan and chain kernels
    "assoc-recursion",                 # the log-depth kernels
    "segment-histogram",               # the mesh's per-segment reduction
    "slab-shard",                      # the mesh's slot-sharded slab
    "probe-stats",                     # the sampled probe diagnostic
)
UNATTRIBUTED = "(unattributed)"

# rs.<label>[/<kernel name>]: the label's characters, then the optional
# launching kernel's (brackets and commas of its instantiation)
_SCOPE_RE = re.compile(re.escape(STAGE_PREFIX)
                       + r"([A-Za-z0-9_+-]+)(?:/([A-Za-z0-9_\[\],]+))?")


def _scopes_from_env() -> bool:
    return os.environ.get("REPORTER_STAGE_SCOPES", "1").strip().lower() not in (
        "0", "false", "off", "no")


_SCOPES = [_scopes_from_env()]


def scopes_enabled() -> bool:
    """The annotation switch: REPORTER_STAGE_SCOPES as it was when this
    module was imported (0 disables), or as ``set_scopes`` last set it."""
    return _SCOPES[0]


def set_scopes(on: Optional[bool] = None) -> bool:
    """Turn the ranges on or off (None: read REPORTER_STAGE_SCOPES again);
    returns the previous setting."""
    prev = _SCOPES[0]
    _SCOPES[0] = _scopes_from_env() if on is None else bool(on)
    return prev


def stage(name: str, kernel: Optional[str] = None):
    """``with stage("candidate-sweep"):`` — a profiler range named
    ``rs.<name>`` (``rs.<name>/<kernel>`` for a launch), or a null context
    when annotation is disabled.  It marks the profiler's timeline only:
    no stream is synchronised and no output changes."""
    if not _SCOPES[0]:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(
        STAGE_PREFIX + name + ("/" + kernel if kernel else ""))


def staged(label: str):
    """Decorator: run the function (a plain version) inside
    ``stage(label)``."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            with stage(label):
                return fn(*a, **kw)
        return run
    return deco


def _scope_of(text) -> Optional[tuple]:
    """(label, kernel name or None) of an ``rs.*`` range name, or None."""
    m = _SCOPE_RE.fullmatch(str(text or ""))
    return (m.group(1), m.group(2)) if m else None


# ---------------------------------------------------------------------------
# Chrome-trace parsing


def _innermost(ranges: list, ts: float) -> Optional[dict]:
    """The innermost (latest-starting) range of ``ranges`` (sorted by
    start, with their starts in ``ranges.starts``) that covers ``ts``."""
    i = bisect.bisect_right(ranges.starts, ts) - 1
    while i >= 0:
        r = ranges[i]
        if ts <= r["ts"] + r["dur"]:
            return r
        i -= 1
    return None


class _Ranges(list):
    """Ranges of one (pid, tid), sorted by start, with the starts."""

    def seal(self) -> None:
        self.sort(key=lambda r: r["ts"])
        self.starts = [r["ts"] for r in self]


def parse_trace_events(events) -> dict:
    """``torch.profiler`` Chrome-trace event list -> attribution dict.

    ``platform`` "cuda" when the capture holds ``kernel`` events; then
    ``stages_ms`` is device time per label (``(unattributed)`` included,
    with ``unattributed_frac`` its share of ``device_total_ms``) and
    ``kernels`` gives, per launching ``Kernel.name``, the launches the
    profiler saw (its ranges that reach at least one device kernel), their
    device ms and label.  ``attributed_by`` counts the kernel events whose
    stage came from the launch correlation and from the device-side
    annotation.  On host cores ``stages_ms`` is each label's own wall."""
    user: Dict[tuple, _Ranges] = collections.defaultdict(_Ranges)
    gpu_ann: Dict[tuple, _Ranges] = collections.defaultdict(_Ranges)
    launches: List[dict] = []
    kernels: List[dict] = []
    n_ranges = 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", ""))
        if cat == "user_annotation":
            sc = _scope_of(e.get("name"))
            if sc is not None:
                user[(e.get("pid"), e.get("tid"))].append(
                    dict(ts=float(e["ts"]), dur=float(e.get("dur", 0)),
                         label=sc[0], kernel=sc[1], id=n_ranges))
                n_ranges += 1
        elif cat == "gpu_user_annotation":
            sc = _scope_of(e.get("name"))
            if sc is not None:
                gpu_ann[(e.get("pid"), e.get("tid"))].append(
                    dict(ts=float(e["ts"]), dur=float(e.get("dur", 0)),
                         label=sc[0], kernel=sc[1]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            launches.append(e)
        elif cat == "kernel":
            kernels.append(e)
    for rs in list(user.values()) + list(gpu_ann.values()):
        rs.seal()
    empty = _Ranges()
    empty.seal()
    if not kernels:
        return _parse_host(user)
    # correlation id -> the range around the launch call
    by_corr: Dict[object, dict] = {}
    for e in launches:
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        r = _innermost(user.get((e.get("pid"), e.get("tid")), empty),
                       float(e["ts"]))
        if r is not None:
            by_corr[corr] = r
    stages: Dict[str, float] = collections.defaultdict(float)
    per_kernel: Dict[str, dict] = {}
    seen_ranges: Dict[str, set] = collections.defaultdict(set)
    by_name: Dict[str, float] = collections.defaultdict(float)
    how = {"launch": 0, "annotation": 0, "none": 0}
    total = 0.0
    devices = set()
    for e in kernels:
        dur = float(e.get("dur", 0)) / 1e3  # us -> ms
        total += dur
        devices.add(e.get("pid"))
        by_name[str(e.get("name", ""))[:120]] += dur
        r = by_corr.get((e.get("args") or {}).get("correlation"))
        key = None
        if r is not None:
            how["launch"] += 1
            key = ("u", r["id"])
        else:
            r = _innermost(gpu_ann.get((e.get("pid"), e.get("tid")), empty),
                           float(e["ts"]))
            if r is not None:
                how["annotation"] += 1
                key = ("g", id(r))
            else:
                how["none"] += 1
        stages[r["label"] if r is not None else UNATTRIBUTED] += dur
        if r is not None and r.get("kernel"):
            k = per_kernel.setdefault(r["kernel"], {
                "launches": 0, "device_ms": 0.0, "stage": r["label"]})
            k["device_ms"] += dur
            if key not in seen_ranges[r["kernel"]]:
                seen_ranges[r["kernel"]].add(key)
                k["launches"] += 1
    for k in per_kernel.values():
        k["device_ms"] = round(k["device_ms"], 4)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:16]
    return {
        "platform": "cuda",
        "devices": len(devices),
        "device_total_ms": round(total, 4),
        "stages_ms": _sorted(stages),
        "unattributed_frac": (round(stages.get(UNATTRIBUTED, 0.0) / total, 4)
                              if total > 0 else 0.0),
        "kernels": dict(sorted(per_kernel.items())),
        "attributed_by": how,
        "by_kernel_name_ms": {k: round(v, 4) for k, v in top},
    }


def _parse_host(user: Dict[tuple, list]) -> dict:
    """The host-cores form: each ``rs.*`` range's wall less its directly
    nested ``rs.*`` ranges', per label."""
    stages: Dict[str, float] = collections.defaultdict(float)
    for rs in user.values():
        stack: List[dict] = []
        for r in rs:  # sorted by start: a parent precedes its children
            while stack and r["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
                stack.pop()
            own = r["dur"] / 1e3
            stages[r["label"]] += own
            if stack:
                stages[stack[-1]["label"]] -= own
            stack.append(r)
    total = sum(stages.values())
    return {
        "platform": "cpu",
        "devices": 0,
        "device_total_ms": round(total, 4),
        "stages_ms": _sorted(stages),
        "unattributed_frac": 0.0,
        "kernels": {},
        "attributed_by": {"launch": 0, "annotation": 0, "none": 0},
        "by_kernel_name_ms": {},
    }


def _sorted(d: Dict[str, float]) -> Dict[str, float]:
    return {k: round(v, 4) for k, v in sorted(d.items(), key=lambda kv: -kv[1])
            if v > 0}


def parse_trace_file(path: str) -> dict:
    """One ``*.trace.json[.gz]`` Chrome trace -> attribution dict."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path) as f:
        tr = json.load(f)
    out = parse_trace_events(tr.get("traceEvents", []))
    out["path"] = path
    return out


def trace_files(trace_dir: str) -> List[str]:
    return sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"),
                  recursive=True)
        + glob.glob(os.path.join(trace_dir, "**", "*.trace.json"),
                    recursive=True))


def parse_trace_dir(trace_dir: str) -> dict:
    """Parse every Chrome trace under a capture directory and merge them
    (stage, kernel and launch counts add)."""
    paths = trace_files(trace_dir)
    if not paths:
        raise FileNotFoundError("no *.trace.json[.gz] under %s" % trace_dir)
    merged: Optional[dict] = None
    for p in paths:
        one = parse_trace_file(p)
        if merged is None:
            merged = one
            continue
        merged["devices"] += one["devices"]
        merged["device_total_ms"] = round(
            merged["device_total_ms"] + one["device_total_ms"], 4)
        for name, ms in one["stages_ms"].items():
            merged["stages_ms"][name] = round(
                merged["stages_ms"].get(name, 0.0) + ms, 4)
        for name, k in one["kernels"].items():
            dst = merged["kernels"].setdefault(
                name, {"launches": 0, "device_ms": 0.0, "stage": k["stage"]})
            dst["launches"] += k["launches"]
            dst["device_ms"] = round(dst["device_ms"] + k["device_ms"], 4)
        for how, n in one["attributed_by"].items():
            merged["attributed_by"][how] += n
        if one["platform"] == "cuda":
            merged["platform"] = "cuda"
    tot = merged["device_total_ms"]
    merged["unattributed_frac"] = (
        round(merged["stages_ms"].get(UNATTRIBUTED, 0.0) / tot, 4)
        if tot > 0 and merged["platform"] == "cuda" else 0.0)
    merged["path"] = trace_dir
    return merged


# ---------------------------------------------------------------------------
# row accounting shared with the probe diagnostics


def dedup_budget(n_pairs: int) -> int:
    """Compacted-unique capacity of the in-batch probe dedup for a
    dispatch of ``n_pairs`` probe pairs (ops/hashtable's budget,
    exactly)."""
    from ..ops.hashtable import _DEDUP_CAP_RATIO, _DEDUP_MIN_PAIRS

    return max(_DEDUP_MIN_PAIRS // 2, n_pairs // _DEDUP_CAP_RATIO)


def executed_rows(n_pairs: int, max_probes: int, dedup: bool = False) -> int:
    """Executed bucket-row reads for a dispatch: ``max_probes`` is the
    table layout's probe count (2 cuckoo / 1 wide32); with dedup the
    deduplicated path reads its budget instead of every occurrence."""
    return max_probes * (dedup_budget(n_pairs) if dedup else n_pairs)


# -- host-stage attribution: wall seconds the host spends per pipeline
# stage, accrued at the stage boundaries the serving path already crosses
# (request decode -> batch pack -> dispatch -> collect + association ->
# response encode)
HOST_STAGES = ("parse", "pack", "dispatch", "collect", "serialize")
C_HOST_STAGE = metrics.counter(
    "reporter_host_stage_seconds_total",
    "Wall seconds of host pipeline work by stage (parse = request-body "
    "decode, pack = batch packing into padded device arrays, dispatch = "
    "device program enqueue, collect = result fetch + host association, "
    "serialize = response encode; GET /debug/attrib reports the split)",
    ("stage",))
_HOST_S = {s: 0.0 for s in HOST_STAGES}
_HOST_LOCK = threading.Lock()


def host_add(stage: str, secs: float) -> None:
    """Accrue ``secs`` of host work to ``stage`` (per batch or request,
    never per point)."""
    if secs <= 0:
        return
    with _HOST_LOCK:
        _HOST_S[stage] = _HOST_S.get(stage, 0.0) + secs
    C_HOST_STAGE.labels(stage).inc(secs)


def host_snapshot() -> Dict[str, float]:
    with _HOST_LOCK:
        return dict(_HOST_S)


def host_summary(since: Optional[Dict[str, float]] = None) -> dict:
    """The host-stage split: cumulative (or since a snapshot) seconds per
    stage plus each stage's share of the host total."""
    now = host_snapshot()
    if since:
        now = {k: max(0.0, v - since.get(k, 0.0)) for k, v in now.items()}
    total = sum(now.values())
    return {
        "stages_s": {k: round(v, 6) for k, v in now.items()},
        "total_s": round(total, 6),
        "split": {k: (round(v / total, 4) if total > 0 else 0.0)
                  for k, v in now.items()},
    }


def host_frac(host_s: float, device_s: float) -> Optional[float]:
    """host / (host + device) over one window; None when the window
    carries no work."""
    denom = host_s + device_s
    return round(host_s / denom, 4) if denom > 0 else None


G_STAGE_S = metrics.gauge(
    "reporter_stage_device_seconds",
    "Device seconds per named kernel stage in the last parsed attribution "
    "capture (torch.profiler ranges rs.<stage>; GET /debug/attrib)",
    ("stage",))
G_ATTRIB_AGE = metrics.gauge(
    "reporter_attrib_age_seconds",
    "Seconds since the last parsed attribution capture (-1 until one runs)")

_LAST: Optional[dict] = None
_LAST_LOCK = threading.Lock()


def _update_age() -> None:
    with _LAST_LOCK:
        ts = _LAST.get("captured_unix") if _LAST else None
    G_ATTRIB_AGE.set(round(time.time() - ts, 3) if ts else -1.0)


metrics.REGISTRY.register_collect(_update_age)


def store_result(result: dict) -> None:
    """Publish a parsed capture: the /debug/attrib 'last' slot and the
    stage gauges (the previous capture's stages zeroed so a stage that
    vanished does not linger)."""
    global _LAST
    with _LAST_LOCK:
        prev, _LAST = _LAST, result
    for name in (prev or {}).get("stages_ms", {}):
        G_STAGE_S.labels(name).set(0.0)
    for name, ms in result.get("stages_ms", {}).items():
        G_STAGE_S.labels(name).set(ms / 1e3)
    _update_age()


def last() -> Optional[dict]:
    with _LAST_LOCK:
        return dict(_LAST) if _LAST else None


def capture(run_fn: Callable[[], object], reps: int = 3,
            out_dir: Optional[str] = None, trace_id: Optional[str] = None,
            store: bool = True, warm: bool = True) -> dict:
    """Profile ``reps`` calls of ``run_fn`` (each must wait on its device
    result), parse the capture into the per-stage table and publish it.
    Single-flight through obs/profiler's process-global lock: a concurrent
    capture (here or /debug/profile) raises ProfilerBusy carrying the
    in-flight capture's trace_id.  ``warm`` runs one call first, outside
    the window, so a first use's kernel build stays out of it.  On the
    card a capture that attributes no kernel to any stage raises: the
    annotation did not reach the profiler."""
    from . import profiler

    reps = max(1, int(reps))
    if warm:
        run_fn()
    host0 = host_snapshot()
    with profiler.session("attrib", trace_id=trace_id, out_dir=out_dir) as d:
        t0 = time.time()
        for _ in range(reps):
            run_fn()
        wall = time.time() - t0
    host_win = host_summary(since=host0)
    result = parse_trace_dir(d)
    if set(result["stages_ms"]) <= {UNATTRIBUTED}:
        if result["platform"] == "cuda":
            raise RuntimeError(
                "attribution capture under %s saw %.4f device ms and "
                "attributed none of it to a stage" % (d, result["device_total_ms"]))
        log.warning("attribution capture resolved no stages "
                    "(REPORTER_STAGE_SCOPES off?)")
    result.update({
        "captured_unix": round(time.time(), 3),
        "captured": time.strftime("%Y-%m-%d"),
        "reps": reps,
        "wall_s": round(wall, 4),
        "trace_dir": d,
        "host_stages_s": host_win["stages_s"],
        "host_frac": host_frac(
            host_win["total_s"],
            float(result.get("device_total_ms") or 0.0) / 1e3),
    })
    if store:
        store_result(result)
    return result


def capture_matcher(matcher, reps: int = 3, length: Optional[int] = None,
                    trace_id: Optional[str] = None) -> dict:
    """Capture ``reps`` live dispatches of a SegmentMatcher (the
    /debug/attrib trigger): dummy traces through the real dispatch path,
    so the profiled kernels are exactly the serving ones."""
    if length is None:
        length = int(matcher.cfg.length_buckets[0]) if matcher.cfg.length_buckets else 64
    traces = matcher.dummy_traces(max(2, length), 1)
    return capture(lambda: matcher.match_many(traces), reps=reps,
                   trace_id=trace_id)


def summary() -> dict:
    """The /statusz line: capture age, headline stage and the host
    split."""
    res = last()
    out: dict = {"captured": bool(res), "host": host_summary()}
    if res:
        out.update({
            "age_s": round(time.time() - res.get("captured_unix", 0), 1),
            "platform": res.get("platform"),
            "device_total_ms": res.get("device_total_ms"),
            "unattributed_frac": res.get("unattributed_frac"),
        })
        if res.get("host_frac") is not None:
            out["host_frac"] = res["host_frac"]
        stages = {k: v for k, v in res.get("stages_ms", {}).items()
                  if k != UNATTRIBUTED}
        if stages:
            top = max(stages.items(), key=lambda kv: kv[1])
            out["top_stage"] = {"stage": top[0], "ms": top[1]}
    return out
