"""Matcher configuration: the reference's MatcherConfig fields for the
paths the port carries.

Honours the tunables the reference bakes into its meili config: sigma_z,
beta, search_radius, breakage_distance, max_route_distance_factor,
max_route_time_factor, turn_penalty_factor.  Adds the device shape knobs
(beam width K, UBODT delta, length buckets, device-batch caps), the
session knobs and the sparse-gap model's knobs (off by default; the serve
entry point turns the model on, ``$REPORTER_SPARSE`` and
``$REPORTER_CALIBRATION`` act at matcher construction, see
``matching/sparse.py``) and the UBODT memory system's two options (the
table layout and in-batch probe dedup; ``$REPORTER_UBODT_LAYOUT`` and
``$REPORTER_PROBE_DEDUP`` override them at matcher construction) and the
Viterbi forward (``viterbi_kernel`` scan | assoc | auto with
``viterbi_assoc_threshold``; ``$REPORTER_VITERBI`` overrides it at
matcher construction), the tiered UBODT (``ubodt_hot_bytes``,
``ubodt_shard``; ``$REPORTER_UBODT_HOT_BYTES`` and ``$REPORTER_UBODT_SHARD``
override them), the session arena's byte budgets
(``session_arena_bytes``, ``session_arena_cold_bytes``;
``$REPORTER_SESSION_ARENA_BYTES`` and ``_COLD_BYTES``) and
route-consistent interpolation (``interpolate``, ``$REPORTER_INTERPOLATE``)
and the device mesh (``devices``, ``graph_devices``; ``$REPORTER_DEVICES``
and ``$REPORTER_GRAPH_DEVICES`` override them) and the service's degraded
CPU fallback (``cpu_fallback``), the columnar host packer (``host_pack``,
``$REPORTER_HOST_PACK``) and the long-trace program (``long_precompute``,
``$REPORTER_LONG_PRECOMPUTE``).  Every field of the reference's config is
one of these; ``from_dict`` drops any other key with one warning per key
per process.  ``warmup_batch_sizes`` sets the rungs
``SegmentMatcher.warmup`` dispatches.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import List, Set

log = logging.getLogger(__name__)

# keys from_dict has warned about in this process
_WARNED: Set[tuple] = set()
_WARNED_LOCK = threading.Lock()


def warn_dropped(what: str, key: str) -> None:
    """Log once per process that config key ``key`` of ``what`` is not
    carried by this port and has no effect."""
    with _WARNED_LOCK:
        if (what, key) in _WARNED:
            return
        _WARNED.add((what, key))
    log.warning("%s key %r is not carried by this port; ignored", what, key)


@dataclass
class MatcherConfig:
    # HMM parameters (reference defaults)
    sigma_z: float = 4.07
    beta: float = 3.0
    search_radius: float = 50.0
    breakage_distance: float = 2000.0
    max_route_distance_factor: float = 5.0
    max_route_time_factor: float = 2.0
    turn_penalty_factor: float = 0.0
    # distance (m) from a segment's end within which trace speeds below
    # queue_speed_threshold_kph count as queueing
    queue_speed_threshold_kph: float = 20.0
    # device shape knobs
    beam_k: int = 8
    ubodt_delta: float = 3000.0
    # UBODT memory system: the table layout ("cuckoo", two 512-byte rows a
    # probe, or "wide32", one 1 KB row) and in-batch probe dedup (each
    # distinct pair of a whole dispatch probed once; same answers)
    ubodt_layout: str = "cuckoo"
    probe_dedup: bool = False
    # Viterbi forward: "scan" (the sequential recursion, least work),
    # "assoc" (the log-depth associative max-plus scan) or "auto" (assoc
    # for padded window lengths >= viterbi_assoc_threshold); the same
    # answers up to float ties
    viterbi_kernel: str = "scan"
    viterbi_assoc_threshold: int = 256
    # long-trace carry chain: True = hoist the carry-independent work
    # (candidate sweep, emissions, the [W-1, K, K] transition build) out of
    # the per-window carry loop and dispatch it batched across all windows
    # of a trace group, leaving only the score recursion to chain; False =
    # the legacy per-window program, kernels 1-3 and the chain kernel once
    # a window.  $REPORTER_LONG_PRECOMPUTE=0|1 overrides it at matcher
    # construction
    long_precompute: bool = True
    # per-trace confidence diagnostics: match results carry a "_quality"
    # block (per-point edges, winner-vs-runner-up margins, pool
    # exhaustion) that the service pops before rendering; the serve
    # entrypoint turns it on unless $REPORTER_QUALITY_AUX=0
    quality_aux: bool = False
    # batch rungs pre-dispatched per length bucket by warmup passes
    # (batch --warmup, LocalMatcherClient.warmup); each snaps up to a
    # ladder rung
    warmup_batch_sizes: List[int] = field(default_factory=lambda: [1])
    # padded trace-length buckets for batched matching; longer traces
    # stream through windows of the largest with carried Viterbi state
    length_buckets: List[int] = field(default_factory=lambda: [16, 32, 64, 128, 256])
    # device-batch caps: the program materialises [B, T, K, K] transition
    # arrays, so the binding bound is on points (B*T), with a row cap on top
    max_device_batch: int = 2048
    max_device_points: int = 2048 * 64
    # per-vehicle sessions: a streaming submit of n new points snaps to the
    # smallest session window bucket >= n (beyond the largest it chains
    # through windows of the largest); the session store is bounded
    # (max_sessions, LRU) and TTL-evicted; session_tail_points bounds the
    # rolling association tail and replay buffer per vehicle
    session_buckets: List[int] = field(default_factory=lambda: [4, 16])
    session_tail_points: int = 64
    max_sessions: int = 65536
    session_ttl_s: float = 3600.0
    # carried session beams in a device slab updated in place by the step
    # (matching/arena.py); off by default, the serve entry point turns it
    # on.  The slab holds min(max_sessions, session_arena_bytes // slot
    # bytes) slots (0 = max_sessions); beams it cannot hold page to pinned
    # host memory, session_arena_cold_bytes of it (0 = 4x the hot slots)
    session_arena: bool = False
    session_arena_bytes: int = 0
    session_arena_cold_bytes: int = 0
    # the tiered UBODT (tiles/tiering.py): with ubodt_hot_bytes > 0 the
    # card holds only an arena of that many bytes of hot bucket rows, the
    # full table stays in pinned host memory; ubodt_shard "i/N" seeds the
    # arena with bucket range i of N.  Same answers at any budget
    ubodt_hot_bytes: int = 0
    ubodt_shard: str = ""
    # route-consistent interpolation (matching/sparse.py): boundary times
    # by free-flow speed; match_options.interpolate overrides per trace
    interpolate: bool = False
    # columnar host packing (matching/columnar.py): pack the padded device
    # batches with one vectorized scatter over flat per-point columns
    # instead of the legacy per-trace Python loop.  Bit-identical output,
    # so it defaults on; False (or $REPORTER_HOST_PACK=0) keeps the legacy
    # loop as the differential reference
    host_pack: bool = True
    # the device mesh (parallel/mesh.py): ``devices`` ranks in all, the
    # trace batch split over devices // graph_devices dp ranks and the
    # UBODT's bucket ranges over graph_devices gp ranks; both powers of
    # two, graph_devices dividing devices.  Same answers at every topology
    devices: int = 1
    graph_devices: int = 1
    # sparse-gap model (matching/sparse.py): a trace whose median gap is at
    # or above sparse_gap_s decodes with the time-adaptive transitions and
    # gap-conditioned breakage, at sparse_beam_k candidates on windowed and
    # long traffic (sessions keep beam_k), with the cohort's
    # CALIBRATION.json row when ``calibration`` (or $REPORTER_CALIBRATION)
    # names one, else the family below.  Off by default; the serve entry
    # point turns it on ($REPORTER_SPARSE=0 reverts).
    sparse: bool = False
    sparse_gap_s: float = 40.0
    sparse_beam_k: int = 16
    # 0 = inherit search_radius; any value clamps to cell_size/2
    sparse_search_radius: float = 0.0
    sparse_beta_ref_s: float = 15.0
    sparse_beta_scale: float = 1.0
    sparse_beta_max: float = 8.0
    sparse_break_speed_mps: float = 34.0
    sparse_vmax_mps: float = 45.0
    sparse_plaus_weight: float = 3.0
    calibration: str = ""
    # the service's degraded mode (serve/service.py): after a device
    # watchdog trip requests are answered by the CPU baseline over the same
    # arrays and table with "degraded": true until a re-attach probe finds
    # the device healthy; False answers a wedge with a retryable 503
    cpu_fallback: bool = True
    # report() business-logic default
    threshold_sec: int = 15
    mode: str = "auto"

    @classmethod
    def from_dict(cls, d: dict) -> "MatcherConfig":
        """The config of a dict's known keys; every other key is dropped
        with one warning per key per process."""
        known = set(cls.__dataclass_fields__)
        for k in d:
            if k not in known:
                warn_dropped("matcher config", k)
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_meili(cls, meili: dict) -> "MatcherConfig":
        """Accept a valhalla-style config json ({'meili': {'default': {...}}})."""
        d = meili.get("meili", meili).get("default", meili.get("default", meili))
        c = cls()
        for key in (
            "sigma_z", "beta", "search_radius", "breakage_distance",
            "max_route_distance_factor", "max_route_time_factor",
            "turn_penalty_factor",
        ):
            if key in d:
                setattr(c, key, type(getattr(c, key))(d[key]))
        return c
