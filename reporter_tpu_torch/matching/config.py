"""Matcher configuration: the reference's MatcherConfig fields for the
paths the port carries.

Honours the tunables the reference bakes into its meili config: sigma_z,
beta, search_radius, breakage_distance, max_route_distance_factor,
max_route_time_factor, turn_penalty_factor.  Adds the device shape knobs
(beam width K, UBODT delta, length buckets, device-batch caps), the
session knobs and the sparse-gap model's knobs (off by default; the serve
entry point turns the model on, ``$REPORTER_SPARSE`` and
``$REPORTER_CALIBRATION`` act at matcher construction, see
``matching/sparse.py``).  Keys of the reference's config that belong to
paths this port does not carry yet (route-consistent interpolation, the
session arena's budget and cold tier, tiering, meshes) are ignored by
``from_dict``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


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
    # per-trace confidence diagnostics: match results carry a "_quality"
    # block (per-point edges, winner-vs-runner-up margins, pool
    # exhaustion) that the service pops before rendering; the serve
    # entrypoint turns it on unless $REPORTER_QUALITY_AUX=0
    quality_aux: bool = False
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
    # carried session beams in a device slab of max_sessions slots updated
    # in place by the step (matching/arena.py); off by default, the serve
    # entry point turns it on
    session_arena: bool = False
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
    # report() business-logic default
    threshold_sec: int = 15
    mode: str = "auto"

    @classmethod
    def from_dict(cls, d: dict) -> "MatcherConfig":
        known = set(cls.__dataclass_fields__)
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
