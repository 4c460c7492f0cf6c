"""SegmentMatcher: the public matching API of the port.

Wire-compatible with the reference's ``SegmentMatcher`` on its bucketed
dense path: ``Match(json) -> json``, ``match(trace)``, ``match_many`` and
``match_many_async``.  Traces are bucketed by padded length
(``length_buckets``), grouped by effective per-request parameters
(``match_options`` sigma_z / beta / search_radius / gps_accuracy), padded
to a batch-ladder rung, packed into one [4, B, T] float32 array and matched
on ``device`` by the match program of ops/viterbi.py; host
association (native core, or its Python twin) turns the [3, B, T] result
into wire-format segments.

Fault injection (``faults.py``): the ``dispatch`` seam at
``match_many_async``'s entry (and ``SessionEngine``'s), ``ubodt_probe`` in
each per-chunk dispatch of the windowed and session paths, and
``device_hang`` at the top of both ``finish()`` closures, where the
reference has them; ``dummy_traces`` is the re-attach probe's input.

Traces longer than the largest bucket stream through fixed windows of that
length with carried Viterbi state (``_dispatch_long``): kernels 1-3 run
once over all of a group's windows, then kernel 5 chains the beam window
to window.  ``match_sessions[_async]`` folds the newly arrived points of
many per-vehicle sessions into fixed [B, W] session steps, the carried
beams on the host or, with ``session_arena``, in a device slab updated in
place (``matching/arena.py``).

The sparse-gap model (``matching/sparse.py``; off by default, on in the
serve entry point, ``$REPORTER_SPARSE`` and ``$REPORTER_CALIBRATION`` read
at construction): a trace whose median gap is at or above
``sparse_gap_s`` is bucketed by (params, cohort label, length) and decodes
through the packed programs with the cohort's ``SparseParams``, the
kernels' SPARSE instantiations, with its cohort's parameters and candidate budget K
(windowed and long traffic; session steps keep ``beam_k``).  Dense traces
take the dense programs unchanged.

The UBODT memory system (``ubodt_layout``, ``probe_dedup``; overridden by
``$REPORTER_UBODT_LAYOUT`` and ``$REPORTER_PROBE_DEDUP`` at construction):
the table is built in, or repacked to (``UBODT.relayout``), the resolved
layout, cuckoo or wide32, and with dedup every bucketed and long ``pre``
dispatch, dense and sparse, probes each distinct (src, dst) pair once
(ops/hashtable.py); session steps and the chain's seam probes never
dedup.  Answers are the same under every setting.

The Viterbi forward (``viterbi_kernel``, overridden by
``$REPORTER_VITERBI`` at construction): "scan", "assoc" (the log-depth
kernels) or "auto", which picks per padded window length against
``viterbi_assoc_threshold`` (``_kernel_for``), at every dispatch: the
bucketed batches, each long window, every session step.  Kernels 1-3 are
the same under either forward.
``$REPORTER_OBS_PROBE_EVERY`` = N samples the probe-outcome diagnostic
(ops/diagnostics.py) on every Nth dense bucketed dispatch: dispatched on
the dispatching thread, harvested at collect into
``reporter_ubodt_probe_total`` (``probe_stats`` reads it).

The tiered UBODT (``ubodt_hot_bytes``, ``ubodt_shard``; overridden by
``$REPORTER_UBODT_HOT_BYTES`` and ``$REPORTER_UBODT_SHARD``): with a
positive budget ``_du`` is a ``TieredDeviceUBODT`` (tiles/tiering.py),
a hot arena on the device over the table in pinned host memory, which
every probe of every path reads through (kernel 2's ``[tiered]``
instantiations, the dedup scatter, the chain kernels' seams); the fetch
totals are read at collect, where a maintenance pass may re-pick the hot
set.  The session slab's byte budget and pinned host cold tier
(``session_arena_bytes``, ``session_arena_cold_bytes``) are
``matching/arena.py``'s.

Route-consistent interpolation (``cfg.interpolate``,
``$REPORTER_INTERPOLATE``, a request's ``match_options.interpolate``)
re-times the windowed and long traces' segment boundaries by free-flow
speed at association (``matching/sparse.py``).

``backend="cpu"`` (asked for by the caller or a service config's
"backend"; the default "jax" is the device program above) runs the CPU
baseline, ``baseline.CPUViterbiMatcher``, on the host over the same
arrays and table, as the reference's CPU backend does: no device, no
windows for long traces (matched whole, bucketed by powers of two), a
session step a stateless window over its points, every trace dense.

The device mesh (``devices``, ``graph_devices``; ``$REPORTER_DEVICES`` and
``$REPORTER_GRAPH_DEVICES`` read at construction): with more than one
device the matcher builds a dp x gp ``parallel.mesh.Mesh`` first (of the
visible cards, or of the list given as ``device``; ranks may share one),
then places every program argument by the rule table
(``parallel/rules.py``): the graph replicated on each dp rank, the table
replicated or, on a gp axis, split into bucket ranges, and each
dispatch's rows (padded to a multiple of the dp ranks) split over dp.
Each dp rank runs kernels 1-5 on its rows on its own device; only the
probe fans out over its gp ranks (kernel 11a, merged by pmin / pmax), so
the Viterbi compute runs once per dp shard where the reference
replicates it over the gp ranks: the same bytes.  The bucketed, long,
sparse, host-carry session and slab session programs all run on it, under
either forward; the slab's slots are split over dp (kernel 11c).  A
tiered table on a mesh raises.  The answers are the single device's.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import faults
from ..convert import carry_from_numpy
from ..obs import attrib as obs_attrib
from ..obs import log as obs_log
from ..obs import metrics as obs
from ..device import resolve_device, upload
from ..ops.diagnostics import ubodt_probe_stats
from ..ops.hashtable import DEDUP
from ..ops.viterbi import (
    NEG_INF, MatchParams, TraceCarry, chain_batch_carry_packed_aux,
    initial_carry_batch, match_batch_compact_packed_aux, pack_inputs,
    precompute_batch_packed, session_step_arena, session_step_arena_mesh,
    session_step_packed, slice_pre, unpack_compact,
)
from ..ops import collectives
from ..parallel.mesh import Mesh, make_mesh, make_mesh2, place
from ..tiles.arrays import GraphArrays, build_graph_arrays
from ..tiles.network import RoadNetwork
from ..tiles.tiering import TieredTable, parse_shard
from ..tiles.ubodt import LAYOUTS, UBODT, build_ubodt
from .arena import SessionArena, carry_host
from .assoc_native import associate_segments_batch
from .config import MatcherConfig
from .sparse import SparseModel, associate_interpolated, clamp_radius

log = logging.getLogger(__name__)

# the matcher's families (docs/observability.md), counted where the JAX
# package's matcher counts them.  reporter_compile_total /
# reporter_compile_seconds_total keep its key, the first dispatch of a
# (kind, kernel, B, T) shape; their seconds are that first dispatch's wall,
# which on the card includes building the CUDA kernels at first use
C_COMPILES = obs.counter(
    "reporter_compile_total",
    "First-dispatch (compiling) device calls per padded shape bucket",
    ("shape", "kernel"))
C_COMPILE_S = obs.counter(
    "reporter_compile_seconds_total",
    "Wall seconds spent blocked in first-dispatch (compiling) calls",
    ("shape", "kernel"))
C_DISPATCHES = obs.counter(
    "reporter_dispatch_total",
    "Device batch dispatches by viterbi kernel (scan / assoc)",
    ("kernel",))
C_DISPATCH_COHORT = obs.counter(
    "reporter_dispatch_cohort_total",
    "Device dispatches by trace cohort (bucketed = length-bucket batches, "
    "long = carry-chain groups, session = per-vehicle incremental steps) "
    "and program kind (compact / pre / chain / carry / step; "
    "docs/performance.md)",
    ("cohort", "kind"))
C_WARM_SHAPES = obs.counter(
    "reporter_warmup_shapes_total",
    "Shapes pre-dispatched by warmup, by viterbi kernel",
    ("kernel",))
C_WARM_S = obs.counter(
    "reporter_warmup_seconds_total",
    "Wall seconds spent in warmup pre-dispatch passes")
C_TRACES = obs.counter(
    "reporter_traces_matched_total", "Traces run through host association")
C_POINTS = obs.counter(
    "reporter_points_matched_total", "Valid trace points run through host association")
C_BREAKS = obs.counter(
    "reporter_transition_breaks_total",
    "Points flagged as HMM discontinuities (includes window starts)")
C_PROBES = obs.counter(
    "reporter_ubodt_probe_total",
    "Sampled UBODT transition-probe outcomes (ops/diagnostics.py; enable "
    "with REPORTER_OBS_PROBE_EVERY=N)",
    ("outcome",))
G_DEDUP_RATIO = obs.gauge(
    "reporter_probe_dedup_ratio",
    "Sampled in-batch UBODT probe redundancy: probe pairs / distinct "
    "(src, dst) pairs in the last sampled dispatch — the factor the "
    "probe-dedup path removes (docs/performance.md; sampled with "
    "REPORTER_OBS_PROBE_EVERY=N)")
PROBE_OUTCOMES = ("pairs", "miss", "costly_miss", "beyond_delta")


def _probe_totals() -> Dict[str, int]:
    """reporter_ubodt_probe_total by outcome (an outcome not counted yet
    reads 0 and is not created)."""
    got = dict(C_PROBES._items())
    return {k: int(got[(k,)].value) if (k,) in got else 0 for k in PROBE_OUTCOMES}

# chunks allowed in flight on the device while the host associates
# earlier ones; each pins its packed input and output
PIPELINE_DEPTH = 8

# long traces: window outputs allowed to wait on the device before one
# concatenated fetch; each pins its packed output (12*B_pad*W bytes)
MAX_DEFERRED_CHUNKS = 64


def _join(parts, dim: int) -> torch.Tensor:
    """The dp ranks' blocks of one output joined along ``dim`` on rank 0's
    device."""
    return collectives.all_gather(list(parts), dim)[0]


def _bucket_for(buckets, n: int) -> int:
    """Smallest of ``buckets`` >= n, else the next power of two of the
    largest that holds n."""
    b = next((int(b) for b in buckets if n <= b), None)
    if b is None:
        b = int(buckets[-1])
        while b < n:
            b <<= 1
    return b


def _pad_rows(pad: int, *arrays):
    """Append ``pad`` all-zero (= all-invalid) rows to each [B, ...] array."""
    return tuple(np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
                 for a in arrays)


class SegmentMatcher:
    def __init__(
        self,
        network: Optional[RoadNetwork] = None,
        config: Optional[MatcherConfig] = None,
        arrays: Optional[GraphArrays] = None,
        ubodt: Optional[UBODT] = None,
        device="cuda",
        backend: str = "jax",
    ):
        self.cfg = config or MatcherConfig()
        if backend not in ("jax", "cpu"):
            raise ValueError("unknown backend %r (jax or cpu)" % (backend,))
        # "jax" (the reference's name for its device program): the port's
        # device program on ``device``; "cpu": the CPU baseline on the
        # host, only where the caller or the service config asks for it
        self.backend = backend
        if backend == "cpu":
            self._mesh, self._n_dp, self.device = None, 1, torch.device("cpu")
        else:
            # the device mesh first: the table's placement and the session
            # slab shard against it
            self._mesh = self._make_mesh(device)
            self._n_dp = 1 if self._mesh is None else self._mesh.n_dp
            if isinstance(device, (list, tuple)):
                (device,) = device[:1]
            self.device = (self._mesh.dp_devices[0] if self._mesh is not None
                           else resolve_device(device))
        if arrays is None:
            if network is None:
                raise ValueError("need a network or prebuilt arrays")
            arrays = build_graph_arrays(
                network, cell_size=max(100.0, 2.0 * self.cfg.search_radius))
        if arrays.cell_size < 2.0 * self.cfg.search_radius:
            raise ValueError(
                "spatial grid cell_size %.1f < 2*search_radius %.1f: the 2x2 "
                "quadrant candidate sweep would miss candidates; rebuild the "
                "grid with a larger cell_size"
                % (arrays.cell_size, 2.0 * self.cfg.search_radius))
        self.arrays = arrays
        self.ubodt_layout, self.probe_dedup = self._memory_options()
        self._kernel_mode = (os.environ.get("REPORTER_VITERBI", "").strip().lower()
                             or self.cfg.viterbi_kernel or "scan")
        if self._kernel_mode not in ("scan", "assoc", "auto"):
            raise ValueError("REPORTER_VITERBI/viterbi_kernel must be "
                             "scan|assoc|auto, got %r" % (self._kernel_mode,))
        self._assoc_threshold = int(self.cfg.viterbi_assoc_threshold)
        if ubodt is None:
            ubodt = build_ubodt(arrays, delta=self.cfg.ubodt_delta,
                                layout=self.ubodt_layout)
        elif ubodt.layout != self.ubodt_layout:
            ubodt = ubodt.relayout(self.ubodt_layout)
        self.ubodt = ubodt
        self._quality_aux = bool(self.cfg.quality_aux)
        # route-consistent interpolation default; a request's
        # match_options.interpolate overrides it either way
        env_ip = os.environ.get("REPORTER_INTERPOLATE", "").strip().lower()
        self._interpolate = (env_ip not in ("0", "false", "off", "no") if env_ip
                             else bool(self.cfg.interpolate))
        # the tiered table: $REPORTER_UBODT_HOT_BYTES (or ubodt_hot_bytes)
        # > 0 keeps only a hot arena of bucket rows on the device, the full
        # table in pinned host memory (tiles/tiering.py; same answers);
        # $REPORTER_UBODT_SHARD = "i/N" seeds the arena with that range
        env_hot = os.environ.get("REPORTER_UBODT_HOT_BYTES", "").strip()
        try:
            self._ubodt_hot_bytes = int(env_hot) if env_hot else int(
                self.cfg.ubodt_hot_bytes or 0)
        except ValueError:
            raise ValueError("REPORTER_UBODT_HOT_BYTES must be an integer "
                             "byte count, got %r" % (env_hot,))
        self.ubodt_shard = parse_shard(
            os.environ.get("REPORTER_UBODT_SHARD", "").strip()
            or self.cfg.ubodt_shard or "")
        self._params = MatchParams.from_config(self.cfg)
        self._params_cache: Dict[tuple, MatchParams] = {}
        # the sparse-gap model: off unless cfg.sparse or $REPORTER_SPARSE
        # (the CPU baseline decodes every trace with the dense model)
        self.sparse = SparseModel(self.cfg, arrays.cell_size)
        self._dispatch_count = 0
        # (kind, kernel, B, T) shapes that have had their first dispatch
        self._compiled_shapes: set = set()
        self._compiled_lock = threading.Lock()
        self._probe_pending: List[torch.Tensor] = []
        self._probe_lock = threading.Lock()
        self._probe_samples = 0
        self._probe_base = _probe_totals()
        self._dedup_ratio: Optional[float] = None
        if backend == "cpu":
            self._init_cpu()
        else:
            self._init_device()

    def _init_cpu(self):
        """The CPU baseline over the same arrays and table: no device
        copies, tiering, session slab or sampled diagnostic."""
        from ..baseline.cpu_matcher import CPUViterbiMatcher

        self._ranks = self._dg = self._du = None
        self.tiering = self.session_arena = None
        self._probe_every = 0
        self._cpu = CPUViterbiMatcher(self.arrays, self.ubodt, self.cfg)
        self._cpu_params_cache: Dict[tuple, object] = {}

    def _init_device(self):
        """The graph and table on the device (on each dp rank of a mesh),
        the tiered table, the session slab and the sampled diagnostic."""
        arrays, ubodt = self.arrays, self.ubodt
        # each dp rank's (graph, table) views; rank 0's are self._dg/_du
        self._ranks = None
        if self._mesh is not None:
            self._ranks = list(zip(place(self._mesh, "dg", arrays.device_graph()),
                                   place(self._mesh, "du", ubodt.device_ubodt())))
            self._dg = self._ranks[0][0]
        else:
            self._dg = arrays.to_device(self.device)
        self.tiering = None
        if self._ubodt_hot_bytes > 0:
            if self._mesh is not None:
                raise ValueError("a tiered UBODT (ubodt_hot_bytes) on a device "
                                 "mesh is not carried by this port yet")
            self.tiering = TieredTable(ubodt, self._ubodt_hot_bytes,
                                       shard=self.ubodt_shard,
                                       device=self.device)
            self._du = self.tiering.device()
        elif self._mesh is not None:
            self._du = self._ranks[0][1]
        else:
            self._du = ubodt.to_device(self.device)
        # carried session beams in a device slab (matching/arena.py); off
        # by default, the serve entry point turns it on
        self.session_arena = None
        if self.cfg.session_arena:
            env_b = os.environ.get("REPORTER_SESSION_ARENA_BYTES", "").strip()
            env_cb = os.environ.get("REPORTER_SESSION_ARENA_COLD_BYTES",
                                    "").strip()
            try:
                hot_b = int(env_b) if env_b else int(
                    self.cfg.session_arena_bytes or 0)
                cold_b = int(env_cb) if env_cb else int(
                    self.cfg.session_arena_cold_bytes or 0)
            except ValueError:
                raise ValueError(
                    "REPORTER_SESSION_ARENA_BYTES/_COLD_BYTES must be integer "
                    "byte counts, got %r/%r" % (env_b, env_cb))
            self.session_arena = SessionArena(
                self.cfg.beam_k, int(self.cfg.max_sessions), self.device,
                hot_bytes=hot_b, cold_bytes=cold_b, mesh=self._mesh)
        # the sampled probe-outcome diagnostic: every Nth dense bucketed
        # dispatch (0 = off); results stay on the device until a collect
        try:
            self._probe_every = int(os.environ.get("REPORTER_OBS_PROBE_EVERY",
                                                   "0"))
        except ValueError:
            self._probe_every = 0
        if self._probe_every and self._mesh is not None and self._mesh.n_gp > 1:
            # as in the reference, whose sampled program cannot probe a
            # table split over gp ranks
            log.warning("probe-outcome sampling is off on a gp mesh")
            self._probe_every = 0

    def _make_mesh(self, device) -> Optional[Mesh]:
        """The dp x gp mesh of ``cfg.devices`` ranks ($REPORTER_DEVICES,
        $REPORTER_GRAPH_DEVICES over the config; the resolved counts are
        written back into ``self.cfg``, a copy), None for one device.  Its
        devices are ``device`` when that is a list (ranks may repeat a
        device), else the visible cards, which must be enough; any other
        single device than ``"cuda"`` raises on a mesh."""
        counts = {}
        for env_key, name in (("REPORTER_DEVICES", "devices"),
                              ("REPORTER_GRAPH_DEVICES", "graph_devices")):
            raw = os.environ.get(env_key, "").strip()
            try:
                counts[name] = int(raw) if raw else int(getattr(self.cfg, name))
            except ValueError:
                raise ValueError("%s must be an integer device count, got %r"
                                 % (env_key, raw))
        n_total = max(1, counts["devices"])
        n_gp = max(1, counts["graph_devices"])
        if n_total & (n_total - 1) or n_gp & (n_gp - 1):
            raise ValueError(
                "cfg.devices/graph_devices must be powers of two, got %d/%d"
                % (n_total, n_gp))
        if n_total % n_gp:
            raise ValueError("cfg.graph_devices=%d must divide devices=%d"
                             % (n_gp, n_total))
        self.cfg = dataclasses.replace(self.cfg, devices=n_total,
                                       graph_devices=n_gp)
        devices = list(device) if isinstance(device, (list, tuple)) else None
        if n_total == 1:
            if devices is not None and len(devices) != 1:
                raise ValueError("a list of %d devices for a 1-device matcher"
                                 % len(devices))
            return None
        if devices is None and torch.device(
                "cuda" if device is None else device) != torch.device("cuda"):
            raise ValueError(
                "a %d-device mesh runs on the visible cards (device='cuda') or "
                "on an explicit device list, not on device=%r"
                % (n_total, str(device)))
        if n_gp > 1:
            return make_mesh2(n_total // n_gp, n_gp, devices)
        return make_mesh(n_total, devices)

    def _rung(self, n: int) -> int:
        """Rows of a dispatch of ``n`` rows: its ladder rung, rounded up to
        a multiple of the mesh's dp ranks (each takes an equal block)."""
        r = self._ladder_rung(n)
        return -(-r // self._n_dp) * self._n_dp

    def _memory_options(self):
        """(layout, dedup): $REPORTER_UBODT_LAYOUT / $REPORTER_PROBE_DEDUP
        over the config's ubodt_layout / probe_dedup."""
        layout = (os.environ.get("REPORTER_UBODT_LAYOUT", "").strip().lower()
                  or self.cfg.ubodt_layout or "cuckoo")
        if layout not in LAYOUTS:
            raise ValueError("REPORTER_UBODT_LAYOUT/ubodt_layout must be "
                             "cuckoo|wide32, got %r" % (layout,))
        env = os.environ.get("REPORTER_PROBE_DEDUP", "").strip().lower()
        dedup = (env not in ("0", "false", "off", "no") if env
                 else bool(self.cfg.probe_dedup))
        return layout, dedup

    def _kernel_for(self, T: int) -> str:
        """The Viterbi forward for padded window length T: the configured
        one, or under "auto" the assoc forward at or above the threshold."""
        if self._kernel_mode != "auto":
            return self._kernel_mode
        return "assoc" if T >= self._assoc_threshold else "scan"

    # -- per-request match parameters (reference wire contract) -----------

    _PARAM_KEYS = ("sigma_z", "beta", "search_radius", "gps_accuracy")

    def effective_match_options(self, match_options) -> dict:
        """The HMM parameters this matcher uses for a request carrying
        ``match_options``: overrides applied, invalid values ignored,
        search_radius clamped to cell_size/2."""
        mo = match_options if isinstance(match_options, dict) else {}

        def _num(key, default):
            v = mo.get(key)
            try:
                v = float(v)
            except (TypeError, ValueError):
                return float(default)
            return v if v > 0 and np.isfinite(v) else float(default)

        # gps_accuracy sets sigma_z only when sigma_z itself is absent
        sigma = _num("sigma_z", _num("gps_accuracy", self.cfg.sigma_z))
        radius = _num("search_radius", self.cfg.search_radius)
        out = {
            "sigma_z": sigma,
            "beta": _num("beta", self.cfg.beta),
            "search_radius": clamp_radius(radius, self.arrays.cell_size),
            "shape_match": mo.get("shape_match", "map_snap"),
        }
        if radius > float(self.arrays.cell_size) / 2.0:
            out["search_radius_clamped"] = True
        return out

    def _interp_indices(self, traces):
        """Indices of the traces whose association runs through the
        route-consistent interpolation (a request's
        match_options.interpolate, else the matcher's default); None when
        none does."""
        out = None
        for i, tr in enumerate(traces):
            mo = tr.get("match_options") if isinstance(tr, dict) else None
            want = self._interpolate
            if isinstance(mo, dict) and "interpolate" in mo:
                want = bool(mo["interpolate"])
            if want:
                out = out or set()
                out.add(i)
        return out

    def _params_key(self, trace) -> tuple:
        """() for the config defaults, else the effective (sigma_z, beta,
        search_radius) triple."""
        mo = trace.get("match_options") if isinstance(trace, dict) else None
        if not isinstance(mo, dict) or not any(k in mo for k in self._PARAM_KEYS):
            return ()
        eff = self.effective_match_options(mo)
        key = (eff["sigma_z"], eff["beta"], eff["search_radius"])
        if key == (float(self.cfg.sigma_z), float(self.cfg.beta),
                   float(self.cfg.search_radius)):
            return ()
        return key

    def _cpu_for(self, pkey: tuple):
        """The CPU baseline of a params group: the default one, or a
        ``CPUViterbiMatcher`` over the same arrays and table with the
        group's (sigma_z, beta, search_radius) in its config; cached,
        bounded."""
        if not pkey:
            return self._cpu
        cpu = self._cpu_params_cache.get(pkey)
        if cpu is None:
            from ..baseline.cpu_matcher import CPUViterbiMatcher

            if len(self._cpu_params_cache) >= 16:
                self._cpu_params_cache.clear()
            cpu = CPUViterbiMatcher(self.arrays, self.ubodt, dataclasses.replace(
                self.cfg, sigma_z=pkey[0], beta=pkey[1], search_radius=pkey[2]))
            self._cpu_params_cache[pkey] = cpu
        return cpu

    def _params_for(self, pkey: tuple) -> MatchParams:
        """MatchParams for a params group (() = the shared default); cached,
        bounded."""
        if not pkey:
            return self._params
        mp = self._params_cache.get(pkey)
        if mp is None:
            if len(self._params_cache) >= 64:
                self._params_cache.clear()
            mp = MatchParams.from_config(dataclasses.replace(
                self.cfg, sigma_z=pkey[0], beta=pkey[1], search_radius=pkey[2]))
            self._params_cache[pkey] = mp
        return mp

    # -- batching ----------------------------------------------------------

    # batch-dimension padding ladder: B snaps up to a small fixed set
    _BATCH_LADDER = (1, 4, 16, 64, 128, 256, 512, 1024, 2048)

    @classmethod
    def _ladder_rung(cls, B: int) -> int:
        """Smallest _BATCH_LADDER rung >= B (next power of two beyond)."""
        B_pad = next((r for r in cls._BATCH_LADDER if r >= B), None)
        if B_pad is None:
            B_pad = 1
            while B_pad < B:
                B_pad <<= 1
        return B_pad

    def _device_cap(self, blen: int) -> int:
        """Rows per device batch for window length blen: bound B*T (the
        program materialises [B, T, K, K]) with a row cap on top, rounded
        down to a ladder rung so padding cannot overshoot the bound."""
        cap = max(1, min(int(self.cfg.max_device_batch),
                         int(self.cfg.max_device_points) // blen))
        rung = self._BATCH_LADDER[0]
        for r in self._BATCH_LADDER:
            if r <= cap:
                rung = r
        if cap > self._BATCH_LADDER[-1]:  # beyond the ladder: power of two
            rung = cap
            while rung & (rung - 1):
                rung &= rung - 1
        return rung

    def _bucket_len(self, n: int) -> int:
        """Smallest length bucket >= n; past the largest (the CPU baseline,
        which does not window long traces) the next power of two."""
        return _bucket_for(self.cfg.length_buckets, n)

    @property
    def max_trace_points(self) -> int:
        """The longest trace matched in one window; longer ones stream
        through windows of this length with carried state."""
        return int(self.cfg.length_buckets[-1])

    def _fill_rows(self, traces, idxs, T):
        """Pack traces[idxs] into padded [B, T] arrays + per-row times (the
        reference's per-row loop; times rebase to the trace start before
        the float32 cast, since epoch seconds have ~2 min float32
        resolution)."""
        B = len(idxs)
        px = np.zeros((B, T), np.float32)
        py = np.zeros((B, T), np.float32)
        tm = np.zeros((B, T), np.float32)
        valid = np.zeros((B, T), bool)
        times = []
        for row, i in enumerate(idxs):
            pts = traces[i]["trace"]
            lats = np.array([p["lat"] for p in pts], np.float64)
            lons = np.array([p["lon"] for p in pts], np.float64)
            x, y = self.arrays.proj.to_xy(lats, lons)
            px[row, : len(pts)] = x
            py[row, : len(pts)] = y
            ts = [float(p["time"]) for p in pts]
            tm[row, : len(pts)] = np.asarray(ts) - ts[0]
            valid[row, : len(pts)] = True
            times.append(ts)
        return px, py, tm, valid, times

    def _sparse_row_factor(self, slabel: str, pkey: tuple = ()) -> int:
        """How many dense rows one row of a sparse cohort costs in the B*T
        device budget: the transition tensor is [B, T, K, K], so the
        cohort's K inflates it by (K_sp/K)^2."""
        if not slabel:
            return 1
        _p, _sp, k_sp = self.sparse.params_for(slabel, pkey)
        k0 = max(1, int(self.cfg.beam_k))
        return max(1, (k_sp * k_sp) // (k0 * k0))

    def _dispatch_batch(self, px, py, times, valid, pkey: tuple = (),
                        slabel: str = ""):
        """Queue one padded [B, T] batch on the device without blocking;
        returns (packed [3, B, T], aux [B, 4]) device tensors.  ``slabel``
        (a sparse cohort) dispatches the sparse program with the cohort's
        parameters and K.  The CPU baseline runs the batch here and returns
        ("cpu", (edge, offset, breaks))."""
        # fault seam: a probe-program failure mid-call, per chunk
        faults.maybe_raise("ubodt_probe")
        if self.backend == "cpu":
            return "cpu", self._cpu_for(pkey).run_batch(px, py, times, valid)
        xin = pack_inputs(px, py, times, valid)
        p, sp, k = (self.sparse.params_for(slabel, pkey) if slabel
                    else (self._params_for(pkey), None, self.cfg.beam_k))
        kernel = self._kernel_for(px.shape[1])
        args = (p, k, sp, self.probe_dedup, kernel)
        t0 = time.monotonic()
        if self._mesh is None:
            xin = upload(xin, self.device)
            out = match_batch_compact_packed_aux(self._dg, self._du, xin, *args)
        else:
            with self._mesh.lock:
                parts = [match_batch_compact_packed_aux(dg, du, x, *args)
                         for (dg, du), x in zip(self._ranks,
                                                place(self._mesh, "xin", xin))]
                out = (_join([pt[0] for pt in parts], 1),
                       _join([pt[1] for pt in parts], 0))
        C_DISPATCHES.labels(kernel).inc()
        C_DISPATCH_COHORT.labels("bucketed", "sparse" if slabel else "compact").inc()
        self._note_dispatch(px.shape, time.monotonic() - t0,
                            "sparse" if slabel else "", kernel)
        if self._probe_every and not slabel:
            self._dispatch_count += 1
            if self._dispatch_count % self._probe_every == 0:
                self._record_probe_stats(upload(xin, self.device)
                                         if isinstance(xin, np.ndarray) else xin)
        return out

    def _note_dispatch(self, shape, dt: float, kind: str = "",
                       kernel: str = "scan") -> None:
        """Feed the compile counters on a shape's first dispatch: ``shape``
        is the padded (B, T), ``kind`` the program ("" the bucketed
        program, "sparse", "pre", "chain", "session", "arena_session" and
        their sparse_ forms) and ``kernel`` the Viterbi forward ("none"
        for the precompute).  ``dt`` is the dispatch call's wall; on the
        card the first one includes building the CUDA kernels."""
        key = (kind, kernel) + tuple(int(v) for v in shape)
        with self._compiled_lock:
            if key in self._compiled_shapes:
                return
            self._compiled_shapes.add(key)
        lbl = kind + "%dx%d" % tuple(int(v) for v in shape)
        C_COMPILES.labels(lbl, kernel).inc()
        C_COMPILE_S.labels(lbl, kernel).inc(dt)
        obs_log.event(log, "compile_stall", shape=lbl, kernel=kernel,
                      seconds=round(dt, 3))

    def _record_probe_stats(self, xin) -> None:
        """Queue the probe-outcome diagnostic over a dispatched batch at the
        default parameters; the result is read at the next collect (at
        most two wait: an older one is read here)."""
        res = ubodt_probe_stats(self._dg, self._du, xin, self._params,
                                self.cfg.beam_k, float(self.cfg.ubodt_delta))
        with self._probe_lock:
            self._probe_pending.append(res)
            drain = self._probe_pending[:-2]
            del self._probe_pending[:-2]
        for r in drain:
            self._consume_probe(r)

    def _consume_probe(self, res) -> None:
        stats = [int(v) for v in res.cpu()]
        self._probe_samples += 1
        for i, key in enumerate(PROBE_OUTCOMES):
            C_PROBES.labels(key).inc(stats[i])
        if stats[4] > 0:  # pairs / distinct: the redundancy dedup removes
            self._dedup_ratio = stats[0] / stats[4]
            G_DEDUP_RATIO.set(self._dedup_ratio)

    @property
    def probe_stats(self) -> dict:
        """The sampled probe diagnostic since this matcher was built: the
        samples it read, ``reporter_ubodt_probe_total``'s outcomes counted
        since (the process's family: another matcher's samples in that
        time count too) and its last pairs / distinct ratio."""
        now = _probe_totals()
        out: dict = {"samples": self._probe_samples}
        out.update({k: now[k] - self._probe_base[k] for k in PROBE_OUTCOMES})
        out["dedup_ratio"] = self._dedup_ratio
        return out

    def _harvest(self) -> None:
        """Collect-side reads of what the dispatches left on the device:
        sampled probe stats, the dedup probes' distinct counts and the
        tiered table's fetch totals (which may run a maintenance pass)."""
        with self._probe_lock:
            pending, self._probe_pending = self._probe_pending, []
        for r in pending:
            self._consume_probe(r)
        DEDUP.harvest()
        if self.tiering is not None:
            self.tiering.drain_stats()

    def _collect_batch(self, handle):
        """Block on a dispatch -> ((edge, offset, breaks), aux) numpy; aux
        is None on the CPU baseline."""
        if isinstance(handle[0], str):
            return handle[1], None
        packed, aux = handle
        out = unpack_compact(packed.cpu().numpy()), aux.cpu().numpy()
        self._harvest()
        return out

    # -- public API ----------------------------------------------------------

    def match_many(self, traces: Sequence[dict]) -> List[dict]:
        """Each trace: {"uuid":..., "trace":[{"lat","lon","time",...},...]}.
        Returns one match dict {"segments": [...]} per trace, in order."""
        return self.match_many_async(traces)()

    def match_many_async(self, traces: Sequence[dict]):
        """Dispatch the device work for ``traces`` and return a zero-arg
        ``finish()`` that blocks on the device, runs host association and
        returns the results.  At most PIPELINE_DEPTH chunks stay in flight;
        excess chunks are drained inline during dispatch."""
        # fault seam: the uuid: form fires for any batch holding the poison
        # trace, which the MicroBatcher's bisect-retry isolates
        faults.maybe_raise("dispatch", key=",".join(
            str(t.get("uuid", "")) for t in traces if isinstance(t, dict)))
        results: List[Optional[dict]] = [None] * len(traces)
        # buckets by (params group, sparse cohort label, padded length);
        # the label is "" for dense traces and whenever the model is off
        buckets: Dict[tuple, List[int]] = {}
        long_map: Dict[tuple, List[int]] = {}
        interp = self._interp_indices(traces)
        for i, tr in enumerate(traces):
            n = len(tr["trace"])
            if n == 0:
                results[i] = {"segments": []}
                continue
            pkey = self._params_key(tr)
            # the CPU baseline decodes every trace dense, as the reference's
            slabel = ((self.sparse.label_for_trace(tr) or "") if self.backend == "jax"
                      else "")
            if n > self.max_trace_points and self.backend == "jax":
                long_map.setdefault((pkey, slabel), []).append(i)
                continue
            buckets.setdefault((pkey, slabel, self._bucket_len(n)),
                               []).append(i)
        chunks = []
        for (pkey, slabel, blen), idxs in sorted(buckets.items()):
            # a sparse cohort's wider K shrinks the cap by (K_sp/K)^2
            cap = self._device_cap(blen * self._sparse_row_factor(slabel,
                                                                  pkey))
            if slabel:
                self.sparse.count(slabel, len(idxs))
            chunks.extend((pkey, slabel, blen, idxs[i: i + cap])
                          for i in range(0, len(idxs), cap))

        pending: deque = deque()

        def drain_one():
            idxs_, handle_, times_ = pending.popleft()
            res, aux = self._collect_batch(handle_)
            self._associate_and_store(idxs_, *res, times_, results, aux=aux,
                                      interp=interp)

        for pkey, slabel, blen, idxs in chunks:
            t0h = time.monotonic()
            px, py, tm, valid, times = self._fill_rows(traces, idxs, blen)
            px, py, tm, valid = _pad_rows(
                self._rung(len(idxs)) - len(idxs), px, py, tm, valid)
            t1h = time.monotonic()
            handle = self._dispatch_batch(px, py, tm, valid, pkey, slabel)
            obs_attrib.host_add("pack", t1h - t0h)
            obs_attrib.host_add("dispatch", time.monotonic() - t1h)
            pending.append((idxs, handle, times))
            if len(pending) >= PIPELINE_DEPTH:
                drain_one()

        # long traces queue their whole carry chains too, so every device
        # program of the call is queued before the host associates
        long_handles = []
        for (pkey, slabel), lidx in sorted(long_map.items()):
            if slabel:
                self.sparse.count(slabel, len(lidx))
            long_handles.extend(self._dispatch_long(traces, lidx, pkey,
                                                    slabel))

        def finish() -> List[dict]:
            # fault seam: a wedged device step, inside the blocking finish
            # the finisher thread and the re-attach probe both run through
            faults.hang("device_hang")
            while pending:
                drain_one()
            for h in long_handles:
                idxs_, res, times_, aux = self._fetch_long_aux(h)
                self._associate_and_store(idxs_, *res, times_, results,
                                          aux=aux, interp=interp)
            return results  # type: ignore[return-value]

        return finish

    # -- long traces: fixed windows with carried Viterbi state ---------------

    def _dispatch_long(self, traces, idxs, pkey: tuple = (), slabel: str = ""):
        """Queue the carry chains of traces longer than the largest bucket,
        in groups of up to ``_device_cap(W)`` traces (longest first, so a
        group's rows need similar window counts; a sparse cohort's cap
        shrinks by its K), and return one handle per group for
        ``_fetch_long_aux``.  Nothing blocks except the bound on what waits
        on the device: before group k is queued, group k-2's deferred
        outputs are fetched."""
        W = self.max_trace_points
        cap = self._device_cap(W * self._sparse_row_factor(slabel, pkey))
        order = sorted(idxs, key=lambda i: -len(traces[i]["trace"]))
        handles = []
        for g in range(0, len(order), cap):
            if len(handles) >= 2:
                grp, parts, tail, tms, aux = handles[-2]
                if tail is not None:
                    parts.append(unpack_compact(tail.cpu().numpy()))
                    handles[-2] = (grp, parts, None, tms, aux)
            group = order[g: g + cap]
            n_chunks = -(-max(len(traces[i]["trace"]) for i in group) // W)
            px, py, tm, valid, times = self._fill_rows(traces, group,
                                                       n_chunks * W)
            px, py, tm, valid = _pad_rows(
                self._rung(len(group)) - len(group), px, py, tm, valid)
            host_parts, outs, aux = self._dispatch_long_group(
                pack_inputs(px, py, tm, valid), n_chunks, W,
                self._params_for(pkey), pkey, slabel)
            tail = (None if not outs else outs[0] if len(outs) == 1
                    else torch.cat(outs, 2))
            handles.append((group, host_parts, tail, times, aux))
        return handles

    def _dispatch_long_group(self, xin: np.ndarray, n_chunks: int, W: int,
                             p: MatchParams, pkey: tuple = (),
                             slabel: str = ""):
        """Queue every device program of one padded long-trace group (xin
        [4, B_pad, n_chunks*W] host f32).  The carry-independent stages run
        batched across windows: the windows fold into the batch axis as
        chunk-major rows (row c*B_pad + b is window c of trace b), cut into
        "pre" dispatches of at most ``_device_cap(W)`` rows snapped to the
        batch ladder; then one chain dispatch per window carries the beam.
        Returns (host_parts, outs, aux): outputs already fetched (waves of
        MAX_DEFERRED_CHUNKS windows), the packed outputs still on the
        device in window order, and the group's [B_pad, 4] aux folded
        across seams (min / + / + / +).  A sparse cohort (``slabel``) runs
        the sparse pre and chain programs with its own parameters and K
        in place of ``p``.  On a mesh each dp rank runs its block of rows'
        windows and the outputs join on rank 0's device."""
        if self._mesh is None:
            return self._long_group(self._dg, self._du, self.device, xin,
                                    n_chunks, W, p, pkey, slabel)
        with self._mesh.lock:
            # one dispatch of the whole group counts once (rank 0's)
            parts = [self._long_group(dg, du, dev, x, n_chunks, W, p, pkey,
                                      slabel, count=r == 0)
                     for r, ((dg, du), dev, x) in enumerate(zip(
                         self._ranks, self._mesh.dp_devices,
                         np.split(xin, self._n_dp, 1)))]
        host_parts = [tuple(np.concatenate([hp[f] for hp in wave], 0)
                            for f in range(3))
                      for wave in zip(*(pt[0] for pt in parts))]
        outs = [_join(win, 1) for win in zip(*(pt[1] for pt in parts))]
        return host_parts, outs, _join([pt[2] for pt in parts], 0)

    def _long_group(self, dg, du, dev, xin: np.ndarray, n_chunks: int, W: int,
                    p: MatchParams, pkey: tuple = (), slabel: str = "",
                    count: bool = True):
        """``_dispatch_long_group`` on one device's graph ``dg`` and table
        ``du``; ``count`` feeds the dispatch families (the mesh counts its
        group once, on rank 0)."""
        B_pad = xin.shape[1]
        k = self.cfg.beam_k
        kernel = self._kernel_for(W)
        sp = None
        if slabel:
            p, sp, k = self.sparse.params_for(slabel, pkey)
        carry = initial_carry_batch(B_pad, k, dev)
        outs: list = []
        host_parts: list = []
        aux = None
        rows_all = np.ascontiguousarray(
            xin.reshape(4, B_pad, n_chunks, W).transpose(0, 2, 1, 3)
            .reshape(4, n_chunks * B_pad, W))
        cpw = max(1, self._device_cap(  # windows per pre dispatch
            W * self._sparse_row_factor(slabel, pkey)) // B_pad)
        for c0 in range(0, n_chunks, cpw):
            m = min(cpw, n_chunks - c0)
            rows = m * B_pad
            seg = rows_all[:, c0 * B_pad: c0 * B_pad + rows]
            rung = self._ladder_rung(rows)
            if rung != rows:  # all-invalid rows that no chain reads
                seg = np.concatenate(
                    [seg, np.zeros((4, rung - rows, W), np.float32)], 1)
            seg = upload(seg, dev)
            t0 = time.monotonic()
            pre = precompute_batch_packed(dg, du, seg, p, k, sp,
                                          self.probe_dedup)
            if count:
                C_DISPATCH_COHORT.labels("long", "pre").inc()
                self._note_dispatch((self._ladder_rung(rows * self._n_dp), W),
                                    time.monotonic() - t0,
                                    "sparse_pre" if slabel else "pre", "none")
            for i in range(m):
                lo, hi = i * B_pad, (i + 1) * B_pad
                win = (dg, du, slice_pre(pre, lo, hi), seg[:, lo:hi])
                t0 = time.monotonic()
                packed, aux_c, carry = chain_batch_carry_packed_aux(
                    *win, p, k, carry, sp, kernel)
                if count:
                    C_DISPATCHES.labels(kernel).inc()
                    C_DISPATCH_COHORT.labels("long", "chain").inc()
                    self._note_dispatch(
                        (B_pad * self._n_dp, W), time.monotonic() - t0,
                        "sparse_chain" if slabel else "chain", kernel)
                aux = aux_c if aux is None else torch.cat(
                    [torch.minimum(aux[:, :1], aux_c[:, :1]),
                     aux[:, 1:] + aux_c[:, 1:]], 1)
                outs.append(packed)
                if len(outs) >= MAX_DEFERRED_CHUNKS:
                    host_parts.append(unpack_compact(
                        torch.cat(outs, 2).cpu().numpy()))
                    outs.clear()
        return host_parts, outs, aux

    def _fetch_long_aux(self, handle):
        """Block on one long group -> (group, (edge, offset, breaks) numpy
        [B_pad, n_chunks*W], times, aux [len(group), 4] numpy)."""
        group, host_parts, tail, times, aux = handle
        parts = list(host_parts)
        if tail is not None:
            parts.append(unpack_compact(tail.cpu().numpy()))
        res = tuple(np.concatenate([p[f] for p in parts], axis=1)
                    for f in range(3))
        self._harvest()
        return group, res, times, aux.cpu().numpy()[: len(group)]

    def _associate_and_store(self, idxs, edge, offset, breaks, times, results,
                             aux=None, interp=None):
        """Wire-format association for the first len(idxs) rows; with
        quality diagnostics on, each result also carries a "_quality" block
        the service pops before rendering.  The traces whose index is in
        ``interp`` associate through the route-consistent interpolation
        instead (same record shape, speed-weighted boundary times)."""
        t0h = time.monotonic()
        B = len(idxs)
        T = edge.shape[1]
        abs_tm = np.zeros((B, T), np.float64)
        n_pts = np.zeros(B, np.int32)
        for row in range(B):
            n_pts[row] = len(times[row])
            abs_tm[row, : n_pts[row]] = times[row]
        seg_lists = associate_segments_batch(
            self.arrays, self.ubodt,
            edge[:B], offset[:B], breaks[:B], abs_tm, n_pts,
            queue_thresh_mps=self.cfg.queue_speed_threshold_kph / 3.6,
            back_tol=2.0 * self.cfg.sigma_z + 5.0,
        )
        in_trace = np.arange(T)[None, :] < n_pts[:, None]
        C_TRACES.inc(B)
        C_POINTS.inc(int(n_pts.sum()))
        C_BREAKS.inc(int(np.count_nonzero((breaks[:B] != 0) & in_trace)))
        for row, i in enumerate(idxs):
            results[i] = {"segments": seg_lists[row]}
        if interp:
            off32 = np.asarray(offset, np.float32)
            for row, i in enumerate(idxs):
                if i not in interp:
                    continue
                mps = [{"edge": int(edge[row, t]), "offset": float(off32[row, t]),
                        "time": float(abs_tm[row, t]), "break": bool(breaks[row, t]),
                        "shape_index": t} for t in range(int(n_pts[row]))]
                results[i] = {"segments": associate_interpolated(
                    self.arrays, self.ubodt, mps,
                    queue_thresh_mps=self.cfg.queue_speed_threshold_kph / 3.6,
                    back_tol=2.0 * self.cfg.sigma_z + 5.0)}
        obs_attrib.host_add("collect", time.monotonic() - t0h)
        if not self._quality_aux:
            return
        for row, i in enumerate(idxs):
            n = int(n_pts[row])
            q: dict = {
                "edge": [int(e) for e in edge[row, :n]],
                "n_points": n,
                "breaks": int(np.count_nonzero(breaks[row, :n])),
            }
            if aux is not None:
                mn, sm, nm, nx = (float(v) for v in aux[row])
                q["margin_min"] = round(mn, 4) if nm > 0 else None
                q["margin_mean"] = round(sm / nm, 4) if nm > 0 else None
                q["pool_exhausted_frac"] = round(nx / n, 4) if n else 0.0
            results[i]["_quality"] = q

    def match(self, trace: dict) -> dict:
        return self.match_many([trace])[0]

    # -- per-vehicle session steps: the carried beam as serving state -------

    def _session_bucket(self, n: int) -> int:
        """Smallest session window bucket >= n; past the largest (the CPU
        baseline's wide steps) the next power of two."""
        return _bucket_for(self.cfg.session_buckets, n)

    def _fill_session_rows(self, items, idxs, W):
        """Pack items[idxs]' points into padded [B, W] arrays.  Times rebase
        against each session's own t0 (not the step's first point), so the
        carried beam's float32 time frame stays coherent across the
        session."""
        B = len(idxs)
        px, py, tm = (np.zeros((B, W), np.float32) for _ in range(3))
        valid = np.zeros((B, W), bool)
        ns = []
        for row, i in enumerate(idxs):
            pts = items[i]["points"]
            n = len(pts)
            x, y = self.arrays.proj.to_xy(
                np.array([p["lat"] for p in pts], np.float64),
                np.array([p["lon"] for p in pts], np.float64))
            px[row, :n] = x
            py[row, :n] = y
            tm[row, :n] = (np.array([float(p["time"]) for p in pts], np.float64)
                           - float(items[i]["t0"]))
            valid[row, :n] = True
            ns.append(n)
        return px, py, tm, valid, ns

    def _carry_batch(self, carries, b_pad: int) -> TraceCarry:
        """Host carry dicts (None = inactive) -> one TraceCarry with leading
        [b_pad] on the device, bit for bit."""
        k = self.cfg.beam_k
        c = {"scores": np.full((b_pad, k), NEG_INF, np.float32),
             "edge": np.full((b_pad, k), -1, np.int32),
             "offset": np.zeros((b_pad, k), np.float32),
             "x": np.zeros(b_pad, np.float32), "y": np.zeros(b_pad, np.float32),
             "t": np.zeros(b_pad, np.float32), "active": np.zeros(b_pad, bool),
             "committed": np.full(b_pad, -1, np.int32)}
        for i, row in enumerate(carries):
            if row is not None:
                for name, leaf in c.items():
                    leaf[i] = row[name]
        return TraceCarry(*(upload(t.numpy(), self.device)
                            for t in carry_from_numpy(c)))

    @staticmethod
    def _carry_rows(carry: TraceCarry, b: int) -> List[dict]:
        """A TraceCarry with leading [B_pad] -> host carry dicts of its first
        b rows."""
        leaves = {n: t[:b].cpu().numpy() for n, t in zip(TraceCarry._fields, carry)}
        return [{"scores": leaves["scores"][i], "edge": leaves["edge"][i],
                 "offset": leaves["offset"][i], "x": leaves["x"][i],
                 "y": leaves["y"][i], "t": leaves["t"][i],
                 "active": bool(leaves["active"][i]),
                 "committed": leaves["committed"][i]} for i in range(b)]

    def match_sessions(self, items):
        """Synchronous ``match_sessions_async``."""
        return self.match_sessions_async(items)()

    def match_sessions_async(self, items):
        """Queue incremental session steps for ``items`` and return a
        zero-arg ``finish()`` resolving to one result per item:
        ``((edge[n], offset[n], breaks[n]) numpy, aux [4], carry)``, where
        carry is the successor beam as a host dict, or with the arena the
        session's ``ArenaRef`` (the beam stayed on the device).

        items: [{"points": [{"lat","lon","time"}...] (1..n, the arriving
        delta), "carry": host carry dict, ArenaRef or None (fresh), "t0":
        rebase epoch, "pkey": effective-params key, "uuid": session key
        (the arena's slot key)}].

        Items group by (pkey, sparse cohort label, session window bucket)
        into [B_rung, W] steps; a step over the largest bucket chains
        through windows of that size, as the long-trace path does.  A
        sparse step keeps K = ``beam_k`` (``_session_label``).

        On the CPU baseline a step is a stateless window over the arriving
        points, as in the reference: no carry in, none out (carry None),
        aux None, and a wide step is one wider window."""
        w_max = int(self.cfg.session_buckets[-1])
        groups: Dict[tuple, List[int]] = {}
        handles = []
        for i, it in enumerate(items):
            n = max(1, len(it["points"]))
            slabel = self._session_label(it)
            if n > w_max and self.backend == "jax":
                handles.append(self._dispatch_session_chain(it, i, w_max,
                                                            slabel))
                continue
            groups.setdefault((it["pkey"], slabel, self._session_bucket(n)),
                              []).append(i)
        arena = self.session_arena
        for (pkey, slabel, W), idxs in sorted(groups.items()):
            cap = self._device_cap(W)
            p, sp = self._session_params(pkey, slabel)
            for g in range(0, len(idxs), cap):
                sub = idxs[g: g + cap]
                # the windowed dispatch's fault seam, per session chunk
                faults.maybe_raise("ubodt_probe")
                px, py, tm, valid, ns = self._fill_session_rows(items, sub, W)
                if self.backend == "cpu":
                    handles.append(("cpu", sub, ns, self._cpu_for(pkey).run_batch(
                        px, py, tm, valid)))
                    continue
                px, py, tm, valid = _pad_rows(
                    self._rung(len(sub)) - len(sub), px, py, tm, valid)
                b_pad = px.shape[0]
                xin = pack_inputs(px, py, tm, valid)
                h = None
                if arena is not None and all("uuid" in items[i] for i in sub):
                    h = self._dispatch_session_arena(items, sub, ns, xin, p,
                                                     sp, slabel)
                if h is None:
                    # host-carry path: arena off, items without uuids, or
                    # a group the slab cannot hold at once (same answers)
                    carry = self._carry_batch(
                        [carry_host(items[i]["carry"]) for i in sub]
                        + [None] * (b_pad - len(sub)), b_pad)
                    if slabel:
                        self.sparse.count(slabel, len(sub))
                    t0 = time.monotonic()
                    h = ("host", sub, ns, *self._session_step(xin, p, sp,
                                                              carry))
                    self._note_session(b_pad, W, time.monotonic() - t0,
                                       "sparse_session" if slabel else "session",
                                       "sparse" if slabel else "step")
                handles.append(h)

        def finish():
            faults.hang("device_hang")  # the windowed finish's seam
            out = [None] * len(items)
            for h in handles:
                if h[0] == "cpu":
                    _kind, sub, ns, (edge, offset, breaks) = h
                    for row, i in enumerate(sub):
                        n = ns[row]
                        out[i] = ((edge[row, :n], offset[row, :n], breaks[row, :n]),
                                  None, None)
                    continue
                if h[0] in ("chain", "chain_arena"):
                    _kind, i, chunk_outs, carry = h
                    E, O, B, aux_rows = [], [], [], []
                    for packed, aux_dev, nc in chunk_outs:
                        e_, o_, b_ = unpack_compact(packed.cpu().numpy())
                        E.append(e_[0, :nc])
                        O.append(o_[0, :nc])
                        B.append(b_[0, :nc])
                        aux_rows.append(aux_dev.cpu().numpy()[0])
                    # aux components combine across seams as min / + / + / +
                    aux = np.concatenate([[min(r[0] for r in aux_rows)],
                                          np.sum([r[1:] for r in aux_rows], 0)])
                    if h[0] == "chain":
                        carry = self._carry_rows(carry, 1)[0]
                    out[i] = ((np.concatenate(E), np.concatenate(O),
                               np.concatenate(B)), aux, carry)
                    continue
                kind, sub, ns, packed, aux, carry = h
                edge, offset, breaks = unpack_compact(packed.cpu().numpy())
                aux_np = aux.cpu().numpy()
                rows = (carry if kind == "arena"
                        else self._carry_rows(carry, len(sub)))
                for row, i in enumerate(sub):
                    n = ns[row]
                    out[i] = ((edge[row, :n], offset[row, :n], breaks[row, :n]),
                              aux_np[row], rows[row])
            if self.tiering is not None:
                self.tiering.drain_stats()
            return out

        return finish

    def _session_label(self, item) -> str:
        """The sparse cohort of one session step ("" = dense).  The seam's
        gap counts: a stream of one point a minute has one-point deltas,
        and its gap lies between the carried last point and the new one.

        A carry that is neither None nor a host dict (an ``ArenaRef``: the
        beam lives in the slab) gives "", as in the reference, whose label
        reads the carried time as ``carry["t"]``, which an ``ArenaRef``
        refuses, and falls back to dense.  So with the slab only a
        session's first step (two points or more) can be sparse; the port
        copies that rule (ROADMAP.md section 3).  The CPU baseline's steps
        are dense."""
        if self.backend != "jax" or not self.sparse.enabled:
            return ""
        try:
            times = [float(p["time"]) for p in item["points"]]
            c = item.get("carry")
            if c is not None:
                if not isinstance(c, dict):
                    return ""
                times = [float(item["t0"]) + float(c["t"])] + times
        except (KeyError, TypeError, ValueError):
            return ""
        return self.sparse.label_for_times(times) or ""

    def _note_session(self, b_pad: int, W: int, dt: float, kind: str,
                      cohort: str) -> None:
        """Count one session-step dispatch of [b_pad, W] (cohort "step",
        "sparse" or "chain") and note its shape's first dispatch."""
        kernel = self._kernel_for(W)
        C_DISPATCHES.labels(kernel).inc()
        C_DISPATCH_COHORT.labels("session", cohort).inc()
        self._note_dispatch((b_pad, W), dt, kind, kernel)

    def _session_params(self, pkey: tuple, slabel: str):
        """(MatchParams, SparseParams or None) of a session step group; a
        sparse cohort's K is not used (the beam keeps ``beam_k``)."""
        if not slabel:
            return self._params_for(pkey), None
        p, sp, _k = self.sparse.params_for(slabel, pkey)
        return p, sp

    def _session_step(self, xin: np.ndarray, p: MatchParams, sp, carry,
                      slots=None, use=None):
        """One session step program over host rows ``xin``: the host-carry
        or (with ``slots``) the slab variant, dense or (with ``sp``)
        sparse.  On a mesh each dp rank steps its block of rows, the slab
        variant through the slot-sharded slab; the outputs join on rank
        0's device."""
        k = self.cfg.beam_k
        kernel = self._kernel_for(xin.shape[2])
        if self._mesh is None:
            a = (self._dg, self._du, upload(xin, self.device), p, k, carry)
            if slots is None:
                return session_step_packed(*a, sp, kernel)
            return session_step_arena(*a, slots, use, sp, kernel)
        m = self._mesh
        with m.lock:
            xins = place(m, "xin", xin)
            if slots is not None:
                packed, aux = session_step_arena_mesh(
                    self._ranks, xins, p, k, carry, slots, use, sp, kernel)
                return _join(packed, 1), _join(aux, 0), carry
            carries = zip(*(place(m, "carry", leaf) for leaf in carry))
            parts = [session_step_packed(dg, du, x, p, k, TraceCarry(*c), sp,
                                         kernel)
                     for (dg, du), x, c in zip(self._ranks, xins, carries)]
            return (_join([pt[0] for pt in parts], 1),
                    _join([pt[1] for pt in parts], 0),
                    TraceCarry(*(_join(leaves, 0)
                                 for leaves in zip(*(pt[2] for pt in parts)))))

    def _dispatch_session_arena(self, items, sub, ns, xin, p: MatchParams,
                                sp=None, slabel: str = ""):
        """One step group against the session slab: resolve each session to
        a slot, then one step that reads and writes the slab in place.
        None when the slab cannot hold the group at once."""
        arena = self.session_arena
        b_pad = xin.shape[1]
        with arena.lock:
            acq = arena.acquire_batch(
                [(str(items[i]["uuid"]), items[i].get("carry")) for i in sub])
            if acq is None:
                return None
            slot_l, use_l, refs = acq
            # padding rows name slot S: they read and write nothing
            slots = np.full(b_pad, arena.hot_slots, np.int32)
            slots[: len(sub)] = slot_l
            use = np.zeros(b_pad, bool)
            use[: len(sub)] = use_l
            if slabel:
                self.sparse.count(slabel, len(sub))
            t0 = time.monotonic()
            packed, aux, _slab = self._session_step(xin, p, sp, arena.hot,
                                                    slots, use)
        self._note_session(b_pad, xin.shape[2], time.monotonic() - t0,
                           "sparse_arena_session" if slabel else "arena_session",
                           "sparse" if slabel else "step")
        return ("arena", sub, ns, packed, aux, refs)

    def _dispatch_session_chain(self, item, idx: int, W: int,
                                slabel: str = ""):
        """One step over the largest session bucket as a chain of [1, W]
        session steps (the carry seams at W boundaries, as the long-trace
        path's): through one slab row with the arena, else through a host
        carry batch of one row; every window sparse for a sparse step."""
        pts = item["points"]
        p, sp = self._session_params(item["pkey"], slabel)
        if slabel:
            self.sparse.count(slabel)
        arena = self.session_arena
        chunk_outs = []

        n = self._rung(1)  # one row, padded to the mesh's dp ranks

        def rows(c0):
            chunk = dict(item, points=pts[c0: c0 + W])
            px, py, tm, valid, ns = self._fill_session_rows([chunk], [0], W)
            return pack_inputs(*_pad_rows(n - 1, px, py, tm, valid)), ns[0]

        if arena is not None and "uuid" in item:
            with arena.lock:
                acq = arena.acquire_batch(
                    [(str(item["uuid"]), item.get("carry"))])
                if acq is not None:
                    (slot,), (use,), (ref,) = acq
                    slots = np.full(n, arena.hot_slots, np.int32)
                    slots[0] = slot
                    for c0 in range(0, len(pts), W):
                        xin, nc = rows(c0)
                        t0 = time.monotonic()
                        packed, aux, _slab = self._session_step(
                            xin, p, sp, arena.hot, slots,
                            np.arange(n) < (1 if use else 0))
                        self._note_session(
                            n, W, time.monotonic() - t0,
                            "sparse_arena_session" if slabel
                            else "arena_session", "chain")
                        use = True
                        chunk_outs.append((packed, aux, nc))
                    return ("chain_arena", idx, chunk_outs, ref)
        carry = self._carry_batch([carry_host(item["carry"])]
                                  + [None] * (n - 1), n)
        for c0 in range(0, len(pts), W):
            xin, nc = rows(c0)
            t0 = time.monotonic()
            packed, aux, carry = self._session_step(xin, p, sp, carry)
            self._note_session(n, W, time.monotonic() - t0,
                               "sparse_session" if slabel else "session",
                               "chain")
            chunk_outs.append((packed, aux, nc))
        return ("chain", idx, chunk_outs, carry)

    def warmup(self, lengths: "Sequence[int] | None" = None,
               batch_sizes: "Sequence[int] | None" = None,
               kernels: "Sequence[str] | None" = None,
               carry_chain: bool = False,
               session_step: bool = False) -> float:
        """Pre-dispatch the hot shapes so the first real request pays
        neither the kernels' build nor a shape's first launch (the first
        launch of a shape also grows the caching allocator's pools).

        Dispatches one batch per (batch rung, length bucket, viterbi
        kernel) of dummy traces along the graph's first edge -- the full
        dispatch path, so the launch counters and the dispatch families
        see exactly what a real request would.

          lengths      length buckets to warm (default: cfg.length_buckets)
          batch_sizes  batch rungs to warm per bucket (default:
                       cfg.warmup_batch_sizes, i.e. [1]); each entry snaps
                       UP to its _BATCH_LADDER rung like real traffic
          kernels      viterbi kernels to warm (default: whatever
                       _kernel_for resolves per bucket -- exactly the
                       kernels live traffic will launch)
          carry_chain  also warm the long-trace programs (one trace of 2x
                       the largest bucket): the chunk-batched "pre"
                       dispatch (kernels 1-3 over the windows) and the
                       carried chain (kernel 5) at [1, W]; on a dp mesh a
                       4-window trace too, whose pre rows land on a higher
                       ladder rung
          session_step also warm the per-vehicle session steps: one (batch
                       rung, session bucket) grid through match_sessions
                       (on the slab when the arena is on; the throwaway
                       slots are freed without a readback)

        Counts each shape into reporter_warmup_shapes_total by kernel and
        the wall into reporter_warmup_seconds_total, as the reference does.
        The CPU baseline has nothing to warm: 0.0.  Returns seconds spent."""
        if self.backend != "jax":
            return 0.0
        t0 = time.time()
        if lengths is None:
            lengths = list(self.cfg.length_buckets)
        if batch_sizes is None:
            batch_sizes = list(self.cfg.warmup_batch_sizes or (1,))
        _dummy_traces = self.dummy_traces
        n_shapes = 0
        for n in lengths:
            n = max(2, int(n))
            want = kernels if kernels is not None else [
                self._kernel_for(self._bucket_len(n))]
            for kern in want:
                prev_mode = self._kernel_mode
                self._kernel_mode = kern
                try:
                    for b in batch_sizes:
                        b = self._ladder_rung(max(1, int(b)))
                        self.match_many(_dummy_traces(n, b))
                        n_shapes += 1
                        C_WARM_SHAPES.labels(kern).inc()
                        if self.sparse.enabled:
                            # the sparse cohort's kernels for the same
                            # shape: a dummy trace at the sparse operating
                            # gap takes the "sparse" dispatch
                            self.match_many(_dummy_traces(
                                n, b, dt=max(60.0, self.sparse.gap_s)))
                            n_shapes += 1
                            C_WARM_SHAPES.labels(kern).inc()
                finally:
                    self._kernel_mode = prev_mode
        if carry_chain and self.cfg.length_buckets:
            w = int(self.cfg.length_buckets[-1])
            self.match_many(_dummy_traces(2 * w, 1))
            # two programs: the chain above and the kernel-independent
            # chunk-batched pre dispatch
            n_shapes += 2
            C_WARM_SHAPES.labels(self._kernel_for(w)).inc()
            C_WARM_SHAPES.labels("none").inc()
            if self._n_dp > 1:
                self.match_many(_dummy_traces(4 * w, 1))
                n_shapes += 1
                C_WARM_SHAPES.labels("none").inc()
        if session_step:
            for w in (self.cfg.session_buckets or (4, 16)):
                w = max(1, int(w))
                kern = self._kernel_for(w)
                pts = _dummy_traces(max(2, w), 1)[0]["trace"][:w]
                for b in batch_sizes:
                    b = self._ladder_rung(max(1, int(b)))
                    warm_items = [
                        {"points": pts, "carry": None,
                         "t0": float(pts[0]["time"]), "pkey": ()}
                        for _ in range(b)
                    ]
                    if self.session_arena is not None:
                        # distinct uuids take the slab's step (the serving
                        # path); their slots are freed without a readback
                        for j, it in enumerate(warm_items):
                            it["uuid"] = "_warmup%d" % j
                    self.match_sessions(warm_items)
                    if self.session_arena is not None:
                        for j in range(b):
                            self.session_arena.free_uuid(
                                "_warmup%d" % j, detach=False)
                    n_shapes += 1
                    C_WARM_SHAPES.labels(kern).inc()
        dt = time.time() - t0
        C_WARM_S.inc(dt)
        log.info("matcher warmup: %d shapes in %.1fs", n_shapes, dt)
        return dt

    def dummy_traces(self, n: int, b: int, dt: float = 5.0) -> List[dict]:
        """``b`` copies of an ``n``-point synthetic trace along the graph's
        first edge, ``dt`` seconds apart: the re-attach probe's input,
        through the full dispatch path."""
        ax, ay, bx, by = self._probe_edge_coords()
        lat, lon = self.arrays.proj.to_latlon(np.linspace(ax, bx, n),
                                              np.linspace(ay, by, n))
        tr = {"uuid": "_warmup",
              "trace": [{"lat": float(a), "lon": float(o), "time": 1.0 + float(dt) * i}
                        for i, (a, o) in enumerate(zip(lat, lon))]}
        return [tr] * b

    def _probe_edge_coords(self):
        """Endpoints of the graph's first edge (the dummy traces' span)."""
        a = self.arrays
        return (float(a.node_x[a.edge_from[0]]), float(a.node_y[a.edge_from[0]]),
                float(a.node_x[a.edge_to[0]]), float(a.node_y[a.edge_to[0]]))

    def Match(self, trace_json: str) -> str:
        """Wire-compatible single-trace entry (valhalla SegmentMatcher.Match)."""
        return json.dumps(self.match(json.loads(trace_json)),
                          separators=(",", ":"))

