"""SegmentMatcher: the public matching API of the port.

Wire-compatible with the reference's ``SegmentMatcher`` on its bucketed
dense path: ``Match(json) -> json``, ``match(trace)``, ``match_many`` and
``match_many_async``.  Traces are bucketed by padded length
(``length_buckets``), grouped by effective per-request parameters
(``match_options`` sigma_z / beta / search_radius / gps_accuracy), padded
to a batch-ladder rung, packed into one [4, B, T] float32 array and matched
on ``device`` by the four-kernel program of ops/viterbi.py; host
association (native core, or its Python twin) turns the [3, B, T] result
into wire-format segments.

Not in this port yet: traces longer than the largest bucket (the
long-trace carry chain; ``match_many`` raises NotImplementedError for
them), the sparse-gap model, sessions, probe dedup, tiering and meshes.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.viterbi import (
    MatchParams, match_batch_compact_packed_aux, pack_inputs, unpack_compact,
)
from ..tiles.arrays import GraphArrays, build_graph_arrays
from ..tiles.network import RoadNetwork
from ..tiles.ubodt import UBODT, build_ubodt
from .assoc_native import associate_segments_batch
from .config import MatcherConfig

log = logging.getLogger(__name__)

# chunks allowed in flight on the device while the host associates
# earlier ones; each pins its packed input and output
PIPELINE_DEPTH = 8


class LongTraceNotSupported(NotImplementedError):
    """A trace longer than the largest length bucket: it needs the
    long-trace carry chain, a later slice of the port."""


def clamp_radius(radius: float, cell_size: float) -> float:
    """min(radius, cell_size/2): the bound that keeps the 2x2 quadrant
    candidate sweep exhaustive; a clamp is logged."""
    max_radius = float(cell_size) / 2.0
    if radius <= max_radius:
        return float(radius)
    log.warning("search_radius %.3f clamped to %.3f (the 2x2 quadrant sweep "
                "requires radius <= cell_size/2)", radius, max_radius)
    return max_radius


class SegmentMatcher:
    def __init__(
        self,
        network: Optional[RoadNetwork] = None,
        config: Optional[MatcherConfig] = None,
        arrays: Optional[GraphArrays] = None,
        ubodt: Optional[UBODT] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = config or MatcherConfig()
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
        if ubodt is None:
            ubodt = build_ubodt(arrays, delta=self.cfg.ubodt_delta)
        self.ubodt = ubodt
        self._quality_aux = bool(self.cfg.quality_aux)
        self._dg = arrays.to_device(self.device)
        self._du = ubodt.to_device(self.device)
        self._params = MatchParams.from_config(self.cfg)
        self._params_cache: Dict[tuple, MatchParams] = {}

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
        for b in self.cfg.length_buckets:
            if n <= b:
                return b
        raise LongTraceNotSupported(
            "trace of %d points exceeds the largest length bucket (%d); "
            "long traces need the long-trace carry chain, a later slice of "
            "the port" % (n, self.max_trace_points))

    @property
    def max_trace_points(self) -> int:
        return int(self.cfg.length_buckets[-1])

    def check_supported(self, trace: dict) -> None:
        """Raise LongTraceNotSupported for a trace this port cannot match."""
        n = len(trace["trace"])
        if n > self.max_trace_points:
            self._bucket_len(n)

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

    def _dispatch_batch(self, px, py, times, valid, pkey: tuple = ()):
        """Queue one padded [B, T] batch on the device without blocking;
        returns (packed [3, B, T], aux [B, 4]) device tensors."""
        xin = torch.from_numpy(pack_inputs(px, py, times, valid))
        if self.device.type == "cuda":
            xin = xin.pin_memory().to(self.device, non_blocking=True)
        return match_batch_compact_packed_aux(
            self._dg, self._du, xin, self._params_for(pkey), self.cfg.beam_k)

    @staticmethod
    def _collect_batch(handle):
        """Block on a dispatch -> ((edge, offset, breaks), aux) numpy."""
        packed, aux = handle
        return unpack_compact(packed.cpu().numpy()), aux.cpu().numpy()

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
        results: List[Optional[dict]] = [None] * len(traces)
        buckets: Dict[tuple, List[int]] = {}
        for i, tr in enumerate(traces):
            n = len(tr["trace"])
            if n == 0:
                results[i] = {"segments": []}
                continue
            buckets.setdefault((self._params_key(tr), self._bucket_len(n)),
                               []).append(i)
        chunks = []
        for (pkey, blen), idxs in sorted(buckets.items()):
            cap = self._device_cap(blen)
            chunks.extend((pkey, blen, idxs[i: i + cap])
                          for i in range(0, len(idxs), cap))

        pending: deque = deque()

        def drain_one():
            idxs_, handle_, times_ = pending.popleft()
            res, aux = self._collect_batch(handle_)
            self._associate_and_store(idxs_, *res, times_, results, aux=aux)

        for pkey, blen, idxs in chunks:
            px, py, tm, valid, times = self._fill_rows(traces, idxs, blen)
            B_pad = self._ladder_rung(len(idxs))
            if B_pad != len(idxs):  # all-zero pad rows = all invalid
                pad = B_pad - len(idxs)
                px, py, tm, valid = (
                    np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
                    for a in (px, py, tm, valid))
            pending.append((idxs, self._dispatch_batch(px, py, tm, valid, pkey),
                            times))
            if len(pending) >= PIPELINE_DEPTH:
                drain_one()

        def finish() -> List[dict]:
            while pending:
                drain_one()
            return results  # type: ignore[return-value]

        return finish

    def _associate_and_store(self, idxs, edge, offset, breaks, times, results,
                             aux=None):
        """Wire-format association for the first len(idxs) rows; with
        quality diagnostics on, each result also carries a "_quality" block
        the service pops before rendering."""
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
        for row, i in enumerate(idxs):
            results[i] = {"segments": seg_lists[row]}
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

    def Match(self, trace_json: str) -> str:
        """Wire-compatible single-trace entry (valhalla SegmentMatcher.Match)."""
        return json.dumps(self.match(json.loads(trace_json)),
                          separators=(",", ":"))

