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

Not in this port yet: route-consistent interpolation, probe dedup,
tiering and meshes.
"""

from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..convert import carry_from_numpy
from ..device import resolve_device, upload
from ..ops.viterbi import (
    NEG_INF, MatchParams, TraceCarry, chain_batch_carry_packed_aux,
    initial_carry_batch, match_batch_compact_packed_aux, pack_inputs,
    precompute_batch_packed, session_step_arena, session_step_packed,
    slice_pre, unpack_compact,
)
from ..tiles.arrays import GraphArrays, build_graph_arrays
from ..tiles.network import RoadNetwork
from ..tiles.ubodt import UBODT, build_ubodt
from .arena import SessionArena, carry_host
from .assoc_native import associate_segments_batch
from .config import MatcherConfig
from .sparse import SparseModel, clamp_radius

# chunks allowed in flight on the device while the host associates
# earlier ones; each pins its packed input and output
PIPELINE_DEPTH = 8

# long traces: window outputs allowed to wait on the device before one
# concatenated fetch; each pins its packed output (12*B_pad*W bytes)
MAX_DEFERRED_CHUNKS = 64


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
        # the sparse-gap model: off unless cfg.sparse or $REPORTER_SPARSE
        self.sparse = SparseModel(self.cfg, arrays.cell_size)
        # carried session beams in a device slab (matching/arena.py); off
        # by default, the serve entry point turns it on
        self.session_arena = None
        if self.cfg.session_arena:
            self.session_arena = SessionArena(
                self.cfg.beam_k, int(self.cfg.max_sessions), self.device)

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
        """Smallest length bucket >= n (n <= max_trace_points)."""
        return next(b for b in self.cfg.length_buckets if n <= b)

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
        parameters and K."""
        xin = upload(pack_inputs(px, py, times, valid), self.device)
        p, sp, k = (self.sparse.params_for(slabel, pkey) if slabel
                    else (self._params_for(pkey), None, self.cfg.beam_k))
        return match_batch_compact_packed_aux(self._dg, self._du, xin, p, k,
                                              sp)

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
        # buckets by (params group, sparse cohort label, padded length);
        # the label is "" for dense traces and whenever the model is off
        buckets: Dict[tuple, List[int]] = {}
        long_map: Dict[tuple, List[int]] = {}
        for i, tr in enumerate(traces):
            n = len(tr["trace"])
            if n == 0:
                results[i] = {"segments": []}
                continue
            pkey = self._params_key(tr)
            slabel = self.sparse.label_for_trace(tr) or ""
            if n > self.max_trace_points:
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
            self._associate_and_store(idxs_, *res, times_, results, aux=aux)

        for pkey, slabel, blen, idxs in chunks:
            px, py, tm, valid, times = self._fill_rows(traces, idxs, blen)
            px, py, tm, valid = _pad_rows(
                self._ladder_rung(len(idxs)) - len(idxs), px, py, tm, valid)
            pending.append((idxs, self._dispatch_batch(px, py, tm, valid, pkey,
                                                       slabel), times))
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
            while pending:
                drain_one()
            for h in long_handles:
                idxs_, res, times_, aux = self._fetch_long_aux(h)
                self._associate_and_store(idxs_, *res, times_, results,
                                          aux=aux)
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
                self._ladder_rung(len(group)) - len(group), px, py, tm, valid)
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
        in place of ``p``."""
        B_pad = xin.shape[1]
        k = self.cfg.beam_k
        sp = None
        if slabel:
            p, sp, k = self.sparse.params_for(slabel, pkey)
        carry = initial_carry_batch(B_pad, k, self.device)
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
            seg = upload(seg, self.device)
            pre = precompute_batch_packed(self._dg, self._du, seg, p, k, sp)
            for i in range(m):
                lo, hi = i * B_pad, (i + 1) * B_pad
                win = (self._dg, self._du, slice_pre(pre, lo, hi),
                       seg[:, lo:hi])
                packed, aux_c, carry = chain_batch_carry_packed_aux(
                    *win, p, k, carry, sp)
                aux = aux_c if aux is None else torch.cat(
                    [torch.minimum(aux[:, :1], aux_c[:, :1]),
                     aux[:, 1:] + aux_c[:, 1:]], 1)
                outs.append(packed)
                if len(outs) >= MAX_DEFERRED_CHUNKS:
                    host_parts.append(unpack_compact(
                        torch.cat(outs, 2).cpu().numpy()))
                    outs.clear()
        return host_parts, outs, aux

    @staticmethod
    def _fetch_long_aux(handle):
        """Block on one long group -> (group, (edge, offset, breaks) numpy
        [B_pad, n_chunks*W], times, aux [len(group), 4] numpy)."""
        group, host_parts, tail, times, aux = handle
        parts = list(host_parts)
        if tail is not None:
            parts.append(unpack_compact(tail.cpu().numpy()))
        res = tuple(np.concatenate([p[f] for p in parts], axis=1)
                    for f in range(3))
        return group, res, times, aux.cpu().numpy()[: len(group)]

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

    # -- per-vehicle session steps: the carried beam as serving state -------

    def _session_bucket(self, n: int) -> int:
        """Smallest session window bucket >= n (n <= the largest)."""
        return next(b for b in self.cfg.session_buckets if n <= b)

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
        sparse step keeps K = ``beam_k`` (``_session_label``)."""
        w_max = int(self.cfg.session_buckets[-1])
        groups: Dict[tuple, List[int]] = {}
        handles = []
        for i, it in enumerate(items):
            n = max(1, len(it["points"]))
            slabel = self._session_label(it)
            if n > w_max:
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
                px, py, tm, valid, ns = self._fill_session_rows(items, sub, W)
                px, py, tm, valid = _pad_rows(
                    self._ladder_rung(len(sub)) - len(sub), px, py, tm, valid)
                b_pad = px.shape[0]
                xin = upload(pack_inputs(px, py, tm, valid), self.device)
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
                    h = ("host", sub, ns, *self._session_step(xin, p, sp,
                                                              carry))
                handles.append(h)

        def finish():
            out = [None] * len(items)
            for h in handles:
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
        copies that rule (ROADMAP.md section 3)."""
        if not self.sparse.enabled:
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

    def _session_params(self, pkey: tuple, slabel: str):
        """(MatchParams, SparseParams or None) of a session step group; a
        sparse cohort's K is not used (the beam keeps ``beam_k``)."""
        if not slabel:
            return self._params_for(pkey), None
        p, sp, _k = self.sparse.params_for(slabel, pkey)
        return p, sp

    def _session_step(self, xin, p: MatchParams, sp, carry, slots=None,
                      use=None):
        """One session step program: the host-carry or (with ``slots``)
        the slab variant, dense or (with ``sp``) sparse."""
        a = (self._dg, self._du, xin, p, self.cfg.beam_k, carry)
        if slots is None:
            return session_step_packed(*a, sp)
        return session_step_arena(*a, slots, use, sp)

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
            packed, aux, _slab = self._session_step(xin, p, sp, arena.hot,
                                                    slots, use)
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

        def rows(c0):
            chunk = dict(item, points=pts[c0: c0 + W])
            px, py, tm, valid, ns = self._fill_session_rows([chunk], [0], W)
            return upload(pack_inputs(px, py, tm, valid), self.device), ns[0]

        if arena is not None and "uuid" in item:
            with arena.lock:
                acq = arena.acquire_batch(
                    [(str(item["uuid"]), item.get("carry"))])
                if acq is not None:
                    (slot,), (use,), (ref,) = acq
                    for c0 in range(0, len(pts), W):
                        xin, nc = rows(c0)
                        packed, aux, _slab = self._session_step(
                            xin, p, sp, arena.hot, np.array([slot], np.int32),
                            np.array([use]))
                        use = True
                        chunk_outs.append((packed, aux, nc))
                    return ("chain_arena", idx, chunk_outs, ref)
        carry = self._carry_batch([carry_host(item["carry"])], 1)
        for c0 in range(0, len(pts), W):
            xin, nc = rows(c0)
            packed, aux, carry = self._session_step(xin, p, sp, carry)
            chunk_outs.append((packed, aux, nc))
        return ("chain", idx, chunk_outs, carry)

    def Match(self, trace_json: str) -> str:
        """Wire-compatible single-trace entry (valhalla SegmentMatcher.Match)."""
        return json.dumps(self.match(json.loads(trace_json)),
                          separators=(",", ":"))

