"""Pure-CPU baseline matcher: the diff oracle and the bench's baseline.

A copy of the reference's ``baseline/cpu_matcher.py``: a per-trace Viterbi
with the same emission and transition model as the device program
(ops/viterbi.py), in plain numpy and Python loops with no batching.
``SegmentMatcher(backend="cpu")`` runs it on the host.  Its jobs: the
single-process CPU traces/s a bench's ``vs_baseline`` is taken against,
and the oracle the device path's answers are diffed with.

It is a literal mirror of the device rules, with the reference's own
float32 choices (``geo.point_segment_distance_f32``, whose ``jnp.hypot``
expansion keeps subnormals as the reference's does), and is not adjusted
toward the port's device path: where the two part, they part as the
reference's JAX path and CPU backend do.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .. import geo

NEG_INF = -1e30


class CPUViterbiMatcher:
    def __init__(self, arrays, ubodt, cfg):
        self.arrays = arrays
        self.ubodt = ubodt
        self.cfg = cfg

    # -- candidate lookup (numpy over shape segments in the 2x2 quadrant
    # cell block -- the same rule as the device sweep, ops/candidates.py:
    # cell_size >= 2*search_radius makes only the neighbour on the point's
    # own side of each axis reachable).  NB sharing the rule means the
    # backend diff cannot catch a bug in the rule itself; the independent
    # checks are agreement against synthesized ground truth and the brute
    # oracle (brute_matcher.py), which do not pass through this code. -----

    def _candidates(self, x: float, y: float) -> List[Tuple[int, float, float]]:
        """[(edge, offset_m, dist_m)] within the search radius, one per edge,
        nearest K first.

        A literal mirror of the device sweep (ops/candidates.py
        find_candidates), including its rounding and tie-breaks -- a ranking
        that differs in the last ulp flips near-tie candidates (e.g. the
        forward vs reverse edge of a two-way road) and breaks byte-exact
        backend parity:

        - cell selection in float32 (the device's fx/fy/sx/sy arithmetic on
          the f32 grid origin), with out-of-range neighbours clamped;
        - the four cell rows visited in the device's (y-outer, x-inner)
          stacking order, first occurrence kept per shape row;
        - projection distances in float32 with jnp.hypot's exact expansion
          (geo.point_segment_distance_f32);
        - the pool truncation to the min(4K, 4*cap) nearest shape segments
          BEFORE per-edge dedup (lax.top_k order: distance, then pool
          position), which at dense geometry can drop or worsen an edge the
          full scan would keep -- the oracle must drop it identically.
        """
        a = self.arrays
        f32 = np.float32
        fx = (f32(x) - f32(a.grid_x0)) / f32(a.cell_size)
        fy = (f32(y) - f32(a.grid_y0)) / f32(a.cell_size)
        cx = int(np.clip(np.floor(fx), 0, a.grid_nx - 1))
        cy = int(np.clip(np.floor(fy), 0, a.grid_ny - 1))
        sx = 1 if fx - np.floor(fx) >= 0.5 else -1
        sy = 1 if fy - np.floor(fy) >= 0.5 else -1
        # duplicates from border-clamped cells are KEPT (the device gathers
        # the clamped cell twice, and its copies occupy pool slots before
        # the per-edge dedup); only the empty (-1) slots drop out, whose
        # device distance is BIG and so sort behind every real entry anyway
        items: List[int] = []
        for gy in (cy, min(max(cy + sy, 0), a.grid_ny - 1)):
            for gx in (cx, min(max(cx + sx, 0), a.grid_nx - 1)):
                for s in a.grid_items[gy * a.grid_nx + gx]:
                    if s >= 0:
                        items.append(int(s))
        if not items:
            return []
        si = np.array(items, np.int64)
        d, t = geo.point_segment_distance_f32(x, y, a.shp_ax[si], a.shp_ay[si], a.shp_bx[si], a.shp_by[si])
        d = np.where(d <= f32(self.cfg.search_radius), d, np.inf)
        # pool narrowing + dedup in (distance, block-position) order; stable
        # argsort == lax.top_k's lower-index-first tie rule
        m = min(4 * self.cfg.beam_k, 4 * a.grid_items.shape[1])
        pool = np.argsort(d, kind="stable")[:m]
        cands: List[Tuple[int, float, float]] = []
        seen_edges = set()
        for k in pool:
            if not np.isfinite(d[k]):
                break  # pool is distance-sorted: the rest are misses
            e = int(a.shp_edge[si[k]])
            if e in seen_edges:
                continue
            seen_edges.add(e)
            off = float(a.shp_off[si[k]] + t[k] * f32(a.shp_len[si[k]]))
            cands.append((e, off, float(d[k])))
            if len(cands) == self.cfg.beam_k:
                break
        return cands

    # -- transition ---------------------------------------------------------

    def _transition(self, ca, cb, gc: float, dt: float) -> float:
        a = self.arrays
        ea, oa, _ = ca
        eb, ob, _ = cb
        same_known = False  # forward or jitter movement within one edge
        if ea == eb and ob >= oa:
            route = ob - oa
            rtime = route / max(float(a.edge_speed[ea]), 0.1)
            same_known = True
        elif ea == eb and (oa - ob) <= 2.0 * self.cfg.sigma_z + 5.0:
            route = (oa - ob) * 1.05 + 1.0
            rtime = (oa - ob) / max(float(a.edge_speed[ea]), 0.1)
            same_known = True
        else:
            sp, sp_time, _ = self.ubodt.lookup_full(int(a.edge_to[ea]), int(a.edge_from[eb]))
            if not np.isfinite(sp):
                return NEG_INF
            route = (float(a.edge_len[ea]) - oa) + sp + ob
            rtime = (float(a.edge_len[ea]) - oa) / max(float(a.edge_speed[ea]), 0.1) \
                + sp_time + ob / max(float(a.edge_speed[eb]), 0.1)
        cfg = self.cfg
        if route > cfg.max_route_distance_factor * (gc + cfg.search_radius):
            return NEG_INF
        if dt > 0 and rtime > cfg.max_route_time_factor * max(dt, 1.0):
            return NEG_INF
        logp = -abs(route - gc) / cfg.beta
        if cfg.turn_penalty_factor > 0.0 and not same_known:
            turn = abs(_angle_diff(float(a.edge_head1[ea]), float(a.edge_head0[eb])))
            logp -= cfg.turn_penalty_factor * turn / (np.pi * cfg.beta)
        return logp

    # -- viterbi ------------------------------------------------------------

    def match_points(self, xs: np.ndarray, ys: np.ndarray, times: np.ndarray):
        """Returns (edge[T], offset[T], breaks[T]) numpy arrays; edge=-1 where
        unmatched."""
        T = len(xs)
        cands = [self._candidates(float(xs[t]), float(ys[t])) for t in range(T)]
        sigma = self.cfg.sigma_z
        emis = [
            [-0.5 * (c[2] / sigma) ** 2 for c in cands[t]]
            for t in range(T)
        ]

        edge = np.full(T, -1, np.int64)
        offset = np.zeros(T, np.float64)
        breaks = np.zeros(T, bool)

        if T == 0:
            return edge, offset, breaks
        backptr: List[List[int]] = [[]]
        seg_start = 0
        seg_ranges: List[Tuple[int, int]] = []  # (start, end) of HMM segments
        scores = emis[0][:]
        all_scores = [scores[:]]

        for t in range(1, T):
            gc = float(np.hypot(xs[t] - xs[t - 1], ys[t] - ys[t - 1]))
            dt = float(times[t] - times[t - 1])
            broke = gc > self.cfg.breakage_distance or not scores or not cands[t]
            new_scores = []
            bp = []
            if not broke:
                any_conn = False
                for j, cj in enumerate(cands[t]):
                    best, arg = NEG_INF, -1
                    for i, ci in enumerate(cands[t - 1]):
                        if scores[i] <= NEG_INF / 2:
                            continue
                        lp = self._transition(ci, cj, gc, dt)
                        if scores[i] + lp > best:
                            best, arg = scores[i] + lp, i
                    if best > NEG_INF / 2:
                        any_conn = True
                    new_scores.append(best + emis[t][j] if best > NEG_INF / 2 else NEG_INF)
                    bp.append(arg)
                if not any_conn:
                    broke = True
            if broke:
                seg_ranges.append((seg_start, t))
                seg_start = t
                new_scores = emis[t][:]
                bp = [-1] * len(cands[t])
                breaks[t] = True
            scores = new_scores
            backptr.append(bp)
            all_scores.append(scores[:])
        seg_ranges.append((seg_start, T))

        # backtrace within each HMM segment
        for s0, s1 in seg_ranges:
            sc = all_scores[s1 - 1]
            if not sc or max(sc) <= NEG_INF / 2:
                continue
            j = int(np.argmax(sc))
            for t in range(s1 - 1, s0 - 1, -1):
                if j < 0 or not cands[t]:
                    break
                edge[t] = cands[t][j][0]
                offset[t] = cands[t][j][1]
                j = backptr[t][j] if t > s0 else -1
        return edge, offset, breaks

    def run_batch(self, px: np.ndarray, py: np.ndarray, times: np.ndarray, valid: np.ndarray):
        """[B, T] padded batch -> per-point (edge, offset, breaks), the
        device program's contract."""
        B, T = px.shape
        edge = np.full((B, T), -1, np.int64)
        offset = np.zeros((B, T), np.float64)
        breaks = np.zeros((B, T), bool)
        for b in range(B):
            n = int(valid[b].sum())
            if n == 0:  # batch-padding dummy row
                continue
            e, o, br = self.match_points(px[b, :n], py[b, :n], times[b, :n])
            edge[b, :n] = e
            offset[b, :n] = o
            breaks[b, :n] = br
            breaks[b, 0] = True
        return edge, offset, breaks


def _angle_diff(a: float, b: float) -> float:
    d = b - a
    return (d + np.pi) % (2.0 * np.pi) - np.pi
