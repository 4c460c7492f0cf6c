"""Brute-force third matcher: the oracle that shares no machinery.

A copy of the reference's ``baseline/brute_matcher.py``.  The CPU baseline
(cpu_matcher.py) is deliberately bit-exact with the device program --
float32 cell math, the quadrant sweep's pool truncation, the UBODT's delta
bound -- which makes the backend diff blind to a bug in any rule both
share.  This matcher speaks the same HMM semantics with none of that:

  * exhaustive candidates: every edge is scanned, point-to-segment
    distance in float64 -- no spatial grid, no float32 cell arithmetic, no
    4K-pool truncation, no beam cap (tiny fixtures keep the candidate
    count within the device's K so the comparison stays meaningful;
    ``candidate_counts`` lets a test assert that precondition);
  * exact route distances: a fresh Dijkstra per (node, node) probe in
    float64 over the raw adjacency -- no UBODT, no delta truncation, no
    hash tables (memoised per source node, which changes nothing);
  * float64 scoring end to end.

It is slow (tiny fixtures only).  The triple agreement (device path ==
CPU baseline == brute oracle) on several topologies means a shared-rule
bug has to be re-invented here independently to stay hidden.
"""

from __future__ import annotations

import heapq
import math
from typing import Dict, List, Tuple

import numpy as np

NEG_INF = -1e30


class BruteForceMatcher:
    """Exhaustive-candidate, exact-Dijkstra, float64 HMM matcher.

    ``sparse``: optional dict of the sparse-gap model's values
    (beta_ref_s, beta_scale, beta_max, break_speed_mps, vmax_mps,
    plaus_weight — matching/sparse.SparseModel.oracle_values) — the f64
    re-derivation of ops/viterbi.SparseParams' time-adaptive transition
    model and gap-conditioned breakage.  The oracle must speak the SAME
    model as the device when judging a sparse-cohort decode: a model
    improvement scored against a dense-model oracle would read as a
    regression.  None = the dense model, exactly as before."""

    def __init__(self, arrays, cfg, sparse: "dict | None" = None):
        self.a = arrays
        self.cfg = cfg
        self.sparse = dict(sparse) if sparse else None
        self._route_cache: Dict[int, Tuple[Dict[int, float], Dict[int, float]]] = {}
        self._seg_geom = None  # lazy f64 segment geometry (candidates())

    # -- sparse-gap model (keep in lock-step with ops/viterbi.py) -----------

    def _beta(self, dt: float) -> float:
        """beta(dt): the time-adaptive tolerance family (sparse_beta)."""
        beta = float(self.cfg.beta)
        if not self.sparse or dt <= 0:
            return beta
        ref = max(float(self.sparse.get("beta_ref_s", 15.0)), 1.0)
        scale = float(self.sparse.get("beta_scale", 1.0))
        mult = 1.0 + scale * max(dt - ref, 0.0) / ref
        return beta * min(mult, float(self.sparse.get("beta_max", 8.0)))

    def _breakage(self, dt: float) -> float:
        """Gap-conditioned breakage threshold (sparse_breakage)."""
        base = float(self.cfg.breakage_distance)
        if not self.sparse:
            return base
        return max(base, float(self.sparse.get("break_speed_mps", 34.0))
                   * max(dt, 0.0))

    # -- exhaustive candidates (float64, no grid) ---------------------------

    def candidates(self, x: float, y: float) -> List[Tuple[int, float, float]]:
        """[(edge, offset_m, dist_m)] for EVERY edge within search_radius,
        nearest first.  Distances in float64 against every shape segment of
        every edge — no spatial index at all.  The sweep itself is one
        vectorised numpy pass (elementwise f64 math; numpy releases the GIL
        in the array ops, which matters where a quality sampler runs this
        oracle on a thread beside live serving); only the handful of
        in-radius segments fall back to a Python reduction."""
        a = self.a
        if self._seg_geom is None:
            ax = np.asarray(a.shp_ax, np.float64)
            ay = np.asarray(a.shp_ay, np.float64)
            vx = np.asarray(a.shp_bx, np.float64) - ax
            vy = np.asarray(a.shp_by, np.float64) - ay
            self._seg_geom = (ax, ay, vx, vy, vx * vx + vy * vy,
                              np.asarray(a.shp_off, np.float64),
                              np.asarray(a.shp_len, np.float64))
        ax, ay, vx, vy, L2, shp_off, shp_len = self._seg_geom
        safe_l2 = np.where(L2 == 0.0, 1.0, L2)
        t = ((x - ax) * vx + (y - ay) * vy) / safe_l2
        t = np.where(L2 == 0.0, 0.0, np.minimum(1.0, np.maximum(0.0, t)))
        d = np.hypot(x - (ax + t * vx), y - (ay + t * vy))
        best: Dict[int, Tuple[float, float]] = {}  # edge -> (dist, offset)
        for s in np.nonzero(d <= float(self.cfg.search_radius))[0]:
            e = int(a.shp_edge[s])
            ds = float(d[s])
            if e not in best or ds < best[e][0]:
                best[e] = (ds, float(shp_off[s]) + float(t[s]) * float(shp_len[s]))
        out = [(e, off, dd) for e, (dd, off) in best.items()]
        out.sort(key=lambda c: c[2])
        return out

    # -- exact route distances (float64 Dijkstra, no UBODT) -----------------

    def _routes_from(self, src: int):
        """(dist, time) maps from node src over the whole graph — exact,
        unbounded.  Cached per source (pure memoisation)."""
        hit = self._route_cache.get(src)
        if hit is not None:
            return hit
        a = self.a
        dist = {src: 0.0}
        time = {src: 0.0}
        done = set()
        heap = [(0.0, src)]
        while heap:
            d, n = heapq.heappop(heap)
            if n in done:
                continue
            done.add(n)
            for k in range(int(a.out_start[n]), int(a.out_start[n + 1])):
                e = int(a.out_edges[k])
                m = int(a.edge_to[e])
                nd = d + float(a.edge_len[e])
                if nd < dist.get(m, math.inf):
                    dist[m] = nd
                    time[m] = time[n] + float(a.edge_len[e]) / max(
                        float(a.edge_speed[e]), 0.1)
                    heapq.heappush(heap, (nd, m))
        self._route_cache[src] = (dist, time)
        return dist, time

    def _transition(self, ca, cb, gc: float, dt: float) -> float:
        """Transition log-prob between two candidates, NEG_INF if
        infeasible.  Same rules as the production kernels, re-derived in
        float64 with exact routes."""
        a, cfg = self.a, self.cfg
        ea, oa, _ = ca
        eb, ob, _ = cb
        same_known = False
        if ea == eb and ob >= oa:
            route = ob - oa
            rtime = route / max(float(a.edge_speed[ea]), 0.1)
            same_known = True
        elif ea == eb and (oa - ob) <= 2.0 * cfg.sigma_z + 5.0:
            # small backward jitter on one edge: lightly penalised
            route = (oa - ob) * 1.05 + 1.0
            rtime = (oa - ob) / max(float(a.edge_speed[ea]), 0.1)
            same_known = True
        else:
            dist_map, time_map = self._routes_from(int(a.edge_to[ea]))
            nd = int(a.edge_from[eb])
            if nd not in dist_map:
                return NEG_INF
            route = (float(a.edge_len[ea]) - oa) + dist_map[nd] + ob
            rtime = ((float(a.edge_len[ea]) - oa)
                     / max(float(a.edge_speed[ea]), 0.1)
                     + time_map[nd]
                     + ob / max(float(a.edge_speed[eb]), 0.1))
        if route > cfg.max_route_distance_factor * (gc + cfg.search_radius):
            return NEG_INF
        if dt > 0 and rtime > cfg.max_route_time_factor * max(dt, 1.0):
            return NEG_INF
        beta_t = self._beta(dt)
        logp = -abs(route - gc) / beta_t
        if cfg.turn_penalty_factor > 0.0 and not same_known:
            turn = float(a.edge_head0[eb]) - float(a.edge_head1[ea])
            turn = abs((turn + math.pi) % (2.0 * math.pi) - math.pi)
            logp -= cfg.turn_penalty_factor * turn / (math.pi * beta_t)
        if self.sparse and dt > 0:
            # drivable-speed plausibility (the f64 twin of the device term)
            vmax = max(float(self.sparse.get("vmax_mps", 45.0)), 1.0)
            implied = route / max(dt, 1.0)
            if implied > vmax:
                logp -= (float(self.sparse.get("plaus_weight", 3.0))
                         * (implied - vmax) / vmax)
        return logp

    # -- viterbi ------------------------------------------------------------

    def match_points(self, xs, ys, times):
        """(edge[T], offset[T], breaks[T]) numpy; edge=-1 unmatched.  Same
        contract as CPUViterbiMatcher.match_points."""
        T = len(xs)
        edge = np.full(T, -1, np.int64)
        offset = np.zeros(T, np.float64)
        breaks = np.zeros(T, bool)
        if T == 0:
            return edge, offset, breaks
        cands = [self.candidates(float(xs[t]), float(ys[t])) for t in range(T)]
        sigma = float(self.cfg.sigma_z)

        # forward pass, segmented at breaks
        score = [[-0.5 * (c[2] / sigma) ** 2 for c in cands[0]]]
        bptr: List[List[int]] = [[-1] * len(cands[0])]
        seg_bounds = [0]
        for t in range(1, T):
            gc = math.hypot(float(xs[t] - xs[t - 1]),
                            float(ys[t] - ys[t - 1]))
            dt = float(times[t] - times[t - 1])
            prev, cur = cands[t - 1], cands[t]
            sc = [NEG_INF] * len(cur)
            bp = [-1] * len(cur)
            broke = (gc > self._breakage(dt) or not prev
                     or not cur or max(score[-1], default=NEG_INF) <= NEG_INF / 2)
            if not broke:
                for j, cj in enumerate(cur):
                    for i, ci in enumerate(prev):
                        if score[-1][i] <= NEG_INF / 2:
                            continue
                        v = score[-1][i] + self._transition(ci, cj, gc, dt)
                        if v > sc[j]:
                            sc[j], bp[j] = v, i
                if all(v <= NEG_INF / 2 for v in sc):
                    broke = True
            if broke:
                seg_bounds.append(t)
                sc = [-0.5 * (c[2] / sigma) ** 2 for c in cur]
                bp = [-1] * len(cur)
                breaks[t] = True
            else:
                sc = [v + -0.5 * (cur[j][2] / sigma) ** 2
                      if v > NEG_INF / 2 else NEG_INF
                      for j, v in enumerate(sc)]
            score.append(sc)
            bptr.append(bp)
        seg_bounds.append(T)

        # backtrace each segment from its best final state
        for s0, s1 in zip(seg_bounds, seg_bounds[1:]):
            sc = score[s1 - 1]
            if not sc or max(sc) <= NEG_INF / 2:
                continue
            j = int(np.argmax(sc))
            for t in range(s1 - 1, s0 - 1, -1):
                if j < 0 or not cands[t]:
                    break
                edge[t] = cands[t][j][0]
                offset[t] = cands[t][j][1]
                j = bptr[t][j] if t > s0 else -1
        breaks[0] = True
        return edge, offset, breaks

    def run_batch(self, px, py, times, valid):
        """Same contract as CPUViterbiMatcher.run_batch / the device path."""
        B, T = px.shape
        edge = np.full((B, T), -1, np.int64)
        offset = np.zeros((B, T), np.float64)
        breaks = np.zeros((B, T), bool)
        for b in range(B):
            n = int(valid[b].sum())
            if n == 0:
                continue
            e, o, br = self.match_points(px[b, :n], py[b, :n], times[b, :n])
            edge[b, :n] = e
            offset[b, :n] = o
            breaks[b, :n] = br
        return edge, offset, breaks

    def candidate_counts(self, xs, ys) -> List[int]:
        """Candidates within radius per point — tests assert max() <=
        beam_k so the exhaustive pool and the device's K-beam see the same
        candidate sets and the triple agreement is meaningful."""
        return [len(self.candidates(float(x), float(y)))
                for x, y in zip(xs, ys)]
