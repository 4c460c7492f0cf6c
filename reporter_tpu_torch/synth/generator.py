"""Synthetic GPS trace generation with ground truth.

A copy of the reference's ``TraceSynthesizer``: route between random nodes
by travel time, sample positions every ``dt`` seconds while driving the
path at edge speed, and add AR(1) Gaussian noise
(e_t = rho * e_{t-1} + N(0, sigma * sqrt(1 - rho^2))).  The same seed on
the same graph gives the same traces as the reference's generator.

Also the reference's helpers around it: ``dryrun_scenario`` (a tiny grid
city's config, arrays and table), ``cohort_xy`` (synthesized traces packed
into padded [B, T] arrays), ``example_grid_batch`` (jittered drives along
grid rows) and ``segment_agreement`` (the fraction of samples matched to
their ground-truth segment).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..tiles.arrays import GraphArrays


@dataclass
class SyntheticTrace:
    trace: dict  # wire-format request {"uuid", "trace": [...], "match_options": ...}
    truth_edge: np.ndarray  # [T] ground-truth edge id per sample
    truth_seg: np.ndarray  # [T] dense segment index per sample (-1 none)
    xy: np.ndarray  # [T, 2] noiseless positions (projected metres)


class TraceSynthesizer:
    def __init__(self, arrays: GraphArrays, seed: int = 0):
        self.arrays = arrays
        self.rng = np.random.default_rng(seed)

    # -- routing ----------------------------------------------------------

    def route(self, src: int, dst: int) -> Optional[List[int]]:
        """Shortest path (by travel time) edge list src -> dst."""
        a = self.arrays
        dist: Dict[int, float] = {src: 0.0}
        prev_edge: Dict[int, int] = {}
        heap = [(0.0, src)]
        done = set()
        while heap:
            d, n = heapq.heappop(heap)
            if n in done:
                continue
            if n == dst:
                break
            done.add(n)
            for k in range(a.out_start[n], a.out_start[n + 1]):
                e = int(a.out_edges[k])
                m = int(a.edge_to[e])
                nd = d + float(a.edge_len[e]) / max(float(a.edge_speed[e]), 0.1)
                if nd < dist.get(m, float("inf")):
                    dist[m] = nd
                    prev_edge[m] = e
                    heapq.heappush(heap, (nd, m))
        if dst not in prev_edge and dst != src:
            return None
        edges: List[int] = []
        n = dst
        while n != src:
            e = prev_edge[n]
            edges.append(e)
            n = int(self.arrays.edge_from[e])
        return list(reversed(edges))

    # -- walking ----------------------------------------------------------

    def walk(self, edges: List[int], dt: float, t0: float = 0.0,
             dt_jitter: float = 0.0):
        """Sample positions every dt seconds while driving the edge path at
        edge speed.  Returns (xy [T,2], times [T], edge_ids [T]).

        ``dt_jitter``: per-sample gap noise as a fraction of dt — each
        inter-sample gap is drawn uniform from [dt*(1-j), dt*(1+j)], so a
        "60 s" fleet stops being suspiciously metronomic (loadgen
        --gap-jitter).  0 draws NOTHING from the rng: existing seeded
        corpora stay bit-identical."""
        a = self.arrays
        xs, ts, eids = [], [], []
        t = t0
        next_sample = t0
        j = max(0.0, min(float(dt_jitter), 0.9))
        for e in edges:
            length = float(a.edge_len[e])
            speed = max(float(a.edge_speed[e]), 0.1)
            x0, y0 = float(a.node_x[a.edge_from[e]]), float(a.node_y[a.edge_from[e]])
            x1, y1 = float(a.node_x[a.edge_to[e]]), float(a.node_y[a.edge_to[e]])
            edge_t = length / speed
            while next_sample <= t + edge_t:
                f = (next_sample - t) / edge_t if edge_t > 0 else 0.0
                xs.append((x0 + f * (x1 - x0), y0 + f * (y1 - y0)))
                ts.append(next_sample)
                eids.append(e)
                if j > 0.0:
                    next_sample += dt * float(
                        self.rng.uniform(1.0 - j, 1.0 + j))
                else:
                    next_sample += dt
            t += edge_t
        return np.asarray(xs), np.asarray(ts), np.asarray(eids, np.int64)

    # -- public -----------------------------------------------------------

    def synthesize(
        self,
        n_points: int,
        dt: float = 15.0,
        sigma: float = 5.0,
        rho: float = 0.5,
        uuid: str = "synth",
        t0: float = 1_460_000_000.0,
        report_levels=(0, 1, 2),
        transition_levels=(0, 1, 2),
        max_tries: int = 20,
        dt_jitter: float = 0.0,
    ) -> SyntheticTrace:
        """A trace of exactly n_points samples along a random route.
        ``dt_jitter`` adds per-point gap noise (see walk); 0 keeps seeded
        corpora bit-identical."""
        a = self.arrays
        # chain random destinations until the drive is long enough: small
        # networks have no single route of arbitrary duration
        need_time = n_points * dt
        edges: List[int] = []
        cur = int(self.rng.integers(0, a.num_nodes))
        consecutive_fails = 0
        for _ in range(max_tries):
            total_time = sum(
                float(a.edge_len[e]) / max(float(a.edge_speed[e]), 0.1) for e in edges
            )
            if total_time > need_time:
                break
            dst = int(self.rng.integers(0, a.num_nodes))
            if dst == cur:
                continue
            leg = self.route(cur, dst)
            if not leg:
                # real graphs have sink nodes (oneway dead-ends, motorway
                # tails).  A stuck START is re-drawn immediately; a sink
                # reached MID-chain can't continue either, so after a few
                # failed destinations the whole chain restarts from a fresh
                # start node rather than burning every remaining try.
                consecutive_fails += 1
                if not edges or consecutive_fails >= 8:
                    edges = []
                    cur = int(self.rng.integers(0, a.num_nodes))
                    consecutive_fails = 0
                continue
            consecutive_fails = 0
            edges.extend(leg)
            cur = dst
        xy, ts, eids = self.walk(edges, dt, t0=0.0, dt_jitter=dt_jitter) \
            if edges else (np.zeros((0, 2)), np.zeros(0), np.zeros(0, np.int64))
        if len(xy) < n_points:
            raise RuntimeError("could not draw a route long enough for %d points" % n_points)

        xy = xy[:n_points]
        ts = ts[:n_points]
        eids = eids[:n_points]

        # AR(1) noise per axis, stationary at sigma: seed e_0 ~ N(0, sigma)
        # *before* the recursion so the autocorrelation holds from the start
        noise = np.zeros((n_points, 2))
        scale = sigma * np.sqrt(max(1.0 - rho * rho, 1e-9))
        noise[0] = self.rng.normal(0, sigma, 2)
        for t in range(1, n_points):
            noise[t] = rho * noise[t - 1] + self.rng.normal(0, scale, 2)
        noisy = xy + noise

        lat, lon = a.proj.to_latlon(noisy[:, 0], noisy[:, 1])
        trace = {
            "uuid": uuid,
            "trace": [
                {
                    "lat": float(la),
                    "lon": float(lo),
                    "time": float(t0 + t),
                    "accuracy": int(max(1, round(sigma))),
                }
                for la, lo, t in zip(lat, lon, ts)
            ],
            "match_options": {
                "mode": "auto",
                "report_levels": list(report_levels),
                "transition_levels": list(transition_levels),
            },
        }
        truth_seg = np.where(eids >= 0, a.edge_seg[eids], -1)
        return SyntheticTrace(trace=trace, truth_edge=eids, truth_seg=truth_seg, xy=xy)

    def batch(self, n_traces: int, n_points: int, **kw) -> List[SyntheticTrace]:
        return [
            self.synthesize(n_points, uuid="synth-%d" % i, **kw) for i in range(n_traces)
        ]


def dryrun_scenario(rows: int = 5, cols: int = 5, spacing_m: float = 150.0,
                    delta: float = 1500.0):
    """(cfg, arrays, ubodt) for a tiny deterministic grid city."""
    from ..matching.config import MatcherConfig
    from ..tiles.arrays import build_graph_arrays
    from ..tiles.network import grid_city
    from ..tiles.ubodt import build_ubodt

    cfg = MatcherConfig()
    city = grid_city(rows=rows, cols=cols, spacing_m=spacing_m)
    arrays = build_graph_arrays(city, cell_size=100.0)
    ubodt = build_ubodt(arrays, delta=delta)
    return cfg, arrays, ubodt


def cohort_xy(arrays: GraphArrays, straces: "List[SyntheticTrace]", T: int):
    """Pack synthesized traces into padded [B, T] arrays (px, py,
    rebased times, valid).  Times rebase to each trace's start before the
    float32 cast: epoch seconds have ~2 min float32 resolution."""
    B = len(straces)
    px = np.zeros((B, T), np.float32)
    py = np.zeros((B, T), np.float32)
    tm = np.zeros((B, T), np.float32)
    valid = np.ones((B, T), bool)
    for i, s in enumerate(straces):
        pts = s.trace["trace"]
        x, y = arrays.proj.to_xy([p["lat"] for p in pts], [p["lon"] for p in pts])
        px[i], py[i] = x, y
        tm[i] = np.asarray([p["time"] for p in pts]) - pts[0]["time"]
    return px, py, tm, valid


def example_grid_batch(arrays: GraphArrays, B: int, T: int, seed: int = 0):
    """Padded [B, T] batch of jittered straight drives along grid-city rows."""
    rng = np.random.default_rng(seed)
    px = np.zeros((B, T), np.float32)
    py = np.zeros((B, T), np.float32)
    times = np.tile(np.arange(T, dtype=np.float32)[None] * 15.0, (B, 1))
    valid = np.ones((B, T), bool)
    # the grid's column count from x-coordinate uniqueness
    cols = len(np.unique(np.round(arrays.node_x, 3)))
    rows = arrays.num_nodes // cols
    for b in range(B):
        r = b % min(rows, 5)
        row_nodes = [r * cols + c for c in range(min(cols, 5))]
        t = np.linspace(0.05, 0.9, T)
        px[b] = np.interp(t, np.linspace(0, 1, len(row_nodes)), arrays.node_x[row_nodes]) + rng.normal(0, 3, T)
        py[b] = np.interp(t, np.linspace(0, 1, len(row_nodes)), arrays.node_y[row_nodes]) + rng.normal(0, 3, T)
    return px, py, times, valid


def segment_agreement(arrays: GraphArrays, matched_edges: np.ndarray, truth: SyntheticTrace) -> float:
    """Fraction of samples whose matched OSMLR segment equals the
    ground-truth segment."""
    matched_seg = np.where(matched_edges >= 0, arrays.edge_seg[np.maximum(matched_edges, 0)], -1)
    return float((matched_seg == truth.truth_seg).mean())
