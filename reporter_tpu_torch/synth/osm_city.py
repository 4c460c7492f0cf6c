"""Deterministic realistic-city OSM extract generator.

A copy of the reference's ``synth/osm_city.py``: the bench's default city
(``BENCH_SCENARIO=osm``), generated as raw OSM primitives and ingested
through the same path a downloaded extract takes (tiles/osm.py:
write_pbf -> read_pbf -> network_from_osm).  What makes it a different
workload for candidate search and the UBODT than the uniform grid:

  - jittered, curvature-warped street grid (non-uniform node spacing, cells
    with varying occupancy)
  - curved streets: interstitial shape nodes, so edges carry multi-segment
    polylines (candidate projection sees >1 shape segment per edge)
  - a road-class hierarchy: primary avenues, secondary collectors,
    residential locals with distinct speeds; diagonal tertiary avenues
    crossing the grid at acute angles (dense candidate cells)
  - one-way residential columns (asymmetric adjacency; route(a->b) !=
    route(b->a))
  - a sinusoidal river severing the grid, crossed only by sparse bridges:
    route distances explode vs straight-line distance around it (the regime
    where the |route - gc|/beta transition actually discriminates)
  - random dead-end blocks (missing edges)
  - an orbital motorway with motorway_link ramps (internal edges, no OSMLR
    ids)

Everything is seeded: the same (rows, cols, seed) yields the same extract
byte for byte, and the same extract as the reference's generator.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from ..tiles.osm import OsmWay

M_PER_DEG_LAT = 111_320.0


def realistic_city(
    rows: int = 120,
    cols: int = 120,
    spacing_m: float = 150.0,
    seed: int = 0,
    origin: Tuple[float, float] = (37.75, -122.45),
):
    """Returns (nodes, ways): raw OSM primitives for a synthetic metro.

    nodes: {osm_id: (lat, lon)}; ways: [OsmWay].  Feed to
    tiles.osm.network_from_osm (or write_pbf + network_from_file to exercise
    the codec path)."""
    rng = np.random.default_rng(seed)
    lat0, lon0 = origin
    m_per_deg_lon = M_PER_DEG_LAT * math.cos(math.radians(lat0))

    def to_latlon(x: float, y: float) -> Tuple[float, float]:
        return (round(lat0 + y / M_PER_DEG_LAT, 7),
                round(lon0 + x / m_per_deg_lon, 7))

    # ---- intersection lattice with jitter + curvature warp ---------------
    jit = rng.normal(0.0, spacing_m * 0.13, (rows, cols, 2))
    gx = np.zeros((rows, cols))
    gy = np.zeros((rows, cols))
    W, H = (cols - 1) * spacing_m, (rows - 1) * spacing_m
    for r in range(rows):
        for c in range(cols):
            x = c * spacing_m + jit[r, c, 0]
            y = r * spacing_m + jit[r, c, 1]
            # gentle metropolitan warp: streets bow around the center
            x += 0.04 * W * math.sin(math.pi * y / max(H, 1.0))
            y += 0.025 * H * math.sin(2 * math.pi * x / max(W, 1.0))
            gx[r, c], gy[r, c] = x, y

    nodes: Dict[int, Tuple[float, float]] = {}
    ways: List[OsmWay] = []
    next_aux = rows * cols + 1  # ids past the lattice are shape/ring nodes
    next_way = [1]

    def nid(r: int, c: int) -> int:
        i = r * cols + c + 1
        if i not in nodes:
            nodes[i] = to_latlon(gx[r, c], gy[r, c])
        return i

    def aux_node(x: float, y: float) -> int:
        nonlocal next_aux
        nodes[next_aux] = to_latlon(x, y)
        next_aux += 1
        return next_aux - 1

    def add_way(refs: List[int], **tags: str) -> None:
        ways.append(OsmWay(next_way[0], refs, {k: str(v) for k, v in tags.items()}))
        next_way[0] += 1

    # ---- the river: sinusoidal band through the middle -------------------
    def river_y(x: float) -> float:
        return H * 0.52 + H * 0.06 * math.sin(2.5 * math.pi * x / max(W, 1.0))

    def in_river(x: float, y: float) -> bool:
        return abs(y - river_y(x)) < spacing_m * 0.55

    bridge_cols = set(range(4, cols - 1, max(8, cols // 12)))

    # ---- street ways (one way per block, with a curve shape node) --------
    def block_way(r0, c0, r1, c1, highway, oneway=None, curve_p=0.3):
        a, b = nid(r0, c0), nid(r1, c1)
        ax, ay = gx[r0, c0], gy[r0, c0]
        bx, by = gx[r1, c1], gy[r1, c1]
        refs = [a, b]
        if rng.random() < curve_p:
            # perpendicular midpoint offset -> a curved polyline edge
            mx, my = (ax + bx) / 2, (ay + by) / 2
            dx, dy = bx - ax, by - ay
            n = math.hypot(dx, dy) or 1.0
            off = rng.normal(0, spacing_m * 0.1)
            refs = [a, aux_node(mx - dy / n * off, my + dx / n * off), b]
        tags = {"highway": highway}
        if oneway:
            tags["oneway"] = oneway
        add_way(refs, **tags)

    prim_every = max(10, rows // 8)
    sec_every = max(5, rows // 20)
    for r in range(rows):
        hw = ("primary" if r % prim_every == 0
              else "secondary" if r % sec_every == 0 else "residential")
        for c in range(cols - 1):
            # river severance (bridges only at bridge columns for the
            # vertical crossings; horizontal streets inside the band vanish)
            mx = (gx[r, c] + gx[r, c + 1]) / 2
            my = (gy[r, c] + gy[r, c + 1]) / 2
            if in_river(mx, my):
                continue
            if hw == "residential" and rng.random() < 0.06:
                continue  # dead-end block
            block_way(r, c, r, c + 1, hw)
    for c in range(cols):
        hw = ("primary" if c % prim_every == 0
              else "secondary" if c % sec_every == 0 else "residential")
        oneway = None
        if hw == "residential" and c % 2 == 0:
            oneway = "yes" if c % 4 == 0 else "-1"
        for r in range(rows - 1):
            mx = (gx[r, c] + gx[r + 1, c]) / 2
            my = (gy[r, c] + gy[r + 1, c]) / 2
            if in_river(mx, my):
                if c in bridge_cols:
                    block_way(r, c, r + 1, c, "secondary", curve_p=0.0)
                continue
            if hw == "residential" and rng.random() < 0.06:
                continue
            block_way(r, c, r + 1, c, hw, oneway=oneway)

    # ---- diagonal avenues -------------------------------------------------
    d = min(rows, cols)
    diag1 = [nid(i, i) for i in range(0, d, 1)]
    diag2 = [nid(i, cols - 1 - i) for i in range(0, d, 1)]
    for diag in (diag1, diag2):
        keep = [n for n in diag
                if not in_river(*_node_xy(n, gx, gy, cols))]
        # split at the river: contiguous runs become separate ways
        run: List[int] = []
        for n in diag:
            if n in keep:
                run.append(n)
            else:
                if len(run) >= 2:
                    add_way(run, highway="tertiary", maxspeed="50")
                run = []
        if len(run) >= 2:
            add_way(run, highway="tertiary", maxspeed="50")

    # ---- orbital motorway + link ramps ------------------------------------
    ring_off = spacing_m * 2.2
    ring_pts = []
    n_ring = 40
    for i in range(n_ring):
        t = 2 * math.pi * i / n_ring
        rx = W / 2 + (W / 2 + ring_off) * math.cos(t)
        ry = H / 2 + (H / 2 + ring_off) * math.sin(t)
        ring_pts.append(aux_node(rx, ry))
    add_way(ring_pts + [ring_pts[0]], highway="motorway", maxspeed="100")
    # ramps at four compass points to the nearest lattice corner region
    ramp_targets = [(0, cols // 2), (rows // 2, cols - 1),
                    (rows - 1, cols // 2), (rows // 2, 0)]
    for i, (rr, rc) in zip(range(0, n_ring, n_ring // 4), ramp_targets):
        add_way([ring_pts[i], nid(rr, rc)], highway="motorway_link")
        add_way([nid(rr, rc), ring_pts[i]], highway="motorway_link")

    return nodes, ways


def _node_xy(osm_id: int, gx, gy, cols: int) -> Tuple[float, float]:
    i = osm_id - 1
    return gx[i // cols, i % cols], gy[i // cols, i % cols]


def realistic_city_network(rows: int = 120, cols: int = 120,
                           spacing_m: float = 150.0, seed: int = 0,
                           via_pbf: bool = True):
    """RoadNetwork for the realistic city, by default round-tripped through
    the PBF codec so the bench exercises the full ingestion path a real
    downloaded extract would take."""
    from ..tiles.osm import network_from_osm, read_pbf, write_pbf

    nodes, ways = realistic_city(rows, cols, spacing_m, seed)
    if via_pbf:
        import os
        import tempfile

        fd, path = tempfile.mkstemp(suffix=".osm.pbf")
        os.close(fd)
        try:
            write_pbf(path, nodes, ways)
            nodes, ways = read_pbf(path)
        finally:
            os.unlink(path)
    return network_from_osm(nodes, ways)
