"""Road network model: the host-side graph the matcher runs against.

A copy of the reference's ``RoadNetwork`` and ``grid_city``, trimmed to
what the serving path uses.  Every edge carries a road level (0 highway,
1 arterial, 2 local) and an optional OSMLR segment id whose low 3 bits are
that level; internal edges carry no segment id.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

from .. import geo
from .segment_id import pack_segment_id


@dataclass
class Edge:
    from_node: int
    to_node: int
    # polyline including both endpoints, [(lat, lon), ...]; None = the
    # straight line between the end nodes
    shape: Optional[List[Tuple[float, float]]] = None
    speed_kph: float = 50.0
    level: int = 2
    segment_id: Optional[int] = None  # OSMLR id; None = unassociated
    internal: bool = False
    way_id: Optional[int] = None


class RoadNetwork:
    """Mutable builder for a directed road graph."""

    def __init__(self):
        self.node_lat: List[float] = []
        self.node_lon: List[float] = []
        self.edges: List[Edge] = []

    def add_node(self, lat: float, lon: float) -> int:
        self.node_lat.append(float(lat))
        self.node_lon.append(float(lon))
        return len(self.node_lat) - 1

    def add_edge(self, edge: Edge) -> int:
        if edge.shape is None:
            edge.shape = [
                (self.node_lat[edge.from_node], self.node_lon[edge.from_node]),
                (self.node_lat[edge.to_node], self.node_lon[edge.to_node]),
            ]
        self.edges.append(edge)
        return len(self.edges) - 1

    def add_road(self, a: int, b: int, **kw) -> Tuple[int, int]:
        """Add a bidirectional road as two directed edges.  Keyword args are
        shared except segment ids: ``segment_id`` (forward) and
        ``rev_segment_id`` (reverse)."""
        rev_sid = kw.pop("rev_segment_id", None)
        shape = kw.pop("shape", None)
        e1 = self.add_edge(Edge(a, b, shape=list(shape) if shape else None, **kw))
        kw2 = dict(kw)
        kw2["segment_id"] = rev_sid
        rev_shape = list(reversed(shape)) if shape else None
        e2 = self.add_edge(Edge(b, a, shape=rev_shape, **kw2))
        return e1, e2

    @property
    def num_nodes(self) -> int:
        return len(self.node_lat)

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def bbox(self) -> Tuple[float, float, float, float]:
        """(min_lat, min_lon, max_lat, max_lon)"""
        return (min(self.node_lat), min(self.node_lon),
                max(self.node_lat), max(self.node_lon))

    @classmethod
    def from_dict(cls, d: dict) -> "RoadNetwork":
        net = cls()
        net.node_lat = [float(v) for v in d["nodes"]["lat"]]
        net.node_lon = [float(v) for v in d["nodes"]["lon"]]
        for ed in d["edges"]:
            net.add_edge(Edge(
                from_node=int(ed["from"]),
                to_node=int(ed["to"]),
                shape=[tuple(p) for p in ed["shape"]] if ed.get("shape") else None,
                speed_kph=float(ed.get("speed_kph", 50.0)),
                level=int(ed.get("level", 2)),
                segment_id=ed.get("segment_id"),
                internal=bool(ed.get("internal", False)),
                way_id=ed.get("way_id"),
            ))
        return net


# world tile grid per level (degrees): 0 highway, 1 arterial, 2 local
_LEVEL_TILE_DEG = {0: 4.0, 1: 1.0, 2: 0.25}


def _tile_index(level: int, lat: float, lon: float) -> int:
    """Row-major index of the level's world tile containing (lat, lon);
    the reference tile hierarchy's ``tile_id`` for in-range coordinates."""
    size = _LEVEL_TILE_DEG[level]
    ncols = int(math.ceil(360.0 / size))
    nrows = int(math.ceil(180.0 / size))
    if not (-90.0 <= lat <= 90.0 and -180.0 <= lon <= 180.0):
        return -1
    row = nrows - 1 if lat == 90.0 else int((lat + 90.0) / size)
    c = (lon + 180.0) / size
    col = ncols - 1 if lon == 180.0 else int(c)
    return row * ncols + col


def grid_city(
    rows: int = 8,
    cols: int = 8,
    spacing_m: float = 200.0,
    origin: Tuple[float, float] = (37.75, -122.45),
    arterial_every: int = 4,
    two_edge_segments: bool = False,
) -> RoadNetwork:
    """A Manhattan-style grid city.

    Every street block is one bidirectional road.  Rows/cols divisible by
    ``arterial_every`` become level-1 arterials (faster); the rest are
    level-2 locals.  Each direction of each block gets its own OSMLR segment
    id unless ``two_edge_segments`` is set, in which case pairs of
    consecutive blocks along a street share one id.
    """
    net = RoadNetwork()
    lat0, lon0 = origin
    proj = geo.LocalProjection(lat0, lon0)
    dlat = spacing_m / (geo.EARTH_RADIUS_M * geo.DEG)
    dlon = spacing_m / (geo.EARTH_RADIUS_M * geo.DEG * proj.coslat0)

    for r in range(rows):
        for c in range(cols):
            net.add_node(lat0 + r * dlat, lon0 + c * dlon)

    def node(r, c):
        return r * cols + c

    seg_counter = [0]

    def next_sid(level):
        sid = pack_segment_id(level, _tile_index(level, lat0, lon0), seg_counter[0])
        seg_counter[0] += 1
        return sid

    for r in range(rows):  # horizontal streets
        level = 1 if r % arterial_every == 0 else 2
        speed = 70.0 if level == 1 else 40.0
        c = 0
        while c < cols - 1:
            span = 2 if (two_edge_segments and level == 2 and c + 2 <= cols - 1) else 1
            fwd = next_sid(level)
            rev = next_sid(level)
            for k in range(span):
                net.add_road(
                    node(r, c + k), node(r, c + k + 1),
                    speed_kph=speed, level=level,
                    segment_id=fwd, rev_segment_id=rev,
                    way_id=1000 + r,
                )
            c += span
    for c in range(cols):  # vertical streets
        level = 1 if c % arterial_every == 0 else 2
        speed = 70.0 if level == 1 else 40.0
        for r in range(rows - 1):
            net.add_road(
                node(r, c), node(r + 1, c),
                speed_kph=speed, level=level,
                segment_id=next_sid(level), rev_segment_id=next_sid(level),
                way_id=2000 + c,
            )
    return net
