"""Road network model: the host-side graph the matcher runs against.

A copy of the reference's ``RoadNetwork`` and ``grid_city``.  Every edge
carries a road level (0 highway, 1 arterial, 2 local) and an optional
OSMLR segment id whose low 3 bits are that level; internal edges carry no
segment id.  ``to_dict`` / ``from_dict`` are the JSON form the OSM import
CLI writes (``python -m reporter_tpu_torch.tiles.osm ... --json``) and the
service's ``{"network": {"type": "file"}}`` reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .. import geo
from .hierarchy import TileHierarchy
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

    def edge_length_m(self, ei: int) -> float:
        e = self.edges[ei]
        pts = e.shape
        total = 0.0
        for i in range(len(pts) - 1):
            total += float(geo.haversine_m(pts[i][0], pts[i][1], pts[i + 1][0], pts[i + 1][1]))
        return total

    def segment_lengths(self) -> Dict[int, float]:
        """Total length of each OSMLR segment (sum over its member edges)."""
        out: Dict[int, float] = {}
        for i, e in enumerate(self.edges):
            if e.segment_id is not None:
                out[e.segment_id] = out.get(e.segment_id, 0.0) + self.edge_length_m(i)
        return out

    def to_dict(self) -> dict:
        return {
            "nodes": {"lat": list(self.node_lat), "lon": list(self.node_lon)},
            "edges": [
                {
                    "from": e.from_node,
                    "to": e.to_node,
                    "shape": e.shape,
                    "speed_kph": e.speed_kph,
                    "level": e.level,
                    "segment_id": e.segment_id,
                    "internal": e.internal,
                    "way_id": e.way_id,
                }
                for e in self.edges
            ],
        }

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

    tiles = TileHierarchy()
    seg_counter = [0]

    def next_sid(level):
        sid = pack_segment_id(level, tiles.tile_id(level, lat0, lon0), seg_counter[0])
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
