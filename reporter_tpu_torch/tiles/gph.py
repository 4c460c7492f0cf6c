"""Spec-derived Valhalla ``.gph`` graph-tile codec (read + fixture write).

A copy of the reference's ``tiles/gph.py``.  The reference's toolchain
consumes prebuilt Valhalla graph tiles; this module implements the tile
container the way the published Valhalla baldr layout (pinned v2.4.5)
describes it, **restricted to the sections the matcher consumes**:

  header          fixed 256-byte block: packed GraphId, version string,
                  section counts and offsets, tile base coordinate
  nodes           fixed 32-byte NodeInfo records: lat/lon as 1e-6-degree
                  offsets from the tile base, first-edge index + count
  directededges   fixed 48-byte DirectedEdge records: end-node GraphId,
                  EdgeInfo offset, length (m), speed (kph),
                  classification, forward/internal flags
  edgeinfo        variable records: OSM way id + the edge shape as the
                  midgard 7-bit varint polyline (zig-zag deltas of
                  round(coord * 1e6), lat then lon)

GraphIds use the published 46-bit layout this repo already mirrors for
OSMLR segment ids (tiles/segment_id.py): 3-bit level, 22-bit tile index,
21-bit within-tile index.  Tile ids and on-disk paths come from
tiles/hierarchy.py (the get_tiles.py-parity hierarchy).

No real Valhalla tile is at hand to validate against, so parity is with
the *published layout*, not captured bytes: ``encode_tiles`` ->
``decode_gph`` -> ``network_from_tiles`` gives back the source network up
to the 1e-6-degree coordinate quantisation.  The admin / restriction /
transit / text sections a full Valhalla tile carries are out of scope: a
tile that declares them still decodes (they ride behind the declared
offsets), but their contents are not interpreted.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

from .hierarchy import TileHierarchy
from .network import Edge, RoadNetwork

GPH_VERSION = "2.4.5"
HEADER_BYTES = 256
NODE_BYTES = 32
EDGE_BYTES = 48
COORD_SCALE = 1e6  # 1e-6-degree fixed point, the baldr coordinate unit

# 46-bit GraphId: 3-bit hierarchy level, 22-bit tile index, 21-bit
# within-tile index (the layout tiles/segment_id.py mirrors for OSMLR)
_LEVEL_BITS, _TILE_BITS, _ID_BITS = 3, 22, 21

# DirectedEdge flag bits
F_FORWARD = 0x1
F_INTERNAL = 0x2


class GphError(ValueError):
    """A .gph byte stream violating the declared layout (truncation,
    version mismatch, out-of-range section offsets)."""


def pack_graphid(level: int, tileid: int, idx: int) -> int:
    if not (0 <= level < (1 << _LEVEL_BITS)
            and 0 <= tileid < (1 << _TILE_BITS)
            and 0 <= idx < (1 << _ID_BITS)):
        raise GphError("graphid field out of range: %r" % ((level, tileid,
                                                            idx),))
    return level | (tileid << _LEVEL_BITS) | (idx << (_LEVEL_BITS +
                                                      _TILE_BITS))


def unpack_graphid(gid: int) -> Tuple[int, int, int]:
    return (gid & ((1 << _LEVEL_BITS) - 1),
            (gid >> _LEVEL_BITS) & ((1 << _TILE_BITS) - 1),
            (gid >> (_LEVEL_BITS + _TILE_BITS)) & ((1 << _ID_BITS) - 1))


# -- shape codec (midgard 7-bit varint polyline) ----------------------------


def encode_shape(points: List[Tuple[float, float]]) -> bytes:
    """Delta-encode a [(lat, lon), ...] polyline: zig-zag each
    1e-6-degree integer delta, emit 7-bit groups LSB-first with the high
    bit as continuation — lat then lon per point."""
    out = bytearray()
    last_lat = last_lon = 0
    for lat, lon in points:
        ilat, ilon = int(round(lat * COORD_SCALE)), int(round(lon *
                                                              COORD_SCALE))
        for delta in (ilat - last_lat, ilon - last_lon):
            v = (delta << 1) ^ (delta >> 63) if delta < 0 else (delta << 1)
            while True:
                g = v & 0x7F
                v >>= 7
                if v:
                    out.append(g | 0x80)
                else:
                    out.append(g)
                    break
        last_lat, last_lon = ilat, ilon
    return bytes(out)


def decode_shape(data: bytes) -> List[Tuple[float, float]]:
    """Inverse of encode_shape."""
    vals: List[int] = []
    v = shift = 0
    for b in data:
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            vals.append((v >> 1) ^ -(v & 1))
            v = shift = 0
    if shift:
        raise GphError("shape byte stream ends mid-varint")
    if len(vals) % 2:
        raise GphError("shape has an odd number of coordinates")
    out: List[Tuple[float, float]] = []
    lat = lon = 0
    for i in range(0, len(vals), 2):
        lat += vals[i]
        lon += vals[i + 1]
        out.append((lat / COORD_SCALE, lon / COORD_SCALE))
    return out


# -- tile model -------------------------------------------------------------


@dataclass
class GphNode:
    lat: float
    lon: float
    edge_index: int
    edge_count: int


@dataclass
class GphEdge:
    endnode: int            # packed GraphId
    length_m: float
    speed_kph: int
    classification: int
    forward: bool
    internal: bool
    way_id: int
    shape: List[Tuple[float, float]]


@dataclass
class GphTile:
    graphid: int            # packed GraphId of the tile (idx == 0)
    version: str
    base_lat: float
    base_lon: float
    nodes: List[GphNode] = field(default_factory=list)
    edges: List[GphEdge] = field(default_factory=list)

    @property
    def level(self) -> int:
        return unpack_graphid(self.graphid)[0]

    @property
    def tileid(self) -> int:
        return unpack_graphid(self.graphid)[1]


_HEADER = struct.Struct("<Q16sQIIIIffI")  # + reserved tail to 256 bytes
_NODE = struct.Struct("<iiIHH16x")
_EDGE = struct.Struct("<QIIBBBB28x")
_EDGEINFO = struct.Struct("<QHH")


def encode_tile(tile: GphTile) -> bytes:
    """One tile -> .gph bytes (the synthetic-fixture writer; also the
    executable documentation of the decoded layout)."""
    base_ilat = int(round(tile.base_lat * COORD_SCALE))
    base_ilon = int(round(tile.base_lon * COORD_SCALE))
    einfo = bytearray()
    offsets: List[int] = []
    for e in tile.edges:
        offsets.append(len(einfo))
        shape = encode_shape(e.shape)
        einfo += _EDGEINFO.pack(e.way_id, 0, len(shape))
        einfo += shape
        while len(einfo) % 4:
            einfo.append(0)
    nodes = b"".join(
        _NODE.pack(int(round(n.lat * COORD_SCALE)) - base_ilat,
                   int(round(n.lon * COORD_SCALE)) - base_ilon,
                   n.edge_index, n.edge_count, 0)
        for n in tile.nodes)
    edges = b"".join(
        _EDGE.pack(e.endnode, offsets[i],
                   min(0xFFFFFFFF, int(round(e.length_m * 100.0))),
                   min(255, int(e.speed_kph)), e.classification & 0x7, 0,
                   (F_FORWARD if e.forward else 0)
                   | (F_INTERNAL if e.internal else 0))
        for i, e in enumerate(tile.edges))
    tile_size = HEADER_BYTES + len(nodes) + len(edges) + len(einfo)
    header = _HEADER.pack(
        tile.graphid, tile.version.encode("ascii")[:16], 0,
        len(tile.nodes), len(tile.edges), len(einfo), 0,
        tile.base_lat, tile.base_lon, tile_size)
    header += b"\x00" * (HEADER_BYTES - len(header))
    return header + nodes + edges + bytes(einfo)


def decode_gph(data: bytes) -> GphTile:
    """.gph bytes -> GphTile.  Strict about the declared layout: a
    truncated stream or out-of-range offset raises GphError rather than
    yielding a plausibly-wrong graph."""
    if len(data) < HEADER_BYTES:
        raise GphError("tile shorter than the %d-byte header"
                       % HEADER_BYTES)
    (graphid, version_b, _dataset, nodecount, edgecount, einfo_size,
     _text_size, base_lat, base_lon, tile_size) = _HEADER.unpack(
        data[: _HEADER.size])
    version = version_b.rstrip(b"\x00").decode("ascii", "replace")
    if version.split(".")[0] != GPH_VERSION.split(".")[0]:
        raise GphError("unsupported gph version %r (decoder derives from "
                       "the v%s layout)" % (version, GPH_VERSION))
    n_off = HEADER_BYTES
    e_off = n_off + nodecount * NODE_BYTES
    i_off = e_off + edgecount * EDGE_BYTES
    if i_off + einfo_size > len(data) or tile_size > len(data):
        raise GphError("declared sections exceed the byte stream "
                       "(%d nodes, %d edges, %d edgeinfo bytes, %d total)"
                       % (nodecount, edgecount, einfo_size, len(data)))
    base_ilat = int(round(base_lat * COORD_SCALE))
    base_ilon = int(round(base_lon * COORD_SCALE))
    tile = GphTile(graphid=graphid, version=version,
                   base_lat=base_lat, base_lon=base_lon)
    for k in range(nodecount):
        lat_off, lon_off, ei, ec, _flags = _NODE.unpack(
            data[n_off + k * NODE_BYTES: n_off + (k + 1) * NODE_BYTES])
        tile.nodes.append(GphNode(
            (base_ilat + lat_off) / COORD_SCALE,
            (base_ilon + lon_off) / COORD_SCALE, ei, ec))
    einfo = data[i_off: i_off + einfo_size]
    for k in range(edgecount):
        endnode, off, length_cm, speed, rc, _use, flags = _EDGE.unpack(
            data[e_off + k * EDGE_BYTES: e_off + (k + 1) * EDGE_BYTES])
        if off + _EDGEINFO.size > len(einfo):
            raise GphError("edge %d edgeinfo offset %d out of range"
                           % (k, off))
        way_id, _names, shape_len = _EDGEINFO.unpack(
            einfo[off: off + _EDGEINFO.size])
        s0 = off + _EDGEINFO.size
        if s0 + shape_len > len(einfo):
            raise GphError("edge %d shape runs past the edgeinfo section"
                           % k)
        tile.edges.append(GphEdge(
            endnode=endnode, length_m=length_cm / 100.0,
            speed_kph=speed, classification=rc,
            forward=bool(flags & F_FORWARD),
            internal=bool(flags & F_INTERNAL),
            way_id=way_id, shape=decode_shape(einfo[s0: s0 + shape_len])))
    return tile


# -- network conversion -----------------------------------------------------


def encode_tiles(network: RoadNetwork, level: int = 2) -> Dict[str, bytes]:
    """A RoadNetwork -> {hierarchy file path: tile bytes} at one level —
    the synthetic-fixture generator.  Nodes partition by their hierarchy
    tile; each directed edge lives in its from-node's tile and references
    its end node by cross-tile GraphId."""
    h = TileHierarchy()
    by_tile: Dict[int, GphTile] = {}
    node_gid: List[int] = []
    for i in range(network.num_nodes):
        lat, lon = network.node_lat[i], network.node_lon[i]
        tid = h.tile_id(level, lat, lon)
        tile = by_tile.get(tid)
        if tile is None:
            bbox = h.levels[level].tile_bbox(tid)
            tile = by_tile[tid] = GphTile(
                graphid=pack_graphid(level, tid, 0), version=GPH_VERSION,
                base_lat=bbox.min_y, base_lon=bbox.min_x)
        node_gid.append(pack_graphid(level, tid, len(tile.nodes)))
        tile.nodes.append(GphNode(lat, lon, 0, 0))
    # group edges by from-node so NodeInfo's (edge_index, edge_count)
    # window is contiguous, the baldr adjacency contract
    per_node: Dict[int, List[int]] = {}
    for ei, e in enumerate(network.edges):
        per_node.setdefault(e.from_node, []).append(ei)
    for i in range(network.num_nodes):
        _lvl, tid, idx = unpack_graphid(node_gid[i])
        tile = by_tile[tid]
        node = tile.nodes[idx]
        node.edge_index = len(tile.edges)
        node.edge_count = len(per_node.get(i, ()))
        for ei in per_node.get(i, ()):
            e = network.edges[ei]
            shape = e.shape or [
                (network.node_lat[e.from_node], network.node_lon[e.from_node]),
                (network.node_lat[e.to_node], network.node_lon[e.to_node])]
            tile.edges.append(GphEdge(
                endnode=node_gid[e.to_node],
                length_m=network.edge_length_m(ei),
                speed_kph=int(round(e.speed_kph)), classification=0,
                forward=True, internal=bool(e.internal),
                way_id=int(e.way_id or 0), shape=list(shape)))
    return {h.levels[level].file_suffix(tid, level, "gph"):
            encode_tile(tile) for tid, tile in by_tile.items()}


def network_from_tiles(tiles: Iterable["GphTile | bytes"],
                       ) -> RoadNetwork:
    """Decoded tiles -> one RoadNetwork (the converter the OSM importer
    parallels: same output type, so everything downstream — RPTT tiles,
    GraphArrays, the matcher — is format-oblivious)."""
    decoded: List[GphTile] = [
        t if isinstance(t, GphTile) else decode_gph(t) for t in tiles]
    net = RoadNetwork()
    node_of: Dict[Tuple[int, int, int], int] = {}
    for t in decoded:
        for idx, n in enumerate(t.nodes):
            node_of[(t.level, t.tileid, idx)] = net.add_node(n.lat, n.lon)
    for t in decoded:
        for e in t.edges:
            key = unpack_graphid(e.endnode)
            if key not in node_of:
                raise GphError(
                    "edge end node %r references a tile outside the "
                    "decoded set" % (key,))
        for idx, n in enumerate(t.nodes):
            frm = node_of[(t.level, t.tileid, idx)]
            for e in t.edges[n.edge_index: n.edge_index + n.edge_count]:
                net.add_edge(Edge(
                    from_node=frm, to_node=node_of[unpack_graphid(e.endnode)],
                    shape=list(e.shape) if e.shape else None,
                    speed_kph=float(e.speed_kph), level=t.level,
                    internal=e.internal, way_id=e.way_id or None))
    return net
