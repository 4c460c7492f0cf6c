"""Graph tile (de)serialisation: RoadNetwork <-> binary tile directory.

A copy of the reference's ``tiles/codec.py`` (the same files, byte for
byte).  The on-disk analogue of the reference's Valhalla tile tree (3-level
hierarchy, ``{level}/{index}`` naming, get_tiles.py:82-102) in this
framework's own dense format (native/reporter_native.cc header comment for
the byte layout).  A network becomes:

    dir/manifest.json        {"version", "num_nodes", "tiles": [...]}
    dir/nodes.rptt           every node (tiles reference global node ids)
    dir/{level}/{index}.rptt the edges whose from-node falls in that tile

Edges partition by the tile of their from-node at the edge's own road level
-- the same level-owns-its-edges rule as the reference hierarchy.  Encoding
and decoding go through the native core when it is available and an
identical numpy implementation otherwise; the two produce byte-identical
files.  ``python -m reporter_tpu_torch.tiles.osm extract.osm.pbf -o dir``
writes such a directory, and a service config's ``{"network": {"type":
"tiles", "path": dir}}`` reads it.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..native import get_lib
from .hierarchy import TileHierarchy
from .network import Edge, RoadNetwork

MAGIC = 0x54545052  # 'RPTT'
VERSION = 1
_HDR = struct.Struct("<6I")


class TileArrays:
    """The flat arrays of one tile file."""

    def __init__(self, node_lat, node_lon, edge_from, edge_to, speed, level,
                 internal, segment_id, way_id, shape_start, shape_lat, shape_lon):
        self.node_lat = np.ascontiguousarray(node_lat, np.float64)
        self.node_lon = np.ascontiguousarray(node_lon, np.float64)
        self.edge_from = np.ascontiguousarray(edge_from, np.uint32)
        self.edge_to = np.ascontiguousarray(edge_to, np.uint32)
        self.speed = np.ascontiguousarray(speed, np.float32)
        self.level = np.ascontiguousarray(level, np.uint8)
        self.internal = np.ascontiguousarray(internal, np.uint8)
        self.segment_id = np.ascontiguousarray(segment_id, np.int64)
        self.way_id = np.ascontiguousarray(way_id, np.int64)
        self.shape_start = np.ascontiguousarray(shape_start, np.uint32)
        self.shape_lat = np.ascontiguousarray(shape_lat, np.float64)
        self.shape_lon = np.ascontiguousarray(shape_lon, np.float64)

    @property
    def n_nodes(self) -> int:
        return len(self.node_lat)

    @property
    def n_edges(self) -> int:
        return len(self.edge_from)

    @property
    def n_shape(self) -> int:
        return len(self.shape_lat)


def write_tile(path: str, t: TileArrays) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    lib = get_lib()
    if lib is not None:
        rc = lib.rn_tile_write(
            path.encode(), t.n_nodes, t.node_lat, t.node_lon, t.n_edges,
            t.edge_from, t.edge_to, t.speed, t.level, t.internal,
            t.segment_id, t.way_id, t.shape_start, t.n_shape,
            t.shape_lat, t.shape_lon,
        )
        if rc != 0:
            raise IOError("native tile write failed (%d): %s" % (rc, path))
        return
    with open(path, "wb") as f:
        f.write(_HDR.pack(MAGIC, VERSION, t.n_nodes, t.n_edges, t.n_shape, 0))
        for arr in (t.node_lat, t.node_lon, t.edge_from, t.edge_to, t.speed,
                    t.level, t.internal, t.segment_id, t.way_id):
            f.write(arr.tobytes())
        if t.n_edges:
            f.write(t.shape_start.tobytes())
        f.write(t.shape_lat.tobytes())
        f.write(t.shape_lon.tobytes())


def read_tile(path: str) -> TileArrays:
    lib = get_lib()
    if lib is not None:
        hdr = np.zeros(4, np.uint32)
        rc = lib.rn_tile_header(path.encode(), hdr)
        if rc != 0:
            raise IOError("native tile header read failed (%d): %s" % (rc, path))
        _ver, n_nodes, n_edges, n_shape = (int(x) for x in hdr)
        t = TileArrays(
            np.empty(n_nodes, np.float64), np.empty(n_nodes, np.float64),
            np.empty(n_edges, np.uint32), np.empty(n_edges, np.uint32),
            np.empty(n_edges, np.float32), np.empty(n_edges, np.uint8),
            np.empty(n_edges, np.uint8), np.empty(n_edges, np.int64),
            np.empty(n_edges, np.int64),
            np.empty(n_edges + 1 if n_edges else 0, np.uint32),
            np.empty(n_shape, np.float64), np.empty(n_shape, np.float64),
        )
        rc = lib.rn_tile_read(
            path.encode(), t.node_lat, t.node_lon, t.edge_from, t.edge_to,
            t.speed, t.level, t.internal, t.segment_id, t.way_id,
            t.shape_start, t.shape_lat, t.shape_lon,
        )
        if rc != 0:
            raise IOError("native tile read failed (%d): %s" % (rc, path))
        return t
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _HDR.size:
        raise IOError("not a tile file (truncated header): %s" % path)
    magic, version, n_nodes, n_edges, n_shape, _ = _HDR.unpack_from(data, 0)
    if magic != MAGIC:
        raise IOError("not a tile file: %s" % path)
    if version != VERSION:
        raise IOError("unsupported tile version %d: %s" % (version, path))
    off = _HDR.size

    def take(dtype, count):
        nonlocal off
        try:
            arr = np.frombuffer(data, dtype, count, off)
        except ValueError as e:  # same IOError the native path raises
            raise IOError("truncated tile file %s: %s" % (path, e))
        off += arr.nbytes
        return arr

    return TileArrays(
        take(np.float64, n_nodes), take(np.float64, n_nodes),
        take(np.uint32, n_edges), take(np.uint32, n_edges),
        take(np.float32, n_edges), take(np.uint8, n_edges),
        take(np.uint8, n_edges), take(np.int64, n_edges),
        take(np.int64, n_edges),
        take(np.uint32, n_edges + 1 if n_edges else 0),
        take(np.float64, n_shape), take(np.float64, n_shape),
    )


# -- network <-> tile directory -------------------------------------------


def _edge_arrays(net: RoadNetwork, edge_idx: List[int]) -> TileArrays:
    E = len(edge_idx)
    shape_start = np.zeros(E + 1 if E else 0, np.uint32)
    slat: List[float] = []
    slon: List[float] = []
    ef = np.zeros(E, np.uint32)
    et = np.zeros(E, np.uint32)
    sp = np.zeros(E, np.float32)
    lv = np.zeros(E, np.uint8)
    internal = np.zeros(E, np.uint8)
    seg = np.zeros(E, np.int64)
    way = np.zeros(E, np.int64)
    for k, ei in enumerate(edge_idx):
        e = net.edges[ei]
        ef[k] = e.from_node
        et[k] = e.to_node
        sp[k] = e.speed_kph
        lv[k] = e.level
        internal[k] = 1 if e.internal else 0
        seg[k] = -1 if e.segment_id is None else e.segment_id
        way[k] = -1 if e.way_id is None else e.way_id
        shape_start[k] = len(slat)
        for la, lo in e.shape:
            slat.append(la)
            slon.append(lo)
    if E:
        shape_start[E] = len(slat)
    return TileArrays(
        np.zeros(0), np.zeros(0), ef, et, sp, lv, internal, seg, way,
        shape_start, np.asarray(slat, np.float64), np.asarray(slon, np.float64),
    )


def save_network_tiles(net: RoadNetwork, dir_path: str) -> dict:
    """Partition a network into the tile tree.  Returns the manifest."""
    os.makedirs(dir_path, exist_ok=True)
    h = TileHierarchy()
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for ei, e in enumerate(net.edges):
        lat, lon = net.node_lat[e.from_node], net.node_lon[e.from_node]
        key = (e.level, h.tile_id(e.level, lat, lon))
        buckets.setdefault(key, []).append(ei)

    nodes = TileArrays(
        np.asarray(net.node_lat, np.float64), np.asarray(net.node_lon, np.float64),
        np.zeros(0, np.uint32), np.zeros(0, np.uint32), np.zeros(0, np.float32),
        np.zeros(0, np.uint8), np.zeros(0, np.uint8), np.zeros(0, np.int64),
        np.zeros(0, np.int64), np.zeros(0, np.uint32),
        np.zeros(0), np.zeros(0),
    )
    write_tile(os.path.join(dir_path, "nodes.rptt"), nodes)

    manifest = {"version": VERSION, "num_nodes": net.num_nodes, "tiles": []}
    for (level, index), edge_idx in sorted(buckets.items()):
        rel = os.path.join(str(level), "%d.rptt" % index)
        write_tile(os.path.join(dir_path, rel), _edge_arrays(net, edge_idx))
        manifest["tiles"].append(
            {"level": level, "index": index, "path": rel, "edges": len(edge_idx)}
        )
    with open(os.path.join(dir_path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def load_network_tiles(
    dir_path: str, levels: Optional[set] = None
) -> RoadNetwork:
    """Rebuild a RoadNetwork from a tile directory (optionally only some
    levels -- the reference's report/transition level masks operate the same
    way)."""
    with open(os.path.join(dir_path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("version") != VERSION:
        raise IOError("unsupported tile manifest version %r" % manifest.get("version"))
    nodes = read_tile(os.path.join(dir_path, "nodes.rptt"))
    net = RoadNetwork()
    net.node_lat = [float(v) for v in nodes.node_lat]
    net.node_lon = [float(v) for v in nodes.node_lon]
    for entry in manifest["tiles"]:
        if levels is not None and entry["level"] not in levels:
            continue
        t = read_tile(os.path.join(dir_path, entry["path"]))
        for k in range(t.n_edges):
            s0, s1 = int(t.shape_start[k]), int(t.shape_start[k + 1])
            net.add_edge(
                Edge(
                    from_node=int(t.edge_from[k]),
                    to_node=int(t.edge_to[k]),
                    shape=[
                        (float(t.shape_lat[i]), float(t.shape_lon[i]))
                        for i in range(s0, s1)
                    ],
                    speed_kph=float(t.speed[k]),
                    level=int(t.level[k]),
                    segment_id=None if t.segment_id[k] < 0 else int(t.segment_id[k]),
                    internal=bool(t.internal[k]),
                    way_id=None if t.way_id[k] < 0 else int(t.way_id[k]),
                )
            )
    return net
