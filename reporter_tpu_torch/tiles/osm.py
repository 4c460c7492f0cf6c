"""Real-map ingestion: OSM extracts -> RoadNetwork.

A copy of the reference's ``tiles/osm.py``.  It reads an OSM extract --
.osm.pbf (the standard binary interchange), .osm / .osm.xml, or an
Overpass API JSON export -- classifies the road network, and produces the
same RoadNetwork the synthetic generators produce, from which
tiles/arrays.py builds the device arrays.

No third-party dependencies: the PBF path implements the protobuf wire
format directly (varint/zigzag/length-delimited, the OSM PBF fileformat +
osmformat schemas), plus a writer used by the round-trip tests and the
realistic city (synth/osm_city.py).

Classification (the Valhalla road classes the tile levels encode; the
segment-id bit layout of tiles/segment_id.py):
  level 0 (highway):  motorway, trunk, primary
  level 1 (arterial): secondary, tertiary
  level 2 (local):    residential, unclassified, living_street, service, road
  *_link ways and roundabouts are "internal" edges: they carry no OSMLR
  segment id and are reported through the internal path.

CLI:
  python -m reporter_tpu_torch.tiles.osm city.osm.pbf -o tiles/ [--json net.json] [--bbox ...]
``-o`` writes the RPTT tile directory (tiles/codec.py) that a service
config's {"network": {"type": "tiles"}} reads; ``--json`` the RoadNetwork
JSON that {"network": {"type": "file"}} reads.
"""

from __future__ import annotations

import json
import logging
import struct
import sys
import zlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from .hierarchy import TileHierarchy
from .network import Edge, RoadNetwork
from .segment_id import SEGMENT_INDEX_MASK, pack_segment_id

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# protobuf wire format (decode + encode), just enough for OSM PBF
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _zigzag_decode(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _zigzag_encode(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else v << 1


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value); value is int for varint/fixed,
    bytes for length-delimited."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
            yield field, wt, v
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            yield field, wt, buf[i:i + ln]
            i += ln
        elif wt == 5:
            yield field, wt, struct.unpack_from("<I", buf, i)[0]
            i += 4
        elif wt == 1:
            yield field, wt, struct.unpack_from("<Q", buf, i)[0]
            i += 8
        else:  # pragma: no cover - groups are absent from OSM PBF
            raise ValueError("unsupported wire type %d" % wt)


def _packed_varints(buf: bytes) -> List[int]:
    out = []
    i = 0
    n = len(buf)
    while i < n:
        v, i = _read_varint(buf, i)
        out.append(v)
    return out


def _emit_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _emit_key(field: int, wt: int) -> bytes:
    return _emit_varint((field << 3) | wt)


def _emit_bytes(field: int, data: bytes) -> bytes:
    return _emit_key(field, 2) + _emit_varint(len(data)) + data


def _emit_int(field: int, v: int) -> bytes:
    return _emit_key(field, 0) + _emit_varint(v)


def _emit_packed(field: int, values: Sequence[int]) -> bytes:
    body = b"".join(_emit_varint(v) for v in values)
    return _emit_bytes(field, body)


# ---------------------------------------------------------------------------
# OSM PBF reader
# ---------------------------------------------------------------------------

@dataclass
class OsmWay:
    id: int
    refs: List[int]
    tags: Dict[str, str]


def _blob_payload(blob: bytes) -> bytes:
    raw = None
    zdata = None
    for field, _wt, v in _fields(blob):
        if field == 1:
            raw = v
        elif field == 3:
            zdata = v
    if raw is not None:
        return raw  # type: ignore[return-value]
    if zdata is not None:
        return zlib.decompress(zdata)  # type: ignore[arg-type]
    raise ValueError("blob has neither raw nor zlib data (lzma unsupported)")


def iter_pbf_blocks(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (block_type, payload) for each blob in a .osm.pbf file."""
    with open(path, "rb") as f:
        while True:
            head = f.read(4)
            if len(head) < 4:
                return
            (hlen,) = struct.unpack(">I", head)
            header = f.read(hlen)
            btype = ""
            dsize = 0
            for field, _wt, v in _fields(header):
                if field == 1:
                    btype = v.decode()  # type: ignore[union-attr]
                elif field == 3:
                    dsize = int(v)  # type: ignore[arg-type]
            blob = f.read(dsize)
            yield btype, _blob_payload(blob)


def _parse_string_table(buf: bytes) -> List[str]:
    return [
        v.decode("utf-8", "replace")  # type: ignore[union-attr]
        for field, _wt, v in _fields(buf)
        if field == 1
    ]


def _parse_dense_nodes(buf: bytes, gran: int, lat_off: int, lon_off: int,
                       nodes: Dict[int, Tuple[float, float]]) -> None:
    ids: List[int] = []
    lats: List[int] = []
    lons: List[int] = []
    for field, _wt, v in _fields(buf):
        if field == 1:
            ids = [_zigzag_decode(x) for x in _packed_varints(v)]  # type: ignore[arg-type]
        elif field == 8:
            lats = [_zigzag_decode(x) for x in _packed_varints(v)]  # type: ignore[arg-type]
        elif field == 9:
            lons = [_zigzag_decode(x) for x in _packed_varints(v)]  # type: ignore[arg-type]
    nid = lat = lon = 0
    for i in range(len(ids)):
        nid += ids[i]
        lat += lats[i]
        lon += lons[i]
        nodes[nid] = (
            1e-9 * (lat_off + gran * lat),
            1e-9 * (lon_off + gran * lon),
        )


def _parse_plain_node(buf: bytes, gran: int, lat_off: int, lon_off: int,
                      nodes: Dict[int, Tuple[float, float]]) -> None:
    nid = lat = lon = 0
    for field, _wt, v in _fields(buf):
        if field == 1:
            nid = _zigzag_decode(int(v))  # type: ignore[arg-type]
        elif field == 8:
            lat = _zigzag_decode(int(v))  # type: ignore[arg-type]
        elif field == 9:
            lon = _zigzag_decode(int(v))  # type: ignore[arg-type]
    nodes[nid] = (1e-9 * (lat_off + gran * lat), 1e-9 * (lon_off + gran * lon))


def _parse_way(buf: bytes, strings: List[str]) -> OsmWay:
    wid = 0
    keys: List[int] = []
    vals: List[int] = []
    refs: List[int] = []
    for field, _wt, v in _fields(buf):
        if field == 1:
            wid = int(v)  # type: ignore[arg-type]
        elif field == 2:
            keys = _packed_varints(v)  # type: ignore[arg-type]
        elif field == 3:
            vals = _packed_varints(v)  # type: ignore[arg-type]
        elif field == 8:
            out = []
            cur = 0
            for d in _packed_varints(v):  # type: ignore[arg-type]
                cur += _zigzag_decode(d)
                out.append(cur)
            refs = out
    tags = {strings[k]: strings[x] for k, x in zip(keys, vals)}
    return OsmWay(id=wid, refs=refs, tags=tags)


def read_pbf(path: str) -> Tuple[Dict[int, Tuple[float, float]], List[OsmWay]]:
    """All nodes {osm_id: (lat, lon)} and tagged ways from a .osm.pbf."""
    nodes: Dict[int, Tuple[float, float]] = {}
    ways: List[OsmWay] = []
    for btype, payload in iter_pbf_blocks(path):
        if btype != "OSMData":
            continue
        strings: List[str] = []
        groups: List[bytes] = []
        gran, lat_off, lon_off = 100, 0, 0
        for field, _wt, v in _fields(payload):
            if field == 1:
                strings = _parse_string_table(v)  # type: ignore[arg-type]
            elif field == 2:
                groups.append(v)  # type: ignore[arg-type]
            elif field == 17:
                gran = int(v)  # type: ignore[arg-type]
            elif field == 19:
                lat_off = int(v)  # type: ignore[arg-type]
            elif field == 20:
                lon_off = int(v)  # type: ignore[arg-type]
        for g in groups:
            for field, _wt, v in _fields(g):
                if field == 1:
                    _parse_plain_node(v, gran, lat_off, lon_off, nodes)  # type: ignore[arg-type]
                elif field == 2:
                    _parse_dense_nodes(v, gran, lat_off, lon_off, nodes)  # type: ignore[arg-type]
                elif field == 3:
                    ways.append(_parse_way(v, strings))  # type: ignore[arg-type]
    return nodes, ways


# ---------------------------------------------------------------------------
# OSM PBF writer (round-trip tests; fixture generation; export)
# ---------------------------------------------------------------------------

def write_pbf(path: str, nodes: Dict[int, Tuple[float, float]],
              ways: Sequence[OsmWay]) -> None:
    """A minimal valid .osm.pbf: one OSMHeader blob + one OSMData blob with
    dense nodes and ways (granularity 100, zlib-compressed)."""
    header = _emit_bytes(4, b"OsmSchema-V0.6") + _emit_bytes(4, b"DenseNodes")

    strings: List[bytes] = [b""]  # index 0 must be the empty string
    index: Dict[str, int] = {}

    def intern(s: str) -> int:
        if s not in index:
            index[s] = len(strings)
            strings.append(s.encode())
        return index[s]

    # dense nodes (delta-coded sint64)
    ids = sorted(nodes)
    did: List[int] = []
    dlat: List[int] = []
    dlon: List[int] = []
    pid = plat = plon = 0
    for nid in ids:
        lat9 = round(nodes[nid][0] * 1e9 / 100)
        lon9 = round(nodes[nid][1] * 1e9 / 100)
        did.append(_zigzag_encode(nid - pid))
        dlat.append(_zigzag_encode(lat9 - plat))
        dlon.append(_zigzag_encode(lon9 - plon))
        pid, plat, plon = nid, lat9, lon9
    dense = _emit_packed(1, did) + _emit_packed(8, dlat) + _emit_packed(9, dlon)
    group = _emit_bytes(2, dense)

    way_msgs = []
    for w in ways:
        keys = [intern(k) for k in w.tags]
        vals = [intern(w.tags[k]) for k in w.tags]
        refs = []
        prev = 0
        for r in w.refs:
            refs.append(_zigzag_encode(r - prev))
            prev = r
        msg = _emit_int(1, w.id) + _emit_packed(2, keys) + _emit_packed(3, vals) + _emit_packed(8, refs)
        way_msgs.append(_emit_bytes(3, msg))
    group2 = b"".join(way_msgs)

    st = _emit_bytes(1, b"".join(_emit_bytes(1, s) for s in strings))
    block = st + _emit_bytes(2, group) + (_emit_bytes(2, group2) if group2 else b"")

    with open(path, "wb") as f:
        for btype, payload in (("OSMHeader", header), ("OSMData", block)):
            z = zlib.compress(payload)
            blob = _emit_int(2, len(payload)) + _emit_bytes(3, z)
            bh = _emit_bytes(1, btype.encode()) + _emit_int(3, len(blob))
            f.write(struct.pack(">I", len(bh)))
            f.write(bh)
            f.write(blob)


# ---------------------------------------------------------------------------
# XML / Overpass JSON readers
# ---------------------------------------------------------------------------

def read_xml(path: str) -> Tuple[Dict[int, Tuple[float, float]], List[OsmWay]]:
    import xml.etree.ElementTree as ET

    nodes: Dict[int, Tuple[float, float]] = {}
    ways: List[OsmWay] = []
    for _event, el in ET.iterparse(path, events=("end",)):
        if el.tag == "node":
            nodes[int(el.get("id"))] = (float(el.get("lat")), float(el.get("lon")))
            el.clear()
        elif el.tag == "way":
            refs = [int(nd.get("ref")) for nd in el.findall("nd")]
            tags = {t.get("k"): t.get("v") for t in el.findall("tag")}
            ways.append(OsmWay(id=int(el.get("id")), refs=refs, tags=tags))
            el.clear()
    return nodes, ways


def read_overpass_json(path: str) -> Tuple[Dict[int, Tuple[float, float]], List[OsmWay]]:
    with open(path) as f:
        doc = json.load(f)
    nodes: Dict[int, Tuple[float, float]] = {}
    ways: List[OsmWay] = []
    for el in doc.get("elements", []):
        if el.get("type") == "node":
            nodes[int(el["id"])] = (float(el["lat"]), float(el["lon"]))
        elif el.get("type") == "way":
            ways.append(OsmWay(
                id=int(el["id"]),
                refs=[int(r) for r in el.get("nodes", [])],
                tags={str(k): str(v) for k, v in el.get("tags", {}).items()},
            ))
    return nodes, ways


def load_osm(path: str) -> Tuple[Dict[int, Tuple[float, float]], List[OsmWay]]:
    if path.endswith(".pbf"):
        return read_pbf(path)
    if path.endswith(".json"):
        return read_overpass_json(path)
    return read_xml(path)


# ---------------------------------------------------------------------------
# highway classification
# ---------------------------------------------------------------------------

# highway tag -> (level, default speed km/h); absent = not routable here
HIGHWAY_CLASS: Dict[str, Tuple[int, float]] = {
    "motorway": (0, 100.0),
    "trunk": (0, 90.0),
    "primary": (0, 65.0),
    "secondary": (1, 55.0),
    "tertiary": (1, 45.0),
    "unclassified": (2, 40.0),
    "residential": (2, 35.0),
    "living_street": (2, 15.0),
    "service": (2, 20.0),
    "road": (2, 40.0),
}
# link roads inherit the class of their parent but are internal (turn
# channels / ramps carry no OSMLR segment, reporter_service.py internal path)
LINK_CLASS = {k + "_link": v for k, v in HIGHWAY_CLASS.items()
              if k in ("motorway", "trunk", "primary", "secondary", "tertiary")}


@dataclass
class RoadClass:
    level: int
    speed_kph: float
    internal: bool
    oneway: int  # 0 = both directions, 1 = forward only, -1 = reverse only


def parse_maxspeed(value: str) -> Optional[float]:
    v = value.strip().lower()
    try:
        if v.endswith("mph"):
            return float(v[:-3].strip()) * 1.609344
        if v.endswith("km/h"):
            v = v[:-4].strip()
        elif v.endswith("kmh"):
            v = v[:-3].strip()
        return float(v)
    except ValueError:
        return None


def classify(tags: Dict[str, str]) -> Optional[RoadClass]:
    hw = tags.get("highway", "")
    internal = False
    if hw in HIGHWAY_CLASS:
        level, speed = HIGHWAY_CLASS[hw]
    elif hw in LINK_CLASS:
        level, speed = LINK_CLASS[hw]
        internal = True
    else:
        return None
    if tags.get("area") == "yes":
        return None
    roundabout = tags.get("junction") in ("roundabout", "circular")
    if roundabout:
        internal = True
    ms = tags.get("maxspeed")
    if ms:
        parsed = parse_maxspeed(ms)
        if parsed and parsed > 0:
            speed = parsed
    ow = tags.get("oneway", "").lower()
    if ow in ("yes", "true", "1"):
        oneway = 1
    elif ow in ("-1", "reverse"):
        oneway = -1
    elif ow in ("no", "false", "0"):
        oneway = 0
    elif roundabout or hw in ("motorway", "motorway_link"):
        oneway = 1  # implied
    else:
        oneway = 0
    return RoadClass(level=level, speed_kph=speed, internal=internal, oneway=oneway)


# ---------------------------------------------------------------------------
# graph build
# ---------------------------------------------------------------------------

def network_from_osm(
    nodes: Dict[int, Tuple[float, float]],
    ways: Sequence[OsmWay],
    bbox: Optional[Tuple[float, float, float, float]] = None,
) -> RoadNetwork:
    """Routable RoadNetwork from raw OSM primitives.

    Ways are split at intersection nodes (nodes shared between kept ways or
    repeated within one), yielding one edge per inter-intersection piece
    with the intermediate geometry kept as the edge shape.  Each directed
    non-internal edge gets an OSMLR-style segment id packed per the
    reference layout (simple_reporter.py:36-49): 3-bit level, 22-bit tile
    index of the edge's start point in that level's world grid
    (get_tiles.py:30-39 geometry), 21-bit per-tile counter.

    ``bbox`` = (min_lat, min_lon, max_lat, max_lon) keeps only ways with at
    least one node inside."""
    kept: List[Tuple[OsmWay, RoadClass]] = []
    for w in ways:
        rc = classify(w.tags)
        if rc is None or len(w.refs) < 2:
            continue
        refs = [r for r in w.refs if r in nodes]
        if len(refs) < 2:
            continue
        if bbox is not None:
            lo_lat, lo_lon, hi_lat, hi_lon = bbox
            if not any(
                lo_lat <= nodes[r][0] <= hi_lat and lo_lon <= nodes[r][1] <= hi_lon
                for r in refs
            ):
                continue
        kept.append((OsmWay(w.id, refs, w.tags), rc))

    # intersection detection: node use count across and within kept ways
    use: Dict[int, int] = {}
    for w, _rc in kept:
        for i, r in enumerate(w.refs):
            # endpoints always count as graph nodes
            bump = 2 if i in (0, len(w.refs) - 1) else 1
            use[r] = use.get(r, 0) + bump

    net = RoadNetwork()
    node_index: Dict[int, int] = {}

    def graph_node(osm_id: int) -> int:
        if osm_id not in node_index:
            lat, lon = nodes[osm_id]
            node_index[osm_id] = net.add_node(lat, lon)
        return node_index[osm_id]

    hierarchy = TileHierarchy()
    seg_counters: Dict[Tuple[int, int], int] = {}

    def next_segment_id(level: int, lat: float, lon: float) -> Optional[int]:
        tile = hierarchy.tile_id(level, lat, lon)
        key = (level, tile)
        idx = seg_counters.get(key, 0)
        if idx > SEGMENT_INDEX_MASK:  # pragma: no cover - 2M segments/tile
            log.warning("segment index overflow in tile %s; id dropped", key)
            return None
        seg_counters[key] = idx + 1
        return pack_segment_id(level, tile, idx)

    for w, rc in kept:
        # split points: endpoints + any node used >= 2 times
        cuts = [0]
        for i in range(1, len(w.refs) - 1):
            if use.get(w.refs[i], 0) >= 2:
                cuts.append(i)
        cuts.append(len(w.refs) - 1)
        for a, b in zip(cuts, cuts[1:]):
            piece = w.refs[a:b + 1]
            shape = [nodes[r] for r in piece]
            na = graph_node(piece[0])
            nb = graph_node(piece[-1])
            lat0, lon0 = shape[0]
            if rc.oneway >= 0:
                sid = None if rc.internal else next_segment_id(rc.level, lat0, lon0)
                net.add_edge(Edge(
                    na, nb, shape=list(shape), speed_kph=rc.speed_kph,
                    level=rc.level, segment_id=sid, internal=rc.internal,
                    way_id=w.id,
                ))
            if rc.oneway <= 0:
                lat1, lon1 = shape[-1]
                sid = None if rc.internal else next_segment_id(rc.level, lat1, lon1)
                net.add_edge(Edge(
                    nb, na, shape=list(reversed(shape)), speed_kph=rc.speed_kph,
                    level=rc.level, segment_id=sid, internal=rc.internal,
                    way_id=w.id,
                ))
    log.info(
        "osm import: %d ways kept -> %d nodes / %d edges",
        len(kept), net.num_nodes, net.num_edges,
    )
    return net


def network_from_file(path: str, bbox=None) -> RoadNetwork:
    nodes, ways = load_osm(path)
    return network_from_osm(nodes, ways, bbox=bbox)


# ---------------------------------------------------------------------------
# CLI: extract -> RPTT tile dir and / or RoadNetwork JSON (the networks a
# service config's {"network": {"type": "tiles"}} / {"type": "file"} read)
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse
    import os

    ap = argparse.ArgumentParser(prog="python -m reporter_tpu_torch.tiles.osm",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("input", help=".osm.pbf, .osm/.osm.xml, or Overpass .json")
    ap.add_argument("-o", "--output", default=None, help="RPTT tile output dir")
    ap.add_argument("--json", default=None, help="also dump RoadNetwork JSON here")
    ap.add_argument("--bbox", default=None,
                    help="min_lat,min_lon,max_lat,max_lon filter")
    args = ap.parse_args(argv)
    logging.basicConfig(level=getattr(logging, os.environ.get(
        "REPORTER_LOG_LEVEL", "INFO").upper(), logging.INFO), stream=sys.stderr)
    bbox = None
    if args.bbox:
        parts = [float(x) for x in args.bbox.split(",")]
        if len(parts) != 4:
            ap.error("--bbox wants 4 comma-separated numbers")
        bbox = tuple(parts)  # type: ignore[assignment]
    net = network_from_file(args.input, bbox=bbox)
    if net.num_edges == 0:
        print("no routable ways found", file=sys.stderr)
        return 1
    if args.json:
        with open(args.json, "w") as f:
            json.dump(net.to_dict(), f)
        print("wrote %s" % args.json)
    if args.output:
        from .codec import save_network_tiles

        manifest = save_network_tiles(net, args.output)
        print("wrote %d tiles to %s" % (len(manifest["tiles"]), args.output))
    return 0


if __name__ == "__main__":
    sys.exit(main())
