"""The port's map ingestion and its helpers against the JAX package's, on
the CPU: the OSM PBF codec and the XML / Overpass readers on a
hand-modelled district, road classification, ``network_from_osm`` and
its bbox filter, the import CLI's ``--json``, the tile hierarchy, the
bench's realistic city (nodes, ways, network and device arrays), the
host geodesy, ``RoadNetwork``'s lengths and JSON form, the UBODT's host
probe and the synthesizer's helpers.  Every comparison is exact."""

import dataclasses
import json
import math
import subprocess
import sys

import numpy as np
import pytest

from reporter_tpu import geo as ref_geo
from reporter_tpu.synth import TraceSynthesizer as RefSynthesizer
from reporter_tpu.synth import generator as ref_gen
from reporter_tpu.synth import osm_city as ref_city
from reporter_tpu.tiles import hierarchy as ref_hier
from reporter_tpu.tiles import osm as ref_osm
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch import geo
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.synth import generator as gen
from reporter_tpu_torch.synth import osm_city
from reporter_tpu_torch.tiles import hierarchy, osm
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city
from reporter_tpu_torch.tiles.ubodt import build_ubodt

REPO = __import__("os").path.dirname(__import__("os").path.dirname(__import__("os").path.abspath(
    __file__)))


def city_fixture(way_cls):
    """(nodes, ways): a small district with every classification feature
    (motorway and ramps, primary / secondary / residential levels, one-way
    streets both ways, a roundabout, mph and km/h maxspeeds, a footpath
    and an area to drop), its ways as ``way_cls``."""
    nodes = {}
    nid = [100]

    def node(lat, lon):
        nid[0] += 1
        nodes[nid[0]] = (lat, lon)
        return nid[0]

    lat0, lon0 = 47.6060, -122.3320
    dg = 0.0015  # ~166 m in latitude
    grid = [[node(lat0 + r * dg, lon0 + c * dg) for c in range(6)] for r in range(6)]
    ways = []
    wid = [1000]

    def way(refs, **tags):
        wid[0] += 1
        ways.append(way_cls(id=wid[0], refs=list(refs),
                            tags={k: str(v) for k, v in tags.items()}))

    for r in range(6):
        tags = {"highway": "residential", "name": "R%d St" % r}
        if r == 2:
            tags = {"highway": "primary", "name": "Central Ave", "maxspeed": "40 mph"}
        if r == 4:
            tags = {"highway": "residential", "oneway": "yes"}
        way(grid[r], **tags)
    for c in range(6):
        tags = {"highway": "residential"}
        if c == 3:
            tags = {"highway": "secondary", "maxspeed": "50"}
        if c == 1:
            tags = {"highway": "residential", "oneway": "-1"}
        way([grid[r][c] for r in range(6)], **tags)
    m = [node(lat0 - dg + k * 2 * dg, lon0 + 6.5 * dg) for k in range(4)]
    way(m, highway="motorway", maxspeed="60 mph", name="I-5")
    way([grid[2][5], m[1]], highway="motorway_link")
    way([m[2], grid[4][5]], highway="motorway_link")
    clat, clon = lat0 - 2 * dg, lon0 + dg
    ring = [node(clat + 0.0004 * math.cos(a), clon + 0.0004 * math.sin(a))
            for a in np.linspace(0, 2 * math.pi, 7)[:-1]]
    way(ring + [ring[0]], highway="tertiary", junction="roundabout")
    way([grid[0][1], ring[0]], highway="tertiary")
    way([grid[0][0], grid[0][1]], highway="footpath")
    way([grid[5][4], grid[5][5]], highway="primary", area="yes")
    return nodes, ways


def _ways(ways):
    return [(w.id, list(w.refs), dict(w.tags)) for w in ways]


@pytest.fixture(scope="module")
def district(tmp_path_factory):
    """The district written by both packages' PBF writers, and as XML and
    an Overpass JSON export."""
    d = tmp_path_factory.mktemp("osm")
    nodes, ways = city_fixture(osm.OsmWay)
    _rn, ref_ways = city_fixture(ref_osm.OsmWay)
    paths = {"pbf": str(d / "port.osm.pbf"), "ref_pbf": str(d / "ref.osm.pbf"),
             "xml": str(d / "city.osm.xml"), "json": str(d / "city.json")}
    osm.write_pbf(paths["pbf"], nodes, ways)
    ref_osm.write_pbf(paths["ref_pbf"], nodes, ref_ways)
    with open(paths["xml"], "w") as f:
        f.write("<osm version='0.6'>\n")
        for i, (lat, lon) in nodes.items():
            f.write("<node id='%d' lat='%.9f' lon='%.9f'/>\n" % (i, lat, lon))
        for w in ways:
            f.write("<way id='%d'>" % w.id)
            for r in w.refs:
                f.write("<nd ref='%d'/>" % r)
            for k, v in w.tags.items():
                f.write("<tag k='%s' v='%s'/>" % (k, v))
            f.write("</way>\n")
        f.write("</osm>\n")
    with open(paths["json"], "w") as f:
        json.dump({"elements": [{"type": "node", "id": i, "lat": lat, "lon": lon}
                                for i, (lat, lon) in nodes.items()]
                   + [{"type": "way", "id": w.id, "nodes": w.refs, "tags": w.tags}
                      for w in ways]}, f)
    return dict(paths, nodes=nodes, ways=ways, ref_ways=ref_ways)


def test_pbf_writer_bytes_and_reader(district):
    with open(district["pbf"], "rb") as f, open(district["ref_pbf"], "rb") as g:
        assert f.read() == g.read()
    nodes, ways = osm.read_pbf(district["pbf"])
    ref_nodes, ref_ways = ref_osm.read_pbf(district["pbf"])
    assert nodes == ref_nodes and len(nodes) == len(district["nodes"])
    assert _ways(ways) == _ways(ref_ways) == _ways(district["ways"])
    blocks = list(osm.iter_pbf_blocks(district["pbf"]))
    assert blocks == list(ref_osm.iter_pbf_blocks(district["pbf"]))
    assert [b for b, _p in blocks] == ["OSMHeader", "OSMData"]


@pytest.mark.parametrize("kind", ["xml", "json", "pbf"])
def test_readers_and_load_osm(district, kind):
    nodes, ways = osm.load_osm(district[kind])
    ref_nodes, ref_ways = ref_osm.load_osm(district[kind])
    assert nodes == ref_nodes
    assert _ways(ways) == _ways(ref_ways)
    reader = {"xml": osm.read_xml, "json": osm.read_overpass_json, "pbf": osm.read_pbf}[kind]
    assert reader(district[kind])[0] == nodes


MAXSPEEDS = ["40 mph", "50", "60 mph", "30 km/h", "45kmh", " 70 ", "walk", "", "none", "25mph"]


@pytest.mark.parametrize("i", range(19))
def test_classify(district, i):
    """Each of the district's ways' tags, and variants of them (oneway
    spellings, an area, a roundabout), classified as the reference does."""
    tags = dict(district["ways"][i].tags)
    variants = [tags, dict(tags, oneway="reverse"), dict(tags, oneway="no"),
                dict(tags, oneway="true"), dict(tags, junction="circular"),
                dict(tags, area="yes"), dict(tags, maxspeed="0")]
    for t in variants:
        got, want = osm.classify(t), ref_osm.classify(t)
        assert (got is None) == (want is None)
        if got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("value", MAXSPEEDS)
def test_parse_maxspeed(value):
    assert osm.parse_maxspeed(value) == ref_osm.parse_maxspeed(value)


@pytest.mark.parametrize("bbox", [None, (47.6050, -122.3330, 47.6095, -122.3290),
                                  (47.6100, -122.3240, 47.6200, -122.3100)])
def test_network_from_osm_and_bbox(district, bbox):
    nodes = district["nodes"]
    got = osm.network_from_osm(nodes, district["ways"], bbox=bbox)
    want = ref_osm.network_from_osm(nodes, district["ref_ways"], bbox=bbox)
    assert got.num_edges > 0
    assert json.dumps(got.to_dict()) == json.dumps(want.to_dict())
    assert json.dumps(osm.network_from_file(district["xml"], bbox=bbox).to_dict()) == \
        json.dumps(ref_osm.network_from_file(district["xml"], bbox=bbox).to_dict())


def test_cli_json(district, tmp_path, capsys):
    out = tmp_path / "net.json"
    assert osm.main([district["pbf"], "--json", str(out),
                     "--bbox", "47.6050,-122.3330,47.6095,-122.3290"]) == 0
    want = ref_osm.network_from_file(district["pbf"], bbox=(47.6050, -122.3330, 47.6095,
                                                            -122.3290))
    assert json.loads(out.read_text()) == json.loads(json.dumps(want.to_dict()))
    assert "wrote" in capsys.readouterr().out
    # -o writes RPTT tiles that the JAX package's codec reads back to the
    # --json network: its edges in the tiles' order (level, then tile, then
    # network order) and speeds at the format's float32
    assert osm.main([district["pbf"], "-o", str(tmp_path / "tiles"),
                     "--json", str(tmp_path / "both.json")]) == 0
    from reporter_tpu.tiles.codec import load_network_tiles as ref_load_network_tiles

    net_d = json.loads((tmp_path / "both.json").read_text())
    back = json.loads(json.dumps(ref_load_network_tiles(str(tmp_path / "tiles")).to_dict()))
    h = ref_hier.TileHierarchy()
    lat, lon = net_d["nodes"]["lat"], net_d["nodes"]["lon"]
    order = sorted(range(len(net_d["edges"])), key=lambda i: (
        net_d["edges"][i]["level"], h.tile_id(net_d["edges"][i]["level"],
                                              lat[net_d["edges"][i]["from"]],
                                              lon[net_d["edges"][i]["from"]]), i))
    want_edges = [dict(net_d["edges"][i],
                       speed_kph=float(np.float32(net_d["edges"][i]["speed_kph"])))
                  for i in order]
    assert back == {"nodes": net_d["nodes"], "edges": want_edges}
    with open(tmp_path / "tiles" / "manifest.json") as f:
        n_tiles = len(json.load(f)["tiles"])
    assert "wrote %d tiles to %s" % (n_tiles, tmp_path / "tiles") in capsys.readouterr().out
    with pytest.raises(SystemExit):
        osm.main([district["pbf"], "--bbox", "1,2,3"])
    # as a module, the way a service's network file is made
    full = tmp_path / "full.json"
    r = subprocess.run([sys.executable, "-m", "reporter_tpu_torch.tiles.osm", district["pbf"],
                        "--json", str(full)], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    want = ref_osm.network_from_file(district["pbf"])
    assert json.loads(full.read_text()) == json.loads(json.dumps(want.to_dict()))


POINTS = [(37.75, -122.45), (47.606, -122.332), (-33.9, 151.2), (90.0, 180.0), (-90.0, -180.0),
          (0.0, 0.0), (12.125, -0.25), (89.99, 179.99), (-45.5, 179.75), (91.0, 0.0),
          (0.0, -181.0)]
BBOXES = [(-122.5, 37.7, -122.4, 37.8), (179.5, -17.0, -179.5, -16.0), (-180.0, -90.0, -179.0,
          -89.0), (170.0, 10.0, 190.0, 11.0), (-190.0, 10.0, -175.0, 11.0), (5.0, 5.0, 5.0, 5.0)]


@pytest.mark.parametrize("level", [0, 1, 2])
def test_tile_hierarchy(level):
    h, rh = hierarchy.TileHierarchy(), ref_hier.TileHierarchy()
    ts, rts = h.levels[level], rh.levels[level]
    assert (ts.ncolumns, ts.nrows, ts.max_tile_id) == (rts.ncolumns, rts.nrows, rts.max_tile_id)
    for lat, lon in POINTS:
        tid = h.tile_id(level, lat, lon)
        assert tid == rh.tile_id(level, lat, lon)
        if tid >= 0:
            assert dataclasses.astuple(ts.tile_bbox(tid)) == dataclasses.astuple(
                rts.tile_bbox(tid))
            assert ts.file_suffix(tid, level, "json") == rts.file_suffix(tid, level, "json")
    for box in BBOXES:
        assert list(h.tiles_in_bbox(*box)) == list(rh.tiles_in_bbox(*box))
        assert h.tile_files_in_bbox(*box, suffix="gph", levels=[level]) == \
            rh.tile_files_in_bbox(*box, suffix="gph", levels=[level])


@pytest.mark.parametrize("seed", [0, 3])
def test_realistic_city_primitives(seed):
    nodes, ways = osm_city.realistic_city(30, 26, seed=seed)
    ref_nodes, ref_ways = ref_city.realistic_city(30, 26, seed=seed)
    assert nodes == ref_nodes
    assert _ways(ways) == _ways(ref_ways)


@pytest.fixture(scope="module")
def city24():
    net = osm_city.realistic_city_network(24, 24, seed=3)
    ref_net = ref_city.realistic_city_network(24, 24, seed=3)
    return (net, build_graph_arrays(net, cell_size=100.0), ref_net,
            ref_build_graph_arrays(ref_net, cell_size=100.0))


def test_realistic_city_network_arrays(city24):
    net, pa, ref_net, ra = city24
    assert json.dumps(net.to_dict()) == json.dumps(ref_net.to_dict())
    for f in dataclasses.fields(ra):
        want, got = getattr(ra, f.name), getattr(pa, f.name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), f.name
        elif f.name == "proj":
            assert (got.lat0, got.lon0, got.coslat0) == (want.lat0, want.lon0, want.coslat0)
        else:
            assert got == want, f.name
    assert pa.grid_items.shape[1] > 8  # denser cells than the lattice's
    # without the PBF round trip the network is the same (7-digit lat/lon
    # survive the codec's 100-nanodegree granularity)
    direct = osm_city.realistic_city_network(24, 24, seed=3, via_pbf=False)
    assert json.dumps(direct.to_dict()) == json.dumps(
        ref_city.realistic_city_network(24, 24, seed=3, via_pbf=False).to_dict())


def test_network_lengths(city24):
    net, _pa, ref_net, _ra = city24
    for ei in range(0, net.num_edges, 37):
        assert net.edge_length_m(ei) == ref_net.edge_length_m(ei)
    assert net.segment_lengths() == ref_net.segment_lengths()


@pytest.mark.parametrize("seed", [1, 2])
def test_host_geodesy(seed):
    rng = np.random.default_rng(seed)
    lat = 37.7 + rng.uniform(0, 0.2, (2, 64))
    lon = -122.5 + rng.uniform(0, 0.2, (2, 64))
    assert np.array_equal(geo.haversine_m(lat[0], lon[0], lat[1], lon[1]),
                          ref_geo.haversine_m(lat[0], lon[0], lat[1], lon[1]))
    assert np.array_equal(geo.equirectangular_m(lat[0], lon[0], lat[1], lon[1]),
                          ref_geo.equirectangular_m(lat[0], lon[0], lat[1], lon[1]))
    xy = rng.normal(0, 300, (6, 256)).astype(np.float32)
    xy[2:4, :8] = xy[4:6, :8]  # zero-length segments
    xy[0, 8:12] = xy[2, 8:12]  # points on a segment's end
    for fn, ref_fn in ((geo.point_segment_distance_np, ref_geo.point_segment_distance_np),
                       (geo.point_segment_distance_f32, ref_geo.point_segment_distance_f32)):
        (d, t), (dr, tr) = fn(*xy), ref_fn(*xy)
        assert d.dtype == dr.dtype and d.tobytes() == dr.tobytes()
        assert t.tobytes() == tr.tobytes()
    # the baseline's hypot keeps subnormal legs and results, as the
    # reference's does (the kernels' flush them, as XLA does)
    u = np.array([1e-40, 0.0, 3e-39, 3.0, np.inf, 0.0], np.float32)
    v = np.array([1e-40, 1e-40, 2.0 ** -125, 4.0, 1.0, 0.0], np.float32)
    got = geo._hypot_f32_like_jax(u, v)
    assert got.tobytes() == ref_geo._hypot_f32_like_jax(u, v).tobytes()
    assert got[0] > 0 and got[1] == np.float32(1e-40) and got[3] == 5.0


def test_lookup_full(city24):
    _net, pa, _rn, ra = city24
    pu, ru = build_ubodt(pa, delta=1200.0), ref_build_ubodt(ra, delta=1200.0)
    rng = np.random.default_rng(4)
    src = rng.integers(0, pa.num_nodes, 300)
    dst = rng.integers(0, pa.num_nodes, 300)
    n_hit = 0
    for s, d in zip(src.tolist() + [0, 5], dst.tolist() + [0, 5]):
        got, want = pu.lookup_full(s, d), ru.lookup_full(s, d)
        assert got == want
        n_hit += got[2] >= 0
    assert 0 < n_hit < 302


def test_synth_helpers(city24):
    _net, pa, _rn, ra = city24
    port = TraceSynthesizer(pa, seed=7).batch(6, 40, dt=5.0, sigma=5.0)
    ref = RefSynthesizer(ra, seed=7).batch(6, 40, dt=5.0, sigma=5.0)
    for a, b in zip(gen.cohort_xy(pa, port, 40), ref_gen.cohort_xy(ra, ref, 40)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    rng = np.random.default_rng(2)
    for s, r in zip(port, ref):
        matched = np.where(rng.random(40) < 0.7, s.truth_edge, rng.integers(-1, pa.num_edges, 40))
        assert gen.segment_agreement(pa, matched, s) == ref_gen.segment_agreement(ra, matched, r)
    assert gen.segment_agreement(pa, port[0].truth_edge, port[0]) == 1.0
    ga = build_graph_arrays(grid_city(6, 7, 150.0), cell_size=100.0)
    gr = ref_build_graph_arrays(ref_grid_city(6, 7, 150.0), cell_size=100.0)
    for a, b in zip(gen.example_grid_batch(ga, 5, 16, seed=3),
                    ref_gen.example_grid_batch(gr, 5, 16, seed=3)):
        assert a.tobytes() == b.tobytes()
    cfg, arrays, ubodt = gen.dryrun_scenario()
    rcfg, rarrays, rubodt = ref_gen.dryrun_scenario()
    assert arrays.edge_to.tobytes() == rarrays.edge_to.tobytes()
    assert ubodt.packed.tobytes() == rubodt.packed.tobytes()
    assert (cfg.beam_k, cfg.sigma_z, cfg.ubodt_delta) == (rcfg.beam_k, rcfg.sigma_z,
                                                          rcfg.ubodt_delta)
