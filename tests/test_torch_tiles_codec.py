"""The port's tile codecs against the JAX package's, on the CPU: the RPTT
tile directory (``tiles/codec.py``: native and numpy writers and readers,
the level filter, corrupt tiles) and the Valhalla GPH codec
(``tiles/gph.py``), on a 5 x 5 grid, the hand-modelled district of
``test_torch_osm`` and a small realistic city.  Every comparison is
exact: bytes, or the JSON form of the networks."""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from reporter_tpu import native as ref_native
from reporter_tpu.synth import osm_city as ref_city
from reporter_tpu.tiles import codec as ref_codec
from reporter_tpu.tiles import gph as ref_gph
from reporter_tpu.tiles import osm as ref_osm
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu_torch import native
from reporter_tpu_torch.synth import osm_city
from reporter_tpu_torch.tiles import codec, gph, osm
from reporter_tpu_torch.tiles.network import grid_city
from test_torch_osm import city_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = ("grid", "district", "city")


def networks(name):
    """(port network, reference network) of one kind."""
    if name == "grid":
        return grid_city(5, 5, 150.0), ref_grid_city(5, 5, 150.0)
    if name == "district":
        nodes, ways = city_fixture(osm.OsmWay)
        _n, ref_ways = city_fixture(ref_osm.OsmWay)
        return osm.network_from_osm(nodes, ways), ref_osm.network_from_osm(nodes, ref_ways)
    return (osm_city.realistic_city_network(8, 8, seed=3),
            ref_city.realistic_city_network(8, 8, seed=3))


def _files(d):
    out = {}
    for root, _dirs, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def _as_json(net):
    return json.loads(json.dumps(net.to_dict()))


@pytest.fixture(params=["native", "python"])
def path_kind(request, monkeypatch):
    """Both packages' codecs on one path: the native core or the numpy
    implementation."""
    if request.param == "native":
        assert native.get_lib() is not None and ref_native.get_lib() is not None
    else:
        monkeypatch.setattr(codec, "get_lib", lambda: None)
        monkeypatch.setattr(ref_codec, "get_lib", lambda: None)
    return request.param


@pytest.mark.parametrize("name", NETS)
def test_save_network_tiles_byte_identical(name, path_kind, tmp_path):
    net, ref_net = networks(name)
    manifest = codec.save_network_tiles(net, str(tmp_path / "port"))
    assert manifest == ref_codec.save_network_tiles(ref_net, str(tmp_path / "ref"))
    got, want = _files(tmp_path / "port"), _files(tmp_path / "ref")
    assert got == want
    assert sum(t["edges"] for t in manifest["tiles"]) == net.num_edges
    if name != "grid":  # the OSM networks span every level
        assert {t["level"] for t in manifest["tiles"]} == {0, 1, 2}


@pytest.mark.parametrize("name", NETS)
def test_each_reads_the_others_tiles(name, path_kind, tmp_path):
    net, ref_net = networks(name)
    codec.save_network_tiles(net, str(tmp_path / "port"))
    ref_codec.save_network_tiles(ref_net, str(tmp_path / "ref"))
    want = _as_json(ref_codec.load_network_tiles(str(tmp_path / "port")))
    assert _as_json(codec.load_network_tiles(str(tmp_path / "ref"))) == want
    assert _as_json(codec.load_network_tiles(str(tmp_path / "port"))) == want
    assert want["nodes"] == _as_json(net)["nodes"]
    assert len(want["edges"]) == net.num_edges
    for levels in ({0}, {1}, {2}, {1, 2}, set()):
        got = _as_json(codec.load_network_tiles(str(tmp_path / "ref"), levels=levels))
        assert got == _as_json(ref_codec.load_network_tiles(str(tmp_path / "port"),
                                                            levels=levels))
        assert all(e["level"] in levels for e in got["edges"])


def test_native_and_python_paths_agree(tmp_path, monkeypatch):
    net, _r = networks("district")
    codec.save_network_tiles(net, str(tmp_path / "native"))
    with monkeypatch.context() as mp:
        mp.setattr(codec, "get_lib", lambda: None)
        codec.save_network_tiles(net, str(tmp_path / "python"))
        py_read = _as_json(codec.load_network_tiles(str(tmp_path / "native")))
    assert _files(tmp_path / "native") == _files(tmp_path / "python")
    assert py_read == _as_json(codec.load_network_tiles(str(tmp_path / "python")))


def _corrupt(tmp_path):
    """Tile files each reader must refuse."""
    good = str(tmp_path / "good.rptt")
    arrays = codec.TileArrays(*([np.zeros(0)] * 2 + [np.zeros(0, np.uint32)] * 2
                                + [np.zeros(0, np.float32)] + [np.zeros(0, np.uint8)] * 2
                                + [np.zeros(0, np.int64)] * 2 + [np.zeros(0, np.uint32)]
                                + [np.zeros(0)] * 2))
    codec.write_tile(good, arrays)
    cases = {"garbage": b"not a tile at all",
             "empty": b"",
             "short header": struct.pack("<3I", codec.MAGIC, codec.VERSION, 1),
             "bad magic": struct.pack("<6I", 0x12345678, codec.VERSION, 0, 0, 0, 0),
             "bad version": struct.pack("<6I", codec.MAGIC, 9, 0, 0, 0, 0),
             "truncated nodes": struct.pack("<6I", codec.MAGIC, codec.VERSION, 100, 0, 0, 0),
             "truncated edges": struct.pack("<6I", codec.MAGIC, codec.VERSION, 0, 3, 0, 0)
             + b"\0" * 20,
             "truncated shape": struct.pack("<6I", codec.MAGIC, codec.VERSION, 0, 0, 5, 0)
             + b"\0" * 8}
    paths = {}
    for k, data in cases.items():
        paths[k] = str(tmp_path / (k.replace(" ", "_") + ".rptt"))
        with open(paths[k], "wb") as f:
            f.write(data)
    return good, paths


def test_corrupt_tiles_refused_alike(path_kind, tmp_path):
    good, paths = _corrupt(tmp_path)
    assert codec.read_tile(good).n_nodes == ref_codec.read_tile(good).n_nodes == 0
    for k, p in paths.items():
        with pytest.raises(IOError) as want:
            ref_codec.read_tile(p)
        with pytest.raises(IOError) as got:
            codec.read_tile(p)
        assert str(got.value) == str(want.value), k
    with pytest.raises((IOError, OSError)):
        codec.read_tile(str(tmp_path / "missing.rptt"))
    # a manifest of another version
    d = tmp_path / "tiles"
    codec.save_network_tiles(grid_city(3, 3), str(d))
    m = json.loads((d / "manifest.json").read_text())
    (d / "manifest.json").write_text(json.dumps(dict(m, version=7)))
    for load in (codec.load_network_tiles, ref_codec.load_network_tiles):
        with pytest.raises(IOError, match="manifest version 7"):
            load(str(d))


# -- GPH ---------------------------------------------------------------------


@pytest.mark.parametrize("name", NETS)
@pytest.mark.parametrize("level", [0, 1, 2])
def test_gph_encode_tiles_byte_identical(name, level):
    net, ref_net = networks(name)
    tiles = gph.encode_tiles(net, level=level)
    assert tiles == ref_gph.encode_tiles(ref_net, level=level)
    got = _as_json(gph.network_from_tiles(tiles.values()))
    assert got == _as_json(ref_gph.network_from_tiles(tiles.values()))
    assert len(got["nodes"]["lat"]) == net.num_nodes
    assert len(got["edges"]) == net.num_edges
    # the decoded tiles, field by field
    for data in tiles.values():
        t, rt = gph.decode_gph(data), ref_gph.decode_gph(data)
        assert (t.graphid, t.version, t.base_lat, t.base_lon, t.level, t.tileid) == (
            rt.graphid, rt.version, rt.base_lat, rt.base_lon, rt.level, rt.tileid)
        assert [vars(n) for n in t.nodes] == [vars(n) for n in rt.nodes]
        assert [vars(e) for e in t.edges] == [vars(e) for e in rt.edges]
        assert gph.encode_tile(t) == ref_gph.encode_tile(rt)


def test_gph_shapes_and_graphids():
    rng = np.random.default_rng(3)
    for _ in range(50):
        pts = [(float(a), float(b)) for a, b in zip(rng.uniform(-90, 90, 7),
                                                     rng.uniform(-180, 180, 7))]
        enc = gph.encode_shape(pts)
        assert enc == ref_gph.encode_shape(pts)
        assert gph.decode_shape(enc) == ref_gph.decode_shape(enc)
    for args in ((0, 0, 0), (2, 736070, 5), (7, (1 << 22) - 1, (1 << 21) - 1)):
        gid = gph.pack_graphid(*args)
        assert gid == ref_gph.pack_graphid(*args)
        assert gph.unpack_graphid(gid) == ref_gph.unpack_graphid(gid) == args
    for args in ((8, 0, 0), (0, 1 << 22, 0), (0, 0, -1)):
        with pytest.raises(ref_gph.GphError):
            ref_gph.pack_graphid(*args)
        with pytest.raises(gph.GphError):
            gph.pack_graphid(*args)


def test_gph_malformed_refused_alike():
    net, _r = networks("district")
    data = next(iter(gph.encode_tiles(net, level=2).values()))
    bad = {
        "short": data[:100],
        "version": data[:8] + b"3.0.0".ljust(16, b"\0") + data[24:],
        "sections": data[:-4],
    }
    einfo_off = gph.HEADER_BYTES + len(gph.decode_gph(data).nodes) * gph.NODE_BYTES
    bad["edge offset"] = (data[:einfo_off + 8] + struct.pack("<I", 1 << 30)
                          + data[einfo_off + 12:])
    for k, b in bad.items():
        with pytest.raises(ref_gph.GphError) as want:
            ref_gph.decode_gph(b)
        with pytest.raises(gph.GphError) as got:
            gph.decode_gph(b)
        assert str(got.value) == str(want.value), k
    for b in (b"\x80", b"\x02"):
        with pytest.raises(ref_gph.GphError) as want:
            ref_gph.decode_shape(b)
        with pytest.raises(gph.GphError) as got:
            gph.decode_shape(b)
        assert str(got.value) == str(want.value)
    # an edge whose end node lies in a tile outside the decoded set
    tiles = gph.encode_tiles(net, level=2)
    if len(tiles) > 1:
        one = [next(iter(tiles.values()))]
        with pytest.raises(ref_gph.GphError):
            ref_gph.network_from_tiles(one)
        with pytest.raises(gph.GphError):
            gph.network_from_tiles(one)


_BLOCKED_RUN = r'''
import importlib.abc, sys, tempfile

def blocked(name):
    return name.startswith("jax") or name == "reporter_tpu" or name.startswith("reporter_tpu.")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if blocked(name):
            raise ImportError("blocked import of %s" % name)
        return None

sys.meta_path.insert(0, Block())
from reporter_tpu_torch.serve import wire
from reporter_tpu_torch.serve.service import ReporterService, _gunzip
from reporter_tpu_torch.tiles import codec, gph
from reporter_tpu_torch.tiles.network import grid_city

net = grid_city(4, 4, 150.0)
with tempfile.TemporaryDirectory() as d:
    codec.save_network_tiles(net, d)
    assert codec.load_network_tiles(d).num_edges == net.num_edges
assert gph.network_from_tiles(gph.encode_tiles(net).values()).num_edges == net.num_edges
body = {"traces": [{"uuid": "a", "trace": [{"lat": 1.0, "lon": 2.0, "time": 3}]}]}
got = wire.decode_request(wire.encode_request(body))
got["traces"][0].pop("_columns")
assert got == body
assert not [m for m in sys.modules if blocked(m)]
print("ISOLATED-OK")
'''


def test_new_modules_import_with_jax_and_reference_blocked():
    """The wire, the tile codec and the GPH codec run with JAX and the
    reference package unimportable (the isolation test's source scan
    covers their text)."""
    r = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ISOLATED-OK" in r.stdout
