"""The port's anonymiser against the JAX package's, on the CPU: time
quantised tiles and their observations, the privacy cull (a randomized
property check on both), the CSV rows, the segment-id helpers, the tile
stores (directory, HTTP POST into ``tools/datastore_stub.py``, the S3 PUT's
signed request) with the shared retry budget, and the batch pipeline's
shard-row parser on torn rows, native and Python alike.  Rows must be
equal, not merely close."""

import collections
import http.server
import os
import sys
import threading
import urllib.error

import numpy as np
import pytest

from reporter_tpu import native as ref_native
from reporter_tpu.anonymise import storage as ref_storage
from reporter_tpu.anonymise import tiles as ref_tiles
from reporter_tpu.tiles import segment_id as ref_sid
from reporter_tpu_torch import native
from reporter_tpu_torch.anonymise import (
    CSV_HEADER,
    DirStore,
    HttpStore,
    S3Store,
    SegmentObservation,
    TimeQuantisedTile,
    make_store,
    observations_for_report,
    privacy_cull,
)
from reporter_tpu_torch.anonymise import storage
from reporter_tpu_torch.anonymise import tiles as port_tiles
from reporter_tpu_torch.anonymise.tiles import tile_csv, usable_report
from reporter_tpu_torch.obs import metrics as obs
from reporter_tpu_torch.tiles import segment_id as sid_mod
from reporter_tpu_torch.tiles.segment_id import INVALID_SEGMENT_ID, get_tile_id, pack_segment_id

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SID = pack_segment_id(1, 1000, 5)
SID2 = pack_segment_id(1, 1000, 6)


def rep(t0, t1, sid=SID, next_id=None, length=200.0, queue=0.0):
    r = {"id": sid, "t0": t0, "t1": t1, "length": length, "queue_length": queue}
    if next_id is not None:
        r["next_id"] = next_id
    return r


def _obs_rows(mod, r, *args, **kw):
    """(tile path, csv row) of every observation a report expands into."""
    return [(t.path(args[0]), o.csv_row())
            for t, o in mod.observations_for_report(r, *args, **kw)]


REPORTS = [
    (rep(100, 160, next_id=SID2), (3600, "src"), {}),
    (rep(3590, 3610), (3600, "src"), {}),
    (rep(0, 4 * 3600), (3600, "src"), {"max_buckets": 2}),
    (rep(10, 20), (3600, "src"), {}),
    (rep(26.5, 53.0, next_id=SID2), (60, "s", "BUS"), {}),  # a half-second: Java rounding
    (rep(7199.5, 10800.2, sid=pack_segment_id(2, 4_000_000, 2_000_000)),
     (3600, "src"), {"max_buckets": 3}),
]


@pytest.mark.parametrize("case", range(len(REPORTS)))
def test_observations_equal_reference(case):
    r, args, kw = REPORTS[case]
    assert _obs_rows(port_tiles, r, *args, **kw) \
        == _obs_rows(ref_tiles, r, *args, **kw)


def test_observation_cases():
    (tile, o), = observations_for_report(rep(100, 160, next_id=SID2), 3600, "src")
    assert tile == TimeQuantisedTile(0, get_tile_id(SID))
    assert o.segment_id == SID and o.next_segment_id == SID2
    assert o.duration == 60 and o.count == 1
    assert o.min_timestamp == 100 and o.max_timestamp == 160
    assert [t.time_start for t, _ in observations_for_report(rep(3590, 3610), 3600, "s")] \
        == [0, 3600]
    assert list(observations_for_report(rep(0, 4 * 3600), 3600, "s", max_buckets=2)) == []
    _t, o = next(iter(observations_for_report(rep(10, 20), 3600, "src")))
    assert o.next_segment_id == INVALID_SEGMENT_ID
    assert TimeQuantisedTile(7200, get_tile_id(SID)).path(3600) == "7200_10799/1/1000"
    for r, want in ((rep(10, 20), True), (rep(0, 20), False), (rep(10, 10.2), False),
                    (rep(10, 20, length=0), False), (rep(10, 20, queue=-1), False)):
        assert usable_report(r) is want is ref_tiles.usable_report(r)


def _obs(mod, a, b, t=100, length=200.0):
    return mod.SegmentObservation(a, b, 10, 1, length, 0.0, t, t + 10, "s", "AUTO")


def test_privacy_cull_cases():
    rows = [_obs(ref_tiles, SID, SID2), _obs(ref_tiles, SID, SID2), _obs(ref_tiles, SID2, SID)]
    port_rows = [SegmentObservation(**vars(r)) for r in rows]
    out = privacy_cull(port_rows, 2)
    assert len(out) == 2 and all(o.segment_id == SID for o in out)
    assert len(privacy_cull(port_rows[1:], 1)) == 2
    assert privacy_cull(port_rows[:1], 2) == []


@pytest.mark.parametrize("trial", range(25))
def test_privacy_property_equals_reference(trial):
    """For every (segment_id, next_segment_id) pair the output carries all
    of its observations (count >= privacy) or none, sorted by the contract
    key -- and exactly the reference's rows."""
    rng = np.random.default_rng(17 + trial)
    privacy = int(rng.integers(1, 5))
    ids = [int(v) for v in rng.integers(1, 9, 2)]
    rows = []
    for _ in range(int(rng.integers(0, 40))):
        a, b = int(rng.choice(ids + [3, 4, 5])), int(rng.choice(ids + [3, 4, 5]))
        t = int(rng.integers(0, 3600))
        rows.append((a, b, t, float(rng.integers(20, 400))))
    port = privacy_cull([_obs(port_tiles, a, b, t, ln)
                         for a, b, t, ln in rows], privacy)
    ref = ref_tiles.privacy_cull([_obs(ref_tiles, a, b, t, ln) for a, b, t, ln in rows],
                                 privacy)
    assert [o.csv_row() for o in port] == [o.csv_row() for o in ref]
    counts = collections.Counter((a, b) for a, b, _t, _l in rows)
    out_counts = collections.Counter((r.segment_id, r.next_segment_id) for r in port)
    for pair, n in counts.items():
        assert out_counts.get(pair, 0) == (n if n >= privacy else 0)
    assert [r.sort_key() for r in port] == sorted(r.sort_key() for r in port)


def test_csv_roundtrip_and_header():
    rows = [_obs(port_tiles, SID, SID2)] * 2
    text = tile_csv(rows)
    assert text == ref_tiles.tile_csv([_obs(ref_tiles, SID, SID2)] * 2)
    lines = text.strip().split("\n")
    assert lines[0] == CSV_HEADER == ref_tiles.CSV_HEADER
    assert SegmentObservation.from_csv_row(lines[1]) == rows[0]


def test_segment_id_helpers_equal_reference():
    rng = np.random.default_rng(5)
    assert sid_mod.INVALID_SEGMENT_ID == ref_sid.INVALID_SEGMENT_ID == 0x3FFFFFFFFFFF
    for _ in range(200):
        s = pack_segment_id(int(rng.integers(0, 8)), int(rng.integers(0, 1 << 22)),
                            int(rng.integers(0, 1 << 21)))
        for name in ("unpack_segment_id", "get_tile_level", "get_tile_index",
                     "get_segment_index", "get_tile_id"):
            assert getattr(sid_mod, name)(s) == getattr(ref_sid, name)(s), name


# -- stores -------------------------------------------------------------------


def _server(handler):
    srv = http.server.HTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_dir_store_and_make_store(tmp_path):
    store = make_store("dir:%s" % tmp_path)
    store.put("7200_10799/1/1000/src.abc", "hello\n")
    assert (tmp_path / "7200_10799" / "1" / "1000" / "src.abc").read_text() == "hello\n"
    assert isinstance(make_store(str(tmp_path)), DirStore)
    assert isinstance(make_store("http://x/y"), HttpStore)
    s3 = make_store("s3://mybucket/tiles/v1")
    assert isinstance(s3, S3Store) and (s3.bucket, s3.prefix) == ("mybucket", "tiles/v1")
    assert make_store("s3://bucket").bucket == "bucket"
    for spec in ("dir:/a", "/b", "http://x/y", "https://h/z", "s3://bk/p/q"):
        assert repr(make_store(spec)) == repr(ref_storage.make_store(spec))


def test_http_store_posts_and_4xx_raises():
    received = {}

    class Ok(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            received["path"] = self.path
            received["type"] = self.headers["Content-Type"]
            received["body"] = self.rfile.read(int(self.headers["Content-Length"])).decode()
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, *a):
            pass

    class Bad(Ok):
        def do_POST(self):
            self.send_response(400)
            self.end_headers()

    srv, bad = _server(Ok), _server(Bad)
    try:
        HttpStore("http://127.0.0.1:%d/store" % srv.server_port).put(
            "0_3599/1/1000/src.x", "csv,data\n")
        assert received == {"path": "/store/0_3599/1/1000/src.x", "type": "text/csv",
                            "body": "csv,data\n"}
        with pytest.raises(urllib.error.HTTPError):
            HttpStore("http://127.0.0.1:%d" % bad.server_port).put("k", "v")
    finally:
        srv.shutdown()
        bad.shutdown()


def test_s3_store_signs_like_reference(monkeypatch):
    """Both packages' S3 PUTs, at one fixed date, send the same path, body
    and headers (the AWS signature V2 over the same string)."""
    got = []

    class Put(http.server.BaseHTTPRequestHandler):
        def do_PUT(self):
            got.append((self.path, dict(self.headers.items()),
                        self.rfile.read(int(self.headers["Content-Length"]))))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = _server(Put)
    date = "Sun, 18 Oct 2026 12:00:00 GMT"
    monkeypatch.setattr(storage, "formatdate", lambda usegmt=True: date)
    monkeypatch.setattr(ref_storage, "formatdate", lambda usegmt=True: date)
    try:
        for mod in (storage, ref_storage):
            mod.S3Store("bk", access_key="AK", secret_key="SK", prefix="tiles",
                        endpoint="http://127.0.0.1:%d" % srv.server_port).put(
                "0_3599/1/7/s.u", "a,b\n")
    finally:
        srv.shutdown()
    (p_path, p_h, p_body), (r_path, r_h, r_body) = got
    assert (p_path, p_body) == (r_path, r_body) == ("/tiles/0_3599/1/7/s.u", b"a,b\n")
    for k in ("Content-Type", "Date", "Authorization"):
        assert p_h[k] == r_h[k], k
    assert p_h["Authorization"].startswith("AWS AK:")


def test_store_retries_injected_5xx_within_budget(tmp_path, monkeypatch):
    """REPORTER_FAULT_STORE_PUT=5xx:1 fails the first attempt; the shared
    retry policy sends the second, which lands, and counts one retry."""
    from reporter_tpu_torch import faults

    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from datastore_stub import make_server
    finally:
        sys.path.pop(0)
    srv = make_server(str(tmp_path / "ds"), host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    monkeypatch.setenv("REPORTER_FAULT_STORE_PUT", "5xx:1")
    monkeypatch.setenv("REPORTER_RETRY_BASE_S", "0.001")
    faults.reset()

    def retries():
        snap = obs.REGISTRY.snapshot()["reporter_egress_retries_total"]["samples"]
        return sum(v for lv, v in snap if tuple(lv) == ("store", "5xx"))
    before = retries()
    try:
        HttpStore("http://127.0.0.1:%d/t" % srv.server_address[1]).put("0_59/0/1/S.x", "h\n1\n")
    finally:
        srv.shutdown()
        srv.server_close()
        monkeypatch.delenv("REPORTER_FAULT_STORE_PUT")
        faults.reset()
    assert (tmp_path / "ds" / "t" / "0_59" / "0" / "1" / "S.x").read_text() == "h\n1\n"
    assert retries() - before == 1


def test_datastore_stub_receives_http_tiles(tmp_path):
    """HttpStore -> tools/datastore_stub -> files on disk keyed by tile
    path, for both packages' stores alike."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from datastore_stub import make_server
    finally:
        sys.path.pop(0)
    root = tmp_path / "ds"
    srv = make_server(str(root), host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        for name, cls in (("port", HttpStore), ("ref", ref_storage.HttpStore)):
            cls("http://127.0.0.1:%d/%s" % (srv.server_address[1], name)).put(
                "1459998000_1460001599/1/45777/SRC.abc", "h,e,a,d\n1,2,3,4\n")
    finally:
        srv.shutdown()
        srv.server_close()
    got = [(root / n / "1459998000_1460001599" / "1" / "45777" / "SRC.abc").read_bytes()
           for n in ("port", "ref")]
    assert got[0] == got[1] == b"h,e,a,d\n1,2,3,4\n"


# -- the shard-row parser -----------------------------------------------------

TORN = (
    b"veh-1,1460000000,37.7512345,-122.4412345,5\n"
    b"veh-2,1460000005,37.75,-122.44,12\r\n"
    b"  veh-3,1460000010,37.76,-122.43,7  \n"
    b"veh-4,146000,37.7\n"                       # torn mid-row
    b",1460000015,37.7,-122.4,5\n"               # empty uuid
    b"veh-5,notatime,37.7,-122.4,5\n"
    b"veh-6,1460000020,37.7,-122.4,5,extra\n"
    b"veh-\xe2\x82,1460000025,37.7,-122.4,5\n"   # a torn multi-byte character
    b"\n"
    b"veh-7,1460000030,-0.0,1e-3,0\n"
    b"veh-8,1460000035,37.7,-122.4,5"            # no trailing newline
)


def _parsed(out):
    uuids, tm, lat, lon, acc = out
    assert (tm.dtype, lat.dtype, lon.dtype, acc.dtype) == (
        np.int64, np.float64, np.float64, np.int32)
    return uuids, tm.tolist(), lat.tolist(), lon.tolist(), acc.tolist()


@pytest.mark.parametrize("data", [TORN, TORN[:57], TORN[:-3], b"", b"a,1,2,3,4"])
def test_parse_shard_bytes_equals_reference(data, monkeypatch):
    """Torn and malformed rows are skipped as the reference skips them: the
    native parser (the same C++ source) and the Python one each equal the
    reference's."""
    lib = native.get_lib()
    assert lib is not None and hasattr(lib, "rn_parse_shard")
    nat = _parsed(native.parse_shard_bytes(data))
    assert nat == _parsed(ref_native.parse_shard_bytes(data))
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(ref_native, "get_lib", lambda: None)
    py = _parsed(native.parse_shard_bytes(data))
    assert py == _parsed(ref_native.parse_shard_bytes(data))
    assert py == nat
    if data == TORN:
        # the torn character is replaced, its row kept
        assert py[0] == ["veh-1", "veh-2", "veh-3", "veh-\ufffd", "veh-7", "veh-8"]
