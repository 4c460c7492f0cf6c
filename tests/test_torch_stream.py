"""The port's streaming stack against the JAX package's, on the CPU: the
point, segment and batch serdes (byte for byte), the formatter DSL on good
and garbage lines, the batch gate and trim, the batcher's micro-batch pools
and eviction, the anonymiser's slicing, cull and validation, and whole
pipelines on a 5 x 5 grid -- raw lines with garbage in between through
``LocalMatcherClient`` on the port (``device="cpu"``) and on the JAX
package, through ``HttpMatcherClient`` against the port's service, and
through the stream CLI on stdin -- whose tiles must hold equal rows under
equal tile paths.  The HTTP client retries a 429 and a 503 "draining"."""

import glob
import io
import json
import os
import random
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.stream import anonymiser as ref_anonymiser
from reporter_tpu.stream import batch as ref_batch
from reporter_tpu.stream import batcher as ref_batcher
from reporter_tpu.stream import client as ref_client
from reporter_tpu.stream import formatter as ref_formatter
from reporter_tpu.stream import point as ref_point
from reporter_tpu.stream import segment as ref_segment
from reporter_tpu.stream import topology as ref_topology
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.obs import metrics as obs
from reporter_tpu_torch.serve import ReporterService
from reporter_tpu_torch.stream import (
    AnonymisingProcessor,
    Batch,
    BatchingProcessor,
    Formatter,
    HttpMatcherClient,
    LocalMatcherClient,
    Point,
    Segment,
)
from reporter_tpu_torch.stream import anonymiser as port_anonymiser
from reporter_tpu_torch.stream import batch as port_batch
from reporter_tpu_torch.stream import batcher as port_batcher
from reporter_tpu_torch.stream import point as port_point
from reporter_tpu_torch.stream import segment as port_segment
from reporter_tpu_torch.stream import topology as port_topology
from reporter_tpu_torch.stream.formatter import joda_to_strptime
from reporter_tpu_torch.stream.segment import INVALID_SEGMENT_ID, pack_list, unpack_list
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.tiles.network import grid_city

SV = ",sv,\\|,0,2,3,1,4"  # uuid|epoch|lat|lon|accuracy
T_ARRIVE = 1_460_000_000_000  # one arrival instant for every line (the CLI's clock, fast)


def tile_rows(out):
    """{tile path: sorted CSV rows} of every tile file under ``out``; file
    names carry a uuid4, so only the tile path and the rows compare."""
    tiles = {}
    for f in glob.glob(os.path.join(out, "**", "*"), recursive=True):
        if os.path.isfile(f):
            with open(f) as fh:
                lines = fh.read().strip().split("\n")
            assert lines[0] == Segment.column_layout()
            tiles.setdefault(os.path.dirname(os.path.relpath(f, out)), []).extend(lines[1:])
    return {k: sorted(v) for k, v in tiles.items()}


# -- serdes ---------------------------------------------------------------


def test_point_serde_and_json_equal_reference():
    rng = np.random.default_rng(3)
    for _ in range(50):
        args = (float(rng.uniform(-90, 90)), float(rng.uniform(-180, 180)),
                int(rng.integers(0, 1000)), int(rng.integers(0, 2 ** 40)))
        p, r = Point(*args), ref_point.Point(*args)
        assert p.pack() == r.pack() and len(p.pack()) == port_point.SIZE == 20
        assert p.to_json() == r.to_json() and p.to_dict() == r.to_dict()
        q = Point.unpack(p.pack())
        assert (q.accuracy, q.time) == (args[2], args[3])
        assert q.lat == pytest.approx(args[0], abs=1e-4)
    assert Point(0.0, 0.0, 7, 10).to_json() == '{"lat":0,"lon":0,"time":10,"accuracy":7}'
    assert Point(1.5, -2.25, 3, 4).to_json() == '{"lat":1.5,"lon":-2.25,"time":4,"accuracy":3}'


def test_segment_serde_and_csv_equal_reference():
    s = Segment(id=0b1010_001, next_id=None, min=100.2, max=163.7, length=120, queue=5)
    r = ref_segment.Segment(id=0b1010_001, next_id=None, min=100.2, max=163.7,
                            length=120, queue=5)
    assert s.pack() == r.pack() and len(s.pack()) == 40
    t = Segment.unpack(s.pack())
    assert t.id == s.id and t.next_id == INVALID_SEGMENT_ID == ref_segment.INVALID_SEGMENT_ID
    assert t.csv_row("AUTO", "SRC") == "81,,63,1,120,5,100,164,SRC,AUTO" == r.csv_row("AUTO",
                                                                                      "SRC")
    # a half-second duration rounds half-up, as Java's Math.round
    h = dict(id=8, next_id=16, min=10.0, max=36.5, length=3, queue=0)
    assert Segment(**h).csv_row("BUS", "S") == ref_segment.Segment(**h).csv_row("BUS", "S")
    assert pack_list([s, t]) == ref_segment.pack_list([r, r])
    assert len(unpack_list(pack_list([s, t]))) == 2
    good = Segment(id=(42 << 25) | (7 << 3) | 1, next_id=3, min=1.0, max=2.0, length=5, queue=0)
    assert good.valid() and good.tile_id() == (7 << 3) | 1
    for bad in (dict(min=0), dict(min=3.0), dict(length=0), dict(queue=-1)):
        kw = dict(id=1, next_id=None, min=1.0, max=2.0, length=5, queue=0, **{})
        kw.update(bad)
        assert not Segment(**kw).valid() and not ref_segment.Segment(**kw).valid()


def _pt(mod, lat, lon, t):
    return mod.Point(lat, lon, 5, t)


def test_batch_gate_trim_and_serde_equal_reference():
    p, r = port_batch.Batch(_pt(port_point, 0.0, 0.0, 0)), ref_batch.Batch(
        _pt(ref_point, 0.0, 0.0, 0))
    for i in range(1, 11):
        p.update(_pt(port_point, 0.0, 0.0005 * i, i * 30))
        r.update(_pt(ref_point, 0.0, 0.0005 * i, i * 30))
        assert p.max_separation == r.max_separation
        assert p.meets(500, 10, 60) == r.meets(500, 10, 60)
    assert p.meets(500, 10, 60)
    p.last_update = r.last_update = 99
    assert p.pack() == r.pack()
    assert Batch.unpack(p.pack()).pack() == p.pack()
    req = p.request("veh", "auto", (0, 1), (0, 1))
    assert req == r.request("veh", "auto", (0, 1), (0, 1))
    p.apply_response({"shape_used": 3})
    r.apply_response({"shape_used": 3})
    assert p.pack() == r.pack() and p.points[0].time == 90
    assert p.max_separation == pytest.approx(
        port_batch.equirectangular_m(p.points[-1], p.points[0]))
    p.apply_response(None)
    assert not p.points and p.max_separation == 0.0


# -- formatter ------------------------------------------------------------


def _fmt_outcome(f, line):
    try:
        uuid, p = f.format(line)
        return ("ok", uuid, p.pack())
    except Exception as e:  # noqa: BLE001 - the outcome is what compares
        assert not isinstance(e, (SystemExit, KeyboardInterrupt, MemoryError))
        return ("raise", type(e).__name__)


def test_formatter_cases_and_garbage_equal_reference():
    f = Formatter.from_config(",sv,\\|,1,9,10,0,5,yyyy-MM-dd HH:mm:ss")
    uuid, p = f.format("2017-01-01 06:05:40|w00t||||6.5||||0.0|0.0")
    assert (uuid, p.accuracy, p.time, p.lat, p.lon) == ("w00t", 7, 1483250740, 0.0, 0.0)
    f = Formatter.from_config("@json@id@la@lo@t@a@yyyy-MM-dd HH:mm:ss")
    uuid, p = f.format('{"t":"2017-01-01 06:05:40","id":"w00t","la":0.0,"lo":0.0,"a":6.5}')
    assert (uuid, p.accuracy, p.time) == ("w00t", 7, 1483250740)
    f = Formatter.from_config("@json@id@latitude@longitude@timestamp@accuracy")
    uuid, p = f.format('{"timestamp":1495037969,"id":"abc","accuracy":51.305,'
                       '"latitude":3.465725,"longitude":-76.5135033}')
    assert (uuid, p.accuracy, p.time) == ("abc", 52, 1495037969)
    for bogus in ("%sv%,%a", "%json%a%b%c%d", "bogus_formatter"):
        with pytest.raises(Exception):
            Formatter.from_config(bogus)
        with pytest.raises(Exception):
            ref_formatter.Formatter.from_config(bogus)
    assert joda_to_strptime("yyyy-MM-dd HH:mm:ss") == "%Y-%m-%d %H:%M:%S"
    with pytest.raises(ValueError):
        joda_to_strptime("QQQ")
    pf, rf = Formatter.from_config(SV), ref_formatter.Formatter.from_config(SV)
    rng = np.random.default_rng(8)
    lines = ["", "|", "||||", "a|b|c|d|e", "veh|notatime|1.0|2.0|5", "veh|100|91.0|181.0|5",
             "veh|100|nan|inf|5", "veh|100|1.0|2.0|" + "9" * 400,
             "\x00\x00|\x00|\x00|\x00|\x00", "veh|100|1.0|2.0|5|extra|columns",
             "x" * 100000, "veh|100|37.75|-122.45|5"]
    for _ in range(40):
        n = int(rng.integers(0, 12))
        lines.append("|".join("".join(chr(int(c)) for c in rng.integers(32, 127,
                                                                        rng.integers(0, 9)))
                              for _ in range(n)))
    outcomes = [_fmt_outcome(pf, ln) for ln in lines]
    assert outcomes == [_fmt_outcome(rf, ln) for ln in lines]
    assert outcomes[-41] == ("ok", "veh", Point(37.75, -122.45, 5, 100).pack())


# -- batcher --------------------------------------------------------------


class FakeClient:
    """Consumes every trace fully, reporting one fixed segment pair."""

    def __init__(self):
        self.requests = []

    def report_many(self, requests):
        self.requests.extend(requests)
        return [{"shape_used": len(r["trace"]), "datastore": {"reports": [{
            "id": 8, "next_id": 16, "t0": r["trace"][0]["time"],
            "t1": r["trace"][-1]["time"], "length": 100, "queue_length": 0}]}}
            for r in requests]


def _drive_batcher(mod, pmod):
    """Both packages' batchers through one scripted sequence: the gate, the
    pooled flush, a trimmed vehicle, eviction with a relaxed final report
    and a lone point evicted silently; (requests, forwarded rows)."""
    client, fwd = FakeClient(), []
    bp = mod.BatchingProcessor(client, lambda k, s: fwd.append((k, s.pack())),
                               report_dist=100, report_count=5, report_time=30,
                               microbatch_size=3)
    t0 = 1_483_250_000
    for i in range(6):
        for v in range(4):
            bp.process("veh-%d" % v, pmod.Point(0.0, 0.001 * i + 0.01 * v, 5, t0 + i * 10),
                       (t0 + i * 10) * 1000, partition=v % 2)
    bp.process("veh-9", pmod.Point(1.0, 1.0, 5, t0), t0 * 1000)
    bp.process("veh-8", pmod.Point(2.0, 2.0, 5, t0), t0 * 1000)
    bp.process("veh-8", pmod.Point(2.0, 2.0004, 5, t0 + 5), (t0 + 5) * 1000)
    pooled = list(bp._ready)
    bp.flush_ready()
    bp.punctuate((t0 + 100) * 1000 + bp.session_gap_ms)
    return client.requests, fwd, pooled, sorted(bp.store)


def test_batcher_pools_trims_and_evicts_like_reference():
    port = _drive_batcher(port_batcher, port_point)
    assert port == _drive_batcher(ref_batcher, ref_point)
    requests, fwd, pooled, left = port
    assert len(requests) >= 4 and {k for k, _ in fwd} == {"8 16"}
    assert "veh-9" not in left and "veh-8" not in left
    client, fwd = FakeClient(), []
    bp = BatchingProcessor(client, lambda k, s: fwd.append(k), report_dist=50,
                           report_count=2, report_time=0, microbatch_size=8)
    for v in range(3):
        bp.process("veh-%d" % v, Point(0.0, 0.0, 5, 1000), 1_000_000)
        bp.process("veh-%d" % v, Point(0.0, 0.001, 5, 1010), 1_010_000)
    assert not client.requests  # pooled, not yet flushed
    bp.flush_ready()
    assert len(client.requests) == 3 and fwd == ["8 16"] * 3


def test_batcher_partition_handoff():
    bp = BatchingProcessor(FakeClient(), lambda k, s: None, microbatch_size=100)
    for v in range(4):
        bp.process("veh-%d" % v, Point(0.0, 0.0, 5, 0), 0, partition=v % 2)
    batches, ready = bp.take_partition(1)
    assert sorted(batches) == ["veh-1", "veh-3"] and sorted(bp.store) == ["veh-0", "veh-2"]
    bp.put_partition(1, batches, ready)
    assert sorted(bp.store) == ["veh-%d" % v for v in range(4)]
    assert bp.partitions == {"veh-0": 0, "veh-2": 0, "veh-1": 1, "veh-3": 1}


# -- anonymiser -----------------------------------------------------------


def _seg(mod, sid, nid, t0, t1):
    return mod.Segment(id=sid, next_id=nid, min=t0, max=t1, length=100, queue=0)


def test_anonymiser_tiles_cull_and_validation(tmp_path):
    assert port_anonymiser.quantised_tiles(_seg(port_segment, 8, 16, 3590.0, 3610.0), 3600) \
        == [(0, 8), (3600, 8)] == ref_anonymiser.quantised_tiles(
            _seg(ref_segment, 8, 16, 3590.0, 3610.0), 3600)
    rows = sorted([_seg(port_segment, 1, 2, 10, 20), _seg(port_segment, 1, 2, 11, 21),
                   _seg(port_segment, 3, 4, 12, 22)], key=Segment.sort_key)
    kept = port_anonymiser.cull(rows, 2)
    assert len(kept) == 2 and all(s.id == 1 for s in kept)  # no trailing-group leak
    for bad in (dict(privacy=0, quantisation=3600), dict(privacy=1, quantisation=30)):
        with pytest.raises(ValueError):
            AnonymisingProcessor(output="x", source="s", **bad)
    outs = {}
    for name, mod in (("port", port_anonymiser), ("ref", ref_anonymiser)):
        out = str(tmp_path / name)
        ap = mod.AnonymisingProcessor(privacy=2, quantisation=3600, output=out,
                                      source="TEST", mode="auto")
        smod = port_segment if mod is port_anonymiser else ref_segment
        for i in range(3):
            ap.process("8 16", _seg(smod, 8, 16, 7200 + i, 7230 + i))
        ap.process("24 -", _seg(smod, 24, None, 7200, 7230))  # lone: culled
        ap.punctuate()
        outs[name] = tile_rows(out)
        files = glob.glob(os.path.join(out, "*", "*", "*", "*"))
        assert len(files) == 1
        rel = os.path.relpath(files[0], out).split(os.sep)
        assert rel[:3] == ["7200_10799", "0", "1"] and rel[3].startswith("TEST.")
    assert outs["port"] == outs["ref"] and len(outs["port"]["7200_10799/0/1"]) == 3


def test_anonymiser_slicing_equals_reference():
    maps = []
    for mod, smod in ((port_anonymiser, port_segment), (ref_anonymiser, ref_segment)):
        ap = mod.AnonymisingProcessor(
            privacy=1, quantisation=3600, output="unused", source="S",
            store=type("N", (), {"put": lambda self, k, b: None})(), slice_size=2)
        for i in range(5):
            ap.process("k", _seg(smod, 8, 16, 100 + i, 110 + i))
        maps.append((dict(ap.map), {k: [s.pack() for s in v] for k, v in ap.slices.items()}))
        ap.punctuate()
        assert ap.tiles_flushed == 1 and not ap.slices and not ap.map
    assert maps[0] == maps[1] and maps[0][0] == {(0, 8): 2}


# -- pipelines on the grid ----------------------------------------------------


@pytest.fixture(scope="module")
def matchers():
    port = SegmentMatcher(network=grid_city(5, 5, 150.0), config=MatcherConfig(),
                          device="cpu")
    ref = RefMatcher(network=ref_grid_city(5, 5, 150.0), config=RefConfig(), backend="jax")
    return port, ref


def _vehicle_lines(arrays, n_vehicles=4, seed=7):
    """SV lines of ``n_vehicles`` synthetic drives in time order, lat / lon
    rounded to float32 (the Point serde's precision)."""
    synth = TraceSynthesizer(arrays, seed=seed)
    rows = []
    for v in range(n_vehicles):
        st = synth.synthesize(24, dt=15.0, sigma=3.0, uuid="veh-%d" % v)
        for pt in st.trace["trace"]:
            rows.append((int(pt["time"]), v, "veh-%d|%d|%r|%r|%d" % (
                v, int(pt["time"]), float(np.float32(pt["lat"])),
                float(np.float32(pt["lon"])), pt["accuracy"])))
    return [r[2] for r in sorted(rows)]


def _pipeline(topology, client, out):
    p = topology.build_pipeline(format_config=SV, client=client, privacy=1,
                                quantisation=3600, output=out, source="CI",
                                report_levels=(0, 1, 2), transition_levels=(0, 1, 2),
                                microbatch_size=4)
    p.batcher.report_dist = 200
    p.batcher.report_count = 8
    p.batcher.report_time = 30
    return p


def _junk(rng):
    alphabet = "abc|,;\x00\xff{}[]\"'\\0123456789.eE+- \t"
    return "".join(rng.choice(alphabet) for _ in range(rng.randrange(0, 60)))


def _run_with_garbage(topology, client, lines, out):
    p = _pipeline(topology, client, out)
    rng = random.Random(1234)
    n_junk = 0
    for line in lines:
        ts = int(line.split("|")[1]) * 1000
        for _ in range(2):
            p.feed(_junk(rng), ts)
            n_junk += 1
        p.feed("veh-x|not-a-lat|1e999|%d|nan" % (ts // 1000), ts)
        n_junk += 1
        p.feed(line, ts)
    p.close()
    return p, n_junk


def test_pipeline_with_garbage_equals_reference(matchers, tmp_path):
    """Raw lines with junk before every record, stamped with the points'
    own times: the same tile rows under the same tile paths as the JAX
    package's pipeline on the same lines."""
    port_m, ref_m = matchers
    lines = _vehicle_lines(port_m.arrays)
    p, n_junk = _run_with_garbage(port_topology, LocalMatcherClient(port_m, threshold_sec=15),
                                  lines, str(tmp_path / "port"))
    r, _ = _run_with_garbage(ref_topology, ref_client.LocalMatcherClient(ref_m,
                                                                         threshold_sec=15),
                             lines, str(tmp_path / "ref"))
    assert p.formatted == len(lines) == r.formatted and p.dropped == n_junk == r.dropped
    assert p.batcher.reported_pairs == r.batcher.reported_pairs > 0
    got = tile_rows(str(tmp_path / "port"))
    assert got and got == tile_rows(str(tmp_path / "ref"))


def _arrival_run(client, lines, out):
    """The lines through a pipeline, every one stamped with one arrival
    instant and closed at it, as the CLI on a fast stdin does."""
    p = _pipeline(port_topology, client, out)
    for line in lines:
        p.feed(line, T_ARRIVE)
    p.close(T_ARRIVE)
    return tile_rows(out)


def test_http_client_and_cli_equal_local(matchers, tmp_path, monkeypatch):
    """HttpMatcherClient against the port's service, and the stream CLI on
    stdin against it, give the in-process client's tiles."""
    from reporter_tpu_torch.stream.__main__ import main

    port_m, _ = matchers
    lines = _vehicle_lines(port_m.arrays, n_vehicles=5, seed=11)
    want = _arrival_run(LocalMatcherClient(port_m, threshold_sec=15), lines,
                        str(tmp_path / "local"))
    assert want
    svc = ReporterService(port_m, threshold_sec=15, max_wait_ms=2.0,
                          robustness={"watchdog_s": 0})
    server = svc.make_server("127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    url = "http://127.0.0.1:%d/report" % server.server_address[1]
    try:
        client = HttpMatcherClient(url)
        assert client.batch_url.endswith("/trace_attributes_batch")
        assert _arrival_run(client, lines, str(tmp_path / "http")) == want
        monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
        assert main(["--format", SV, "--reporter-url", url, "--privacy", "1",
                     "--quantisation", "3600", "--source", "CI", "--output",
                     str(tmp_path / "cli"), "--reports", "0,1,2", "--transitions", "0,1,2",
                     "--microbatch", "4"]) == 0
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        th.join(10)
    # the CLI keeps the batcher's default gate (500 m, 10 points, 60 s):
    # the same lines through a pipeline with that gate
    p = port_topology.build_pipeline(format_config=SV, client=LocalMatcherClient(
        port_m, threshold_sec=15), privacy=1, quantisation=3600,
        output=str(tmp_path / "local_default"), source="CI", report_levels=(0, 1, 2),
        transition_levels=(0, 1, 2), microbatch_size=4)
    for line in lines:
        p.feed(line, T_ARRIVE)
    p.close(T_ARRIVE)
    cli = tile_rows(str(tmp_path / "cli"))
    assert cli and cli == tile_rows(str(tmp_path / "local_default"))


def test_local_client_warmup_counts_the_matchers_shapes(matchers):
    """LocalMatcherClient.warmup is the matcher's: one shape a length
    bucket (the configured kernel) counted by kernel, seconds returned."""
    port_m, _ = matchers

    def shapes():
        fam = obs.REGISTRY.snapshot()["reporter_warmup_shapes_total"]["samples"]
        return {tuple(lv): v for lv, v in fam}
    before = shapes()
    assert LocalMatcherClient(port_m).warmup(lengths=[16, 32]) > 0.0
    after = shapes()
    assert after[("scan",)] - before.get(("scan",), 0.0) == 2
    assert LocalMatcherClient(object()).warmup() == 0.0  # a matcher without one


class _Flaky(BaseHTTPRequestHandler):
    """Answers the first POST with ``status`` (Retry-After 0, the service's
    shed or drain body), every later one with canned batch results."""

    protocol_version = "HTTP/1.1"
    plan = []
    seen = []

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        self.seen.append(self.headers.get("X-Reporter-Trace"))
        status = self.plan.pop(0) if self.plan else 200
        if status == 200:
            out = json.dumps({"results": [{"shape_used": len(t["trace"]),
                                           "datastore": {"reports": []}}
                                          for t in body["traces"]]}).encode()
        else:
            out = json.dumps({"error": "draining" if status == 503 else "overloaded",
                              "retry_after": 0}).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        if status != 200:
            self.send_header("Retry-After", "0")
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *a):
        pass


@pytest.mark.parametrize("status,cause", [(503, "5xx"), (429, "429")])
def test_http_client_retries_shed_and_drain(status, cause, monkeypatch):
    monkeypatch.setenv("REPORTER_RETRY_BASE_S", "0.001")
    _Flaky.plan[:] = [status]
    _Flaky.seen[:] = []
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Flaky)
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    def count(name, *lv):
        samples = obs.REGISTRY.snapshot()[name]["samples"]
        return sum(v for labels, v in samples if tuple(labels) == lv)
    before = count("reporter_egress_retries_total", "matcher", cause)
    ok_before = count("reporter_client_responses_total", "matcher", "200")
    try:
        client = HttpMatcherClient("http://127.0.0.1:%d/report" % srv.server_address[1])
        reqs = [{"uuid": "a", "trace": [{"time": 1}, {"time": 2}]},
                {"uuid": "b", "trace": [{"time": 1}]}]
        assert client.report_many(reqs) == [{"shape_used": 2, "datastore": {"reports": []}},
                                            {"shape_used": 1, "datastore": {"reports": []}}]
    finally:
        srv.shutdown()
        srv.server_close()
    assert count("reporter_egress_retries_total", "matcher", cause) - before == 1
    assert count("reporter_client_responses_total", "matcher", "200") - ok_before == 1
    # both attempts carried one trace id, minted for the call
    assert len(_Flaky.seen) == 2 and _Flaky.seen[0] == _Flaky.seen[1]
