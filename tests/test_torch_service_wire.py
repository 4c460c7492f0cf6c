"""The port's service, its batch route, wire and admission, on the CPU:
``/trace_attributes_batch`` and ``/report`` against the JAX package's
``ReporterService`` over HTTP (the same bodies give the same status and
the same JSON, the "trace %d: ..." 400s and the binary frames byte for
byte included), the four encodings of one body answering alike, the
negotiation's refusals (415, 400), ``$REPORTER_WIRE=0``, the batcher's
admission (429 shedding with Retry-After, deadlines with 504 before
dispatch, ``max_inflight``) and the "tiles" network type.  Every
comparison is exact."""

import gzip
import http.client
import json
import logging
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.serve import service as ref_service_mod
from reporter_tpu.serve import wire as ref_wire
from reporter_tpu.serve.service import ReporterService as RefService
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.matching import config as config_mod
from reporter_tpu_torch.serve import service as service_mod
from reporter_tpu_torch.serve import wire
from reporter_tpu_torch.serve.service import (DeadlineExpired, MicroBatcher, Overloaded,
                                              ReporterService, batch_options, build_matcher,
                                              parse_service_config)
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.codec import save_network_tiles
from reporter_tpu_torch.tiles.network import grid_city

MO = {"mode": "auto", "report_levels": [0, 1, 2], "transition_levels": [0, 1, 2]}
KW = dict(length_buckets=[16, 32])
JSON_H = {"Content-Type": "application/json"}
BIN_H = {"Content-Type": wire.CONTENT_TYPE, "Accept": wire.CONTENT_TYPE}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("REPORTER_WIRE", "REPORTER_MAX_QUEUE", "REPORTER_DEADLINE_MS",
                "REPORTER_SPARSE", "REPORTER_CALIBRATION", "REPORTER_INTERPOLATE",
                "REPORTER_UBODT_LAYOUT", "REPORTER_PROBE_DEDUP", "REPORTER_VITERBI",
                "REPORTER_UBODT_HOT_BYTES", "REPORTER_OBS_PROBE_EVERY"):
        monkeypatch.delenv(var, raising=False)


def _serve(service):
    server = service.make_server("127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    return server, th, "http://127.0.0.1:%d" % server.server_address[1]


def _stop(server, th):
    server.shutdown()
    server.server_close()
    th.join(10)


@pytest.fixture(scope="module")
def world():
    """The 5 x 5 grid in both packages, a service of each on HTTP, and
    seeded traces: street-following synthetic ones with int and float
    times, some with accuracy."""
    ra = ref_build_graph_arrays(ref_grid_city(5, 5, 150.0), cell_size=100.0)
    pa = build_graph_arrays(grid_city(5, 5, 150.0), cell_size=100.0)
    ref = RefMatcher(arrays=ra, ubodt=ref_build_ubodt(ra, delta=2000.0),
                     config=RefConfig(**KW), backend="jax")
    port = SegmentMatcher(arrays=pa, config=MatcherConfig(ubodt_delta=2000.0, **KW),
                          device="cpu")
    rng = np.random.default_rng(15)
    synth = TraceSynthesizer(pa, seed=15)
    traces = []
    for i in range(10):
        tr = synth.synthesize(int(rng.integers(6, 30)), dt=5.0, sigma=4.0, uuid="veh-%d" % i,
                              max_tries=400).trace
        for p in tr["trace"]:
            if i % 3 == 0:
                p["time"] = int(round(p["time"]))
            if i % 4 == 1:
                p["accuracy"] = int(rng.integers(3, 20))
        tr["match_options"] = dict(MO)
        traces.append(tr)
    svc, ref_svc = ReporterService(port, max_wait_ms=2.0), RefService(ref, max_wait_ms=2.0)
    srv, th, url = _serve(svc)
    rsrv, rth, ref_url = _serve(ref_svc)
    yield {"port": port, "traces": traces, "svc": svc, "url": url, "ref_url": ref_url,
           "ref_svc": ref_svc}
    _stop(srv, th)
    _stop(rsrv, rth)
    svc.close()


def _post(url, data, headers=JSON_H):
    req = urllib.request.Request(url, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _both(world, path, data, headers=JSON_H):
    """(port answer, reference answer): status, Content-Type, body."""
    out = []
    for url in (world["url"], world["ref_url"]):
        code, hdrs, raw = _post(url + path, data, headers)
        out.append((code, hdrs.get("Content-Type"), raw))
    return out


BATCH_CASES = ("all", "three", "one", "extra key", "uuid at 2", "levels at 1",
               "one point at 0", "sigma at 3", "empty", "not a list", "no traces",
               "not an object", "string trace")


def _bodies(traces):
    """Batch bodies by case: valid ones, and invalid ones at several
    indices."""
    t = traces
    no_uuid = {k: v for k, v in t[2].items() if k != "uuid"}
    no_rl = dict(t[1], match_options={"transition_levels": [0]})
    one_pt = dict(t[3], trace=t[3]["trace"][:1])
    bad_sigma = dict(t[0], match_options=dict(MO, sigma_z=-1))
    return dict([
        ("all", {"traces": t}),
        ("three", {"traces": t[4:7]}),
        ("one", {"traces": [t[9]]}),
        ("extra key", {"traces": t[:2], "client": "fleet-1"}),
        ("uuid at 2", {"traces": t[:2] + [no_uuid] + t[3:5]}),
        ("levels at 1", {"traces": [t[0], no_rl]}),
        ("one point at 0", {"traces": [one_pt, t[1]]}),
        ("sigma at 3", {"traces": t[:3] + [bad_sigma]}),
        ("empty", {"traces": []}),
        ("not a list", {"traces": "x"}),
        ("no traces", {"uuid": "a"}),
        ("not an object", ["x"]),
        ("string trace", {"traces": ["x"]}),
    ])


@pytest.mark.parametrize("case", BATCH_CASES)
def test_batch_bodies_answer_as_reference(world, case):
    bodies = _bodies(world["traces"])
    assert set(bodies) == set(BATCH_CASES)
    body = bodies[case]
    (code, ctype, raw), (rcode, rctype, rraw) = _both(
        world, "/trace_attributes_batch", json.dumps(body).encode())
    assert (code, ctype, json.loads(raw)) == (rcode, rctype, json.loads(rraw))
    if case in ("all", "three", "one", "extra key"):
        assert code == 200 and len(json.loads(raw)["results"]) == len(body["traces"])
    elif " at " in case:
        assert code == 400
        assert json.loads(raw)["error"].startswith("trace %s: " % case.split()[-1])
    else:
        assert code in (400, 500)
    # the same body through the handlers themselves
    if isinstance(body, dict) and case != "string trace":
        assert world["svc"].handle_batch(json.loads(json.dumps(body)))[0] == code


def test_report_bodies_answer_as_reference(world):
    t = world["traces"]
    for body in (t[0], t[5], dict(t[1], trace=t[1]["trace"][:1]), {"trace": []},
                 dict(t[2], match_options={"report_levels": [0]})):
        (code, ctype, raw), (rcode, rctype, rraw) = _both(world, "/report",
                                                         json.dumps(body).encode())
        assert (code, ctype, json.loads(raw)) == (rcode, rctype, json.loads(rraw))


def test_four_encodings_answer_alike(world):
    """JSON, gzip JSON, binary in and out, binary in and JSON out: equal
    answers on the port, the binary frames byte-identical to the JSON
    package's, each binary answer under the wire's Content-Type."""
    body = {"traces": world["traces"]}
    js = json.dumps(body).encode()
    frame = wire.encode_request(json.loads(js))
    path = "/trace_attributes_batch"
    runs = {
        "json": _both(world, path, js),
        "gzip": _both(world, path, gzip.compress(js),
                      dict(JSON_H, **{"Content-Encoding": "gzip"})),
        "binary": _both(world, path, frame, BIN_H),
        "binary in": _both(world, path, frame, {"Content-Type": wire.CONTENT_TYPE}),
    }
    decoded = {}
    for how, ((code, ctype, raw), (rcode, rctype, rraw)) in runs.items():
        assert code == rcode == 200, how
        assert ctype == rctype
        assert raw == rraw or json.loads(raw) == json.loads(rraw), how
        if how == "binary":
            assert ctype == wire.CONTENT_TYPE and raw == rraw
            decoded[how] = wire.decode_response(raw)
            assert json.dumps(decoded[how]) == json.dumps(ref_wire.decode_response(rraw))
        else:
            assert ctype == "application/json;charset=utf-8"
            decoded[how] = json.loads(raw)
    want = decoded["json"]
    assert all(d == want for d in decoded.values())
    assert len(runs["binary"][0][2]) < len(runs["json"][0][2])
    # one bare /report, binary both ways (single-flagged) and JSON
    tr = world["traces"][3]
    (code, ctype, raw), (rcode, _rc, rraw) = _both(world, "/report", wire.encode_request(tr),
                                                   BIN_H)
    assert code == rcode == 200 and ctype == wire.CONTENT_TYPE and raw == rraw
    assert raw[6] & wire.FLAG_SINGLE
    jcode, _h, jraw = _post(world["url"] + "/report", json.dumps(tr).encode())
    assert jcode == 200
    assert wire.decode_response(raw) == json.loads(jraw) == want["results"][3]


def test_negotiation_flags_reset_on_keep_alive(world):
    """One binary request must not turn the next request on the same
    socket binary."""
    host, port = world["url"][len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    tr = world["traces"][0]
    try:
        for path, headers, data, binary in (
                ("/report", BIN_H, wire.encode_request(tr), True),
                ("/report", JSON_H, json.dumps(tr).encode(), False),
                ("/trace_attributes_batch", dict(JSON_H, Accept=wire.CONTENT_TYPE),
                 json.dumps({"traces": [tr]}).encode(), True),
                ("/trace_attributes_batch", JSON_H, json.dumps({"traces": [tr]}).encode(),
                 False)):
            conn.request("POST", path, body=data, headers=headers)
            r = conn.getresponse()
            raw = r.read()
            assert r.status == 200
            assert wire.is_wire(r.getheader("Content-Type")) == binary
            if not binary:
                json.loads(raw)
    finally:
        conn.close()


def test_refusals_answer_as_reference(world, monkeypatch):
    """Unknown Content-Encoding 415; a bad gzip body, an inflate past the
    bound and a garbage frame 400; the same status and JSON as the JSON
    package's service."""
    tr = json.dumps(world["traces"][0]).encode()
    cases = [
        ("/report", tr, dict(JSON_H, **{"Content-Encoding": "br"}), 415),
        ("/trace_attributes_batch", tr, dict(JSON_H, **{"Content-Encoding": "deflate"}), 415),
        ("/report", b"\x1f\x8bnot-gzip-at-all", dict(JSON_H, **{"Content-Encoding": "gzip"}),
         400),
        ("/report", gzip.compress(b" " * 5000 + tr), dict(JSON_H, **{"Content-Encoding": "gzip"}),
         400),
        ("/report", b"RPTC\x01\x01\x00\x00junk", {"Content-Type": wire.CONTENT_TYPE}, 400),
        ("/trace_attributes_batch", b"RPTC\x02\x01\x00\x00", BIN_H, 400),
        ("/report", wire.encode_response({"results": []}), BIN_H, 400),
        ("/report", b"{not json", JSON_H, 400),
    ]
    monkeypatch.setattr(service_mod, "_MAX_INFLATE", 4096)
    monkeypatch.setattr(ref_service_mod, "_MAX_INFLATE", 4096)
    for path, data, headers, want in cases:
        (code, ctype, raw), (rcode, rctype, rraw) = _both(world, path, data, headers)
        assert (code, ctype, json.loads(raw)) == (rcode, rctype, json.loads(rraw)) and \
            code == want, (path, headers, raw)
    # under the bound the same gzip body is answered
    monkeypatch.setattr(service_mod, "_MAX_INFLATE", 1 << 20)
    code, _h, _raw = _post(world["url"] + "/report", gzip.compress(b" " * 5000 + tr),
                           dict(JSON_H, **{"Content-Encoding": "gzip"}))
    assert code == 200


def test_wire_off_answers_as_reference(world, monkeypatch):
    """$REPORTER_WIRE=0: binary bodies 415, Accept alone answered in JSON,
    "wire-columnar" gone from /health's capabilities, as on the JSON
    package's service."""
    with urllib.request.urlopen(world["url"] + "/health", timeout=30) as r:
        assert json.loads(r.read())["capabilities"] == ["gzip", "wire-columnar"]
    monkeypatch.setenv("REPORTER_WIRE", "0")
    svc = ReporterService(world["port"], max_wait_ms=2.0)
    ref_svc = RefService(world["ref_svc"].matcher, max_wait_ms=2.0)
    srv, th, url = _serve(svc)
    rsrv, rth, ref_url = _serve(ref_svc)
    try:
        w = {"url": url, "ref_url": ref_url}
        tr = world["traces"][0]
        for path, data, headers in (("/report", wire.encode_request(tr), BIN_H),
                                    ("/trace_attributes_batch",
                                     wire.encode_request({"traces": [tr]}), BIN_H)):
            (code, ctype, raw), (rcode, rctype, rraw) = _both(w, path, data, headers)
            assert (code, ctype, json.loads(raw)) == (rcode, rctype, json.loads(rraw))
            assert code == 415
        (code, ctype, raw), (rcode, rctype, rraw) = _both(
            w, "/report", json.dumps(tr).encode(), dict(JSON_H, Accept=wire.CONTENT_TYPE))
        assert code == rcode == 200 and ctype == rctype == "application/json;charset=utf-8"
        assert json.loads(raw) == json.loads(rraw)
        caps = []
        for u in (url, ref_url):
            with urllib.request.urlopen(u + "/health", timeout=30) as r:
                caps.append(json.loads(r.read())["capabilities"])
        assert caps[0] == caps[1] == ["gzip"]
    finally:
        _stop(srv, th)
        _stop(rsrv, rth)
        svc.close()


def test_columns_side_channel_never_reaches_report(world):
    tr = json.loads(json.dumps(world["traces"][4]))
    want = world["svc"].handle_report(json.loads(json.dumps(tr)))
    decoded = wire.decode_request(wire.encode_request(tr))
    assert isinstance(decoded["_columns"]["lat"], np.ndarray)
    assert world["svc"].handle_report(decoded) == want
    batch = wire.decode_request(wire.encode_request({"traces": [tr, tr]}))
    code, out = world["svc"].handle_batch(batch)
    assert code == 200 and out["results"] == [want[1], want[1]]
    assert all("_columns" not in t for t in batch["traces"])
    json.dumps(out)


# -- admission ----------------------------------------------------------------


class Gate:
    """A matcher whose dispatch waits for ``open``, counting the traces
    dispatched; its finish runs the real matcher."""

    def __init__(self, matcher, block_finish=False):
        self.m, self.cfg = matcher, matcher.cfg
        self.open = threading.Event()
        self.dispatched = []
        self.block_finish = block_finish

    def match_many_async(self, traces):
        self.dispatched.append(len(traces))
        if not self.block_finish:
            self.open.wait(60)
        finish = self.m.match_many_async(traces)

        def done():
            if self.block_finish:
                self.open.wait(60)
            return finish()
        return done


def _wait_for(cond, timeout=30.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout
        time.sleep(0.005)


def test_full_queue_sheds_with_429(world):
    gate = Gate(world["port"])
    svc = ReporterService(gate, max_batch=1, max_wait_ms=0.0, robustness={"max_queue": 2})
    srv, th, url = _serve(svc)
    t = world["traces"]
    answers = {}

    def send(i, path="/report", body=None):
        answers[i] = _post(url + path, json.dumps(body or t[i]).encode())

    try:
        first = threading.Thread(target=send, args=(0,))
        first.start()
        _wait_for(lambda: gate.dispatched == [1])
        queued = [threading.Thread(target=send, args=(i,)) for i in (1, 2)]
        for q in queued:
            q.start()
        _wait_for(lambda: svc.batcher._q.qsize() == 2)
        for i in (3, 4):
            send(i)
        send(5, "/trace_attributes_batch", {"traces": t[5:8]})
        for i in (3, 4, 5):
            code, hdrs, raw = answers[i]
            body = json.loads(raw)
            assert code == 429 and body["error"].startswith("submit queue full")
            assert int(hdrs["Retry-After"]) == body["retry_after"] >= 1
        assert gate.dispatched == [1]
        gate.open.set()
        for w in [first] + queued:
            w.join(60)
        assert [answers[i][0] for i in (0, 1, 2)] == [200, 200, 200]
        assert sum(gate.dispatched) == 3
    finally:
        gate.open.set()
        _stop(srv, th)
        svc.close()


def test_deadline_answers_504_before_dispatch(world):
    gate = Gate(world["port"])
    gate.open.set()
    svc = ReporterService(gate, max_wait_ms=1.0)
    srv, th, url = _serve(svc)
    t = world["traces"]
    try:
        for path, body in (("/report", t[0]), ("/trace_attributes_batch", {"traces": t[:3]})):
            code, _h, raw = _post(url + path, json.dumps(body).encode(),
                                  dict(JSON_H, **{"X-Reporter-Deadline-Ms": "0"}))
            assert code == 504 and "deadline expired" in json.loads(raw)["error"]
        assert gate.dispatched == []
        # a malformed deadline is ignored, a roomy one is met
        for value in ("soon", "", "60000"):
            code, _h, raw = _post(url + "/report", json.dumps(t[0]).encode(),
                                  dict(JSON_H, **{"X-Reporter-Deadline-Ms": value}))
            assert code == 200, value
        assert gate.dispatched == [1, 1, 1]
        # the handlers' own deadline argument, as ingestion passes it
        assert svc.handle_batch({"traces": t[:2]}, time.monotonic() - 1.0)[0] == 504
        assert svc.handle_report(dict(t[1]), time.monotonic() - 1.0)[0] == 504
        assert gate.dispatched == [1, 1, 1]
    finally:
        _stop(srv, th)
        svc.close()


def test_admission_knobs(world, monkeypatch, caplog):
    """max_queue and deadline_ms from the robustness block, the
    environment over both, <= 0 turning the server's deadline off; the
    fault domains' keys carried to both batchers, a key the reference
    does not read named once; Overloaded and DeadlineExpired from the
    batcher itself."""
    m = world["port"]
    monkeypatch.setattr(config_mod, "_WARNED", set())
    with caplog.at_level(logging.WARNING, logger=config_mod.__name__):
        svc = ReporterService(m, robustness={"max_queue": 7, "deadline_ms": 250,
                                             "watchdog_s": 5, "quarantine_after": 3,
                                             "retry_budget": 2})
        ReporterService(m, robustness={"watchdog_s": 9, "retry_budget": 1}).close()
    try:
        for b in (svc.batcher, svc.session_batcher):
            assert (b.max_queue, b.deadline_s, b._q.maxsize) == (7, 0.25, 7)
            assert (b.watchdog_s, b.quarantine_after) == (5, 3)
    finally:
        svc.close()
    assert [r.getMessage() for r in caplog.records] == [
        "robustness config key 'retry_budget' is not carried by this port; ignored"]
    monkeypatch.setenv("REPORTER_MAX_QUEUE", "3")
    monkeypatch.setenv("REPORTER_DEADLINE_MS", "0")
    gate = Gate(m)
    b = MicroBatcher(gate, max_batch=1, max_wait_ms=0.0, max_queue=50, deadline_ms=100)
    try:
        assert (b.max_queue, b.deadline_s) == (3, 0.0)
        first = b.submit(dict(world["traces"][0]))
        _wait_for(lambda: gate.dispatched == [1])
        futs = [b.submit(dict(world["traces"][i])) for i in (1, 2, 3)]
        with pytest.raises(Overloaded):
            b.submit(dict(world["traces"][4]))
        assert b.retry_after_s() == 4
        gate.open.set()
        # no deadline by default here: every queued entry is answered
        assert first.result(60) and all(f.result(60) for f in futs)
        late = b.submit(dict(world["traces"][5]), time.monotonic() - 0.5)
        with pytest.raises(DeadlineExpired):
            late.result(60)
    finally:
        gate.open.set()
        b.close()
    monkeypatch.setenv("REPORTER_MAX_QUEUE", "lots")
    b = MicroBatcher(gate, max_queue=5)
    assert b.max_queue == 5
    b.close()


@pytest.mark.parametrize("inflight", [1, 2, 3])
def test_max_inflight_bounds_the_finisher_queue(world, inflight):
    """With the finisher held, dispatch stops after max_inflight batches
    wait for it (one finishing, ``max_inflight`` queued, one blocked on
    the hand-off)."""
    gate = Gate(world["port"], block_finish=True)
    conf = {"batch": {"max_batch": 1, "max_wait_ms": 0.0, "max_inflight": inflight}}
    svc = ReporterService(gate, **batch_options(conf))
    try:
        assert svc.batcher._finish_q.maxsize == svc.batcher.max_inflight == inflight
        futs = [svc.batcher.submit(dict(world["traces"][i])) for i in range(7)]
        _wait_for(lambda: len(gate.dispatched) == inflight + 2)
        time.sleep(0.2)
        assert len(gate.dispatched) == inflight + 2
        gate.open.set()
        assert all(f.result(60) for f in futs) and len(gate.dispatched) == 7
    finally:
        gate.open.set()
        svc.close()


def test_max_inflight_defaults():
    class Stub:
        def match_many_async(self, traces):
            return lambda: [{} for _ in traces]

    class OnCard(Stub):
        backend, device = "jax", torch.device("cuda", 0)

    class Engine:
        matcher = OnCard()

    for m, want in ((Stub(), 2), (OnCard(), 4), (Engine(), 4)):
        b = MicroBatcher(m)
        assert b.max_inflight == b._finish_q.maxsize == want
        b.close()
    b = MicroBatcher(Stub(), max_inflight=0)
    assert b._finish_q.maxsize == 1
    b.close()


def test_tiles_config_answers_as_file_config(world, tmp_path):
    """A {"network": {"type": "tiles"}} config builds a matcher whose
    batch answers equal the "file" config's on the same network."""
    net = grid_city(5, 5, 150.0)
    save_network_tiles(net, str(tmp_path / "tiles"))
    with open(tmp_path / "net.json", "w") as f:
        json.dump(net.to_dict(), f)
    answers = []
    for spec in ({"type": "tiles", "path": str(tmp_path / "tiles")},
                 {"type": "file", "path": str(tmp_path / "net.json")}):
        cfg_path = tmp_path / ("%s.json" % spec["type"])
        cfg_path.write_text(json.dumps({"network": spec, "matcher": dict(
            KW, ubodt_delta=2000.0), "batch": {"max_inflight": 3}}))
        cfg, conf = parse_service_config(str(cfg_path))
        m = build_matcher(cfg, conf, device="cpu")
        assert m.arrays.num_edges == net.num_edges
        svc = ReporterService(m, robustness=conf.get("robustness"), **batch_options(conf))
        try:
            assert svc.batcher.max_inflight == 3
            answers.append(svc.handle_batch(json.loads(json.dumps(
                {"traces": world["traces"]}))))
        finally:
            svc.close()
    assert answers[0][0] == 200 and answers[0] == answers[1]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"network": {"type": "gph", "path": "x"}}))
    with pytest.raises(ValueError, match="grid, file or tiles"):
        parse_service_config(str(bad))
