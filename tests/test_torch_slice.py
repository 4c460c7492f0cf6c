"""The port's serving slice as a whole, on the CPU: ``match_many`` against
the JAX matcher on fuzz and synthetic corpora, the recorded /report
fixtures replayed through the port's ``match`` + ``report()``, and the
port's HTTP server answering /report."""

import json
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu.report import report as ref_report_fn
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.report import report as report_fn
from reporter_tpu_torch.serve import ReporterService
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city
from reporter_tpu_torch.tiles.ubodt import build_ubodt
from test_fuzz_differential import _canon, random_traces
from test_parity_fixtures import FIXTURE_PATH, _diff_segment
from test_torch_builders import scenario


@pytest.fixture(scope="module")
def recorded():
    with open(FIXTURE_PATH) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def fixture_matcher(recorded):
    net = recorded["network"]
    arrays = build_graph_arrays(grid_city(rows=net["rows"], cols=net["cols"],
                                          spacing_m=net["spacing_m"]), cell_size=100.0)
    return SegmentMatcher(arrays=arrays, ubodt=build_ubodt(arrays, delta=3000.0),
                          config=MatcherConfig(), device="cpu")


@pytest.mark.parametrize("seed", [7, 19, 43])
def test_match_many_equals_jax_on_fuzz_corpus(seed):
    net, ra, ru, pa, pu = scenario(seed)
    traces = random_traces(np.random.default_rng(seed + 1), net, ra, 12)
    ref = RefMatcher(arrays=ra, ubodt=ru, config=RefConfig(), backend="jax")
    port = SegmentMatcher(arrays=pa, ubodt=pu, config=MatcherConfig(), device="cpu")
    want = [_canon(r) for r in ref.match_many(traces)]
    got = [_canon(r) for r in port.match_many(traces)]
    assert got == want


def test_match_many_equals_jax_on_synthetic_grid_corpus():
    """Several length buckets in one call, a per-request parameter group,
    an empty trace, and the confidence diagnostics on both sides."""
    ra = ref_build_graph_arrays(ref_grid_city(8, 8, 200.0), cell_size=100.0)
    ru = ref_build_ubodt(ra, delta=3000.0)
    pa = build_graph_arrays(grid_city(8, 8, 200.0), cell_size=100.0)
    pu = build_ubodt(pa, delta=3000.0)
    syn = TraceSynthesizer(pa, seed=5)
    traces = [syn.synthesize(n, dt=5.0, sigma=6.0, uuid="s%d" % i, max_tries=200).trace
              for i, n in enumerate([12, 30, 30, 70, 150, 250, 3])]
    traces[2]["match_options"]["sigma_z"] = 9.0
    traces[3]["match_options"]["search_radius"] = 35.0
    traces.append({"uuid": "empty", "trace": [], "match_options": traces[0]["match_options"]})
    ref = RefMatcher(arrays=ra, ubodt=ru, config=RefConfig(quality_aux=True), backend="jax")
    port = SegmentMatcher(arrays=pa, ubodt=pu, config=MatcherConfig(quality_aux=True),
                          device="cpu")
    want = ref.match_many(traces)
    got = port.match_many(traces)
    qw = [r.pop("_quality", None) for r in want]
    qg = [r.pop("_quality", None) for r in got]
    assert [_canon(r) for r in got] == [_canon(r) for r in want]
    for a, b in zip(qg, qw):
        if b is None:
            assert a is None
            continue
        assert {k: a[k] for k in ("edge", "n_points", "breaks")} == \
            {k: b[k] for k in ("edge", "n_points", "breaks")}
        for k in ("margin_min", "margin_mean", "pool_exhausted_frac"):
            assert (a[k] is None) == (b[k] is None), k
            if b[k] is not None:
                assert a[k] == pytest.approx(b[k], rel=1e-4, abs=1e-3), k


def _check_report(got, want, uid):
    assert got.get("shape_used") == want.get("shape_used"), uid
    g_reports = got["datastore"]["reports"]
    w_reports = want["datastore"]["reports"]
    assert len(g_reports) == len(w_reports), uid
    for i, (g, w) in enumerate(zip(g_reports, w_reports)):
        _diff_segment(g, w, "%s.reports[%d]" % (uid, i))
    g_segs = got["segment_matcher"]["segments"]
    w_segs = want["segment_matcher"]["segments"]
    assert len(g_segs) == len(w_segs), uid
    for i, (g, w) in enumerate(zip(g_segs, w_segs)):
        _diff_segment(g, w, "%s.segments[%d]" % (uid, i))
    assert got["stats"] == want["stats"], uid
    assert set(got) == set(want), uid


def test_fixture_replay_matches_recorded(recorded, fixture_matcher):
    thr = recorded["threshold_sec"]
    for fx in recorded["fixtures"]:
        req = fx["request"]
        got = report_fn(fixture_matcher.match(req), req, thr,
                        set(req["match_options"]["report_levels"]),
                        set(req["match_options"]["transition_levels"]),
                        mode=req["match_options"]["mode"])
        _check_report(got, fx["response"], req["uuid"])


def _http(port, path, body=None):
    req = urllib.request.Request("http://127.0.0.1:%d%s" % (port, path),
                                 data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _long_request(arrays):
    tr = TraceSynthesizer(arrays, seed=3).synthesize(300, dt=5.0, sigma=5.0,
                                                     uuid="long", max_tries=400).trace
    tr["match_options"] = {"mode": "auto", "report_levels": [0, 1],
                           "transition_levels": [0, 1]}
    return tr


def _ref_report(recorded, req):
    net = recorded["network"]
    ra = ref_build_graph_arrays(ref_grid_city(net["rows"], net["cols"], net["spacing_m"]),
                                cell_size=100.0)
    ref = RefMatcher(arrays=ra, ubodt=ref_build_ubodt(ra, delta=3000.0), config=RefConfig(),
                     backend="jax")
    mo = req["match_options"]
    return ref_report_fn(ref.match(req), req, recorded["threshold_sec"],
                         set(mo["report_levels"]), set(mo["transition_levels"]),
                         mode=mo["mode"])


def test_http_server_answers_report(recorded, fixture_matcher):
    service = ReporterService(fixture_matcher, threshold_sec=recorded["threshold_sec"],
                              max_batch=8, max_wait_ms=5)
    server = service.make_server("127.0.0.1", 0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        first, second = _http(port, "/health"), _http(port, "/health")
        # uptime_s is a wall clock rounded to 0.1 s: two reads may straddle a step
        assert abs(first[1].pop("uptime_s") - second[1].pop("uptime_s")) <= 0.5
        assert first == (200, second[1])
        assert _http(port, "/health")[1]["status"] == "ok"
        fx0, fx1 = recorded["fixtures"][:2]
        code, out = _http(port, "/report?json=" + urllib.parse.quote(json.dumps(fx0["request"])))
        assert code == 200
        _check_report(out, fx0["response"], fx0["request"]["uuid"])
        code, out = _http(port, "/report", fx1["request"])
        assert code == 200
        _check_report(out, fx1["response"], fx1["request"]["uuid"])
        code, out = _http(port, "/report", {"trace": []})
        assert (code, out["error"]) == (400, "uuid is required")
        # a street-following trace longer than the largest bucket (256):
        # matched in windows with carried state, as the reference does
        long_req = _long_request(fixture_matcher.arrays)
        code, out = _http(port, "/report", long_req)
        assert code == 200
        _check_report(out, _ref_report(recorded, long_req), "long")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        t.join(10)
    assert not t.is_alive()
