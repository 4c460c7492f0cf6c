"""The sparse-gap model through the port's whole paths on the CPU, against
the JAX package's ``SegmentMatcher(config=replace(cfg, sparse=True))`` on
the reference's sparse test world (``dryrun_scenario(rows=6, cols=6,
spacing_m=200)``, ``length_buckets=[16, 32]``): windowed and long
``match_many`` (``_canon`` equal), host-carry session steps and
``SessionEngine`` streams on the slab (records and beams bit for bit,
including the reference's rule that a carry held in the slab labels its
step dense), the flag gating ($REPORTER_SPARSE, ``cfg.sparse``), the
calibration file, and the serve defaults answering a sparse /report as
the reference's matcher and ``report()`` do."""

import dataclasses
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.matching import sparse as ref_sparse
from reporter_tpu.matching.session import SessionEngine as RefEngine
from reporter_tpu.matching.session import SessionStore as RefStore
from reporter_tpu.report import report as ref_report_fn
from reporter_tpu.synth import TraceSynthesizer
from reporter_tpu.synth.generator import dryrun_scenario
from reporter_tpu_torch.matching import (
    MatcherConfig, SegmentMatcher, SessionEngine, SessionStore,
)
from reporter_tpu_torch.matching.arena import ArenaRef, carry_host
from reporter_tpu_torch.serve import ReporterService
from reporter_tpu_torch.serve.__main__ import serving_defaults
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city
from reporter_tpu_torch.tiles.ubodt import build_ubodt
from test_fuzz_differential import _canon
from test_torch_slice import _check_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALIBRATION = os.path.join(REPO, "CALIBRATION.json")
MO = {"mode": "auto", "report_levels": [0, 1], "transition_levels": [0, 1]}
KW = dict(length_buckets=[16, 32])


@pytest.fixture(autouse=True)
def _clean_sparse_env(monkeypatch):
    """Both matchers read $REPORTER_SPARSE and $REPORTER_CALIBRATION when
    built; every test starts from the library defaults."""
    for var in ("REPORTER_SPARSE", "REPORTER_QUALITY_AUX", "REPORTER_CALIBRATION",
                "REPORTER_INTERPOLATE", "REPORTER_SESSION_ARENA"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def world():
    cfg, ra, ru = dryrun_scenario(rows=6, cols=6, spacing_m=200.0, delta=3000.0)
    pa = build_graph_arrays(grid_city(rows=6, cols=6, spacing_m=200.0), cell_size=100.0)
    return dataclasses.replace(cfg, **KW), ra, ru, pa, build_ubodt(pa, delta=3000.0)


def _ref(world, **kw):
    cfg, ra, ru, _pa, _pu = world
    return RefMatcher(arrays=ra, ubodt=ru, config=dataclasses.replace(cfg, **kw),
                      backend="jax")


def _port(world, **kw):
    _cfg, _ra, _ru, pa, pu = world
    return SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                          config=MatcherConfig(**dict(KW, **kw)))


def _traces(arrays, seed, spec):
    """Street-following traces, one per (points, gap seconds) of ``spec``."""
    synth = TraceSynthesizer(arrays, seed=seed)
    out = []
    for i, (n, dt) in enumerate(spec):
        tr = synth.synthesize(n, dt=dt, uuid="t%d-%g" % (i, dt), max_tries=400).trace
        tr["match_options"] = dict(MO)
        out.append(tr)
    return out


def _corpus(arrays, seed=5):
    """Dense (5 s) traces and sparse ones at 45, 60 and 90 s, in two length
    buckets, one of them in its own per-request parameter group."""
    traces = _traces(arrays, seed, [(12, 5.0), (20, 5.0), (12, 60.0), (20, 60.0),
                                    (10, 45.0), (14, 90.0), (12, 60.0)])
    traces[-1]["match_options"]["sigma_z"] = 6.0
    return traces


def _wire(results):
    return json.dumps(results, sort_keys=True)


@pytest.mark.parametrize("calibrated", [False, True])
def test_match_many_sparse_equals_reference(world, calibrated, monkeypatch):
    if calibrated:
        monkeypatch.setenv("REPORTER_CALIBRATION", CALIBRATION)
    ref, port = _ref(world, sparse=True), _port(world, sparse=True)
    assert port.sparse.summary()["calibrated"] is calibrated
    assert port.sparse.cohort_values("ge60") == ref.sparse.cohort_values("ge60")
    traces = _corpus(world[1])
    before = ref_sparse.C_SPARSE_DISPATCH.labels("ge60").value
    want = ref.match_many(traces)
    got = port.match_many(traces)
    assert [_canon(r) for r in got] == [_canon(r) for r in want]
    assert port.sparse.dispatch == {"45-60": 1, "ge60": 4}
    assert ref_sparse.C_SPARSE_DISPATCH.labels("ge60").value - before == 4


def test_long_sparse_trace_equals_reference(world):
    """A 40-point trace at 60 s takes the long path (two windows of 32) at
    the cohort's K = 16; a dense 40-point trace beside it keeps K = 8."""
    ref, port = _ref(world, sparse=True), _port(world, sparse=True)
    traces = _traces(world[1], 7, [(40, 60.0), (40, 5.0), (12, 60.0)])
    want = ref.match_many(traces)
    got = port.match_many(traces)
    assert [_canon(r) for r in got] == [_canon(r) for r in want]
    assert port.sparse.dispatch == {"ge60": 2}
    # the long group's cap shrank by (16/8)^2
    assert port._sparse_row_factor("ge60") == 4


def _step_all(matcher, pts):
    """A point-at-a-time host-carry stream of one session."""
    carry, outs = None, []
    for p in pts:
        (res, _aux, carry) = matcher.match_sessions(
            [{"points": [p], "carry": carry, "t0": float(pts[0]["time"]), "pkey": ()}])[0]
        outs.append([a.tolist() for a in res])
    return outs, carry


def test_session_host_carry_sparse_equals_reference(world):
    """Every step of a 60 s stream labels sparse through its seam gap (a
    one-point delta after the carried point) and equals the reference's;
    a dense stream through the same matcher equals the dense port's."""
    kw = dict(sparse=True, sparse_vmax_mps=12.0)
    ref, port = _ref(world, **kw), _port(world, **kw)
    sp_pts, de_pts = (t["trace"] for t in _traces(world[1], 10, [(8, 60.0), (8, 5.0)]))
    want, wcarry = _step_all(ref, sp_pts)
    got, gcarry = _step_all(port, sp_pts)
    assert got == want
    for k in ("scores", "edge", "offset", "x", "y", "t", "active", "committed"):
        assert np.asarray(gcarry[k]).tobytes() == np.asarray(wcarry[k]).tobytes(), k
    assert port.sparse.dispatch == {"ge60": 7}  # the first point has no gap
    assert _step_all(port, de_pts)[0] == _step_all(_port(world), de_pts)[0]
    assert port.sparse.dispatch == {"ge60": 7}


def _stream(eng, traces, step):
    out = []
    n = max(len(t["trace"]) for t in traces)
    for j in range(0, n, step):
        out.extend(eng.match_many([{"uuid": t["uuid"], "trace": t["trace"][j:j + step],
                                    "match_options": MO} for t in traces
                                   if j < len(t["trace"])]))
    return out


def _carry_bytes(c):
    c = carry_host(c)
    return [np.asarray(c[k]).tobytes() for k in
            ("scores", "edge", "offset", "x", "y", "t", "active", "committed")]


@pytest.mark.parametrize("arena", [True, False])
def test_session_engine_sparse_equals_reference(world, arena):
    """Three vehicles at 60 and 45 s streamed 4 points at a time through
    ``SessionEngine``: records and beams equal the reference engine's.  On
    the slab only each session's first step is sparse (its later carries
    are ``ArenaRef``s, which label dense, as in the reference); with host
    carries every step is."""
    kw = dict(sparse=True, session_arena=arena)
    ref, port = _ref(world, **kw), _port(world, **kw)
    traces = _traces(world[1], 12, [(12, 60.0), (9, 60.0), (12, 45.0)])
    ref_eng = RefEngine(ref, RefStore(), tail_points=512)
    eng = SessionEngine(port, SessionStore(), tail_points=512)
    want, got = _stream(ref_eng, traces, 4), _stream(eng, traces, 4)
    assert [g["segments"] for g in got] == [w["segments"] for w in want]
    for t in traces:
        s, r = eng.store.peek(t["uuid"]), ref_eng.store.peek(t["uuid"])
        assert s.records == r.records
        assert _carry_bytes(s.carry) == _carry_bytes(r.carry)
        assert isinstance(s.carry, ArenaRef) == arena
    if arena:
        assert port.sparse.dispatch == {"ge60": 2, "45-60": 1}
        for t in traces:
            eng.store.drop(t["uuid"])
    else:
        assert port.sparse.dispatch == {"ge60": 6, "45-60": 3}


@pytest.mark.parametrize("how", ["config", "env"])
def test_sparse_off_equals_dense_port(world, how, monkeypatch):
    """With the model off (the config default, or $REPORTER_SPARSE=0 over
    a sparse config) every output equals the dense port's bytes."""
    dense = _port(world, session_arena=True)
    if how == "env":
        monkeypatch.setenv("REPORTER_SPARSE", "0")
        off = _port(world, sparse=True, sparse_beam_k=16, session_arena=True)
    else:
        off = _port(world, session_arena=True)
    assert not off.sparse.enabled
    traces = _corpus(world[1]) + _traces(world[1], 7, [(40, 60.0)])
    assert _wire(off.match_many(traces)) == _wire(dense.match_many(traces))
    sp_pts = traces[2]["trace"]
    (a, ca), (b, cb) = _step_all(off, sp_pts), _step_all(dense, sp_pts)
    assert a == b and _carry_bytes(ca) == _carry_bytes(cb)
    engs = [SessionEngine(m, SessionStore(), tail_points=512) for m in (off, dense)]
    a, b = (_stream(e, traces[2:5], 4) for e in engs)
    for r in a + b:  # the session's age is wall-clock time
        r["_stream"]["session"].pop("age_s")
    assert _wire(a) == _wire(b)
    assert off.sparse.dispatch == {}


def test_sparse_on_leaves_dense_traffic_unchanged(world):
    dense_m, on = _port(world), _port(world, sparse=True, sparse_vmax_mps=12.0)
    traces = _corpus(world[1])
    base, res = dense_m.match_many(traces), on.match_many(traces)
    assert _wire(res[:2]) == _wire(base[:2])  # the dense traces
    assert _wire(res[2:]) != _wire(base[2:])  # the model engaged


def test_calibration_loads_and_corrupt_degrades(world, tmp_path, monkeypatch):
    monkeypatch.setenv("REPORTER_CALIBRATION", CALIBRATION)
    m = _port(world, sparse=True)
    assert m.sparse.summary()["calibrated"] and m.sparse.calibration["path"] == CALIBRATION
    p, sp, k = m.sparse.params_for("ge60")
    assert (k, float(sp.vmax), float(sp.plaus_weight)) == (8, 12.0, 6.0)
    _p, sp2, _k = m.sparse.params_for("30-45")  # uncovered: 45-60 stands in
    assert float(sp2.vmax) == 16.0
    p3, _sp, _k = m.sparse.params_for("ge60", (9.0, 4.0, 30.0))  # the request wins
    assert (float(p3.sigma_z), float(p3.beta), float(p3.search_radius)) == (9.0, 4.0, 30.0)
    assert m.sparse.cohort_values("ge60", (9.0, 4.0, 300.0))["search_radius"] == 50.0
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    monkeypatch.setenv("REPORTER_CALIBRATION", str(bad))
    m = _port(world, sparse=True)
    assert m.sparse.enabled and m.sparse.calibration is None
    _p, sp, k = m.sparse.params_for("ge60")
    assert (k, float(sp.vmax)) == (16, 45.0)  # the config family
    monkeypatch.setenv("REPORTER_SPARSE", "0")
    assert _port(world, sparse=True).sparse.summary()["calibrated"] is False


def test_serve_defaults_answer_a_sparse_report(world):
    """The serve entry point's defaults turn the model on: a 60 s /report
    over HTTP answers as the reference's sparse matcher and report() do,
    and the dispatch count moves."""
    _cfg, _ra, _ru, pa, pu = world
    cfg = serving_defaults(MatcherConfig(**KW))
    assert cfg.sparse and cfg.session_arena and cfg.quality_aux
    m = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu", config=cfg)
    assert m.sparse.enabled
    req = _traces(world[1], 21, [(14, 60.0)])[0]
    ref = _ref(world, sparse=True)
    want = ref_report_fn(ref.match(json.loads(json.dumps(req))), req, 15,
                         set(MO["report_levels"]), set(MO["transition_levels"]),
                         mode=MO["mode"])
    service = ReporterService(m, threshold_sec=15, max_batch=8, max_wait_ms=5)
    server = service.make_server("127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        r = urllib.request.Request("http://127.0.0.1:%d/report" % server.server_address[1],
                                   data=json.dumps(req).encode())
        with urllib.request.urlopen(r, timeout=60) as resp:
            code, out = resp.status, json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        th.join(10)
    assert code == 200
    _check_report(out, json.loads(json.dumps(want)), req["uuid"])
    assert m.sparse.dispatch == {"ge60": 1}
