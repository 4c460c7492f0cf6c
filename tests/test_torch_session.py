"""Streaming sessions on the port (``SessionEngine`` over
``match_sessions``: kernel 5 with the carry on the host or in the device
slab) against the JAX package's ``SessionEngine``: per-point records,
answers and carried beams equal bit for bit, point at a time, 4 points at
a time and a whole window at a time; the slab path equal to the host-carry
path; a freed and reused slot exact; and the streaming /report over HTTP
equal to the windowed wire and to the reference service's answers."""

import json
import threading
import urllib.request

import numpy as np
import pytest

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.matching.session import SessionEngine as RefEngine
from reporter_tpu.matching.session import SessionStore as RefStore
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch.matching import (
    MatcherConfig, SegmentMatcher, SessionEngine, SessionStore,
)
from reporter_tpu_torch.matching.arena import ArenaRef, carry_host
from reporter_tpu_torch.serve import ReporterService
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city
from reporter_tpu_torch.tiles.ubodt import build_ubodt

MO = {"mode": "auto", "report_levels": [0, 1], "transition_levels": [0, 1]}
KW = dict(length_buckets=[16], session_buckets=[4, 16])


@pytest.fixture(scope="module")
def setup():
    ra = ref_build_graph_arrays(ref_grid_city(8, 8, 150.0), cell_size=100.0)
    pa = build_graph_arrays(grid_city(8, 8, 150.0), cell_size=100.0)
    ref = RefMatcher(arrays=ra, ubodt=ref_build_ubodt(ra, delta=1500.0),
                     config=RefConfig(**KW), backend="jax")
    pu = build_ubodt(pa, delta=1500.0)
    ports = {arena: SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                                   config=MatcherConfig(session_arena=arena, **KW))
             for arena in (False, True)}
    traces = [s.trace for s in TraceSynthesizer(pa, seed=11).batch(3, 22, dt=5.0,
                                                                      sigma=3.0)]
    return ref, ports, traces


def _stream(eng, traces, step):
    """All traces in ``step``-point submits, one engine batch per step
    round (the vehicles share each step's dispatch)."""
    out = []
    n = max(len(t["trace"]) for t in traces)
    for j in range(0, n, step):
        subs = [{"uuid": t["uuid"], "trace": t["trace"][j:j + step], "match_options": MO}
                for t in traces if j < len(t["trace"])]
        out.extend(eng.match_many(subs))
    return out


def _carry_bytes(c):
    c = carry_host(c)
    return [np.asarray(c[k]).tobytes() for k in
            ("scores", "edge", "offset", "x", "y", "t", "active", "committed")]


def _same_sessions(store, ref_store, uuids):
    for u in uuids:
        s, r = store.peek(u), ref_store.peek(u)
        assert s.records == r.records, u
        assert _carry_bytes(s.carry) == _carry_bytes(r.carry), u
        assert (s.seq, s.points_total) == (r.seq, r.points_total), u


@pytest.mark.parametrize("step", [1, 4, 16])
def test_session_steps_equal_reference_engine(setup, step):
    ref, ports, traces = setup
    ref_eng = RefEngine(ref, RefStore(), tail_points=512)
    want = _stream(ref_eng, traces, step)
    uuids = [t["uuid"] for t in traces]
    for arena, m in ports.items():
        eng = SessionEngine(m, SessionStore(), tail_points=512)
        got = _stream(eng, traces, step)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["segments"] == w["segments"], arena
            assert g["_stream"]["trace"] == w["_stream"]["trace"]
            gs, ws = g["_stream"]["session"], w["_stream"]["session"]
            for k in ("uuid", "seq", "points_total", "tail_points", "points"):
                assert gs[k] == ws[k], k
        _same_sessions(eng.store, ref_eng.store, uuids)
        if arena:
            assert all(isinstance(eng.store.peek(u).carry, ArenaRef) for u in uuids)
            for u in uuids:
                m.session_arena.free_uuid(u)


def test_arena_equals_host_carry_and_reuses_freed_slots(setup):
    """Sessions through the slab and through host carries give the same
    records and beams; a dropped session's slot is reused by the next
    vehicle, whose decode stays exact (the slot's old beam is never read),
    and an LRU eviction frees its slot too."""
    ref, ports, traces = setup
    m = ports[True]
    arena = m.session_arena
    host = SessionEngine(ports[False], SessionStore(), tail_points=512)
    eng = SessionEngine(m, SessionStore(max_sessions=2), tail_points=512)
    ref_eng = RefEngine(ref, RefStore(), tail_points=512)
    a, b, c = traces
    for e in (host, eng, ref_eng):
        _stream(e, [a], 4)
    slot_a = arena._slot_of[a["uuid"]]
    _same_sessions(eng.store, host.store, [a["uuid"]])
    eng.store.drop(a["uuid"])
    assert a["uuid"] not in arena._slot_of
    for e in (host, eng, ref_eng):
        _stream(e, [b], 4)
    assert arena._slot_of[b["uuid"]] == slot_a  # the freed slot, reused
    _same_sessions(eng.store, ref_eng.store, [b["uuid"]])
    _same_sessions(eng.store, host.store, [b["uuid"]])
    used = arena.summary()["hot_used"]
    for e in (host, eng, ref_eng):
        _stream(e, [c, dict(a, uuid="again")], 1)  # evicts b (max 2 sessions)
    assert eng.store.peek(b["uuid"]) is None and b["uuid"] not in arena._slot_of
    assert arena.summary()["hot_used"] == used + 1
    _same_sessions(eng.store, ref_eng.store, [c["uuid"], "again"])
    for u in eng.store.uuids():
        eng.store.drop(u)
    assert arena.summary()["hot_used"] == 0


def test_over_bucket_step_chains_like_the_long_path(setup):
    """A 22-point submit (over the largest session bucket, 16) chains two
    [1, 16] steps: equal to the reference's chain, slab and host alike."""
    ref, ports, traces = setup
    ref_eng = RefEngine(ref, RefStore(), tail_points=512)
    want = _stream(ref_eng, traces[:1], 22)
    for arena, m in ports.items():
        eng = SessionEngine(m, SessionStore(), tail_points=512)
        got = _stream(eng, traces[:1], 22)
        assert got[0]["segments"] == want[0]["segments"]
        _same_sessions(eng.store, ref_eng.store, [traces[0]["uuid"]])
        eng.store.drop(traces[0]["uuid"])


def _post(port, body):
    req = urllib.request.Request("http://127.0.0.1:%d/report" % port,
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_streaming_report_over_http(setup):
    """A whole trace streamed in one submit answers the windowed wire; point
    at a time, every answer equals the reference service's streaming
    answer, with a growing session block; one point is valid only when
    streaming."""
    from reporter_tpu.serve.service import ReporterService as RefService

    ref, ports, traces = setup
    tr = traces[1]["trace"][:14]
    m = SegmentMatcher(arrays=ports[True].arrays, ubodt=ports[True].ubodt, device="cpu",
                       config=MatcherConfig(session_arena=True, session_tail_points=512,
                                            **KW))
    service = ReporterService(m, max_wait_ms=1.0, session_wait_ms=1.0)
    ref_svc = RefService(ref, max_wait_ms=1.0, session_wait_ms=1.0)
    server = service.make_server("127.0.0.1", 0)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        code, win = _post(port, {"uuid": "veh-w", "trace": tr, "match_options": MO})
        assert code == 200
        code, out = _post(port, {"uuid": "veh-s", "stream": True, "trace": tr,
                                 "match_options": MO})
        assert code == 200
        sess = out.pop("session")
        assert (sess["points"], sess["points_total"], sess["seq"], sess["tail_points"]) \
            == (14, 14, 1, 14)
        assert out == win
        for i, p in enumerate(tr):
            body = {"uuid": "veh-p", "stream": True, "trace": [p], "match_options": MO}
            code, out = _post(port, body)
            assert code == 200, out
            rcode, rout = ref_svc.handle_report(json.loads(json.dumps(body)))
            assert rcode == 200
            assert (out["session"]["seq"], out["session"]["points_total"]) == (i + 1, i + 1)
            out.pop("session")
            rout.pop("session")
            assert out == json.loads(json.dumps(rout)), i
        code, out = _post(port, {"uuid": "veh-bad", "trace": [tr[0]], "match_options": MO})
        assert code == 400
        code, health = 200, json.loads(urllib.request.urlopen(
            "http://127.0.0.1:%d/health" % port, timeout=30).read())
        assert health["sessions"]["sessions"] == 2
        assert health["session_arena"]["hot_used"] == 2
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        th.join(10)
    assert not th.is_alive()
