"""The port's session wire, rebuild, degraded step and checkpointer against
the JAX package's, on the CPU (8 x 8 grid, length bucket 16, session
buckets 4 and 16):

  rebuild     a beam-less session (a replay-only wire) rebuilds from its
              replay inside its next step, equal to the reference's
              rebuild and to the windowed decode of its history, within
              one session bucket and past it (chained);
  wire        a session exported by either package imports into the other
              and continues bit for bit (records, beam bytes, ledger), on
              host carries and on the slab; the wires are equal JSON;
  merge       an import into a live session merges as the reference's
              does (ledger, replay dedup by raw point, rebuild);
  endpoint    /sessions: summary, one session, export, import, drop, pop;
  slab        pop_wire mid-stream, a handoff racing a re-dispatched point,
              the checkpoint restore seam, each equal to host carries;
  checkpoint  sweep and prune, sync mode, prompt removal on pop and drop,
              clear at start and unreadable files, the merge dedup, and a
              service whose streaming commits land in its directory;
  engine      the late-commit guard and the degraded step against the
              reference's."""

import json
import os

import numpy as np
import pytest

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.matching.session import SessionCheckpointer as RefCheckpointer
from reporter_tpu.matching.session import SessionEngine as RefEngine
from reporter_tpu.matching.session import SessionState as RefState
from reporter_tpu.matching.session import SessionStore as RefStore
from reporter_tpu.matching.session import read_checkpoints as ref_read_checkpoints
from reporter_tpu.serve.service import ReporterService as RefService
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.matching.arena import ArenaRef
from reporter_tpu_torch.matching.session import (
    SessionCheckpointer, SessionEngine, SessionState, SessionStore, read_checkpoints,
)
from reporter_tpu_torch.serve.service import ReporterService
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
    return pa, ports, ref


def _traces(arrays, b, t, seed):
    return [s.trace for s in TraceSynthesizer(arrays, seed=seed).batch(b, t, dt=5.0, sigma=3.0)]


def _engine(m, ref=False, tail=512):
    store = (RefStore if ref else SessionStore)()
    return (RefEngine if ref else SessionEngine)(m, store, tail_points=tail), store


def _stream(eng, pts, uuid, step=1):
    out = []
    for j in range(0, len(pts), step):
        out.extend(eng.match_many([{"uuid": uuid, "trace": pts[j:j + step],
                                    "match_options": MO}]))
    return out


def _fresh(m):
    """A new matcher of the same arrays, table and config (a second
    replica), its own slab."""
    return SegmentMatcher(arrays=m.arrays, ubodt=m.ubodt, device="cpu", config=m.cfg)


def _carry_wire(store, uuid):
    return json.loads(json.dumps(store.peek(uuid).to_wire()))["carry"]


def _same(store, ref_store, uuid):
    s, r = store.peek(uuid), ref_store.peek(uuid)
    assert s.records == r.records, uuid
    assert _carry_wire(store, uuid) == _carry_wire(ref_store, uuid), uuid
    assert (s.seq, s.points_total, s.replay) == (r.seq, r.points_total, r.replay), uuid


def _windowed_records(m, pts):
    """The windowed path's per-point records of one trace on the port."""
    tr = {"uuid": "w", "trace": pts}
    n = len(pts)
    if n > m.max_trace_points:
        _g, (edge, offset, breaks), _t, _a = m._fetch_long_aux(m._dispatch_long([tr], [0])[0])
    else:
        px, py, tm, valid, _ = m._fill_rows([tr], [0], m._bucket_len(n))
        (edge, offset, breaks), _a = m._collect_batch(m._dispatch_batch(px, py, tm, valid))
    return [(int(edge[0, j]), float(np.float32(offset[0, j])), bool(breaks[0, j]),
             float(pts[j]["time"])) for j in range(n)]


def _extra(pts):
    p = pts[-1]
    return {"lat": p["lat"], "lon": p["lon"], "time": p["time"] + 5.0}


@pytest.mark.parametrize("n", [12, 40], ids=["one-bucket", "chained"])
@pytest.mark.parametrize("arena", [False, True], ids=["host", "slab"])
def test_rebuild_from_replay_equals_reference_and_windowed(setup, n, arena):
    pa, ports, ref = setup
    m = ports[arena]
    pts = _traces(pa, 1, n, seed=33 if n == 12 else 27)[0]["trace"]
    stores = {}
    for who, mm in (("port", m), ("ref", ref)):
        eng, store = _engine(mm, ref=who == "ref")
        _stream(eng, pts, "veh-r")
        wire = json.loads(json.dumps(store.peek("veh-r").to_wire()))
        wire["carry"] = None  # the replay-only handoff
        store.drop("veh-r")
        eng2, store2 = _engine(mm, ref=who == "ref")
        res = store2.import_wire([wire])
        assert res == {"imported": 1, "merged": 0, "skipped": 0, "rebuild_pending": 1,
                       "imported_uuids": ["veh-r"]}
        (out,) = _stream(eng2, [_extra(pts)], "veh-r")
        meta = out["_stream"]["session"]
        assert meta["rebuilt"] is True and meta["points_total"] == n + 1 and meta["imported"]
        assert store2.peek("veh-r").rebuild_pending is False
        stores[who] = store2
        if who == "port":
            got = out
            if arena:
                assert isinstance(store2.peek("veh-r").carry, ArenaRef)
        else:
            want = out
    _same(stores["port"], stores["ref"], "veh-r")
    assert got["segments"] == want["segments"]
    assert stores["port"].peek("veh-r").records == _windowed_records(m, pts + [_extra(pts)])
    stores["port"].drop("veh-r")  # the shared slab's slot


@pytest.mark.parametrize("arena", [False, True], ids=["host", "slab"])
@pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
def test_wire_round_trip_across_packages(setup, arena, direction):
    """Streamed on one package to ``cut``, exported, JSON round-tripped,
    imported into the other and streamed on: records, beam and ledger
    equal the uninterrupted session bit for bit; both packages' wires of
    the same session are the same JSON."""
    pa, ports, ref = setup
    m = ports[arena]
    pts = _traces(pa, 1, 20, seed=5)[0]["trace"]
    cut = 11
    full_eng, full = _engine(ref, ref=True)
    _stream(full_eng, pts, "veh-h")
    heads = {}
    for who, mm in (("port", m), ("ref", ref)):
        eng, store = _engine(mm, ref=who == "ref")
        _stream(eng, pts[:cut], "veh-h")
        heads[who] = json.loads(json.dumps(store.export_all()))
        if who == "port" and arena:
            assert m.session_arena.readbacks > 0  # the export read the slot
            store.drop("veh-h")
    assert heads["port"] == heads["ref"] and heads["port"][0]["carry"] is not None
    src = "port" if direction == "port-to-ref" else "ref"
    wires = heads[src]
    dst_m = ref if direction == "port-to-ref" else _fresh(m)
    eng2, store2 = _engine(dst_m, ref=direction == "port-to-ref")
    assert store2.import_wire(wires)["imported"] == 1
    _stream(eng2, pts[cut:], "veh-h")
    s2, r = store2.peek("veh-h"), full.peek("veh-h")
    assert s2.records == r.records and s2.points_total == len(pts) == r.points_total
    assert _carry_wire(store2, "veh-h") == _carry_wire(full, "veh-h")


def test_import_merges_into_live_session(setup):
    pa, ports, ref = setup
    pts = _traces(pa, 1, 12, seed=6)[0]["trace"]
    cut = 8
    out = {}
    for who, mm in (("port", ports[False]), ("ref", ref)):
        eng1, store1 = _engine(mm, ref=who == "ref")
        _stream(eng1, pts[:cut], "veh-l")
        wire = store1.export_all()[0]
        eng, store = _engine(mm, ref=who == "ref")
        _stream(eng, pts[cut:cut + 2], "veh-l")  # the race loser
        live = store.peek("veh-l")
        res = store.import_wire([wire])
        assert store.peek("veh-l") is live
        rows = [res, live.points_total, live.rebuild_pending, list(live.replay)]
        (ans,) = _stream(eng, [pts[cut + 2]], "veh-l")
        rows += [ans["segments"], list(live.records), live.points_total]
        st = (RefState if who == "ref" else SessionState)("veh-l", 0.0)
        rows.append(store.import_wire([st.to_wire()]))  # no replay: ledger only
        rows.append(store.peek("veh-l").rebuild_pending)
        out[who] = rows
    assert out["port"] == out["ref"]
    assert out["port"][0]["merged"] == 1 and out["port"][1] == cut + 2
    assert out["port"][2] is True and out["port"][6] == cut + 3
    assert out["port"][5] == _windowed_records(ports[False], pts[:cut + 3])


def _no_age(d):
    return {k: v for k, v in d.items() if k not in ("age_s", "replica")}


def test_sessions_endpoint(setup):
    """GET summary / ?uuid= / ?export=1 and POST import / drop / pop, on
    the port's service against the reference's."""
    pa, ports, ref = setup
    pts = _traces(pa, 1, 6, seed=19)[0]["trace"]
    svcs = {"port": ReporterService(ports[True], max_wait_ms=1.0, session_wait_ms=1.0),
            "ref": RefService(ref, max_wait_ms=1.0, session_wait_ms=1.0)}
    seconds = {"port": ReporterService(_fresh(ports[True]), max_wait_ms=1.0),
               "ref": RefService(ref, max_wait_ms=1.0)}
    try:
        out = {}
        for who, svc in svcs.items():
            rows = []
            for p in pts:
                code, _b = svc.handle_report({"uuid": "veh-e", "stream": True, "trace": [p],
                                              "match_options": MO})
                assert code == 200
            rows.append(_no_age(svc.handle_sessions({})[1]))
            code, ex = svc.handle_sessions({"export": ["1"]})
            rows.append((code, _no_age(ex)))
            code, one = svc.handle_sessions({"uuid": ["veh-e"]})
            rows.append((code, _no_age(one)))
            rows.append(svc.handle_sessions({"uuid": ["ghost"]}))
            sec = seconds[who]
            code, res = sec.handle_sessions({}, json.loads(json.dumps(
                {"sessions": ex["sessions"]})))
            rows.append((code, _no_age(res)))
            rows.append(sec.handle_sessions({}, {"sessions": "nope"}))
            rows.append(sec.handle_sessions({}, {"drop": "nope"}))
            rows.append(sec.handle_sessions({}, {"pop": "nope"}))
            code, popped = sec.handle_sessions({}, {"pop": ["veh-e", "ghost"]})
            rows.append((code, popped["sessions"]))
            rows.append(_no_age(sec.handle_sessions({}, {"drop": ["veh-e"]})[1]))
            rows.append(_no_age(svc.handle_sessions({}, {"drop": ["veh-e", "ghost"]})[1]))
            rows.append(_no_age(svc.handle_sessions({})[1]))
            out[who] = rows
        assert out["port"] == out["ref"]
        got = out["port"]
        assert got[0]["sessions"] == 1 and got[0]["points_total"] == len(pts)
        assert got[3] == (404, {"error": "no session for uuid 'ghost'"})
        assert got[4] == (200, {"imported": 1, "merged": 0, "skipped": 0,
                                "rebuild_pending": 0, "imported_uuids": ["veh-e"]})
        assert got[5][0] == got[6][0] == got[7][0] == 400
        assert len(got[8][1]) == 1 and got[8][1][0]["points_total"] == len(pts)
        assert got[9] == {"dropped": 0} and got[10] == {"dropped": 1}
    finally:
        svcs["port"].close()
        seconds["port"].close()


# -- the slab's seams --------------------------------------------------------------


def _stream_with_pop(m, trs, pop_at, popped_uuids, ref=False):
    eng, store = _engine(m, ref=ref)
    popped = None
    for j in range(0, 12, 2):
        eng.match_many([{"uuid": t["uuid"], "trace": t["trace"][j:j + 2], "match_options": MO}
                        for t in trs])
        if j == pop_at:
            popped = store.pop_wire(popped_uuids)
    return popped, store


def test_pop_wire_midstream_bitexact(setup):
    pa, ports, ref = setup
    trs = _traces(pa, 4, 12, seed=11)
    drained = [t["uuid"] for t in trs[:2]]
    stayers = [t["uuid"] for t in trs[2:]]
    m = _fresh(ports[True])
    p_ref, s_ref = _stream_with_pop(ref, trs, 6, drained, ref=True)
    p_host, s_host = _stream_with_pop(ports[False], trs, 6, drained)
    p_arena, s_arena = _stream_with_pop(m, trs, 6, drained)
    assert json.loads(json.dumps(p_arena)) == json.loads(json.dumps(p_host)) == \
        json.loads(json.dumps(p_ref))
    assert m.session_arena.readbacks >= len(drained)
    for u in stayers:
        _same(s_arena, s_ref, u)
        _same(s_host, s_ref, u)
    # the popped vehicles came back as fresh sessions holding only the
    # points after the pop (finalize does not resurrect them)
    assert [s_arena.peek(u).points_total for u in drained] == \
        [s_ref.peek(u).points_total for u in drained] == [4, 4]


def test_handoff_racing_redispatched_point(setup):
    pa, ports, ref = setup
    tr = _traces(pa, 1, 12, seed=6)[0]
    pts, cut = tr["trace"], 8

    def race(m1, m2, is_ref):
        eng1, store1 = _engine(m1, ref=is_ref)
        _stream(eng1, pts[:cut], tr["uuid"])
        wire = json.loads(json.dumps(store1.pop_wire([tr["uuid"]])))
        eng2, store2 = _engine(m2, ref=is_ref)
        _stream(eng2, pts[cut:cut + 2], tr["uuid"], step=2)
        assert store2.import_wire(wire)["merged"] == 1
        _stream(eng2, pts[cut + 2:], tr["uuid"])
        return store2

    s_ref = race(ref, ref, True)
    s_arena = race(_fresh(ports[True]), _fresh(ports[True]), False)
    _same(s_arena, s_ref, tr["uuid"])
    assert s_arena.peek(tr["uuid"]).points_total == 12


def test_checkpoint_restore_seam(setup, tmp_path):
    pa, ports, ref = setup
    tr = _traces(pa, 1, 12, seed=9)[0]
    full_eng, full = _engine(ref, ref=True)
    _stream(full_eng, tr["trace"], tr["uuid"])
    m = _fresh(ports[True])
    eng, store = _engine(m)
    cp = SessionCheckpointer(store, str(tmp_path / "ckpt"), cadence_s=3600.0)
    _stream(eng, tr["trace"][:8], tr["uuid"])
    assert m.session_arena.readbacks == 0  # streaming alone reads nothing back
    assert cp.sweep()["written"] == 1
    assert m.session_arena.readbacks == 1  # the checkpoint's slot read
    wires = read_checkpoints(cp.dir)
    m2 = _fresh(ports[True])
    eng2, store2 = _engine(m2)
    assert store2.import_wire(wires)["imported"] == 1
    _stream(eng2, tr["trace"][8:], tr["uuid"])
    _same(store2, full, tr["uuid"])


# -- the checkpointer ----------------------------------------------------------------


def _open_session(store, uuid, points):
    s = store.get_or_open(uuid, t0=1000.0)
    s.replay = [{"lat": 37.75, "lon": -122.45, "time": 1000 + i} for i in range(points)]
    s.points_total = points
    s.seq = 1
    return s


def _files(d):
    return sorted(f for f in os.listdir(d))


def test_checkpoint_sweep_writes_dirty_and_prunes_dead(tmp_path):
    out = {}
    for who, Store, Cp, read in (("port", SessionStore, SessionCheckpointer, read_checkpoints),
                                 ("ref", RefStore, RefCheckpointer, ref_read_checkpoints)):
        store = Store()
        cp = Cp(store, str(tmp_path / who), cadence_s=3600.0, sync=False)
        cp.start()
        _open_session(store, "veh-a", 3)
        _open_session(store, "veh/b:weird uuid", 2)
        store.notify_commit("veh-a")
        store.notify_commit("veh/b:weird uuid")
        rows = [cp.sweep(), _files(cp.dir), read(cp.dir), cp.sweep()]
        with store._lock:
            del store._by_uuid["veh-a"]
        rows += [cp.sweep(), [w["uuid"] for w in read(cp.dir)]]
        rows.append({k: v for k, v in cp.summary().items() if k != "dir"})
        with open(os.path.join(cp.dir, os.listdir(cp.dir)[0])) as f:
            rows.append(f.read())
        out[who] = rows
    assert out["port"] == out["ref"]
    got = out["port"]
    assert got[0]["written"] == 2 and got[3]["written"] == 0 and got[4]["pruned"] == 1
    assert got[1] == ["veh%2Fb%3Aweird%20uuid.json", "veh-a.json"]
    assert got[5] == ["veh/b:weird uuid"]


def test_checkpoint_sync_and_prompt_removal(tmp_path):
    out = {}
    for who, Store, Cp, read in (("port", SessionStore, SessionCheckpointer, read_checkpoints),
                                 ("ref", RefStore, RefCheckpointer, ref_read_checkpoints)):
        store = Store()
        cp = Cp(store, str(tmp_path / who), cadence_s=3600.0, sync=True)
        cp.start()
        _open_session(store, "veh-pop", 2)
        _open_session(store, "veh-drop", 4)
        store.notify_commit("veh-pop")
        store.notify_commit("veh-drop")
        rows = [[(w["uuid"], w["points_total"]) for w in read(cp.dir)]]
        rows.append(json.loads(json.dumps(store.pop_wire(["veh-pop"]))))
        rows.append([w["uuid"] for w in read(cp.dir)])
        store.drop("veh-drop")
        rows.append(read(cp.dir))
        out[who] = rows
    assert out["port"] == out["ref"]
    assert out["port"][0] == [("veh-drop", 4), ("veh-pop", 2)]
    assert out["port"][2] == ["veh-drop"] and out["port"][3] == []


def test_checkpoint_clear_on_start_and_unreadable_skipped(tmp_path):
    out = {}
    for who, Store, Cp, read, State in (
            ("port", SessionStore, SessionCheckpointer, read_checkpoints, SessionState),
            ("ref", RefStore, RefCheckpointer, ref_read_checkpoints, RefState)):
        d = tmp_path / who
        d.mkdir()
        (d / "stale.json").write_text(json.dumps(State("veh-stale", 0.0).to_wire()))
        (d / "garbage.json").write_text("{not json")
        (d / "ignored.txt").write_text("not a checkpoint")
        rows = [[w["uuid"] for w in read(str(d))]]
        Cp(Store(), str(d), cadence_s=3600.0).start()
        rows += [read(str(d)), _files(str(d))]
        out[who] = rows
    assert out["port"] == out["ref"] == [["veh-stale"], [], ["ignored.txt"]]


def test_import_merge_dedups_shared_replay_points():
    out = {}
    for who, Store, State in (("port", SessionStore, SessionState), ("ref", RefStore, RefState)):
        store = Store()
        live = _open_session(store, "veh-m", 2)
        live.replay = [{"lat": 1.0, "lon": 2.0, "time": 1003},
                       {"lat": 1.0, "lon": 2.0, "time": 1004}]
        s = State("veh-m", 1000.0)
        s.points_total = 3
        s.replay = [{"lat": 1.0, "lon": 2.0, "time": t} for t in (1001, 1002, 1003)]
        res = store.import_wire([s.to_wire()])
        out[who] = [res, live.points_total, [p["time"] for p in live.replay],
                    live.rebuild_pending, live.seq, store.resident_bytes()]
    assert out["port"] == out["ref"]
    assert out["port"][1] == 4 and out["port"][2] == [1001, 1002, 1003, 1004]


def test_service_checkpoints_streaming_commits(setup, tmp_path, monkeypatch):
    """A service with a checkpoint cadence and directory writes each
    streaming commit of sync mode under <dir>/<replica id>; the files
    read back to the store's wires and restore into the reference."""
    pa, ports, ref = setup
    monkeypatch.setenv("REPORTER_REPLICA_ID", "rep-ck")
    svc = ReporterService(ports[False], session_wait_ms=1.0, robustness={
        "session_checkpoint_s": 3600, "session_checkpoint_sync": True,
        "session_checkpoint_dir": str(tmp_path)})
    pts = _traces(pa, 1, 6, seed=21)[0]["trace"]
    try:
        for p in pts:
            assert svc.handle_report({"uuid": "veh-c", "stream": True, "trace": [p],
                                      "match_options": MO})[0] == 200
        d = str(tmp_path / "rep-ck")
        assert svc.session_checkpointer.dir == d and _files(d) == ["veh-c.json"]
        (w,) = read_checkpoints(d)
        assert w == json.loads(json.dumps(svc.session_store.peek("veh-c").to_wire()))
        ref_eng, ref_store = _engine(ref, ref=True)
        assert ref_store.import_wire([w])["imported"] == 1
        full_eng, full = _engine(ref, ref=True)
        _stream(full_eng, pts + [_extra(pts)], "veh-c")
        _stream(ref_eng, [_extra(pts)], "veh-c")
        assert ref_store.peek("veh-c").records[-7:] == full.peek("veh-c").records[-7:]
    finally:
        svc.close()


# -- the engine ------------------------------------------------------------------------


@pytest.mark.parametrize("arena", [False, True], ids=["host", "slab"])
def test_late_commit_guard(setup, arena):
    """A step whose batcher wedged while it was in flight commits nothing
    and answers nothing when its finish wakes; the session then steps on
    as the reference's does."""
    pa, ports, ref = setup
    pts = _traces(pa, 1, 8, seed=4)[0]["trace"]
    out = {}
    for who, mm in (("port", _fresh(ports[arena]) if arena else ports[False]), ("ref", ref)):
        eng, store = _engine(mm, ref=who == "ref")
        _stream(eng, pts[:4], "veh-g")
        finish = eng.match_many_async([{"uuid": "veh-g", "trace": pts[4:6],
                                        "match_options": MO}])
        eng.invalidate_inflight()
        rows = [finish(), store.peek("veh-g").points_total, list(store.peek("veh-g").records)]
        (ans,) = _stream(eng, pts[6:8], "veh-g", step=2)
        rows += [ans["segments"], store.peek("veh-g").points_total]
        out[who] = rows
    assert out["port"][:2] == out["ref"][:2] == [[None], 4]
    assert out["port"][2] == out["ref"][2]
    if not arena:  # the slab's beam advanced at dispatch: fault 3c, on purpose
        assert out["port"] == out["ref"]
    assert out["port"][4] == 6


def test_degraded_step_equals_reference(setup):
    pa, ports, ref = setup
    pm = ports[True]
    pts = _traces(pa, 1, 6, seed=8)[0]["trace"]
    cpu = SegmentMatcher(arrays=pm.arrays, ubodt=pm.ubodt, config=pm.cfg, backend="cpu")
    ref_cpu = RefMatcher(arrays=ref.arrays, ubodt=ref.ubodt, config=ref.cfg, backend="cpu")
    out = {}
    for who, mm, c in (("port", _fresh(pm), cpu), ("ref", ref, ref_cpu)):
        eng, store = _engine(mm, ref=who == "ref")
        _stream(eng, pts[:2], "veh-x")
        rows = []
        for p in pts[2:4] + [pts[3]]:  # the last a duplicate delivery
            ans = eng.degraded_step(c, {"uuid": "veh-x", "trace": [p], "match_options": MO})
            ans["_stream"]["session"].pop("age_s")
            rows.append(json.loads(json.dumps(ans)))
        s = store.peek("veh-x")
        rows.append((s.carry, s.records, s.rebuild_pending, s.points_total, len(s.replay)))
        (ans,) = _stream(eng, pts[4:], "veh-x", step=2)
        ans["_stream"]["session"].pop("age_s")
        rows.append(json.loads(json.dumps(ans)))
        rows.append(list(store.peek("veh-x").records))
        out[who] = rows
    assert out["port"] == out["ref"]
    assert out["port"][3] == (None, [], True, 4, 4)
    assert out["port"][4]["_stream"]["session"]["rebuilt"] is True
    assert out["port"][5] == _windowed_records(pm, pts)
