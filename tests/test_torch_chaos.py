"""The port's serving fault domains against the JAX package's, over HTTP on
a 5 x 5 grid: both services run from the same arrays and table under the
same ``REPORTER_FAULT_*`` environment, and every answer's status code and
JSON body (round-tripped) must be equal.

  faults off   the served answers equal ``report()`` over ``match``, no
               fault fires, nothing is degraded;
  poison       a poison trace fails alone (500 "failed its device batch
               alone"), its neighbours answer 200, the repeat offender is
               refused 422 until its quarantine expires; the same for
               streaming submits; a transient probe failure is absorbed by
               the bisect; a failure of every launch is a 500, never a
               degraded answer;
  watchdog     a hung device step degrades the service to the CPU
               baseline (``"degraded": true`` on /report, the batch route
               and its binary frame, streaming submits and /health), and
               the service re-attaches once the fault clears: streaming
               sessions rebuild from their replay buffers, equal to the
               windowed decode; ``cpu_fallback`` false answers 503;
  crash        a dead loop thread fails its pending futures and turns
               /health into 503 "unhealthy";
  seams        clock_skew expires deadlines in the queue (504),
               replica_shed sheds (429), replica_slow_accept only delays.

The two packages' timed scenarios run side by side in two threads; the
fault variables change only where both threads meet."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from reporter_tpu import faults as ref_faults
from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.serve import service as ref_service_mod
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch import faults
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.report import report as report_fn
from reporter_tpu_torch.serve import service as service_mod
from reporter_tpu_torch.serve import wire
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city

MO = {"mode": "auto", "report_levels": [0, 1, 2], "transition_levels": [0, 1, 2]}
INNOCENT = ["veh-%d" % i for i in range(7)]


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for p in faults.POINTS:
        monkeypatch.delenv("REPORTER_FAULT_" + p.upper(), raising=False)
    for var in ("REPORTER_WATCHDOG_S", "REPORTER_QUARANTINE_AFTER", "REPORTER_QUARANTINE_TTL_S",
                "REPORTER_REATTACH_PROBE_S", "REPORTER_MAX_QUEUE", "REPORTER_DEADLINE_MS",
                "REPORTER_SESSION_CHECKPOINT_S", "REPORTER_SESSION_CHECKPOINT_DIR"):
        monkeypatch.delenv(var, raising=False)
    _reset()
    yield
    _reset()


def _reset():
    faults.reset()
    ref_faults.reset()


@pytest.fixture(scope="module")
def engines():
    ra = ref_build_graph_arrays(ref_grid_city(5, 5, 150.0), cell_size=100.0)
    pa = build_graph_arrays(grid_city(5, 5, 150.0), cell_size=100.0)
    ref = RefMatcher(arrays=ra, ubodt=ref_build_ubodt(ra, delta=2000.0), config=RefConfig(),
                     backend="jax")
    port = SegmentMatcher(arrays=pa, config=MatcherConfig(ubodt_delta=2000.0), device="cpu")
    # the reference's shapes compiled before the timed cases: every batch
    # rung the bisect reaches and the session steps
    for b in (1, 4, 8):
        ref.match_many([street_trace(pa, row=r % 4) for r in range(b)])
    ref.match_sessions([{"points": street_trace(pa)["trace"][:k], "carry": None, "t0": 0.0,
                         "pkey": (), "uuid": "w"} for k in (1, 1)])
    return pa, port, ref


def street_trace(arrays, row=2, n=10, t0=1000, uuid=None):
    nodes = [row * 5 + c for c in range(5)]
    t = np.linspace(0.05, 0.9, n)
    xs = np.interp(t, np.linspace(0, 1, 5), arrays.node_x[nodes])
    ys = np.interp(t, np.linspace(0, 1, 5), arrays.node_y[nodes])
    lat, lon = arrays.proj.to_latlon(xs, ys)
    return {"uuid": uuid or ("veh-%d" % row), "match_options": dict(MO),
            "trace": [{"lat": float(a), "lon": float(o), "time": t0 + 15 * i}
                      for i, (a, o) in enumerate(zip(lat, lon))]}


class _Served:
    def __init__(self, svc):
        self.svc = svc
        self.httpd = svc.make_server("127.0.0.1", 0)
        self.th = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.th.start()
        self.url = "http://127.0.0.1:%d" % self.httpd.server_address[1]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.th.join(10)
        close = getattr(self.svc, "close", None)
        if close is not None:  # the reference service has none
            close()


@pytest.fixture
def pair(engines):
    """make(**kw) -> {"port": served port service, "ref": served reference
    service}, both from the same keyword arguments."""
    made = []

    def make(**kw):
        _pa, port, ref = engines
        out = {"port": _Served(service_mod.ReporterService(port, **kw)),
               "ref": _Served(ref_service_mod.ReporterService(ref, **kw))}
        made.extend(out.values())
        return out

    yield make
    for s in made:
        s.close()


def post(url, payload, headers=None, raw=False):
    req = urllib.request.Request(
        url, data=payload if raw else json.dumps(payload).encode(),
        headers=dict({"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            body = r.read()
            return r.status, (body if raw else json.loads(body)), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def norm(code_body):
    """(code, body) comparable across packages: the session block's age
    and the replica's name are the process's own."""
    code, body = code_body[:2]
    body = json.loads(json.dumps(body))
    if isinstance(body, dict):
        body.pop("replica", None)
        if isinstance(body.get("session"), dict):
            body["session"].pop("age_s", None)
    return code, body


def run_pair(scenario, served, syncs=()):
    """Run ``scenario(served_one, package_name, sync)`` for both packages on
    two threads; ``sync()`` waits for the other thread, and the first
    call's meeting runs ``syncs[0]`` once, and so on.  Returns {"port":
    result, "ref": result}."""
    bars = [threading.Barrier(2, action=a, timeout=120) for a in syncs]
    out, errors = {}, []

    def go(name):
        it = iter(bars)
        try:
            out[name] = scenario(served[name], name, lambda: next(it).wait())
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            for b in bars:
                b.abort()

    threads = [threading.Thread(target=go, args=(n,)) for n in ("port", "ref")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors:
        raise errors[0]
    return out


def _concurrent(fn, keys):
    res = {}
    ths = [threading.Thread(target=lambda k=k, i=i: res.__setitem__(k, fn(i, k)))
           for i, k in enumerate(keys)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(120)
    return res


# -- faults off ---------------------------------------------------------------


def test_all_faults_off_is_bit_identical(engines, pair):
    pa, port, _ref = engines
    before = {p: faults.injected(p) for p in faults.POINTS}
    counts = service_mod.counts()
    s = pair(max_wait_ms=5.0)
    trace = street_trace(pa)
    got = post(s["port"].url + "/report", trace)
    assert norm(got) == norm(post(s["ref"].url + "/report", trace))
    want = report_fn(port.match(trace), trace, 15, {0, 1, 2}, {0, 1, 2}, mode="auto")
    assert got[0] == 200 and got[1] == json.loads(json.dumps(want))
    assert "degraded" not in got[1]
    body = {"traces": [street_trace(pa, row=r) for r in range(3)]}
    got = post(s["port"].url + "/trace_attributes_batch", body)
    assert norm(got) == norm(post(s["ref"].url + "/trace_attributes_batch", body))
    assert got[0] == 200 and "degraded" not in got[1]
    code, health = get(s["port"].url + "/health")
    assert code == 200 and health["degraded"] is False
    assert {p: faults.injected(p) for p in faults.POINTS} == before
    assert service_mod.counts() == counts


# -- poison -------------------------------------------------------------------


def _poison_round(s, pa, stream_idx=None):
    def hit(i, uuid):
        tr = street_trace(pa, row=i % 4, uuid=uuid)
        if stream_idx is not None:
            tr = dict(tr, stream=True, trace=[tr["trace"][stream_idx]])
        return norm(post(s.url + "/report", tr))
    return _concurrent(hit, INNOCENT[: 5 if stream_idx is not None else 7] + ["poison-veh"])


def test_poison_trace_fails_alone_then_quarantines(engines, pair, monkeypatch):
    pa, _port, _ref = engines
    monkeypatch.setenv("REPORTER_FAULT_DISPATCH", "uuid:poison-veh")
    s = pair(max_wait_ms=150.0, robustness=dict(watchdog_s=0, quarantine_after=2,
                                                quarantine_ttl_s=300.0))
    b = s["port"].svc.batcher
    isolated = service_mod.counts()["poison_isolations"]
    for rnd in range(2):
        got, want = _poison_round(s["port"], pa), _poison_round(s["ref"], pa)
        assert got == want, rnd
        code, body = got["poison-veh"]
        assert code == 500 and "failed its device batch alone" in body["error"]
        assert all(got[u][0] == 200 and got[u][1]["datastore"]["reports"] for u in INNOCENT)
    assert service_mod.counts()["poison_isolations"] - isolated == 2 and b.quarantined() == 1
    # round 3: refused at admission, nothing dispatched; innocents fly
    n = faults.injected("dispatch")
    for name in ("port", "ref"):
        code, body = norm(post(s[name].url + "/report", street_trace(pa, uuid="poison-veh")))
        assert code == 422 and body == {
            "error": "uuid 'poison-veh' is quarantined after repeated poison-batch isolation"}
        assert post(s[name].url + "/report", street_trace(pa))[0] == 200
    assert faults.injected("dispatch") == n
    assert service_mod.counts()["quarantine_rejections"] >= 1


def test_poisoned_session_fails_alone_then_quarantines(engines, pair, monkeypatch):
    pa, _port, _ref = engines
    monkeypatch.setenv("REPORTER_FAULT_DISPATCH", "uuid:poison-veh")
    s = pair(max_wait_ms=5.0, session_wait_ms=150.0,
             robustness=dict(watchdog_s=0, quarantine_after=2, quarantine_ttl_s=300.0))
    for idx in (0, 1):
        got, want = _poison_round(s["port"], pa, idx), _poison_round(s["ref"], pa, idx)
        assert got == want
        assert got["poison-veh"][0] == 500
        assert "failed its device batch alone" in got["poison-veh"][1]["error"]
        for u in INNOCENT[:5]:
            assert got[u][0] == 200 and got[u][1]["session"]["points_total"] == idx + 1
    for name in ("port", "ref"):
        tr = street_trace(pa, uuid="poison-veh")
        code, body, _h = post(s[name].url + "/report",
                              dict(tr, stream=True, trace=[tr["trace"][2]]))
        assert code == 422 and "quarantined" in body["error"]
        tr = street_trace(pa, uuid="veh-0")
        code, body, _h = post(s[name].url + "/report",
                              dict(tr, stream=True, trace=[tr["trace"][2]]))
        assert code == 200 and body["session"]["points_total"] == 3


def test_quarantine_ttl_expires(engines):
    pa, port, ref = engines
    svcs = [mod.ReporterService(m, robustness=dict(watchdog_s=0, quarantine_after=1,
                                                   quarantine_ttl_s=0.2))
            for mod, m in ((service_mod, port), (ref_service_mod, ref))]
    try:
        for svc, mod in zip(svcs, (service_mod, ref_service_mod)):
            b = svc.batcher
            b._record_offender("bad-veh")
            assert b._is_quarantined("bad-veh")
            with pytest.raises(mod.TraceQuarantined):
                b.submit({"uuid": "bad-veh", "trace": []})
        time.sleep(0.3)
        assert [svc.batcher._is_quarantined("bad-veh") for svc in svcs] == [False, False]
        assert svcs[0].batcher.quarantined() == 0
    finally:
        svcs[0].close()


def test_transient_device_fault_absorbed_by_bisect(engines, pair, monkeypatch):
    pa, _port, _ref = engines
    monkeypatch.setenv("REPORTER_FAULT_UBODT_PROBE", "1")
    s = pair(max_wait_ms=300.0, robustness=dict(watchdog_s=0))
    n = faults.injected("ubodt_probe")
    isolated = service_mod.counts()["poison_isolations"]
    out = {}
    for name in ("port", "ref"):
        out[name] = _concurrent(
            lambda i, _k, name=name: norm(post(s[name].url + "/report",
                                               street_trace(pa, row=i % 4))), range(4))
    assert out["port"] == out["ref"]
    assert all(c == 200 and b["datastore"]["reports"] for c, b in out["port"].values())
    assert faults.injected("ubodt_probe") == n + 1
    assert service_mod.counts()["poison_isolations"] == isolated


def test_failing_launches_are_batch_failures_not_degraded(engines, pair, monkeypatch):
    """Every dispatch failing (a launch error on every program) fails the
    requests with the error (500) through the bisect; the watchdog never
    trips and nothing is answered degraded."""
    pa, _port, _ref = engines
    monkeypatch.setenv("REPORTER_FAULT_UBODT_PROBE", "always")
    s = pair(max_wait_ms=100.0, robustness=dict(watchdog_s=5.0, quarantine_after=100))
    trips = service_mod.counts()["watchdog_trips"]
    out = {name: _concurrent(lambda i, k, name=name: norm(post(
        s[name].url + "/report", street_trace(pa, row=i % 4, uuid=k))), INNOCENT[:4])
        for name in ("port", "ref")}
    assert out["port"] == out["ref"]
    for code, body in out["port"].values():
        assert code == 500 and "injected fault at ubodt_probe" in body["error"]
    body = {"traces": [street_trace(pa, row=r) for r in range(2)]}
    got = norm(post(s["port"].url + "/trace_attributes_batch", body))
    assert got == norm(post(s["ref"].url + "/trace_attributes_batch", body))
    assert got[0] == 500
    assert not s["port"].svc.degraded and service_mod.counts()["watchdog_trips"] == trips


# -- the watchdog, degraded mode and re-attach ---------------------------------


def _clear_hang():
    import os

    os.environ.pop("REPORTER_FAULT_DEVICE_HANG", None)
    _reset()


def _wait_reattached(svc, timeout=20.0):
    deadline = time.monotonic() + timeout
    while svc.degraded and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not svc.degraded, "no re-attach within %.0f s" % timeout


def test_watchdog_degrades_to_cpu_then_reattaches(engines, pair, monkeypatch):
    pa, port, _ref = engines
    monkeypatch.setenv("REPORTER_FAULT_DEVICE_HANG", "2.5")
    s = pair(max_wait_ms=5.0, robustness=dict(watchdog_s=0.4, reattach_probe_s=0.25))
    batch = {"traces": [street_trace(pa, row=r) for r in range(3)]}

    def scenario(one, name, sync):
        out = [norm(post(one.url + "/report", street_trace(pa)))]
        out.append(get(one.url + "/health"))
        out.append(norm(post(one.url + "/report", street_trace(pa, row=1))))
        out.append(norm(post(one.url + "/trace_attributes_batch", batch)))
        frame = None
        if name == "port":
            code, frame, hdrs = post(one.url + "/trace_attributes_batch",
                                     wire.encode_request(json.loads(json.dumps(batch))),
                                     {"Content-Type": wire.CONTENT_TYPE,
                                      "Accept": wire.CONTENT_TYPE}, raw=True)
            assert code == 200 and wire.is_wire(hdrs["Content-Type"])
        sync()  # the fault clears
        _wait_reattached(one.svc)
        out.append(norm(post(one.url + "/report", street_trace(pa))))
        out.append(get(one.url + "/health"))
        return out, frame

    res = run_pair(scenario, s, syncs=(_clear_hang,))
    (got, frame), (want, _f) = res["port"], res["ref"]
    for i in (0, 2, 3, 4):
        assert got[i] == want[i], i
    cpu = SegmentMatcher(arrays=port.arrays, ubodt=port.ubodt, config=port.cfg, backend="cpu")
    for i, tr in ((0, street_trace(pa)), (2, street_trace(pa, row=1))):
        assert got[i][0] == 200 and got[i][1].pop("degraded") is True
        assert got[i][1] == json.loads(json.dumps(report_fn(
            cpu.match(tr), tr, 15, {0, 1, 2}, {0, 1, 2}, mode="auto")))
    assert got[3][0] == 200 and got[3][1]["degraded"] is True
    assert wire.response_degraded(frame)
    assert wire.decode_response(frame) == got[3][1]
    for h in (got[1], want[1]):
        assert h[0] == 200 and h[1]["status"] == "ok" and h[1]["degraded"] is True
    assert got[4][0] == 200 and "degraded" not in got[4][1]
    assert got[5][1]["degraded"] is False
    svc = s["port"].svc
    assert svc.reattach_s is not None and svc.batcher.trips == 0
    assert sum(b.trips for b in svc._retired) == 1


def test_streaming_degraded_answering_and_rebuild(engines, pair, monkeypatch):
    """Streaming submits in the degraded window are answered by the CPU
    baseline over the session's replay (degraded and session block); after
    re-attach the next step rebuilds the beam from the replay buffer, equal
    to the windowed decode of the whole history, points_total exact."""
    pa, _port, _ref = engines
    monkeypatch.setenv("REPORTER_FAULT_DEVICE_HANG", "2.5")
    s = pair(max_wait_ms=5.0, session_wait_ms=1.0,
             robustness=dict(watchdog_s=0.4, reattach_probe_s=0.25))
    tr = street_trace(pa, uuid="deg-veh")

    def scenario(one, name, sync):
        out = []
        for i in range(3):
            out.append(norm(post(one.url + "/report",
                                 dict(tr, stream=True, trace=[tr["trace"][i]]))))
        sess = one.svc.session_store.peek("deg-veh")
        out.append((sess.rebuild_pending, sess.carry is None, len(sess.replay)))
        sync()
        _wait_reattached(one.svc)
        out.append(norm(post(one.url + "/report", dict(tr, stream=True, trace=[tr["trace"][3]]))))
        sess = one.svc.session_store.peek("deg-veh")
        out.append((sess.rebuild_pending, sess.carry is None, len(sess.replay)))
        out.append(norm(post(one.url + "/report", dict(tr, uuid="ref-w", trace=tr["trace"][:4]))))
        return out

    res = run_pair(scenario, s, syncs=(_clear_hang,))
    got, want = res["port"], res["ref"]
    assert got == want
    for i in range(3):
        code, body = got[i]
        assert code == 200 and body["degraded"] is True
        assert body["session"]["points_total"] == i + 1 and body["session"]["degraded"]
    assert got[3] == (True, True, 3)
    code, body = got[4]
    assert code == 200 and "degraded" not in body
    assert body["session"]["points_total"] == 4 and body["session"]["rebuilt"] is True
    assert got[5] == (False, False, 4)
    body.pop("session")
    assert body["datastore"] == got[6][1]["datastore"]


def test_cpu_fallback_off_answers_503(engines, pair, monkeypatch):
    pa, port, ref = engines
    monkeypatch.setattr(port.cfg, "cpu_fallback", False)
    monkeypatch.setattr(ref.cfg, "cpu_fallback", False)
    monkeypatch.setenv("REPORTER_FAULT_DEVICE_HANG", "2.5")
    s = pair(max_wait_ms=5.0, robustness=dict(watchdog_s=0.4, reattach_probe_s=0))

    def scenario(one, name, sync):
        out = [post(one.url + "/report", street_trace(pa)) for _ in range(2)]
        out.append(post(one.url + "/trace_attributes_batch", {"traces": [street_trace(pa)]}))
        return [(c, b, h.get("Retry-After")) for c, b, h in out]

    res = run_pair(scenario, s)
    assert res["port"] == res["ref"]
    for code, body, ra in res["port"]:
        assert code == 503 and ra == "1" and body["retry_after"] == 1
    assert res["port"][0][1]["error"] == "device wedged and cpu_fallback disabled"
    assert s["port"].svc.degraded


# -- crash-loud loops -----------------------------------------------------------


def test_loop_thread_crash_fails_pending_and_flips_health(engines):
    pa, port, ref = engines
    answers = {}
    for mod, m in ((service_mod, port), (ref_service_mod, ref)):
        for victim in ("_q", "_finish_q"):
            svc = mod.ReporterService(m, max_wait_ms=5.0, robustness=dict(watchdog_s=0))
            b = svc.batcher
            q = getattr(b, victim)
            orig_get = q.get

            def boom(*a, orig_get=orig_get, **kw):
                if a or kw:  # the drain's get(block=False) keeps working
                    return orig_get(*a, **kw)
                raise RuntimeError("synthetic loop bug")

            q.get = boom
            assert b.submit(street_trace(pa)).result(timeout=60) is not None
            deadline = time.monotonic() + 10.0
            # the crash hook runs last, after the pending futures failed
            while svc.unhealthy_reason is None and time.monotonic() < deadline:
                time.sleep(0.02)
            assert b._crashed and svc.unhealthy_reason, victim
            with pytest.raises(mod.BatcherCrashed):
                b.submit(street_trace(pa))
            code, health = svc.handle_health()
            code_r, rep = svc.handle_report(street_trace(pa))
            answers[(mod is service_mod, victim)] = (
                code, health["status"], health["reason"], code_r, rep)
            if mod is service_mod:
                svc.close()
    for victim in ("_q", "_finish_q"):
        assert answers[(True, victim)] == answers[(False, victim)]
        code, status, reason, code_r, rep = answers[(True, victim)]
        assert (code, status, code_r) == (503, "unhealthy", 503) and "died" in reason
        assert rep["retry_after"] == 1 and "thread died" in rep["error"]


# -- the admission seams --------------------------------------------------------


def test_clock_skew_shed_and_slow_accept_seams(engines, pair, monkeypatch):
    pa, _port, _ref = engines
    s = pair(max_wait_ms=50.0, robustness=dict(watchdog_s=0))
    out = {}
    for name in ("port", "ref"):
        _reset()
        rows = []
        monkeypatch.setenv("REPORTER_FAULT_CLOCK_SKEW", "1000.0:1")
        rows.append(norm(post(s[name].url + "/report", street_trace(pa),
                              {"X-Reporter-Deadline-Ms": "5000"})))
        rows.append(norm(post(s[name].url + "/report", street_trace(pa),
                              {"X-Reporter-Deadline-Ms": "5000"})))
        monkeypatch.delenv("REPORTER_FAULT_CLOCK_SKEW")
        monkeypatch.setenv("REPORTER_FAULT_REPLICA_SHED", "1")
        code, body, hdrs = post(s[name].url + "/report", street_trace(pa))
        rows.append((code, body, hdrs.get("Retry-After")))
        rows.append(norm(post(s[name].url + "/report", street_trace(pa))))
        monkeypatch.delenv("REPORTER_FAULT_REPLICA_SHED")
        monkeypatch.setenv("REPORTER_FAULT_REPLICA_SLOW_ACCEPT", "0.2:1")
        t0 = time.monotonic()
        rows.append(norm(post(s[name].url + "/report", street_trace(pa))))
        rows.append(time.monotonic() - t0 >= 0.2)
        monkeypatch.delenv("REPORTER_FAULT_REPLICA_SLOW_ACCEPT")
        out[name] = rows
    got = out["port"]
    assert got[0][0] == 504 and got[0][1]["error"].startswith("deadline expired after")
    assert got[1][0] == 200
    assert got[2] == (429, {"error": "injected admission shed", "retry_after": 1}, "1")
    assert got[3][0] == got[4][0] == 200 and got[5] is True
    # the 504's queue time is the process's own
    for rows in out.values():
        rows[0] = (rows[0][0], rows[0][1]["error"].split(" after ")[0])
    assert out["port"] == out["ref"]
