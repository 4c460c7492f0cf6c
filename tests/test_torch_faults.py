"""The port's fault injection (``reporter_tpu_torch/faults.py``) against the
JAX package's module: the same spec grammar gives the same sequence of
firings, keyed and count-limited alike; and the drain: the service's
/health statuses, and a SIGTERM to ``python -m reporter_tpu_torch.serve
--device cpu`` that finishes the inflight request, refuses new work with
503 "draining" and exits 0."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from reporter_tpu import faults as ref_faults
from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.serve.service import ReporterService as RefService
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch import faults
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.serve.service import ReporterService
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MO = {"mode": "auto", "report_levels": [0, 1, 2], "transition_levels": [0, 1, 2]}


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for p in faults.POINTS:
        monkeypatch.delenv("REPORTER_FAULT_" + p.upper(), raising=False)
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()


def test_points_are_the_reference_points():
    assert faults.POINTS == ref_faults.POINTS


# (point, spec, keys fired in turn): every grammar form, the count limits,
# the uuid: form's matching and the disarmed spellings
SPECS = [
    ("dispatch", "3", [None] * 5),
    ("dispatch", "always", [None] * 4),
    ("dispatch", "uuid:poison", ["a,poison-veh", "a,b", None, "poison", "xpoisonx"]),
    ("dispatch", "uuid:", ["a", None]),
    ("dispatch", "0", [None] * 2),
    ("dispatch", "off", [None] * 2),
    ("dispatch", "No", [None] * 2),
    ("ubodt_probe", "1", [None] * 3),
    ("device_hang", "0.001", [None] * 3),
    ("device_hang", "0.001:2", [None] * 4),
    ("store_put", "5xx:2", [None] * 3),
    ("store_put", "timeout", [None] * 3),
    # any mode on any point (client_post's own count is the JAX package's
    # chaos suite's to read, absolutely, in the same process)
    ("store_put", "reset:1", [None] * 2),
    ("router_connect", "refused:3", [None] * 4),
    ("clock_skew", "4.0:1", [None] * 2),
    ("clock_skew", "4", [None] * 5),
    ("health_flap", "garbage", [None] * 2),
    ("replica_shed", " 2 ", [None] * 3),
    ("slow_drain", "0.5:x", [None] * 2),
]


@pytest.mark.parametrize("point,spec,keys", SPECS,
                         ids=["%s=%s" % (p, s.strip() or "empty") for p, s, _k in SPECS])
def test_spec_grammar_fires_as_the_reference(monkeypatch, point, spec, keys):
    monkeypatch.setenv("REPORTER_FAULT_" + point.upper(), spec)
    before = faults.injected(point)
    got = [faults.fire(point, k) for k in keys]
    want = [ref_faults.fire(point, k) for k in keys]
    assert got == want
    assert faults.spec(point) == ref_faults.spec(point)
    assert faults.injected(point) - before == sum(g is not None for g in got)
    # reset re-arms the count-limited specs, the counts stay
    faults.reset()
    ref_faults.reset()
    assert [faults.fire(point, k) for k in keys] == [ref_faults.fire(point, k) for k in keys]
    assert faults.injected(point) - before == 2 * sum(g is not None for g in got)


def test_changing_the_spec_rearms_and_helpers_agree(monkeypatch):
    monkeypatch.setenv("REPORTER_FAULT_UBODT_PROBE", "1")
    with pytest.raises(faults.InjectedFault, match="injected fault at ubodt_probe$"):
        faults.maybe_raise("ubodt_probe")
    faults.maybe_raise("ubodt_probe")  # consumed
    monkeypatch.setenv("REPORTER_FAULT_UBODT_PROBE", "01")  # another raw spec
    with pytest.raises(faults.InjectedFault) as e:
        faults.maybe_raise("ubodt_probe", "k")
    with pytest.raises(ref_faults.InjectedFault) as r:
        ref_faults.maybe_raise("ubodt_probe", "k")
    assert str(e.value) == str(r.value) and e.value.point == r.value.point
    monkeypatch.setenv("REPORTER_FAULT_CLOCK_SKEW", "2.5:1")
    assert [faults.scale("clock_skew") for _ in range(2)] == \
        [ref_faults.scale("clock_skew") for _ in range(2)] == [2.5, 1.0]
    monkeypatch.setenv("REPORTER_FAULT_DEVICE_HANG", "0.05:1")
    t0 = time.monotonic()
    assert faults.hang() == ref_faults.hang() == 0.05
    assert faults.hang() == ref_faults.hang() == 0.0
    assert time.monotonic() - t0 >= 0.1


# -- the drain ----------------------------------------------------------------


@pytest.fixture(scope="module")
def services():
    ra = ref_build_graph_arrays(ref_grid_city(5, 5, 150.0), cell_size=100.0)
    pa = build_graph_arrays(grid_city(5, 5, 150.0), cell_size=100.0)
    ref = RefMatcher(arrays=ra, ubodt=ref_build_ubodt(ra, delta=2000.0), config=RefConfig(),
                     backend="jax")
    port = SegmentMatcher(arrays=pa, config=MatcherConfig(ubodt_delta=2000.0), device="cpu")
    return port, ref


def _street_trace(arrays, uuid, row=2, n=10):
    nodes = [row * 5 + c for c in range(5)]
    t = np.linspace(0.05, 0.9, n)
    xs = np.interp(t, np.linspace(0, 1, 5), arrays.node_x[nodes])
    ys = np.interp(t, np.linspace(0, 1, 5), arrays.node_y[nodes])
    lat, lon = arrays.proj.to_latlon(xs, ys)
    return {"uuid": uuid, "match_options": dict(MO),
            "trace": [{"lat": float(a), "lon": float(o), "time": 1000 + 15 * i}
                      for i, (a, o) in enumerate(zip(lat, lon))]}


def _strip(body):
    return {k: v for k, v in body.items() if k not in ("uptime_s", "replica")}


def test_health_draining_vs_unhealthy_statuses(services, monkeypatch):
    """ok, then "unhealthy" (a dead batcher thread), then "draining" with
    its inflight count, unhealthy outranking draining, and draining
    refusals of both matching routes with Retry-After, as the
    reference."""
    port, ref = services
    monkeypatch.setenv("REPORTER_REPLICA_ID", "rep-x")
    svc, rsvc = ReporterService(port), RefService(ref)
    tr = _street_trace(port.arrays, "veh-d")
    try:
        got, want = [], []
        for s, out in ((svc, got), (rsvc, want)):
            code, body = s.handle_health()
            out.append((code, body["status"], body["replica"], body["degraded"]))
            s.unhealthy_reason = "batcher thread died: boom"
            out.append((s.handle_health()[0], _strip(s.handle_health()[1])))
            s.unhealthy_reason = None
            s.begin_drain()
            s.begin_drain()  # idempotent
            out.append((s.handle_health()[0], _strip(s.handle_health()[1])))
            out.append(s.handle_report(json.loads(json.dumps(tr))))
            out.append(s.handle_batch({"traces": [json.loads(json.dumps(tr))]}))
            s.unhealthy_reason = "batcher thread died: boom"
            out.append((s.handle_health()[0], _strip(s.handle_health()[1])))
            out.append(s.idle())
        assert got == want
        assert got[0] == (200, "ok", "rep-x", False)
        assert got[2] == (503, {"status": "draining", "inflight": 0})
        assert got[3] == (503, {"error": "draining", "status": "draining", "retry_after": 1})
    finally:
        svc.close()


def test_health_flap_seam(services, monkeypatch):
    port, ref = services
    svc, rsvc = ReporterService(port), RefService(ref)
    try:
        monkeypatch.setenv("REPORTER_FAULT_HEALTH_FLAP", "2")
        got = [(c, _strip(b)) for c, b in (svc.handle_health() for _ in range(3))]
        want = [(c, _strip(b)) for c, b in (rsvc.handle_health() for _ in range(3))]
        assert [g[0] for g in got] == [w[0] for w in want] == [503, 503, 200]
        assert got[:2] == want[:2] == [(503, {"status": "unhealthy",
                                              "reason": "injected health flap"})] * 2
        assert faults.injected("health_flap") >= 2
    finally:
        svc.close()


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_sigterm_drain_finishes_inflight_then_exits_zero(services, tmp_path):
    """SIGTERM to ``python -m reporter_tpu_torch.serve --device cpu``: the
    inflight request (held in a 1.5 s batch window) answers 200 equal to
    the matcher's report, a new /report answers 503 "draining" with
    Retry-After, /health 503 "draining", and the process exits 0."""
    port, _ref = services
    conf = {"network": {"type": "grid", "rows": 5, "cols": 5, "spacing_m": 150.0},
            "matcher": {"ubodt_delta": 2000.0},
            "batch": {"max_batch": 64, "max_wait_ms": 1500}}
    conf_path = tmp_path / "config.json"
    conf_path.write_text(json.dumps(conf))
    env = dict(os.environ, PYTHONPATH=REPO, REPORTER_REPLICA_ID="rep-drain",
               REPORTER_DRAIN_GRACE_S="15", REPORTER_QUALITY_AUX="0",
               REPORTER_SESSION_ARENA="0", REPORTER_SPARSE="0")
    proc = subprocess.Popen([sys.executable, "-m", "reporter_tpu_torch.serve", "--device",
                             "cpu", str(conf_path), "127.0.0.1:0"], cwd=str(tmp_path),
                            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        port_no, buf = None, b""
        deadline = time.monotonic() + 90
        while port_no is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                assert proc.poll() is None, buf.decode(errors="replace")
                continue
            buf += line
            if b"on 127.0.0.1:" in line:
                port_no = int(line.split(b"on 127.0.0.1:")[1].split()[0])
        assert port_no, buf.decode(errors="replace")
        # the log pipe is drained from here on, so the child never blocks
        threading.Thread(target=proc.stderr.read, daemon=True).start()
        url = "http://127.0.0.1:%d" % port_no
        # the boot is deferred: /health answers 200 "warming" from the bind,
        # and names the backend once the engine is attached
        assert _get(url + "/health")[0] == 200
        deadline = time.monotonic() + 60
        while _get(url + "/health")[1]["backend"] is None:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        inflight = {}
        tr = _street_trace(port.arrays, "veh-inflight")
        t = threading.Thread(target=lambda: inflight.update(r=_post(url + "/report", tr)))
        t.start()
        time.sleep(0.6)  # inside its 1.5 s batch window
        proc.send_signal(signal.SIGTERM)
        time.sleep(0.3)
        code, hdrs, body = _post(url + "/report", _street_trace(port.arrays, "veh-late"), 10)
        assert code == 503 and body == {"error": "draining", "status": "draining",
                                        "retry_after": 1}
        assert int(hdrs["Retry-After"]) >= 1 and hdrs["X-Reporter-Replica"] == "rep-drain"
        code, body = _get(url + "/health")
        assert code == 503 and body["status"] == "draining" and body["inflight"] == 1
        t.join(30)
        assert not t.is_alive()
        code, hdrs, body = inflight["r"]
        assert code == 200 and hdrs["X-Reporter-Replica"] == "rep-drain"
        from reporter_tpu_torch.report import report as report_fn

        want = report_fn(port.match(tr), tr, 15, {0, 1, 2}, {0, 1, 2}, mode="auto")
        assert body == json.loads(json.dumps(want))
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_answer_is_written_before_the_drain_sees_idle(services, monkeypatch):
    """The inflight count the drain waits on covers the answer's write: a
    handler still writing its body is not idle, so the drain's cut of the
    lingering connections cannot truncate it."""
    port, _ref = services
    svc = ReporterService(port, max_wait_ms=5)
    server = svc.make_server("127.0.0.1", 0)
    handler = server.RequestHandlerClass
    seen = []
    write = handler._answer

    def answer(self, code, payload):
        seen.append((code, svc.idle()))
        return write(self, code, payload)

    monkeypatch.setattr(handler, "_answer", answer)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        url = "http://127.0.0.1:%d" % server.server_address[1]
        tr = _street_trace(port.arrays, "veh-answer")
        assert _post(url + "/report", tr)[0] == 200
        assert _post(url + "/trace_attributes_batch", {"traces": [tr]})[0] == 200
        assert seen == [(200, False), (200, False)]
        deadline = time.monotonic() + 5
        while not svc.idle():  # the count drops once the handler returns
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_main_restores_the_signal_handlers(tmp_path, monkeypatch):
    """An in-process caller keeps its own SIGTERM/SIGINT handlers once
    ``main`` returns (here main returns at once: a server shut down from
    another thread)."""
    from reporter_tpu_torch.serve import __main__ as serve_main

    conf_path = tmp_path / "config.json"
    conf_path.write_text(json.dumps({"network": {"type": "grid", "rows": 3, "cols": 3},
                                     "matcher": {"ubodt_delta": 800.0}}))
    mine = lambda *_a: None  # noqa: E731
    old = {s: signal.signal(s, mine) for s in (signal.SIGTERM, signal.SIGINT)}
    made = []
    real = serve_main.ReporterService.make_server

    def make_server(self, host, port):
        server = real(self, host, port)
        made.append(server)
        threading.Timer(0.3, server.shutdown).start()
        return server

    monkeypatch.setattr(serve_main.ReporterService, "make_server", make_server)
    try:
        assert serve_main.main(["--device", "cpu", str(conf_path), "127.0.0.1:0"]) == 0
        assert made and all(signal.getsignal(s) is mine for s in old)
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def test_counts_lose_no_update_under_threads(monkeypatch):
    """The fault counts, the service's event counts and the sparse model's
    dispatch counts are bumped from the dispatch, finisher and probe
    threads at once: none may lose an update."""
    from reporter_tpu_torch.matching.sparse import SparseModel
    from reporter_tpu_torch.serve import service as service_mod

    monkeypatch.setenv("REPORTER_FAULT_REPLICA_SHED", "always")
    sparse = SparseModel(MatcherConfig(), 100.0)
    before = (faults.injected("replica_shed"), service_mod.counts()["drain_refusals"])
    n_threads, n = 16, 2000

    def bump(fn):
        for _ in range(n):
            fn()

    fns = (lambda: faults.fire("replica_shed"), lambda: service_mod._count("drain_refusals"),
           lambda: sparse.count("45-60"))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for fn in fns:
            workers = [threading.Thread(target=bump, args=(fn,)) for _ in range(n_threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(60)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert faults.injected("replica_shed") - before[0] == n_threads * n
    assert service_mod.counts()["drain_refusals"] - before[1] == n_threads * n
    assert sparse.dispatch == {"45-60": n_threads * n}
