"""The port's serve boot on the CPU: the deferred boot of
``python -m reporter_tpu_torch.serve`` (bind first, /health 200 with
"warming": true and "backend": null, /report and /sessions 503 "service
initialising" until ``attach_matcher``), ``--warmup`` (every shape warmed
before attach: the first streaming point and the first long trace build
and warm nothing inline), ``$MATCHER_CONF_FILE``, a failed engine build
(exit 1, listener closed), a SIGTERM during the warmup pass (exit 0), and
``capacity_summary`` and the /health key set against the JAX package's
replica of the same kind (the device program; the CPU baseline)."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.serve.service import ReporterService as RefService
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.obs import metrics as port_metrics
from reporter_tpu_torch.serve import __main__ as serve_main
from reporter_tpu_torch.serve.service import ReporterService
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city
from reporter_tpu_torch.tiles.ubodt import build_ubodt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(length_buckets=[16, 32])
# the port's /health keys beyond the reference's
PORT_EXTRA = {"device", "mesh", "max_trace_points", "sessions"}
CONF = {"network": {"type": "grid", "rows": 5, "cols": 5, "spacing_m": 150.0},
        "matcher": {"ubodt_delta": 2000.0, "length_buckets": [16, 32]},
        "batch": {"max_batch": 64, "max_wait_ms": 2, "session_wait_ms": 1}}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("MATCHER_CONF_FILE", "MATCHER_BIND_ADDR", "MATCHER_LISTEN_PORT",
                "REPORTER_SESSION_ARENA", "REPORTER_SPARSE", "REPORTER_QUALITY_AUX",
                "REPORTER_UBODT_HOT_BYTES", "REPORTER_VITERBI"):
        monkeypatch.delenv(var, raising=False)


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get_json(url, timeout=10):
    code, body = _get(url, timeout)
    return code, json.loads(body)


def _post_json(url, payload, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait_for(cond, timeout=10.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def _counter_sum(text, name):
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith(name + "{") or line.startswith(name + " "))


def _street(arrays, uuid, n, t0=1000):
    """n points along the 5 x 5 grid's rows, 15 s apart."""
    nodes = [r * 5 + c for r in range(5) for c in (range(5) if r % 2 == 0 else range(4, -1, -1))]
    t = np.linspace(0.02, 0.98, n)
    xs = np.interp(t, np.linspace(0, 1, 25), arrays.node_x[nodes])
    ys = np.interp(t, np.linspace(0, 1, 25), arrays.node_y[nodes])
    lat, lon = arrays.proj.to_latlon(xs, ys)
    return {"uuid": uuid, "trace": [{"lat": float(a), "lon": float(o), "time": t0 + 15 * i}
                                    for i, (a, o) in enumerate(zip(lat, lon))],
            "match_options": {"mode": "auto", "report_levels": [0, 1],
                              "transition_levels": [0, 1]}}


class _InProcess:
    """``serve_main.main(argv)`` on a thread (no signal handlers there),
    its server captured; ``gate`` holds the engine build until set."""

    def __init__(self, monkeypatch, argv, gate=None, build=None):
        self.servers = []
        real = serve_main.ReporterService.make_server

        def make_server(svc, host, port):
            server = real(svc, host, port)
            self.svc = svc
            self.servers.append(server)
            return server

        monkeypatch.setattr(serve_main.ReporterService, "make_server", make_server)
        real_build = build or serve_main.build_matcher

        def build_matcher(cfg, conf, device="cuda"):
            if gate is not None:
                assert gate.wait(60)
            return real_build(cfg, conf, device=device)

        monkeypatch.setattr(serve_main, "build_matcher", build_matcher)
        self.rc = []
        self.thread = threading.Thread(target=lambda: self.rc.append(serve_main.main(argv)),
                                       daemon=True)
        self.thread.start()
        assert _wait_for(lambda: self.servers)
        self.url = "http://127.0.0.1:%d" % self.servers[0].server_address[1]

    def stop(self):
        if self.thread.is_alive():
            self.servers[0].shutdown()
        self.thread.join(60)
        assert not self.thread.is_alive()
        return self.rc[0]


def test_deferred_boot_warming_then_attached(monkeypatch, tmp_path):
    """Bound before the engine exists: /health 200 "warming" with the
    matcher's fields null, /report and /sessions 503 "service
    initialising", /statusz warming; then attached (after the --warmup
    pass) with a capacity block, and the pass's shapes counted."""
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(CONF))
    gate = threading.Event()
    warmed0 = _counter_sum(port_metrics.REGISTRY.render(), "reporter_warmup_shapes_total")
    run = _InProcess(monkeypatch, ["--warmup", "--device", "cpu", str(cfg), "127.0.0.1:0"],
                     gate=gate)
    try:
        code, health = _get_json(run.url + "/health")
        assert code == 200 and health["status"] == "ok" and health["warming"] is True
        assert health["backend"] is None and health["capacity"] is None
        assert _post_json(run.url + "/report", {"uuid": "v", "trace": []}) == (
            503, {"error": "service initialising", "retry_after": 1})
        assert _get_json(run.url + "/sessions")[0] == 503
        code, statusz = _get_json(run.url + "/statusz")
        assert code == 200 and statusz["warming"] is True and statusz["backend"] is None
        gate.set()
        assert _wait_for(lambda: not _get_json(run.url + "/health")[1]["warming"], 60)
        code, health = _get_json(run.url + "/health")
        assert code == 200 and health["backend"] == "jax" and health["device"] == "cpu"
        assert health["capacity"]["devices"] == 1
        assert health["capacity"]["mesh"] == {"dp": 1, "gp": 1}
        assert "session_arena" in health["capacity"]  # the serve default: the slab
        assert _get_json(run.url + "/statusz")[1]["warming"] is False
        assert _counter_sum(port_metrics.REGISTRY.render(),
                            "reporter_warmup_shapes_total") > warmed0
    finally:
        gate.set()
        assert run.stop() == 0


def test_failed_engine_build_exits_1(monkeypatch, tmp_path):
    """An engine build that raises closes the listener and main returns 1."""
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"network": {"type": "file", "path": str(tmp_path / "none")}}))
    run = _InProcess(monkeypatch, ["--device", "cpu", str(cfg), "127.0.0.1:0"])
    assert run.stop() == 1
    port = run.servers[0].server_address[1]
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2).close()


def test_matcher_conf_file_and_usage(monkeypatch, tmp_path, capsys):
    """No config and no $MATCHER_CONF_FILE is a usage error (exit 1);
    with the variable set a lone positional address is the address."""
    assert serve_main.main(["--device", "cpu"]) == 1
    assert "usage:" in capsys.readouterr().err
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(dict(CONF, warmup=False)))
    monkeypatch.setenv("MATCHER_CONF_FILE", str(cfg))
    run = _InProcess(monkeypatch, ["--device", "cpu", "127.0.0.1:0"])
    try:
        assert _wait_for(lambda: _get_json(run.url + "/health")[1]["backend"] == "jax", 60)
    finally:
        assert run.stop() == 0


def _spawn(tmp_path, conf, *flags):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(conf))
    env = dict(os.environ, PYTHONPATH=REPO, REPORTER_REPLICA_ID="boot")
    proc = subprocess.Popen([sys.executable, "-m", "reporter_tpu_torch.serve", *flags,
                             str(path), "127.0.0.1:0", "--device", "cpu"], cwd=str(tmp_path),
                            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    buf = b""
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        line = proc.stderr.readline()
        if not line:
            assert proc.poll() is None, buf.decode(errors="replace")
            continue
        buf += line
        if b"on 127.0.0.1:" in line:
            break
    port = int(line.split(b"on 127.0.0.1:")[1].split()[0])
    log = []
    threading.Thread(target=lambda: log.extend(proc.stderr), daemon=True).start()
    return proc, "http://127.0.0.1:%d" % port, log


def test_warmup_cli_binds_at_once_and_leaves_no_shape_cold(tmp_path):
    """``serve --warmup``: /health answers "warming" right after the bind,
    then 200 "ok" with a capacity block; the first streaming point and
    the first long trace (two windows) dispatch no shape for the first
    time; SIGTERM exits 0."""
    arrays = build_graph_arrays(grid_city(5, 5, 150.0), cell_size=100.0)
    proc, url, _log = _spawn(tmp_path, CONF, "--warmup")
    try:
        code, health = _get_json(url + "/health")
        assert code == 200 and health["warming"] is True and health["backend"] is None
        assert _wait_for(lambda: not _get_json(url + "/health")[1]["warming"], 120, 0.1)
        code, health = _get_json(url + "/health")
        assert code == 200 and health["status"] == "ok" and health["capacity"]["devices"] == 1
        before = _counter_sum(_get(url + "/metrics")[1].decode(), "reporter_compile_total")
        tr = _street(arrays, "boot-stream", 6)
        code, body = _post_json(url + "/report", dict(tr, stream=True, trace=tr["trace"][:1]))
        assert code == 200 and body["session"]["points_total"] == 1
        code, body = _post_json(url + "/report", dict(tr, stream=True, trace=tr["trace"][1:]))
        assert code == 200 and body["session"]["points_total"] == 6
        code, body = _post_json(url + "/report", _street(arrays, "boot-long", 50))
        assert code == 200 and body["segment_matcher"]["segments"]
        after = _counter_sum(_get(url + "/metrics")[1].decode(), "reporter_compile_total")
        assert after == before, "a request after --warmup dispatched a shape first"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_unwarmed_first_streaming_point_does_dispatch_a_shape_first(both):
    """The control of the --warmup case: without a warmup pass the first
    streaming point is a shape's first dispatch (the counter the warmed
    replica keeps flat does fire), as in the JAX package."""
    from reporter_tpu_torch.matching import SessionEngine, SessionStore

    _ref, (pa, pub) = both
    m = SegmentMatcher(arrays=pa, ubodt=pub, device="cpu",
                       config=MatcherConfig(session_arena=True, **KW))
    tr = _street(pa, "cold-stream", 4)
    before = _counter_sum(port_metrics.REGISTRY.render(), "reporter_compile_total")
    SessionEngine(m, SessionStore()).match_many([dict(tr, trace=tr["trace"][:1])])
    assert _counter_sum(port_metrics.REGISTRY.render(), "reporter_compile_total") == before + 1


def test_sigterm_during_warmup_exits_zero(tmp_path):
    """A SIGTERM while the --warmup pass runs (wide rungs on six buckets)
    stops it between shapes; the engine never attaches; exit 0."""
    conf = dict(CONF, matcher={"ubodt_delta": 2000.0, "warmup_batch_sizes": [1, 64, 256],
                               "length_buckets": [16, 32, 64, 128, 256, 512]})
    proc, url, log = _spawn(tmp_path, conf, "--warmup")
    try:
        code, health = _get_json(url + "/health")
        assert code == 200 and health["warming"] is True
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
        text = b"".join(log).decode(errors="replace")
        assert "engine live" not in text and "drained; exiting" in text
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def both():
    ra = ref_build_graph_arrays(ref_grid_city(5, 5, 150.0), cell_size=100.0)
    pa = build_graph_arrays(grid_city(5, 5, 150.0), cell_size=100.0)
    return (ra, ref_build_ubodt(ra, delta=2000.0)), (pa, build_ubodt(pa, delta=2000.0))


@pytest.mark.parametrize("backend,extra", [("jax", {}), ("cpu", {}),
                                           ("jax", {"session_arena": True})])
def test_capacity_and_health_keys_equal_reference(both, backend, extra):
    """capacity_summary of the port's matcher against the reference's of
    the same kind (the device program, or the CPU baseline), and the
    /health key sets: the reference's keys, plus the port's own."""
    (ra, rub), (pa, pub) = both
    ref = RefMatcher(arrays=ra, ubodt=rub, config=RefConfig(**KW, **extra), backend=backend)
    port = SegmentMatcher(arrays=pa, ubodt=pub, config=MatcherConfig(**KW, **extra),
                          device="cpu", backend=backend)
    rc, pc = ref.capacity_summary(), port.capacity_summary()
    assert set(pc) == set(rc)
    for k in ("devices", "mesh", "max_device_batch", "max_device_points"):
        assert pc[k] == rc[k], k
    if "session_arena" in rc:
        for k in ("hot_slots", "hot_used", "devices", "hot_slots_per_chip"):
            assert pc["session_arena"][k] == rc["session_arena"][k], k
    svc, rsvc = ReporterService(port), RefService(ref)
    try:
        (code, h), (rcode, rh) = svc.handle_health(), rsvc.handle_health()
        assert code == rcode == 200
        assert set(rh) <= set(h)
        assert set(h) - set(rh) - {"ubodt_tier", "session_arena"} == PORT_EXTRA
        assert h["capacity"] == pc
        for k in ("warming", "backend", "devices", "graph_devices", "edges", "ubodt_rows",
                  "ubodt_shard", "ubodt_tiered", "degraded", "capabilities"):
            assert h[k] == rh[k], k
    finally:
        svc.close()
    # a deferred service: the same keys, null alike
    d, rd = ReporterService(None), RefService(None)
    try:
        (code, h), (rcode, rh) = d.handle_health(), rd.handle_health()
        assert code == rcode == 200 and set(rh) <= set(h)
        assert {k: h[k] for k in rh if k not in ("uptime_s", "replica")} == \
            {k: v for k, v in rh.items() if k not in ("uptime_s", "replica")}
    finally:
        d.close()
        rd.economics.stop()
