"""The port stands alone: it imports neither JAX nor anything of the
reference package ``reporter_tpu``, and its entry points refuse to run on
a CUDA device that is not there instead of falling back to the CPU."""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_RUN = r'''
import importlib.abc, sys

def blocked(name):
    return name.startswith("jax") or name == "reporter_tpu" or name.startswith("reporter_tpu.")

for mod in [m for m in sys.modules if blocked(m)]:
    del sys.modules[mod]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if blocked(name):
            raise ImportError("blocked import of %s" % name)
        return None

sys.meta_path.insert(0, Block())

import reporter_tpu_torch
import reporter_tpu_torch.convert
import reporter_tpu_torch.matching.arena
import reporter_tpu_torch.matching.session
import reporter_tpu_torch.matching.sparse
import reporter_tpu_torch.ops.diagnostics
import reporter_tpu_torch.serve.__main__
import reporter_tpu_torch.tiles.tiering
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher, SessionEngine, SessionStore
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city

arrays = build_graph_arrays(grid_city(5, 5, 150.0))
m = SegmentMatcher(arrays=arrays, device="cpu",
                   config=MatcherConfig(ubodt_delta=1500.0, length_buckets=[16],
                                        session_arena=True))
traces = [s.trace for s in TraceSynthesizer(arrays, seed=1).batch(3, 20, dt=5.0)]
out = m.match_many(traces)  # 20 points: two windows of 16 with carried state
assert len(out) == 3 and all(r["segments"] for r in out)
eng = SessionEngine(m, SessionStore())
for j in range(0, 20, 4):
    res = eng.match_many([dict(t, trace=t["trace"][j:j + 4]) for t in traces])
assert all(r["_stream"]["session"]["points_total"] == 20 for r in res)
assert m.session_arena.summary()["hot_used"] == 3
# the sparse model, calibrated: windowed, long and streaming 60 s traffic
sm = SegmentMatcher(arrays=arrays, ubodt=m.ubodt, device="cpu",
                    config=MatcherConfig(length_buckets=[16], sparse=True,
                                         calibration="CALIBRATION.json"))
assert sm.sparse.summary()["calibrated"]
# one fix a minute: the 5 s traces' points, 60 s apart
sparse = [dict(t, uuid=t["uuid"] + "-60", trace=[dict(p, time=p["time"] * 12.0)
                                                 for p in t["trace"]]) for t in traces[:2]]
out = sm.match_many(sparse + [dict(t, trace=t["trace"][:8]) for t in sparse])
assert all(r["segments"] for r in out) and sm.sparse.dispatch == {"ge60": 4}
eng = SessionEngine(sm, SessionStore())
res = eng.match_many([dict(t, trace=t["trace"][:4]) for t in sparse])
assert sm.sparse.dispatch == {"ge60": 6}
# the UBODT memory system: a wide32 table repacked from the cuckoo one,
# probe dedup and the sampled probe diagnostic
import os
os.environ["REPORTER_OBS_PROBE_EVERY"] = "1"
wm = SegmentMatcher(arrays=arrays, ubodt=m.ubodt, device="cpu",
                    config=MatcherConfig(ubodt_delta=1500.0, length_buckets=[16],
                                         ubodt_layout="wide32", probe_dedup=True))
assert wm.ubodt.layout == "wide32" and wm.match_many(traces) == m.match_many(traces)
short = [dict(t, trace=t["trace"][:12]) for t in traces]  # one bucketed dispatch
assert wm.match_many(short) == m.match_many(short)
assert wm.probe_stats["samples"] == 1 and wm.probe_stats["pairs"] > 0
# the log-depth (assoc) forward: windowed, long and slab session traffic
am = SegmentMatcher(arrays=arrays, ubodt=m.ubodt, device="cpu",
                    config=MatcherConfig(ubodt_delta=1500.0, length_buckets=[16],
                                         session_arena=True, viterbi_kernel="assoc"))
assert am.match_many(traces) == m.match_many(traces)
eng = SessionEngine(am, SessionStore())
for j in range(0, 20, 4):
    res = eng.match_many([dict(t, trace=t["trace"][j:j + 4]) for t in traces])
assert all(r["_stream"]["session"]["points_total"] == 20 for r in res)
# the tiered UBODT (a 2 KB hot arena), route-consistent interpolation and
# the session slab's byte budget with its cold tier
tm = SegmentMatcher(arrays=arrays, ubodt=m.ubodt, device="cpu",
                    config=MatcherConfig(ubodt_delta=1500.0, length_buckets=[16],
                                         ubodt_hot_bytes=2048, session_arena=True,
                                         session_arena_bytes=2 * 113,
                                         session_arena_cold_bytes=113))
assert tm.match_many(traces) == m.match_many(traces)
assert tm.tiering.summary()["capacity_rows"] == 4 and tm.tiering.misses > 0
ip = [dict(t, match_options={"interpolate": True}) for t in traces]
assert [len(r["segments"]) for r in tm.match_many(ip)] == \
    [len(r["segments"]) for r in m.match_many(traces)]
eng = SessionEngine(tm, SessionStore())
for j in range(0, 20, 4):
    for t in traces:
        res = eng.match_many([dict(t, trace=t["trace"][j:j + 4])])
s_ = tm.session_arena.summary()
assert (s_["hot_used"], s_["cold_used"]) == (2, 1) and s_["evictions"] > 0
# the device mesh: a dp 2 x gp 2 matcher on shared cpu ranks (the table in
# bucket ranges, the slab split over dp) and the histogram program
import torch
import reporter_tpu_torch.ops.collectives
import reporter_tpu_torch.parallel.rules
from reporter_tpu_torch.parallel import graph_sharded_match_fn, make_mesh2
mm = SegmentMatcher(arrays=arrays, ubodt=m.ubodt, device=["cpu"] * 4,
                    config=MatcherConfig(ubodt_delta=1500.0, length_buckets=[16], devices=4,
                                         graph_devices=2, session_arena=True))
assert mm._mesh.shape == {"dp": 2, "gp": 2} and mm.match_many(traces) == m.match_many(traces)
eng = SessionEngine(mm, SessionStore())
for j in range(0, 20, 4):
    res = eng.match_many([dict(t, trace=t["trace"][j:j + 4]) for t in traces])
assert all(r["_stream"]["session"]["points_total"] == 20 for r in res)
px, py, tm, valid, _t = mm._fill_rows(traces, [0, 1], 32)
fn = graph_sharded_match_fn(make_mesh2(2, 2, ["cpu"] * 4), 8, len(arrays.seg_ids))
_r, hist = fn(m._dg, m._du, *(torch.from_numpy(a) for a in (px, py, tm, valid)), m._params)
assert 0 < float(hist.point_count.sum()) <= 40
# the bench's realistic city through the PBF codec and the OSM import, the
# tile hierarchy, the CPU baseline (backend="cpu") and the brute oracle
import tempfile
import reporter_tpu_torch.baseline
import reporter_tpu_torch.tiles.hierarchy
from reporter_tpu_torch.baseline import BruteForceMatcher
from reporter_tpu_torch.synth.generator import segment_agreement
from reporter_tpu_torch.synth.osm_city import realistic_city, realistic_city_network
from reporter_tpu_torch.tiles import osm
oa = build_graph_arrays(realistic_city_network(8, 8, seed=3), cell_size=100.0)
assert oa.grid_items.shape[1] > 0 and oa.num_edges > 100
nodes, ways = realistic_city(8, 8, seed=3)
with tempfile.TemporaryDirectory() as d:
    osm.write_pbf(d + "/c.osm.pbf", nodes, ways)
    assert osm.main([d + "/c.osm.pbf", "--json", d + "/net.json"]) == 0
ou = reporter_tpu_torch.tiles.ubodt.build_ubodt(oa, delta=1500.0)
cm = SegmentMatcher(arrays=oa, ubodt=ou, config=MatcherConfig(length_buckets=[16]),
                    backend="cpu")
dm = SegmentMatcher(arrays=oa, ubodt=ou, config=MatcherConfig(length_buckets=[16]),
                    device="cpu")
syn = TraceSynthesizer(oa, seed=7).batch(3, 20, dt=5.0)
ots = [s.trace for s in syn]
assert len(cm.match_many(ots)) == 3 and all(r["segments"] for r in dm.match_many(ots))
px, py, tm_, vd, _ = dm._fill_rows(ots, [0], 20)
edge = BruteForceMatcher(oa, dm.cfg).run_batch(px, py, tm_, vd)[0]
assert 0.0 <= segment_agreement(oa, edge[0], syn[0]) <= 1.0
# service recovery: fault injection, the poison bisect, the watchdog's
# degraded CPU mode and re-attach, the session wire and the checkpointer
import threading, time
import reporter_tpu_torch.faults as faults
from reporter_tpu_torch.matching.session import SessionCheckpointer, read_checkpoints
from reporter_tpu_torch.serve.service import ReporterService
os.environ["REPORTER_FAULT_DISPATCH"] = "uuid:poison"
svc = ReporterService(m, max_wait_ms=100.0, robustness={"watchdog_s": 0})
out = {}
ths = [threading.Thread(target=lambda t=t: out.__setitem__(t["uuid"], svc.handle_report(
    dict(t, match_options={"report_levels": [0, 1], "transition_levels": [0, 1]}))))
       for t in traces[:2] + [dict(traces[2], uuid="poison")]]
[t.start() for t in ths]; [t.join() for t in ths]
assert out["poison"][0] == 500 and [out[t["uuid"]][0] for t in traces[:2]] == [200, 200]
del os.environ["REPORTER_FAULT_DISPATCH"]
svc.close()
os.environ["REPORTER_FAULT_DEVICE_HANG"] = "1.0:1"
svc = ReporterService(m, max_wait_ms=1.0, robustness={"watchdog_s": 0.2, "reattach_probe_s": 0.1})
code, body = svc.handle_report(dict(traces[0], match_options={"report_levels": [0],
                                                              "transition_levels": [0]}))
assert code == 200 and body["degraded"] is True and faults.injected("device_hang") == 1
t0 = time.monotonic()
while svc.degraded and time.monotonic() - t0 < 20:
    time.sleep(0.05)
assert not svc.degraded
del os.environ["REPORTER_FAULT_DEVICE_HANG"]
with tempfile.TemporaryDirectory() as d:
    eng = SessionEngine(m, SessionStore())
    cp = SessionCheckpointer(eng.store, d, cadence_s=0, sync=True)
    eng.match_many([dict(traces[0], trace=traces[0]["trace"][:4])])
    (w,) = read_checkpoints(d)
    assert w["carry"] is not None and w["points_total"] == 4
svc.close()
assert not [m for m in sys.modules if blocked(m)]
print("ISOLATED-OK")
'''


def test_port_imports_and_matches_with_jax_and_reference_blocked():
    r = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ISOLATED-OK" in r.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|from\s+jaxlib\b)"
    r"|reporter_tpu\.|from\s+reporter_tpu\s", re.M)


def test_no_jax_or_reference_imports_in_port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "reporter_tpu_torch")):
        files.extend(os.path.join(root, n) for n in names if n.endswith(".py"))
    hits = []
    for path in files:
        with open(path) as f:
            text = f.read()
        hits.extend("%s: %s" % (os.path.relpath(path, REPO), m.group(0).strip())
                    for m in _FORBIDDEN.finditer(text))
    assert len(files) > 20
    assert hits == []


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from reporter_tpu_torch import resolve_device
    from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
    from reporter_tpu_torch.serve.__main__ import main
    from reporter_tpu_torch.tiles.arrays import build_graph_arrays
    from reporter_tpu_torch.tiles.network import grid_city
    from reporter_tpu_torch.tiles.ubodt import build_ubodt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = build_graph_arrays(grid_city(4, 4, 150.0))
    ubodt = build_ubodt(arrays, delta=1000.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SegmentMatcher(arrays=arrays, ubodt=ubodt, config=MatcherConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        arrays.to_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ubodt.to_device()
    cfg = tmp_path / "config.json"
    cfg.write_text('{"network": {"type": "grid", "rows": 4, "cols": 4}}')
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([str(cfg), "127.0.0.1:0"])
    # the batch CLI: no card and no --device cpu is an error, not a CPU run
    from reporter_tpu_torch.batch.__main__ import main as batch_main

    (tmp_path / "arch").mkdir()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch_main(["--src", str(tmp_path / "arch"), "--match-config", str(cfg),
                    "--concurrency", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch_main(["--src", str(tmp_path / "arch"), "--match-config", str(cfg),
                    "--concurrency", "1", "--device", "cuda", "--backend", "jax"])
    # asked for explicitly, the CPU runs the plain versions
    assert SegmentMatcher(arrays=arrays, ubodt=ubodt, config=MatcherConfig(),
                          device="cpu").device.type == "cpu"


_BLOCKED_OBS = _BLOCKED_RUN[:_BLOCKED_RUN.index("import reporter_tpu_torch\n")] + r'''
import json, os, pkgutil, tempfile, threading, urllib.request
import reporter_tpu_torch.obs as obs_pkg
names = sorted(m.name for m in pkgutil.iter_modules(obs_pkg.__path__))
assert names == ["adaptive", "attrib", "economics", "flight", "log", "metrics",
                 "profiler", "quality", "quantile", "slo", "trace"], names
for n in names:
    __import__("reporter_tpu_torch.obs." + n)
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.obs import attrib
from reporter_tpu_torch.serve.service import ReporterService
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city
os.environ["REPORTER_QUALITY_SAMPLE_EVERY"] = "1"
arrays = build_graph_arrays(grid_city(5, 5, 150.0))
m = SegmentMatcher(arrays=arrays, device="cpu",
                   config=MatcherConfig(ubodt_delta=1500.0, length_buckets=[16]))
svc = ReporterService(m, max_wait_ms=1.0, robustness={"watchdog_s": 0})
server = svc.make_server("127.0.0.1", 0)
threading.Thread(target=server.serve_forever, daemon=True).start()
url = "http://127.0.0.1:%d" % server.server_address[1]
tr = TraceSynthesizer(arrays, seed=1).batch(1, 12, dt=5.0)[0].trace
tr["match_options"] = {"report_levels": [0, 1], "transition_levels": [0, 1]}
req = urllib.request.Request(url + "/report?debug=1", json.dumps(tr).encode(),
                             {"Content-Type": "application/json", "X-Reporter-Trace": "iso-1"})
with urllib.request.urlopen(req, timeout=60) as r:
    assert r.headers["X-Reporter-Trace"] == "iso-1"
    assert json.loads(r.read())["debug"]["trace_id"] == "iso-1"
assert svc.quality is not None and svc.quality.drain(30.0)
for path in ("/metrics", "/statusz", "/debug/slo", "/debug/traces", "/debug/cost",
             "/debug/history", "/debug/attrib?capture=1&reps=1"):
    with urllib.request.urlopen(url + path, timeout=120) as r:
        assert r.status == 200, path
res = attrib.last()
assert res["platform"] == "cpu" and res["stages_ms"]["candidate-sweep"] > 0
server.shutdown()
server.server_close()
svc.close()
assert not [m for m in sys.modules if blocked(m)]
print("OBS-ISOLATED-OK")
'''


def test_obs_modules_serve_with_jax_and_reference_blocked():
    """Every module of reporter_tpu_torch/obs imports with ``jax`` and
    ``reporter_tpu`` blocked, and the service answers the observability
    endpoints (an attribution capture and a quality sample included)."""
    r = subprocess.run([sys.executable, "-c", _BLOCKED_OBS], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OBS-ISOLATED-OK" in r.stdout


_BLOCKED_MODES = _BLOCKED_RUN[:_BLOCKED_RUN.index("import reporter_tpu_torch\n")] + r'''
import glob, os, pkgutil, tempfile
import reporter_tpu_torch.utils as utils_pkg
names = sorted(m.name for m in pkgutil.iter_modules(utils_pkg.__path__))
assert names == ["httppool", "journal", "retry", "shutdown"], names
import reporter_tpu_torch.anonymise
import reporter_tpu_torch.batch.__main__
import reporter_tpu_torch.stream.__main__
import reporter_tpu_torch.stream.kafka_io
from reporter_tpu_torch.batch import run_pipeline
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.native import parse_shard_bytes
from reporter_tpu_torch.stream import LocalMatcherClient
from reporter_tpu_torch.stream.checkpoint import load_file, save_file
from reporter_tpu_torch.stream.topology import build_pipeline
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.tiles.network import grid_city
m = SegmentMatcher(network=grid_city(5, 5, 150.0), device="cpu",
                   config=MatcherConfig(length_buckets=[16, 32]))
assert m.warmup(carry_chain=True) > 0
syn = TraceSynthesizer(m.arrays, seed=7)
lines = []
for v in range(3):
    for p in syn.synthesize(24, dt=15.0, sigma=3.0).trace["trace"]:
        lines.append((p["time"], "veh-%d|%d|%r|%r|%d" % (v, p["time"], p["lat"], p["lon"],
                                                          p["accuracy"])))
lines = [l for _t, l in sorted(lines)]
with tempfile.TemporaryDirectory() as d:
    pipe = build_pipeline(",sv,\\|,0,2,3,1,4", LocalMatcherClient(m), privacy=1,
                          quantisation=3600, output=d + "/stream", source="ISO",
                          microbatch_size=2)
    pipe.batcher.report_dist = 200
    for l in lines[:40]:
        pipe.feed(l, int(l.split("|")[1]) * 1000)
    save_file(pipe, d + "/s.ckpt")
    assert load_file(pipe, d + "/s.ckpt")
    for l in lines[40:]:
        pipe.feed(l, int(l.split("|")[1]) * 1000)
    pipe.close()
    assert glob.glob(d + "/stream/*/*/*/*")
    os.makedirs(d + "/arch")
    with open(d + "/arch/day0", "w") as f:
        f.write("\n".join(lines) + "\n")
    run_pipeline(m, archive_spec=d + "/arch", dest_store="dir:" + d + "/batch",
                 valuer='lambda l: tuple(l.split("|"))', time_pattern=None, privacy=1)
    assert glob.glob(d + "/batch/*/*/*/*")
    uu, *_ = parse_shard_bytes(b"a,1,2.0,3.0,4\nb,torn")
    assert uu == ["a"]
assert not [m for m in sys.modules if blocked(m)]
print("MODES-ISOLATED-OK")
'''


def test_stream_batch_anonymise_utils_run_with_jax_and_reference_blocked():
    """``stream``, ``batch``, ``anonymise`` and ``utils`` import with
    ``jax`` and ``reporter_tpu`` blocked, and a small stream pipeline (with a
    checkpoint round trip), a batch run and the matcher's warmup complete
    on the CPU."""
    r = subprocess.run([sys.executable, "-c", _BLOCKED_MODES], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "MODES-ISOLATED-OK" in r.stdout
