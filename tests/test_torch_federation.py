"""The port's fleet observability plane on the CPU: ``obs/federation.py``'s
render and merge against the JAX package's on the same snapshot dicts
(equal text, equal merge), and the reference's federation cases, ported
through the port's router over port replicas: the federated render, a
dead replica's last snapshot kept and labeled stale, the client-truth
fleet SLO and its masking debt, cross-hop trace stitching (failover and
hedge legs), ``?replica=`` proxying of /debug/attrib and /debug/profile,
the flight recorder's dump names and pinning, and the federation
consistency of two real serve processes with their shutdown dumps.

The metric registries are process-global, and other files' fleets may
have run before in this process: each fleet here has replica ids of its
own, and the checks read that fleet's samples."""

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

from reporter_tpu.obs import federation as ref_fed
from reporter_tpu.obs import metrics as ref_metrics
from reporter_tpu_torch import faults
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.obs import federation as obs_fed
from reporter_tpu_torch.obs import flight as obs_flight
from reporter_tpu_torch.obs import metrics as port_metrics
from reporter_tpu_torch.obs.quantile import hist_buckets, hist_quantile, merge_parsed, parse_metrics
from reporter_tpu_torch.obs.trace import Span
from reporter_tpu_torch.serve import router as router_mod
from reporter_tpu_torch.serve.router import FleetRouter
from reporter_tpu_torch.serve.service import ReporterService
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city
from reporter_tpu_torch.tiles.ubodt import build_ubodt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(length_buckets=[16, 32])


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for p in faults.POINTS:
        monkeypatch.delenv("REPORTER_FAULT_" + p.upper(), raising=False)
    for var in ("REPORTER_HEDGE_MS", "REPORTER_ADAPTIVE", "REPORTER_FEDERATION_PULL_S",
                "REPORTER_FEDERATION_STALE_S"):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def engine():
    arrays = build_graph_arrays(grid_city(rows=5, cols=5, spacing_m=150.0), cell_size=100.0)
    return arrays, build_ubodt(arrays, delta=2000.0)


def street_trace(arrays, uuid, row=2, n=8, t0=1000):
    nodes = [row * 5 + c for c in range(5)]
    t = np.linspace(0.05, 0.9, n)
    xs = np.interp(t, np.linspace(0, 1, 5), arrays.node_x[nodes])
    ys = np.interp(t, np.linspace(0, 1, 5), arrays.node_y[nodes])
    lat, lon = arrays.proj.to_latlon(xs, ys)
    return {"uuid": uuid,
            "trace": [{"lat": float(a), "lon": float(o), "time": t0 + 15 * i}
                      for i, (a, o) in enumerate(zip(lat, lon))],
            "match_options": {"mode": "auto", "report_levels": [0, 1],
                              "transition_levels": [0, 1]}}


class _Replica:
    def __init__(self, arrays, ubodt, rid, backend="jax"):
        self.rid = rid
        prev = os.environ.get("REPORTER_REPLICA_ID")
        os.environ["REPORTER_REPLICA_ID"] = rid
        try:
            m = SegmentMatcher(arrays=arrays, ubodt=ubodt, config=MatcherConfig(**KW),
                               device="cpu", backend=backend)
            self.svc = ReporterService(m, max_wait_ms=2.0)
        finally:
            if prev is None:
                os.environ.pop("REPORTER_REPLICA_ID", None)
            else:
                os.environ["REPORTER_REPLICA_ID"] = prev
        self.httpd = self.svc.make_server("127.0.0.1", 0)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = "http://127.0.0.1:%d" % self.httpd.server_port

    def kill(self):
        self.httpd.shutdown()
        self.httpd.close_lingering()
        self.httpd.server_close()

    def close(self):
        try:
            self.kill()
        except Exception:  # noqa: BLE001 - already killed by the test
            pass
        self.svc.close()


class _Fleet:
    def __init__(self, arrays, ubodt, prefix, n=2, router_kw=None, backends=None):
        self.replicas = [_Replica(arrays, ubodt, "%s-%d" % (prefix, i),
                                  (backends or ["jax"] * n)[i]) for i in range(n)]
        self.router = FleetRouter([r.url for r in self.replicas],
                                  **dict({"probe_interval_s": 0.2}, **(router_kw or {})))
        self.router.federator.pull_interval_s = 0.3
        self.router.federator.stale_after_s = 0.9
        self.router.start()
        self.httpd = self.router.make_server("127.0.0.1", 0)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = "http://127.0.0.1:%d" % self.httpd.server_port

    def by_id(self, rid):
        return next(r for r in self.replicas if r.rid == rid)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.router.stop()
        for r in self.replicas:
            r.close()


@pytest.fixture
def fleet_factory(engine, request):
    arrays, ubodt = engine
    fleets = []

    def make(n=2, router_kw=None, backends=None):
        # replica ids of this test's own: the gauges' children outlive it
        prefix = "fed-%s-%d" % (request.node.name[5:25], len(fleets))
        f = _Fleet(arrays, ubodt, prefix, n, router_kw, backends)
        fleets.append(f)
        return f

    yield make
    for f in fleets:
        f.close()


def post_json(url, payload, headers=None, timeout=30):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers=dict({"Content-Type": "application/json"},
                                              **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read().decode())


def get_raw(url, timeout=30):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def get_json(url, timeout=30):
    st, body = get_raw(url, timeout)
    return st, json.loads(body)


def wait_for(cond, timeout=5.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


SNAPS = {
    "rep-a": {
        "m_total": {"type": "counter", "help": "a counter", "labelnames": ["endpoint"],
                    "samples": [[["report"], 3.0], [["batch"], 0.5]]},
        "m_lat": {"type": "histogram", "help": "a hist", "labelnames": [],
                  "samples": [[[], {"buckets": [0.1, 1.0], "counts": [2, 1, 1],
                                    "sum": 1.5, "count": 4}]]},
        "m_g": {"type": "gauge", "help": "a\ngauge", "labelnames": ["k"],
                "samples": [[["x"], 1e-7], [["y"], 12345678.0]]},
    },
    'rep-"b"': {  # label escaping must hold
        "m_total": {"type": "counter", "help": "a counter", "labelnames": ["endpoint"],
                    "samples": [[["report"], 5.0]]},
        "m_lat": {"type": "histogram", "help": "a hist", "labelnames": [],
                  "samples": [[[], {"buckets": [0.1, 1.0], "counts": [0, 3, 2],
                                    "sum": 9.25, "count": 5}]]},
        "m_g": {"type": "counter", "help": "mixed-version odd one out", "labelnames": [],
                "samples": [[[], 2.0]]},
    },
}


@pytest.mark.parametrize("skip", [None, {"m_total"}, {"m_lat", "m_g"}])
def test_render_and_merge_equal_reference(skip):
    """render_snapshots (skip_meta included) and the registry merge over
    the same snapshot dicts: the same text and the same merged dict."""
    assert obs_fed.render_snapshots(SNAPS, skip_meta=skip) == ref_fed.render_snapshots(
        SNAPS, skip_meta=skip)
    same = {k: {n: f for n, f in v.items() if n != "m_g"} for k, v in SNAPS.items()}
    assert port_metrics.merge(*same.values()) == ref_metrics.merge(*same.values())
    for name, labels in (("m_total", ("report",)), ("m_g", ("x",)), ("m_lat", ())):
        for snap in SNAPS.values():
            assert obs_fed.snapshot_scalar(snap, name, labels) == ref_fed.snapshot_scalar(
                snap, name, labels)
            assert obs_fed.snapshot_total(snap, name) == ref_fed.snapshot_total(snap, name)
            assert obs_fed.snapshot_total(snap, name, {"endpoint": "report"}) == \
                ref_fed.snapshot_total(snap, name, {"endpoint": "report"})


# -- the reference's cases, ported -----------------------------------------------


def test_render_snapshots_unit():
    snaps = {k: {n: f for n, f in v.items() if n != "m_g"} for k, v in SNAPS.items()}
    m = parse_metrics(obs_fed.render_snapshots(snaps))
    assert m["m_total"][(("endpoint", "report"), ("replica", "rep-a"))] == 3.0
    assert m["m_total"][(("endpoint", "report"), ("replica", 'rep-\\"b\\"'))] == 5.0
    # cumulative histogram buckets with the replica label on every line
    assert hist_buckets(m, "m_lat", match={"replica": "rep-a"}) == [
        (0.1, 2.0), (1.0, 3.0), (float("inf"), 4.0)]
    assert m["m_lat_count"][(("replica", "rep-a"),)] == 4.0
    text2 = obs_fed.render_snapshots(snaps, skip_meta={"m_total"})
    assert "# TYPE m_total" not in text2 and 'm_total{replica="rep-a"' in text2


def test_merge_parsed_sums_across_targets():
    a = parse_metrics('x_total 3\nh_bucket{le="0.1"} 1\nh_bucket{le="+Inf"} 2\n')
    b = parse_metrics('x_total 4\nh_bucket{le="0.1"} 2\nh_bucket{le="+Inf"} 3\n')
    m = merge_parsed([a, b])
    assert m["x_total"][()] == 7.0
    assert hist_buckets(m, "h") == [(0.1, 3.0), (float("inf"), 5.0)]
    fed = parse_metrics('h_bucket{replica="r0",le="0.1"} 1\nh_bucket{replica="r0",le="+Inf"} 2\n'
                        'h_bucket{replica="r1",le="0.1"} 3\nh_bucket{replica="r1",le="+Inf"} 5\n')
    assert hist_buckets(fed, "h", merge_children=True) == [(0.1, 4.0), (float("inf"), 7.0)]
    assert hist_quantile(hist_buckets(fed, "h", merge_children=True), 0.5) is not None


def test_router_metrics_federated(engine, fleet_factory):
    arrays, _ = engine
    fleet = fleet_factory(n=2)
    ids = {r.rid for r in fleet.replicas}
    for k in range(6):
        assert post_json(fleet.url + "/report", street_trace(arrays, "veh-%d" % k))[0] == 200
    st, text = get_raw(fleet.url + "/metrics?pull=1")
    assert st == 200
    for rid in ids:
        assert 'replica="%s"' % rid in text
    # the router's own families render once: no duplicated # TYPE metadata
    tnames = [line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")]
    assert len(tnames) == len(set(tnames))
    m = parse_metrics(text)
    assert "reporter_fleet_slo_requests_total" in m
    assert "reporter_fleet_slo_masking_debt" in m
    ages = {dict(lv)["replica"]: v
            for lv, v in m["reporter_federation_snapshot_age_seconds"].items()}
    assert ids <= set(ages) and all(ages[r] >= 0 for r in ids)


def test_dead_replica_snapshot_kept_and_labeled_stale(engine, fleet_factory):
    arrays, _ = engine
    fleet = fleet_factory(n=2)
    for k in range(4):
        assert post_json(fleet.url + "/report", street_trace(arrays, "veh-%d" % k))[0] == 200
    fleet.router.federator.pull_all()
    victim = fleet.replicas[1]
    victim.kill()
    key = (("replica", victim.rid),)

    def stale():
        m = parse_metrics(get_raw(fleet.url + "/metrics?pull=1")[1])
        return m if m["reporter_federation_snapshot_stale"].get(key) == 1.0 else None

    assert wait_for(stale, timeout=5.0, step=0.1)
    m = stale()
    age1 = m["reporter_federation_snapshot_age_seconds"][key]
    assert age1 > 0.9
    # the final snapshot is still in the render: dead, not dropped
    assert any(dict(lv).get("replica") == victim.rid for lv in m["reporter_requests_total"])
    assert wait_for(lambda: parse_metrics(get_raw(fleet.url + "/metrics?pull=1")[1])[
        "reporter_federation_snapshot_age_seconds"][key] > age1)
    m2 = parse_metrics(get_raw(fleet.url + "/metrics?pull=1")[1])
    assert m2["reporter_federation_snapshot_stale"][(("replica", fleet.replicas[0].rid),)] \
        == 0.0


def test_failover_masked_request_is_fleet_good_replica_bad(engine, fleet_factory):
    arrays, _ = engine
    # probed once at start only: a probe that saw the drain first would
    # route around the primary, and no replica would refuse anything
    fleet = fleet_factory(n=2, router_kw={"probe_interval_s": 3600.0})
    uuid = next("veh-m%d" % k for k in range(64)
                if fleet.router.ranked("veh-m%d" % k)[0].url == fleet.replicas[0].url)
    assert post_json(fleet.url + "/report", street_trace(arrays, uuid))[0] == 200
    # the primary drains: its 503 burns its own budget while the router
    # fails over and the client sees a clean 200
    fleet.replicas[0].svc.begin_drain()
    st, hd, _b = post_json(fleet.url + "/report", street_trace(arrays, uuid))
    assert st == 200 and hd["X-Reporter-Replica"] == fleet.replicas[1].rid
    fleet.router.federator.pull_all()
    st, slo = get_json(fleet.url + "/debug/slo")
    assert st == 200 and slo["scope"] == "fleet"
    rep = slo["routes"]["report"]
    assert rep["bad"] == 0 and rep["good"] >= 2
    assert slo["masking_debt"]["availability"] > 0
    st, statusz = get_json(fleet.url + "/statusz")
    assert statusz["masking_debt"]["availability"] > 0
    m = parse_metrics(get_raw(fleet.url + "/metrics")[1])
    assert m["reporter_fleet_slo_masking_debt"][(("objective", "availability"),)] > 0


def test_injected_replica_shed_is_masked_and_billed(engine, fleet_factory, monkeypatch):
    arrays, _ = engine
    fleet = fleet_factory(n=2)
    monkeypatch.setenv("REPORTER_FAULT_REPLICA_SHED", "1")
    faults.reset()
    st, hd, _b = post_json(fleet.url + "/report", street_trace(arrays, "veh-shed"))
    assert st == 200  # masked: the shed never reached the client
    tid = hd["X-Reporter-Trace"]
    fleet.router.federator.pull_all()
    assert get_json(fleet.url + "/debug/slo")[1]["masking_debt"]["availability"] > 0
    st, out = get_json(fleet.url + "/debug/traces?id=%s" % tid)
    assert st == 200
    hops = out["stitched"]["hops"]
    assert any(h["outcome"] == "429" for h in hops) and any(h["outcome"] == "200"
                                                            for h in hops)


def test_stitched_trace_for_failed_over_request(engine, fleet_factory, monkeypatch):
    arrays, _ = engine
    fleet = fleet_factory(n=2)
    monkeypatch.setenv("REPORTER_FAULT_ROUTER_CONNECT", "refused:1")
    st, hd, _b = post_json(fleet.url + "/report", street_trace(arrays, "veh-stitch"))
    assert st == 200
    tid = hd["X-Reporter-Trace"]
    st, out = get_json(fleet.url + "/debug/traces?id=%s" % tid)
    assert st == 200
    stitched = out["stitched"]
    hops = stitched["hops"]
    assert len([h for h in hops if h["span"] == "dispatch"]) >= 2
    assert any("error" in h["outcome"] for h in hops)
    assert any(h["outcome"] == "200" for h in hops)
    assert stitched["attempts"] >= 2
    # the serving replica's span tree, pinned by the failover's keep hint
    children = stitched["children"]
    assert children and any(e.get("endpoint") == "report" for e in children)
    assert all(e["trace_id"] == tid for e in children)
    assert any(e.get("flight_keep") == "failover" for e in children)
    assert "total_s" in stitched["timings"] and "ranking_s" in stitched["timings"]


def test_stitched_hedge_marks_cancelled_leg(engine, fleet_factory, monkeypatch):
    arrays, _ = engine
    fleet = fleet_factory(n=2, router_kw={"hedge_ms": 100.0})
    monkeypatch.setenv("REPORTER_FAULT_REPLICA_SLOW_ACCEPT", "1.2:1")
    st, hd, _b = post_json(fleet.url + "/report", street_trace(arrays, "veh-hedge"))
    assert st == 200
    st, out = get_json(fleet.url + "/debug/traces?id=%s" % hd["X-Reporter-Trace"])
    assert st == 200
    hops = out["stitched"]["hops"]
    assert any(h["span"] == "hedge" and h["outcome"] == "200" for h in hops)
    assert any(h.get("cancelled") for h in hops)


def test_trace_by_id_on_replica_and_404(engine, fleet_factory):
    arrays, _ = engine
    fleet = fleet_factory(n=2)
    st, hd, _b = post_json(fleet.url + "/report", street_trace(arrays, "veh-byid"),
                           headers={"X-Reporter-Flight-Keep": "test"})
    assert st == 200
    tid = hd["X-Reporter-Trace"]
    rep = fleet.by_id(hd["X-Reporter-Replica"])
    st, out = get_json(rep.url + "/debug/traces?id=%s" % tid)
    assert st == 200 and out["trace_id"] == tid
    assert out["traces"] and out["traces"][0]["trace_id"] == tid
    assert out["traces"][0]["flight_keep"] == "test"
    st, out = get_json(rep.url + "/debug/traces?id=no-such-trace")
    assert st == 404 and out["traces"] == []
    assert get_json(fleet.url + "/debug/traces?id=no-such-trace")[0] == 404


def test_router_debug_replica_selector(fleet_factory):
    # the second replica is the CPU baseline, whose profile answers 501
    fleet = fleet_factory(n=2, backends=["jax", "cpu"])
    ids = [r.rid for r in fleet.replicas]
    st, out = get_json(fleet.url + "/debug/attrib")
    assert st == 400 and set(out["replicas"]) == set(ids)
    st, out = get_json(fleet.url + "/debug/attrib?replica=nope")
    assert st == 404 and ids[0] in out["replicas"]
    st, out = get_json(fleet.url + "/debug/attrib?replica=%s" % ids[0])
    assert st == 200 and "summary" in out
    # the replica's answer passes through verbatim
    st, out = get_json(fleet.url + "/debug/profile?replica=%s" % ids[1])
    assert st == 501 and "device backend" in out["error"]


def test_flight_dump_name_embeds_replica_id(monkeypatch, tmp_path):
    monkeypatch.setenv("REPORTER_REPLICA_ID", "rep/odd id")
    assert obs_flight.default_dump_name().startswith("reporter_flight_rep_odd_id_")
    monkeypatch.delenv("REPORTER_REPLICA_ID")
    assert obs_flight.default_dump_name() == "reporter_flight_%d.json" % os.getpid()
    monkeypatch.setenv("REPORTER_REPLICA_ID", "rep-9")
    rec = obs_flight.FlightRecorder(capacity=4, slow_ms=0)
    span = Span("t")
    span.finish()
    rec.record(span)
    out = rec.dump(str(tmp_path))
    assert out is not None and os.path.basename(out).startswith("reporter_flight_rep-9_")
    with open(out) as f:
        assert json.load(f)["traces"]


def test_pinned_flight_decision():
    rec = obs_flight.FlightRecorder(capacity=8, slow_ms=10_000, sample_every=1_000_000)
    span = Span("t")
    span.meta["flight_keep"] = "failover"
    span.finish()
    assert rec.record(span) == "pinned"
    plain = Span("t2")
    plain.finish()
    assert rec.record(plain) == "dropped"
    assert rec.find(span.trace_id)[0]["flight_keep"] == "failover"


def _bound_port(proc, timeout=90):
    buf = b""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stderr.readline()
        if not line:
            assert proc.poll() is None, buf.decode(errors="replace")
            continue
        buf += line
        if b"on 127.0.0.1:" in line:
            threading.Thread(target=proc.stderr.read, daemon=True).start()
            return int(line.split(b"on 127.0.0.1:")[1].split()[0])
    raise AssertionError(buf.decode(errors="replace"))


def test_subprocess_fleet_consistency_and_dump_isolation(engine, tmp_path):
    """Two real serve processes behind an in-process router: the federated
    per-replica ``reporter_requests_total`` equals the client-observed
    split by X-Reporter-Replica, and their SIGTERM flight dumps land in
    one shared directory under distinct replica-tagged names."""
    arrays, _ = engine
    conf = {"network": {"type": "grid", "rows": 5, "cols": 5, "spacing_m": 150.0},
            "matcher": {"ubodt_delta": 2000.0, "length_buckets": [16, 32]},
            "batch": {"max_batch": 64, "max_wait_ms": 2}, "warmup": False}
    conf_path = tmp_path / "config.json"
    conf_path.write_text(json.dumps(conf))
    dump_dir = tmp_path / "dumps"
    dump_dir.mkdir()
    procs = []
    try:
        for i in range(2):
            env = dict(os.environ, PYTHONPATH=REPO, REPORTER_REPLICA_ID="sub-rep-%d" % i,
                       REPORTER_FLIGHT_DUMP=str(dump_dir), REPORTER_FLIGHT_SLOW_MS="0",
                       REPORTER_DRAIN_GRACE_S="10")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "reporter_tpu_torch.serve", "--device", "cpu",
                 str(conf_path), "127.0.0.1:0"], cwd=str(tmp_path), env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
        urls = ["http://127.0.0.1:%d" % _bound_port(p) for p in procs]
        for u in urls:
            assert wait_for(lambda: get_json(u + "/health")[1].get("backend"), timeout=120,
                            step=0.2)
        router = FleetRouter(urls, probe_interval_s=0.2)
        router.start()
        httpd = router.make_server("127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        rurl = "http://127.0.0.1:%d" % httpd.server_port
        shed0 = router_mod.C_SHED.value  # the counter is process-global
        try:
            observed = {}
            n = 14
            for k in range(n):
                st, hd, _b = post_json(rurl + "/report", street_trace(arrays, "veh-%d" % k))
                assert st == 200
                observed[hd["X-Reporter-Replica"]] = observed.get(
                    hd["X-Reporter-Replica"], 0) + 1
            assert set(observed) == {"sub-rep-0", "sub-rep-1"}
            m = parse_metrics(get_raw(rurl + "/metrics?pull=1")[1])
            federated = {}
            for lv, v in m["reporter_requests_total"].items():
                d = dict(lv)
                # only the replica-labeled samples: this process's own
                # registry renders the family too
                if d.get("replica") in observed and d.get("endpoint") == "report":
                    federated[d["replica"]] = federated.get(d["replica"], 0) + int(v)
            shed = m.get("reporter_router_shed_total", {}).get((), 0) - shed0
            assert sum(federated.values()) + int(shed) == n
            assert federated == observed
        finally:
            httpd.shutdown()
            httpd.server_close()
            router.stop()
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            assert p.wait(timeout=30) == 0
        dumps = sorted(f.name for f in dump_dir.iterdir())
        assert len(dumps) == 2, dumps
        assert dumps[0].startswith("reporter_flight_sub-rep-0_")
        assert dumps[1].startswith("reporter_flight_sub-rep-1_")
        for f in dump_dir.iterdir():
            with open(f) as fh:
                assert json.load(fh)["traces"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
