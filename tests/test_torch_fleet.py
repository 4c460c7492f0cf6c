"""The port's fleet router (``reporter_tpu_torch.serve.router``) over the
port's replicas on the CPU, against the JAX package's router: the
rendezvous scores, ``ranked`` and ``route_order`` of both routers over the
same urls, capacities, shards and geo settings give the same orders; the
same /report and /trace_attributes_batch requests (JSON, gzip and the
binary columnar frames) through the port's router in front of port
replicas and through the reference's router in front of reference
replicas give the same bodies; and the reference's fleet cases, ported:
affinity and ``X-Reporter-Replica``, kill failover with bounded remap,
drain and rolling restart, connect refused, flap debounce, hedging,
shedding, 503 with no replica, draining vs unhealthy, connection reuse,
a stale keep-alive, the SIGTERM drain of a serve process, geo off and
on.  Port replicas run ``SegmentMatcher(..., device="cpu")``; every wait
is on a condition with a deadline, every socket binds port 0."""

import gzip
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

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.serve import router as ref_router_mod
from reporter_tpu.serve import wire as ref_wire
from reporter_tpu.serve.service import ReporterService as RefService
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch import faults
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.serve import router as router_mod
from reporter_tpu_torch.serve import wire
from reporter_tpu_torch.serve.router import FleetRouter, Replica, rendezvous_score
from reporter_tpu_torch.serve.service import ReporterService
from reporter_tpu_torch.stream.client import _post_json
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city
from reporter_tpu_torch.tiles.ubodt import build_ubodt
from reporter_tpu_torch.utils.httppool import C_CONN_OPENED, C_CONN_REUSED, HttpPool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(length_buckets=[16, 32])


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for p in faults.POINTS:
        monkeypatch.delenv("REPORTER_FAULT_" + p.upper(), raising=False)
    for var in ("REPORTER_ROUTER_GEO", "REPORTER_ROUTER_GEO_CELL_DEG", "REPORTER_HEDGE_MS",
                "REPORTER_ADAPTIVE", "REPORTER_WIRE"):
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
    """One in-process port replica with a pinned replica id; ``make``
    builds its service (the reference's class for the differential)."""

    def __init__(self, rid, make, port=0):
        self.rid = rid
        prev = os.environ.get("REPORTER_REPLICA_ID")
        os.environ["REPORTER_REPLICA_ID"] = rid
        try:
            self.svc = make()
        finally:
            if prev is None:
                os.environ.pop("REPORTER_REPLICA_ID", None)
            else:
                os.environ["REPORTER_REPLICA_ID"] = prev
        self.httpd = self.svc.make_server("127.0.0.1", port)
        self.port = self.httpd.server_port
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = "http://127.0.0.1:%d" % self.port

    def kill(self):
        """Stop accepting and cut every live connection (a SIGKILL's
        socket teardown, as the router sees it)."""
        self.httpd.shutdown()
        self.httpd.close_lingering()
        self.httpd.server_close()

    def close(self):
        try:
            self.kill()
        except Exception:  # noqa: BLE001 - already killed by the test
            pass
        close = getattr(self.svc, "close", None)
        if close is not None:
            close()


def port_replica(arrays, ubodt, rid, port=0, **svc_kw):
    return _Replica(rid, lambda: ReporterService(
        SegmentMatcher(arrays=arrays, ubodt=ubodt, config=MatcherConfig(**KW), device="cpu"),
        max_wait_ms=2.0, **svc_kw), port)


class _Fleet:
    def __init__(self, replicas, router_cls=FleetRouter, router_kw=None):
        self.replicas = replicas
        self.router = router_cls([r.url for r in replicas], probe_interval_s=0.2,
                                 **(router_kw or {}))
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
def fleet_factory(engine):
    arrays, ubodt = engine
    fleets = []

    def make(n=3, router_kw=None, **svc_kw):
        f = _Fleet([port_replica(arrays, ubodt, "rep-%d" % i, **svc_kw) for i in range(n)],
                   router_kw=router_kw)
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


def get_json(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read().decode())


def wait_for(cond, timeout=5.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


# -- the differentials ----------------------------------------------------------

URLS = ["http://127.0.0.1:%d" % p for p in (19001, 19002, 19003, 19004)]
RANK_CASES = {
    # (capacity devices per replica, shards per replica, geo flag)
    "plain": ((None,) * 4, (None,) * 4, False),
    "weighted": ((1, 4, 2, None), (None,) * 4, False),
    "geo on": ((None,) * 4, ("0/4", "1/4", "2/4", "3/4"), True),
    "geo and weights": ((2, 1, 8, 1), ("0/2", "1/2", "0/2", "junk"), True),
    "geo off, shards": ((None,) * 4, ("0/4", "1/4", "2/4", "3/4"), False),
}


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_ranking_equals_reference(case, monkeypatch):
    """rendezvous_score, geo_cell, ``ranked`` and ``route_order`` of both
    routers over the same urls, capacities, shards, states and
    REPORTER_ROUTER_GEO settings: equal scores and equal orders."""
    devices, shards, geo_on = RANK_CASES[case]
    if geo_on:
        monkeypatch.setenv("REPORTER_ROUTER_GEO", "1")
        monkeypatch.setenv("REPORTER_ROUTER_GEO_CELL_DEG", "0.1")
    routers = [FleetRouter(URLS, probe_interval_s=3600.0),
               ref_router_mod.FleetRouter(URLS, probe_interval_s=3600.0)]
    try:
        for rt in routers:
            assert rt.geo_routing is geo_on
            for r, d, sh, st in zip(rt.replicas, devices, shards,
                                    ("healthy", "healthy", "unhealthy", "healthy")):
                r.capacity = None if d is None else {"devices": d}
                r.shard = sh
                r.state = st
        rng = np.random.default_rng(19)
        for k in range(200):
            uuid = "veh-%d-%d" % (k, rng.integers(1 << 30))
            lat, lon = float(rng.uniform(-60, 60)), float(rng.uniform(-170, 170))
            assert rendezvous_score(uuid, URLS[k % 4]) == ref_router_mod.rendezvous_score(
                uuid, URLS[k % 4])
            assert router_mod.geo_cell(lat, lon, 0.1) == ref_router_mod.geo_cell(lat, lon, 0.1)
            geo = (lat, lon) if k % 2 else None
            p_rank, r_rank = (rt.ranked(uuid, geo) for rt in routers)
            assert [r.url for r in p_rank] == [r.url for r in r_rank], (case, uuid)
            (p_ord, p_rm), (r_ord, r_rm) = (rt.route_order(uuid, geo) for rt in routers)
            assert [r.url for r in p_ord] == [r.url for r in r_ord] and p_rm == r_rm
    finally:
        for rt in routers:
            rt.stop()


def ref_replica(arrays, ubodt, rid):
    return _Replica(rid, lambda: RefService(
        RefMatcher(arrays=arrays, ubodt=ubodt, config=RefConfig(**KW), backend="jax"),
        max_wait_ms=2.0))


def _raw_post(url, data, headers):
    req = urllib.request.Request(url, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_bodies_through_both_routers_equal(engine):
    """The same /report and /trace_attributes_batch requests (JSON, gzip,
    the binary frames both ways) through the port's router in front of
    two port replicas and through the reference's router in front of two
    reference replicas: the same status and the same body (the frames
    byte for byte), and each router's X-Reporter-Replica stable per
    uuid."""
    arrays, ubodt = engine
    ra = ref_build_graph_arrays(ref_grid_city(5, 5, 150.0), cell_size=100.0)
    rub = ref_build_ubodt(ra, delta=2000.0)
    port = _Fleet([port_replica(arrays, ubodt, "rep-%d" % i) for i in range(2)])
    ref = _Fleet([ref_replica(ra, rub, "rep-%d" % i) for i in range(2)],
                 router_cls=ref_router_mod.FleetRouter)
    try:
        traces = [street_trace(arrays, "veh-b%d" % k, row=k % 5, n=6 + 3 * k)
                  for k in range(5)]
        js = {"Content-Type": "application/json"}
        requests = [("/report", json.dumps(t).encode(), js) for t in traces]
        batch = json.dumps({"traces": traces}).encode()
        requests += [
            ("/trace_attributes_batch", batch, js),
            ("/trace_attributes_batch", gzip.compress(batch),
             dict(js, **{"Content-Encoding": "gzip"})),
            ("/trace_attributes_batch", wire.encode_request({"traces": traces}),
             {"Content-Type": wire.CONTENT_TYPE, "Accept": wire.CONTENT_TYPE}),
            ("/report", wire.encode_request(traces[2]),
             {"Content-Type": wire.CONTENT_TYPE, "Accept": wire.CONTENT_TYPE}),
            ("/trace_attributes_batch", batch, {"Content-Type": "application/json",
                                                "Accept": wire.CONTENT_TYPE}),
            ("/report", json.dumps(dict(traces[0], uuid=None)).encode(), js),
        ]
        assert wire.encode_request({"traces": traces}) == ref_wire.encode_request(
            {"traces": traces})
        seen = {"port": {}, "ref": {}}
        for path, data, hdrs in requests * 2:
            (pc, ph, pb), (rc, rh, rb) = (_raw_post(f.url + path, data, hdrs)
                                          for f in (port, ref))
            assert pc == rc, (path, pc, rc, pb[:200], rb[:200])
            assert ph.get("Content-Type") == rh.get("Content-Type"), path
            if ph.get("Content-Type") == wire.CONTENT_TYPE:
                assert pb == rb, path
            else:
                assert json.loads(pb) == json.loads(rb), path
            for side, h in (("port", ph), ("ref", rh)):
                key = (path, data)
                rid = h.get("X-Reporter-Replica")
                if pc == 200:
                    assert seen[side].setdefault(key, rid) == rid
    finally:
        port.close()
        ref.close()


# -- the reference's cases, ported ---------------------------------------------


def test_rendezvous_remap_confined_to_lost_replica():
    urls = ["http://h%d:8000" % i for i in range(5)]
    uuids = ["veh-%04d" % i for i in range(400)]

    def top(uuid, pool):
        return max(pool, key=lambda u: rendezvous_score(uuid, u))

    before = {u: top(u, urls) for u in uuids}
    survivors = [u for u in urls if u != urls[2]]
    after = {u: top(u, survivors) for u in uuids}
    moved = {u for u in uuids if before[u] != after[u]}
    # exactly the dead replica's vehicles move, spread over the survivors
    assert moved == {u for u in uuids if before[u] == urls[2]}
    assert moved and len({after[u] for u in moved}) > 1


def test_affinity_stable_and_replica_header(engine, fleet_factory):
    arrays, _ = engine
    fleet = fleet_factory()
    st, _hd, health = get_json(fleet.url + "/health")
    assert st == 200 and health["available"] == 3
    seen = {}
    for k in range(12):
        u = "veh-%d" % k
        st, hd, _body = post_json(fleet.url + "/report", street_trace(arrays, u))
        assert st == 200 and hd.get("X-Reporter-Replica") in ("rep-0", "rep-1", "rep-2")
        seen[u] = hd["X-Reporter-Replica"]
    assert len(set(seen.values())) > 1  # traffic spreads
    for u, rid in seen.items():
        st, hd, _body = post_json(fleet.url + "/report", street_trace(arrays, u))
        assert st == 200 and hd["X-Reporter-Replica"] == rid
    # the batch route follows its first trace's uuid
    st, hd, body = post_json(fleet.url + "/trace_attributes_batch",
                             {"traces": [street_trace(arrays, "veh-0")] * 2})
    assert st == 200 and len(body["results"]) == 2
    assert hd["X-Reporter-Replica"] == seen["veh-0"]


def test_kill_mid_load_failover_and_bounded_remap(engine, fleet_factory):
    arrays, _ = engine
    fleet = fleet_factory()
    uuids = ["veh-%d" % k for k in range(18)]
    before = {}
    for u in uuids:
        st, hd, _ = post_json(fleet.url + "/report", street_trace(arrays, u))
        assert st == 200
        before[u] = hd["X-Reporter-Replica"]
    dead_rid = before[uuids[0]]
    fleet.by_id(dead_rid).kill()
    after = {}
    for u in uuids:  # no failed request in the failover window
        st, hd, _ = post_json(fleet.url + "/report", street_trace(arrays, u))
        assert st == 200, u
        after[u] = hd["X-Reporter-Replica"]
    assert {u for u in uuids if after[u] != before[u]} == {
        u for u in uuids if before[u] == dead_rid}
    assert dead_rid not in after.values()
    assert wait_for(lambda: get_json(fleet.url + "/health")[2]["available"] == 2)


def test_drain_rotates_off_and_rolling_restart_returns(engine, fleet_factory):
    arrays, ubodt = engine
    fleet = fleet_factory()
    uuids = ["veh-%d" % k for k in range(12)]
    before = {}
    for u in uuids:
        st, hd, _ = post_json(fleet.url + "/report", street_trace(arrays, u))
        assert st == 200
        before[u] = hd["X-Reporter-Replica"]
    target_rid = before[uuids[0]]
    target = fleet.by_id(target_rid)
    target.svc.begin_drain()
    st, _hd, body = get_json(target.url + "/health")
    assert st == 503 and body["status"] == "draining"
    st, hd, body = post_json(target.url + "/report", street_trace(arrays, uuids[0]))
    assert st == 503 and body.get("status") == "draining"
    assert int(hd.get("Retry-After", 0)) >= 1
    # through the router its vehicles keep succeeding, nobody else moves
    for u in uuids:
        st, hd, _ = post_json(fleet.url + "/report", street_trace(arrays, u))
        assert st == 200, u
        if before[u] != target_rid:
            assert hd["X-Reporter-Replica"] == before[u]
        else:
            assert hd["X-Reporter-Replica"] != target_rid
    rep = next(r for r in fleet.router.replicas if (r.id or "") == target_rid)
    assert wait_for(lambda: rep.state == "draining")
    # rolling restart: a fresh replica binds the same port; the vehicle
    # comes back to its primary
    port = target.port
    target.kill()
    replacement = port_replica(arrays, ubodt, target_rid, port=port)
    try:
        def back():
            fleet.router.probe_all()
            return rep.available()

        assert wait_for(back, step=0.1)
        st, hd, _ = post_json(fleet.url + "/report", street_trace(arrays, uuids[0]))
        assert st == 200 and hd["X-Reporter-Replica"] == target_rid
    finally:
        replacement.close()


def test_router_connect_refused_absorbed_by_failover(engine, fleet_factory, monkeypatch):
    arrays, _ = engine
    fleet = fleet_factory()
    n0 = router_mod.C_FAILOVER.labels("network").value
    monkeypatch.setenv("REPORTER_FAULT_ROUTER_CONNECT", "refused:1")
    st, _hd, _ = post_json(fleet.url + "/report", street_trace(arrays, "veh-0"))
    assert st == 200  # the injected refusal never reached the client
    assert router_mod.C_FAILOVER.labels("network").value >= n0 + 1


def test_health_flap_is_debounced_then_sustained_failure_ejects(fleet_factory, monkeypatch):
    fleet = fleet_factory()
    first = fleet.router.replicas[0]
    assert first.available()
    # one flapped probe: below the unhealthy_after=2 debounce
    monkeypatch.setenv("REPORTER_FAULT_HEALTH_FLAP", "1")
    fleet.router.probe_all()
    assert first.available() and first.state == "healthy"
    monkeypatch.setenv("REPORTER_FAULT_HEALTH_FLAP", "always")
    faults.reset()
    fleet.router.probe_all()
    fleet.router.probe_all()
    assert first.state == "unhealthy" and not first.available()
    # recovery is debounced too (healthy_after=2)
    monkeypatch.delenv("REPORTER_FAULT_HEALTH_FLAP")
    fleet.router.probe_all()
    assert first.state == "unhealthy"
    fleet.router.probe_all()
    assert first.state == "healthy" and first.available()


def test_slow_accept_is_hedged_around(engine, fleet_factory, monkeypatch):
    arrays, _ = engine
    fleet = fleet_factory(router_kw={"hedge_ms": 100.0})
    hedges0, wins0 = router_mod.C_HEDGES.value, router_mod.C_HEDGE_WINS.value
    # the primary's next /report stalls 1.2 s at the door; the hedge fires
    # at 100 ms and the second-ranked replica answers
    monkeypatch.setenv("REPORTER_FAULT_REPLICA_SLOW_ACCEPT", "1.2:1")
    t0 = time.monotonic()
    st, _hd, _ = post_json(fleet.url + "/report", street_trace(arrays, "veh-7"))
    took = time.monotonic() - t0
    assert st == 200
    assert took < 1.0, "the hedge did not cut the straggler (took %.2f s)" % took
    assert router_mod.C_HEDGES.value >= hedges0 + 1
    assert router_mod.C_HEDGE_WINS.value >= wins0 + 1


def test_router_sheds_when_saturated(engine, fleet_factory, monkeypatch):
    arrays, _ = engine
    fleet = fleet_factory(router_kw={"max_inflight": 1})
    shed0 = router_mod.C_SHED.value
    monkeypatch.setenv("REPORTER_FAULT_REPLICA_SLOW_ACCEPT", "0.8:1")
    results = []
    t1 = threading.Thread(target=lambda: results.append(
        post_json(fleet.url + "/report", street_trace(arrays, "veh-1"))))
    t1.start()
    # the slow request holds the only slot
    assert wait_for(lambda: router_mod.G_INFLIGHT._default().value >= 1, step=0.01)
    st, hd, _body = post_json(fleet.url + "/report", street_trace(arrays, "veh-2"))
    t1.join()
    assert st == 429 and int(hd.get("Retry-After", 0)) >= 1
    assert router_mod.C_SHED.value >= shed0 + 1
    assert results[0][0] == 200  # the admitted request still succeeded


def test_no_replica_available_is_503():
    router = FleetRouter(["http://127.0.0.1:9"])  # the discard port: refused
    router.probe_all()
    httpd = router.make_server("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://127.0.0.1:%d" % httpd.server_port
    try:
        st, _hd, body = get_json(url + "/health")
        assert st == 503 and body["status"] == "unavailable"
        st, hd, _body = post_json(url + "/report",
                                  {"uuid": "v", "trace": [], "match_options": {}})
        assert st == 503 and int(hd.get("Retry-After", 0)) >= 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        router.stop()


def test_health_draining_vs_unhealthy_statuses(engine):
    arrays, ubodt = engine
    rep = port_replica(arrays, ubodt, "rep-x")
    try:
        st, body = rep.svc.handle_health()
        assert st == 200 and body["status"] == "ok" and body["replica"] == "rep-x"
        rep.svc.unhealthy_reason = "batcher thread died: boom"
        st, body = rep.svc.handle_health()
        assert st == 503 and body["status"] == "unhealthy"
        rep.svc.unhealthy_reason = None
        rep.svc.begin_drain()
        st, body = rep.svc.handle_health()
        assert st == 503 and body["status"] == "draining"
        # unhealthy outranks draining
        rep.svc.unhealthy_reason = "batcher thread died: boom"
        st, body = rep.svc.handle_health()
        assert st == 503 and body["status"] == "unhealthy"
    finally:
        rep.close()


def test_connection_reuse_is_real_and_counted(engine):
    arrays, ubodt = engine
    rep = port_replica(arrays, ubodt, "rep-ka")
    try:
        opened0 = C_CONN_OPENED.labels("matcher").value
        reused0 = C_CONN_REUSED.labels("matcher").value
        for k in range(6):
            out = _post_json(rep.url + "/report", street_trace(arrays, "veh-%d" % k))
            assert out is not None and "segment_matcher" in out
        # six sequential requests: one connect, five keep-alive reuses
        assert C_CONN_OPENED.labels("matcher").value - opened0 == 1
        assert C_CONN_REUSED.labels("matcher").value - reused0 >= 5
    finally:
        rep.close()


def test_pool_recovers_transparently_from_stale_keepalive(engine):
    arrays, ubodt = engine
    pool = HttpPool()
    rep = port_replica(arrays, ubodt, "rep-stale")
    body = json.dumps(street_trace(arrays, "veh-1")).encode()
    hdrs = {"Content-Type": "application/json"}
    try:
        st, _h, _b = pool.request("POST", rep.url + "/report", body=body, headers=hdrs,
                                  target="t")
        assert st == 200
        # the server cuts the pooled connection behind the pool's back; the
        # next request retries on a fresh connection instead of failing
        rep.httpd.close_lingering()
        st, _h, _b = pool.request("POST", rep.url + "/report", body=body, headers=hdrs,
                                  target="t")
        assert st == 200
    finally:
        pool.close()
        rep.close()


def test_pool_retries_on_a_fresh_connection_past_many_stale_ones(engine):
    """Several idle keep-alive sockets the server closed at once (its idle
    timeout closes them together): a request's one retry opens a new
    connection instead of taking the next stale socket, so it answers."""
    arrays, ubodt = engine
    pool = HttpPool()
    rep = port_replica(arrays, ubodt, "rep-stale-many")
    body = json.dumps(street_trace(arrays, "veh-1")).encode()
    hdrs = {"Content-Type": "application/json"}
    try:
        gate = threading.Barrier(4)

        def one():
            gate.wait()
            return pool.request("POST", rep.url + "/report", body=body, headers=hdrs,
                                target="t")[0]
        threads = [threading.Thread(target=one) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert len(pool._idle[("127.0.0.1", rep.port)]) >= 2
        rep.httpd.close_lingering()
        opened0 = C_CONN_OPENED.labels("t").value
        for _ in range(3):
            st, _h, _b = pool.request("POST", rep.url + "/report", body=body, headers=hdrs,
                                      target="t")
            assert st == 200
        assert C_CONN_OPENED.labels("t").value - opened0 >= 1
    finally:
        pool.close()
        rep.close()


def _bound_port(proc, timeout=90):
    """The port a serve process logged it bound (it binds port 0)."""
    buf = b""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stderr.readline()
        if not line:
            assert proc.poll() is None, buf.decode(errors="replace")
            continue
        buf += line
        if b"on 127.0.0.1:" in line:
            # the log pipe is drained from here on, so the child never blocks
            threading.Thread(target=proc.stderr.read, daemon=True).start()
            return int(line.split(b"on 127.0.0.1:")[1].split()[0])
    raise AssertionError(buf.decode(errors="replace"))


def test_sigterm_drain_finishes_inflight_then_exits_zero(engine, tmp_path):
    """SIGTERM: the inflight request completes, new requests answer 503
    "draining" with Retry-After, /health turns "draining", exit 0."""
    arrays, _ = engine
    conf = {"network": {"type": "grid", "rows": 5, "cols": 5, "spacing_m": 150.0},
            "matcher": {"ubodt_delta": 2000.0, "length_buckets": [16, 32]},
            # a 1.5 s batch window holds every /report inside the batcher
            "batch": {"max_batch": 64, "max_wait_ms": 1500}, "warmup": False}
    conf_path = tmp_path / "config.json"
    conf_path.write_text(json.dumps(conf))
    env = dict(os.environ, PYTHONPATH=REPO, REPORTER_REPLICA_ID="rep-drain",
               REPORTER_DRAIN_GRACE_S="15")
    proc = subprocess.Popen([sys.executable, "-m", "reporter_tpu_torch.serve", "--device",
                             "cpu", str(conf_path), "127.0.0.1:0"], cwd=str(tmp_path),
                            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        url = "http://127.0.0.1:%d" % _bound_port(proc)
        assert wait_for(lambda: get_json(url + "/health")[2].get("backend"), timeout=120,
                        step=0.2)
        inflight = {}
        t = threading.Thread(target=lambda: inflight.update(r=post_json(
            url + "/report", street_trace(arrays, "veh-inflight"))))
        t.start()
        # the request is inside its batch window: its handler bills the
        # cost ledger's "serving" state
        seen = []
        assert wait_for(lambda: seen.append(get_json(url + "/debug/cost")[2]["state"]) or seen[-1] == "serving",
                        timeout=10, step=0.02), (seen[:5], inflight, t.is_alive())
        proc.send_signal(signal.SIGTERM)
        assert wait_for(lambda: get_json(url + "/health")[0] == 503)
        st, hd, body = post_json(url + "/report", street_trace(arrays, "veh-late"))
        assert st == 503 and body.get("status") == "draining"
        assert int(hd.get("Retry-After", 0)) >= 1
        t.join(20)
        assert not t.is_alive()
        st, hd, body = inflight["r"]
        assert st == 200 and "segment_matcher" in body
        assert hd.get("X-Reporter-Replica") == "rep-drain"
        assert proc.wait(timeout=20) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_geo_off_is_bitforbit_rendezvous():
    """REPORTER_ROUTER_GEO unset: the ranking is the plain rendezvous hash
    for every uuid, shards and coordinates notwithstanding."""
    router = FleetRouter(["http://127.0.0.1:%d" % p for p in (1, 2, 3)],
                         probe_interval_s=3600.0)
    try:
        assert router.geo_routing is False
        for i, r in enumerate(router.replicas):
            r.shard = "%d/3" % i
        for k in range(50):
            uuid = "veh-%d" % k
            want = sorted(router.replicas, key=lambda r: rendezvous_score(uuid, r.url),
                          reverse=True)
            assert [r.url for r in router.ranked(uuid)] == [r.url for r in want]
            assert [r.url for r in router.ranked(uuid, (52.5, 13.4))] == [r.url for r in want]
    finally:
        router.stop()


def test_geo_on_prefers_shard_owner(monkeypatch):
    """Flag on: the replica whose shard covers the request's cell ranks
    first, the rendezvous hash orders the rest, and a uuid without a
    coordinate keeps the plain ranking."""
    from reporter_tpu_torch.serve.router import C_GEO, geo_cell

    monkeypatch.setenv("REPORTER_ROUTER_GEO", "1")
    monkeypatch.setenv("REPORTER_ROUTER_GEO_CELL_DEG", "0.25")
    router = FleetRouter(["http://127.0.0.1:%d" % p for p in (1, 2, 3)],
                         probe_interval_s=3600.0)
    try:
        assert router.geo_routing is True
        for i, r in enumerate(router.replicas):
            r.shard = "%d/3" % i
        geo = (52.5, 13.4)
        cell = geo_cell(geo[0], geo[1], 0.25)
        owner = next(r for r in router.replicas if router._geo_pref(r, cell))
        g0 = sum(C_GEO.labels(o).value for o in ("steered", "aligned"))
        for k in range(20):
            order = router.ranked("veh-%d" % k, geo)
            assert order[0] is owner
            tail = sorted([r for r in router.replicas if r is not owner],
                          key=lambda r: rendezvous_score("veh-%d" % k, r.url), reverse=True)
            assert [r.url for r in order[1:]] == [r.url for r in tail]
        assert sum(C_GEO.labels(o).value for o in ("steered", "aligned")) == g0 + 20
        for k in range(20):
            uuid = "veh-%d" % k
            want = sorted(router.replicas, key=lambda r: rendezvous_score(uuid, r.url),
                          reverse=True)
            assert [r.url for r in router.ranked(uuid)] == [r.url for r in want]
        assert router._geo_pref(Replica("http://x:1"), cell) == 0
        junk = Replica("http://x:2")
        junk.shard = "weird"
        assert router._geo_pref(junk, cell) == 0
    finally:
        router.stop()


def test_wait_routed_waits_for_the_routers_probe():
    """``wait_routed`` returns once the router's GET /fleet has the
    replica available, not before; False when it never does."""
    import http.server
    import types

    from reporter_tpu_torch.tools import fleet as fleet_mod

    polls = {"n": 0}

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - http.server's name
            polls["n"] += 1
            body = json.dumps({"replicas": [
                {"url": "http://127.0.0.1:1", "available": True},
                {"url": "http://127.0.0.1:2", "available": polls["n"] > 3}]}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = "http://127.0.0.1:%d" % srv.server_address[1]
        assert fleet_mod.wait_routed(url, "http://127.0.0.1:2/", 10.0)
        assert polls["n"] >= 4
        t0 = time.monotonic()
        assert not fleet_mod.wait_routed(url, "http://127.0.0.1:3", 0.5)
        assert time.monotonic() - t0 < 5.0
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(10)
    assert not th.is_alive()

    # the rolling restart drains the next replica only once the router has
    # readmitted the last one, and stops when it does not
    for routed in (True, False):
        events = []

        class Child:
            def __init__(self, name):
                self.name, self.url, self.restarts = name, "http://%s" % name, 0

            def drain(self, grace_s):
                events.append(("drain", self.name))
                return 0

            def spawn(self):
                events.append(("spawn", self.name))

        f = fleet_mod.Fleet.__new__(fleet_mod.Fleet)
        f._lock, f._stop = threading.RLock(), threading.Event()
        f.replicas = [Child("a"), Child("b")]
        f.args = types.SimpleNamespace(drain_grace=1.0, up_timeout=1.0)
        f.router = types.SimpleNamespace(url="http://router")
        f._bank_uptime = f.write_state = lambda *a: None
        mp = pytest.MonkeyPatch()
        try:
            mp.setattr(fleet_mod, "wait_healthy",
                       lambda url, t: events.append(("healthy", url)) or True)
            mp.setattr(fleet_mod, "wait_routed",
                       lambda r, url, t: events.append(("routed", url)) or routed)
            assert f.rolling_restart() is routed
        finally:
            mp.undo()
        first = [("drain", "a"), ("spawn", "a"), ("healthy", "http://a"),
                 ("routed", "http://a")]
        assert events == (first + [("drain", "b"), ("spawn", "b"), ("healthy", "http://b"),
                                   ("routed", "http://b")] if routed else first)
