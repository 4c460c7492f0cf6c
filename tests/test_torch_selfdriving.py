"""The port's self-driving fleet on the CPU: ``serve/autoscale.py``'s
``Autoscaler`` decisions and ``RespawnBackoff`` delays against the JAX
package's under the same signal sequences, clock and seeded random;
``FleetCostLedger`` against the reference's over the same observation
sequences, resets included; the router's fleet economics roll-up; and
the reference's router and autoscale cases, ported: the adaptive hedge
threshold, the AND-gated scale decisions, the router's admin surface and
scale events, the warming hold-out of an added replica (a deferred
``ReporterService(None)`` brought live by ``attach_matcher``), the
checkpoint re-home through the router, the prober's jitter and its
honouring of a drain's Retry-After, and the slow_drain seam."""

import json
import os
import random
import threading
import time
import urllib.error
import urllib.request

import pytest

from reporter_tpu.obs import economics as ref_econ
from reporter_tpu.serve import autoscale as ref_autoscale
from reporter_tpu_torch import faults
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.matching.session import SessionState
from reporter_tpu_torch.obs import economics as econ
from reporter_tpu_torch.serve.autoscale import Autoscaler, RespawnBackoff
from reporter_tpu_torch.serve.router import FleetRouter
from reporter_tpu_torch.serve.service import ReporterService
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city
from reporter_tpu_torch.tiles.ubodt import build_ubodt

KW = dict(length_buckets=[16, 32])


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for p in faults.POINTS:
        monkeypatch.delenv("REPORTER_FAULT_" + p.upper(), raising=False)
    for var in ("REPORTER_ADAPTIVE", "REPORTER_HEDGE_MS", "REPORTER_COST_LEDGER_TOL"):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def engine():
    arrays = build_graph_arrays(grid_city(rows=5, cols=5, spacing_m=150.0), cell_size=100.0)
    return arrays, build_ubodt(arrays, delta=2000.0)


def _matcher(arrays, ubodt):
    return SegmentMatcher(arrays=arrays, ubodt=ubodt, config=MatcherConfig(**KW), device="cpu")


class _Replica:
    """One in-process port replica with a pinned replica id; ``deferred``
    binds it with no matcher."""

    def __init__(self, arrays, ubodt, rid, deferred=False):
        self.rid = rid
        prev = os.environ.get("REPORTER_REPLICA_ID")
        os.environ["REPORTER_REPLICA_ID"] = rid
        try:
            self.svc = ReporterService(None if deferred else _matcher(arrays, ubodt),
                                       max_wait_ms=2.0)
        finally:
            if prev is None:
                os.environ.pop("REPORTER_REPLICA_ID", None)
            else:
                os.environ["REPORTER_REPLICA_ID"] = prev
        self.httpd = self.svc.make_server("127.0.0.1", 0)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = "http://127.0.0.1:%d" % self.httpd.server_port

    def close(self):
        try:
            self.httpd.shutdown()
            self.httpd.server_close()
        except Exception:  # noqa: BLE001
            pass
        self.svc.close()


def post_json(url, payload, timeout=30):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
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


# -- the differentials ---------------------------------------------------------


def _signal_sequence(kind, n=240, seed=0):
    """One poll's signals per second: bursts, sustained pressure, burn
    without queues, calm, and a seeded random walk of all of them."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        if kind == "burst":
            hot = i in (60, 61, 150)
            out.append({"queue_depth": 50.0 if hot else 0.0, "burn_alerting": hot,
                        "max_burn": 4.0 if hot else 0.0})
        elif kind == "sustained":
            out.append({"queue_depth": 50.0, "burn_alerting": True, "max_burn": 3.0,
                        "devices": 2 * (1 + i // 80)})
        elif kind == "burn only":
            out.append({"queue_depth": 0.0, "burn_alerting": True, "max_burn": 5.0})
        elif kind == "calm":
            out.append({"queue_depth": 0.0, "burn_alerting": False, "max_burn": 0.0})
        else:
            out.append({"queue_depth": rng.choice((0.0, 4.0, 9.0, 40.0)),
                        "burn_alerting": rng.random() < 0.4,
                        "max_burn": rng.choice((0.0, 0.05, 0.5, 2.0)),
                        "devices": rng.choice((0, 2, 4))})
    return out


def _drive(cls, seq, start=2, blind_every=0):
    clock = {"t": 1000.0}
    state = {"replicas": start}
    decisions = []

    def signals():
        if blind_every and int(clock["t"]) % blind_every == 0:
            return None
        return dict(seq[int(clock["t"]) - 1001], replicas=state["replicas"])

    def up(reason):
        state["replicas"] += 1
        return True

    def down(reason):
        state["replicas"] -= 1
        return True

    a = cls(signals, up, down, min_replicas=1, max_replicas=4, poll_s=1.0, cooldown_s=5.0,
            queue_high=8.0, window_s=12.0, down_after_s=30.0, clock=lambda: clock["t"])
    for _ in seq:
        clock["t"] += 1.0
        decisions.append(a.tick())
    st = a.state()
    return decisions, state["replicas"], st["queue_gate"], st["last_decision"] is not None


@pytest.mark.parametrize("kind", ["burst", "sustained", "burn only", "calm", "random"])
@pytest.mark.parametrize("blind_every", [0, 7])
def test_autoscaler_decisions_equal_reference(kind, blind_every):
    """Both packages' Autoscaler over the same signal sequence and clock:
    the same decision at every poll, the same fleet size, the same gate."""
    seq = _signal_sequence(kind, seed=len(kind) + blind_every)
    port = _drive(Autoscaler, seq, blind_every=blind_every)
    ref = _drive(ref_autoscale.Autoscaler, seq, blind_every=blind_every)
    assert port == ref
    if kind == "sustained":
        assert any(d == ("up", "burn_and_queue") for d in port[0])
    if kind == "calm":
        assert port[1] == 1


def test_respawn_backoff_equals_reference():
    """The same deaths (child, uptime) with the same seeded random: the same
    delays and streaks, the crash-loop log at the same points."""
    rng = random.Random(5)
    deaths = [("rep-%d" % rng.randrange(3), rng.choice((0.1, 0.5, 2.0, 31.0, 120.0)))
              for _ in range(120)]
    port = RespawnBackoff(base_s=0.5, max_s=8.0, healthy_reset_s=30.0, rng=random.Random(11))
    ref = ref_autoscale.RespawnBackoff(base_s=0.5, max_s=8.0, healthy_reset_s=30.0,
                                       rng=random.Random(11))
    for i, (child, up) in enumerate(deaths):
        assert port.next_delay(child, up) == ref.next_delay(child, up)
        assert port.streak(child) == ref.streak(child)
        if i % 17 == 0:
            port.note_healthy(child)
            ref.note_healthy(child)


def _ledger_sequence(seed):
    rng = random.Random(seed)
    out = []
    cs = {"rep-0": 0.0, "rep-1": 0.0, "rep-2": 0.0}
    for _ in range(200):
        rid = rng.choice(sorted(cs))
        if rng.random() < 0.08:
            cs[rid] = rng.uniform(0.0, 3.0)  # a respawn: the counter restarts
        else:
            cs[rid] += rng.uniform(0.0, 2.0)
        out.append((rid, cs[rid], cs[rid] * 0.01, int(cs[rid] * 40), rng.choice((1, 2, None))))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("tolerance", [0.15, 0.01])
def test_fleet_cost_ledger_equals_reference(seed, tolerance):
    """FleetCostLedger over the same observations, resets included: the
    same totals, incarnations and consistency flag at every report."""
    port, ref = econ.FleetCostLedger(tolerance), ref_econ.FleetCostLedger(tolerance)
    for i, (rid, cs, usd, pts, chips) in enumerate(_ledger_sequence(seed)):
        for led in (port, ref):
            led.observe(rid, cs, usd=usd, points=pts, chips=chips)
        if i % 20 == 19:
            up = {"rep-0": 3.0 * i, "rep-1": 2.0 * i, "rep-9": 5.0}
            assert port.report(up, price=1.5) == ref.report(up, price=1.5)
    assert port.report() == ref.report()


# -- the reference's cases, ported -----------------------------------------------


def test_hedge_threshold_tracks_live_p95():
    router = FleetRouter(["http://127.0.0.1:1"], hedge_ms=100.0, probe_interval_s=3600.0)
    try:
        assert router._hedge_ctl is not None
        router._hedge_ctl.cooldown_s = 0.0
        # thin traffic: the controller holds
        assert router.current_hedge_s() == pytest.approx(0.1)
        for _ in range(100):
            router.slo.observe("report", 200, 0.400)
        for _ in range(40):
            router.current_hedge_s()
        # k=2 x p95(~0.4 s) = 0.8 s, inside the [0.01, 1.0] clamp
        assert router.current_hedge_s() == pytest.approx(0.8, rel=0.2)
    finally:
        router.stop()


def test_hedge_threshold_static_without_adaptive(monkeypatch):
    monkeypatch.setenv("REPORTER_ADAPTIVE", "0")
    router = FleetRouter(["http://127.0.0.1:1"], hedge_ms=100.0, probe_interval_s=3600.0)
    try:
        assert router._hedge_ctl is None
        for _ in range(100):
            router.slo.observe("report", 200, 0.400)
        assert router.current_hedge_s() == pytest.approx(0.1)
    finally:
        router.stop()


def _mk_autoscaler(clock):
    sig = {"replicas": 2, "queue_depth": 0.0, "burn_alerting": False, "max_burn": 0.0}
    actions = {"up": 0, "down": 0}

    def scale_up(reason):
        actions["up"] += 1
        sig["replicas"] += 1
        return True

    def scale_down(reason):
        actions["down"] += 1
        sig["replicas"] -= 1
        return True

    a = Autoscaler(lambda: dict(sig), scale_up, scale_down, min_replicas=1, max_replicas=3,
                   poll_s=1.0, cooldown_s=5.0, queue_high=8.0, window_s=12.0,
                   down_after_s=30.0, clock=lambda: clock["t"])
    return a, sig, actions


def test_burst_alone_cannot_scale_up():
    clock = {"t": 1000.0}
    a, sig, actions = _mk_autoscaler(clock)
    # a 2-second queue burst with a burn alert: the fast window fires, the
    # slow window does not
    for i in range(120):
        clock["t"] += 1.0
        sig["queue_depth"] = 50.0 if i in (60, 61) else 0.0
        sig["burn_alerting"] = i in (60, 61)
        a.tick()
    assert actions["up"] == 0 and sig["replicas"] >= 1


def test_sustained_burn_and_queue_scales_up_once_per_cooldown():
    clock = {"t": 1000.0}
    a, sig, actions = _mk_autoscaler(clock)
    sig.update(queue_depth=50.0, burn_alerting=True, max_burn=3.0)
    for _ in range(60):
        clock["t"] += 1.0
        a.tick()
    assert 1 <= actions["up"] <= 60 / 5.0 + 1
    assert sig["replicas"] <= 3


def test_burn_without_queue_pressure_does_not_scale():
    clock = {"t": 1000.0}
    a, sig, actions = _mk_autoscaler(clock)
    sig.update(burn_alerting=True, max_burn=5.0)  # latency pain, empty queues
    for _ in range(60):
        clock["t"] += 1.0
        a.tick()
    assert actions["up"] == 0


def test_sustained_calm_scales_down_to_min():
    clock = {"t": 1000.0}
    a, sig, actions = _mk_autoscaler(clock)
    sig["replicas"] = 3
    for _ in range(120):
        clock["t"] += 1.0
        a.tick()
    assert actions["down"] >= 1 and sig["replicas"] == 1
    n_down = actions["down"]
    for _ in range(60):
        clock["t"] += 1.0
        a.tick()
    assert actions["down"] == n_down


def test_unreachable_router_makes_no_decisions():
    clock = {"t": 1000.0}
    calls = {"n": 0}

    def boom(reason):
        calls["n"] += 1
        return True

    a = Autoscaler(lambda: None, boom, boom, clock=lambda: clock["t"], cooldown_s=0.0)
    for _ in range(50):
        clock["t"] += 1.0
        assert a.tick() is None
    assert calls["n"] == 0


def test_respawn_backoff_doubles_and_resets():
    backoff = RespawnBackoff(base_s=0.5, max_s=8.0, healthy_reset_s=30.0)
    assert backoff.next_delay("rep-0", uptime_s=2.0) == 0.0  # a one-off death
    d1, d2, d3 = (backoff.next_delay("rep-0", uptime_s=0.5) for _ in range(3))
    assert 0.5 <= d1 <= 1.0 and 1.0 <= d2 <= 2.0 and 2.0 <= d3 <= 4.0
    assert backoff.next_delay("rep-0", uptime_s=120.0) == 0.0  # a long life resets
    assert backoff.next_delay("rep-1", uptime_s=0.1) == 0.0  # per child


def test_router_admin_add_remove_and_scale_events(engine):
    arrays, ubodt = engine
    reps = [_Replica(arrays, ubodt, "sd-rep-%d" % i) for i in range(2)]
    extra = _Replica(arrays, ubodt, "sd-rep-2")
    router = FleetRouter([r.url for r in reps], probe_interval_s=0.2)
    router.start()
    httpd = router.make_server("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://127.0.0.1:%d" % httpd.server_port
    try:
        st, _h, body = post_json(url + "/fleet", {"add": extra.url, "reason": "burn_and_queue"})
        assert st == 200 and body["ok"] and len(router.replicas) == 3
        st, _h, body = post_json(url + "/fleet", {"add": extra.url})  # no duplicate
        assert st == 409 and len(router.replicas) == 3
        st, _h, sz = get_json(url + "/statusz")
        assert st == 200
        assert any(e["direction"] == "up" and e["reason"] == "burn_and_queue"
                   for e in sz["autoscale"]["events"])
        fam = sz["metrics"]["reporter_fleet_scale_events_total"]
        assert any(lv == ["up", "burn_and_queue"] and v >= 1 for lv, v in fam["samples"])
        assert wait_for(lambda: any(r.url == extra.url and r.available()
                                    for r in router.replicas))
        st, _h, body = post_json(url + "/fleet", {"remove": "sd-rep-2", "reason": "idle"})
        assert st == 200 and body["ok"] and len(router.replicas) == 2
        post_json(url + "/fleet", {"remove": reps[0].rid})
        st, _h, body = post_json(url + "/fleet", {"remove": reps[1].rid})
        assert st == 409 and "last replica" in body["admin"]
        assert post_json(url + "/fleet", {"nope": 1})[0] == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        router.stop()
        for r in reps + [extra]:
            r.close()


def test_added_replica_warming_holdout_serves_nothing_cold(engine):
    arrays, ubodt = engine
    warm = _Replica(arrays, ubodt, "sd-rep-warm")
    cold = _Replica(arrays, ubodt, "sd-rep-cold", deferred=True)
    router = FleetRouter([warm.url], probe_interval_s=0.1)
    router.start()
    try:
        # before attach: /health 200 "warming", /report 503 "initialising"
        st, _h, health = get_json(cold.url + "/health")
        assert st == 200 and health["warming"] is True and health["backend"] is None
        assert health["capacity"] is None
        st, _h, body = post_json(cold.url + "/report", {"uuid": "v", "trace": []})
        assert st == 503 and body["error"] == "service initialising"
        ok, _msg = router.add_replica(cold.url, "burn_and_queue")
        assert ok
        cold_rep = next(r for r in router.replicas if r.url == cold.url)
        # the warming hold-out: in the ring, not routable
        assert wait_for(lambda: cold_rep.last_probe is not None)
        assert cold_rep.state == "init" and not cold_rep.available()
        for k in range(8):
            assert all(r.url != cold.url for r in router.route_order("veh-%d" % k)[0])
        assert cold_rep.was_lost  # its first healthy transition is a recovery
        cold.svc.attach_matcher(_matcher(arrays, ubodt))
        assert wait_for(cold_rep.available)
        st, _h, health = get_json(cold.url + "/health")
        assert health["warming"] is False and health["capacity"]["devices"] == 1
        assert cold_rep.capacity == health["capacity"]
    finally:
        router.stop()
        warm.close()
        cold.close()


def test_router_rehomes_checkpointed_sessions(engine):
    arrays, ubodt = engine
    reps = [_Replica(arrays, ubodt, "sd-rh-%d" % i) for i in range(2)]
    router = FleetRouter([r.url for r in reps], probe_interval_s=0.2)
    router.start()
    httpd = router.make_server("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://127.0.0.1:%d" % httpd.server_port
    try:
        assert wait_for(lambda: all(r.available() for r in router.replicas))
        wires = []
        for k in range(6):
            s = SessionState("veh-re-%d" % k, t0=1000.0)
            s.points_total = 3
            s.replay = [{"lat": 37.75, "lon": -122.45, "time": 1000 + i} for i in range(3)]
            s.seq = 1
            wires.append(s.to_wire())
        st, _h, body = post_json(url + "/sessions", {"sessions": wires})
        assert st == 200 and body["rehomed"] == 6 and body["no_target"] == 0
        assert sorted(body["imported_uuids"]) == sorted(w["uuid"] for w in wires)
        for w in wires:  # every session on its uuid's rendezvous primary
            primary = next(r for r in reps if r.url == router.route_order(w["uuid"])[0][0].url)
            assert primary.svc.session_store.peek(w["uuid"]) is not None
        assert sum(r.svc.session_store.summary()["points_total"] for r in reps) == 18
        # "exclude" reroutes around a replica the caller knows is dead
        s = SessionState("veh-excl", t0=1000.0)
        s.points_total = 1
        s.replay = [{"lat": 37.75, "lon": -122.45, "time": 2000}]
        primary_rid = next(r.rid for r in reps
                           if r.url == router.route_order("veh-excl")[0][0].url)
        other = next(r for r in reps if r.rid != primary_rid)
        st, _h, body = post_json(url + "/sessions", {"sessions": [s.to_wire()],
                                                     "exclude": primary_rid})
        assert st == 200 and body["rehomed"] == 1
        assert other.svc.session_store.peek("veh-excl") is not None
    finally:
        httpd.shutdown()
        httpd.server_close()
        router.stop()
        for r in reps:
            r.close()


def test_probe_schedule_jitter_spreads_phases():
    router = FleetRouter(["http://127.0.0.1:1"], probe_interval_s=1.0)
    try:
        r = router.replicas[0]
        delays = []
        for _ in range(200):
            router._schedule_probe(r)
            delays.append(r.next_probe_at - time.monotonic())
        assert min(delays) >= 0.99
        assert max(delays) <= 1.0 + router.probe_jitter + 0.01
        assert max(delays) - min(delays) > 0.05
    finally:
        router.stop()


def test_draining_probe_honors_retry_after_no_streak(engine):
    arrays, ubodt = engine
    rep = _Replica(arrays, ubodt, "sd-rep-drn")
    router = FleetRouter([rep.url], probe_interval_s=0.2, unhealthy_after=2)
    try:
        router.probe_all()
        r = router.replicas[0]
        assert r.state == "healthy"
        rep.svc.begin_drain()
        t0 = time.monotonic()
        router.probe_all()
        # a 503 "draining" is no unhealthy streak, and its Retry-After (1 s)
        # pushes this replica's next probe past the 0.2 s interval
        assert r.state == "draining" and r.probe_fail_streak == 0
        assert r.next_probe_at - t0 >= 0.9
    finally:
        router.stop()
        rep.close()


def test_slow_drain_stalls_session_export(monkeypatch, engine):
    arrays, ubodt = engine
    rep = _Replica(arrays, ubodt, "sd-rep-slow")
    try:
        monkeypatch.setenv("REPORTER_FAULT_SLOW_DRAIN", "0.4:1")
        faults.reset()
        t0 = time.monotonic()
        code, body = rep.svc.handle_sessions({"export": ["1"]})
        dt_armed = time.monotonic() - t0
        assert code == 200 and "sessions" in body and dt_armed >= 0.4
        # the count-limited spec disarms after one firing
        t0 = time.monotonic()
        rep.svc.handle_sessions({"export": ["1"]})
        assert time.monotonic() - t0 < dt_armed - 0.2
    finally:
        rep.close()


def _feed_statusz(cs, usd, chips=1, points=500.0, headroom=10.0):
    return {"economics": {"chip_seconds_total": cs, "usd": usd, "chips": chips,
                          "price_per_chip_hour": 1.2, "headroom_traces_per_sec": headroom,
                          "ceiling_traces_per_sec": headroom + 5.0},
            "metrics": {"reporter_points_matched_total": {"labelnames": [],
                                                          "samples": [[[], points]]}}}


def test_router_fleet_economics_rolls_up():
    from reporter_tpu.serve.router import FleetRouter as RefRouter

    urls = ["http://127.0.0.1:1", "http://127.0.0.1:2"]
    r, ref = FleetRouter(urls), RefRouter(urls)
    try:
        for rt in (r, ref):
            feeds = rt.federator.feeds()
            feeds[0].statusz = _feed_statusz(10.0, 0.01, points=1_000.0)
            feeds[1].statusz = _feed_statusz(30.0, 0.03, chips=2, points=1_000.0)
        e = r.fleet_economics()
        assert e == ref.fleet_economics()
        assert e["chip_seconds_total"] == pytest.approx(40.0) and e["chips"] == 3
        assert e["usd"] == pytest.approx(0.04) and e["points_total"] == 2000
        assert e["usd_per_million_points"] == pytest.approx(20.0)
        assert e["headroom_traces_per_sec"] == pytest.approx(20.0)
        code, rep = r.handle_cost({})
        assert code == 200 and rep["scope"] == "fleet" and len(rep["replicas"]) == 2
        assert (code, rep) == ref.handle_cost({})
    finally:
        r.stop()
        ref.stop()


def test_fleet_cost_ledger_survives_resets():
    led = econ.FleetCostLedger(tolerance=0.15)
    led.observe("rep-0", 10.0, usd=0.1, points=100, chips=1)
    led.observe("rep-0", 20.0, usd=0.2, points=200, chips=1)
    led.observe("rep-0", 2.0, usd=0.02, points=10, chips=1)  # a SIGKILL
    led.observe("rep-0", 8.0, usd=0.08, points=40, chips=1)
    rep = led.report({"rep-0": 30.0})
    row = rep["replicas"]["rep-0"]
    assert row["chip_seconds"] == pytest.approx(28.0) and row["incarnations"] == 2
    assert rep["consistent"] and rep["totals"]["points"] == 240


def test_fleet_cost_ledger_flags_inconsistency():
    led = econ.FleetCostLedger(tolerance=0.05)
    led.BOOT_SLACK_S = 0.0
    led.observe("rep-0", 10.0)
    rep = led.report({"rep-0": 100.0})
    assert not rep["consistent"] and rep["rel_err"] == pytest.approx(0.9)
