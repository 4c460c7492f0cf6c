"""Preemption-tolerant sessions in the port on the CPU: the
``SessionCheckpointer``'s write / prune / clear semantics and the
merge-dedup import, each run on the port's and the JAX package's store
with the same operations (same results, same files), and the SIGKILL of
a port serve process holding live session beams behind the port's
router: the fleet ledger loses exactly the victim's answered points, and
re-homing the victim's sync-mode checkpoint through the router restores
every one of them (zero lost, zero duplicated)."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from reporter_tpu.matching import session as ref_session
from reporter_tpu_torch import faults
from reporter_tpu_torch.matching import session as port_session
from reporter_tpu_torch.matching.session import read_checkpoints
from reporter_tpu_torch.serve.router import FleetRouter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"port": port_session, "ref": ref_session}


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for p in faults.POINTS:
        monkeypatch.delenv("REPORTER_FAULT_" + p.upper(), raising=False)
    faults.reset()
    yield
    faults.reset()


def _open_session(store, uuid, points):
    s = store.get_or_open(uuid, t0=1000.0)
    s.replay = [{"lat": 37.75, "lon": -122.45, "time": 1000 + i} for i in range(points)]
    s.points_total = points
    s.seq = 1
    return s


def _files(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def _both(fn, tmp_path):
    """fn(session module, directory) on each package; the two results."""
    return [fn(mod, str(tmp_path / side)) for side, mod in sorted(SIDES.items())]


def test_checkpoint_sweep_writes_dirty_and_prunes_dead(tmp_path):
    def run(mod, d):
        store = mod.SessionStore()
        cp = mod.SessionCheckpointer(store, d, cadence_s=3600.0, sync=False)
        cp.start()  # sweeps driven by hand
        _open_session(store, "veh-a", 3)
        _open_session(store, "veh/b:weird uuid", 2)
        store.notify_commit("veh-a")
        store.notify_commit("veh/b:weird uuid")
        out = [cp.sweep()["written"], sorted((w["uuid"], w["points_total"])
                                             for w in mod.read_checkpoints(d))]
        out.append(cp.sweep()["written"])  # a clean sweep writes nothing
        with store._lock:  # a session leaving the store is pruned
            del store._by_uuid["veh-a"]
        out += [cp.sweep()["pruned"], [w["uuid"] for w in mod.read_checkpoints(d)], _files(d)]
        cp.stop()
        return out

    port, ref = _both(run, tmp_path)
    assert port == ref
    assert port[:4] == [2, [("veh-a", 3), ("veh/b:weird uuid", 2)], 0, 1]
    assert port[4] == ["veh/b:weird uuid"]


def test_checkpoint_sync_mode_persists_each_commit(tmp_path):
    def run(mod, d):
        store = mod.SessionStore()
        cp = mod.SessionCheckpointer(store, d, cadence_s=3600.0, sync=True)
        cp.start()
        _open_session(store, "veh-s", 4)
        store.notify_commit("veh-s")  # the commit itself writes the file
        cp.stop()
        return [(w["uuid"], w["points_total"]) for w in mod.read_checkpoints(d)]

    port, ref = _both(run, tmp_path)
    assert port == ref == [("veh-s", 4)]


def test_pop_and_drop_remove_files_promptly(tmp_path):
    def run(mod, d):
        store = mod.SessionStore()
        cp = mod.SessionCheckpointer(store, d, cadence_s=3600.0, sync=True)
        cp.start()
        _open_session(store, "veh-pop", 2)
        _open_session(store, "veh-drop", 2)
        store.notify_commit("veh-pop")
        store.notify_commit("veh-drop")
        out = [len(mod.read_checkpoints(d)), len(store.pop_wire(["veh-pop"])),
               [w["uuid"] for w in mod.read_checkpoints(d)]]
        store.drop("veh-drop")
        out.append(mod.read_checkpoints(d))
        cp.stop()
        return out

    port, ref = _both(run, tmp_path)
    # a popped beam moved: its file dies with the pop, not at the next sweep
    assert port == ref == [2, 1, ["veh-drop"], []]


def test_checkpoint_clear_on_start_and_unreadable_skipped(tmp_path):
    def run(mod, d):
        os.makedirs(d)
        with open(os.path.join(d, "stale.json"), "w") as f:
            json.dump(mod.SessionState("veh-stale", 0.0).to_wire(), f)
        with open(os.path.join(d, "garbage.json"), "w") as f:
            f.write("{not json")
        with open(os.path.join(d, "ignored.txt"), "w") as f:
            f.write("not a checkpoint")
        out = [[w["uuid"] for w in mod.read_checkpoints(d)]]
        # a fresh checkpointer clears leftovers; only checkpoint files die
        cp = mod.SessionCheckpointer(mod.SessionStore(), d, cadence_s=3600.0)
        cp.start()
        out += [mod.read_checkpoints(d), _files(d)]
        cp.stop()
        return out

    port, ref = _both(run, tmp_path)
    assert port == ref == [["veh-stale"], [], ["ignored.txt"]]


def test_import_merge_dedups_shared_replay_points():
    out = {}
    for side, mod in SIDES.items():
        store = mod.SessionStore()
        live = _open_session(store, "veh-m", 2)
        live.replay = [{"lat": 1.0, "lon": 2.0, "time": 1003},
                       {"lat": 1.0, "lon": 2.0, "time": 1004}]
        # the incoming wire shares one point with the live replay
        s = mod.SessionState("veh-m", 1000.0)
        s.points_total = 3
        s.replay = [{"lat": 1.0, "lon": 2.0, "time": t} for t in (1001, 1002, 1003)]
        res = store.import_wire([s.to_wire()])
        out[side] = (res["merged"], live.points_total, [p["time"] for p in live.replay],
                     live.rebuild_pending)
    assert out["port"] == out["ref"] == (1, 4, [1001, 1002, 1003, 1004], True)


def _spawn_replica(tmp_path, rid, ckpt_dir):
    conf = {"network": {"type": "grid", "rows": 5, "cols": 5, "spacing_m": 150.0},
            "matcher": {"ubodt_delta": 2000.0, "length_buckets": [16, 32]},
            "batch": {"max_batch": 16, "max_wait_ms": 2, "session_wait_ms": 1},
            "warmup": False}
    conf_path = tmp_path / ("config-%s.json" % rid)
    conf_path.write_text(json.dumps(conf))
    env = dict(os.environ, PYTHONPATH=REPO, REPORTER_REPLICA_ID=rid,
               REPORTER_SESSION_CHECKPOINT_S="60", REPORTER_SESSION_CHECKPOINT_SYNC="1",
               REPORTER_SESSION_CHECKPOINT_DIR=str(ckpt_dir))
    return subprocess.Popen([sys.executable, "-m", "reporter_tpu_torch.serve", "--device",
                             "cpu", str(conf_path), "127.0.0.1:0"], cwd=str(tmp_path),
                            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


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


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _wait_backend(url, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if _get(url + "/health", 2).get("backend"):
                return
        except Exception:  # noqa: BLE001 - still booting
            pass
        time.sleep(0.2)
    raise AssertionError("replica %s never attached" % url)


def _post(url, payload, timeout=30):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read().decode())


def _street_points(i0, n):
    # a short straight walk near the 5 x 5 grid's row-2 street
    return [{"lat": 37.75 + 0.00012 * (i0 + i), "lon": -122.45 + 0.00012 * (i0 + i),
             "time": 1000 + 15 * (i0 + i)} for i in range(n)]


def _submit(rurl, uuid, i0):
    return _post(rurl + "/report", {
        "uuid": uuid, "stream": True, "trace": _street_points(i0, 2),
        "match_options": {"mode": "auto", "report_levels": [0, 1],
                          "transition_levels": [0, 1]}})


def test_sigkill_baseline_loss_then_checkpoint_rehome_exact(tmp_path):
    """SIGKILL a port replica holding live sessions (no drain, no
    export): the fleet ledger lacks exactly the victim's answered points;
    re-homing its sync checkpoint through the router restores the ledger
    to every answered point."""
    ckpt_dir = tmp_path / "session-ckpt"
    procs = [_spawn_replica(tmp_path, "pre-rep-%d" % i, ckpt_dir) for i in range(2)]
    router = httpd = None
    try:
        urls = ["http://127.0.0.1:%d" % _bound_port(p) for p in procs]
        for u in urls:
            _wait_backend(u)
        router = FleetRouter(urls, probe_interval_s=0.15, unhealthy_after=2)
        router.start()
        httpd = router.make_server("127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        rurl = "http://127.0.0.1:%d" % httpd.server_port
        deadline = time.monotonic() + 10
        while not all(r.available() for r in router.replicas):
            assert time.monotonic() < deadline
            time.sleep(0.05)

        # two-point session steps, synchronously: nothing is in flight at
        # the kill, so the answered points are exactly countable
        uuids = ["veh-pre-%02d" % k for k in range(10)]
        answered = {}  # uuid -> [points before the kill, after, replica]
        for step in range(2):
            for u in uuids:
                st, hd, body = _submit(rurl, u, 2 * step)
                assert st == 200, body
                row = answered.setdefault(u, [0, 0, None])
                row[0] += 2
                row[2] = hd.get("X-Reporter-Replica")
        n_pre = sum(r[0] for r in answered.values())
        assert _get(rurl + "/sessions")["points_total"] == n_pre

        by_rep = {}
        for _p, _q, rep in answered.values():
            by_rep[rep] = by_rep.get(rep, 0) + 1
        victim_rid = max(by_rep, key=by_rep.get)
        victim = procs[int(victim_rid.rsplit("-", 1)[1])]
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=10)
        victim_points = sum(p for p, _q, rep in answered.values() if rep == victim_rid)
        assert victim_points > 0

        # the vehicles keep streaming: the survivor opens fresh sessions
        for u in uuids:
            st, hd, body = _submit(rurl, u, 4)
            assert st == 200, body
            assert hd.get("X-Reporter-Replica") != victim_rid
            answered[u][1] += 2
        n_all = sum(p + q for p, q, _r in answered.values())
        # the baseline: exactly the victim's answered points are missing
        assert _get(rurl + "/sessions")["points_total"] == n_all - victim_points

        # re-home the victim's sync-mode checkpoint through the router
        wires = read_checkpoints(str(ckpt_dir / victim_rid))
        assert wires, "sync checkpointing left no files for the victim"
        st, _h, res = _post(rurl + "/sessions", {"sessions": wires})
        assert st == 200 and res["rehomed"] == len(wires)
        assert _get(rurl + "/sessions")["points_total"] == n_all
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if router is not None:
            router.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
