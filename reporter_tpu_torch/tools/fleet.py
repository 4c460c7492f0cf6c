"""Fleet supervisor: N serve replicas + the session-affine router, as one
process tree (the port's copy of the JAX package's ``tools/fleet.py``:
the same lifecycle, files, signals and knobs, with ``--device`` in place
of ``--cpu-default``).

Spawns each replica (`python -m reporter_tpu_torch.serve --device D`) on
its own port with a pinned `REPORTER_REPLICA_ID`, the router (`python -m
reporter_tpu_torch.serve.router`) in front of them, monitors every child,
and restarts any that dies unexpectedly — replicas are cattle; the
supervisor's restart loop is the herd's continuity.  A state file
(`<workdir>/fleet.json`) always holds the live pids/urls so an external
harness can SIGKILL a specific replica and watch the fleet absorb it.
Every replica gets the same ``--device`` (default cuda): a replica that
asks for a card the machine lacks exits non-zero, and the crash-loop
backoff below paces its respawns; nothing falls back to the CPU.

The supervisor is ALSO a federation point (obs/federation.py, the same
machinery the router's `GET /metrics` serves): it pulls every replica's
mergeable metrics snapshot on an interval and writes
`<workdir>/federation.json` — per-replica snapshots + ages/staleness +
the fleet-merged registry — so a harness that cannot scrape HTTP still
gets the one-pane-of-glass view, and a SIGKILLed replica's final
snapshot survives in the file, labeled stale (`--federate-every 0`
disables).

Self-driving extensions (docs/serving-fleet.md "Self-driving fleet"):

  --autoscale      a control thread (reporter_tpu_torch/serve/autoscale.py)
                   grows the fleet when the router's client-truth SLO
                   burn alert AND a sustained-queue gate both fire
                   (multi-window AND-gated, the obs/slo.py math), and
                   shrinks it after a sustained calm window — scale-up
                   spawns a --warmup replica that the router holds out
                   of the ring until /health reports attached+warmed;
                   scale-down is strictly SIGTERM drain + beam handoff.
                   Every decision lands in the router's
                   reporter_fleet_scale_events_total counter, the
                   /statusz autoscale ring, and
                   <workdir>/scale_events.jsonl.

  crash-loop backoff   consecutive quick deaths of one child back its
                   respawn off exponentially with full jitter
                   (reporter_fleet_respawn_backoff_seconds; a one-off
                   death still respawns immediately).

  checkpoint re-home   with --session-checkpoint S the replicas persist
                   dirty session state to <workdir>/session-ckpt/<rid>/
                   (REPORTER_SESSION_CHECKPOINT_*); when a replica dies
                   WITHOUT draining, the supervisor re-homes its last
                   checkpoint through the router (POST /sessions) before
                   the respawn — a SIGKILL becomes a restore, not an
                   incident.

Lifecycle signals (to THIS process):

  SIGUSR1   rolling restart: each replica in turn is SIGTERM'd (graceful
            drain — the router rotates traffic off via /health before
            the process dies), waited to exit 0, respawned, and waited
            healthy before the next one is touched.  Zero non-shed
            client errors is the contract (chip_smoke.py phase 22 checks it).
  SIGTTIN / SIGTTOU
            scale up / down by one replica through the autoscaler's own
            actuators (``scale_up`` / ``scale_down``, reason "manual"):
            a --warmup replica held out of the router's ring until it
            attaches, or the newest replica drained (the port's addition,
            the process-manager convention for growing a worker pool).
  SIGTERM / SIGINT
            drain the whole fleet: router first (stop admitting), then
            every replica, wait for clean exits; exit 0 only when every
            child exited 0.

Usage:
    python -m reporter_tpu_torch.tools.fleet --config service.json \
        --replicas 3 --base-port 19010 --router-port 19009 \
        --workdir fleet/ [--device cuda|cpu] [--warmup] \
        [--rolling-restart-after 20] \
        [--autoscale --min-replicas 1 --max-replicas 6] \
        [--session-checkpoint 1.0 [--session-checkpoint-sync]]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

from ..matching.session import SessionCheckpointer, read_checkpoints
from ..obs import economics as econ
from ..obs import federation as obs_fed
from ..obs.economics import FleetCostLedger
from ..obs.federation import Federator
from ..serve.autoscale import G_AUTOSCALE_REPLICAS, Autoscaler, RespawnBackoff

# the package's parent directory: children import the port from there
# whatever their working directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

log = logging.getLogger("fleet")


def wait_healthy(url: str, timeout_s: float, want_status: str = "ok",
                 want_warmed: bool = False) -> bool:
    """Poll /health until it answers 200 with the wanted status (and, for
    replicas, an attached backend; ``want_warmed`` additionally requires
    the warmup pass to have finished) or the timeout lapses."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(url + "/health", timeout=2) as r:
                h = json.loads(r.read().decode())
            if h.get("status") == want_status and (
                    h.get("role") == "router" or h.get("backend")):
                if not (want_warmed and h.get("warming")):
                    return True
        except Exception:  # noqa: BLE001 - not up yet
            pass
        time.sleep(0.5)
    return False


def wait_routed(router_url: str, url: str, timeout_s: float) -> bool:
    """Poll the router's GET /fleet until its own probe has the replica at
    ``url`` available (back in the rendezvous ring), or the timeout
    lapses."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            fleet = _get_json(router_url + "/fleet", timeout=2.0)
            if any(r.get("url") == url.rstrip("/") and r.get("available")
                   for r in fleet.get("replicas", [])):
                return True
        except Exception:  # noqa: BLE001 - the router is busy or restarting
            pass
        time.sleep(0.1)
    return False


def _get_json(url: str, timeout: float = 5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _post_json(url: str, payload: dict, timeout: float = 30.0):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


class Child:
    """One supervised process (replica or router)."""

    def __init__(self, name: str, cmd, env: dict, log_path: str, url: str,
                 rid=None):
        self.name = name
        self.cmd = cmd
        self.env = env
        self.log_path = log_path
        self.url = url
        self.rid = rid                  # replica id (None for the router)
        self.proc: subprocess.Popen = None
        self.restarts = 0
        self.expected_exit = False  # set around intentional drains
        self.t_spawn = 0.0
        self.respawn_at = 0.0       # crash-loop backoff: due time

    def spawn(self) -> None:
        logf = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            self.cmd, env=self.env, stdout=logf, stderr=subprocess.STDOUT)
        logf.close()
        self.expected_exit = False
        self.t_spawn = time.monotonic()
        self.respawn_at = 0.0
        log.info("%s: pid %d on %s", self.name, self.proc.pid, self.url)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def drain(self, grace_s: float) -> int:
        """SIGTERM and wait for the graceful-drain exit; SIGKILL past the
        grace.  Returns the exit code."""
        self.expected_exit = True
        if not self.alive():
            return self.proc.returncode if self.proc else 0
        self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            log.warning("%s: drain grace %.1fs expired; SIGKILL",
                        self.name, grace_s)
            self.proc.kill()
            return self.proc.wait()


class Fleet:
    def __init__(self, args):
        self.args = args
        self.workdir = os.path.abspath(args.workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.host = args.host
        base = os.environ.copy()
        base["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, base.get("PYTHONPATH")) if p)
        # preemption-tolerant sessions: every replica checkpoints dirty
        # session wire-state under one shared workdir tree, one owned
        # subdirectory per replica id (docs/serving-fleet.md)
        self.ckpt_dir = None
        if args.session_checkpoint > 0:
            self.ckpt_dir = os.path.join(self.workdir, "session-ckpt")
            base["REPORTER_SESSION_CHECKPOINT_S"] = str(
                args.session_checkpoint)
            base["REPORTER_SESSION_CHECKPOINT_DIR"] = self.ckpt_dir
            if args.session_checkpoint_sync:
                base["REPORTER_SESSION_CHECKPOINT_SYNC"] = "1"
        # fleet economics (docs/economics.md): every child persists its
        # demand-history ring under one shared workdir tree unless the
        # operator already pinned a directory; the supervisor's own
        # fleet-level series and the cross-incarnation cost ledger land
        # next to them on the federation cadence
        base.setdefault("REPORTER_HISTORY_DIR",
                        os.path.join(self.workdir, "history"))
        self.history_dir = base["REPORTER_HISTORY_DIR"]
        self._base_env = base
        self.replicas = []
        self._next_idx = 0
        self._next_port = args.base_port
        for _ in range(args.replicas):
            self.replicas.append(self._make_replica())
        urls = ",".join(c.url for c in self.replicas)
        router_env = dict(base)
        # the router's shutdown dumps (hop spans) get their own tag so
        # they never collide with a replica's on a shared dump dir
        router_env.setdefault("REPORTER_REPLICA_ID", "router")
        self.router = Child(
            "router",
            [sys.executable, "-m", "reporter_tpu_torch.serve.router",
             "--host", self.host, "--port", str(args.router_port),
             "--replicas", urls],
            router_env, os.path.join(self.workdir, "router.log"),
            "http://%s:%d" % (self.host, args.router_port))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._rolling = threading.Event()
        self._scaling = threading.Lock()   # one scale action at a time
        self._federator = None
        self.autoscaler = None
        # crash-loop backoff (serve/autoscale.py)
        self.backoff = RespawnBackoff(
            base_s=args.respawn_backoff_base,
            max_s=args.respawn_backoff_max)
        # chip-second accounting across incarnations (obs/economics.py
        # FleetCostLedger): _uptime banks each completed incarnation's
        # supervised wall-seconds per child so the expected side of the
        # cost invariant survives SIGKILL + respawn too
        self.cost_ledger = FleetCostLedger()
        self._uptime = {}           # name -> completed-incarnation seconds
        self._econ_prev = None      # (t, admitted_total, shed_total)
        self._fleet_hist = None     # lazy DemandHistory, federate thread

    def _make_replica(self) -> Child:
        i = self._next_idx
        self._next_idx += 1
        port = self._next_port
        self._next_port += 1
        serve_cmd = [sys.executable, "-m", "reporter_tpu_torch.serve",
                     "--device", self.args.device]
        if self.args.warmup:
            serve_cmd.append("--warmup")
        rid = "rep-%d" % i
        env = dict(self._base_env)
        env["REPORTER_REPLICA_ID"] = rid
        # fleet-sharded UBODT serving (docs/serving-fleet.md "Sharded
        # tables"): each replica is assigned one contiguous bucket-range
        # shard of the table to seed its hot arena with, advertised on
        # /health for the router's geo-aware ranking.  A respawned
        # replica keeps its slot's shard (i mod count), so the partition
        # is stable across restarts and scale events.
        if self.args.ubodt_shards > 0:
            env["REPORTER_UBODT_SHARD"] = "%d/%d" % (
                i % self.args.ubodt_shards, self.args.ubodt_shards)
        return Child(
            rid,
            serve_cmd + [self.args.config, "%s:%d" % (self.host, port)],
            env, os.path.join(self.workdir, "replica-%d.log" % i),
            "http://%s:%d" % (self.host, port), rid=rid)

    # -- state file ---------------------------------------------------------

    def write_state(self) -> None:
        state = {
            "router": {"url": self.router.url,
                       "pid": self.router.proc.pid if self.router.proc else None},
            "replicas": [
                {"id": c.rid, "url": c.url,
                 "pid": c.proc.pid if c.proc else None,
                 "restarts": c.restarts, "log": c.log_path,
                 "backoff_streak": self.backoff.streak(c.name)}
                for c in self.replicas],
            "autoscale": (self.autoscaler.state()
                          if self.autoscaler is not None else None),
            "session_checkpoint_dir": self.ckpt_dir,
        }
        path = os.path.join(self.workdir, "fleet.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, path)

    def _scale_event(self, **kw) -> None:
        kw.setdefault("t_unix", round(time.time(), 3))
        path = os.path.join(self.workdir, "scale_events.jsonl")
        try:
            with open(path, "a") as f:
                f.write(json.dumps(kw, separators=(",", ":")) + "\n")
        except OSError:
            pass

    # -- lifecycle ----------------------------------------------------------

    def boot(self) -> bool:
        for c in self.replicas:
            c.spawn()
        self.router.spawn()
        self.write_state()
        for c in self.replicas:
            if not wait_healthy(c.url, self.args.up_timeout):
                log.error("%s never became healthy (see %s)",
                          c.name, c.log_path)
                return False
        if not wait_healthy(self.router.url, 30.0):
            log.error("router never became healthy (see %s)",
                      self.router.log_path)
            return False
        log.info("fleet up: %d replicas behind %s",
                 len(self.replicas), self.router.url)
        return True

    def rolling_restart(self) -> bool:
        """Restart every replica one at a time, gracefully: drain (the
        router rotates traffic off via the 503-draining /health), wait
        exit 0, respawn, wait healthy and routed, move on.  The fleet
        never has more than one replica out at once: the next drain waits
        for the router's own probe to readmit the respawned replica (its
        /health answering is not enough; the reference moves on there,
        and a request in between finds no replica to take it)."""
        ok = True
        with self._lock:
            replicas = list(self.replicas)
        for c in replicas:
            if self._stop.is_set():
                break
            log.info("rolling restart: draining %s", c.name)
            rc = c.drain(self.args.drain_grace + 10.0)
            self._bank_uptime(c)
            if rc != 0:
                log.error("%s exited %s during rolling drain", c.name, rc)
                ok = False
            with self._lock:
                c.restarts += 1
                c.spawn()
                self.write_state()
            if not wait_healthy(c.url, self.args.up_timeout):
                log.error("%s did not come back healthy", c.name)
                ok = False
                break
            if not wait_routed(self.router.url, c.url, self.args.up_timeout):
                log.error("%s came back but the router did not readmit it",
                          c.name)
                ok = False
                break
        log.info("rolling restart %s", "complete" if ok else "FAILED")
        return ok

    def federate(self) -> None:
        """Supervisor-side federation loop: pull every replica's snapshot
        (obs/federation.py Federator — the same machinery the router
        serves at /metrics) and write <workdir>/federation.json
        atomically on each tick.  A dead replica's last snapshot stays
        in the file, labeled stale — the supervisor keeps the herd's
        numbers even when the router is the thing that died."""
        fed = Federator([c.url for c in self.replicas],
                        pull_interval_s=self.args.federate_every)
        self._federator = fed
        path = os.path.join(self.workdir, "federation.json")
        while not self._stop.wait(fed.pull_interval_s):
            with self._lock:
                urls = {c.url for c in self.replicas}
            for u in urls:
                fed.add_target(u)
            fed.pull_all()
            try:
                fed.dump(path, extra={"router": self.router.url})
            except OSError as e:
                log.warning("federation dump failed: %s", e)
            try:
                self._econ_tick(fed)
            except Exception as e:  # noqa: BLE001 - bookkeeping only
                log.warning("economics tick failed: %s", e)

    # -- fleet economics (docs/economics.md) ---------------------------------

    def _bank_uptime(self, c: Child) -> None:
        """A child incarnation ended on purpose (drain): bank its
        supervised wall-seconds.  Unexpected deaths bank in monitor()."""
        if c.t_spawn:
            self._uptime[c.name] = (
                self._uptime.get(c.name, 0.0)
                + max(0.0, time.monotonic() - c.t_spawn))

    def _expected_uptime(self) -> dict:
        """rid -> supervised wall-seconds across ALL incarnations: the
        banked completed ones plus the live one — the expected side of
        the chip-seconds invariant (`cost_ledger.json` "consistent")."""
        now = time.monotonic()
        out = dict(self._uptime)
        out.pop("router", None)     # the router bills no chips
        with self._lock:
            replicas = list(self.replicas)
        for c in replicas:
            if c.alive():
                out[c.rid] = out.get(c.rid, 0.0) + (now - c.t_spawn)
        return out

    def _econ_tick(self, fed) -> None:
        """One economics tick per federation pull: feed every replica's
        statusz economics block into the cross-incarnation cost ledger,
        write <workdir>/cost_ledger.json atomically, and append one
        fleet-level record to the demand-history ring — the series
        tools/demand_export.py replays."""
        now = time.monotonic()
        price = None
        qdepth = admitted = shed = 0.0
        headroom = None
        n_live = 0
        for f in fed.feeds():
            statusz = f.statusz or {}
            e = statusz.get("economics") or {}
            snap = statusz.get("metrics") or {}
            if e:
                self.cost_ledger.observe(
                    f.label, e.get("chip_seconds_total"), e.get("usd"),
                    obs_fed.snapshot_scalar(
                        snap, "reporter_points_matched_total"),
                    e.get("chips") or 1)
                price = price if price is not None else \
                    e.get("price_per_chip_hour")
                hr = e.get("headroom_traces_per_sec")
                if hr is not None:
                    headroom = (headroom or 0.0) + float(hr)
            if f.ok:
                n_live += 1
            qdepth += obs_fed.snapshot_scalar(
                snap, "reporter_microbatch_queue_depth") or 0.0
            for outcome in ("ok", "degraded"):
                admitted += obs_fed.snapshot_total(
                    snap, "reporter_requests_total",
                    {"outcome": outcome}) or 0.0
            shed += obs_fed.snapshot_total(
                snap, "reporter_requests_total", {"outcome": "shed"}) or 0.0

        rep = self.cost_ledger.report(self._expected_uptime(), price=price)
        rep["t_unix"] = round(time.time(), 3)
        path = os.path.join(self.workdir, "cost_ledger.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(rep, fh, indent=1)
        os.replace(tmp, path)

        if self._fleet_hist is None:
            try:
                os.makedirs(self.history_dir, exist_ok=True)
                self._fleet_hist = econ.DemandHistory(
                    os.path.join(self.history_dir, "fleet.jsonl"))
            except OSError as e:
                log.warning("fleet history disabled: %s", e)
                return
        admitted_rps = shed_rps = 0.0
        if self._econ_prev is not None:
            t0, a0, s0 = self._econ_prev
            dt = max(1e-6, now - t0)
            admitted_rps = max(0.0, admitted - a0) / dt
            shed_rps = max(0.0, shed - s0) / dt
        self._econ_prev = (now, admitted, shed)
        offered = admitted_rps + shed_rps
        self._fleet_hist.append({
            "replica": "fleet",
            "replicas_live": n_live,
            "queue_depth": round(qdepth, 3),
            "admitted_rps": round(admitted_rps, 4),
            "shed_rps": round(shed_rps, 4),
            "shed_fraction": (round(shed_rps / offered, 4)
                              if offered > 0 else 0.0),
            "headroom": (round(headroom, 4)
                         if headroom is not None else None),
            "chip_seconds_total": rep["totals"]["chip_seconds"],
            "usd": rep["totals"]["usd"],
        })

    # -- preemption re-home (docs/serving-fleet.md) --------------------------

    def _rehome_checkpoints(self, c: Child) -> None:
        """A replica died WITHOUT draining: push its last checkpointed
        sessions through the router to whichever replicas its vehicles
        rendezvous-rank to now.  Imported files are removed; anything
        that could not travel stays on disk for the next attempt (the
        respawned replica clears its own dir at boot, so this runs
        BEFORE the respawn)."""
        if self.ckpt_dir is None or c.rid is None:
            return
        d = os.path.join(self.ckpt_dir, c.rid)
        wires = read_checkpoints(d)
        if not wires:
            return
        try:
            # exclude the corpse explicitly: this runs the instant the
            # death is seen, often BEFORE the router's probe streak has
            # marked the replica unavailable
            res = _post_json(self.router.url + "/sessions",
                             {"sessions": wires, "exclude": c.rid},
                             timeout=90.0)
        except Exception as e:  # noqa: BLE001 - files stay for a retry
            log.warning("%s: checkpoint re-home failed: %s", c.name, e)
            self._scale_event(event="rehome_failed", replica=c.rid,
                              sessions=len(wires), error=str(e)[:200])
            return
        imported = set(res.get("imported_uuids") or ())
        for w in wires:
            u = str(w.get("uuid") or "")
            if u in imported:
                try:
                    os.unlink(os.path.join(
                        d, SessionCheckpointer._path_name(u)))
                except OSError:
                    pass
        log.warning("%s: re-homed %d/%d checkpointed sessions "
                    "(no_target=%s)", c.name, res.get("rehomed"),
                    len(wires), res.get("no_target"))
        self._scale_event(event="rehome", replica=c.rid,
                          sessions=len(wires),
                          rehomed=res.get("rehomed"),
                          no_target=res.get("no_target"))

    def monitor(self) -> None:
        """Respawn unexpected deaths (crash-only replicas are the fault
        posture: the router keeps serving around the hole while the
        supervisor refills it) — with crash-loop backoff + jitter, and a
        checkpoint re-home before a dead replica's slot is refilled."""
        while not self._stop.wait(0.25):
            if self._rolling.is_set():
                continue  # the rolling-restart thread owns lifecycle now
            now = time.monotonic()
            with self._lock:
                children = list(self.replicas) + [self.router]
            for c in children:
                if c.proc is None or c.alive() or c.expected_exit:
                    continue
                if c.respawn_at == 0.0:
                    # first sight of this death: back off, re-home
                    rc = c.proc.returncode
                    uptime = now - c.t_spawn
                    self._uptime[c.name] = (
                        self._uptime.get(c.name, 0.0) + uptime)
                    delay = self.backoff.next_delay(c.name, uptime)
                    log.warning("%s died rc=%s after %.1fs; respawn in "
                                "%.2fs", c.name, rc, uptime, delay)
                    if rc != 0:
                        # a PREEMPTION (SIGKILL/crash): restore its last
                        # checkpointed sessions through the router.  An
                        # rc-0 exit was a graceful drain — the router's
                        # handoff already moved those beams; re-homing
                        # the leftover files would race the live copies.
                        # Backgrounded: an import retrying through a
                        # churning fleet must not freeze the monitor
                        # (the files are read before the respawned
                        # process clears its directory at attach)
                        threading.Thread(
                            target=self._rehome_checkpoints, args=(c,),
                            daemon=True, name="rehome-%s" % c.name,
                        ).start()
                    c.respawn_at = now + delay if delay > 0 else -1.0
                    with self._lock:
                        self.write_state()
                if c.respawn_at <= now or c.respawn_at < 0:
                    with self._lock:
                        c.restarts += 1
                        c.spawn()
                        self.write_state()

    # -- autoscaling (serve/autoscale.py) ------------------------------------

    def _read_signals(self):
        try:
            statusz = _get_json(self.router.url + "/statusz", timeout=5.0)
            slo = _get_json(self.router.url + "/debug/slo", timeout=5.0)
        except Exception:  # noqa: BLE001 - blind polls make no decisions
            return None
        depth = 0.0
        devices = 0
        for row in statusz.get("fleet", ()):
            try:
                depth += float(row.get("queue_depth") or 0.0)
            except (TypeError, ValueError):
                pass
            try:
                # advertised local mesh size per replica (/health
                # "capacity"): the autoscaler's queue gate scales its
                # threshold by mean chips per replica
                devices += int(row.get("devices") or 1)
            except (TypeError, ValueError):
                devices += 1
        alerting = False
        max_burn = 0.0
        for o in slo.get("objectives", ()):
            if o.get("kind") not in ("availability", "latency"):
                continue
            alerting = alerting or bool(o.get("alerting"))
            for v in (o.get("burn") or {}).values():
                try:
                    max_burn = max(max_burn, float(v))
                except (TypeError, ValueError):
                    pass
        with self._lock:
            n = len(self.replicas)
        return {"replicas": n, "queue_depth": depth, "devices": devices,
                "burn_alerting": alerting, "max_burn": max_burn}

    def scale_up(self, reason: str) -> bool:
        """Spawn one --warmup replica and register it with the router:
        the router's warming hold-out keeps it OUT of the rendezvous
        ring until /health reports attached+warmed, so no request is
        ever served by a cold replica.  Blocks until admission (the
        cooldown must start from a fleet that is actually bigger)."""
        with self._scaling:
            with self._lock:
                c = self._make_replica()
                self.replicas.append(c)
                c.spawn()
                self.write_state()
            self._scale_event(event="spawned", direction="up",
                              replica=c.rid, url=c.url, reason=reason)
            try:
                _post_json(self.router.url + "/fleet",
                           {"add": c.url, "reason": reason}, timeout=15.0)
            except Exception as e:  # noqa: BLE001
                log.error("router add %s failed: %s", c.url, e)
            warmed = wait_healthy(c.url, self.args.up_timeout,
                                  want_warmed=True)
            self._scale_event(event="admitted" if warmed else
                              "admission_timeout", direction="up",
                              replica=c.rid, url=c.url, reason=reason)
            log.warning("scale-up %s: %s (%s)", c.rid,
                        "admitted" if warmed else "ADMISSION TIMED OUT",
                        reason)
            return warmed

    def scale_down(self, reason: str) -> bool:
        """Drain the newest replica (SIGTERM -> graceful drain -> beam
        handoff at the router), wait for the clean exit, then drop it
        from the router's ring and the supervised set."""
        with self._scaling:
            with self._lock:
                if len(self.replicas) <= 1:
                    return False
                c = self.replicas[-1]
            self._scale_event(event="draining", direction="down",
                              replica=c.rid, url=c.url, reason=reason)
            rc = c.drain(self.args.drain_grace + 10.0)
            self._bank_uptime(c)
            try:
                _post_json(self.router.url + "/fleet",
                           {"remove": c.url, "reason": reason},
                           timeout=15.0)
            except Exception as e:  # noqa: BLE001
                log.error("router remove %s failed: %s", c.url, e)
            with self._lock:
                self.replicas = [x for x in self.replicas if x is not c]
                self.write_state()
            if self._federator is not None:
                # a scale-down leaves the fleet on purpose: drop its feed
                # (unlike a death, whose stale snapshot is kept)
                self._federator.remove_target(c.url)
            self._scale_event(event="removed", direction="down",
                              replica=c.rid, url=c.url, reason=reason,
                              exit_rc=rc)
            log.warning("scale-down %s: drained rc=%s (%s)",
                        c.rid, rc, reason)
            return rc == 0

    def start_autoscaler(self) -> None:
        a = self.args

        def signals():
            sig = self._read_signals()
            if sig is not None:
                G_AUTOSCALE_REPLICAS.set(sig["replicas"])
            return sig

        self.autoscaler = Autoscaler(
            signals, self.scale_up, self.scale_down,
            min_replicas=a.min_replicas, max_replicas=a.max_replicas,
            poll_s=a.scale_poll, cooldown_s=a.scale_cooldown,
            queue_high=a.scale_queue_high, window_s=a.scale_window,
            down_after_s=(a.scale_down_after or None))
        threading.Thread(target=self.autoscaler.run, args=(self._stop,),
                         daemon=True, name="autoscaler").start()
        log.info("autoscaler on: %d..%d replicas, queue_high=%.0f, "
                 "window=%.0fs, cooldown=%.0fs", a.min_replicas,
                 a.max_replicas, a.scale_queue_high, a.scale_window,
                 a.scale_cooldown)

    def shutdown(self) -> int:
        self._stop.set()
        # router first: stop admitting new traffic, then drain replicas
        rc = 0
        code = self.router.drain(10.0)
        if code != 0:
            log.error("router exited %s on drain", code)
            rc = 1
        for c in self.replicas:
            code = c.drain(self.args.drain_grace + 10.0)
            if code != 0:
                log.error("%s exited %s on drain", c.name, code)
                rc = 1
        self.write_state()
        return rc

    def run(self) -> int:
        # signal handlers BEFORE the (slow: warmup compiles) boot wait — a
        # SIGUSR1 landing mid-boot must queue a rolling restart, not kill
        # the supervisor with the default action
        def _usr1(signum, frame):
            if not self._rolling.is_set():
                threading.Thread(target=self._rolling_once,
                                 daemon=True, name="rolling").start()

        def _term(signum, frame):
            try:
                signal.signal(signum, signal.SIG_DFL)
            except (ValueError, OSError):
                pass
            self._stop.set()

        def _scale(direction):
            def handler(signum, frame):
                act = self.scale_up if direction == "up" else self.scale_down
                threading.Thread(target=act, args=("manual",), daemon=True,
                                 name="scale-" + direction).start()
            return handler

        signal.signal(signal.SIGUSR1, _usr1)
        signal.signal(signal.SIGTTIN, _scale("up"))
        signal.signal(signal.SIGTTOU, _scale("down"))
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _term)

        if not self.boot():
            self.shutdown()
            return 2

        mon = threading.Thread(target=self.monitor, daemon=True,
                               name="fleet-monitor")
        mon.start()
        if self.args.federate_every > 0:
            threading.Thread(target=self.federate, daemon=True,
                             name="fleet-federation").start()
        if self.args.autoscale:
            self.start_autoscaler()
        if self.args.rolling_restart_after > 0:
            def _timed():
                if not self._stop.wait(self.args.rolling_restart_after):
                    self._rolling_once()
            threading.Thread(target=_timed, daemon=True,
                             name="rolling-timer").start()
        while not self._stop.is_set():
            time.sleep(0.2)
        return self.shutdown()

    def _rolling_once(self) -> None:
        self._rolling.set()
        try:
            self.rolling_restart()
        finally:
            self._rolling.clear()


# the reference's default working directory, under the temporary directory
DEFAULT_WORKDIR = os.path.join(tempfile.gettempdir(), "reporter-fleet")


def parser() -> argparse.ArgumentParser:
    """The supervisor's command line."""
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True, help="serve config json")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--base-port", type=int, default=19010)
    ap.add_argument("--router-port", type=int, default=19009)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--warmup", action="store_true",
                    help="boot each replica with --warmup (every shape "
                         "warmed before its engine attaches)")
    ap.add_argument("--up-timeout", type=float, default=240.0,
                    help="seconds to wait for a replica to become healthy")
    ap.add_argument("--drain-grace", type=float, default=30.0,
                    help="seconds a draining replica gets before SIGKILL")
    ap.add_argument("--rolling-restart-after", type=float, default=0.0,
                    help="schedule ONE rolling restart this many seconds "
                         "after boot (0 = only on SIGUSR1)")
    ap.add_argument("--federate-every", type=float, default=5.0,
                    help="seconds between federation pulls written to "
                         "<workdir>/federation.json (0 disables)")
    ap.add_argument("--ubodt-shards", type=int, default=0,
                    help="assign each replica REPORTER_UBODT_SHARD="
                         "'i%%N/N' over this many table shards (0 = "
                         "unsharded; pair with REPORTER_UBODT_HOT_BYTES "
                         "for the tiered serving fleet, docs/serving-"
                         "fleet.md \"Sharded tables\")")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="every replica's --device (default cuda; a replica "
                         "asking for a card the machine lacks exits non-zero)")
    # self-driving knobs (docs/serving-fleet.md "Self-driving fleet")
    ap.add_argument("--autoscale", action="store_true",
                    help="run the burn-rate autoscaler control thread")
    ap.add_argument("--min-replicas", type=int, default=1)
    ap.add_argument("--max-replicas", type=int, default=8)
    ap.add_argument("--scale-poll", type=float, default=1.0,
                    help="autoscaler signal poll interval (seconds)")
    ap.add_argument("--scale-cooldown", type=float, default=20.0,
                    help="seconds after a scale action before the next "
                         "decision")
    ap.add_argument("--scale-queue-high", type=float, default=8.0,
                    help="summed replica queue depth counting as queue "
                         "pressure for the sustained gate")
    ap.add_argument("--scale-window", type=float, default=30.0,
                    help="the sustained-queue gate's long window (its "
                         "fast window is a sixth of it)")
    ap.add_argument("--scale-down-after", type=float, default=0.0,
                    help="seconds of calm before a scale-down (0 = "
                         "2x the gate window)")
    ap.add_argument("--respawn-backoff-base", type=float, default=0.5,
                    help="crash-loop backoff base (doubles per "
                         "consecutive quick death, full jitter)")
    ap.add_argument("--respawn-backoff-max", type=float, default=30.0)
    ap.add_argument("--session-checkpoint", type=float, default=0.0,
                    help="session checkpoint cadence seconds for every "
                         "replica (0 = off); enables the SIGKILL "
                         "re-home path")
    ap.add_argument("--session-checkpoint-sync", action="store_true",
                    help="checkpoint each session commit synchronously "
                         "(zero lost answered points under SIGKILL)")
    return ap


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s fleet %(levelname)s %(message)s")
    return Fleet(parser().parse_args(argv)).run()


if __name__ == "__main__":
    sys.exit(main())
