"""Per-vehicle matching sessions: the carried Viterbi beam as serialisable
serving state.

The windowed path makes every point wait for its window.  A session keeps
the beam the long-trace chain carries across windows, keyed by vehicle
uuid, so each arriving point costs one row of a small [B, W] session step
and is answered at once.

  SessionState   one vehicle's live decode: the carried beam (a host dict,
                 or an ``ArenaRef`` when it lives in the device slab), the
                 epoch its float32 times are rebased to, and a bounded
                 rolling tail of matched per-point records with the raw
                 points behind them (the association context of the next
                 answer, and the replay buffer a beam-less session
                 rebuilds from).  ``to_wire`` / ``from_wire`` are the
                 handoff format (``WIRE_VERSION`` 1, the reference's).
  SessionStore   uuid -> SessionState, LRU-bounded and TTL-evicted, with
                 the handoff's export, atomic pop and merging import.
  SessionEngine  the engine the service mounts in its session MicroBatcher:
                 it folds the streaming submits of many vehicles into
                 ``SegmentMatcher.match_sessions_async`` steps, commits to
                 the store only after the device answered (unless a wedge
                 or crash invalidated the step meanwhile), rebuilds a
                 beam-less session from its replay buffer inside the same
                 dispatch, and answers from the CPU baseline in the
                 service's degraded mode (``degraded_step``).
  SessionCheckpointer
                 dirty sessions' wire snapshots as atomic per-uuid files,
                 on a cadence or at every commit; ``read_checkpoints``
                 reads a directory of them back.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time as _time
from collections import OrderedDict
from typing import List, Optional, Tuple
from urllib.parse import quote, unquote

import numpy as np

from .. import faults
from ..obs import metrics as obs
from .arena import carry_free, carry_host
from .assoc_native import associate_segments_batch

log = logging.getLogger(__name__)

# the session plane's families (docs/observability.md "Sessions")
G_SESSIONS = obs.gauge(
    "reporter_sessions_active",
    "Open per-vehicle matching sessions in the pinned-host store")
C_SESSION_EVENTS = obs.counter(
    "reporter_sessions_total",
    "Session lifecycle events (opened / expired / evicted / exported / "
    "imported / import_merged / rebuilt / reattached)",
    ("event",))
C_SESSION_POINTS = obs.counter(
    "reporter_session_points_total",
    "Points folded into open sessions by the incremental step")
H_STEP_SESSIONS = obs.histogram(
    "reporter_session_step_sessions",
    "Sessions folded per incremental session-step device dispatch",
    buckets=obs.BATCH_FILL_BUCKETS)
C_SESSION_DEDUP = obs.counter(
    "reporter_session_dedup_points_total",
    "Streaming points dropped at SessionEngine admission because an "
    "identical raw point (time, lat, lon) already lives in the "
    "session's replay buffer — a hedged \"stream\": true request that "
    "landed on two replicas (or a client retry racing a slow answer) "
    "commits once; the duplicate still gets a full answer from the "
    "accumulated tail (docs/serving-fleet.md \"Beam handoff\")")
C_CKPT = obs.counter(
    "reporter_session_checkpoints_total",
    "Session checkpoint events (written / pruned / cleared / error) — "
    "the preemption-tolerance plane: dirty session wire-state persisted "
    "to atomic per-uuid files on REPORTER_SESSION_CHECKPOINT_S cadence "
    "(or synchronously per commit with _SYNC=1), re-homed by the fleet "
    "supervisor when a replica is SIGKILLed (docs/serving-fleet.md "
    "\"Self-driving fleet\")",
    ("event",))

WIRE_VERSION = 1


def _point_key(p: dict) -> tuple:
    """A raw point's identity: the admission dedup's and the import
    merge's."""
    return (p.get("time"), p.get("lat"), p.get("lon"))


class SessionState:
    """One vehicle's live decode.  The store lock serialises its metadata
    and the single-worker engine serialises its steps."""

    __slots__ = ("uuid", "t0", "carry", "records", "replay", "seq",
                 "points_total", "pkey", "last_used", "created",
                 "rebuild_pending", "imported")

    def __init__(self, uuid: str, t0: float, pkey: tuple = ()):
        self.uuid = uuid
        # rebase epoch of the float32 device times: epoch seconds would
        # lose the dt resolution the time-factor cut needs
        self.t0 = float(t0)
        # the carried beam: None until the first step lands, or after a
        # degraded window dropped it (rebuild_pending replays first)
        self.carry = None
        # rolling tail of matched per-point records, newest last: (edge,
        # offset, break, epoch time), and the raw points behind them
        self.records: List[Tuple[int, float, bool, float]] = []
        self.replay: List[dict] = []
        self.seq = 0            # steps applied
        self.points_total = 0   # points ever folded in
        self.pkey = pkey
        self.rebuild_pending = False
        self.imported = False
        now = _time.monotonic()
        self.created = now
        self.last_used = now

    def trim(self, tail_points: int) -> None:
        del self.records[: max(0, len(self.records) - tail_points)]
        del self.replay[: max(0, len(self.replay) - tail_points)]

    # -- the handoff wire ----------------------------------------------------

    def to_wire(self) -> dict:
        """A JSON-able snapshot.  The beam's float32 values travel as
        Python floats (float32 -> float64 -> float32 is exact), so a handed
        off beam continues bit for bit on the importer.  A slab-resident
        beam reads back exactly its own slot (``carry_host``)."""
        carry = None
        c = carry_host(self.carry)
        if c is not None:
            carry = {
                "scores": [float(v) for v in c["scores"]],
                "edge": [int(v) for v in c["edge"]],
                "offset": [float(v) for v in c["offset"]],
                "x": float(c["x"]), "y": float(c["y"]), "t": float(c["t"]),
                "active": bool(c["active"]),
                "committed": int(c["committed"]),
            }
        return {
            "v": WIRE_VERSION,
            "uuid": self.uuid,
            "t0": self.t0,
            "seq": self.seq,
            "points_total": self.points_total,
            "params": list(self.pkey) if self.pkey else None,
            "carry": carry,
            "records": [[int(e), float(o), bool(b), float(t)]
                        for e, o, b, t in self.records],
            "replay": self.replay,
        }

    @classmethod
    def from_wire(cls, w: dict) -> "SessionState":
        pkey = tuple(float(v) for v in w["params"]) if w.get("params") else ()
        s = cls(str(w["uuid"]), float(w["t0"]), pkey)
        s.seq = int(w.get("seq", 0))
        s.points_total = int(w.get("points_total", 0))
        s.records = [(int(e), float(o), bool(b), float(t))
                     for e, o, b, t in w.get("records", ())]
        s.replay = [dict(p) for p in w.get("replay", ())]
        c = w.get("carry")
        if c is not None:
            s.carry = {
                "scores": np.asarray(c["scores"], np.float32),
                "edge": np.asarray(c["edge"], np.int32),
                "offset": np.asarray(c["offset"], np.float32),
                "x": np.float32(c["x"]), "y": np.float32(c["y"]),
                "t": np.float32(c["t"]),
                "active": bool(c["active"]),
                "committed": np.int32(c["committed"]),
            }
        else:
            # a replay-only payload rebuilds on its next step
            s.rebuild_pending = bool(s.replay)
        s.imported = True
        return s

    def meta(self) -> dict:
        """The ``"session"`` block of a streaming /report answer and the
        /sessions view of one session."""
        return {
            "uuid": self.uuid,
            "seq": self.seq,
            "points_total": self.points_total,
            "tail_points": len(self.records),
            "rebuild_pending": bool(self.rebuild_pending),
            "imported": bool(self.imported),
            "age_s": round(_time.monotonic() - self.created, 1),
        }


class SessionStore:
    """uuid -> SessionState, bounded (LRU) and TTL-evicted.  Expiry sweeps
    lazily on access; every removal frees the session's arena slot."""

    def __init__(self, max_sessions: int = 65536, ttl_s: float = 3600.0):
        self.max_sessions = max(1, int(max_sessions))
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        self._by_uuid: "OrderedDict[str, SessionState]" = OrderedDict()
        self._checkpointer: "Optional[SessionCheckpointer]" = None

    def attach_checkpointer(self, cp: "SessionCheckpointer") -> None:
        self._checkpointer = cp

    def notify_commit(self, uuid: str) -> None:
        """A step committed into ``uuid``'s session (called outside the
        store lock): checkpoint-dirty, or written at once in sync mode."""
        cp = self._checkpointer
        if cp is not None:
            cp.on_commit(uuid)

    def _notify_removed(self, uuid: str) -> None:
        cp = self._checkpointer
        if cp is not None:
            cp.on_removed(uuid)

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_uuid)

    def _expire_locked(self, now: float) -> None:
        if self.ttl_s <= 0:
            return
        dead = [u for u, s in self._by_uuid.items()
                if now - s.last_used > self.ttl_s]
        for u in dead:
            carry_free(self._by_uuid.pop(u).carry)
            C_SESSION_EVENTS.labels("expired").inc()
        if dead:
            G_SESSIONS.set(len(self._by_uuid))

    def _evict_locked(self) -> None:
        while len(self._by_uuid) >= self.max_sessions:
            carry_free(self._by_uuid.popitem(last=False)[1].carry)
            C_SESSION_EVENTS.labels("evicted").inc()

    def get_or_open(self, uuid: str, t0: float,
                    pkey: tuple = ()) -> SessionState:
        """The live session (its LRU/TTL clock touched), or a fresh one,
        evicting the least recently used past the bound.  A change of
        params key reopens the session (changed sigma_z invalidates the
        carried scores)."""
        now = _time.monotonic()
        with self._lock:
            self._expire_locked(now)
            s = self._by_uuid.get(uuid)
            if s is not None and s.pkey == pkey:
                s.last_used = now
                self._by_uuid.move_to_end(uuid)
                return s
            if s is not None:
                del self._by_uuid[uuid]
                carry_free(s.carry)
            self._evict_locked()
            s = self._by_uuid[uuid] = SessionState(uuid, t0, pkey)
            C_SESSION_EVENTS.labels("opened").inc()
            G_SESSIONS.set(len(self._by_uuid))
            return s

    def peek(self, uuid: str) -> Optional[SessionState]:
        with self._lock:
            return self._by_uuid.get(uuid)

    def drop(self, uuid: str) -> bool:
        with self._lock:
            s = self._by_uuid.pop(uuid, None)
            G_SESSIONS.set(len(self._by_uuid))
        if s is not None:
            carry_free(s.carry)
            self._notify_removed(uuid)
        return s is not None

    def pop_wire(self, uuids) -> List[dict]:
        """Atomic remove-and-serialise: the wires carry every point
        committed up to the pop, and nothing commits into the removed
        entries afterwards (a step in flight re-accounts itself in
        ``finalize``).  A slab-resident beam frees its slot first, which
        detaches the exact bytes into its ref; the wire reads those."""
        out = []
        with self._lock:
            for u in uuids:
                s = self._by_uuid.pop(str(u), None)
                if s is not None:
                    carry_free(s.carry)
                    out.append(s.to_wire())
            G_SESSIONS.set(len(self._by_uuid))
        for w in out:
            # the popped copy travels: its checkpoint file goes now, not at
            # the next sweep
            self._notify_removed(str(w.get("uuid")))
        if out:
            C_SESSION_EVENTS.labels("exported").inc(len(out))
        return out

    def finalize(self, sess: SessionState, step_points: int,
                 step_subs: int) -> None:
        """After a commit: if the session was popped or evicted while its
        step was in flight (the popped wire carried the ledger before the
        step), put it back holding only this step's points, or fold them
        into the session that took the uuid since."""
        with self._lock:
            cur = self._by_uuid.get(sess.uuid)
            if cur is sess:
                return
            if cur is not None:
                cur.points_total += step_points
                return
            sess.points_total = step_points
            sess.seq = step_subs
            sess.last_used = _time.monotonic()
            self._by_uuid[sess.uuid] = sess
            C_SESSION_EVENTS.labels("reattached").inc()
            G_SESSIONS.set(len(self._by_uuid))

    def export_all(self) -> List[dict]:
        """Every live session's wire snapshot (non-destructive: the
        importer skips nothing, it merges a uuid that went live there)."""
        with self._lock:
            out = [s.to_wire() for s in self._by_uuid.values()]
        C_SESSION_EVENTS.labels("exported").inc(len(out))
        return out

    def import_wire(self, wires: List[dict]) -> dict:
        """The importing side of a handoff.  A uuid with no local session
        lands as it is: with its beam when the wire carries one, else
        flagged to rebuild from its replay on the next step.  A uuid that
        is live here already merges: the imported replay's points not in
        the live replay (by raw point identity) go before it, the live
        decode is flagged to rebuild over both, and the ledger takes the
        imported count less the shared points."""
        skipped = rebuild = merged = 0
        imported: List[str] = []
        now = _time.monotonic()
        states = []
        for w in wires:
            try:
                states.append(SessionState.from_wire(w))
            except (KeyError, TypeError, ValueError):
                skipped += 1
        with self._lock:
            self._expire_locked(now)
            for s in states:
                live = self._by_uuid.get(s.uuid)
                if live is not None:
                    live_keys = {_point_key(p) for p in live.replay}
                    fresh = [p for p in s.replay if _point_key(p) not in live_keys]
                    dup = len(s.replay) - len(fresh)
                    live.points_total += max(0, s.points_total - dup)
                    live.seq += s.seq
                    if fresh:
                        live.replay = fresh + live.replay
                        live.rebuild_pending = True
                    live.imported = True
                    merged += 1
                    imported.append(s.uuid)
                    C_SESSION_EVENTS.labels("import_merged").inc()
                    continue
                self._evict_locked()
                s.last_used = now
                self._by_uuid[s.uuid] = s
                imported.append(s.uuid)
                rebuild += s.rebuild_pending
                C_SESSION_EVENTS.labels("imported").inc()
            G_SESSIONS.set(len(self._by_uuid))
        # imported sessions are checkpoint-dirty on their new home
        for u in imported:
            self.notify_commit(u)
        return {"imported": len(imported) - merged, "merged": merged,
                "skipped": skipped, "rebuild_pending": rebuild,
                "imported_uuids": imported}

    def wire_of(self, uuid: str) -> Optional[dict]:
        """One session's wire snapshot under the store lock (None when it
        is gone): the checkpointer's consistent read."""
        with self._lock:
            s = self._by_uuid.get(uuid)
            return s.to_wire() if s is not None else None

    def uuids(self) -> List[str]:
        with self._lock:
            return list(self._by_uuid)

    def summary(self) -> dict:
        with self._lock:
            n = len(self._by_uuid)
            pts = sum(s.points_total for s in self._by_uuid.values())
        return {"sessions": n, "points_total": pts,
                "max_sessions": self.max_sessions, "ttl_s": self.ttl_s}

    def resident_bytes(self) -> int:
        """Payload bytes the store holds on the host: per session 17 B a
        record (i32 + f32 + bool + f64), 24 B a replay point and a host
        beam's array bytes + 16 B of scalars (a slab-resident beam is the
        arena's)."""
        total = 0
        with self._lock:
            for s in self._by_uuid.values():
                total += 17 * len(s.records) + 24 * len(s.replay)
                c = s.carry
                if isinstance(c, dict):
                    for key in ("scores", "edge", "offset"):
                        arr = c.get(key)
                        nb = getattr(arr, "nbytes", None)
                        total += int(nb) if nb is not None else 4 * len(arr or ())
                    total += 16
        return total


class SessionEngine:
    """The streaming match engine of the service's session MicroBatcher.
    Speaks the matcher's batching contract (``match_many_async(traces) ->
    finish``), so submits batch like windowed ones and take the same fault
    domains.

    A session's records, tail and replay buffer change only in
    ``finish()``, after the device answered.  Its beam does too on the
    host-carry path, but not on the slab path: the step writes the
    successor beam into the session's slot at dispatch.  A step that fails
    after its launch (association or rendering raising) therefore leaves
    the slab advanced and the records not, and a retried submit decodes
    its points a second time from the advanced beam, as the reference
    does.

    ``invalidate_inflight`` (the service calls it when a batcher wedges or
    crashes) bumps a generation: a step dispatched before it, whose
    futures were failed, commits nothing when its finish wakes late."""

    def __init__(self, matcher, store: SessionStore, tail_points: int = 64):
        self.matcher = matcher
        self.store = store
        self.tail_points = max(2, int(tail_points))
        # serialises _apply (the finisher) with degraded_step (handlers)
        self._lock = threading.Lock()
        self._generation = 0

    def invalidate_inflight(self) -> None:
        with self._lock:
            self._generation += 1

    def match_many(self, traces) -> List[dict]:
        return self.match_many_async(traces)()

    def match_many_async(self, traces):
        # the windowed engine's fault seam: uuid:<u> poisons any batch
        # carrying that vehicle's step
        faults.maybe_raise("dispatch", key=",".join(
            str(t.get("uuid", "")) for t in traces if isinstance(t, dict)))
        m = self.matcher
        # group by uuid in arrival order: two submits of one vehicle in one
        # batch chain (the second sees the first's carry), so they fold
        # into one step and split back into per-request answers
        order: "OrderedDict[str, dict]" = OrderedDict()
        for i, tr in enumerate(traces):
            uuid = str(tr.get("uuid") or "")
            ent = order.get(uuid)
            if ent is None:
                ent = order[uuid] = {"uuid": uuid, "pkey": m._params_key(tr),
                                     "raw_subs": []}
            ent["raw_subs"].append((i, list(tr.get("trace") or ())))

        # resolve sessions and build the step items (the store is only read
        # here).  Admission drops a point whose (time, lat, lon) is already
        # in the session's replay buffer: a retried submit commits once and
        # still gets a full answer from the tail.  A session flagged for a
        # rebuild steps its replay buffer + the new points from no carry.
        items, dispatch_map = [], []
        for ent in order.values():
            raw_first = next((p for _i, pts in ent["raw_subs"] for p in pts),
                             None)
            t_first = float(raw_first["time"]) if raw_first else 0.0
            sess = ent["sess"] = self.store.get_or_open(ent["uuid"], t_first,
                                                        ent["pkey"])
            seen = {_point_key(p) for p in sess.replay}
            subs, points = [], []
            dups = 0
            for i, pts in ent["raw_subs"]:
                fresh = []
                for p in pts:
                    key = _point_key(p)
                    if key not in seen:
                        seen.add(key)
                        fresh.append(p)
                    else:
                        dups += 1
                subs.append((i, len(points), len(fresh)))
                points.extend(fresh)
            ent["subs"] = subs
            ent["points"] = points
            if dups:
                C_SESSION_DEDUP.inc(dups)
            rebuild = ent["rebuild"] = sess.rebuild_pending and bool(sess.replay)
            ent["noop"] = not points and not rebuild
            if ent["noop"]:
                continue  # duplicates only: answered from the tail
            ent["n_prefix"] = len(sess.replay) if rebuild else 0
            dispatch_map.append(ent)
            items.append({"points": (list(sess.replay) + points) if rebuild else points,
                          "carry": None if rebuild else sess.carry,
                          "t0": sess.t0, "pkey": ent["pkey"],
                          "uuid": ent["uuid"]})
        entries = list(order.values())
        H_STEP_SESSIONS.observe(len(entries))
        gen = self._generation
        finish_dev = m.match_sessions_async(items)

        def finish() -> List[dict]:
            step_out = finish_dev()
            results: List[Optional[dict]] = [None] * len(traces)
            with self._lock:
                if gen != self._generation:
                    # wedged or crashed while in flight: the futures are
                    # failed already; commit and answer nothing
                    return results  # type: ignore[return-value]
                for ent, (rec, aux, carry_out) in zip(dispatch_map, step_out):
                    self._apply(ent, rec, aux, carry_out, results)
                for ent in entries:
                    if ent["noop"]:
                        self._answer_noop(ent, results)
            return results  # type: ignore[return-value]

        return finish

    def _answer_noop(self, ent: dict, results) -> None:
        """Answer duplicate-only submits from the tail, committing nothing."""
        sess: SessionState = ent["sess"]
        for i, _p0, _n in ent["subs"]:
            results[i] = self._render(
                list(sess.records), list(sess.replay), None,
                meta=dict(sess.meta(), points=0, deduped=True))

    def _apply(self, ent: dict, rec, aux, carry_out, results) -> None:
        """Fold one session's step result into it and render the answers of
        its submits.  rec: (edge[n], offset[n], breaks[n]) numpy over the
        step's points, a rebuild's replay prefix included."""
        sess: SessionState = ent["sess"]
        edge, offset, breaks = rec
        pts = ent["points"]
        step_pts = (list(sess.replay) + pts) if ent["rebuild"] else pts
        new_recs = [(int(edge[j]), float(np.float32(offset[j])), bool(breaks[j]),
                     float(step_pts[j]["time"])) for j in range(len(step_pts))]
        tail_raw = list(sess.replay)
        if ent["rebuild"]:
            # the replay prefix's records replace the stale tail
            n_prefix = ent["n_prefix"]
            tail_recs, new_recs = new_recs[:n_prefix], new_recs[n_prefix:]
            sess.rebuild_pending = False
            C_SESSION_EVENTS.labels("rebuilt").inc()
        else:
            tail_recs = list(sess.records)
        # each answer covers the tail + its own (and earlier same-batch)
        # points: the accumulated recent shape the incremental contract
        # reports over
        for k, (i, p0, n) in enumerate(ent["subs"]):
            win_recs = tail_recs + new_recs[: p0 + n]
            results[i] = self._render(
                win_recs, tail_raw + pts[: p0 + n], aux,
                meta=dict(sess.meta(), points=n, seq=sess.seq + k + 1,
                          points_total=sess.points_total + p0 + n,
                          tail_points=len(win_recs), rebuilt=ent["rebuild"]))
        # commit (success only).  An old arena slot is freed when the new
        # carry no longer covers it (a host-carry step), not when the step
        # wrote the successor into the same uuid's slot.
        old = sess.carry
        sess.carry = carry_out
        if (old is not None and old is not carry_out
                and not isinstance(old, dict)
                and getattr(carry_out, "uuid", None) != old.uuid):
            carry_free(old)
        sess.records = tail_recs + new_recs
        sess.replay = tail_raw + [
            {"lat": p["lat"], "lon": p["lon"], "time": p["time"]} for p in pts]
        sess.trim(self.tail_points)
        sess.seq += len(ent["subs"])
        sess.points_total += len(pts)
        C_SESSION_POINTS.inc(len(pts))
        self.store.finalize(sess, step_points=len(pts),
                            step_subs=len(ent["subs"]))
        self.store.notify_commit(sess.uuid)

    def _render(self, win_recs, win_raw, aux, meta: dict) -> dict:
        """One answer window as a wire match dict; ``_stream`` carries the
        window's raw points and the session block to the service."""
        m = self.matcher
        n = len(win_recs)
        match: dict = {"segments": self.associate(win_recs),
                       "_stream": {"trace": win_raw, "session": meta}}
        if m.cfg.quality_aux:
            q: dict = {"edge": [r[0] for r in win_recs], "n_points": n,
                       "breaks": sum(1 for r in win_recs if r[2])}
            if aux is not None:
                mn, sm, nm, nx = (float(v) for v in aux)
                q["margin_min"] = round(mn, 4) if nm > 0 else None
                q["margin_mean"] = round(sm / nm, 4) if nm > 0 else None
                q["pool_exhausted_frac"] = round(nx / n, 4) if n else 0.0
            match["_quality"] = q
        return match

    def associate(self, recs) -> List[dict]:
        """Wire-format association over a window of per-point records: the
        windowed path's native batch walk, so equal records render equal
        segments."""
        m = self.matcher
        n = len(recs)
        if n == 0:
            return []
        return associate_segments_batch(
            m.arrays, m.ubodt,
            np.asarray([[r[0] for r in recs]], np.int32),
            np.asarray([[r[1] for r in recs]], np.float32),
            np.asarray([[r[2] for r in recs]], bool),
            np.asarray([[r[3] for r in recs]], np.float64), [n],
            queue_thresh_mps=m.cfg.queue_speed_threshold_kph / 3.6,
            back_tol=2.0 * m.cfg.sigma_z + 5.0)[0]

    def degraded_step(self, cpu_matcher, trace: dict) -> dict:
        """A streaming submit answered by the CPU baseline while the device
        is wedged: the session's replay buffer + the new points match as
        one windowed trace, and the beam is dropped (its next healthy step
        rebuilds from the replay), so sessions survive the degraded
        window."""
        uuid = str(trace.get("uuid") or "")
        pts = list(trace.get("trace") or ())
        pkey = self.matcher._params_key(trace)
        t_first = float(pts[0]["time"]) if pts else 0.0
        with self._lock:
            sess = self.store.get_or_open(uuid, t_first, pkey)
            seen = {_point_key(p) for p in sess.replay}
            fresh = [p for p in pts if _point_key(p) not in seen]
            if len(fresh) < len(pts):
                C_SESSION_DEDUP.inc(len(pts) - len(fresh))
            pts = fresh
            win_raw = list(sess.replay) + [
                {"lat": p["lat"], "lon": p["lon"], "time": p["time"]} for p in pts]
            if len(win_raw) >= 2:
                match = cpu_matcher.match_many([{"uuid": uuid, "trace": win_raw}])[0]
                match.pop("_quality", None)
            else:
                match = {"segments": []}
            # raw points recorded, matched records dropped (the baseline's
            # choices must not enter the device chain), the beam dropped
            sess.replay = win_raw
            sess.records = []
            carry_free(sess.carry)
            sess.carry = None
            sess.rebuild_pending = True
            sess.trim(self.tail_points)
            sess.seq += 1
            sess.points_total += len(pts)
            C_SESSION_POINTS.inc(len(pts))
            self.store.finalize(sess, step_points=len(pts), step_subs=1)
            self.store.notify_commit(sess.uuid)
            match["_stream"] = {
                "trace": win_raw,
                "session": dict(sess.meta(), points=len(pts), degraded=True)}
            return match


class SessionCheckpointer:
    """Dirty sessions' wire snapshots as atomic per-uuid JSON files in a
    directory of their own (one per replica), so a killed process's
    sessions can be restored instead of rebuilt.

      cadence   a background sweep every ``cadence_s`` seconds writes every
                dirty session (tmp + rename per uuid) and prunes the files
                of sessions that left the store;
      sync      (``sync=True``) each commit also writes its session before
                the answer leaves the batcher.

    ``pop`` and ``drop`` remove a file at once (a moved beam must not be
    restored from a stale file); expiry and eviction wait for the sweep.
    ``start`` clears the directory first.  File names are percent-encoded
    uuids (client data never names a path raw).  The written / pruned /
    cleared / error totals are ``reporter_session_checkpoints_total``'s
    (by ``event``)."""

    def __init__(self, store: SessionStore, dirpath: str,
                 cadence_s: float, sync: bool = False):
        self.store = store
        self.dir = dirpath
        self.cadence_s = float(cadence_s)
        self.sync = bool(sync)
        self._dirty: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(self.dir, exist_ok=True)
        store.attach_checkpointer(self)

    @staticmethod
    def _path_name(uuid: str) -> str:
        return quote(uuid, safe="") + ".json"

    def _path(self, uuid: str) -> str:
        return os.path.join(self.dir, self._path_name(uuid))

    @staticmethod
    def _uuid_of(fname: str) -> Optional[str]:
        if not fname.endswith(".json"):
            return None
        return unquote(fname[:-5])

    @staticmethod
    def _count(what: str, n: int = 1) -> None:
        if n:
            C_CKPT.labels(what).inc(n)

    def start(self) -> None:
        self.clear()
        if self.cadence_s > 0:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="session-checkpoint")
            self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def _unlink_files(self, keep=frozenset()) -> int:
        """Remove the directory's checkpoint files whose uuid is not in
        ``keep``; other files stay."""
        n = 0
        try:
            names = os.listdir(self.dir)
        except OSError:
            return 0
        for fname in names:
            u = self._uuid_of(fname)
            if u is None or u in keep:
                continue
            try:
                os.unlink(os.path.join(self.dir, fname))
                n += 1
            except OSError:
                pass
        return n

    def clear(self) -> int:
        """Empty the directory of checkpoint files (at start: a previous
        process's files are not this one's live state)."""
        n = self._unlink_files()
        self._count("cleared", n)
        return n

    def on_commit(self, uuid: str) -> None:
        if self.sync:
            self._write(uuid)
            return
        with self._lock:
            self._dirty.add(uuid)

    def on_removed(self, uuid: str) -> None:
        with self._lock:
            self._dirty.discard(uuid)
        try:
            os.unlink(self._path(uuid))
        except OSError:
            return
        self._count("pruned")

    def _write(self, uuid: str) -> bool:
        wire = self.store.wire_of(uuid)
        if wire is None:
            return False
        path = self._path(uuid)
        tmp = "%s.%d.tmp" % (path, os.getpid())
        try:
            with open(tmp, "w") as f:
                json.dump(wire, f, separators=(",", ":"))
            os.replace(tmp, path)
        except OSError:
            self._count("error")
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        self._count("written")
        return True

    def sweep(self) -> dict:
        """One pass: write every dirty session, prune the files of sessions
        no longer in the store."""
        with self._lock:
            dirty = list(self._dirty)
            self._dirty.clear()
        written = sum(1 for u in dirty if self._write(u))
        pruned = self._unlink_files(keep=set(self.store.uuids()))
        self._count("pruned", pruned)
        with self._lock:
            remaining = len(self._dirty)
        return {"written": written, "pruned": pruned, "dirty_remaining": remaining}

    def _loop(self) -> None:
        while not self._stop.wait(self.cadence_s):
            try:
                self.sweep()
            except Exception:  # noqa: BLE001 - checkpointing must not die
                log.exception("session checkpoint sweep failed")

    def summary(self) -> dict:
        with self._lock:
            dirty = len(self._dirty)
        try:
            files = sum(1 for f in os.listdir(self.dir) if self._uuid_of(f) is not None)
        except OSError:
            files = None
        return {"dir": self.dir, "cadence_s": self.cadence_s, "sync": self.sync,
                "dirty": dirty, "files": files}


def read_checkpoints(dirpath: str) -> List[dict]:
    """Every session wire snapshot under ``dirpath``, by file name;
    unreadable files are skipped with a warning (a torn write must not stop
    the rest from being restored)."""
    out: List[dict] = []
    try:
        names = sorted(os.listdir(dirpath))
    except OSError:
        return out
    for fname in names:
        if SessionCheckpointer._uuid_of(fname) is None:
            continue
        try:
            with open(os.path.join(dirpath, fname)) as f:
                out.append(json.load(f))
        except (OSError, ValueError) as e:
            log.warning("unreadable session checkpoint %s: %s", fname, str(e)[:200])
    return out
