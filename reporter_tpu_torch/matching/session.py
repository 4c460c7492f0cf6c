"""Per-vehicle matching sessions: the carried Viterbi beam as serving state.

The windowed path makes every point wait for its window.  A session keeps
the beam the long-trace chain carries across windows, keyed by vehicle
uuid, so each arriving point costs one row of a small [B, W] session step
and is answered at once.

  SessionState   one vehicle's live decode: the carried beam (a host dict,
                 or an ``ArenaRef`` when it lives in the device slab), the
                 epoch its float32 times are rebased to, and a bounded
                 rolling tail of matched per-point records with the raw
                 points behind them (the association context of the next
                 answer).
  SessionStore   uuid -> SessionState, LRU-bounded and TTL-evicted.
  SessionEngine  the engine the service mounts in its session MicroBatcher:
                 it folds the streaming submits of many vehicles into
                 ``SegmentMatcher.match_sessions_async`` steps, commits to
                 the store only after the device answered, and renders
                 each answer by associating the session's tail plus the
                 new points.

Not ported yet: the checkpointer, the /sessions wire export and import,
the rebuild from a replay buffer, and the degraded CPU step.
"""

from __future__ import annotations

import threading
import time as _time
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from .arena import carry_free
from .assoc_native import associate_segments_batch


class SessionState:
    """One vehicle's live decode.  The store lock serialises its metadata
    and the single-worker engine serialises its steps."""

    __slots__ = ("uuid", "t0", "carry", "records", "replay", "seq",
                 "points_total", "pkey", "last_used", "created")

    def __init__(self, uuid: str, t0: float, pkey: tuple = ()):
        self.uuid = uuid
        # rebase epoch of the float32 device times: epoch seconds would
        # lose the dt resolution the time-factor cut needs
        self.t0 = float(t0)
        # the carried beam: None until the first step lands
        self.carry = None
        # rolling tail of matched per-point records, newest last: (edge,
        # offset, break, epoch time), and the raw points behind them
        self.records: List[Tuple[int, float, bool, float]] = []
        self.replay: List[dict] = []
        self.seq = 0            # steps applied
        self.points_total = 0   # points ever folded in
        self.pkey = pkey
        now = _time.monotonic()
        self.created = now
        self.last_used = now

    def trim(self, tail_points: int) -> None:
        del self.records[: max(0, len(self.records) - tail_points)]
        del self.replay[: max(0, len(self.replay) - tail_points)]

    def meta(self) -> dict:
        """The ``"session"`` block of a streaming /report answer."""
        return {
            "uuid": self.uuid,
            "seq": self.seq,
            "points_total": self.points_total,
            "tail_points": len(self.records),
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

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_uuid)

    def _expire_locked(self, now: float) -> None:
        if self.ttl_s <= 0:
            return
        for u in [u for u, s in self._by_uuid.items()
                  if now - s.last_used > self.ttl_s]:
            carry_free(self._by_uuid.pop(u).carry)

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
            while len(self._by_uuid) >= self.max_sessions:
                carry_free(self._by_uuid.popitem(last=False)[1].carry)
            s = self._by_uuid[uuid] = SessionState(uuid, t0, pkey)
            return s

    def peek(self, uuid: str) -> Optional[SessionState]:
        with self._lock:
            return self._by_uuid.get(uuid)

    def drop(self, uuid: str) -> bool:
        with self._lock:
            s = self._by_uuid.pop(uuid, None)
        if s is not None:
            carry_free(s.carry)
        return s is not None

    def finalize(self, sess: SessionState, step_points: int,
                 step_subs: int) -> None:
        """After a commit: if the session was evicted while its step was in
        flight, put it back holding only this step's points (or fold them
        into the session that took the uuid since)."""
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

    def uuids(self) -> List[str]:
        with self._lock:
            return list(self._by_uuid)

    def summary(self) -> dict:
        with self._lock:
            n = len(self._by_uuid)
            pts = sum(s.points_total for s in self._by_uuid.values())
        return {"sessions": n, "points_total": pts,
                "max_sessions": self.max_sessions, "ttl_s": self.ttl_s}


class SessionEngine:
    """The streaming match engine of the service's session MicroBatcher.
    Speaks the matcher's batching contract (``match_many_async(traces) ->
    finish``), so submits batch like windowed ones.

    A session's records, tail and replay buffer change only in
    ``finish()``, after the device answered.  Its beam does too on the
    host-carry path, but not on the slab path: the step writes the
    successor beam into the session's slot at dispatch.  A step that fails
    after its launch (association or rendering raising) therefore leaves
    the slab advanced and the records not, and a retried submit decodes
    its points a second time from the advanced beam, as the reference
    does."""

    def __init__(self, matcher, store: SessionStore, tail_points: int = 64):
        self.matcher = matcher
        self.store = store
        self.tail_points = max(2, int(tail_points))
        self._lock = threading.Lock()

    def match_many(self, traces) -> List[dict]:
        return self.match_many_async(traces)()

    def match_many_async(self, traces):
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
        # still gets a full answer from the tail.
        items, dispatch_map = [], []
        for ent in order.values():
            raw_first = next((p for _i, pts in ent["raw_subs"] for p in pts),
                             None)
            t_first = float(raw_first["time"]) if raw_first else 0.0
            sess = ent["sess"] = self.store.get_or_open(ent["uuid"], t_first,
                                                        ent["pkey"])
            seen = {(p.get("time"), p.get("lat"), p.get("lon"))
                    for p in sess.replay}
            subs, points = [], []
            for i, pts in ent["raw_subs"]:
                fresh = []
                for p in pts:
                    key = (p.get("time"), p.get("lat"), p.get("lon"))
                    if key not in seen:
                        seen.add(key)
                        fresh.append(p)
                subs.append((i, len(points), len(fresh)))
                points.extend(fresh)
            ent["subs"] = subs
            ent["points"] = points
            if not points:
                continue  # duplicates only: answered from the tail
            dispatch_map.append(ent)
            items.append({"points": points, "carry": sess.carry,
                          "t0": sess.t0, "pkey": ent["pkey"],
                          "uuid": ent["uuid"]})
        entries = list(order.values())
        finish_dev = m.match_sessions_async(items)

        def finish() -> List[dict]:
            step_out = finish_dev()
            results: List[Optional[dict]] = [None] * len(traces)
            with self._lock:
                for ent, (rec, aux, carry_out) in zip(dispatch_map, step_out):
                    self._apply(ent, rec, aux, carry_out, results)
                for ent in entries:
                    if not ent["points"]:
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
        its submits.  rec: (edge[n], offset[n], breaks[n]) numpy."""
        sess: SessionState = ent["sess"]
        edge, offset, breaks = rec
        pts = ent["points"]
        new_recs = [(int(edge[j]), float(np.float32(offset[j])), bool(breaks[j]),
                     float(pts[j]["time"])) for j in range(len(pts))]
        tail_recs = list(sess.records)
        tail_raw = list(sess.replay)
        # each answer covers the tail + its own (and earlier same-batch)
        # points: the accumulated recent shape the incremental contract
        # reports over
        for k, (i, p0, n) in enumerate(ent["subs"]):
            win_recs = tail_recs + new_recs[: p0 + n]
            results[i] = self._render(
                win_recs, tail_raw + pts[: p0 + n], aux,
                meta=dict(sess.meta(), points=n, seq=sess.seq + k + 1,
                          points_total=sess.points_total + p0 + n,
                          tail_points=len(win_recs)))
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
        self.store.finalize(sess, step_points=len(pts),
                            step_subs=len(ent["subs"]))

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
