"""Device-resident session arena: carried Viterbi beams as slot-mapped
device state, with a byte budget and a pinned host cold tier.

A session step on the host-carry path uploads a [B, K] carry batch before
the step and reads the successors back after it.  With the arena the
beams stay on the device: a ``TraceCarry`` slab with leading [S] is
addressed by slot index, and ``ops/viterbi.session_step_arena`` reads each
row's beam from its slot and writes the successor back in place, in the
same launch as the decode (kernel 5).  The beams never cross to the host
while a session streams.

The session plane stays device-agnostic by duck typing: ``SessionState
.carry`` may hold an :class:`ArenaRef` instead of a host dict, and every
reader that needs host bytes goes through ``carry_host`` (a counted
readback of that one slot).  A freed or reused slot detaches its beam into
the live ref first, so a handle captured before the free still resolves
to the exact bytes.

Tiers (the port of ``reporter_tpu/matching/arena.py``): the hot slab holds
``min(max_sessions, hot_bytes // slot_bytes)`` slots (``hot_bytes`` 0:
``max_sessions``), ``slot_bytes = 12 K + 17``.  When a step group needs a
slot and none is free, the hot session with the lowest probe-frequency
EWMA (decay 0.8 per acquire, applied lazily) outside the group is demoted
to a cold page: one row of a preallocated host slab of ``cold_bytes //
slot_bytes`` pages (0: 4x the hot slots), pinned on the card's host.
When the cold tier is full, its coldest page spills: the beam detaches
into its ref as a host dict.  A cold session's next step promotes its page
back into a hot slot.  Promotion and demotion are row copies on the
device's current stream, in order with the steps; a host read of a cold
page waits for the stream first.  A group wider than the whole slab takes
the host-carry path, bit for bit the same.

On a device mesh (``mesh``, ``parallel/mesh.py``) the slab's slot axis is
split over the dp ranks (the rule table's ``slab`` row): rank r holds
slots [r * S_local, (r + 1) * S_local) on its device, ``hot`` is the list
of the ranks' shards and the step is ``ops/viterbi.session_step_arena_mesh``.
The byte budget is per device, so it multiplies by the mesh's device
count, and the slot count rounds up to a multiple of the dp ranks, as in
the reference.  Demotion, promotion and readback address a slot's row in
its shard; the cold tier is one pinned host slab, as on one device.

Concurrency: one re-entrant ``lock`` serialises every slab access; the
dispatcher holds it across acquire -> step launch.  The step updates the
slab on the device stream, in order with every later read.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..convert import carry_from_numpy
from ..obs import metrics as obs
from ..ops.viterbi import TraceCarry, initial_carry_batch
from ..parallel.rules import BATCH_AXIS, spec_for

# the slab's flows, fed by every slab's promotions / evictions / readbacks
C_ARENA_PROMOTIONS = obs.counter(
    "reporter_session_arena_promotions_total",
    "Carried beams promoted into the hot session-arena slab (fresh "
    "uploads, cold-page promotions, imported handoff beams)")
C_ARENA_EVICTIONS = obs.counter(
    "reporter_session_arena_evictions_total",
    "Carried beams demoted out of the hot session-arena slab (to "
    "pinned_host cold pages, or spilled to the host wire form)")
C_ARENA_READBACKS = obs.counter(
    "reporter_session_arena_readbacks_total",
    "Device->host beam readbacks from the session arena (checkpoint / "
    "export / drain / spill reads of touched slots — steady-state "
    "streaming performs none)")

log = logging.getLogger(__name__)

# the EWMA decay per acquire tick: a session untouched for ~10 steps of
# other traffic has its frequency halved about three times
_EWMA_DECAY = 0.8

class ArenaRef:
    """One session's handle into the arena, what ``SessionState.carry``
    holds while its beam is device-resident: ``read()`` gives the host
    carry dict (a counted readback), ``free()`` releases the slot."""

    __slots__ = ("arena", "uuid", "_detached")

    def __init__(self, arena: "SessionArena", uuid: str):
        self.arena = arena
        self.uuid = uuid
        self._detached: Optional[dict] = None

    def read(self) -> Optional[dict]:
        if self._detached is not None:
            return self._detached
        return self.arena.read_uuid(self.uuid)

    def free(self) -> None:
        self.arena.free_uuid(self.uuid)


def carry_host(c) -> Optional[dict]:
    """A host carry dict (or None) from either carry representation."""
    if c is None or isinstance(c, dict):
        return c
    return c.read()


def carry_free(c) -> None:
    """Release a carry's arena slot if it holds one (no-op for host dicts
    and None)."""
    if c is not None and not isinstance(c, dict):
        c.free()


class SessionArena:
    """The slot-mapped beam store: a ``TraceCarry`` slab with leading
    [hot_slots] on ``device`` and a cold slab of [cold_slots] pages in
    host memory (pinned when ``device`` is a card).  ``acquire_batch`` and
    the step launch that uses its slots must run inside one ``with
    arena.lock:`` section."""

    def __init__(self, beam_k: int, max_sessions: int = 65536, device="cuda",
                 hot_bytes: int = 0, cold_bytes: int = 0, mesh=None):
        self.beam_k = int(beam_k)
        # per-slot payload: scores/edge/offset [K] at 4 B, x/y/t/committed
        # at 4 B, active at 1 B
        self.slot_bytes = 12 * self.beam_k + 17
        self.devices = 1 if mesh is None else mesh.n_dp * mesh.n_gp
        n_dp = 1
        if mesh is not None and BATCH_AXIS in spec_for("slab", mesh):
            n_dp = mesh.n_dp
        cap = max(1, int(max_sessions))
        self.hot_slots = (max(1, min(cap, int(hot_bytes) * self.devices
                                     // self.slot_bytes))
                          if hot_bytes and int(hot_bytes) > 0 else cap)
        # the sharded slab splits its slot axis evenly over the dp ranks
        self.hot_slots = -(-self.hot_slots // n_dp) * n_dp
        self.cold_slots = (max(0, int(cold_bytes) // self.slot_bytes)
                           if cold_bytes and int(cold_bytes) > 0
                           else 4 * self.hot_slots)
        self.lock = threading.RLock()
        self._s_local = self.hot_slots // n_dp
        devs = [device] if mesh is None else mesh.dp_devices
        self._shards = [initial_carry_batch(self._s_local, self.beam_k, d)
                        for d in devs]
        self._hot = self._shards[0] if mesh is None else self._shards
        self._dev = self._shards[0].scores.device
        pin = self._dev.type == "cuda"
        self._cold_slab = TraceCarry(*(
            torch.empty((self.cold_slots,) + tuple(t.shape[1:]), dtype=t.dtype,
                        pin_memory=pin) for t in self._shards[0]))
        self.cold_memory_kind = "pinned_host" if pin else "host"
        # uuid -> hot slot / cold page; both free-listed
        self._slot_of: Dict[str, int] = {}
        self._free: List[int] = list(range(self.hot_slots - 1, -1, -1))
        self._cold: Dict[str, int] = {}
        self._cold_free: List[int] = list(range(self.cold_slots - 1, -1, -1))
        self._refs: Dict[str, ArenaRef] = {}
        # uuid -> (ewma, last tick); decay applies lazily
        self._freq: Dict[str, Tuple[float, int]] = {}
        self._tick = 0
        self.promotions = 0
        self.evictions = 0
        self.readbacks = 0
        log.info("session arena: %d hot slots of %d B on %s, %d cold pages "
                 "(%s)", self.hot_slots, self.slot_bytes, device,
                 self.cold_slots, self.cold_memory_kind)

    @property
    def hot(self):
        """The slab (use under ``lock``; the step updates it in place): a
        ``TraceCarry`` with leading [hot_slots], or on a mesh the dp
        ranks' shards."""
        return self._hot

    def _hot_row(self, slot: int):
        """(the shard holding ``slot``, its row there)."""
        return self._shards[slot // self._s_local], slot % self._s_local

    def _sync(self) -> None:
        """Wait for what the streams of the slab's devices have queued."""
        for dev in {sh.scores.device for sh in self._shards}:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

    def ref_for(self, uuid: str) -> ArenaRef:
        with self.lock:
            r = self._refs.get(uuid)
            if r is None or r._detached is not None:
                r = self._refs[uuid] = ArenaRef(self, uuid)
            return r

    # -- the EWMA ------------------------------------------------------------

    def _eff_freq(self, uuid: str) -> float:
        f = self._freq.get(uuid)
        if f is None:
            return 0.0
        ewma, last = f
        return ewma * (_EWMA_DECAY ** max(0, self._tick - last))

    def _touch(self, uuid: str) -> None:
        self._freq[uuid] = (self._eff_freq(uuid) + 1.0, self._tick)

    # -- row plumbing --------------------------------------------------------

    def _set_row(self, slot: int, c: dict) -> None:
        rows, i = self._hot_row(slot)
        for leaf, v in zip(rows, carry_from_numpy(c)):
            leaf[i].copy_(v)

    @staticmethod
    def _dict_of(rows: TraceCarry, i: int) -> dict:
        # a copy: on the CPU .cpu() would share the slab's row, which a
        # later step or demotion overwrites
        row = {n: t[i].to("cpu", copy=True).numpy()
               for n, t in zip(TraceCarry._fields, rows)}
        row["x"], row["y"], row["t"] = row["x"][()], row["y"][()], row["t"][()]
        row["active"] = bool(row["active"])
        row["committed"] = row["committed"][()]
        return row

    def _cold_dict(self, page: int) -> dict:
        """A cold page as a host dict, once the streams have written it."""
        self._sync()
        return self._dict_of(self._cold_slab, page)

    def _victim_locked(self, pinned) -> Optional[str]:
        """The hot uuid of lowest effective frequency outside ``pinned``."""
        best_u, best_f = None, None
        for u in self._slot_of:
            if u in pinned:
                continue
            f = self._eff_freq(u)
            if best_f is None or f < best_f:
                best_u, best_f = u, f
        return best_u

    def _detach_locked(self, uuid: str, row: dict) -> None:
        """A beam squeezed out of both tiers: into its ref, as a host
        dict."""
        ref = self._refs.get(uuid)
        if ref is not None:
            ref._detached = row
            self.readbacks += 1
            C_ARENA_READBACKS.inc()
            self._refs.pop(uuid, None)
        self._freq.pop(uuid, None)
        self.evictions += 1
        C_ARENA_EVICTIONS.inc()

    def _spill_cold_locked(self) -> None:
        """Detach the coldest cold page into its ref."""
        best_u, best_f = None, None
        for u in self._cold:
            f = self._eff_freq(u)
            if best_f is None or f < best_f:
                best_u, best_f = u, f
        if best_u is None:
            return
        page = self._cold.pop(best_u)
        row = self._cold_dict(page)
        self._cold_free.append(page)
        self._detach_locked(best_u, row)

    def _demote_locked(self, uuid: str) -> None:
        """hot -> cold: the beam's row copied to a cold page (a host detach
        when the cold tier holds nothing)."""
        slot = self._slot_of.pop(uuid)
        self._free.append(slot)
        if self.cold_slots > 0:
            if len(self._cold) >= self.cold_slots:
                self._spill_cold_locked()
            if len(self._cold) < self.cold_slots:
                page = self._cold_free.pop()
                rows, i = self._hot_row(slot)
                for c, h in zip(self._cold_slab, rows):
                    c[page].copy_(h[i], non_blocking=True)
                self._cold[uuid] = page
                self.evictions += 1
                C_ARENA_EVICTIONS.inc()
                return
        self._detach_locked(uuid, self._dict_of(*self._hot_row(slot)))

    def _alloc_slot_locked(self, pinned) -> Optional[int]:
        if self._free:
            return self._free.pop()
        victim = self._victim_locked(pinned)
        if victim is None:
            return None
        self._demote_locked(victim)
        return self._free.pop()

    def _drop_cold_locked(self, uuid: str) -> None:
        page = self._cold.pop(uuid, None)
        if page is not None:
            self._cold_free.append(page)

    # -- the dispatcher's surface -------------------------------------------

    def acquire_batch(self, entries):
        """Resolve one step group's (uuid, carry_in) pairs to hot slots,
        demoting the coldest hot sessions outside the group when slots run
        out.  Call it, and launch the step, under ``with arena.lock:``.

        carry_in is what the session held when the step was built: None
        (a fresh session: the slot starts from the inactive carry), a host
        dict (uploaded into the slot) or an :class:`ArenaRef` (the beam is
        in its slot, or on a cold page it is promoted from).  Returns
        parallel lists ``(slots, use_carry, refs)``, or None when the
        group is wider than the slab (the caller takes the host-carry path
        for the whole group)."""
        if len(entries) > self.hot_slots:
            return None
        self._tick += 1
        pinned = {u for u, _c in entries}
        slots: List[int] = []
        use: List[bool] = []
        refs: List[ArenaRef] = []
        for uuid, c in entries:
            if isinstance(c, ArenaRef) and c.arena is self \
                    and c._detached is None:
                slot = self._slot_of.get(uuid)
                if slot is None and uuid in self._cold:
                    # staged on the device first: the slot's allocation
                    # may demote another beam into the freed page
                    page = self._cold.pop(uuid)
                    row = [cl[page].to(self._dev, non_blocking=True, copy=True)
                           for cl in self._cold_slab]
                    self._cold_free.append(page)
                    slot = self._alloc_slot_locked(pinned)
                    rows, i = self._hot_row(slot)
                    for h, r in zip(rows, row):
                        h[i].copy_(r)
                    self._slot_of[uuid] = slot
                    self.promotions += 1
                    C_ARENA_PROMOTIONS.inc()
                if slot is None:
                    # a stale ref (its session freed since the step was
                    # built) decodes fresh, like a carry-less step
                    slot = self._alloc_slot_locked(pinned)
                    self._slot_of[uuid] = slot
                    use.append(False)
                else:
                    use.append(True)
            else:
                host = carry_host(c) if c is not None else None
                slot = self._slot_of.get(uuid)
                if slot is None:
                    self._drop_cold_locked(uuid)
                    slot = self._alloc_slot_locked(pinned)
                    self._slot_of[uuid] = slot
                if host is not None:
                    self._set_row(slot, host)
                    self.promotions += 1
                    C_ARENA_PROMOTIONS.inc()
                use.append(host is not None)
            self._touch(uuid)
            slots.append(slot)
            refs.append(self.ref_for(uuid))
        return slots, use, refs

    # -- host reads / frees --------------------------------------------------

    def read_uuid(self, uuid: str) -> Optional[dict]:
        """One beam as a host dict (a counted readback), hot or cold."""
        with self.lock:
            slot = self._slot_of.get(uuid)
            if slot is not None:
                out = self._dict_of(*self._hot_row(slot))
            elif uuid in self._cold:
                out = self._cold_dict(self._cold[uuid])
            else:
                ref = self._refs.get(uuid)
                return ref._detached if ref is not None else None
            self.readbacks += 1
            C_ARENA_READBACKS.inc()
            return out

    def free_uuid(self, uuid: str, detach: bool = True) -> None:
        """Release a uuid's slot or page.  The beam detaches into the live
        ref first (one readback), so handles captured before the free
        still resolve to the exact bytes.  ``detach=False`` skips that
        (warmup's throwaway slots)."""
        with self.lock:
            ref = self._refs.get(uuid)
            if detach and ref is not None and ref._detached is None:
                detached = self.read_uuid(uuid)
                if detached is not None:
                    ref._detached = detached
            slot = self._slot_of.pop(uuid, None)
            if slot is not None:
                self._free.append(slot)
            self._drop_cold_locked(uuid)
            self._refs.pop(uuid, None)
            self._freq.pop(uuid, None)

    # -- accounting ----------------------------------------------------------

    def tier_counts(self) -> Dict[str, int]:
        with self.lock:
            return {"hot": len(self._slot_of), "cold": len(self._cold)}

    def summary(self) -> dict:
        """The reference's session_arena block."""
        with self.lock:
            return {
                "hot_slots": self.hot_slots,
                "hot_used": len(self._slot_of),
                "cold_slots": self.cold_slots,
                "cold_used": len(self._cold),
                "slot_bytes": self.slot_bytes,
                "hot_bytes": self.hot_slots * self.slot_bytes,
                "cold_bytes": len(self._cold) * self.slot_bytes,
                "cold_memory_kind": self.cold_memory_kind,
                "devices": self.devices,
                "hot_slots_per_chip": self.hot_slots // self.devices,
                "hot_bytes_per_chip":
                    self.hot_slots * self.slot_bytes // self.devices,
                "promotions": self.promotions,
                "evictions": self.evictions,
                "readbacks": self.readbacks,
            }
