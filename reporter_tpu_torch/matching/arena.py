"""Device-resident session arena: carried Viterbi beams as slot-mapped
device state.

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

Only the hot slab is here (the reference's byte budget, pinned-host cold
pages, spill, demotion and the probe-frequency EWMA are not ported): the
slab holds ``max_sessions`` slots, the store's own bound.  A step group
that needs more free slots than remain (a session evicted while its step
was in flight is put back on commit, one past the bound) takes the
host-carry path instead, bit for bit the same.

Concurrency: one re-entrant ``lock`` serialises every slab access; the
dispatcher holds it across acquire -> step launch.  The step updates the
slab on the device stream, in order with every later read.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..convert import carry_from_numpy
from ..ops.viterbi import TraceCarry, initial_carry_batch

log = logging.getLogger(__name__)


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
    [hot_slots] on ``device``.  ``acquire_batch`` and the step launch that
    uses its slots must run inside one ``with arena.lock:`` section."""

    def __init__(self, beam_k: int, max_sessions: int = 65536, device="cuda"):
        self.beam_k = int(beam_k)
        # per-slot payload: scores/edge/offset [K] at 4 B, x/y/t/committed
        # at 4 B, active at 1 B
        self.slot_bytes = 12 * self.beam_k + 17
        self.hot_slots = max(1, int(max_sessions))
        self.lock = threading.RLock()
        self._hot = initial_carry_batch(self.hot_slots, self.beam_k, device)
        # uuid -> slot; slots free-listed so churn reuses rows
        self._slot_of: Dict[str, int] = {}
        self._free: List[int] = list(range(self.hot_slots - 1, -1, -1))
        self._refs: Dict[str, ArenaRef] = {}
        self.promotions = 0
        self.readbacks = 0
        log.info("session arena: %d slots of %d B on %s", self.hot_slots,
                 self.slot_bytes, device)

    @property
    def hot(self) -> TraceCarry:
        """The slab (use under ``lock``; the step updates it in place)."""
        return self._hot

    def ref_for(self, uuid: str) -> ArenaRef:
        with self.lock:
            r = self._refs.get(uuid)
            if r is None or r._detached is not None:
                r = self._refs[uuid] = ArenaRef(self, uuid)
            return r

    def _set_row(self, slot: int, c: dict) -> None:
        for leaf, v in zip(self._hot, carry_from_numpy(c)):
            leaf[slot].copy_(v)

    def _row_dict(self, slot: int) -> dict:
        row = {n: t[slot].cpu().numpy() for n, t in zip(TraceCarry._fields,
                                                         self._hot)}
        row["x"], row["y"], row["t"] = row["x"][()], row["y"][()], row["t"][()]
        row["active"] = bool(row["active"])
        row["committed"] = row["committed"][()]
        return row

    def acquire_batch(self, entries):
        """Resolve one step group's (uuid, carry_in) pairs to slots.  Call
        it, and launch the step, under ``with arena.lock:``.

        carry_in is what the session held when the step was built: None
        (a fresh session: the slot starts from the inactive carry), a host
        dict (uploaded into the slot) or an :class:`ArenaRef` (the beam is
        already in its slot).  Returns parallel lists ``(slots, use_carry,
        refs)``, or None when the group needs more free slots than remain
        (the caller takes the host-carry path for the whole group)."""
        need = sum(1 for u, _c in entries if u not in self._slot_of)
        if need > len(self._free):
            return None
        slots: List[int] = []
        use: List[bool] = []
        refs: List[ArenaRef] = []
        for uuid, c in entries:
            slot = self._slot_of.get(uuid)
            if isinstance(c, ArenaRef) and c.arena is self \
                    and c._detached is None:
                # a stale ref (its slot freed since the step was built)
                # decodes fresh, like a carry-less step
                use.append(slot is not None)
            else:
                host = carry_host(c)
                if host is not None:
                    slot = slot if slot is not None else self._free.pop()
                    self._set_row(slot, host)
                    self.promotions += 1
                use.append(host is not None)
            if slot is None:
                slot = self._free.pop()
            self._slot_of[uuid] = slot
            slots.append(slot)
            refs.append(self.ref_for(uuid))
        return slots, use, refs

    def read_uuid(self, uuid: str) -> Optional[dict]:
        """One beam as a host dict (a counted readback)."""
        with self.lock:
            slot = self._slot_of.get(uuid)
            if slot is None:
                ref = self._refs.get(uuid)
                return ref._detached if ref is not None else None
            self.readbacks += 1
            return self._row_dict(slot)

    def free_uuid(self, uuid: str) -> None:
        """Release a uuid's slot.  The beam detaches into the live ref first
        (one readback), so handles captured before the free still resolve
        to the exact bytes."""
        with self.lock:
            ref = self._refs.pop(uuid, None)
            if ref is not None and ref._detached is None:
                ref._detached = self.read_uuid(uuid)
            slot = self._slot_of.pop(uuid, None)
            if slot is not None:
                self._free.append(slot)

    def summary(self) -> dict:
        with self.lock:
            return {"hot_slots": self.hot_slots,
                    "hot_used": len(self._slot_of),
                    "slot_bytes": self.slot_bytes,
                    "hot_bytes": self.hot_slots * self.slot_bytes,
                    "promotions": self.promotions,
                    "readbacks": self.readbacks}
