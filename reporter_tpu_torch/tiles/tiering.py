"""Tiered UBODT: a table larger than the card's memory, served from a hot
arena on the card and cold rows read in place from pinned host memory.

The port of ``reporter_tpu/tiles/tiering.py``:

  hot tier    an arena of packed bucket rows (the 128- or 256-lane rows
              the probe reads) on the card, ``capacity = min(n_buckets,
              hot_bytes // row_bytes)`` rows, and a ``slot_map``
              [n_buckets] int32 mapping each bucket to its arena row (-1 =
              cold), both in device memory;
  cold tier   the full packed table in host memory, page-locked
              (``cudaHostRegister`` of the table's own buffer) and mapped
              into the card's address space: a probe of a cold bucket
              reads its row in place over the host link.  The table is
              never copied to the card.

Every probe of the port fetches its bucket rows through one device
function, ``bucket_row`` (``csrc/ubodt.cuh``): the arena's row when the
slot map names one, else the host page.  Each probe decides alone (the
reference's ``lax.cond`` falls back to the pages for every probe of a
dispatch when one is cold; the bytes are the same either way).  Every
arena row is a copy of its page, so the answers are bit for bit the
untiered table's at every occupancy.

Admission and eviction follow the reference exactly: each fetch adds one
to a per-bucket count on the device (``counts``, this maintenance
window's) and to the hit or miss total (``totals``, cumulative).  The
matcher reads them at collect (``drain_stats``), as it reads the probe
diagnostic.  A maintenance pass folds the window's counts into an EWMA
(decay 0.8) and takes the top-``capacity`` buckets as the hot set, with
the reference's tie rules (``_select_range``).  One pass runs when a
drain finds misses and at least ``maintain_every`` (8) fetch units since
the last: a unit is one hash's rows of one lookup (two per cuckoo lookup,
one per wide32), the reference's one ``_bucket_rows`` call.  A shard
assignment (``parse_shard``, ``$REPORTER_UBODT_SHARD=i/N``) seeds the hot
set with that bucket range.

On a device mesh with a gp axis the tier splits as the table does: each
gp rank owns a contiguous bucket range and holds, on its device, an
arena of ``capacity`` rows of its range (``hot_bytes`` is a per-chip
budget), a slot map, counts and totals of its own, indexed by the
bucket's offset in the range; it is seeded with its range's prefix and
maintained over its range alone.  Kernel 2's ``[tiered,sharded]``
instantiations probe a rank; the ranks' answers merge by pmin / pmax
into the untiered table's.  The pages are page-locked once, whole, and
each rank reads its range at an offset into that one mapping.

The arena holds ``capacity`` rows from the start.  A maintenance pass
moves only what changed: each admitted bucket's page goes into a slot an
evicted bucket freed (or one never used), and the slot map follows.  The
admitted rows are gathered from the pages on the host into page-locked
memory, and the row copy and the slot-map writes are queued on the
current stream under ``launch_lock``, which every launch holds while it
captures the pair: a launch queued before the pass reads the old pair to
its end, one queued after reads the new one, and none sees half of it.

On the CPU (the tests) the pages are an ordinary tensor and the probes
run their plain versions, which fetch, count and total the same rows.
Hits, misses, evictions and resident rows are plain attributes.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..obs import metrics as obs
from ..obs.attrib import stage
from .ubodt import ROW_W, UBODT, ShardedUBODT, bucket_entries

log = logging.getLogger(__name__)

# the tiers' flows and residency, fed by every table's counts
C_TIER_HITS = obs.counter(
    "reporter_ubodt_tier_hits_total",
    "UBODT probes answered from the device-resident hot-bucket arena "
    "(docs/performance.md \"Continent-scale data plane\")")
C_TIER_MISSES = obs.counter(
    "reporter_ubodt_tier_misses_total",
    "UBODT probes whose bucket was cold — served bit-identically through "
    "the host-paged full-width fallback")
C_TIER_EVICTIONS = obs.counter(
    "reporter_ubodt_tier_evictions_total",
    "Hot-arena bucket rows evicted by the probe-frequency EWMA "
    "maintenance pass")
G_TIER_ROWS = obs.gauge(
    "reporter_ubodt_tier_resident_rows",
    "Bucket rows currently resident in the device hot arena")
G_TIER_FRAC = obs.gauge(
    "reporter_ubodt_tier_residency_frac",
    "Fraction of the table's buckets resident in the device hot arena "
    "(resident rows / n_buckets)")

EWMA_DECAY = 0.8  # the reference's decay of the probe-frequency EWMA


def parse_shard(spec: str) -> Optional[Tuple[int, int]]:
    """``"i/N"`` -> (i, N), None for an empty spec; raises on anything
    else (a typo'd shard must fail the boot, not serve another range)."""
    spec = (spec or "").strip()
    if not spec:
        return None
    try:
        idx_s, n_s = spec.split("/", 1)
        idx, n = int(idx_s), int(n_s)
    except ValueError:
        raise ValueError("ubodt shard must be 'i/N', got %r" % (spec,))
    if n < 1 or not 0 <= idx < n:
        raise ValueError("ubodt shard index out of range: %r" % (spec,))
    return idx, n


def shard_bucket_range(idx: int, n_shards: int,
                       n_buckets: int) -> Tuple[int, int]:
    """The contiguous bucket range [lo, hi) of shard ``idx`` of
    ``n_shards`` (the reference's partition everywhere the table
    splits)."""
    if not 0 <= idx < n_shards:
        raise ValueError("shard %d/%d out of range" % (idx, n_shards))
    return idx * n_buckets // n_shards, (idx + 1) * n_buckets // n_shards


class TieredDeviceUBODT:
    """What the probes take in place of a ``DeviceUBODT``: the bucket
    mask, the layout, the manager (``tier``) and one of its ranks
    (``rank``), whose hot pair, page range and counters every launch
    reads.  On a gp mesh the view is the rank's bucket range [lo, lo +
    local_buckets) (``sharded``), as ``DeviceUBODT.shard`` gives one."""

    def __init__(self, tier: "TieredTable", rank: "_Rank"):
        self.tier = tier
        self.rank = rank
        self.bmask = int(tier.ubodt.bmask)
        self.layout = tier.ubodt.layout
        self.lo = rank.lo
        self.sharded = tier.n_gp > 1

    @property
    def wide(self) -> bool:
        return self.layout == "wide32"

    @property
    def device(self) -> torch.device:
        return self.rank.dev

    @property
    def local_buckets(self) -> int:
        return self.rank.n

    @property
    def max_probes(self) -> int:
        """Bucket rows a lookup reads per key: the fetch units it counts."""
        return 1 if self.wide else 2


class _Rank:
    """One gp rank's tier on one device: its bucket range [lo, lo + n) of
    the table, an arena of ``capacity`` rows, the slot map [n] (local arena
    slots, -1 cold) with its host mirror and the unused slots, the
    window's counts [n] and the (hits, misses) totals, all indexed by the
    bucket's offset in the range; the device address of its first page
    (0 on the CPU); the resident buckets (table ids)."""

    def __init__(self, tier: "TieredTable", g: int, dev: torch.device):
        self.g, self.dev = g, dev
        self.n = tier.shard_len
        self.lo = g * self.n
        self.arena = torch.zeros((max(1, tier.capacity), tier.lanes),
                                 dtype=torch.int32, device=dev)
        self.slot_map = torch.full((self.n,), -1, dtype=torch.int32,
                                   device=dev)
        self.counts = torch.zeros(self.n, dtype=torch.int32, device=dev)
        self.totals = torch.zeros(2, dtype=torch.int64, device=dev)
        self.slot_host = np.full(self.n, -1, np.int32)
        self.free = np.arange(max(0, tier.capacity), dtype=np.int32)
        self.hot = np.zeros(0, np.int64)
        self.pages_ptr = (tier._pages_dev_ptr + self.lo * tier.lanes * 4
                          if tier._pages_dev_ptr else 0)


class TieredTable:
    """The manager of one tiered table: the pinned host pages, the EWMA,
    the device arenas and slot maps, and the device counters.  ``device``
    is where the hot tier lives (the CPU for the plain versions); on a
    ``mesh``, its devices.

    On a device mesh (``mesh``, the matcher's ``parallel.mesh.Mesh``) with
    a gp axis of n_gp ranks, the reference's composition
    (``reporter_tpu/tiles/tiering.py:201-286``): the table splits into
    n_gp contiguous bucket ranges of ``shard_len``, ``hot_bytes`` is a
    per-chip budget (each rank holds ``capacity`` rows of its own range,
    its own slot map with local slot ids), each rank is seeded with the
    prefix of its range (intersected with ``shard`` when both are set)
    and ``maintain`` admits and evicts per range.  Every (rank, device)
    pair of the mesh holds one copy of its rank's tier; ranks that share
    a device share it.  The cold pages are page-locked once, whole: each
    rank reads its range at an offset into that one mapping."""

    def __init__(self, ubodt: UBODT, hot_bytes: int,
                 shard: Optional[Tuple[int, int]] = None,
                 maintain_every: int = 8, device="cuda", mesh=None):
        self.ubodt = ubodt
        self.hot_bytes = int(hot_bytes)
        self.shard = shard
        self.maintain_every = max(1, int(maintain_every))
        self.lanes = bucket_entries(ubodt.layout) * ROW_W
        self.n_buckets = ubodt.n_buckets
        self.mesh = mesh
        self.n_gp = 1 if mesh is None else mesh.n_gp
        if self.n_buckets % self.n_gp:
            raise ValueError(
                "UBODT bucket count %d not divisible by gp=%d (use a "
                "power-of-two gp axis)" % (self.n_buckets, self.n_gp))
        self.shard_len = self.n_buckets // self.n_gp
        # each rank's devices: the mesh's column of that rank, or ``device``
        if mesh is None:
            rank_devs = [[resolve_device(device)]]
        else:
            rank_devs = [list(dict.fromkeys(row[g] for row in mesh.devices))
                         for g in range(self.n_gp)]
        self.dev = rank_devs[0][0]
        if len({d.type for devs in rank_devs for d in devs}) != 1:
            raise ValueError("a tiered table's ranks are all on cards or all "
                             "on the CPU")
        # the pages: the table's own buffer, [n_buckets, lanes]
        self.pages = np.ascontiguousarray(
            ubodt.packed.reshape(self.n_buckets, self.lanes), np.int32)
        self.pages_t = torch.from_numpy(self.pages)
        row_bytes = self.lanes * 4
        # rows a rank holds; a budget below one row is legal: all cold
        self.capacity = min(self.shard_len, self.hot_bytes // row_bytes)
        self._lock = threading.RLock()
        # held by each launch while it captures a rank's hot pair and
        # counters (never while taking _lock: maintain takes _lock, then
        # this one)
        self.launch_lock = threading.Lock()
        self._ewma = np.zeros(self.n_buckets, np.float64)
        self._dispatches_since_maintain = 0
        self._misses_since_maintain = 0
        self._units = 0  # fetch units launched since the last drain
        self.evictions = 0
        self.maintenance_passes = 0
        # the seed: the prefix of each rank's range, within the shard
        seed = [np.zeros(0, np.int64)] * self.n_gp
        if self.capacity > 0 and (shard is not None or self.n_gp > 1):
            s_lo, s_hi = ((0, self.n_buckets) if shard is None else
                          shard_bucket_range(shard[0], shard[1],
                                             self.n_buckets))
            for g in range(self.n_gp):
                lo = max(s_lo, g * self.shard_len)
                hi = min(s_hi, (g + 1) * self.shard_len)
                if lo < hi:
                    seed[g] = np.arange(lo, min(hi, lo + self.capacity),
                                        dtype=np.int64)
        # the cold tier: on the card, the pages page-locked and mapped in
        # place, once for every rank; on the CPU the tensor itself
        self._pages_dev_ptr = 0
        if self.dev.type == "cuda":
            from ..ops._kernels import host_register

            if self.pages_t.data_ptr() % 16:
                raise ValueError("UBODT pages must be 16-byte aligned")
            self._pages_dev_ptr = host_register(self.pages_t.data_ptr(),
                                                self.pages.nbytes)
            self.cold_memory_kind = "pinned_host"
        else:
            self.cold_memory_kind = "host"
        self.pinned_bytes = self.pages.nbytes if self._pages_dev_ptr else 0
        self._ranks = {(g, d): _Rank(self, g, d)
                       for g, devs in enumerate(rank_devs) for d in devs}
        self._hot_g = [np.zeros(0, np.int64)] * self.n_gp  # each rank's
        self._seen = (0, 0)
        with self._lock:
            for g in range(self.n_gp):
                self._swap(g, seed[g])
        self._publish_gauges()
        log.info("ubodt tiering: %d/%d bucket rows hot (%d B budget a rank, "
                 "%d rank(s), %d B row, table %d B, %d B pinned)%s",
                 self.resident_rows, self.n_buckets, self.hot_bytes,
                 self.n_gp, row_bytes, self.table_bytes, self.pinned_bytes,
                 " shard %d/%d seeded" % shard if shard else "")

    @property
    def table_bytes(self) -> int:
        return self.n_buckets * self.lanes * 4

    def rank(self, g: int = 0, dev=None) -> _Rank:
        """Rank ``g``'s tier on ``dev`` (default: the table's device)."""
        return self._ranks[g, self.dev if dev is None else resolve_device(dev)]

    def view(self, g: int = 0, dev=None) -> TieredDeviceUBODT:
        """The probes' view of rank ``g`` on ``dev``."""
        return TieredDeviceUBODT(self, self.rank(g, dev))

    def device(self, dev=None):
        """The probes' view of the whole table on ``dev`` (the matcher's
        ``_du``): one view, or on a gp mesh a ``ShardedUBODT`` of the
        ranks' views."""
        if self.n_gp == 1:
            return self.view(0, dev)
        return ShardedUBODT(self.view(g, dev) for g in range(self.n_gp))

    @property
    def counts(self) -> torch.Tensor:
        """Rank 0's window counts on the table's device (the whole table's
        on one rank)."""
        return self.rank().counts

    @counts.setter
    def counts(self, value: torch.Tensor) -> None:
        # ``tier.counts += x`` adds in place, then assigns the same tensor
        if value is not self.rank().counts:
            self.rank().counts.copy_(value)

    @property
    def totals(self) -> torch.Tensor:
        """Rank 0's (hits, misses) totals on the table's device."""
        return self.rank().totals

    def close(self) -> None:
        """Unregister the pages (the table stays usable on the CPU only)."""
        if self._pages_dev_ptr:
            from ..ops._kernels import host_unregister

            for d in {d for _g, d in self._ranks}:
                torch.cuda.synchronize(d)
            host_unregister(self.pages_t.data_ptr())
            self._pages_dev_ptr = 0

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def _publish_gauges(self) -> None:
        G_TIER_ROWS.set(self.resident_rows)
        G_TIER_FRAC.set(self.resident_rows / max(1, self.n_buckets))

    def _swap(self, g: int, new_set: np.ndarray) -> None:
        """Make ``new_set`` (table ids in rank ``g``'s range) the rank's hot
        set on each of its devices: the evicted buckets' slots freed, each
        admitted bucket's page copied into a free slot, the slot map
        updated, all queued on the device's current stream under
        ``launch_lock`` (call under ``_lock``)."""
        for (rg, _d), r in self._ranks.items():
            if rg == g:
                self._swap_rank(r, new_set)
        self._hot_g[g] = new_set

    def _swap_rank(self, r: _Rank, new_set: np.ndarray) -> None:
        old = r.hot
        gone = old[~np.isin(old, new_set, assume_unique=True)]
        came = new_set[~np.isin(new_set, old, assume_unique=True)]
        r.free = np.concatenate([r.slot_host[gone - r.lo], r.free])
        slots, r.free = r.free[: len(came)], r.free[len(came):]
        r.slot_host[gone - r.lo] = -1
        r.slot_host[came - r.lo] = slots
        # host tensors page-locked for an asynchronous copy on the card
        pin = (lambda x: x.pin_memory()) if r.dev.type == "cuda" else (
            lambda x: x)
        rows = pin(torch.from_numpy(self.pages[came]))
        idx = pin(torch.from_numpy(np.concatenate(
            [gone - r.lo, came - r.lo, slots.astype(np.int64)])))
        with self.launch_lock:
            idx = idx.to(r.dev, non_blocking=True)
            g, c, sl = idx.split([len(gone), len(came), len(came)])
            r.slot_map.index_fill_(0, g, -1)
            r.arena.index_copy_(0, sl, rows.to(r.dev, non_blocking=True))
            r.slot_map.index_copy_(0, c, sl.to(torch.int32))
            r.hot = new_set

    # -- what a launch reads ------------------------------------------------

    def source(self, rank: Optional[_Rank] = None):
        """(arena, slot_map, first page's device address, counts, totals)
        of ``rank`` (default: rank 0 on the table's device): call under
        ``launch_lock`` and launch before releasing it."""
        r = self.rank() if rank is None else rank
        return r.arena, r.slot_map, r.pages_ptr, r.counts, r.totals

    def note_units(self, n: int) -> None:
        """Record ``n`` fetch units launched (the maintenance cadence)."""
        with self.launch_lock:
            self._units += int(n)

    def rows_plain(self, b: torch.Tensor,
                   rank: Optional[_Rank] = None) -> torch.Tensor:
        """Plain version of the tiered row fetch: [N, lanes] rows of the
        int64 buckets ``b`` of ``rank``'s range (offsets in it, on its
        device; default rank 0, the whole table on one rank), the arena's
        where the slot map names one, else the page's, each fetch counted
        and totalled."""
        r = self.rank() if rank is None else rank
        with self.launch_lock:
            slot = r.slot_map[b]
            hot = slot >= 0
            with stage("tier-arena"):
                rows = r.arena[slot.clamp(min=0).long()]
            cold = ~hot
            if bool(cold.any()):  # the pages live on the host
                with stage("tier-page"):
                    rows[cold] = self.pages_t[(b[cold] + r.lo).cpu()].to(
                        b.device)
            r.counts.index_add_(0, b, torch.ones_like(b, dtype=torch.int32))
            n_hot = hot.sum()
            r.totals += torch.stack([n_hot, hot.numel() - n_hot])
        return rows

    # -- the counters (device -> host at collect) ---------------------------

    def _total(self):
        return [sum(x) for x in zip(*(r.totals.cpu().tolist()
                                      for r in self._ranks.values()))]

    def drain_stats(self) -> None:
        """Read the fetch totals the launches left on the devices and run a
        maintenance pass when one is due (misses since the last pass and
        at least ``maintain_every`` fetch units): the reference's
        ``drain_stats`` at the granularity of a collect."""
        with self.launch_lock:
            units, self._units = self._units, 0
        tot = self._total()
        with self._lock:
            n_hit, n_miss = tot[0] - self._seen[0], tot[1] - self._seen[1]
            self._seen = (tot[0], tot[1])
            C_TIER_HITS.inc(n_hit)
            C_TIER_MISSES.inc(n_miss)
            self._dispatches_since_maintain += units
            self._misses_since_maintain += n_miss
            due = (self._misses_since_maintain > 0
                   and self._dispatches_since_maintain >= self.maintain_every)
        if due:
            self.maintain()

    def window_counts(self) -> np.ndarray:
        """This window's per-bucket fetch counts (int64) over every rank,
        without taking them."""
        out = np.zeros(self.n_buckets, np.int64)
        for r in self._ranks.values():
            out[r.lo:r.lo + r.n] += r.counts.cpu().numpy()
        return out

    # -- maintenance --------------------------------------------------------

    def maintain(self) -> dict:
        """One admission/eviction pass: fold the window's counts into the
        EWMA, take each rank's top-``capacity`` buckets of its range, move
        the admitted rows into the evicted ones' slots.  Returns
        {hot_rows, admitted, evicted}."""
        with self._lock:
            snap = np.zeros(self.n_buckets, np.int64)
            with self.launch_lock:
                # taken in stream order: every earlier launch's fetches,
                # none of a later one's
                taken = [(r, r.counts.clone()) for r in self._ranks.values()]
                for r, _c in taken:
                    r.counts.zero_()
            for r, c in taken:
                snap[r.lo:r.lo + r.n] += c.cpu().numpy()
            self._ewma *= EWMA_DECAY
            self._ewma += snap
            self._dispatches_since_maintain = 0
            self._misses_since_maintain = 0
            self.maintenance_passes += 1
            if self.capacity <= 0:
                return {"hot_rows": 0, "admitted": 0, "evicted": 0}
            admitted = evicted = 0
            for g in range(self.n_gp):
                old = self._hot_g[g]
                lo = g * self.shard_len
                new_set = self._select_range(lo, lo + self.shard_len, old)
                ev = int(np.count_nonzero(~np.isin(old, new_set)))
                ad = int(np.count_nonzero(~np.isin(new_set, old)))
                if ad or ev:
                    self._swap(g, new_set)
                admitted += ad
                evicted += ev
            self.evictions += evicted
            C_TIER_EVICTIONS.inc(evicted)
            self._publish_gauges()
            return {"hot_rows": self.resident_rows,
                    "admitted": admitted, "evicted": evicted}

    def _select_range(self, lo: int, hi: int,
                      incumbent: np.ndarray) -> np.ndarray:
        """Top-``capacity`` buckets of [lo, hi) by EWMA (the reference's
        rules: argpartition's pick, sorted; zero-score winners yield to
        incumbents, so an unprobed bucket never evicts a seeded one)."""
        n = hi - lo
        if self.capacity >= n:
            return np.arange(lo, hi, dtype=np.int64)
        top = np.argpartition(-self._ewma[lo:hi], self.capacity - 1)[
            : self.capacity]
        new_set = np.sort(top).astype(np.int64) + lo
        zero = self._ewma[new_set] <= 0.0
        n_zero = int(np.count_nonzero(zero))
        if n_zero and len(incumbent):
            keep_old = incumbent[~np.isin(incumbent, new_set)]
            fill = keep_old[:n_zero]
            new_set = np.sort(np.concatenate(
                [new_set[~zero],
                 new_set[zero][: n_zero - len(fill)],
                 fill])).astype(np.int64)
        return new_set

    # -- introspection ------------------------------------------------------

    @property
    def hits(self) -> int:
        """Fetches answered from the hot arenas, read at collect."""
        return self._seen[0]

    @property
    def misses(self) -> int:
        """Fetches of cold buckets, read at collect."""
        return self._seen[1]

    @property
    def resident_rows(self) -> int:
        """Hot rows over the ranks."""
        return int(sum(len(h) for h in self._hot_g))

    def hot_buckets(self) -> np.ndarray:
        """Every rank's hot buckets (table ids), in bucket order."""
        with self._lock:
            return np.concatenate(self._hot_g).astype(np.int64)

    def summary(self) -> dict:
        """The reference's tier block: ``hot_bytes`` and ``capacity_rows``
        a rank, their totals over the gp ranks."""
        with self._lock:
            hot_rows = self.resident_rows
        return {
            "hot_bytes": self.hot_bytes,
            "hot_bytes_total": self.hot_bytes * self.n_gp,
            "table_bytes": self.table_bytes,
            "n_buckets": self.n_buckets,
            "hot_rows": hot_rows,
            "capacity_rows": self.capacity,
            "capacity_rows_total": self.capacity * self.n_gp,
            "devices": self.n_gp,
            "residency_frac": round(hot_rows / max(1, self.n_buckets), 4),
            "layout": self.ubodt.layout,
            "cold_memory_kind": self.cold_memory_kind,
            "shard": ("%d/%d" % self.shard) if self.shard else None,
        }
