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
from .ubodt import ROW_W, UBODT, bucket_entries

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
    mask, the layout and the manager (``tier``), whose current hot pair,
    pages and counters every launch reads."""

    def __init__(self, tier: "TieredTable"):
        self.tier = tier
        self.bmask = int(tier.ubodt.bmask)
        self.layout = tier.ubodt.layout

    @property
    def wide(self) -> bool:
        return self.layout == "wide32"

    @property
    def max_probes(self) -> int:
        """Bucket rows a lookup reads per key: the fetch units it counts."""
        return 1 if self.wide else 2


class TieredTable:
    """The manager of one tiered table: the pinned host pages, the EWMA,
    the device arena and slot map, and the device counters.  ``device``
    is where the hot tier lives (the CPU for the plain versions)."""

    def __init__(self, ubodt: UBODT, hot_bytes: int,
                 shard: Optional[Tuple[int, int]] = None,
                 maintain_every: int = 8, device="cuda"):
        self.dev = resolve_device(device)
        self.ubodt = ubodt
        self.hot_bytes = int(hot_bytes)
        self.shard = shard
        self.maintain_every = max(1, int(maintain_every))
        self.lanes = bucket_entries(ubodt.layout) * ROW_W
        self.n_buckets = ubodt.n_buckets
        # the pages: the table's own buffer, [n_buckets, lanes]
        self.pages = np.ascontiguousarray(
            ubodt.packed.reshape(self.n_buckets, self.lanes), np.int32)
        self.pages_t = torch.from_numpy(self.pages)
        row_bytes = self.lanes * 4
        # a budget below one row is legal: everything cold
        self.capacity = min(self.n_buckets, self.hot_bytes // row_bytes)
        self._lock = threading.RLock()
        # held by each launch while it captures the hot pair and counters
        # (never while taking _lock: maintain takes _lock, then this one)
        self.launch_lock = threading.Lock()
        self._ewma = np.zeros(self.n_buckets, np.float64)
        self._dispatches_since_maintain = 0
        self._misses_since_maintain = 0
        self._units = 0  # fetch units launched since the last drain
        self.evictions = 0
        self.maintenance_passes = 0
        self._hot_set = np.zeros(0, np.int64)
        if self.capacity > 0 and shard is not None:
            lo, hi = shard_bucket_range(shard[0], shard[1], self.n_buckets)
            self._hot_set = np.arange(lo, min(hi, lo + self.capacity),
                                      dtype=np.int64)
        # the cold tier: on the card, the pages page-locked and mapped in
        # place; on the CPU the tensor itself
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
        # this window's fetches per bucket, and (hits, misses) since boot
        self.counts = torch.zeros(self.n_buckets, dtype=torch.int32,
                                  device=self.dev)
        self.totals = torch.zeros(2, dtype=torch.int64, device=self.dev)
        self._seen = (0, 0)
        # the hot pair: an arena of capacity rows (at least one, so a
        # clamped index stays in bounds) and the slot map, with the slot
        # map's host mirror and the arena's unused slots
        self._hot = (torch.zeros((max(1, self.capacity), self.lanes),
                                 dtype=torch.int32, device=self.dev),
                     torch.full((self.n_buckets,), -1, dtype=torch.int32,
                                device=self.dev))
        self._slot_host = np.full(self.n_buckets, -1, np.int32)
        self._free = np.arange(max(0, self.capacity), dtype=np.int32)
        seed, self._hot_set = self._hot_set, np.zeros(0, np.int64)
        self._swap(seed)
        self._publish_gauges()
        log.info("ubodt tiering: %d/%d bucket rows hot (%d B budget, %d B "
                 "row, table %d B, %d B pinned)%s", len(self._hot_set),
                 self.n_buckets, self.hot_bytes, row_bytes, self.table_bytes,
                 self.pinned_bytes,
                 " shard %d/%d seeded" % shard if shard else "")

    @property
    def table_bytes(self) -> int:
        return self.n_buckets * self.lanes * 4

    def device(self) -> TieredDeviceUBODT:
        """The probes' view of this table (the matcher's ``_du``)."""
        return TieredDeviceUBODT(self)

    def close(self) -> None:
        """Unregister the pages (the table stays usable on the CPU only)."""
        if self._pages_dev_ptr:
            from ..ops._kernels import host_unregister

            torch.cuda.synchronize(self.dev)
            host_unregister(self.pages_t.data_ptr())
            self._pages_dev_ptr = 0

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def _publish_gauges(self) -> None:
        G_TIER_ROWS.set(len(self._hot_set))
        G_TIER_FRAC.set(len(self._hot_set) / max(1, self.n_buckets))

    def _swap(self, new_set: np.ndarray) -> None:
        """Make ``new_set`` the hot set: the evicted buckets' slots freed,
        each admitted bucket's page copied into a free slot, the slot map
        updated, all queued on the current stream under ``launch_lock``
        (call under ``_lock``)."""
        old = self._hot_set
        gone = old[~np.isin(old, new_set, assume_unique=True)]
        came = new_set[~np.isin(new_set, old, assume_unique=True)]
        self._free = np.concatenate([self._slot_host[gone], self._free])
        slots, self._free = self._free[: len(came)], self._free[len(came):]
        self._slot_host[gone] = -1
        self._slot_host[came] = slots
        # host tensors page-locked for an asynchronous copy on the card
        pin = (lambda x: x.pin_memory()) if self.dev.type == "cuda" else (
            lambda x: x)
        rows = pin(torch.from_numpy(self.pages[came]))
        idx = pin(torch.from_numpy(np.concatenate([gone, came,
                                                     slots.astype(np.int64)])))
        with self.launch_lock:
            arena, slot_map = self._hot
            idx = idx.to(self.dev, non_blocking=True)
            g, c, sl = idx.split([len(gone), len(came), len(came)])
            slot_map.index_fill_(0, g, -1)
            arena.index_copy_(0, sl, rows.to(self.dev, non_blocking=True))
            slot_map.index_copy_(0, c, sl.to(torch.int32))
            self._hot_set = new_set

    # -- what a launch reads ------------------------------------------------

    def source(self):
        """(arena, slot_map, pages device address, counts, totals): call
        under ``launch_lock`` and launch before releasing it."""
        arena, slot_map = self._hot
        return arena, slot_map, self._pages_dev_ptr, self.counts, self.totals

    def note_units(self, n: int) -> None:
        """Record ``n`` fetch units launched (the maintenance cadence)."""
        with self.launch_lock:
            self._units += int(n)

    def rows_plain(self, b: torch.Tensor) -> torch.Tensor:
        """Plain version of the tiered row fetch: [N, lanes] rows of the
        int64 buckets ``b`` (on the tier's device), the arena's where the
        slot map names one, else the page's, each fetch counted and
        totalled."""
        with self.launch_lock:
            arena, slot_map = self._hot
            slot = slot_map[b]
            hot = slot >= 0
            with stage("tier-arena"):
                rows = arena[slot.clamp(min=0).long()]
            cold = ~hot
            if bool(cold.any()):  # the pages live on the host
                with stage("tier-page"):
                    rows[cold] = self.pages_t[b[cold].cpu()].to(b.device)
            self.counts.index_add_(0, b, torch.ones_like(b, dtype=torch.int32))
            n_hot = hot.sum()
            self.totals += torch.stack([n_hot, hot.numel() - n_hot])
        return rows

    # -- the counters (device -> host at collect) ---------------------------

    def drain_stats(self) -> None:
        """Read the fetch totals the launches left on the device and run a
        maintenance pass when one is due (misses since the last pass and
        at least ``maintain_every`` fetch units): the reference's
        ``drain_stats`` at the granularity of a collect."""
        with self.launch_lock:
            units, self._units = self._units, 0
        tot = self.totals.cpu().tolist()
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
        """This window's per-bucket fetch counts (int64), without taking
        them."""
        return self.counts.cpu().numpy().astype(np.int64)

    # -- maintenance --------------------------------------------------------

    def maintain(self) -> dict:
        """One admission/eviction pass: fold the window's counts into the
        EWMA, take the top-``capacity`` buckets, move the admitted rows
        into the evicted ones' slots.  Returns {hot_rows, admitted,
        evicted}."""
        with self._lock:
            with self.launch_lock:
                # taken in stream order: every earlier launch's fetches,
                # none of a later one's
                snap = self.counts.clone()
                self.counts.zero_()
            self._ewma *= EWMA_DECAY
            self._ewma += snap.cpu().numpy()
            self._dispatches_since_maintain = 0
            self._misses_since_maintain = 0
            self.maintenance_passes += 1
            if self.capacity <= 0:
                return {"hot_rows": 0, "admitted": 0, "evicted": 0}
            new_set = self._select_range(0, self.n_buckets, self._hot_set)
            evicted = int(np.count_nonzero(~np.isin(self._hot_set, new_set)))
            admitted = int(np.count_nonzero(~np.isin(new_set, self._hot_set)))
            if admitted or evicted:
                self._swap(new_set)
            self.evictions += evicted
            C_TIER_EVICTIONS.inc(evicted)
            self._publish_gauges()
            return {"hot_rows": int(len(self._hot_set)),
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
        """Fetches answered from the hot arena, read at collect."""
        return self._seen[0]

    @property
    def misses(self) -> int:
        """Fetches of cold buckets, read at collect."""
        return self._seen[1]

    @property
    def resident_rows(self) -> int:
        return int(len(self._hot_set))

    def hot_buckets(self) -> np.ndarray:
        with self._lock:
            return self._hot_set.copy()

    def summary(self) -> dict:
        """The reference's tier block, for one device."""
        with self._lock:
            hot_rows = int(len(self._hot_set))
        return {
            "hot_bytes": self.hot_bytes,
            "hot_bytes_total": self.hot_bytes,
            "table_bytes": self.table_bytes,
            "n_buckets": self.n_buckets,
            "hot_rows": hot_rows,
            "capacity_rows": self.capacity,
            "capacity_rows_total": self.capacity,
            "devices": 1,
            "residency_frac": round(hot_rows / max(1, self.n_buckets), 4),
            "layout": self.ubodt.layout,
            "cold_memory_kind": self.cold_memory_kind,
            "shard": ("%d/%d" % self.shard) if self.shard else None,
        }
