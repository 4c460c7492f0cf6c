"""UBODT probe and select (kernel 2), in-batch probe dedup and the distinct
pair count.

Hash each (src, dst) node pair, read its bucket rows and match the src and
dst lanes of each entry, returning (dist, time, first_edge), with +inf /
-1 on a miss.  ``cuckoo`` tables hash twice and read two 128-lane rows;
``wide32`` tables hash once (``device_pair_hash``) and read one 256-lane
row.  The port of ``reporter_tpu/ops/hashtable.py`` ``_lookup_plain``
(both layouts), ``device_pair_hash``, ``device_pair_hash2``,
``_bucket_rows`` and ``_select``.

``dedup=True`` probes each DISTINCT pair of a dispatch once and copies its
result to every position that asked for it: the reference's
``_lookup_dedup`` (sort, segment heads, compaction into a budget of
``m = max(_DEDUP_MIN_PAIRS // 2, n // _DEDUP_CAP_RATIO)`` pairs, one probe
per distinct pair, scatter-back, and the full-width probe when the
distinct count exceeds ``m``).  Below ``_DEDUP_MIN_PAIRS`` pairs the plain
probe runs.  The outputs are bit-identical to the plain probe's in every
case: each position's result is a function of its key alone.

On the card the sort is replaced by a hash set (``csrc/ubodt_dedup.cu``):
a claim kernel deduplicates each block's run of keys in shared memory,
inserts the run's distinct keys into an open-addressing set and compacts
the distinct ones, kernel 2 probes the compact buffer, and a scatter
kernel copies each key's result back, or, when the distinct count is past
the budget, probes its keys itself.  The claim kernel in count mode is
``count_distinct_pairs``.  The distinct count stays on the device until
the caller's collect (``DEDUP.harvest``).

A tiered table (``tiles/tiering.TieredDeviceUBODT``) is probed the same
way: kernel 2's ``[tiered]`` instantiations read each row from the hot
arena or a staging buffer on the card and count the fetches.  Before the
probe, ``ubodt_cold_mark`` claims each distinct cold first-hash row of
the dispatch and ``ubodt_cold_gather`` copies the claimed rows from the
pinned host pages into the staging buffer; on a cuckoo table the probe
itself claims and copies the cold second rows of keys their first row
does not hold.  So each distinct cold row crosses the host link once a
dispatch (rows past the staging capacity are read in place).  The
scatter's fallback reads cold rows in place.  The plain versions fetch
through ``TieredTable.rows_plain``, which counts the same, and count the
staging of ``TieredTable.stage_plain``'s rows as the card does.  Each
top-level lookup records its fetch units (one per hash) for the
maintenance cadence.  The answers are the untiered table's.

A table split over a device mesh's gp axis (``tiles/ubodt.ShardedUBODT``,
one dp rank's view) is probed by every gp rank over its bucket range,
kernel 2's ``[sharded]`` instantiations, a bucket outside the range
reading as -2 lanes that match nothing; the ranks' answers merge by pmin
of dist and time and pmax of the first edge over the gp axis
(``ops/collectives.py``), exactly the whole table's answer (the
reference's ``_ubodt_lookup_sharded``).  A gp rank of a tiered table
(``TieredDeviceUBODT`` with ``sharded``) is probed by the
``[tiered,sharded]`` instantiations: its range through its own slot map,
arena, counts and page range.  Dedup is skipped there, as in the
reference.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version for CPU tensors.  Torch has no uint32 arithmetic and its int32
``>>`` is arithmetic, so the plain hashes compute in int64 masked to 32
bits after every multiply and shift (the kernels use true uint32).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from collections import deque
from typing import NamedTuple, Optional

import torch

from . import collectives
from ..tiles.ubodt import (
    F_DIST, F_DST, F_FE, F_SRC, F_TIME, ROW_W, DeviceUBODT, ShardedUBODT,
)
from ..obs.attrib import staged
from ._kernels import KERNELS, check, ptr

_M32 = 0xFFFFFFFF
# probes per chunk of the plain version (bounds its [chunk, 256] row copies)
_PLAIN_CHUNK = 1 << 18
# the dedup budget: the compact buffer holds n // _DEDUP_CAP_RATIO distinct
# pairs (at least _DEDUP_MIN_PAIRS // 2); below _DEDUP_MIN_PAIRS pairs the
# plain probe runs whatever the flag says (the reference's constants)
_DEDUP_CAP_RATIO = 2
_DEDUP_MIN_PAIRS = 1024


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64 overflow:
    the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(src, dst, a, b, s1, c, s2, mask):
    s = src.to(torch.int64) & _M32
    d = dst.to(torch.int64) & _M32
    h = (_mul32(s, a) + _mul32(d, b)) & _M32
    h = h ^ (h >> s1)
    h = _mul32(h, c)
    h = h ^ (h >> s2)
    return h & mask


def device_pair_hash(src: torch.Tensor, dst: torch.Tensor, mask: int) -> torch.Tensor:
    """Bucket choice 1 (and the single wide32 bucket): the uint32 mix of
    tiles.ubodt.pair_hash, as int64."""
    return _mix(src, dst, 0x9E3779B1, 0x85EBCA6B, 15, 0x2C1B3C6D, 12, mask)


def device_pair_hash2(src: torch.Tensor, dst: torch.Tensor, mask: int) -> torch.Tensor:
    """Bucket choice 2 (cuckoo): the uint32 mix of tiles.ubodt.pair_hash2,
    as int64."""
    return _mix(src, dst, 0x85EBCA77, 0xC2B2AE3D, 13, 0x27D4EB2F, 16, mask)


def _select(rows: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    """rows [N, 128 or 256] -> (dist, time, first) of the entry (of 16 or
    32) whose src and dst lanes both match, +inf / -1 when none does
    (keys are unique)."""
    e = rows.reshape(rows.shape[0], -1, ROW_W)
    both = (e[:, :, F_SRC] == src[:, None]) & (e[:, :, F_DST] == dst[:, None])
    vf = e.view(torch.float32)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=rows.device)
    dist = torch.where(both, vf[:, :, F_DIST], inf).amin(1)
    time = torch.where(both, vf[:, :, F_TIME], inf).amin(1)
    first = torch.where(both, e[:, :, F_FE], -1).amax(1)
    return dist, time, first


def _tier(u):
    """The table's tier manager, None for an untiered table."""
    return getattr(u, "tier", None)


def note_lookup(u) -> None:
    """Record one lookup's fetch units (one per hash) on a tiered table."""
    t = _tier(u)
    if t is not None:
        t.note_units(u.max_probes)


def _rows(u, b: torch.Tensor) -> torch.Tensor:
    """Bucket rows [N, 128 or 256] of buckets ``b``: the plain version of
    the kernels' row fetch (``_bucket_rows``), through the tier when the
    table has one; a bucket-range view's rows outside its range are -2
    lanes (a tiered rank fetches and counts only its range's)."""
    t = _tier(u)
    if not getattr(u, "sharded", False):
        return u.packed[b] if t is None else t.rows_plain(b, u.rank)
    loc = b - u.lo
    mine = (loc >= 0) & (loc < u.local_buckets)
    if t is not None:
        rows = torch.full((b.shape[0], t.lanes), -2, dtype=torch.int32,
                          device=b.device)
        rows[mine] = t.rows_plain(loc[mine], u.rank)
        return rows
    rows = u.packed[torch.where(mine, loc, 0)]
    return torch.where(mine[:, None], rows, torch.full_like(rows, -2))


def _empty_result(shape, dev, with_first):
    return (torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev) if with_first
            else None)


def ubodt_lookup_plain(u: DeviceUBODT, src: torch.Tensor, dst: torch.Tensor,
                       with_first: bool = True, dedup: bool = False):
    """Plain PyTorch probe over broadcastable int32 ``src``/``dst``, either
    layout.  Returns (dist f32, time f32, first_edge i32) of the broadcast
    shape; first_edge is None unless ``with_first``.  ``dedup`` runs
    ``ubodt_lookup_dedup_plain`` (same results) from _DEDUP_MIN_PAIRS
    pairs."""
    src, dst = torch.broadcast_tensors(src, dst)
    if isinstance(u, ShardedUBODT):
        return ubodt_lookup_sharded(u, src, dst, with_first, plain=True)
    if dedup and src.numel() >= _DEDUP_MIN_PAIRS:
        return tuple(ubodt_lookup_dedup_plain(u, src, dst, with_first)[:3])
    note_lookup(u)
    return _probe_plain(u, src, dst, with_first)


@staged("ubodt-probe+select")
def _probe_plain(u, src, dst, with_first, live=None):
    """The plain probe of broadcast keys, without recording fetch units.
    On a tiered table the staging of the first ``live`` keys' cold rows
    (all keys by default; 0: none, as the card's scatter fallback reads
    in place) is counted as the card's staged probe counts it."""
    shape = src.shape
    t = _tier(u)
    if t is not None and live != 0:
        ks, kd = (x.reshape(-1)[:live] for x in (src, dst))
        t.note_staged(t.stage_plain(ks, kd, u.rank).numel(), u.rank)
    s = src.reshape(-1)
    d = dst.reshape(-1)
    outs = ([], [], [])
    for lo in range(0, s.shape[0], _PLAIN_CHUNK):
        sc, dc = s[lo:lo + _PLAIN_CHUNK], d[lo:lo + _PLAIN_CHUNK]
        r = _select(_rows(u, device_pair_hash(sc, dc, u.bmask)), sc, dc)
        if not u.wide:
            r2 = _select(_rows(u, device_pair_hash2(sc, dc, u.bmask)), sc, dc)
            r = (torch.minimum(r[0], r2[0]), torch.minimum(r[1], r2[1]),
                 torch.maximum(r[2], r2[2]))
        for o, x in zip(outs, r):
            o.append(x)
    if not outs[0]:
        res = _empty_result(shape, src.device, True)
    else:
        res = tuple(torch.cat(o).reshape(shape) for o in outs)
    return res if with_first else (res[0], res[1], None)


def fast_divmod(d: int):
    """(multiplier, shift) that divide by ``d`` (1 <= d < 2**31) in the
    kernels' 32-bit arithmetic: with l = ceil(log2 d) and mul =
    ceil(2**(32 + l) / d) - 2**32, i // d == (umulhi(i, mul) + i) >> l
    for every 0 <= i < 2**31 (umulhi: the high word of the 64-bit
    product)."""
    if not 1 <= d < 1 << 31:
        return 0, 0  # the kernels decode such a grid in int64
    l = (d - 1).bit_length()
    return ((1 << (32 + l)) + d - 1) // d - (1 << 32), l


def _grid(src: torch.Tensor, dst: torch.Tensor):
    """The kernels' view of broadcast keys: (dims, src strides, dst
    strides) as host int64 tensors, leading dims padded with 1 / 0; dims
    holds 12 values: the 4 dims, then their ``fast_divmod`` multipliers,
    then their shifts (``rtt::Grid4``)."""
    if src.dim() > 4:
        raise ValueError("at most 4 key dims, got %d" % src.dim())
    pad = 4 - src.dim()
    dims = (1,) * pad + tuple(src.shape)
    mul, shr = zip(*(fast_divmod(d) for d in dims))
    return (torch.tensor(dims + mul + shr, dtype=torch.int64),
            torch.tensor((0,) * pad + src.stride(), dtype=torch.int64),
            torch.tensor((0,) * pad + dst.stride(), dtype=torch.int64))


def check_table(u, dev: torch.device) -> None:
    """Validate a table for a launch on ``dev``: an untiered table's rows
    (int32, on ``dev``, 16-byte aligned), or a tier on ``dev``."""
    t = _tier(u)
    if t is not None:
        if u.device != dev:
            raise ValueError("tiered table is on %s, not %s" % (u.device, dev))
        return
    check(u.packed, "packed", torch.int32, dev)
    if u.packed.data_ptr() % 16:
        raise ValueError("packed table must be 16-byte aligned")


def _check_keys(u: DeviceUBODT, src, dst) -> None:
    dev = src.device
    for name, t in (("src", src), ("dst", dst)):
        if t.dtype != torch.int32 or t.device != dev:
            raise ValueError("%s must be int32 on %s" % (name, dev))
    check_table(u, dev)


def probe_kernel_name(u) -> str:
    """The kernel 2 instantiation that probes table ``u`` (a gp mesh's:
    its ranks')."""
    if isinstance(u, ShardedUBODT):
        return probe_kernel_name(u.shards[0])
    tags = [t for t, on in (("wide32", u.wide), ("tiered", _tier(u) is not None),
                            ("sharded", getattr(u, "sharded", False))) if on]
    return "ubodt_probe" + ("[%s]" % ",".join(tags) if tags else "")


@contextlib.contextmanager
def table_args(u):
    """(table address, [slot_map, arena, counts, totals] addresses) for a
    launch over table ``u``; a tiered table's are captured under its
    ``launch_lock``, held until the launch is queued."""
    t = _tier(u)
    if t is None:
        yield ptr(u.packed), [ptr(None)] * 4
        return
    with t.launch_lock:
        arena, slot_map, pages, counts, totals = t.source(u.rank)
        yield (ctypes.c_void_p(pages),
               [ptr(slot_map), ptr(arena), ptr(counts), ptr(totals)])


def _probe(u: DeviceUBODT, src, dst, with_first, n_live=None, out=None):
    """Launch kernel 2 (its wide32 and tiered instantiations as the table
    asks) over broadcast keys, into ``out`` (dist, time, first) when
    given.  ``n_live`` (device int32 [1]): probe only the first n_live
    keys, none when n_live exceeds the key count (the dedup scatter then
    probes them itself).  A tiered table's probe is staged
    (``_staged_probe``)."""
    dims, s_str, d_str = _grid(src, dst)
    dist, time, first = out or _empty_result(tuple(src.shape), src.device,
                                             with_first)
    if dist.numel():
        keys = (ptr(src), ptr(dst), ptr(dims), ptr(s_str), ptr(d_str))
        outs = (ptr(dist), ptr(time), ptr(first))
        extra = ((u.lo, u.local_buckets) if getattr(u, "sharded", False)
                 else ())
        with table_args(u) as (table, tier):
            if _tier(u) is None:
                KERNELS[probe_kernel_name(u)].launch(
                    src.device, *keys, table, u.bmask, ptr(n_live), *outs,
                    *extra)
            else:
                _staged_probe(u, src.device, keys, outs, table, tier, n_live,
                              extra)
    return dist, time, first


def _staged_probe(u, dev, keys, outs, table, tier, n_live, extra):
    """Kernel 2's tiered probe, queued under the tier's ``launch_lock``
    (``table_args`` holds it): ``ubodt_cold_mark`` claims the keys' cold
    first rows in the rank's stage map, ``ubodt_cold_gather`` copies them
    to the staging buffer, and the probe reads arena and staged rows,
    claiming and copying the cold second rows it needs (cuckoo).  A
    refused launch raises: nothing falls back to reading in place."""
    st, gen, cap = _cold_mark(u, dev, keys, tier[0], n_live)
    _cold_gather(u, dev, table)
    KERNELS[probe_kernel_name(u)].launch(
        dev, *keys, table, u.bmask, ptr(n_live), *outs, *tier, *extra,
        ptr(st.map), ptr(st.rows), ptr(st.list), ptr(st.state),
        ptr(u.rank.stage_stats), gen, cap)


def _cold_mark(u, dev, keys, slot_map, n_live):
    """Launch ``ubodt_cold_mark`` for a new dispatch of tiered view ``u``
    over kernel 2's key arguments (``keys``: the grid's five addresses)
    and ``n_live``; returns the rank's (stage, gen, cap).  Call under the
    tier's ``launch_lock``."""
    t, r = u.tier, u.rank
    st, gen, cap = t.stage_args(r)
    lo, n_range = ((u.lo, u.local_buckets) if getattr(u, "sharded", False)
                   else (0, t.n_buckets))
    KERNELS["ubodt_cold_mark"].launch(
        dev, *keys, u.bmask, ptr(n_live), slot_map, ptr(st.map), ptr(st.list),
        ptr(st.state), ptr(r.stage_stats), gen, cap, lo, n_range)
    return st, gen, cap


def _cold_gather(u, dev, pages):
    """Launch ``ubodt_cold_gather`` of the newest dispatch of tiered view
    ``u``, from ``pages`` (its first page's address).  Call under the
    tier's ``launch_lock``, after ``_cold_mark``."""
    r = u.rank
    KERNELS["ubodt_cold_gather"].launch(
        dev, pages, int(u.wide), ptr(r.stage.rows), ptr(r.stage.list),
        ptr(r.stage.state), ptr(r.stage_stats), r.gen, r.stage_cap)


class DedupProbe(NamedTuple):
    dist: torch.Tensor
    time: torch.Tensor
    first: Optional[torch.Tensor]
    # int32 [1] distinct pairs (None: the plain probe ran); past the budget
    # m the full-width probe ran
    n_unique: Optional[torch.Tensor]
    m: int


def _budget(n: int) -> int:
    return max(_DEDUP_MIN_PAIRS // 2, n // _DEDUP_CAP_RATIO)


def _pair_keys(s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(src, dst) int32 -> one int64 key, src in the high word."""
    return (s.to(torch.int64) << 32) | (d.to(torch.int64) & _M32)


@staged("dedup-sort+dedup-compact")
def ubodt_lookup_dedup_plain(u: DeviceUBODT, src: torch.Tensor,
                             dst: torch.Tensor, with_first: bool = True):
    """Plain version of the deduplicated probe: the distinct pairs by
    ``torch.unique``, one plain probe each, results gathered back; the
    plain probe of every pair when there are more than the budget ``m``
    (or when ``m >= n``, n_unique None).  Returns a ``DedupProbe``."""
    src, dst = torch.broadcast_tensors(src, dst)
    shape, n = src.shape, src.numel()
    m = _budget(n)
    note_lookup(u)
    if m >= n:
        return DedupProbe(*_probe_plain(u, src, dst, with_first), None, m)
    uniq, inv = torch.unique(_pair_keys(src.reshape(-1), dst.reshape(-1)),
                             return_inverse=True)
    U = uniq.numel()
    n_unique = torch.tensor([U], dtype=torch.int32, device=src.device)
    if U > m:  # on the card the scatter probes every key, in place
        return DedupProbe(*_probe_plain(u, src, dst, with_first, live=0),
                          n_unique, m)
    hi = (uniq >> 32).to(torch.int32)
    lo = (((uniq & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)
    if _tier(u) is not None:
        # the reference probes its whole compact buffer: the distinct keys
        # and m - U keys (0, 0), all fetched and counted (on the card the
        # scatter counts the tail, which no probe reads or stages)
        hi, lo = (torch.cat([x, x.new_zeros(m - U)]) for x in (hi, lo))
    r = _probe_plain(u, hi, lo, with_first, live=U)
    out = [None if x is None else x[:U][inv].reshape(shape) for x in r]
    return DedupProbe(*out, n_unique, m)


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _claim(src, dst, valid, m: int, count: torch.Tensor):
    """Launch the claim kernel over broadcast keys: every key (where
    ``valid``, a contiguous uint8 mask of the broadcast shape) inserted
    (after its block's own dedup) into a set of next_pow2(2 * budget)
    slots and the distinct count
    written to ``count``.  With ``m`` > 0 (dedup) the first m distinct
    keys are also compacted; returns (slot of each key, compact index of
    each slot, compact src, compact dst).  ``m`` == 0 (count mode): no
    budget, nothing compacted."""
    dev = src.device
    n = src.numel()
    dims, s_str, d_str = _grid(src, dst)
    nslots = _next_pow2(2 * (m if m else n))
    # the set's keys, then the keys won so far (the kernel clears both)
    keys = torch.empty(nslots + 2, dtype=torch.int64, device=dev)
    i32 = lambda k: torch.empty(k, dtype=torch.int32, device=dev)  # noqa: E731
    slot_of, sidx, cs, cd = ((i32(n), i32(nslots + 1), i32(m), i32(m)) if m
                             else (None,) * 4)
    KERNELS["ubodt_dedup_claim"].launch(
        dev, ptr(src), ptr(dst), ptr(dims), ptr(s_str), ptr(d_str),
        ptr(valid), ptr(keys), nslots, ptr(sidx), ptr(slot_of), ptr(cs),
        ptr(cd), m, ptr(count))
    return slot_of, sidx, cs, cd


def ubodt_lookup_dedup(u: DeviceUBODT, src: torch.Tensor, dst: torch.Tensor,
                       with_first: bool = True) -> DedupProbe:
    """The deduplicated probe over broadcastable int32 keys (at most 4-d):
    claim, kernel 2 over the compact distinct keys, scatter-back (or the
    full-width probe inside the scatter launch when the distinct count
    exceeds the budget, decided on the device).  Returns a ``DedupProbe``
    whose ``n_unique`` stays on the device; past the budget it is a lower
    bound above ``m`` (the claim stops inserting once the fallback is
    certain).  CPU tensors run ``ubodt_lookup_dedup_plain``."""
    if src.device.type == "cpu":
        return ubodt_lookup_dedup_plain(u, src, dst, with_first)
    src, dst = torch.broadcast_tensors(src, dst)
    _check_keys(u, src, dst)
    dev, shape, n = src.device, tuple(src.shape), src.numel()
    m = _budget(n)
    note_lookup(u)
    if m >= n:
        return DedupProbe(*_probe(u, src, dst, with_first), None, m)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    claim = _claim(src, dst, None, m, count)
    compact = _probe(u, claim[2], claim[3], with_first, n_live=count)
    return DedupProbe(*_scatter(u, src, dst, claim, count, m, compact), count,
                      m)


def _scatter(u: DeviceUBODT, src, dst, claim, count, m: int, compact):
    """Launch the scatter kernel: each key's result from the compact
    probe's ``compact`` (dist, time, first) through its slot in ``claim``
    (``_claim``'s result), or, when ``count`` > m, from its own probe."""
    dev = src.device
    dims, s_str, d_str = _grid(src, dst)
    dist, time, first = _empty_result(tuple(src.shape), dev,
                                      compact[2] is not None)
    with table_args(u) as (table, tier):
        KERNELS["ubodt_dedup_scatter"].launch(
            dev, ptr(src), ptr(dst), ptr(dims), ptr(s_str), ptr(d_str),
            ptr(claim[0]), ptr(claim[1]), ptr(count), m, ptr(compact[0]),
            ptr(compact[1]), ptr(compact[2]), table, u.bmask, int(u.wide),
            ptr(dist), ptr(time), ptr(first), *tier)
    return dist, time, first


class DedupStats:
    """The deduplicated probes the wrappers dispatched: each one's distinct
    count stays on the device until ``harvest`` (a caller's collect, which
    already waits on the device) reads it.  Totals: ``probes`` (dedup
    dispatches read back), ``pairs`` and ``distinct`` over them,
    ``dedup_fallbacks`` (dispatches whose distinct count exceeded the
    budget and took the full-width probe) and ``last`` (n, m, n_unique of
    the newest)."""

    _MAX_PENDING = 64

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: deque = deque()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._pending.clear()
            self.probes = self.pairs = self.distinct = self.dedup_fallbacks = 0
            self.last = None

    def record(self, n: int, m: int, n_unique: torch.Tensor) -> None:
        with self._lock:
            self._pending.append((n, m, n_unique))
            over = len(self._pending) > self._MAX_PENDING
        if over:
            self.harvest()

    def harvest(self) -> None:
        with self._lock:
            pending, self._pending = list(self._pending), deque()
            for n, m, n_unique in pending:
                u = int(n_unique.reshape(-1)[0])
                self.probes += 1
                self.pairs += n
                self.distinct += u
                self.dedup_fallbacks += u > m
                self.last = (n, m, u)

    def summary(self) -> dict:
        self.harvest()
        return {"probes": self.probes, "pairs": self.pairs,
                "distinct": self.distinct,
                "dedup_fallbacks": self.dedup_fallbacks, "last": self.last}


DEDUP = DedupStats()


def ubodt_lookup(u: DeviceUBODT, src: torch.Tensor, dst: torch.Tensor,
                 with_first: bool = True, dedup: bool = False):
    """Vectorised table probe over broadcastable int32 ``src``/``dst`` (at
    most 4-d).  Returns (dist, time, first_edge): dist/time = +inf and
    first_edge = -1 on a miss; with ``with_first=False`` first_edge is
    neither written nor returned (None).  ``dedup`` probes each distinct
    pair once from _DEDUP_MIN_PAIRS pairs (same results; its distinct
    count goes to ``DEDUP``).  CUDA tensors launch the kernels, which read
    the broadcast through strides (no materialised key arrays); CPU
    tensors run the plain versions."""
    src, dst = torch.broadcast_tensors(src, dst)
    if isinstance(u, ShardedUBODT):
        return ubodt_lookup_sharded(u, src, dst, with_first)
    if dedup and src.numel() >= _DEDUP_MIN_PAIRS:
        r = ubodt_lookup_dedup(u, src, dst, with_first)
        if r.n_unique is not None:
            DEDUP.record(src.numel(), r.m, r.n_unique)
        return r.dist, r.time, r.first
    if src.device.type == "cpu":
        return ubodt_lookup_plain(u, src, dst, with_first)
    _check_keys(u, src, dst)
    note_lookup(u)
    return _probe(u, src, dst, with_first)


def ubodt_lookup_sharded(u: ShardedUBODT, src: torch.Tensor,
                         dst: torch.Tensor, with_first: bool = True,
                         plain: bool = False):
    """The probe of a table split over the gp axis: each gp rank probes
    its bucket range (kernel 2's ``[sharded]`` instantiation on a card,
    the plain version with ``plain`` or on the CPU), then pmin over dist
    and time and pmax over the first edge resolve every key on gp rank 0's
    device.  Keys live in exactly one rank's range, so the merge is exact
    (the reference's ``_ubodt_lookup_sharded``)."""
    src, dst = torch.broadcast_tensors(src, dst)
    lookup = (ubodt_lookup_plain if plain or src.device.type == "cpu"
              else ubodt_lookup)
    parts = []
    for sh in u.shards:
        dev = sh.device
        parts.append(lookup(sh, src.to(dev), dst.to(dev), with_first))
    dist = collectives.pmin([p[0] for p in parts])[0]
    time = collectives.pmin([p[1] for p in parts])[0]
    first = (collectives.pmax([p[2] for p in parts])[0] if with_first
             else None)
    if u.group is not None:  # the row's other processes' ranks
        dist, time = (collectives.all_reduce(x, "min", u.group)
                      for x in (dist, time))
        if first is not None:
            first = collectives.all_reduce(first, "max", u.group)
    return dist, time, first


def count_distinct_pairs_plain(src: torch.Tensor, dst: torch.Tensor,
                               valid: torch.Tensor) -> torch.Tensor:
    """int32 scalar: distinct (src, dst) pairs among the positions where
    ``valid`` (broadcastable)."""
    src, dst, valid = torch.broadcast_tensors(src, dst, valid)
    keys = _pair_keys(src[valid != 0], dst[valid != 0])
    return torch.tensor(torch.unique(keys).numel(), dtype=torch.int32,
                        device=src.device)


def count_distinct_pairs(src: torch.Tensor, dst: torch.Tensor,
                         valid: torch.Tensor,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 scalar: distinct (src, dst) pairs among the positions where
    ``valid`` (the reference's ``count_distinct_pairs``, the numerator of
    the probe-dedup redundancy).  On the card the claim kernel in count
    mode; the count is written into ``out`` (int32, one element) when
    given.  CPU tensors run the plain version."""
    if src.device.type == "cpu":
        r = count_distinct_pairs_plain(src, dst, valid)
        if out is not None:
            out.copy_(r.reshape(out.shape))
        return r
    src, dst = torch.broadcast_tensors(src, dst)
    for name, t in (("src", src), ("dst", dst)):
        if t.dtype != torch.int32:
            raise ValueError("%s must be int32" % name)
    mask = torch.broadcast_to(valid, src.shape).to(torch.uint8).contiguous()
    if out is None:
        out = torch.empty(1, dtype=torch.int32, device=src.device)
    check(out, "out", torch.int32, src.device)
    _claim(src, dst, mask, 0, out)
    return out.reshape(())
