"""UBODT: upper-bounded origin-destination table of route distances.

A copy of the reference's table in its two layouts.  A bounded-radius
Dijkstra from every node yields all node pairs within ``delta`` metres;
the rows go into a hash table ``packed[n_buckets, entries, ROW_W]`` int32,
one entry = (src, dst, dist-bits, time-bits, first_edge, 0, 0, 0):

``cuckoo`` (the default): 2-choice bucketed cuckoo, BUCKET=16 entries per
bucket, so a bucket is one 512-byte row and a probe reads exactly two
rows (ops/hashtable.py), sized to LOAD_TARGET.

``wide32``: single-hash (``pair_hash``) buckets of WIDE_BUCKET=32
entries, one 1 KB row, so a probe reads one row; entries take the first
free slot of their home bucket, the table is sized to WIDE_LOAD and
doubles when a bucket overflows.

The native packers (rn_cuckoo_pack, rn_wide_pack) and the Python loops
below produce bit-identical tables; all are bit-identical to the
reference's builders.  ``relayout`` repacks a table's rows into the other
layout without a graph search.  The tiered table is ``tiles/tiering.py``'s;
on a device mesh's gp axis each rank holds the bucket-range slice
``DeviceUBODT.shard`` gives (``parallel/mesh.py``).
"""

from __future__ import annotations

import heapq
import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..obs import metrics as obs

log = logging.getLogger(__name__)

# the distributed builder's work units; the port builds its tables in one
# process, so the family is registered (as the JAX package's is) and stays
# empty
C_DIST_UNITS = obs.counter(
    "reporter_ubodt_dist_units_total",
    "Distributed-builder source-range work units by outcome (built = "
    "journalled complete by a worker, requeued = a dead worker's "
    "unfinished remainder re-run once on the parent; "
    "docs/performance.md \"Continent-scale data plane\")",
    ("outcome",))

# uint32 multiplicative mixing constants; two independent mixes give the
# two cuckoo bucket choices
_H1A = np.uint32(0x9E3779B1)
_H1B = np.uint32(0x85EBCA6B)
_H2A = np.uint32(0x85EBCA77)
_H2B = np.uint32(0xC2B2AE3D)

EMPTY = -1
BUCKET = 16  # entries per bucket: 16 x ROW_W = one 128-lane int32 row
ROW_W = 8  # int32 lanes per entry
F_SRC, F_DST, F_DIST, F_TIME, F_FE = 0, 1, 2, 3, 4
LOAD_TARGET = 0.75
MAX_KICKS = 500
# wide32: 32 entries per single-hash bucket = one 256-lane (1 KB) row,
# sized sparser than cuckoo (no displacement): a bucket overflow doubles
# the table
WIDE_BUCKET = 32
WIDE_LOAD = 0.33
LAYOUTS = ("cuckoo", "wide32")


def bucket_entries(layout: str) -> int:
    """Entries per bucket row of a table layout (16 cuckoo, 32 wide32)."""
    if layout == "wide32":
        return WIDE_BUCKET
    if layout == "cuckoo":
        return BUCKET
    raise ValueError("unknown UBODT layout %r (expected one of %s)"
                     % (layout, LAYOUTS))


def pair_hash(src, dst, mask):
    """Bucket choice 1 (numpy uint32 arithmetic)."""
    s = src.astype(np.uint32) if hasattr(src, "astype") else np.uint32(src)
    d = dst.astype(np.uint32) if hasattr(dst, "astype") else np.uint32(dst)
    with np.errstate(over="ignore"):
        h = s * _H1A + d * _H1B
        h ^= h >> np.uint32(15)
        h = h * np.uint32(0x2C1B3C6D)
        h ^= h >> np.uint32(12)
    return (h & np.uint32(mask)).astype(np.int64) if hasattr(h, "astype") else int(h) & mask


def pair_hash2(src, dst, mask):
    """Bucket choice 2 (independent mix constants)."""
    s = src.astype(np.uint32) if hasattr(src, "astype") else np.uint32(src)
    d = dst.astype(np.uint32) if hasattr(dst, "astype") else np.uint32(dst)
    with np.errstate(over="ignore"):
        h = s * _H2A + d * _H2B
        h ^= h >> np.uint32(13)
        h = h * np.uint32(0x27D4EB2F)
        h ^= h >> np.uint32(16)
    return (h & np.uint32(mask)).astype(np.int64) if hasattr(h, "astype") else int(h) & mask


class DeviceUBODT:
    """The table as the probe kernels read it: ``packed`` [n_buckets, 128]
    (cuckoo) or [n_buckets, 256] (wide32) int32, one bucket per row, the
    bucket mask and the layout tag.

    A gp rank's view (``shard``, ``sharded`` True) holds only the
    contiguous bucket range [lo, lo + L) of the table, ``packed``
    [L, width]: its probe reads the
    rows it holds and lets every other bucket contribute a row of -2
    lanes, which matches no key (the reference's ``_ubodt_lookup_sharded``
    masking), so the ranks' answers merge exactly by min / max."""

    def __init__(self, packed: torch.Tensor, bmask: int,
                 layout: str = "cuckoo", lo: int = 0, sharded: bool = False):
        width = bucket_entries(layout) * ROW_W
        if packed.dtype != torch.int32 or packed.dim() != 2 \
                or packed.shape[1] != width:
            raise ValueError("packed must be [n_buckets, %d] int32 (%s)"
                             % (width, layout))
        if not sharded and (lo or packed.shape[0] != int(bmask) + 1):
            raise ValueError("packed has %d buckets, bmask %d"
                             % (packed.shape[0], bmask))
        if lo < 0 or packed.shape[0] < 1 or lo + packed.shape[0] > int(bmask) + 1:
            raise ValueError("bucket range [%d, %d) outside a table of %d "
                             "buckets" % (lo, lo + packed.shape[0], bmask + 1))
        self.packed = packed.contiguous()
        self.bmask = int(bmask)
        self.layout = layout
        self.lo = int(lo)
        # a gp rank's bucket-range view (set only by ``shard``)
        self.sharded = bool(sharded)

    @property
    def wide(self) -> bool:
        return self.layout == "wide32"

    @property
    def local_buckets(self) -> int:
        """Buckets this view holds: the whole table, or a rank's range."""
        return self.packed.shape[0]

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def to_device(self, device="cuda") -> "DeviceUBODT":
        return DeviceUBODT(self.packed.to(resolve_device(device)), self.bmask,
                           self.layout, self.lo, self.sharded)

    def shard(self, idx: int, n_shards: int, device=None) -> "DeviceUBODT":
        """Rank ``idx`` of ``n_shards``'s view: the contiguous bucket range
        of ``tiles.tiering.shard_bucket_range`` (the partition the fleet
        shards use too), copied to ``device`` (default: where the table
        is).  The table must split evenly (``check_ubodt_shardable``)."""
        from .tiering import shard_bucket_range

        if self.sharded:
            raise ValueError("a bucket-range view cannot be sharded again")
        if (self.bmask + 1) % n_shards:
            raise ValueError("UBODT bucket count %d not divisible by gp=%d"
                             % (self.bmask + 1, n_shards))
        lo, hi = shard_bucket_range(idx, n_shards, self.bmask + 1)
        dev = self.packed.device if device is None else device
        return DeviceUBODT(self.packed[lo:hi].to(dev), self.bmask,
                           self.layout, lo, sharded=True)


class ShardedUBODT:
    """One dp rank's view of a table split over a mesh's gp axis (the
    reference's ``DeviceUBODT.with_shard_axis``): the gp ranks' bucket-range
    views in rank order, each on its rank's device, together the whole
    table.  A probe fans out over them and merges by min / max
    (``ops/hashtable.ubodt_lookup``).

    With ``group`` (a ``torch.distributed`` process group: a dp row that
    spans processes) the views are this process's contiguous run of the
    row's gp ranks, and every probe's merge continues over the group's
    processes (``parallel/multihost.py``)."""

    def __init__(self, shards, group=None):
        self.shards = list(shards)
        self.group = group
        first = self.shards[0]
        self.bmask, self.layout = first.bmask, first.layout
        at = first.lo if group is not None else 0
        for sh in self.shards:
            if (sh.lo, sh.bmask, sh.layout) != (at, self.bmask, self.layout):
                raise ValueError("gp shards must cover the table in rank order")
            at += sh.local_buckets
        if group is None and at != self.bmask + 1:
            raise ValueError("gp shards cover %d of %d buckets"
                             % (at, self.bmask + 1))

    @property
    def wide(self) -> bool:
        return self.layout == "wide32"


@dataclass
class UBODT:
    delta: float
    packed: np.ndarray  # [n_buckets, bucket_entries, ROW_W] int32
    bmask: int  # n_buckets - 1
    num_rows: int
    max_kicks: int  # longest displacement chain (cuckoo) / 0 (wide32)
    # the graph's edge_to, attached after construction (path reconstruction)
    _edge_to: Optional[np.ndarray] = None
    layout: str = "cuckoo"

    @property
    def bucket_entries(self) -> int:
        return bucket_entries(self.layout)

    @property
    def n_buckets(self) -> int:
        return self.bmask + 1

    def attach_graph(self, edge_to: np.ndarray) -> "UBODT":
        self._edge_to = edge_to
        return self

    def _find(self, src: int, dst: int) -> int:
        """Flat entry index of the (src, dst) row, or -1: one home bucket
        (wide32) or two (cuckoo)."""
        hashes = [int(pair_hash(np.int64(src), np.int64(dst), self.bmask))]
        if self.layout == "cuckoo":
            hashes.append(int(pair_hash2(np.int64(src), np.int64(dst),
                                         self.bmask)))
        be = self.bucket_entries
        for h in hashes:
            for s in range(be):
                e = self.packed[h, s]
                if e[F_SRC] == src and e[F_DST] == dst:
                    return h * be + s
        return -1

    def lookup(self, src: int, dst: int) -> Tuple[float, int]:
        """Host-side probe: (dist, first_edge), or (inf, -1) on a miss."""
        i = self._find(src, dst)
        if i < 0:
            return float("inf"), -1
        e = self.packed.reshape(-1, ROW_W)[i]
        return float(np.int32(e[F_DIST]).view(np.float32)), int(e[F_FE])

    def lookup_full(self, src: int, dst: int) -> Tuple[float, float, int]:
        """Host-side probe: (dist, time, first_edge), or (inf, inf, -1) on a
        miss (the CPU baseline's transitions)."""
        i = self._find(src, dst)
        if i < 0:
            return float("inf"), float("inf"), -1
        e = self.packed.reshape(-1, ROW_W)[i]
        return (float(np.int32(e[F_DIST]).view(np.float32)),
                float(np.int32(e[F_TIME]).view(np.float32)), int(e[F_FE]))

    def path_edges(self, src: int, dst: int) -> Optional[List[int]]:
        """Edge sequence of the shortest path src -> dst by chaining
        first-edge hops; None if unreachable within delta."""
        if src == dst:
            return []
        edges: List[int] = []
        node = src
        for _ in range(self.num_rows + 1):  # bounded against corruption
            _dist, fe = self.lookup(node, dst)
            if fe < 0:
                return None
            edges.append(fe)
            node = int(self._edge_to[fe]) if self._edge_to is not None else None
            if node is None:
                return None
            if node == dst:
                return edges
        return None

    def rows(self) -> Tuple[np.ndarray, ...]:
        """(src, dst, dist, time, first_edge) columns of every occupied
        entry in (bucket, slot) order: what ``relayout`` repacks."""
        flat = self.packed.reshape(-1, ROW_W)
        e = flat[flat[:, F_SRC] != EMPTY]
        return (e[:, F_SRC].copy(), e[:, F_DST].copy(),
                e[:, F_DIST].view(np.float32).copy(),
                e[:, F_TIME].view(np.float32).copy(), e[:, F_FE].copy())

    def relayout(self, layout: str, use_native: bool = True,
                 lib=None) -> "UBODT":
        """This table's rows repacked into ``layout`` (no graph search);
        self when the layout already matches.  The packer runs in C++ when
        the native core is available (or ``lib`` is given)."""
        if layout == self.layout:
            return self
        if use_native and lib is None:
            from ..native import get_lib

            lib = get_lib()
        out = ubodt_from_columns(*self.rows(), self.delta, lib=lib,
                                 layout=layout)
        out._edge_to = self._edge_to
        return out

    def device_ubodt(self) -> DeviceUBODT:
        """The probe kernels' view of this table, on the CPU (``to_device``
        moves it)."""
        return DeviceUBODT(
            torch.from_numpy(self.packed.reshape(
                self.n_buckets, self.bucket_entries * ROW_W)),
            self.bmask, self.layout)

    def to_device(self, device="cuda") -> DeviceUBODT:
        return self.device_ubodt().to_device(device)


def _bounded_dijkstra(src, delta, out_start, out_edges, edge_to, edge_len,
                      edge_speed) -> List[Tuple[int, float, float, int]]:
    """All (dst, dist, time, first_edge) with dist <= delta from src,
    shortest by distance; includes the trivial (src, 0, 0, -1) row."""
    dist = {src: 0.0}
    tim = {src: 0.0}
    first = {src: -1}
    heap = [(0.0, src)]
    out: List[Tuple[int, float, float, int]] = []
    done = set()
    while heap:
        d, n = heapq.heappop(heap)
        if n in done:
            continue
        done.add(n)
        out.append((n, d, tim[n], first[n]))
        for k in range(out_start[n], out_start[n + 1]):
            e = int(out_edges[k])
            m = int(edge_to[e])
            nd = d + float(edge_len[e])
            if nd <= delta and nd < dist.get(m, float("inf")):
                dist[m] = nd
                tim[m] = tim[n] + float(edge_len[e]) / max(float(edge_speed[e]), 0.1)
                first[m] = e if n == src else first[n]
                heapq.heappush(heap, (nd, m))
    return out


def build_ubodt(arrays, delta: float = 3000.0,
                load_factor: Optional[float] = None, num_threads: int = 0,
                use_native: bool = True, lib=None,
                layout: str = "cuckoo") -> UBODT:
    """Build the table in ``layout`` from GraphArrays: the native parallel
    Dijkstra and packer when available (or ``lib`` is given), else the
    Python loops."""
    if use_native and lib is None:
        from ..native import get_lib

        lib = get_lib()
    if use_native and lib is not None:
        src, dst, dist, tm, fe = _native_build_rows(lib, arrays, delta,
                                                    num_threads)
        return ubodt_from_columns(src, dst, dist, tm, fe, delta, load_factor,
                                  lib=lib, layout=layout
                                  ).attach_graph(arrays.edge_to)
    rows = []
    for src in range(arrays.num_nodes):
        for dst, d, tm, fe in _bounded_dijkstra(
                src, delta, arrays.out_start, arrays.out_edges,
                arrays.edge_to, arrays.edge_len, arrays.edge_speed):
            rows.append((src, dst, d, tm, fe))
    cols = list(zip(*rows)) if rows else [(), (), (), (), ()]
    return ubodt_from_columns(
        np.asarray(cols[0], np.int32), np.asarray(cols[1], np.int32),
        np.asarray(cols[2], np.float32), np.asarray(cols[3], np.float32),
        np.asarray(cols[4], np.int32), delta, load_factor, lib=None,
        layout=layout).attach_graph(arrays.edge_to)


def _native_build_rows(lib, arrays, delta: float, num_threads: int):
    """(src, dst, dist, time, first_edge) columns from the C++ builder."""
    import ctypes

    n_rows = ctypes.c_int64(0)
    handle = lib.rn_ubodt_build(
        arrays.num_nodes,
        np.ascontiguousarray(arrays.out_start, np.int32),
        np.ascontiguousarray(arrays.out_edges, np.int32),
        np.ascontiguousarray(arrays.edge_to, np.int32),
        np.ascontiguousarray(arrays.edge_len, np.float32),
        np.ascontiguousarray(arrays.edge_speed, np.float32),
        float(delta), int(num_threads), ctypes.byref(n_rows),
    )
    if not handle:
        raise MemoryError("rn_ubodt_build failed")
    n = n_rows.value
    src = np.empty(n, np.int32)
    dst = np.empty(n, np.int32)
    dist = np.empty(n, np.float32)
    tm = np.empty(n, np.float32)
    fe = np.empty(n, np.int32)
    lib.rn_ubodt_fetch(handle, src, dst, dist, tm, fe)
    return src, dst, dist, tm, fe


def _pack_python(src, dst, dist, time, first_edge, n_buckets, packed) -> int:
    """Python twin of rn_cuckoo_pack: deterministic 2-choice cuckoo insert
    into ``packed`` (pre-filled with src = EMPTY).  Returns the longest
    displacement chain, or -1 when an insert exceeds MAX_KICKS."""
    bmask = n_buckets - 1
    dist_bits = np.asarray(dist, np.float32).view(np.int32)
    time_bits = np.asarray(time, np.float32).view(np.int32)

    def h1(s, d):
        return int(pair_hash(np.int64(s), np.int64(d), bmask))

    def h2(s, d):
        return int(pair_hash2(np.int64(s), np.int64(d), bmask))

    def put(b, s, e):
        packed[b, s] = 0
        packed[b, s, :5] = e

    def try_place(b, e) -> bool:
        for s in range(BUCKET):
            if packed[b, s, F_SRC] == EMPTY:
                put(b, s, e)
                return True
        return False

    max_chain = 0
    for r in range(len(src)):
        cur = (int(src[r]), int(dst[r]), int(dist_bits[r]), int(time_bits[r]),
               int(first_edge[r]))
        b1 = h1(cur[0], cur[1])
        b2 = h2(cur[0], cur[1])
        if try_place(b1, cur) or try_place(b2, cur):
            continue
        b = b2
        placed = False
        for kick in range(MAX_KICKS):
            s = kick % BUCKET
            victim = tuple(int(v) for v in packed[b, s, :5])
            packed[b, s, :5] = cur
            cur = victim
            nb = h1(cur[0], cur[1])  # the victim's other bucket
            if nb == b:
                nb = h2(cur[0], cur[1])
            b = nb
            if try_place(b, cur):
                max_chain = max(max_chain, kick + 1)
                placed = True
                break
        if not placed:
            return -1
    return max_chain


def _pack_wide_python(src, dst, dist, time, first_edge, n_buckets,
                      packed) -> int:
    """Python twin of rn_wide_pack: single-hash first-free-slot insert into
    ``packed`` [n_buckets, WIDE_BUCKET, ROW_W] (pre-filled with src =
    EMPTY).  Returns the fullest bucket's occupancy, or -1 when a bucket
    overflows.  A row's slot is its rank among its bucket's rows in input
    order, which is what the C++ insert loop gives, so the placement is
    vectorised (a stable argsort by bucket)."""
    n = len(src)
    if n == 0:
        return 0
    b = pair_hash(np.asarray(src, np.int64), np.asarray(dst, np.int64),
                  n_buckets - 1).astype(np.int64)
    order = np.argsort(b, kind="stable")
    sb = b[order]
    start = np.concatenate([[0], np.flatnonzero(sb[1:] != sb[:-1]) + 1])
    group = np.repeat(np.arange(len(start)), np.diff(np.append(start, n)))
    slot = np.arange(n) - start[group]
    fill = int(slot.max()) + 1
    if fill > WIDE_BUCKET:
        return -1
    packed[sb, slot, :] = 0
    packed[sb, slot, F_SRC] = np.asarray(src, np.int32)[order]
    packed[sb, slot, F_DST] = np.asarray(dst, np.int32)[order]
    packed[sb, slot, F_DIST] = np.asarray(dist, np.float32).view(np.int32)[order]
    packed[sb, slot, F_TIME] = np.asarray(time, np.float32).view(np.int32)[order]
    packed[sb, slot, F_FE] = np.asarray(first_edge, np.int32)[order]
    return fill


def ubodt_from_columns(src, dst, dist, time, first_edge, delta: float,
                       load_factor: Optional[float] = None, lib=None,
                       layout: str = "cuckoo") -> UBODT:
    """Pack row columns into a table of ``layout``, doubling the bucket
    count until every insert succeeds; the insert loop runs in C++
    (rn_cuckoo_pack / rn_wide_pack) when ``lib`` is given, else in
    _pack_python / _pack_wide_python (bit-identical tables)."""
    wide = layout == "wide32"
    entries = bucket_entries(layout)
    if load_factor is None:
        load_factor = WIDE_LOAD if wide else LOAD_TARGET
    n = int(len(src))
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    dist = np.ascontiguousarray(dist, np.float32)
    time = np.ascontiguousarray(time, np.float32)
    first_edge = np.ascontiguousarray(first_edge, np.int32)
    n_buckets = 1
    while n_buckets * entries * load_factor < max(n, 1):
        n_buckets <<= 1
    n_buckets = max(n_buckets, 4)
    pack = (lib.rn_wide_pack if wide else lib.rn_cuckoo_pack) if lib else None
    while True:
        packed = np.zeros((n_buckets, entries, ROW_W), np.int32)
        packed[:, :, F_SRC] = EMPTY
        if pack is not None:
            max_chain = pack(n, src, dst, dist, time, first_edge, n_buckets,
                             packed.reshape(-1))
        else:
            max_chain = (_pack_wide_python if wide else _pack_python)(
                src, dst, dist, time, first_edge, n_buckets, packed)
        if max_chain >= 0:
            break
        n_buckets <<= 1
        log.info("ubodt: %s insert failed (%s), growing table to %d buckets",
                 layout, "bucket overflow" if wide else
                 "cuckoo chain exceeded %d kicks" % MAX_KICKS, n_buckets)
    log.info("ubodt: %d rows, %d x %d-entry buckets (%s, load %.2f), %s %d",
             n, n_buckets, entries, layout, n / max(n_buckets * entries, 1),
             "max bucket fill" if wide else "max kick chain", max_chain)
    return UBODT(delta=delta, packed=packed, bmask=n_buckets - 1, num_rows=n,
                 max_kicks=0 if wide else int(max_chain), layout=layout)
