// UBODT probe arithmetic shared by the probe kernel (ubodt_probe.cu), the
// dedup scatter (ubodt_dedup.cu) and the seam transition of the chain
// kernels (viterbi_chain.cu, viterbi_assoc.cu): the two uint32 pair hashes
// of reporter_tpu/ops/hashtable.py:63,:75, the bucket-row fetch
// (bucket_row, :122 _bucket_rows with reporter_tpu/tiles/tiering.py:538
// tiered_bucket_rows), a warp probe and a serial probe of both table
// layouts (:138 _lookup_plain, :96 _select), and the 4-d key grid the
// probe kernels read through strides.
//
// Tiered tables (RowSource with a slot map): a bucket's row comes from the
// hot arena on the card when slot_map[b] >= 0, else from the full table
// in pinned host memory, read in place over the host link.  Each probe
// decides alone.  The arena rows are copies of the pages, so the bytes a
// probe reads, and its answer, are the untiered table's.  With counts,
// every fetch adds one to counts[b] (the maintenance window's probe
// frequencies) and to the hit (hot) or miss (cold) total.
//
// Layouts, read as int4 (entry e = int4 2e: src, dst, dist bits, time
// bits; int4 2e+1: first_edge and padding):
//   cuckoo  [n_buckets, 128] int32 = 32 int4 per row, 16 entries; a key
//           lives in one of its two buckets (pair_hash1, pair_hash2);
//   wide32  [n_buckets, 256] int32 = 64 int4 per row, 32 entries; a key
//           lives in its one bucket (pair_hash1).
// The merge over rows and entries is min dist, min time, max first edge
// (exact and order-free; keys are unique, so at most one entry hits).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rtt {

__device__ __forceinline__ uint32_t pair_hash1(uint32_t s, uint32_t d) {
  uint32_t h = s * 0x9E3779B1u + d * 0x85EBCA6Bu;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  return h;
}

__device__ __forceinline__ uint32_t pair_hash2(uint32_t s, uint32_t d) {
  uint32_t h = s * 0x85EBCA77u + d * 0xC2B2AE3Du;
  h ^= h >> 13;
  h *= 0x27D4EB2Fu;
  h ^= h >> 16;
  return h;
}

// Where a probe's bucket rows come from, beside the table pointer
// ``packed`` the kernels take: slot_map null, an untiered table in device
// memory.  Otherwise ``packed`` is the full table in pinned host memory (a
// device-mapped address), arena holds the hot rows, and counts / totals
// (each may be null) are the fetch counters.
struct RowSource {
  const int32_t* slot_map;     // [n_buckets] arena row, -1 cold; or null
  const int4* arena;           // [hot rows, row]
  int32_t* counts;             // [n_buckets] fetches this window
  unsigned long long* totals;  // [2] hits, misses
};

// The row (row_int4 int4 long) of bucket b, and whether it is hot (an
// untiered table's rows always are).  TIERED = false is the untiered
// address arithmetic alone.
template <bool TIERED>
__device__ __forceinline__ const int4* bucket_row(
    const int4* __restrict__ packed, const RowSource& src, uint32_t b,
    int row_int4, bool* hot) {
  if constexpr (!TIERED) {
    *hot = true;
    return packed + (int64_t)b * row_int4;
  } else {
    const int32_t slot = src.slot_map[b];
    *hot = slot >= 0;
    return slot >= 0 ? src.arena + (int64_t)slot * row_int4
                     : packed + (int64_t)b * row_int4;
  }
}

// One fetch of bucket b into the window's counts.
__device__ __forceinline__ void count_fetch(const RowSource& src, uint32_t b) {
  if (src.counts) atomicAdd(src.counts + b, 1);
}

// Add hits and misses to the totals (a warp's, a block's, or one
// thread's aggregate).
__device__ __forceinline__ void add_totals(const RowSource& src,
                                           unsigned long long hits,
                                           unsigned long long misses) {
  if (!src.totals) return;
  if (hits) atomicAdd(src.totals, hits);
  if (misses) atomicAdd(src.totals + 1, misses);
}

// A gp rank's bucket range [lo, lo + n) of the table (SHARDED probes):
// packed then holds only those n rows, and a bucket outside the range
// contributes a row of -2 lanes, which matches no key (node ids are never
// negative), as the reference's sharded probe masks it.
struct BucketRange {
  uint32_t lo;
  uint32_t n;
};

// Broadcast keys: element i of the 4-d grid `dim` sits at i's coordinates
// dotted with each side's strides (0 strides broadcast).
struct Grid4 {
  int64_t dim[4];
  int64_t src_stride[4];
  int64_t dst_stride[4];
};

// Grid4 from the host's dims / strides arrays; returns the element count.
inline int64_t make_grid(const int64_t* dims, const int64_t* src_strides,
                         const int64_t* dst_strides, Grid4* g) {
  int64_t n = 1;
  for (int a = 0; a < 4; ++a) {
    g->dim[a] = dims[a];
    g->src_stride[a] = src_strides[a];
    g->dst_stride[a] = dst_strides[a];
    n *= dims[a];
  }
  return n;
}

__device__ __forceinline__ void grid_keys(const int32_t* __restrict__ src,
                                          const int32_t* __restrict__ dst,
                                          const Grid4& g, int64_t i,
                                          int32_t* s, int32_t* d) {
  int64_t r = i, so = 0, dof = 0;
#pragma unroll
  for (int a = 3; a >= 0; --a) {
    const int64_t c = r % g.dim[a];
    r /= g.dim[a];
    so += c * g.src_stride[a];
    dof += c * g.dst_stride[a];
  }
  *s = src[so];
  *d = dst[dof];
}

// One probe by a whole warp (all 32 lanes, the same key): lane l loads
// int4 l of each 512-byte half row, so a row is one coalesced read (two
// halves for wide32).  The even lane compares both keys and takes
// first_edge from its odd neighbour.  Every lane returns the result and
// the number of the probe's rows that were hot; with TIERED, lane 0
// counts each fetch.  With SHARDED, packed holds only ``range``'s rows
// and a bucket outside it reads as -2 lanes.
template <bool WIDE, bool TIERED, bool SHARDED = false>
__device__ __forceinline__ int warp_probe(const int4* __restrict__ packed,
                                          const RowSource& src,
                                          uint32_t bmask, int32_t s,
                                          int32_t d, int lane, float* dist,
                                          float* time, int32_t* first,
                                          BucketRange range = BucketRange{}) {
  constexpr int kRows = WIDE ? 1 : 2;   // home buckets
  constexpr int kHalves = WIDE ? 2 : 1; // 512-byte halves per row
  float best_d = INFINITY, best_t = INFINITY;
  int32_t best_f = -1;
  int n_hot = 0;
  int4 v[kRows * kHalves];
#pragma unroll
  for (int w = 0; w < kRows; ++w) {
    const uint32_t h = (w == 0 ? pair_hash1((uint32_t)s, (uint32_t)d)
                               : pair_hash2((uint32_t)s, (uint32_t)d)) & bmask;
    if constexpr (SHARDED) {
      const uint32_t loc = h - range.lo;  // wraps past n below lo
      const bool mine = loc < range.n;
      const int4* row = packed + (int64_t)(mine ? loc : 0) * (32 * kHalves);
#pragma unroll
      for (int q = 0; q < kHalves; ++q)
        v[w * kHalves + q] = mine ? row[q * 32 + lane]
                                  : make_int4(-2, -2, -2, -2);
    } else {
      bool hot;
      const int4* row = bucket_row<TIERED>(packed, src, h, 32 * kHalves,
                                           &hot);
      if constexpr (TIERED) {
        n_hot += hot;
        if (lane == 0) count_fetch(src, h);
      }
#pragma unroll
      for (int q = 0; q < kHalves; ++q) v[w * kHalves + q] = row[q * 32 + lane];
    }
  }
#pragma unroll
  for (int r = 0; r < kRows * kHalves; ++r) {
    const int fe = __shfl_down_sync(0xffffffffu, v[r].x, 1);
    if ((lane & 1) == 0 && v[r].x == s && v[r].y == d) {
      const float dd = __int_as_float(v[r].z), tt = __int_as_float(v[r].w);
      best_d = dd < best_d ? dd : best_d;
      best_t = tt < best_t ? tt : best_t;
      best_f = fe > best_f ? fe : best_f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, best_d, off);
    const float ot = __shfl_xor_sync(0xffffffffu, best_t, off);
    const int32_t of = __shfl_xor_sync(0xffffffffu, best_f, off);
    best_d = od < best_d ? od : best_d;
    best_t = ot < best_t ? ot : best_t;
    best_f = of > best_f ? of : best_f;
  }
  *dist = best_d;
  *time = best_t;
  *first = best_f;
  return n_hot;
}

// One probe by one thread: (dist, time) of (s, d), +inf on a miss; `wide`
// selects the table layout (one 32-entry row, or two 16-entry rows).  Rows
// come through the source's tier when it has one; with ``count`` each
// fetch is counted and ``hits`` / ``fetches`` grow.
__device__ __forceinline__ void probe_serial(const int4* __restrict__ packed,
                                             const RowSource& src,
                                             uint32_t bmask, bool wide,
                                             int32_t s, int32_t d,
                                             float* dist, float* time,
                                             bool count, int* hits,
                                             int* fetches) {
  float bd = INFINITY, bt = INFINITY;
  const int rows = wide ? 1 : 2;
  const int entries = wide ? 32 : 16;
  const bool tiered = src.slot_map != nullptr;
  for (int w = 0; w < rows; ++w) {
    const uint32_t h = (w == 0 ? pair_hash1((uint32_t)s, (uint32_t)d)
                               : pair_hash2((uint32_t)s, (uint32_t)d)) & bmask;
    bool hot;
    const int4* row =
        tiered ? bucket_row<true>(packed, src, h, 2 * entries, &hot)
               : bucket_row<false>(packed, src, h, 2 * entries, &hot);
    if (tiered && count) {
      count_fetch(src, h);
      *hits += hot;
      *fetches += 1;
    }
    for (int e = 0; e < entries; ++e) {
      const int4 v = row[2 * e];
      if (v.x == s && v.y == d) {
        const float dd = __int_as_float(v.z), tt = __int_as_float(v.w);
        bd = dd < bd ? dd : bd;
        bt = tt < bt ? tt : bt;
      }
    }
  }
  *dist = bd;
  *time = bt;
}

}  // namespace rtt
