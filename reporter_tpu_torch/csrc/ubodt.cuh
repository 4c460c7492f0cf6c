// UBODT probe arithmetic shared by the probe kernel (ubodt_probe.cu), the
// dedup scatter (ubodt_dedup.cu) and the seam transition of the chain
// kernels (viterbi_chain.cu, viterbi_assoc.cu): the two uint32 pair hashes
// of reporter_tpu/ops/hashtable.py:63,:75, the bucket-row fetch
// (bucket_row, :122 _bucket_rows with reporter_tpu/tiles/tiering.py:538
// tiered_bucket_rows), a warp probe and a serial probe of both table
// layouts (:138 _lookup_plain, :96 _select), the 4-d key grid the probe
// kernels read through strides, decoded in 32-bit fast-divmod arithmetic,
// and kernel 2's persistent grid (probe_loop, probe_kernel, launch_probe),
// whose loop the dedup scatter's full-width fallback runs too.
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
// (exact and order-free; keys are unique, so at most one entry of a real
// key hits, and the empty marker's key (-1, 0) hits only entries of equal
// values).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

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
// dotted with each side's strides (0 strides broadcast).  The host passes
// dims as 12 int64 (ops/hashtable.py _grid): the 4 dims, then each dim's
// fast-divmod multiplier and shift, so that the decode divides by a
// multiply-high, an add and a shift in 32-bit arithmetic: for d >= 1,
// l = ceil(log2 d) and mul = ceil(2^(32+l) / d) - 2^32, i / d =
// (umulhi(i, mul) + i) >> l for every i < 2^31.  ``fast`` holds when the
// grid has fewer than 2^31 keys and every offset fits in 31 bits; a larger
// grid decodes in int64.
struct Grid4 {
  bool fast;
  uint32_t dim32[4], mul[4], shr[4];
  uint32_t src_stride32[4], dst_stride32[4];
  int64_t dim[4];
  int64_t src_stride[4];
  int64_t dst_stride[4];
};

// Grid4 from the host's dims (12 int64, above) and strides arrays;
// returns the element count.
inline int64_t make_grid(const int64_t* dims, const int64_t* src_strides,
                         const int64_t* dst_strides, Grid4* g) {
  constexpr int64_t kLim = 0x7fffffffLL;
  int64_t n = 1, reach_s = 0, reach_d = 0;
  bool fits = true;
  for (int a = 0; a < 4; ++a) {
    g->dim[a] = dims[a];
    g->src_stride[a] = src_strides[a];
    g->dst_stride[a] = dst_strides[a];
    n *= dims[a];
    fits = fits && dims[a] <= kLim && src_strides[a] >= 0 &&
           src_strides[a] <= kLim && dst_strides[a] >= 0 &&
           dst_strides[a] <= kLim;
    if (dims[a] > 0 && fits) {
      reach_s += (dims[a] - 1) * src_strides[a];
      reach_d += (dims[a] - 1) * dst_strides[a];
    }
    g->dim32[a] = (uint32_t)dims[a];
    g->mul[a] = (uint32_t)dims[4 + a];
    g->shr[a] = (uint32_t)dims[8 + a];
    g->src_stride32[a] = (uint32_t)src_strides[a];
    g->dst_stride32[a] = (uint32_t)dst_strides[a];
  }
  g->fast = fits && n < kLim && reach_s < kLim && reach_d < kLim;
  return n;
}

__device__ __forceinline__ void grid_keys(const int32_t* __restrict__ src,
                                          const int32_t* __restrict__ dst,
                                          const Grid4& g, int64_t i,
                                          int32_t* s, int32_t* d) {
  if (g.fast) {
    uint32_t r = (uint32_t)i, so = 0, dof = 0;
#pragma unroll
    for (int a = 3; a >= 1; --a) {
      const uint32_t q = (__umulhi(r, g.mul[a]) + r) >> g.shr[a];
      const uint32_t c = r - q * g.dim32[a];
      so += c * g.src_stride32[a];
      dof += c * g.dst_stride32[a];
      r = q;
    }
    // i < n, so the leading coordinate is what is left
    *s = src[so + r * g.src_stride32[0]];
    *d = dst[dof + r * g.dst_stride32[0]];
    return;
  }
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

// The probes of 32 keys by one warp: every lane calls it with its own key
// (s, d) and ``active`` (false: no key), and gets its own key's (dist,
// time, first_edge), +inf / +inf / -1 on a miss.  The owning lane alone
// hashes its key and finds its rows (with TIERED it reads slot_map and
// counts each fetch; with SHARDED a row outside ``range`` is not visited:
// packed holds only the range's rows, and the reference's -2 lanes there
// match no key).  Then the warp walks the visited rows of all 32 keys in
// turn, kBatch rows in flight: each row's address is broadcast by
// shuffle and lane l loads int4 l of each 512-byte half, so a row is one
// coalesced read (two for wide32).  The even lanes compare against the
// row's broadcast key and a ballot finds the hits; shuffles bring each
// hit's dist, time and first_edge (from the odd neighbour) to the owner,
// which merges them by min dist, min time, max first_edge, the
// reference's merge.  Real keys are unique, so a row holds at most one
// hit, but the empty marker (-1, 0) hits every empty entry (src -1, zeros
// elsewhere): every set bit of the ballot is merged, so that key's answer
// (0, 0, 0) is exact too.  A cuckoo key found in its first row skips its
// second: a unique key is not there, and the empty marker's second row
// could only add equal hits.  Its fetch still counts (the reference reads
// both rows).  Returns how many of the owner's rows were hot (TIERED; 0
// otherwise).
template <bool WIDE, bool TIERED, bool SHARDED = false>
__device__ __forceinline__ int warp_probe(const int4* __restrict__ packed,
                                          const RowSource& src,
                                          uint32_t bmask, bool active,
                                          int32_t s, int32_t d, int lane,
                                          float* dist, float* time,
                                          int32_t* first,
                                          BucketRange range = BucketRange{}) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kRows = WIDE ? 1 : 2;      // home buckets
  constexpr int kHalves = WIDE ? 2 : 1;    // 512-byte halves per row
  constexpr int kRowInt4 = 32 * kHalves;
  constexpr int kBatch = WIDE ? 4 : 8;     // rows in flight, 4 KB a warp
  const int4* row[kRows];
  unsigned visit[kRows];
  int n_hot = 0;
#pragma unroll
  for (int w = 0; w < kRows; ++w) {
    const uint32_t h = (w == 0 ? pair_hash1((uint32_t)s, (uint32_t)d)
                               : pair_hash2((uint32_t)s, (uint32_t)d)) & bmask;
    bool mine = active;
    row[w] = packed;
    if constexpr (SHARDED) {
      const uint32_t loc = h - range.lo;  // wraps past n below lo
      mine = mine && loc < range.n;
      if (mine) row[w] = packed + (int64_t)loc * kRowInt4;
    } else if (mine) {
      bool hot;
      row[w] = bucket_row<TIERED>(packed, src, h, kRowInt4, &hot);
      if constexpr (TIERED) {
        n_hot += hot;
        count_fetch(src, h);
      }
    }
    visit[w] = __ballot_sync(kAll, mine);
  }
  float bd = INFINITY, bt = INFINITY;
  int32_t bf = -1;
  bool found = false;
#pragma unroll
  for (int w = 0; w < kRows; ++w) {
    unsigned left = visit[w];
    // a key found in its first row is not in its second (keys are unique;
    // the empty marker's second row could only repeat (0, 0, 0)): skip it
    if (w > 0) left &= ~__ballot_sync(kAll, found);
    while (left) {  // uniform across the warp
      int4 v[kBatch][kHalves];
      int who[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        who[k] = left ? __ffs(left) - 1 : -1;
        left &= left - 1u;
        if (who[k] >= 0) {
          const int4* r = reinterpret_cast<const int4*>(__shfl_sync(
              kAll, reinterpret_cast<unsigned long long>(row[w]), who[k]));
#pragma unroll
          for (int q = 0; q < kHalves; ++q) v[k][q] = r[q * 32 + lane];
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (who[k] < 0) break;
        const int32_t ks = __shfl_sync(kAll, s, who[k]);
        const int32_t kd = __shfl_sync(kAll, d, who[k]);
#pragma unroll
        for (int q = 0; q < kHalves; ++q) {
          unsigned hit = __ballot_sync(
              kAll, (lane & 1) == 0 && v[k][q].x == ks && v[k][q].y == kd);
          while (hit) {
            const int l = __ffs(hit) - 1;
            hit &= hit - 1u;
            const float dd = __int_as_float(__shfl_sync(kAll, v[k][q].z, l));
            const float tt = __int_as_float(__shfl_sync(kAll, v[k][q].w, l));
            const int32_t fe = __shfl_sync(kAll, v[k][q].x, l + 1);
            if (lane == who[k]) {
              bd = dd < bd ? dd : bd;
              bt = tt < bt ? tt : bt;
              bf = fe > bf ? fe : bf;
              found = true;
            }
          }
        }
      }
    }
  }
  *dist = bd;
  *time = bt;
  *first = bf;
  return n_hot;
}

constexpr int kProbeThreads = 256;  // 8 warps, 256 probes a block per pass

// Kernel 2's grid-stride loop over the keys [0, live) of grid g, on a
// persistent grid of kProbeThreads-thread blocks: each warp takes 32 keys
// a pass (warp_probe).  ``live`` must be the same for the whole warp.
// The body of probe_kernel, and of the dedup scatter's full-width
// fallback (ubodt_dedup.cu).
template <bool WIDE, bool TIERED, bool SHARDED>
__device__ __forceinline__ void probe_loop(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const Grid4& g, int64_t live, const int4* __restrict__ packed,
    uint32_t bmask, float* __restrict__ out_dist, float* __restrict__ out_time,
    int32_t* __restrict__ out_first, const RowSource& tier,
    BucketRange range) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kProbeThreads;
  unsigned hits = 0, fetches = 0;  // TIERED: this lane's probes' rows
  // the loop bound is uniform across the warp: every lane runs every pass
  for (int64_t base = (int64_t)blockIdx.x * kProbeThreads + (threadIdx.x & ~31);
       base < live; base += stride) {
    const int64_t probe = base + lane;
    const bool active = probe < live;
    int32_t s = 0, d = 0;
    if (active) grid_keys(src, dst, g, probe, &s, &d);
    float dist, time;
    int32_t first;
    const int hot = warp_probe<WIDE, TIERED, SHARDED>(
        packed, tier, bmask, active, s, d, lane, &dist, &time, &first, range);
    if (active) {
      out_dist[probe] = dist;
      out_time[probe] = time;
      if (out_first) out_first[probe] = first;
      hits += hot;
      fetches += WIDE ? 1 : 2;
    }
  }
  if constexpr (TIERED) {
    const unsigned h = __reduce_add_sync(0xffffffffu, hits);
    const unsigned f = __reduce_add_sync(0xffffffffu, fetches);
    if (lane == 0) add_totals(tier, h, f - h);
  }
}

// Kernel 2 over the n keys of grid g (probe_loop): n_live (or n when
// null) keys are live, none when it exceeds n (the dedup path's compact
// probe).  A block reads the live count once.
template <bool WIDE, bool TIERED, bool SHARDED>
__global__ void __launch_bounds__(kProbeThreads) probe_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    Grid4 g, int64_t n, const int32_t* __restrict__ n_live,
    const int4* __restrict__ packed, uint32_t bmask,
    float* __restrict__ out_dist, float* __restrict__ out_time,
    int32_t* __restrict__ out_first, RowSource tier, BucketRange range) {
  __shared__ int64_t block_live;
  if (threadIdx.x == 0) {
    int64_t live = n;
    if (n_live) {
      const int64_t c = *n_live;
      live = c <= n ? c : 0;
    }
    block_live = live;
  }
  __syncthreads();
  probe_loop<WIDE, TIERED, SHARDED>(src, dst, g, block_live, packed, bmask,
                                    out_dist, out_time, out_first, tier,
                                    range);
}

// Launch probe_kernel on its persistent grid: the blocks the SMs hold at
// once (resident_blocks), fewer when the keys need fewer.
template <bool WIDE, bool TIERED, bool SHARDED>
cudaError_t launch_probe(const int32_t* src, const int32_t* dst,
                         const Grid4& g, int64_t n, const int32_t* n_live,
                         const int4* packed, uint32_t bmask, float* out_dist,
                         float* out_time, int32_t* out_first,
                         const RowSource& tier, BucketRange range,
                         cudaStream_t stream) {
  static std::atomic<int> cached[kMaxDevices];
  int resident = 0;
  const cudaError_t e = resident_blocks(probe_kernel<WIDE, TIERED, SHARDED>,
                                        kProbeThreads, cached, &resident);
  if (e != cudaSuccess) return e;
  const int64_t need = (n + kProbeThreads - 1) / kProbeThreads;
  const int64_t blocks = need < resident ? need : resident;
  probe_kernel<WIDE, TIERED, SHARDED><<<(unsigned)blocks, kProbeThreads, 0,
                                        stream>>>(
      src, dst, g, n, n_live, packed, bmask, out_dist, out_time, out_first,
      tier, range);
  return cudaGetLastError();
}

// One probe by one thread: (dist, time) of (s, d), +inf on a miss; `wide`
// selects the table layout (one 32-entry row, or two 16-entry rows).  Rows
// come through the source's tier when it has one; with ``count`` each
// fetch is counted and ``hits`` / ``fetches`` grow.  A row's entries are
// loaded kBatch at a time (1 or 16), every load of a batch before its
// compares, in entry order, so the merge is the same for any kBatch.
template <int kBatch = 1>
__device__ __forceinline__ void probe_serial(const int4* __restrict__ packed,
                                             const RowSource& src,
                                             uint32_t bmask, bool wide,
                                             int32_t s, int32_t d,
                                             float* dist, float* time,
                                             bool count, int* hits,
                                             int* fetches) {
  static_assert(kBatch == 1 || kBatch == 16, "a row holds 16 or 32 entries");
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
    for (int e0 = 0; e0 < entries; e0 += kBatch) {
      int4 v[kBatch];
#pragma unroll
      for (int e = 0; e < kBatch; ++e) v[e] = row[2 * (e0 + e)];
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        if (v[e].x == s && v[e].y == d) {
          const float dd = __int_as_float(v[e].z), tt = __int_as_float(v[e].w);
          bd = dd < bd ? dd : bd;
          bt = tt < bt ? tt : bt;
        }
      }
    }
  }
  *dist = bd;
  *time = bt;
}

}  // namespace rtt
