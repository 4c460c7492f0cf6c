// In-batch UBODT probe dedup: the claim and scatter kernels around kernel
// 2, and the distinct pair count.
//
// Replaces reporter_tpu/ops/hashtable.py:160 _lookup_dedup (stages
// "dedup-sort", "dedup-compact", "dedup-scatter" and the lax.cond to the
// full-width probe) and :213 count_distinct_pairs.  The reference finds
// the distinct keys of a dispatch by a lexicographic sort, the TPU's way;
// here the keys go into a hash set instead:
//
//   claim    one thread per key reads (src, dst) through the same 4-d
//            strides as kernel 2 (the [B, T-1, K, K] grid is never
//            materialised) and inserts the 64-bit key src << 32 | dst
//            into an open-addressing set of next_pow2(2m) slots (linear
//            probing, atomicCAS).  The winner of a slot takes a compact
//            index by a warp-aggregated atomicAdd on the distinct count
//            and, below the budget m, writes its key to the compact
//            buffers.  Every thread records its key's slot.  Once the
//            count is past m the fallback is certain and probing stops.
//   probe    kernel 2 over the compact buffers, n_live = the count.
//   scatter  a separate launch, so every claim is visible: each key copies
//            the result at its slot's compact index.  When the count is
//            past m, kernel 2's grid (rtt::launch_probe), launched right
//            after it, probes every key itself instead (the reference's
//            full-width fallback, decided on the device with no host
//            readback); each of the two exits at once when the other
//            does the work.
//
// The compact order depends on the order in which atomics land; the
// outputs do not: each position's result is the probe of its own key, so
// the outputs are bit-identical to the plain probe's, deduplicated or
// fallen back.  The set (8 bytes a slot, plus a 4-byte compact index) is
// cleared on the stream before each claim; at 512 x 64 points, K = 8, it
// is 2,097,152 slots, 25 MB, inside the 50 MB L2.  The count mode (m = 0,
// a validity mask, no budget, next_pow2(2n) slots) counts the distinct
// keys among the valid positions: count_distinct_pairs.
//
// The key (-1, -1) equals the empty marker: it has a slot of its own at
// index nslots.
//
// On a tiered table (a RowSource with a slot map) the fallback reads its
// rows through the tier (rtt::bucket_row) and counts them, and, when the
// dedup ran, one thread counts what the reference's deduplicated probe
// also fetches: its compact buffer of m slots holds the n_unique distinct
// keys and m - n_unique copies of the key (0, 0), all probed
// (reporter_tpu/ops/hashtable.py:183-196), while kernel 2 here probes the
// n_unique distinct keys only.

#include "ubodt.cuh"

namespace {

constexpr unsigned long long kEmpty = ~0ull;

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ull;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBull;
  x ^= x >> 31;
  return x;
}

__global__ void claim_kernel(const int32_t* __restrict__ src,
                             const int32_t* __restrict__ dst, rtt::Grid4 g,
                             const uint8_t* __restrict__ valid, int64_t n,
                             unsigned long long* __restrict__ keys,
                             int64_t nslots, int32_t* __restrict__ sidx,
                             int32_t* __restrict__ slot_of,
                             int32_t* __restrict__ csrc,
                             int32_t* __restrict__ cdst, int64_t m,
                             int32_t* count) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  bool won = false;
  int64_t slot = -1;
  int32_t s = 0, d = 0;
  if (i < n && (valid == nullptr || valid[i] != 0)) {
    rtt::grid_keys(src, dst, g, i, &s, &d);
    const unsigned long long key =
        ((unsigned long long)(uint32_t)s << 32) | (uint32_t)d;
    if (key == kEmpty) {
      slot = nslots;
      won = atomicCAS(&keys[nslots], kEmpty, 0ull) == kEmpty;
    } else {
      const unsigned long long smask = (unsigned long long)nslots - 1ull;
      unsigned long long h = mix64(key) & smask;
      for (int64_t step = 0; step < nslots; ++step) {
        const unsigned long long prev = atomicCAS(&keys[h], kEmpty, key);
        if (prev == kEmpty || prev == key) {
          won = prev == kEmpty;
          slot = (int64_t)h;
          break;
        }
        if (m > 0 && *(volatile int32_t*)count > m) break;  // fallback
        h = (h + 1ull) & smask;
      }
    }
  }
  // the warp's winners take consecutive compact indices
  const unsigned ball = __ballot_sync(0xffffffffu, won);
  if (ball != 0u) {
    const int leader = __ffs(ball) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(count, __popc(ball));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (won && m > 0) {
      const int idx = base + __popc(ball & ((1u << lane) - 1u));
      sidx[slot] = idx;
      if (idx < m) {
        csrc[idx] = s;
        cdst[idx] = d;
      }
    }
  }
  if (slot_of != nullptr && i < n) slot_of[i] = (int32_t)slot;
}

__global__ void scatter_kernel(const int64_t n,
                               const int32_t* __restrict__ slot_of,
                               const int32_t* __restrict__ sidx,
                               const int32_t* __restrict__ count, int64_t m,
                               const float* __restrict__ c_dist,
                               const float* __restrict__ c_time,
                               const int32_t* __restrict__ c_first, bool wide,
                               uint32_t bmask, float* __restrict__ out_dist,
                               float* __restrict__ out_time,
                               int32_t* __restrict__ out_first,
                               rtt::RowSource tier) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (*count > m) return;  // uniform over the grid: the fallback probes
  if (tier.slot_map != nullptr && i == 0) {  // the compact buffer's (0, 0) tail
    const unsigned long long tail = (unsigned long long)(m - *count);
    unsigned long long hits = 0, misses = 0;
    for (int w = 0; w < (wide ? 1 : 2) && tail; ++w) {
      const uint32_t h = (w == 0 ? rtt::pair_hash1(0u, 0u)
                                 : rtt::pair_hash2(0u, 0u)) & bmask;
      if (tier.counts) atomicAdd(tier.counts + h, (int32_t)tail);
      (tier.slot_map[h] >= 0 ? hits : misses) += tail;
    }
    rtt::add_totals(tier, hits, misses);
  }
  if (i >= n) return;
  const int32_t idx = sidx[slot_of[i]];
  out_dist[i] = c_dist[idx];
  out_time[i] = c_time[idx];
  if (out_first) out_first[i] = c_first[idx];
}

constexpr int kThreads = 256;

inline int64_t blocks_for(int64_t n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Clears the set (keys: nslots + 1 int64, nslots a power of two) and the
// count, then claims.  valid: uint8 [n] or null.  m > 0: dedup (sidx
// [nslots + 1], slot_of [n], csrc/cdst [m]); m == 0: count mode, the
// four may be null.
extern "C" int ubodt_dedup_claim_launch(
    const int32_t* src, const int32_t* dst, const int64_t* dims,
    const int64_t* src_strides, const int64_t* dst_strides,
    const uint8_t* valid, int64_t* keys, int64_t nslots, int32_t* sidx,
    int32_t* slot_of, int32_t* csrc, int32_t* cdst, int64_t m,
    int32_t* count, void* stream) {
  rtt::Grid4 g;
  const int64_t n = rtt::make_grid(dims, src_strides, dst_strides, &g);
  cudaStream_t st = (cudaStream_t)stream;
  if (nslots <= 0 || (nslots & (nslots - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(keys, 0xFF, (size_t)(nslots + 1) * 8, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(count, 0, sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return 0;
  if (blocks_for(n) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  claim_kernel<<<(unsigned)blocks_for(n), kThreads, 0, st>>>(
      src, dst, g, valid, n, reinterpret_cast<unsigned long long*>(keys),
      nslots, sidx, slot_of, csrc, cdst, m, count);
  return (int)cudaGetLastError();
}


// wide: the table's layout (0 cuckoo, 1 wide32), for the fallback probe.
// slot_map (null: untiered), arena, counts and totals: the tier's, as
// kernel 2's tiered instantiations take them (packed the host pages).
extern "C" int ubodt_dedup_scatter_launch(
    const int32_t* src, const int32_t* dst, const int64_t* dims,
    const int64_t* src_strides, const int64_t* dst_strides,
    const int32_t* slot_of, const int32_t* sidx, const int32_t* count,
    int64_t m, const float* c_dist, const float* c_time,
    const int32_t* c_first, const int32_t* packed, int32_t bmask,
    int32_t wide, float* out_dist, float* out_time, int32_t* out_first,
    const int32_t* slot_map, const int32_t* arena, int32_t* counts,
    int64_t* totals, void* stream) {
  rtt::Grid4 g;
  const int64_t n = rtt::make_grid(dims, src_strides, dst_strides, &g);
  if (n <= 0) return 0;
  if (blocks_for(n) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int4* p = reinterpret_cast<const int4*>(packed);
  cudaStream_t st = (cudaStream_t)stream;
  const rtt::RowSource tier = {slot_map, reinterpret_cast<const int4*>(arena),
                               counts,
                               reinterpret_cast<unsigned long long*>(totals)};
  const uint32_t bm = (uint32_t)bmask;
  scatter_kernel<<<(unsigned)blocks_for(n), kThreads, 0, st>>>(
      n, slot_of, sidx, count, m, c_dist, c_time, c_first, wide != 0, bm,
      out_dist, out_time, out_first, tier);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // past the budget: kernel 2 over every key (a grid that exits at once
  // when the dedup ran)
  const bool tiered = slot_map != nullptr;
  const rtt::BucketRange all{};
  if (wide)
    e = tiered ? rtt::launch_probe<true, true, false>(
                     src, dst, g, n, count, m, p, bm, out_dist, out_time,
                     out_first, tier, all, st)
               : rtt::launch_probe<true, false, false>(
                     src, dst, g, n, count, m, p, bm, out_dist, out_time,
                     out_first, tier, all, st);
  else
    e = tiered ? rtt::launch_probe<false, true, false>(
                     src, dst, g, n, count, m, p, bm, out_dist, out_time,
                     out_first, tier, all, st)
               : rtt::launch_probe<false, false, false>(
                     src, dst, g, n, count, m, p, bm, out_dist, out_time,
                     out_first, tier, all, st);
  return (int)e;
}

extern "C" const char* ubodt_dedup_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
