// In-batch UBODT probe dedup: the claim and scatter kernels around kernel
// 2, and the distinct pair count.
//
// Replaces reporter_tpu/ops/hashtable.py:160 _lookup_dedup (stages
// "dedup-sort", "dedup-compact", "dedup-scatter" and the lax.cond to the
// full-width probe) and :213 count_distinct_pairs.  The reference finds
// the distinct keys of a dispatch by a lexicographic sort, the TPU's way;
// here the keys go into hash sets instead:
//
//   claim    each block takes a contiguous run of 1,024 keys of the
//            [B, T-1, K, K] grid (read through kernel 2's 4-d strides, never
//            materialised), 4 a thread, and first deduplicates them in a
//            hash set in shared memory (a slot that already holds the key
//            takes no atomic).  Neighbouring steps of a trace share most
//            of their (to node, from node) pairs, so a run holds far fewer
//            distinct keys than keys (13.5x fewer in all at 512 x 64, K =
//            8).  Only the block's distinct keys go to the global set
//            (next_pow2(2m) slots of 64-bit keys, cleared before the claim;
//            linear probing by atomicCAS, a slot read first unless the
//            block's keys are mostly new); the block takes its compact
//            range by one atomicAdd on the distinct count, and each
//            global winner below the budget m writes its key to the compact
//            buffers.  Distinct indices and ranks come from a ballot and
//            one shared-memory atomic a warp.  Each key finds its global
//            slot through the block's table.  Once more than m keys are
//            won (blocks whose keys are mostly new add theirs to a second
//            count as each warp wins them) the fallback is certain and
//            insertion stops.
//   probe    kernel 2 over the compact buffers, n_live = the count.
//   scatter  a separate launch, so every claim is visible, on a
//            persistent grid held to kernel 2's occupancy (4 blocks of
//            256 an SM).  Every thread reads the count itself (one word:
//            the branch is the same for the whole grid).  Bounded by
//            memory: each key's slot read and its results written, 12
//            bytes a key (16 with first_edge), the compact side from L2.
//            Within the budget each key copies the result
//            at its slot's compact index: a thread takes 4 consecutive
//            keys a pass (one 16-byte load of their slots, 4 independent
//            reads of the compact indices, 8 or 12 of the results, 16-byte
//            stores), the next pass's slots loaded before this pass's
//            reads, the first pass's before the count test resolves, so
//            neither the count nor the slots are a link in the chain; a
//            tail of n % 4 keys runs one a thread.  A key's chain is one
//            slot read, one index read and one result read.  Past
//            the budget the same launch runs kernel 2's loop over every
//            key (rtt::probe_loop: the reference's full-width fallback,
//            decided on the device with no host readback and no second
//            launch).
//
// The compact order depends on the order in which atomics land; the
// outputs do not: each position's result is the probe of its own key, so
// the outputs are bit-identical to the plain probe's, deduplicated or
// fallen back.  The count mode (m = 0, a validity mask, no budget,
// next_pow2(2n) slots) counts the distinct keys among the valid positions:
// count_distinct_pairs.
//
// The key (-1, -1) equals the empty marker: it has a slot of its own in
// both sets (index kLocal locally, nslots globally).
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
constexpr int kClaimThreads = 256;
constexpr int kPerThread = 4;
constexpr int kRun = kClaimThreads * kPerThread;  // keys a block
constexpr int kLocal = 2 * kRun;                  // the block's set (a power of two)

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ull;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBull;
  x ^= x >> 31;
  return x;
}

// Insert ``key`` into the global set; returns its slot (-1 when the
// fallback became certain first) and sets *won for its first claimant.
// A slot is read before its atomicCAS (a slot that already holds the key
// takes no atomic), except the first when ``cas_first`` (a block whose
// keys are mostly new).  ``won_so_far`` counts from -1.
__device__ __forceinline__ int64_t global_insert(unsigned long long key,
                                                 unsigned long long* keys,
                                                 int64_t nslots, int64_t m,
                                                 const int32_t* won_so_far,
                                                 bool cas_first, bool* won) {
  *won = false;
  if (key == kEmpty) {
    *won = atomicCAS(&keys[nslots], kEmpty, 0ull) == kEmpty;
    return nslots;
  }
  const unsigned long long smask = (unsigned long long)nslots - 1ull;
  unsigned long long h = mix64(key) & smask;
  for (int64_t step = 0; step < nslots; ++step) {
    unsigned long long prev = cas_first && step == 0 ? kEmpty : __ldcg(keys + h);
    if (prev == kEmpty) prev = atomicCAS(&keys[h], kEmpty, key);
    if (prev == kEmpty) {
      *won = true;
      return (int64_t)h;
    }
    if (prev == key) return (int64_t)h;
    if (m > 0 && *(volatile const int32_t*)won_so_far >= m) return -1;  // fallback
    h = (h + 1ull) & smask;
  }
  return -1;
}

// Each winning lane of the warp its index: base (one atomicAdd on *n a
// warp) plus its rank among the warp's winners; -1 for a lane that lost.
__device__ __forceinline__ int warp_index(bool won, int32_t* n) {
  const unsigned ball = __ballot_sync(0xffffffffu, won);
  if (ball == 0u) return -1;
  const int lane = threadIdx.x & 31, leader = __ffs(ball) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(n, __popc(ball));
  base = __shfl_sync(0xffffffffu, base, leader);
  return won ? base + __popc(ball & ((1u << lane) - 1u)) : -1;
}

__global__ void __launch_bounds__(kClaimThreads)
claim_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
             rtt::Grid4 g, const uint8_t* __restrict__ valid, int64_t n,
             unsigned long long* __restrict__ keys, int64_t nslots,
             int32_t* __restrict__ sidx, int32_t* __restrict__ slot_of,
             int32_t* __restrict__ csrc, int32_t* __restrict__ cdst, int64_t m,
             int32_t* count, int32_t* won_so_far) {
  __shared__ unsigned long long lkeys[kLocal];
  __shared__ int16_t lidx[kLocal + 1];  // local slot -> the block's distinct index
  __shared__ int16_t dslot[kRun];       // distinct index -> local slot
  __shared__ int16_t rank[kRun];        // distinct index -> rank among the winners, -1
  __shared__ int32_t gslot[kRun];       // distinct index -> global slot
  __shared__ int32_t n_local, n_won, base, empty_seen, done;
  const int tid = threadIdx.x;
  const int64_t run = (int64_t)blockIdx.x * kRun;
  for (int s = tid; s < kLocal; s += kClaimThreads) lkeys[s] = kEmpty;
  if (tid == 0) {
    n_local = n_won = empty_seen = 0;
    done = m > 0 && *(volatile const int32_t*)won_so_far >= m;
  }
  __syncthreads();
  // the fallback is certain already: nothing of this run is needed (the
  // scatter reads no slot then)
  if (done) return;

  // the block's keys into its set: the first claimant of a local slot
  // gives the key a distinct index
  int ls[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int64_t i = run + r * kClaimThreads + tid;
    const bool live = i < n && (valid == nullptr || valid[i] != 0);
    int32_t s = 0, d = 0;
    if (live) rtt::grid_keys(src, dst, g, i, &s, &d);
    const unsigned long long key = ((unsigned long long)(uint32_t)s << 32) | (uint32_t)d;
    int h = -1;
    bool won = false;
    if (live && key == kEmpty) {
      h = kLocal;
      won = atomicCAS(&empty_seen, 0, 1) == 0;
    } else if (live) {
      h = (int)((unsigned)mix64(key) & (kLocal - 1));
      for (;;) {
        unsigned long long prev = *(volatile unsigned long long*)&lkeys[h];
        if (prev == kEmpty) prev = atomicCAS(&lkeys[h], kEmpty, key);
        won = prev == kEmpty;
        if (won || prev == key) break;
        h = (h + 1) & (kLocal - 1);
      }
    }
    const int li = warp_index(won, &n_local);
    if (won) {
      lidx[h] = (int16_t)li;
      dslot[li] = (int16_t)h;
    }
    ls[r] = h;
  }
  __syncthreads();

  // the block's distinct keys into the global set; none once more than m
  // keys are won (the fallback is certain then)
  const int U = n_local;
  const bool mostly_new = U >= kRun / 4;  // its winners are counted as they come
  for (int l0 = 0; l0 < U; l0 += kClaimThreads) {
    const int li = l0 + tid;
    bool won = false;
    if (li < U) {
      const int h = dslot[li];
      const bool stop = m > 0 && *(volatile const int32_t*)won_so_far >= m;
      gslot[li] = (int32_t)(stop ? -1
                                 : global_insert(h == kLocal ? kEmpty : lkeys[h], keys,
                                                 nslots, m, won_so_far, mostly_new, &won));
    }
    const int rk = warp_index(won, &n_won);
    if (li < U) rank[li] = (int16_t)rk;
    if (m > 0 && mostly_new) {
      const unsigned w = __ballot_sync(0xffffffffu, won);
      if ((tid & 31) == 0 && w) atomicAdd(won_so_far, __popc(w));
    }
  }
  __syncthreads();
  if (tid == 0) base = n_won ? atomicAdd(count, n_won) : 0;  // the block's range
  __syncthreads();
  if (m == 0) return;  // count mode
  for (int li = tid; li < U; li += kClaimThreads) {
    if (rank[li] < 0) continue;
    const int idx = base + rank[li];
    sidx[gslot[li]] = idx;
    if (idx < m) {
      const int h = dslot[li];
      const unsigned long long key = h == kLocal ? kEmpty : lkeys[h];
      csrc[idx] = (int32_t)(key >> 32);
      cdst[idx] = (int32_t)(uint32_t)key;
    }
  }
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int64_t i = run + r * kClaimThreads + tid;
    if (i < n) slot_of[i] = ls[r] < 0 ? -1 : gslot[lidx[ls[r]]];
  }
}

// The slots of keys 4q..4q+3, loaded as one 16-byte read through the
// read-only path, in program order before the count's read (both asm
// volatile, so the compiler keeps them in this order and the slot load is
// in flight while the count test resolves).
__device__ __forceinline__ int4 slots_early(const int32_t* slot_of, int64_t q) {
  int4 v;
  asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(slot_of + 4 * q));
  return v;
}

__device__ __forceinline__ int32_t count_now(const int32_t* count) {
  int32_t c;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(c) : "l"(count));
  return c;
}

// Each key's result from the compact probe through its slot, or, past the
// budget, kernel 2's full-width probe of every key (WIDE, TIERED: the
// table's).  slot_of and the outputs are 16-byte aligned.  Held to 64
// registers, 4 blocks an SM, as kernel 2's untiered probe_kernel is on
// its own: the fallback then probes on kernel 2's grid.
template <bool WIDE, bool TIERED>
__global__ void __launch_bounds__(rtt::kProbeThreads, 4) scatter_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    rtt::Grid4 g, int64_t n, const int32_t* __restrict__ slot_of,
    const int32_t* __restrict__ sidx, const int32_t* count, int64_t m,
    const float* __restrict__ c_dist, const float* __restrict__ c_time,
    const int32_t* __restrict__ c_first, const int4* __restrict__ packed,
    uint32_t bmask, float* __restrict__ out_dist,
    float* __restrict__ out_time, int32_t* __restrict__ out_first,
    rtt::RowSource tier) {
  const int64_t t0 = (int64_t)blockIdx.x * rtt::kProbeThreads + threadIdx.x;
  const int64_t threads = (int64_t)gridDim.x * rtt::kProbeThreads;
  const int64_t nq = n >> 2;  // whole runs of 4 keys
  int4 so = make_int4(0, 0, 0, 0);
  if (t0 < nq) so = slots_early(slot_of, t0);
  if (count_now(count) > m) {  // the same for every thread: the fallback
    rtt::probe_loop<WIDE, TIERED, false>(src, dst, g, n, packed, bmask,
                                         out_dist, out_time, out_first, tier,
                                         rtt::BucketRange{});
    return;
  }
  if (TIERED && t0 == 0) {  // the compact buffer's (0, 0) tail
    const unsigned long long tail = (unsigned long long)(m - *count);
    unsigned long long hits = 0, misses = 0;
    for (int w = 0; w < (WIDE ? 1 : 2) && tail; ++w) {
      const uint32_t h = (w == 0 ? rtt::pair_hash1(0u, 0u)
                                 : rtt::pair_hash2(0u, 0u)) & bmask;
      if (tier.counts) atomicAdd(tier.counts + h, (int32_t)tail);
      (tier.slot_map[h] >= 0 ? hits : misses) += tail;
    }
    rtt::add_totals(tier, hits, misses);
  }
  const int4* slot4 = reinterpret_cast<const int4*>(slot_of);
  for (int64_t q = t0; q < nq; q += threads) {
    const int64_t qn = q + threads;
    const int4 next = qn < nq ? __ldg(slot4 + qn) : so;
    const int32_t i0 = __ldg(sidx + so.x), i1 = __ldg(sidx + so.y);
    const int32_t i2 = __ldg(sidx + so.z), i3 = __ldg(sidx + so.w);
    const float4 d = make_float4(__ldg(c_dist + i0), __ldg(c_dist + i1),
                                 __ldg(c_dist + i2), __ldg(c_dist + i3));
    const float4 t = make_float4(__ldg(c_time + i0), __ldg(c_time + i1),
                                 __ldg(c_time + i2), __ldg(c_time + i3));
    if (out_first)
      reinterpret_cast<int4*>(out_first)[q] =
          make_int4(__ldg(c_first + i0), __ldg(c_first + i1),
                    __ldg(c_first + i2), __ldg(c_first + i3));
    reinterpret_cast<float4*>(out_dist)[q] = d;
    reinterpret_cast<float4*>(out_time)[q] = t;
    so = next;
  }
  const int64_t i = 4 * nq + t0;  // the tail, one key a thread
  if (i < n) {
    const int32_t idx = sidx[slot_of[i]];
    out_dist[i] = c_dist[idx];
    out_time[i] = c_time[idx];
    if (out_first) out_first[i] = c_first[idx];
  }
}

template <bool WIDE, bool TIERED>
cudaError_t launch_scatter(const int32_t* src, const int32_t* dst,
                           const rtt::Grid4& g, int64_t n,
                           const int32_t* slot_of, const int32_t* sidx,
                           const int32_t* count, int64_t m,
                           const float* c_dist, const float* c_time,
                           const int32_t* c_first, const int4* packed,
                           uint32_t bmask, float* out_dist, float* out_time,
                           int32_t* out_first, const rtt::RowSource& tier,
                           cudaStream_t st) {
  static std::atomic<int> cached[rtt::kMaxDevices];
  int resident = 0;
  const cudaError_t e = rtt::resident_blocks(scatter_kernel<WIDE, TIERED>,
                                             rtt::kProbeThreads, cached,
                                             &resident);
  if (e != cudaSuccess) return e;
  // enough blocks for the fallback's one key a thread, at most resident
  const int64_t need = (n + rtt::kProbeThreads - 1) / rtt::kProbeThreads;
  const int64_t blocks = need < resident ? need : resident;
  scatter_kernel<WIDE, TIERED><<<(unsigned)blocks, rtt::kProbeThreads, 0, st>>>(
      src, dst, g, n, slot_of, sidx, count, m, c_dist, c_time, c_first,
      packed, bmask, out_dist, out_time, out_first, tier);
  return cudaGetLastError();
}

}  // namespace

// Clears the set (keys: nslots + 2 int64, nslots a power of two; the last
// holds the keys won so far, from -1) and the count, then claims.  valid:
// uint8 [n] or null.  m > 0: dedup (sidx [nslots + 1], slot_of [n],
// csrc/cdst [m]); m == 0: count mode, the four may be null.
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
  cudaError_t e = cudaMemsetAsync(keys, 0xFF, (size_t)(nslots + 2) * 8, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(count, 0, sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return 0;
  const int64_t blocks = (n + kRun - 1) / kRun;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  claim_kernel<<<(unsigned)blocks, kClaimThreads, 0, st>>>(
      src, dst, g, valid, n, reinterpret_cast<unsigned long long*>(keys), nslots,
      sidx, slot_of, csrc, cdst, m, count, reinterpret_cast<int32_t*>(keys + nslots + 1));
  return (int)cudaGetLastError();
}


// wide: the table's layout (0 cuckoo, 1 wide32), for the fallback probe.
// slot_map (null: untiered), arena, counts and totals: the tier's, as
// kernel 2's tiered instantiations take them (packed the host pages).
// slot_of, out_dist, out_time and out_first (or null) 16-byte aligned.
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
  if (((uintptr_t)slot_of | (uintptr_t)out_dist | (uintptr_t)out_time |
       (uintptr_t)out_first) & 15)
    return (int)cudaErrorInvalidValue;
  const int4* p = reinterpret_cast<const int4*>(packed);
  cudaStream_t st = (cudaStream_t)stream;
  const rtt::RowSource tier = {slot_map, reinterpret_cast<const int4*>(arena),
                               counts,
                               reinterpret_cast<unsigned long long*>(totals)};
  const uint32_t bm = (uint32_t)bmask;
#define RTT_SCATTER(W, T)                                                    \
  launch_scatter<W, T>(src, dst, g, n, slot_of, sidx, count, m, c_dist,      \
                       c_time, c_first, p, bm, out_dist, out_time, out_first, \
                       tier, st)
  const bool tiered = slot_map != nullptr;
  const cudaError_t e = wide ? (tiered ? RTT_SCATTER(true, true)
                                       : RTT_SCATTER(true, false))
                             : (tiered ? RTT_SCATTER(false, true)
                                       : RTT_SCATTER(false, false));
#undef RTT_SCATTER
  return (int)e;
}

extern "C" const char* ubodt_dedup_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
