// UBODT probe and select (kernel 2 of the match program), both table
// layouts.
//
// Replaces reporter_tpu/ops/hashtable.py:138 _lookup_plain with :63
// device_pair_hash, :75 device_pair_hash2, :122 _bucket_rows and :96
// _select, stages "ubodt-probe" and "select": the cuckoo layout (two
// 512-byte rows per probe, `ubodt_probe_launch`) and the wide32 layout
// (one 1 KB row, `ubodt_probe_wide32_launch`, counted apart as
// ubodt_probe[wide32]).
//
// Work per probe: one or two uint32 hash mixes, 1 KB of random bucket
// rows of a table far larger than L2 (the metro table is ~0.5 GB cuckoo,
// ~1.1 GB wide32), and a 32-entry key compare.  On the H100 it is bounded
// by memory: the rows each probe must read (the probes of one batch share
// many rows, so the least traffic is the distinct rows touched, once
// each).
//
// Design (rtt::warp_probe): a warp takes 32 probes at a time.  Lane l
// alone decodes its key from the 4-d grid (32-bit fast divmod), loads the
// two node ids, hashes and finds its rows; the warp then reads the 32
// probes' rows in turn, 8 rows in flight (4 for wide32's 1 KB rows), each
// one coalesced read of 16 bytes a lane, and finds the hit by a ballot
// over the entries' keys.  A cuckoo key found in its first row does not
// read its second.  The grid is persistent: SMs x resident blocks
// (the occupancy query, once per device), each warp striding over the
// probes up to the live count, which a block reads once, so the dedup
// path's compact probe costs its live keys, not its budget.  Keys are
// read through strides, so the [B, T-1, K, K] key grid of the main path is
// a broadcast of two [B, T, K] arrays and is never materialised; the
// outputs are written 32 consecutive probes a warp.  out_first may be
// null (the match path reads only dist and time): it is then not written.
// n_live (the dedup path's device-side distinct count) may limit the
// probes to the first n_live keys; when it exceeds the key count no probe
// runs (the dedup scatter then probes every key itself).
//
// The TIERED instantiations (ubodt_probe_tiered_launch and
// ubodt_probe_wide32_tiered_launch, counted apart as ubodt_probe[tiered]
// and ubodt_probe[wide32,tiered]) replace reporter_tpu/tiles/tiering.py:538
// tiered_bucket_rows: packed is then the full table in pinned host memory,
// and each row comes from the hot arena when slot_map names one (an
// L2-resident 4 MB map for the metro table).  Read in place, a cold row
// crossed the host link once for every warp that visited it (the metro
// table's 512 x 64 cohort reads 3,085,806 cold rows, 162,114 of them
// distinct), so a dispatch's distinct cold rows are staged first, as the
// reference's page gather (tiering.py:586-591) fetches a dispatch's rows
// in bulk:
//   1. ubodt_cold_mark: a thread four keys a pass decodes and hashes them
//      and claims each key's first-hash row, when cold, in the rank's
//      stage map (one compare-and-swap wins a row; the winners of a warp
//      take their slots with one atomic; rtt::stage_claim);
//   2. ubodt_cold_gather: a persistent grid, one block an SM, copies the
//      claimed rows from the pages into the staging buffer on the card, a
//      warp 8 rows at a time (4 for wide32), 16 bytes a lane, every load
//      before its stores, so that many rows are in flight on every SM;
//   3. the probe: warp_probe reads arena and staged rows.  A cuckoo key
//      its first row does not hold needs its second row: a hot or already
//      staged one is read at once; a cold one is claimed, the warp that
//      wins it copies it into its slot and only then publishes the slot,
//      and a warp that meets a claim still pending waits for that
//      publication (rtt::stage_second).  A second row the probe skips
//      (its first row holds the key) never crosses the link: staging both
//      rows of every cold key would copy 1.6x the rows read.
// The link then carries each distinct cold row once a dispatch (the bound:
// the distinct cold rows over the link's peak, the hot side over HBM's).
// Rows past the staging capacity (a rank's cap rows, tiles/tiering.py
// STAGE_BYTES) are read in place and counted.  Every launch goes to the
// caller's stream, none waits for the host: the dispatch's counts stay on
// the card, stamped with its gen (rtt::stamped_add), so nothing clears
// them.  The gather is launched as the mark's programmatic dependent and
// the probe as the gather's (rtt::launch_dependent), so each launches
// while the one before it runs and waits for its results before reading
// them.  The lane that owns a probe counts its fetches per bucket, both
// home rows as the reference reads them; each warp totals its hits and
// misses once, at the end, in one atomic each.
//
// The SHARDED instantiations (ubodt_probe_sharded_launch and
// ubodt_probe_wide32_sharded_launch, counted apart as ubodt_probe[sharded]
// and ubodt_probe[wide32,sharded]) replace
// reporter_tpu/ops/hashtable.py:249 _ubodt_lookup_sharded with its local
// _bucket_rows and _select: one gp rank's probe of its bucket range
// [lo, lo + L), packed holding only those L rows.  A bucket outside the
// range reads as a row of -2 lanes, as the reference masks it, so a key
// that lives on another rank gives (inf, inf, -1) here, and the ranks'
// answers merge exactly by min dist, min time, max first edge (the
// wrapper's pmin / pmax over the gp axis).  Bounded by memory: a rank
// reads only its in-range rows (about 1/gp of the distinct rows), plus
// the keys and its outputs.  Same design as kernel 2: the owning lane
// tests the range, and the warp visits only the in-range rows.
//
// The TIERED and SHARDED instantiations
// (ubodt_probe_tiered_sharded_launch and
// ubodt_probe_wide32_tiered_sharded_launch, counted apart as
// ubodt_probe[tiered,sharded] and ubodt_probe[wide32,tiered,sharded])
// replace tiered_bucket_rows under the reference's gp mesh
// (reporter_tpu/tiles/tiering.py:201-286, :538): one gp rank of a tiered
// table probes its range [lo, lo + L) through its own slot map [L] (local
// arena slots), hot arena, counts [L] and staging (its own stage map [L]
// and buffer), staging the cold rows of its range from the one
// page-locked table, at the offset lo into it; a bucket outside the range
// is neither staged nor read and answers a miss, as [sharded] does, and
// the pmin / pmax merge gives the untiered table's answer.  The rank
// counts only its in-range fetches, so the ranks' counts and totals sum
// to the untiered tier's.
//
// ubodt_host_register pins a host buffer and maps it into the card's
// address space (cudaHostRegister + cudaHostGetDevicePointer): the tiered
// table's pages, once for every rank.

#include "ubodt.cuh"

namespace {

using rtt::kProbeThreads;

// The mark pass: each live key's first-hash row, when it lies in the
// range [lo, lo + L) and is cold, claimed in the stage map.  A warp takes
// kMarkKeys x 32 consecutive keys a pass, every key's loads issued before
// its hash is needed, so that a thread waits on its loads once a pass,
// not once a key.  A key's lane wins its row's entry by compare-and-swap
// (rtt::stage_claim's rule); the block's winners of a pass take their
// slots with one atomic on the claims count, not one a warp, and publish
// them at once (the gather copies the rows).  It lets its dependent (the
// gather) launch at once.
constexpr int kMarkKeys = 4;
constexpr int kWarps = kProbeThreads / 32;

__global__ void __launch_bounds__(kProbeThreads) mark_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    rtt::Grid4 g, int64_t n, const int32_t* __restrict__ n_live,
    uint32_t bmask, const int32_t* __restrict__ slot_map, rtt::Stage st,
    rtt::BucketRange range) {
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ int64_t block_live;
  __shared__ uint32_t warp_wins[kWarps], warp_base[kWarps];
  asm volatile("griddepcontrol.launch_dependents;");
  if (threadIdx.x == 0) {
    int64_t live = n;
    if (n_live) {
      const int64_t c = *n_live;
      live = c <= n ? c : 0;
    }
    block_live = live;
  }
  __syncthreads();
  const int64_t live = block_live;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const unsigned long long pend = ((unsigned long long)st.gen << 32) | rtt::kStagePending;
  const int64_t stride = (int64_t)gridDim.x * kProbeThreads * kMarkKeys;
  // the loop bound is uniform across the block: every thread runs every pass
  for (int64_t block_base = (int64_t)blockIdx.x * kProbeThreads * kMarkKeys;
       block_base < live; block_base += stride) {
    const int64_t base = block_base + (int64_t)warp * 32 * kMarkKeys;
    int32_t s[kMarkKeys], d[kMarkKeys];
    uint32_t b[kMarkKeys];
    bool won[kMarkKeys];
#pragma unroll
    for (int j = 0; j < kMarkKeys; ++j) {
      const int64_t probe = base + j * 32 + lane;
      s[j] = d[j] = 0;
      if (probe < live) rtt::grid_keys(src, dst, g, probe, &s[j], &d[j]);
    }
#pragma unroll
    for (int j = 0; j < kMarkKeys; ++j) {
      b[j] = (rtt::pair_hash1((uint32_t)s[j], (uint32_t)d[j]) & bmask) - range.lo;
      won[j] = base + j * 32 + lane < live && b[j] < range.n;
    }
#pragma unroll
    for (int j = 0; j < kMarkKeys; ++j) won[j] = won[j] && slot_map[b[j]] < 0;
    unsigned wins[kMarkKeys];
    uint32_t count = 0;
#pragma unroll
    for (int j = 0; j < kMarkKeys; ++j) {
      if (won[j]) {
        unsigned long long* e = st.map + b[j];
        const unsigned long long old = __ldcg(e);
        won[j] = (uint32_t)(old >> 32) != st.gen && atomicCAS(e, old, pend) == old;
      }
      wins[j] = __ballot_sync(kAll, won[j]);
      count += __popc(wins[j]);
    }
    if (lane == 0) warp_wins[warp] = count;
    if (!__syncthreads_or(count != 0)) continue;  // no claim in the block
    if (threadIdx.x == 0) {
      uint32_t total = 0;
      for (int w = 0; w < kWarps; ++w) total += warp_wins[w];
      uint32_t at = rtt::stamped_add(st.state, st.gen, total);
      for (int w = 0; w < kWarps; ++w) {
        warp_base[w] = at;
        at += warp_wins[w];
      }
    }
    __syncthreads();
    uint32_t slot = warp_base[warp];
    unsigned over = 0;
#pragma unroll
    for (int j = 0; j < kMarkKeys; ++j) {
      if (won[j]) {
        const uint32_t mine = slot + __popc(wins[j] & below);
        const uint32_t got = mine < (uint32_t)st.cap ? mine : rtt::kStageOver;
        if (got != rtt::kStageOver) st.list[mine] = (int32_t)b[j];
        atomicExch(st.map + b[j], ((unsigned long long)st.gen << 32) | got);
        over += got == rtt::kStageOver;
      }
      slot += __popc(wins[j]);
    }
    over = __reduce_add_sync(kAll, over);
    if (lane == 0 && over) atomicAdd(st.stats + 1, (unsigned long long)over);
  }
}

// The gather: the slots the mark claimed, [0, end) with end = min(claimed,
// cap), copied from the pages to the staged rows; it records end as the
// ready count the probe reads.  A warp copies kBatch rows at a time, every
// load before its stores, 16 bytes a lane; the grid is persistent.
// Launched as the mark's programmatic dependent, it lets the probe launch
// at once, then waits for the claims.
template <bool WIDE>
__global__ void __launch_bounds__(kProbeThreads) gather_kernel(
    const int4* __restrict__ pages, rtt::Stage st) {
  constexpr int kHalves = WIDE ? 2 : 1;
  constexpr int kRowInt4 = 32 * kHalves;
  constexpr int kBatch = WIDE ? 4 : 8;
  asm volatile("griddepcontrol.launch_dependents;");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const uint32_t claimed = rtt::stamped(st.state, st.gen);
  const int64_t end = claimed < (uint32_t)st.cap ? claimed : st.cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    st.state[1] = ((unsigned long long)st.gen << 32) | (uint64_t)end;
    if (end > 0) atomicAdd(st.stats, (unsigned long long)end);
  }
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * kProbeThreads + threadIdx.x) >> 5;
  const int64_t warps = ((int64_t)gridDim.x * kProbeThreads) >> 5;
  for (int64_t r0 = warp * kBatch; r0 < end; r0 += warps * kBatch) {
    int4 v[kBatch][kHalves];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (r0 + k < end) {
        const int4* row = pages + (int64_t)st.list[r0 + k] * kRowInt4;
#pragma unroll
        for (int q = 0; q < kHalves; ++q) v[k][q] = row[q * 32 + lane];
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (r0 + k < end) {
        int4* out = st.rows + (r0 + k) * kRowInt4;
#pragma unroll
        for (int q = 0; q < kHalves; ++q) out[q * 32 + lane] = v[k][q];
      }
    }
  }
}

// The gather's grid: one block an SM, its 8 warps 8 rows (4 wide32) in
// flight each, 4 MB over the card, far more than the host link's rate
// times its latency needs; an empty gather (every row hot) then costs
// the launch of few blocks.
cudaError_t gather_blocks(unsigned* blocks) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = (unsigned)(sms > 0 ? sms : 1);
  return e;
}

// A dispatch's stage from the C arguments.
rtt::Stage stage_of(int64_t* map, int32_t* rows, int32_t* list, int64_t* state,
                    int64_t* stats, int64_t gen, int32_t cap) {
  return {reinterpret_cast<unsigned long long*>(map), reinterpret_cast<int4*>(rows),
          list, reinterpret_cast<unsigned long long*>(state),
          reinterpret_cast<unsigned long long*>(stats), (uint32_t)gen, cap};
}

template <bool WIDE, bool TIERED, bool SHARDED = false>
int launch(const int32_t* src, const int32_t* dst, const int64_t* dims,
           const int64_t* src_strides, const int64_t* dst_strides,
           const int32_t* packed, int32_t bmask, const int32_t* n_live,
           float* out_dist, float* out_time, int32_t* out_first,
           rtt::RowSource tier, void* stream,
           rtt::BucketRange range = rtt::BucketRange{},
           const rtt::Stage& st = rtt::Stage{}) {
  rtt::Grid4 g;
  const int64_t n = rtt::make_grid(dims, src_strides, dst_strides, &g);
  if (n <= 0) return 0;
  if (TIERED && (tier.slot_map == nullptr || st.map == nullptr || st.rows == nullptr ||
                 st.list == nullptr || st.state == nullptr || st.stats == nullptr ||
                 st.cap < 0))
    return (int)cudaErrorInvalidValue;
  if (SHARDED && (range.n == 0 || (uint64_t)range.lo + range.n >
                                      (uint64_t)(uint32_t)bmask + 1))
    return (int)cudaErrorInvalidValue;
  return (int)rtt::launch_probe<WIDE, TIERED, SHARDED, TIERED>(
      src, dst, g, n, n_live, reinterpret_cast<const int4*>(packed),
      (uint32_t)bmask, out_dist, out_time, out_first, tier, range,
      (cudaStream_t)stream, st);
}

inline rtt::RowSource row_source(const int32_t* slot_map, const int32_t* arena,
                                 int32_t* counts, int64_t* totals) {
  return {slot_map, reinterpret_cast<const int4*>(arena), counts,
          reinterpret_cast<unsigned long long*>(totals)};
}

}  // namespace

// dims: host int64 [12], the 4 dims then their fast-divmod multipliers
// and shifts (rtt::Grid4); src_strides / dst_strides: host int64 [4]
// (elements; 0 strides broadcast).  packed: [bmask + 1, 128] int32,
// 16-byte aligned.  n_live: device int32 or null.
extern "C" int ubodt_probe_launch(const int32_t* src, const int32_t* dst,
                                  const int64_t* dims,
                                  const int64_t* src_strides,
                                  const int64_t* dst_strides,
                                  const int32_t* packed, int32_t bmask,
                                  const int32_t* n_live, float* out_dist,
                                  float* out_time, int32_t* out_first,
                                  void* stream) {
  return launch<false, false>(src, dst, dims, src_strides, dst_strides,
                              packed, bmask, n_live, out_dist, out_time,
                              out_first, rtt::RowSource{}, stream);
}

// The same for a wide32 table: packed [bmask + 1, 256] int32.
extern "C" int ubodt_probe_wide32_launch(const int32_t* src,
                                         const int32_t* dst,
                                         const int64_t* dims,
                                         const int64_t* src_strides,
                                         const int64_t* dst_strides,
                                         const int32_t* packed, int32_t bmask,
                                         const int32_t* n_live,
                                         float* out_dist, float* out_time,
                                         int32_t* out_first, void* stream) {
  return launch<true, false>(src, dst, dims, src_strides, dst_strides,
                             packed, bmask, n_live, out_dist, out_time,
                             out_first, rtt::RowSource{}, stream);
}

// The tiered instantiations: kernel 2's arguments with packed the pinned
// host pages (a device-mapped address), then slot_map [n_buckets] int32,
// arena [rows, 128 or 256] int32, counts [n_buckets] int32 (or null) and
// totals [2] int64 (or null), then the staging (STAGE_PARAMS): stage_map
// [n_buckets] int64, staged rows [cap, 128 or 256] int32, list [cap]
// int32, state [2] int64, stats [2] int64, the dispatch's gen and cap.
#define STAGE_PARAMS                                                       \
  int64_t *stage_map, int32_t *stage_rows, int32_t *stage_list,             \
      int64_t *stage_state, int64_t *stage_stats, int64_t gen, int32_t cap
#define STAGE_OF \
  stage_of(stage_map, stage_rows, stage_list, stage_state, stage_stats, gen, cap)

extern "C" int ubodt_probe_tiered_launch(
    const int32_t* src, const int32_t* dst, const int64_t* dims,
    const int64_t* src_strides, const int64_t* dst_strides,
    const int32_t* packed, int32_t bmask, const int32_t* n_live,
    float* out_dist, float* out_time, int32_t* out_first,
    const int32_t* slot_map, const int32_t* arena, int32_t* counts,
    int64_t* totals, STAGE_PARAMS, void* stream) {
  return launch<false, true>(src, dst, dims, src_strides, dst_strides, packed,
                             bmask, n_live, out_dist, out_time, out_first,
                             row_source(slot_map, arena, counts, totals),
                             stream, rtt::BucketRange{0u, (uint32_t)bmask + 1u},
                             STAGE_OF);
}

extern "C" int ubodt_probe_wide32_tiered_launch(
    const int32_t* src, const int32_t* dst, const int64_t* dims,
    const int64_t* src_strides, const int64_t* dst_strides,
    const int32_t* packed, int32_t bmask, const int32_t* n_live,
    float* out_dist, float* out_time, int32_t* out_first,
    const int32_t* slot_map, const int32_t* arena, int32_t* counts,
    int64_t* totals, STAGE_PARAMS, void* stream) {
  return launch<true, true>(src, dst, dims, src_strides, dst_strides, packed,
                            bmask, n_live, out_dist, out_time, out_first,
                            row_source(slot_map, arena, counts, totals),
                            stream, rtt::BucketRange{0u, (uint32_t)bmask + 1u},
                            STAGE_OF);
}

// The sharded instantiations: kernel 2's arguments with packed the rank's
// [L, 128 or 256] rows, then its range's first bucket lo and length L.
extern "C" int ubodt_probe_sharded_launch(
    const int32_t* src, const int32_t* dst, const int64_t* dims,
    const int64_t* src_strides, const int64_t* dst_strides,
    const int32_t* packed, int32_t bmask, const int32_t* n_live,
    float* out_dist, float* out_time, int32_t* out_first, int32_t lo,
    int32_t L, void* stream) {
  return launch<false, false, true>(
      src, dst, dims, src_strides, dst_strides, packed, bmask, n_live,
      out_dist, out_time, out_first, rtt::RowSource{}, stream,
      rtt::BucketRange{(uint32_t)lo, (uint32_t)L});
}

extern "C" int ubodt_probe_wide32_sharded_launch(
    const int32_t* src, const int32_t* dst, const int64_t* dims,
    const int64_t* src_strides, const int64_t* dst_strides,
    const int32_t* packed, int32_t bmask, const int32_t* n_live,
    float* out_dist, float* out_time, int32_t* out_first, int32_t lo,
    int32_t L, void* stream) {
  return launch<true, false, true>(
      src, dst, dims, src_strides, dst_strides, packed, bmask, n_live,
      out_dist, out_time, out_first, rtt::RowSource{}, stream,
      rtt::BucketRange{(uint32_t)lo, (uint32_t)L});
}

// The tiered and sharded instantiations: the tiered arguments with packed
// the rank's first page (the pages' device address plus lo rows), slot_map,
// counts and stage_map [L], arena and the staged rows the rank's, totals
// and stats the rank's [2]; lo and L before the staging.
extern "C" int ubodt_probe_tiered_sharded_launch(
    const int32_t* src, const int32_t* dst, const int64_t* dims,
    const int64_t* src_strides, const int64_t* dst_strides,
    const int32_t* packed, int32_t bmask, const int32_t* n_live,
    float* out_dist, float* out_time, int32_t* out_first,
    const int32_t* slot_map, const int32_t* arena, int32_t* counts,
    int64_t* totals, int32_t lo, int32_t L, STAGE_PARAMS, void* stream) {
  return launch<false, true, true>(
      src, dst, dims, src_strides, dst_strides, packed, bmask, n_live,
      out_dist, out_time, out_first,
      row_source(slot_map, arena, counts, totals), stream,
      rtt::BucketRange{(uint32_t)lo, (uint32_t)L}, STAGE_OF);
}

extern "C" int ubodt_probe_wide32_tiered_sharded_launch(
    const int32_t* src, const int32_t* dst, const int64_t* dims,
    const int64_t* src_strides, const int64_t* dst_strides,
    const int32_t* packed, int32_t bmask, const int32_t* n_live,
    float* out_dist, float* out_time, int32_t* out_first,
    const int32_t* slot_map, const int32_t* arena, int32_t* counts,
    int64_t* totals, int32_t lo, int32_t L, STAGE_PARAMS, void* stream) {
  return launch<true, true, true>(
      src, dst, dims, src_strides, dst_strides, packed, bmask, n_live,
      out_dist, out_time, out_first,
      row_source(slot_map, arena, counts, totals), stream,
      rtt::BucketRange{(uint32_t)lo, (uint32_t)L}, STAGE_OF);
}

// The mark pass of a tiered probe over kernel 2's keys (grid, n_live) of
// the range [lo, lo + L) (lo 0 and L the bucket count on one rank):
// slot_map [L], then the staging as the probe takes it.
extern "C" int ubodt_cold_mark_launch(
    const int32_t* src, const int32_t* dst, const int64_t* dims,
    const int64_t* src_strides, const int64_t* dst_strides, int32_t bmask,
    const int32_t* n_live, const int32_t* slot_map, int64_t* stage_map,
    int32_t* stage_list, int64_t* stage_state, int64_t* stage_stats, int64_t gen,
    int32_t cap, int32_t lo, int32_t L, void* stream) {
  rtt::Grid4 g;
  const int64_t n = rtt::make_grid(dims, src_strides, dst_strides, &g);
  if (slot_map == nullptr || stage_map == nullptr || stage_list == nullptr ||
      stage_state == nullptr || cap < 0 || (uint32_t)L == 0 ||
      (uint64_t)(uint32_t)lo + (uint32_t)L > (uint64_t)(uint32_t)bmask + 1)
    return (int)cudaErrorInvalidValue;
  const rtt::Stage st = stage_of(stage_map, nullptr, stage_list, stage_state,
                                 stage_stats, gen, cap);
  static std::atomic<int> cached[rtt::kMaxDevices];
  int resident = 0;
  const cudaError_t e = rtt::resident_blocks(mark_kernel, kProbeThreads, cached, &resident);
  if (e != cudaSuccess) return (int)e;
  const int64_t need = (n + kProbeThreads * kMarkKeys - 1) / (kProbeThreads * kMarkKeys);
  const unsigned blocks = (unsigned)(need < 1 ? 1 : need < resident ? need : resident);
  mark_kernel<<<blocks, kProbeThreads, 0, (cudaStream_t)stream>>>(
      src, dst, g, n > 0 ? n : 0, n_live, (uint32_t)bmask, slot_map, st,
      rtt::BucketRange{(uint32_t)lo, (uint32_t)L});
  return (int)cudaGetLastError();
}

// The gather: pages (the rank's first page), wide (the layout's row: 0
// cuckoo, 1 wide32), then the staging as the probe takes it.
extern "C" int ubodt_cold_gather_launch(const int32_t* pages, int32_t wide,
                                        int32_t* stage_rows, int32_t* stage_list,
                                        int64_t* stage_state, int64_t* stage_stats,
                                        int64_t gen, int32_t cap, void* stream) {
  if (pages == nullptr || stage_rows == nullptr || stage_list == nullptr ||
      stage_state == nullptr || stage_stats == nullptr || cap < 0)
    return (int)cudaErrorInvalidValue;
  const rtt::Stage st = stage_of(nullptr, stage_rows, stage_list, stage_state,
                                 stage_stats, gen, cap);
  const int4* p = reinterpret_cast<const int4*>(pages);
  unsigned blocks = 0;
  cudaError_t e = gather_blocks(&blocks);
  if (e == cudaSuccess)
    e = wide ? rtt::launch_dependent(gather_kernel<true>, blocks, (cudaStream_t)stream, p, st)
             : rtt::launch_dependent(gather_kernel<false>, blocks, (cudaStream_t)stream, p, st);
  return (int)e;
}

// Page-lock ``bytes`` of host memory at ``host`` and map it into the
// card's address space; *dev_ptr receives the address kernels read it by.
extern "C" int ubodt_host_register(void* host, size_t bytes, void** dev_ptr) {
  cudaError_t e = cudaHostRegister(host, bytes, cudaHostRegisterMapped);
  if (e != cudaSuccess) return (int)e;
  e = cudaHostGetDevicePointer(dev_ptr, host, 0);
  if (e != cudaSuccess) cudaHostUnregister(host);
  return (int)e;
}

extern "C" int ubodt_host_unregister(void* host) {
  return (int)cudaHostUnregister(host);
}

// The memory type CUDA reports for an address (cudaMemoryType: 1 host,
// i.e. page-locked, 2 device, 0 unregistered), or -1 on an error.
extern "C" int ubodt_memory_type(const void* ptr) {
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, ptr) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return (int)attr.type;
}

extern "C" const char* ubodt_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
