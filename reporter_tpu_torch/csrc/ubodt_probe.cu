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
// Design: one warp per probe (rtt::warp_probe): lane l loads 16 bytes of
// each 512-byte half row, so each half is one coalesced transaction; a
// warp reduction merges (min dist, min time, max first_edge), exactly the
// reference's min/max merge.  Keys are read through strides, so the
// [B, T-1, K, K] key grid of the main path is a broadcast of two [B, T, K]
// arrays and is never materialised.  out_first may be null (the match
// path reads only dist and time): it is then not written.  n_live (the
// dedup path's device-side distinct count) may limit the probes to the
// first n_live keys; when it exceeds the key count no probe runs (the
// dedup scatter then probes every key itself).
//
// The TIERED instantiations (ubodt_probe_tiered_launch and
// ubodt_probe_wide32_tiered_launch, counted apart as ubodt_probe[tiered]
// and ubodt_probe[wide32,tiered]) replace reporter_tpu/tiles/tiering.py:538
// tiered_bucket_rows: packed is then the full table in pinned host memory,
// each row comes from the hot arena when slot_map names one (an L2-resident
// 4 MB map for the metro table) and is read in place over the host link
// when not (rtt::bucket_row).  A cold row costs a PCIe round trip, so a
// cold probe is bounded by the host link's rate, not HBM's.  Lane 0 of each
// probe's warp counts its fetches per bucket; the block totals its hits
// and misses (__syncthreads_count) before one atomic each.  The untiered
// instantiations are the code above, unchanged.
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
// the keys and its outputs.  Same design as kernel 2; the untiered code
// path is unchanged.
//
// ubodt_host_register pins a host buffer and maps it into the card's
// address space (cudaHostRegister + cudaHostGetDevicePointer): the tiered
// table's pages.

#include "ubodt.cuh"

namespace {

template <bool WIDE, bool TIERED, bool SHARDED>
__global__ void ubodt_probe_kernel(const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ dst,
                                   rtt::Grid4 g, int64_t n,
                                   const int32_t* __restrict__ n_live,
                                   const int4* __restrict__ packed,
                                   uint32_t bmask, float* __restrict__ out_dist,
                                   float* __restrict__ out_time,
                                   int32_t* __restrict__ out_first,
                                   rtt::RowSource tier,
                                   rtt::BucketRange range) {
  const int lane = threadIdx.x & 31;
  const int64_t probe = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int64_t live = n;
  if (n_live) {
    const int64_t c = *n_live;
    live = c <= n ? c : 0;
  }
  if constexpr (!TIERED) {
    if (probe >= live) return;  // uniform across the warp
    int32_t s, d;
    rtt::grid_keys(src, dst, g, probe, &s, &d);
    float dist, time;
    int32_t first;
    rtt::warp_probe<WIDE, false, SHARDED>(packed, tier, bmask, s, d, lane,
                                          &dist, &time, &first, range);
    if (lane == 0) {
      out_dist[probe] = dist;
      out_time[probe] = time;
      if (out_first) out_first[probe] = first;
    }
  } else {
    // every thread reaches the block's counts below
    const bool active = probe < live;  // uniform across the warp
    int n_hot = 0;
    if (active) {
      int32_t s, d;
      rtt::grid_keys(src, dst, g, probe, &s, &d);
      float dist, time;
      int32_t first;
      n_hot = rtt::warp_probe<WIDE, true>(packed, tier, bmask, s, d, lane,
                                          &dist, &time, &first);
      if (lane == 0) {
        out_dist[probe] = dist;
        out_time[probe] = time;
        if (out_first) out_first[probe] = first;
      }
    }
    constexpr int kRows = WIDE ? 1 : 2;
    const bool lead = lane == 0 && active;
    const int hits = __syncthreads_count(lead && n_hot >= 1) +
                     (WIDE ? 0 : __syncthreads_count(lead && n_hot >= 2));
    const int fetches = __syncthreads_count(lead) * kRows;
    if (threadIdx.x == 0)
      rtt::add_totals(tier, (unsigned long long)hits,
                      (unsigned long long)(fetches - hits));
  }
}

template <bool WIDE, bool TIERED, bool SHARDED = false>
int launch(const int32_t* src, const int32_t* dst, const int64_t* dims,
           const int64_t* src_strides, const int64_t* dst_strides,
           const int32_t* packed, int32_t bmask, const int32_t* n_live,
           float* out_dist, float* out_time, int32_t* out_first,
           rtt::RowSource tier, void* stream,
           rtt::BucketRange range = rtt::BucketRange{}) {
  rtt::Grid4 g;
  const int64_t n = rtt::make_grid(dims, src_strides, dst_strides, &g);
  if (n <= 0) return 0;
  if (TIERED && tier.slot_map == nullptr) return (int)cudaErrorInvalidValue;
  if (SHARDED && (range.n == 0 || (uint64_t)range.lo + range.n >
                                      (uint64_t)(uint32_t)bmask + 1))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;  // 8 probes per block
  const int64_t blocks = (n * 32 + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ubodt_probe_kernel<WIDE, TIERED, SHARDED><<<(unsigned)blocks, threads, 0,
                                              (cudaStream_t)stream>>>(
      src, dst, g, n, n_live, reinterpret_cast<const int4*>(packed),
      (uint32_t)bmask, out_dist, out_time, out_first, tier, range);
  return (int)cudaGetLastError();
}

inline rtt::RowSource row_source(const int32_t* slot_map, const int32_t* arena,
                                 int32_t* counts, int64_t* totals) {
  return {slot_map, reinterpret_cast<const int4*>(arena), counts,
          reinterpret_cast<unsigned long long*>(totals)};
}

}  // namespace

// dims / src_strides / dst_strides: host arrays of 4 int64 (elements; 0
// strides broadcast).  packed: [bmask + 1, 128] int32, 16-byte aligned.
// n_live: device int32 or null.
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
// totals [2] int64 (or null).
extern "C" int ubodt_probe_tiered_launch(
    const int32_t* src, const int32_t* dst, const int64_t* dims,
    const int64_t* src_strides, const int64_t* dst_strides,
    const int32_t* packed, int32_t bmask, const int32_t* n_live,
    float* out_dist, float* out_time, int32_t* out_first,
    const int32_t* slot_map, const int32_t* arena, int32_t* counts,
    int64_t* totals, void* stream) {
  return launch<false, true>(src, dst, dims, src_strides, dst_strides, packed,
                             bmask, n_live, out_dist, out_time, out_first,
                             row_source(slot_map, arena, counts, totals),
                             stream);
}

extern "C" int ubodt_probe_wide32_tiered_launch(
    const int32_t* src, const int32_t* dst, const int64_t* dims,
    const int64_t* src_strides, const int64_t* dst_strides,
    const int32_t* packed, int32_t bmask, const int32_t* n_live,
    float* out_dist, float* out_time, int32_t* out_first,
    const int32_t* slot_map, const int32_t* arena, int32_t* counts,
    int64_t* totals, void* stream) {
  return launch<true, true>(src, dst, dims, src_strides, dst_strides, packed,
                            bmask, n_live, out_dist, out_time, out_first,
                            row_source(slot_map, arena, counts, totals),
                            stream);
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
