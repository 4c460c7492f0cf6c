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
// each row comes from the hot arena when slot_map names one (an L2-resident
// 4 MB map for the metro table) and is read in place over the host link
// when not (rtt::bucket_row).  A cold row costs a PCIe round trip, so a
// cold probe is bounded by the host link's rate, not HBM's.  The lane that
// owns a probe counts its fetches per bucket; each warp totals its hits
// and misses once, at the end, in one atomic each.
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
// ubodt_host_register pins a host buffer and maps it into the card's
// address space (cudaHostRegister + cudaHostGetDevicePointer): the tiered
// table's pages.

#include "ubodt.cuh"

namespace {

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
  return (int)rtt::launch_probe<WIDE, TIERED, SHARDED>(
      src, dst, g, n, n_live, reinterpret_cast<const int4*>(packed),
      (uint32_t)bmask, out_dist, out_time, out_first, tier, range,
      (cudaStream_t)stream);
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
