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

#include "ubodt.cuh"

namespace {

template <bool WIDE>
__global__ void ubodt_probe_kernel(const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ dst,
                                   rtt::Grid4 g, int64_t n,
                                   const int32_t* __restrict__ n_live,
                                   const int4* __restrict__ packed,
                                   uint32_t bmask, float* __restrict__ out_dist,
                                   float* __restrict__ out_time,
                                   int32_t* __restrict__ out_first) {
  const int lane = threadIdx.x & 31;
  const int64_t probe = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int64_t live = n;
  if (n_live) {
    const int64_t c = *n_live;
    live = c <= n ? c : 0;
  }
  if (probe >= live) return;  // uniform across the warp
  int32_t s, d;
  rtt::grid_keys(src, dst, g, probe, &s, &d);
  float dist, time;
  int32_t first;
  rtt::warp_probe<WIDE>(packed, bmask, s, d, lane, &dist, &time, &first);
  if (lane == 0) {
    out_dist[probe] = dist;
    out_time[probe] = time;
    if (out_first) out_first[probe] = first;
  }
}

template <bool WIDE>
int launch(const int32_t* src, const int32_t* dst, const int64_t* dims,
           const int64_t* src_strides, const int64_t* dst_strides,
           const int32_t* packed, int32_t bmask, const int32_t* n_live,
           float* out_dist, float* out_time, int32_t* out_first,
           void* stream) {
  rtt::Grid4 g;
  const int64_t n = rtt::make_grid(dims, src_strides, dst_strides, &g);
  if (n <= 0) return 0;
  const int threads = 256;  // 8 probes per block
  const int64_t blocks = (n * 32 + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ubodt_probe_kernel<WIDE><<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      src, dst, g, n, n_live, reinterpret_cast<const int4*>(packed),
      (uint32_t)bmask, out_dist, out_time, out_first);
  return (int)cudaGetLastError();
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
  return launch<false>(src, dst, dims, src_strides, dst_strides, packed,
                       bmask, n_live, out_dist, out_time, out_first, stream);
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
  return launch<true>(src, dst, dims, src_strides, dst_strides, packed,
                      bmask, n_live, out_dist, out_time, out_first, stream);
}

extern "C" const char* ubodt_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
