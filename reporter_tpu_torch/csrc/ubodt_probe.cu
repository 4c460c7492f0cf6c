// UBODT probe and select (kernel 2 of the match program).
//
// Replaces reporter_tpu/ops/hashtable.py:138 _lookup_plain (cuckoo layout)
// with :63 device_pair_hash, :75 device_pair_hash2, :122 _bucket_rows and
// :96 _select, stages "ubodt-probe" and "select".
//
// Work per probe: two uint32 hash mixes, two random 512-byte bucket rows
// of a table far larger than L2 (the metro table is ~0.5 GB), and a
// 32-entry key compare.  On the H100 it is bounded by memory: the rows
// each probe must read (the probes of one batch share many rows, so the
// least traffic is the distinct rows touched, once each).
//
// Design: one warp per probe.  Lane l loads 16 bytes of each bucket row
// (entry l/2: the even lane holds src, dst, dist, time, the odd lane
// first_edge and padding), so each row is one coalesced 512-byte
// transaction.  The even lane compares both keys, takes first_edge from
// its odd neighbour by shuffle, and a warp reduction merges (min dist,
// min time, max first_edge) over both rows, exactly the reference's
// min/max merge.  Keys are read through strides, so the [B, T-1, K, K]
// key grid of the main path is a broadcast of two [B, T, K] arrays and is
// never materialised.  out_first may be null (the match path reads only
// dist and time): it is then not written.

#include "ubodt.cuh"

namespace {

using rtt::pair_hash1;
using rtt::pair_hash2;

struct Grid4 {
  int64_t dim[4];
  int64_t src_stride[4];
  int64_t dst_stride[4];
};

__global__ void ubodt_probe_kernel(const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ dst,
                                   Grid4 g, int64_t n,
                                   const int4* __restrict__ packed,
                                   uint32_t bmask, float* __restrict__ out_dist,
                                   float* __restrict__ out_time,
                                   int32_t* __restrict__ out_first) {
  const int lane = threadIdx.x & 31;
  const int64_t probe = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (probe >= n) return;  // uniform across the warp
  int64_t r = probe, so = 0, dof = 0;
#pragma unroll
  for (int a = 3; a >= 0; --a) {
    const int64_t i = r % g.dim[a];
    r /= g.dim[a];
    so += i * g.src_stride[a];
    dof += i * g.dst_stride[a];
  }
  const int32_t s = src[so], d = dst[dof];
  float best_d = INFINITY, best_t = INFINITY;
  int32_t best_f = -1;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const uint32_t h = (w == 0 ? pair_hash1((uint32_t)s, (uint32_t)d)
                               : pair_hash2((uint32_t)s, (uint32_t)d)) & bmask;
    const int4 v = packed[(int64_t)h * 32 + lane];
    const int fe = __shfl_down_sync(0xffffffffu, v.x, 1);
    if ((lane & 1) == 0 && v.x == s && v.y == d) {
      const float dd = __int_as_float(v.z), tt = __int_as_float(v.w);
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
  if (lane == 0) {
    out_dist[probe] = best_d;
    out_time[probe] = best_t;
    if (out_first) out_first[probe] = best_f;
  }
}

}  // namespace

// dims / src_strides / dst_strides: host arrays of 4 int64 (elements; 0
// strides broadcast).  packed: [bmask + 1, 128] int32, 16-byte aligned.
extern "C" int ubodt_probe_launch(const int32_t* src, const int32_t* dst,
                                  const int64_t* dims,
                                  const int64_t* src_strides,
                                  const int64_t* dst_strides,
                                  const int32_t* packed, int32_t bmask,
                                  float* out_dist, float* out_time,
                                  int32_t* out_first, void* stream) {
  Grid4 g;
  int64_t n = 1;
  for (int a = 0; a < 4; ++a) {
    g.dim[a] = dims[a];
    g.src_stride[a] = src_strides[a];
    g.dst_stride[a] = dst_strides[a];
    n *= dims[a];
  }
  if (n <= 0) return 0;
  const int threads = 256;  // 8 probes per block
  const int64_t blocks = (n * 32 + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ubodt_probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      src, dst, g, n, reinterpret_cast<const int4*>(packed), (uint32_t)bmask,
      out_dist, out_time, out_first);
  return (int)cudaGetLastError();
}

extern "C" const char* ubodt_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
