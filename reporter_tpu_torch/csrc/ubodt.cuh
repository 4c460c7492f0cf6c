// UBODT probe arithmetic shared by the probe kernel (ubodt_probe.cu) and
// the seam transition of the chain kernel (viterbi_chain.cu): the two
// uint32 pair hashes of reporter_tpu/ops/hashtable.py:63,:75 and a serial
// probe of the cuckoo layout (:122 _bucket_rows, :96 _select).
//
// Layout: [n_buckets, 128] int32, 16 entries of 8 lanes per bucket row
// (src, dst, dist bits, time bits, first_edge, 3 padding), read as 32
// int4 per row.  A key lives in one of its two buckets; the merge over
// both rows is min dist, min time (exact, order-free).
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

// One probe by one thread: (dist, time) of (s, d), +inf on a miss.
__device__ __forceinline__ void probe_serial(const int4* __restrict__ packed,
                                             uint32_t bmask, int32_t s,
                                             int32_t d, float* dist,
                                             float* time) {
  float bd = INFINITY, bt = INFINITY;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const uint32_t h = (w == 0 ? pair_hash1((uint32_t)s, (uint32_t)d)
                               : pair_hash2((uint32_t)s, (uint32_t)d)) & bmask;
    const int4* row = packed + (int64_t)h * 32;
    for (int e = 0; e < 16; ++e) {
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
