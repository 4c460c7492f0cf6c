// UBODT probe-outcome counters (the sampled diagnostic; off the match
// program).
//
// Replaces reporter_tpu/ops/diagnostics.py:24 ubodt_probe_stats' counts
// over the probe's [B, T-1, K, K] output: for each candidate pair (t, i,
// j) of consecutive points
//   need   = both candidate edges >= 0, both points valid, not the same
//            edge (a pair that needs a table probe);
//   miss   = need and the probed distance is not finite;
//   costly = miss and the straight-line gap gc <= breakage_distance;
//   beyond = costly and gc > delta (a provable delta truncation).
// gc is jnp.hypot as XLA compiles it (rtt::hypot_like_jax, as kernel 3).
//
// A reduction over bytes: one thread per pair, warp ballots, a block's
// four counts in shared memory, then four atomicAdds per block into the
// int32 [5] result (cleared by the launch).  Slot [4], the distinct pairs
// among the needed ones, is written by the claim kernel in count mode
// (ubodt_dedup.cu) over the `need` mask this kernel writes.

#include "common.cuh"

namespace {

__global__ void probe_stats_kernel(const float* __restrict__ dist,
                                   const int32_t* __restrict__ cand_edge,
                                   const float* __restrict__ valid,
                                   const float* __restrict__ px,
                                   const float* __restrict__ py, int64_t B,
                                   int32_t T, int32_t K, float brk,
                                   float delta, int32_t* stats,
                                   uint8_t* __restrict__ need_out) {
  __shared__ int32_t acc[4];
  if (threadIdx.x < 4) acc[threadIdx.x] = 0;
  __syncthreads();
  const int64_t n = B * (int64_t)(T - 1) * K * K;
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool need = false, miss = false, costly = false, beyond = false;
  if (q < n) {
    const int j = (int)(q % K);
    int64_t r = q / K;
    const int i = (int)(r % K);
    r /= K;
    const int t = (int)(r % (T - 1));
    const int64_t b = r / (T - 1);
    const int64_t p = b * T + t;  // point t of trace b
    const int32_t ea = cand_edge[p * K + i];
    const int32_t eb = cand_edge[(p + 1) * K + j];
    need = ea >= 0 && eb >= 0 && valid[p] != 0.f && valid[p + 1] != 0.f &&
           ea != eb;
    miss = need && !isfinite(dist[q]);
    if (miss) {
      const float gc = rtt::hypot_like_jax(__fsub_rn(px[p + 1], px[p]),
                                           __fsub_rn(py[p + 1], py[p]));
      costly = gc <= brk;
      beyond = costly && gc > delta;
    }
    if (need_out) need_out[q] = need ? 1 : 0;
  }
  const bool flags[4] = {need, miss, costly, beyond};
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int c = __popc(__ballot_sync(0xffffffffu, flags[f]));
    if ((threadIdx.x & 31) == 0 && c) atomicAdd_block(&acc[f], c);
  }
  __syncthreads();
  if (threadIdx.x < 4 && acc[threadIdx.x])
    atomicAdd(&stats[threadIdx.x], acc[threadIdx.x]);
}

}  // namespace

// dist [B, T-1, K, K] f32; cand_edge [B, T, K] i32; valid, px, py [B, T]
// f32; stats int32 [5] (cleared; slots 0-3 counted here); need_out
// uint8 [B, T-1, K, K] or null.
extern "C" int probe_stats_launch(const float* dist, const int32_t* cand_edge,
                                  const float* valid, const float* px,
                                  const float* py, int64_t B, int32_t T,
                                  int32_t K, float brk, float delta,
                                  int32_t* stats, uint8_t* need_out,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(stats, 0, 5 * sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  const int64_t n = B * (int64_t)(T - 1) * K * K;
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  probe_stats_kernel<<<(unsigned)blocks, threads, 0, st>>>(
      dist, cand_edge, valid, px, py, B, T, K, brk, delta, stats, need_out);
  return (int)cudaGetLastError();
}

extern "C" const char* probe_stats_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
