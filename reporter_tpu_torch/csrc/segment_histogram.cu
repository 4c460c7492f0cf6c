// Per-segment histogram of a decoded batch (kernel 11b).
//
// Replaces reporter_tpu/parallel/mesh.py:75 match_and_histogram's
// reduction (:85-138): per OSMLR segment, over a [B, T] batch,
//   point_count          matched points on the segment;
//   trace_count          traces that touched it, exactly one per (trace,
//                        segment) pair however often the trace re-enters
//                        (the reference's per-row sort and first
//                        occurrence, :117-130);
//   time_in_segment      seconds between consecutive points on the same
//                        segment with no break between them;
//   distance_in_segment  the chosen route metres of those steps, where
//                        finite.
// A point's segment is edge_seg[cand_edge[b, t, idx]] where the decode
// chose slot idx >= 0 (-1 otherwise, or where the edge has no segment);
// the chosen route into point t is route[b, t-1, src, idx] where src,
// the backpointer at the chosen slot, is >= 0 (the step neither broke
// nor was disconnected), else +inf: the reference's route_dist.  The
// decode's ``choice`` [2, B, T] output (kernel 4) holds idx and src.
//
// Work: a few hundred KB of [B, T] inputs, a gather of one candidate
// edge, one route entry and one segment id per point, and four
// scatter-adds into [S] bins.  Bounded by memory on paper; in practice by
// the atomics' latency and the first-occurrence test.
//
// Design: one block per trace row.  The row's segment ids go to shared
// memory; thread t adds its point, tests first occurrence against the
// row's earlier points (T <= 256 on the matcher's paths: at most 255
// compares a point) and adds its step's dwell, each with a global
// atomicAdd into the [4, S] output, which the wrapper zeroes.  Counts are
// small integers, exact in float32 below 2^24 whatever the order; the two
// float sums depend on the atomics' order, so they agree with any other
// order to rounding (the reference's sharded and unsharded histograms are
// held to rtol 1e-5).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void segment_histogram_kernel(
    const int32_t* __restrict__ choice, const float* __restrict__ route,
    const int32_t* __restrict__ cand_edge, const int32_t* __restrict__ breaks,
    const float* __restrict__ times, const int32_t* __restrict__ edge_seg,
    int64_t B, int32_t T, int32_t K, int32_t S, float* __restrict__ out) {
  extern __shared__ int32_t seg[];  // [T] the row's segment ids, -1 none
  const int64_t b = blockIdx.x;
  const int64_t plane = B * (int64_t)T;
  const int32_t* idx = choice + b * T;
  const int32_t* src = choice + plane + b * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const int it = idx[t];
    int sg = -1;
    if (it >= 0) {
      const int32_t e = cand_edge[(b * T + t) * K + it];
      sg = edge_seg[e > 0 ? e : 0];
    }
    seg[t] = sg >= 0 && sg < S ? sg : -1;
  }
  __syncthreads();
  float* point_count = out;
  float* trace_count = out + S;
  float* time_in = out + 2 * (int64_t)S;
  float* dist_in = out + 3 * (int64_t)S;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const int sg = seg[t];
    if (sg < 0) continue;
    atomicAdd(point_count + sg, 1.f);
    bool first = true;
    for (int u = 0; u < t && first; ++u) first = seg[u] != sg;
    if (first) atomicAdd(trace_count + sg, 1.f);
    if (t == 0 || seg[t - 1] != sg || breaks[b * T + t] != 0) continue;
    const float dt = __fsub_rn(times[b * T + t], times[b * T + t - 1]);
    if (dt != 0.f) atomicAdd(time_in + sg, dt);
    const int s0 = src[t];
    if (s0 >= 0) {
      const float r =
          route[(((b * (T - 1) + (t - 1)) * K) + s0) * K + idx[t]];
      if (isfinite(r) && r != 0.f) atomicAdd(dist_in + sg, r);
    }
  }
}

}  // namespace

// choice [2, B, T] i32 (chosen slot, its backpointer); route [B, T-1, K,
// K] f32; cand_edge [B, T, K] i32; breaks [B, T] i32; times [B, T] f32;
// edge_seg [E] i32; out [4, S] f32, zeroed by the caller.
extern "C" int segment_histogram_launch(const int32_t* choice,
                                        const float* route,
                                        const int32_t* cand_edge,
                                        const int32_t* breaks,
                                        const float* times,
                                        const int32_t* edge_seg, int64_t B,
                                        int32_t T, int32_t K, int32_t S,
                                        float* out, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (B > 0x7fffffffLL || S <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)T * sizeof(int32_t);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        segment_histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  segment_histogram_kernel<<<(unsigned)B, kThreads, smem,
                             (cudaStream_t)stream>>>(
      choice, route, cand_edge, breaks, times, edge_seg, B, T, K, S, out);
  return (int)cudaGetLastError();
}

extern "C" const char* segment_histogram_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
