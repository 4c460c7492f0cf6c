// Transition build (kernel 3 of the match program).
//
// Replaces reporter_tpu/ops/viterbi.py:361 precompute_batch (its edge-row
// gather and the straight-line distance gc) and :196 _transition_matrix
// with, in the SPARSE instantiation (transition_build_sparse_launch), the
// sparse-gap model of :146 sparse_beta and :247-265; stages
// "transition-build": for every
// step t and candidate pair (i, j) of a trace, the route distance remain +
// UBODT dist + offset with the same-edge forward / jitter rules, the
// max-route and route-time feasibility cuts, the turn penalty and
// logp = -|route - gc| / beta (beta(dt) and the plausibility term when
// SPARSE).
//
// Work per (b, t, i, j): two 32-byte edge rows (shared by a step's K*K
// threads, so cached), the probe's dist and time, ~40 float operations,
// and logp (and route) out.  On the H100 it is bounded by memory: the
// [B, T-1, K, K] probe results in and logp out, 12 bytes per entry on
// the packed path; the arithmetic is far below the float32 rate.
//
// Design: one thread per (b, t, i, j), in the reference's operation order
// with each rounding explicit (transition.cuh, shared with the chain
// kernel's seam); the (i, j) = (0, 0) thread of a step also writes gc.
// route may be null (the packed match path never reads it): it is then
// not written.

#include "transition.cuh"

namespace {

template <bool SPARSE>
__global__ void transition_build_kernel(
    const int32_t* __restrict__ edge, const float* __restrict__ offset,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ times, const float* __restrict__ edge_rows,
    const float* __restrict__ sp_dist, const float* __restrict__ sp_time,
    int64_t B, int T, int K, rtt::TransParams tp, rtt::SparseArgs sa,
    float* __restrict__ logp,
    float* __restrict__ route, float* __restrict__ gc_out) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = B * (int64_t)(T - 1) * K * K;
  if (n >= total) return;
  const int j = (int)(n % K);
  const int i = (int)((n / K) % K);
  const int64_t r = n / ((int64_t)K * K);  // b * (T-1) + t
  const int64_t b = r / (T - 1);
  const int t = (int)(r % (T - 1));
  const int64_t pt = b * T + t;  // point t of trace b
  const int64_t pa = pt * K + i, pb = (pt + 1) * K + j;

  const int32_t ea = edge[pa], eb = edge[pb];
  const float* era = edge_rows + (int64_t)(ea >= 0 ? ea : 0) * 8;
  const float* erb = edge_rows + (int64_t)(eb >= 0 ? eb : 0) * 8;
  const float gc = rtt::hypot_like_jax(__fsub_rn(px[pt + 1], px[pt]),
                                       __fsub_rn(py[pt + 1], py[pt]));
  const float dt = __fsub_rn(times[pt + 1], times[pt]);
  if (i == 0 && j == 0) gc_out[r] = gc;
  float rt;
  logp[n] = rtt::transition_logp<SPARSE>(ea, eb, offset[pa], offset[pb], era,
                                         erb, sp_dist[n], sp_time[n], gc, dt,
                                         tp, sa, &rt);
  if (route) route[n] = rt;
}

template <bool SPARSE>
int launch(const int32_t* edge, const float* offset, const float* px,
           const float* py, const float* times, const float* edge_rows,
           const float* sp_dist, const float* sp_time, int64_t B, int32_t T,
           int32_t K, const rtt::TransParams& tp, const rtt::SparseArgs& sa,
           float* logp, float* route, float* gc, void* stream) {
  if (T < 2 || B <= 0) return 0;
  const int64_t total = B * (int64_t)(T - 1) * K * K;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  transition_build_kernel<SPARSE><<<(unsigned)blocks, threads, 0,
                                    (cudaStream_t)stream>>>(
      edge, offset, px, py, times, edge_rows, sp_dist, sp_time, B, T, K, tp,
      sa, logp, route, gc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int transition_build_launch(
    const int32_t* edge, const float* offset, const float* px,
    const float* py, const float* times, const float* edge_rows,
    const float* sp_dist, const float* sp_time, int64_t B, int32_t T,
    int32_t K, float sigma, float beta, float radius, float max_route_factor,
    float max_time_factor, float turn_factor, float* logp, float* route,
    float* gc, void* stream) {
  const rtt::TransParams tp = {sigma, beta, radius, max_route_factor,
                               max_time_factor, turn_factor};
  return launch<false>(edge, offset, px, py, times, edge_rows, sp_dist,
                       sp_time, B, T, K, tp, rtt::SparseArgs{}, logp, route,
                       gc, stream);
}

// The dense arguments, then the sparse model's six scalars.
extern "C" int transition_build_sparse_launch(
    const int32_t* edge, const float* offset, const float* px,
    const float* py, const float* times, const float* edge_rows,
    const float* sp_dist, const float* sp_time, int64_t B, int32_t T,
    int32_t K, float sigma, float beta, float radius, float max_route_factor,
    float max_time_factor, float turn_factor, float* logp, float* route,
    float* gc, float beta_ref, float beta_scale, float beta_max,
    float break_speed, float vmax, float plaus_weight, void* stream) {
  const rtt::TransParams tp = {sigma, beta, radius, max_route_factor,
                               max_time_factor, turn_factor};
  const rtt::SparseArgs sa = {beta_ref, beta_scale, beta_max, break_speed,
                              vmax, plaus_weight};
  return launch<true>(edge, offset, px, py, times, edge_rows, sp_dist,
                      sp_time, B, T, K, tp, sa, logp, route, gc, stream);
}

extern "C" const char* transition_build_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
