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
// Work per (b, t, i, j): the probe's dist and time in, logp (and route)
// out, 12 bytes on the packed path; the edge rows, offsets and points are
// shared by a step's K*K pairs.  On the H100 the pair traffic takes a few
// microseconds at 512 x 64, K = 8; the rest is instructions and latency:
// two divisions, the turn term and ~30 more operations a feasible pair
// (a minority of a cohort's pairs), the cuts for every pair.
//
// Design: a block takes S consecutive steps r = b * (T-1) + t, S * K * K
// = 512 pairs (256 steps at K = 1, S = 1 past K = 22), so its probe
// results and logp are one contiguous run.  The kernel is templated on K
// in {1, 2, 4, 8, 16, 32}, so a pair's (s, i, j) is shifts and masks (K =
// 0: any other K, decoded at run time); a step's trace b = r / (T-1) is a
// 32-bit fast divmod (the multiplier and shift of ops/hashtable.py
// fast_divmod, made here on the host).
//   1. Each thread reads its 4 consecutive pairs' probe results (16 bytes
//      each) first.  Then one thread a step computes gc, dt and the
//      step's cuts and beta (transition.cuh step_terms) and writes gc, and
//      one thread a (step, candidate) of each side reads the candidate and
//      its edge row's words and computes its divisions (src_terms,
//      dst_terms), all into shared memory as 16-byte rows.
//   2. Each thread takes its pairs' cuts (pair_cut).  An infeasible pair
//      is done (kNegInf, +inf); a feasible one joins its warp's queue
//      (slots by ballot), and the warp then computes the queue's logp
//      (pair_logp) with every lane busy, not the few feasible ones.
//   3. Each thread writes its pairs' logp (and route) 16 bytes at once.
// pair_cut and pair_logp are transition_logp's operations in its order,
// so the bits are the same.  route may be null (the packed match path
// never reads it): it is then not written.

#include "transition.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 10;  // resident blocks an SM, at least
constexpr int kPairs = 512;     // a block's pairs, at most, for K <= 22
constexpr int kPerThread = kPairs / kThreads;  // a thread's pairs
constexpr int kMaxSteps = 256;

// kPerThread consecutive floats, read or written as one access
struct alignas(4 * kPerThread) Run {
  float v[kPerThread];
};

// S, a block's steps: kPairs / K^2, at most kMaxSteps, at least 1
__host__ __device__ constexpr int steps_for(int K) {
  return K * K >= kPairs ? 1 : (kPairs / (K * K) < kMaxSteps ? kPairs / (K * K)
                                                             : kMaxSteps);
}
constexpr int kSide = 512;  // S * K for every K <= 512

using rtt::StepDecode;

template <int KT, bool SPARSE>  // KT = K, or 0: K at run time
__global__ void __launch_bounds__(kThreads, kMinBlocks) transition_build_kernel(
    const int32_t* __restrict__ edge, const float* __restrict__ offset,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ times, const float* __restrict__ edge_rows,
    const float* __restrict__ sp_dist, const float* __restrict__ sp_time,
    int64_t n_steps, StepDecode dec, int k_rt, bool vec, rtt::TransParams tp,
    rtt::SparseArgs sa, float* __restrict__ logp, float* __restrict__ route,
    float* __restrict__ gc_out) {
  constexpr int kS = KT ? steps_for(KT) : kMaxSteps;  // array sizes
  constexpr int kSK = KT ? steps_for(KT) * KT : kSide;
  const int K = KT ? KT : k_rt;
  const int KK = K * K;
  const int S = steps_for(K);
  // the staged terms, a pair's reads 16 bytes at a time: a step's (gc, dt,
  // max_route, max_time) and (beta, pi_beta); a source candidate's (edge
  // bits, offset, remain, remain / speed) and (speed, exit heading); a
  // destination's (edge bits, offset, offset / speed, entry heading)
  __shared__ float4 s_step[kS], s_src[kSK], s_dst[kSK];
  __shared__ float2 s_step2[kS], s_src2[kSK];
  // each warp's feasible pairs: flat index and route, then logp by index
  __shared__ int s_qw[kPairs];
  __shared__ float s_qrt[kPairs], s_lp[kPairs];

  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * S;
  const int ns = (int)min((int64_t)S, n_steps - r0);
  const int n_pairs = ns * KK;
  const int64_t n0 = r0 * KK;  // the block's pairs are n0 .. n0 + n_pairs
  // this thread's pairs w0 .. w0 + kPerThread - 1, read and written as one
  // run where the run is whole and aligned
  const int w0 = tid * kPerThread;
  const bool whole = vec && n0 % kPerThread == 0 && w0 + kPerThread <= n_pairs;

  // the pairs' probe results first, so that their latency overlaps the
  // staging below
  Run pd, pt;
  if (whole) {
    pd = *reinterpret_cast<const Run*>(sp_dist + n0 + w0);
    pt = *reinterpret_cast<const Run*>(sp_time + n0 + w0);
  } else {
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      if (w0 + u < n_pairs) {
        pd.v[u] = sp_dist[n0 + w0 + u];
        pt.v[u] = sp_time[n0 + w0 + u];
      }
    }
  }

  for (int s = tid; s < ns; s += kThreads) {
    const int64_t at = dec.point(r0 + s);  // point t of trace b
    const float gc = rtt::hypot_like_jax(__fsub_rn(px[at + 1], px[at]),
                                         __fsub_rn(py[at + 1], py[at]));
    const rtt::StepTerms st = rtt::step_terms<SPARSE>(
        gc, __fsub_rn(times[at + 1], times[at]), tp, sa);
    gc_out[r0 + s] = gc;
    s_step[s] = make_float4(st.gc, st.dt, st.max_route, st.max_time);
    s_step2[s] = make_float2(st.beta, st.pi_beta);
  }
  const int side = ns * K;  // (step, candidate) entries of each side
  for (int e = tid; e < 2 * side; e += kThreads) {
    const bool dst = e >= side;
    const int c = dst ? e - side : e;  // s * K + candidate
    const int64_t at = (dec.point(r0 + c / K) + (dst ? 1 : 0)) * K + c % K;
    const int32_t ec = edge[at];
    const float oc = offset[at];
    const float* er = edge_rows + (int64_t)(ec >= 0 ? ec : 0) * 8;
    if (dst) {
      const rtt::DstTerms b = rtt::dst_terms(ec, oc, er);
      s_dst[c] = make_float4(__int_as_float(b.e), b.o, b.rtime, b.head);
    } else {
      const rtt::SrcTerms a = rtt::src_terms(ec, oc, er);
      s_src[c] = make_float4(__int_as_float(a.e), a.o, a.remain, a.rtime);
      s_src2[c] = make_float2(a.speed, a.head);
    }
  }
  __syncthreads();

  const float back_tol = __fadd_rn(__fmul_rn(2.0f, tp.sigma), 5.0f);
  auto terms = [&](int w, rtt::StepTerms* st, rtt::SrcTerms* a,
                   rtt::DstTerms* b) {
    const int s = w / KK, ia = s * K + (w / K) % K, ib = s * K + w % K;
    const float4 s4 = s_step[s], a4 = s_src[ia], b4 = s_dst[ib];
    const float2 s2 = s_step2[s], a2 = s_src2[ia];
    *st = {s4.x, s4.y, s4.z, s4.w, s2.x, s2.y};
    *a = {__float_as_int(a4.x), a4.y, a4.z, a2.x, a4.w, a2.y};
    *b = {__float_as_int(b4.x), b4.y, b4.z, b4.w};
  };
  // the cuts of this thread's pairs; the feasible ones join its warp's
  // queue (flat index, bit 31 when a same-edge rule gave the route), in
  // the warp's share of the block's queue arrays
  const int lane = tid & 31;
  const int qbase = (tid & ~31) * kPerThread;
  Run lp, rt;
  unsigned mine = 0;  // bit u: pair w0 + u is feasible
  int nq = 0;         // the warp's queue length
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int w = w0 + u;
    bool feasible = false, known = false;
    lp.v[u] = rtt::kNegInf;
    rt.v[u] = INFINITY;
    if (w < n_pairs) {
      rtt::StepTerms st;
      rtt::SrcTerms a;
      rtt::DstTerms b;
      terms(w, &st, &a, &b);
      float r;
      feasible = rtt::pair_cut(a, b, st, pd.v[u], pt.v[u], back_tol, &r,
                               &known);
      if (feasible) rt.v[u] = r;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, feasible);
    if (feasible) {
      const int q = qbase + nq + __popc(ballot & ((1u << lane) - 1u));
      s_qw[q] = (int)((unsigned)w | (known ? 0x80000000u : 0u));
      s_qrt[q] = rt.v[u];
      mine |= 1u << u;
    }
    nq += __popc(ballot);
  }
  __syncwarp();
  // the queue's values, every lane of the warp busy
  for (int q = qbase + lane; q < qbase + nq; q += 32) {
    const int v = s_qw[q], w = v & 0x7fffffff;
    rtt::StepTerms st;
    rtt::SrcTerms a;
    rtt::DstTerms b;
    terms(w, &st, &a, &b);
    s_lp[w] = rtt::pair_logp<SPARSE>(a.head, b.head, st, s_qrt[q], v < 0, tp,
                                     sa);
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < kPerThread; ++u)
    if (mine & (1u << u)) lp.v[u] = s_lp[w0 + u];
  if (whole) {
    *reinterpret_cast<Run*>(logp + n0 + w0) = lp;
    if (route) *reinterpret_cast<Run*>(route + n0 + w0) = rt;
  } else {
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      if (w0 + u < n_pairs) {
        logp[n0 + w0 + u] = lp.v[u];
        if (route) route[n0 + w0 + u] = rt.v[u];
      }
    }
  }
  // K > 32 only (a step's pairs outnumber kPairs), one pair at a time
  for (int w = tid + kPairs; w < n_pairs; w += kThreads) {
    rtt::StepTerms st;
    rtt::SrcTerms a;
    rtt::DstTerms b;
    terms(w, &st, &a, &b);
    float r;
    bool known;
    const bool feasible = rtt::pair_cut(a, b, st, sp_dist[n0 + w],
                                        sp_time[n0 + w], back_tol, &r, &known);
    logp[n0 + w] = feasible
        ? rtt::pair_logp<SPARSE>(a.head, b.head, st, r, known, tp, sa)
        : rtt::kNegInf;
    if (route) route[n0 + w] = feasible ? r : INFINITY;
  }
}

template <int KT, bool SPARSE>
int launch_kt(const int32_t* edge, const float* offset, const float* px,
              const float* py, const float* times, const float* edge_rows,
              const float* sp_dist, const float* sp_time, int64_t n_steps,
              const StepDecode& dec, int K, const rtt::TransParams& tp,
              const rtt::SparseArgs& sa, float* logp, float* route,
              float* gc, cudaStream_t stream) {
  const int64_t blocks = (n_steps + steps_for(K) - 1) / steps_for(K);
  const bool vec = (((uintptr_t)sp_dist | (uintptr_t)sp_time | (uintptr_t)logp |
                     (uintptr_t)route) & 15) == 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  transition_build_kernel<KT, SPARSE><<<(unsigned)blocks, kThreads, 0,
                                        stream>>>(
      edge, offset, px, py, times, edge_rows, sp_dist, sp_time, n_steps, dec,
      K, vec, tp, sa, logp, route, gc);
  return (int)cudaGetLastError();
}

template <bool SPARSE>
int launch(const int32_t* edge, const float* offset, const float* px,
           const float* py, const float* times, const float* edge_rows,
           const float* sp_dist, const float* sp_time, int64_t B, int32_t T,
           int32_t K, const rtt::TransParams& tp, const rtt::SparseArgs& sa,
           float* logp, float* route, float* gc, void* stream) {
  if (T < 2 || B <= 0 || K <= 0) return 0;
  if (K > kSide) return (int)cudaErrorInvalidValue;
  const int64_t n_steps = B * (int64_t)(T - 1);
  const StepDecode dec = rtt::step_decode(n_steps, T);
  cudaStream_t s = (cudaStream_t)stream;
#define RTT_BUILD(KT)                                                        \
  launch_kt<KT, SPARSE>(edge, offset, px, py, times, edge_rows, sp_dist,     \
                        sp_time, n_steps, dec, K, tp, sa, logp, route, gc, s)
  switch (K) {
    case 1: return RTT_BUILD(1);
    case 2: return RTT_BUILD(2);
    case 4: return RTT_BUILD(4);
    case 8: return RTT_BUILD(8);
    case 16: return RTT_BUILD(16);
    case 32: return RTT_BUILD(32);
    default: return RTT_BUILD(0);
  }
#undef RTT_BUILD
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
