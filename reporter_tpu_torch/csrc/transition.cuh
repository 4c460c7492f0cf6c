// One entry of the transition matrix, shared by the transition build
// (transition_build.cu, every step of a window) and the seam transition of
// the chain kernel (viterbi_chain.cu, from the carried beam to a window's
// first point): reporter_tpu/ops/viterbi.py:196 _transition_matrix, in the
// reference's operation order with each rounding explicit (common.cuh).
// SPARSE (a template parameter: the reference's static ``sp`` presence)
// adds the sparse-gap model of :146 sparse_beta and :247-265, and :154
// sparse_breakage is here for the recursion and the seam; the dense
// instantiation compiles to the dense code alone.
#pragma once

#include "common.cuh"

namespace rtt {

struct TransParams {
  float sigma;             // sigma_z (the jitter tolerance 2 sigma + 5)
  float beta;
  float radius;            // search_radius
  float max_route_factor;  // max_route_distance_factor
  float max_time_factor;   // max_route_time_factor
  float turn_factor;       // turn_penalty_factor
};

// The sparse-gap model's six scalars (reference SparseParams).
struct SparseArgs {
  float beta_ref;     // s; gaps at or below leave beta unchanged
  float beta_scale;   // growth rate of the beta multiplier
  float beta_max;     // cap on the multiplier
  float break_speed;  // m/s; breakage = max(base, break_speed * dt)
  float vmax;         // m/s drivable-speed knee
  float plaus_weight; // log-prob units per vmax of excess speed
};

// beta * min(1 + beta_scale * max(dt - beta_ref, 0) / max(beta_ref, 1),
// beta_max): the division sits between the product and the sum, so
// nothing fuses
__device__ __forceinline__ float sparse_beta(float beta, const SparseArgs& s,
                                             float dt) {
  const float grow = __fdiv_rn(
      __fmul_rn(s.beta_scale, fmaxf(__fsub_rn(dt, s.beta_ref), 0.f)),
      fmaxf(s.beta_ref, 1.f));
  return __fmul_rn(beta, fminf(__fadd_rn(1.f, grow), s.beta_max));
}

// gap-conditioned breakage: max(breakage_distance, break_speed * max(dt, 0))
__device__ __forceinline__ float sparse_breakage(float brk,
                                                 const SparseArgs& s,
                                                 float dt) {
  return fmaxf(brk, __fmul_rn(s.break_speed, fmaxf(dt, 0.f)));
}

// jnp.mod(d + pi, 2 pi) - pi with jnp.mod's floored remainder: fmod
// (exact), plus the divisor where the signs differ
__device__ __forceinline__ float angle_diff(float a, float b) {
  const float d = __fadd_rn(__fsub_rn(b, a), kPi);
  float r = fmodf(d, kTwoPi);
  if (r != 0.f && ((r < 0.f) != (kTwoPi < 0.f))) r = __fadd_rn(r, kTwoPi);
  return __fsub_rn(r, kPi);
}

// logp of source candidate (ea, oa) -> destination (eb, ob): route =
// remain + UBODT dist + offset with the same-edge forward / jitter rules,
// the max-route and route-time cuts, the turn penalty and
// -|route - gc| / beta.  era/erb are the two candidates' [8] edge rows,
// (sp_dist, sp_time) the probe of (to(ea), from(eb)), gc the straight-line
// metres and dt the seconds between the two points.  Writes the route
// (+inf when infeasible) to *route when route is not null.  With SPARSE,
// beta becomes sparse_beta(dt) in both the |route - gc| term and the turn
// penalty, and where dt > 0 the plausibility term plaus_weight *
// max(route / max(dt, 1) - vmax, 0) / max(vmax, 1) is subtracted, on the
// route before the feasibility cut; an infeasible pair returns kNegInf
// whatever that term gave (0 * inf is NaN when plaus_weight is 0).
template <bool SPARSE>
__device__ __forceinline__ float transition_logp(
    int32_t ea, int32_t eb, float oa, float ob, const float* era,
    const float* erb, float sp_dist, float sp_time, float gc, float dt,
    const TransParams& p, const SparseArgs& sa, float* route) {
  const float remain = __fsub_rn(era[2], oa);
  float rt = __fadd_rn(__fadd_rn(remain, sp_dist), ob);
  // same 0.1 m/s floor as the UBODT builder
  const float speed_a = fmaxf(era[3], 0.1f), speed_b = fmaxf(erb[3], 0.1f);
  float rtime = __fadd_rn(__fadd_rn(__fdiv_rn(remain, speed_a), sp_time),
                          __fdiv_rn(ob, speed_b));

  // same-edge handling: forward progress is the offset delta; a small
  // backward delta (GPS jitter) is lightly penalised; a large one routes
  // the loop, which the formula above already expresses
  const bool same = ea == eb && ea >= 0;
  const float delta = __fsub_rn(ob, oa);
  const float back_tol = __fadd_rn(__fmul_rn(2.0f, p.sigma), 5.0f);
  const bool same_fwd = same && delta >= 0.f;
  const bool same_jitter = same && delta < 0.f && -delta <= back_tol;
  if (same_fwd) rt = delta;
  if (same_jitter) rt = __fmaf_rn(-delta, 1.05f, 1.0f);
  const bool same_known = same_fwd || same_jitter;
  if (same_known) rtime = __fdiv_rn(fabsf(delta), speed_a);

  const bool ok = ea >= 0 && eb >= 0;
  const float max_route = __fmul_rn(p.max_route_factor, __fadd_rn(gc, p.radius));
  bool feasible = ok && isfinite(rt) && rt <= max_route;
  feasible = feasible &&
      (dt <= 0.f || rtime <= __fmul_rn(p.max_time_factor, fmaxf(dt, 1.0f)));

  const float beta = SPARSE ? sparse_beta(p.beta, sa, dt) : p.beta;
  float lp = __fdiv_rn(-fabsf(__fsub_rn(rt, gc)), beta);
  const float turn = fabsf(angle_diff(era[5], erb[4]));
  const float pen = same_known
      ? 0.f : __fdiv_rn(__fmul_rn(p.turn_factor, turn), __fmul_rn(kPi, beta));
  lp = __fsub_rn(lp, pen);
  if (SPARSE && dt > 0.f) {
    const float implied = __fdiv_rn(rt, fmaxf(dt, 1.f));
    const float excess = __fdiv_rn(fmaxf(__fsub_rn(implied, sa.vmax), 0.f),
                                   fmaxf(sa.vmax, 1.f));
    // not fused: the compiled reference rounds the product on its own
    lp = __fsub_rn(lp, __fmul_rn(sa.plaus_weight, excess));
  }
  if (route) *route = feasible ? rt : INFINITY;
  return feasible ? lp : kNegInf;
}

// transition_logp split by what each value depends on, for the transition
// build, which computes a step's and a candidate's parts once and only the
// pair's part per pair.  Every hoisted value is the same operation on the
// same operands as in transition_logp, and pair_cut and pair_logp keep
// its order and roundings, so they give the same bits (an infeasible pair
// is kNegInf and +inf whatever else transition_logp computes for it): a
// change to one must be made to the other.  (The chain kernels' seam keeps transition_logp itself:
// its code generation is fragile, PERF.md.)

// What a step shares: gc and dt between its two points, the max-route
// cut, the route-time cut's bound, beta (sparse_beta(dt) when SPARSE) and
// pi * beta.
struct StepTerms {
  float gc, dt, max_route, max_time, beta, pi_beta;
};

template <bool SPARSE>
__device__ __forceinline__ StepTerms step_terms(float gc, float dt,
                                                const TransParams& p,
                                                const SparseArgs& sa) {
  StepTerms s;
  s.gc = gc;
  s.dt = dt;
  s.max_route = __fmul_rn(p.max_route_factor, __fadd_rn(gc, p.radius));
  s.max_time = __fmul_rn(p.max_time_factor, fmaxf(dt, 1.0f));
  s.beta = SPARSE ? sparse_beta(p.beta, sa, dt) : p.beta;
  s.pi_beta = __fmul_rn(kPi, s.beta);
  return s;
}

// What a source candidate (ea, oa) shares over its K pairs: remain, its
// speed floor, remain / speed_a and its edge's exit heading (era[5]).
struct SrcTerms {
  int32_t e;
  float o, remain, speed, rtime, head;
};

__device__ __forceinline__ SrcTerms src_terms(int32_t ea, float oa,
                                              const float* era) {
  SrcTerms a;
  a.e = ea;
  a.o = oa;
  a.remain = __fsub_rn(era[2], oa);
  a.speed = fmaxf(era[3], 0.1f);
  a.rtime = __fdiv_rn(a.remain, a.speed);
  a.head = era[5];
  return a;
}

// What a destination candidate (eb, ob) shares: ob / speed_b and its
// edge's entry heading (erb[4]).
struct DstTerms {
  int32_t e;
  float o, rtime, head;
};

__device__ __forceinline__ DstTerms dst_terms(int32_t eb, float ob,
                                              const float* erb) {
  DstTerms b;
  b.e = eb;
  b.o = ob;
  b.rtime = __fdiv_rn(ob, fmaxf(erb[3], 0.1f));
  b.head = erb[4];
  return b;
}

// angle_diff's value for every input, with fmodf only outside the range
// the edge rows' headings give.  fmod(d, 2 pi) is d for d in [0, 2 pi),
// and d - 2 pi for d in [2 pi, 4 pi), where the subtraction is exact
// (Sterbenz); for d in (-2 pi, 0) it is d, to which the floored
// remainder adds 2 pi (-0.0 falls in the first range, as fmodf keeps it).
__device__ __forceinline__ float angle_diff_fast(float a, float b) {
  const float d = __fadd_rn(__fsub_rn(b, a), kPi);
  float r;
  if (d >= 0.f && d < kTwoPi) {
    r = d;
  } else if (d >= kTwoPi && d < 2.f * kTwoPi) {
    r = __fsub_rn(d, kTwoPi);
  } else if (d < 0.f && d > -kTwoPi) {
    r = __fadd_rn(d, kTwoPi);
  } else {
    r = fmodf(d, kTwoPi);
    if (r != 0.f && ((r < 0.f) != (kTwoPi < 0.f))) r = __fadd_rn(r, kTwoPi);
  }
  return __fsub_rn(r, kPi);
}

// transition_logp's cuts for the pair (a, b) at step s (back_tol = 2 sigma
// + 5): whether it is feasible, its route (*rt) and whether a same-edge
// rule gave the route (*same_known).  The same-edge time is computed only
// where the time cut reads it.
__device__ __forceinline__ bool pair_cut(const SrcTerms& a, const DstTerms& b,
                                         const StepTerms& s, float sp_dist,
                                         float sp_time, float back_tol,
                                         float* rt, bool* same_known) {
  float r = __fadd_rn(__fadd_rn(a.remain, sp_dist), b.o);
  float rtime = __fadd_rn(__fadd_rn(a.rtime, sp_time), b.rtime);

  const bool same = a.e == b.e && a.e >= 0;
  const float delta = __fsub_rn(b.o, a.o);
  const bool same_fwd = same && delta >= 0.f;
  const bool same_jitter = same && delta < 0.f && -delta <= back_tol;
  if (same_fwd) r = delta;
  if (same_jitter) r = __fmaf_rn(-delta, 1.05f, 1.0f);
  *same_known = same_fwd || same_jitter;
  *rt = r;

  const bool ok = a.e >= 0 && b.e >= 0;
  bool feasible = ok && isfinite(r) && r <= s.max_route;
  if (feasible && !(s.dt <= 0.f)) {
    if (*same_known) rtime = __fdiv_rn(fabsf(delta), a.speed);
    feasible = rtime <= s.max_time;
  }
  return feasible;
}

// transition_logp's value for a feasible pair of route rt at step s, from
// the source edge's exit heading and the destination edge's entry heading.
template <bool SPARSE>
__device__ __forceinline__ float pair_logp(float head_a, float head_b,
                                           const StepTerms& s, float rt,
                                           bool same_known,
                                           const TransParams& p,
                                           const SparseArgs& sa) {
  float lp = __fdiv_rn(-fabsf(__fsub_rn(rt, s.gc)), s.beta);
  float pen = 0.f;
  if (!same_known) {
    const float turn = fabsf(angle_diff_fast(head_a, head_b));
    pen = __fdiv_rn(__fmul_rn(p.turn_factor, turn), s.pi_beta);
  }
  lp = __fsub_rn(lp, pen);
  if (SPARSE && s.dt > 0.f) {
    const float implied = __fdiv_rn(rt, fmaxf(s.dt, 1.f));
    const float excess = __fdiv_rn(fmaxf(__fsub_rn(implied, sa.vmax), 0.f),
                                   fmaxf(sa.vmax, 1.f));
    // not fused: the compiled reference rounds the product on its own
    lp = __fsub_rn(lp, __fmul_rn(sa.plaus_weight, excess));
  }
  return lp;
}

}  // namespace rtt
