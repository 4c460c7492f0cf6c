// The per-trace Viterbi shared by kernel 4 (viterbi_scan.cu, a window
// that starts fresh) and kernel 5 (viterbi_chain.cu, a window that
// continues a carried beam); the log-depth kernels (viterbi_assoc.cu)
// share its seam (seam_column), per-point aux (point_aux, Aux) and end of
// trace (finish_trace: seam check, packed output, aux, carry-out).
//
// Replaces reporter_tpu/ops/viterbi.py:447 chain_trace (the step function
// at :466-480; with CARRY the seam transition from the carried beam at
// :487-510, the seam check at :578-584 and the carry-out at :590-606),
// :610 backtrace, :814 _compact, the confidence block at :553 and :865
// pack_compact.
//
// SPARSE (the reference's static ``sp``, :458-470 and :498-499): step t
// breaks when gc exceeds max(breakage_distance, break_speed * max(times[t]
// - times[t-1], 0)) instead of the fixed distance, the seam's threshold
// uses the gap from the carried time, and the seam transition is the
// sparse one (transition.cuh).  The dense instantiation is unchanged.
//
// Work per trace: T-1 max-plus [K] x [K, K] steps (K*K adds and compares
// each), then a reverse walk over the backpointers; with CARRY also one
// [K, K] seam transition (K*K serial UBODT probes of two 512-byte rows
// each) before the recursion.  The recursion is sequential in T, so with
// few traces it is bounded by the chain's latency, with many by reading
// logp ([B, T-1, K, K] floats) once.
//
// Design: one group of K threads per trace (K a power of two <= 32, so 32/K
// traces share a warp).  Thread j owns destination slot j: per step it
// gathers the K running scores by shuffle, scans the K sources in index
// order with a strict > (the first maximum, as argmax takes it) and
// applies break, restart and padding-freeze exactly as the reference's
// step.  A step's operands never come from global memory inside the
// step: each step's [K, K] logp slab reaches a shared-memory ring (Ring, 8
// steps deep, 4 at K = 32) by cp.async 7 (3) steps ahead, and the
// emissions and step scalars (valid, gc, the last slot's edge, the time)
// a span of 32 steps at a time, a span ahead (Layout sizes every buffer
// to T at most).  So a step costs its shuffles, adds, compares, one
// ballot and shared-memory reads, not a memory round trip.  The
// confidence aux leaves the step too: the scores wait in shared memory
// and every 32 steps the group's lanes compute the points' local argmax
// and aux parts in parallel, lane 0 adding them in point order.
// Backpointers (int8) and each step's argmax, break and flags stay in
// shared memory.  Lane 0 of the group walks back (each point's flags read
// a point ahead); then the group writes the packed [3, B, T] output
// (edge, offset bits, break; loads batched before their stores) and the
// [B, 4] aux.  Blocks shrink from 128 threads to 64 or 32 for a small
// batch (launch), so that the traces spread over more SMs.  The
// arithmetic and its order are the reference's, as before this design.
// Kernel 4 may also write ``choice`` [2, B, T]: each point's chosen slot
// and its backpointer there (the source slot of the step into it), what
// the segment histogram reads.
//
// With CARRY, thread j first computes the seam column j: for each carried
// source slot i it probes the UBODT for (to(carry.edge[i]),
// from(cand.edge[0][j])), or, on a gp mesh (the table split over ranks, so
// no launch sees all of it), reads that probe's result from the [B, K, K]
// seam_dist / seam_time the wrapper resolved over the ranks, and applies
// the dense transition arithmetic (transition.cuh, the same roundings as
// kernel 3), then starts from the
// carried scores instead of the emissions alone.  After the walk it
// re-checks that the committed slot reaches the window's first choice and
// writes the carry-out (scores renormalised by their max, the last valid
// point's candidates, position and chosen slot).  The carry comes from
// [B]-leading rows, or from a slab through ``slots``: a row with use false
// reads nothing and starts from the inactive carry, a row whose slot is
// >= S writes nothing.  Carry reads all happen before the first
// __syncwarp and writes after the last, and the caller passes each slab
// row at most once per launch, so reading and writing one slab in one
// launch is safe.
#pragma once

#include <cuda_pipeline.h>

#include <atomic>

#include "transition.cuh"
#include "ubodt.cuh"

namespace {

using rtt::kNegInf;

// TraceCarry leaves: [rows, K] scores, edge, offset; [rows] x, y, t,
// active (bool bytes), committed.
struct CarryPtrs {
  const float* scores;
  const int32_t* edge;
  const float* offset;
  const float* x;
  const float* y;
  const float* t;
  const uint8_t* active;
  const int32_t* committed;
};

struct CarryOutPtrs {
  float* scores;
  int32_t* edge;
  float* offset;
  float* x;
  float* y;
  float* t;
  uint8_t* active;
  int32_t* committed;
};

struct ViterbiArgs {
  const float* emis;         // [B, T, K]
  const float* logp;         // [B, T-1, K, K]
  const float* gc;           // [B, T-1]
  const float* valid;        // [B, T] 0/1
  const int32_t* cand_edge;  // [B, T, K]
  const float* cand_offset;  // [B, T, K]
  int64_t B;
  int T;
  float brk;                 // breakage_distance
  int32_t* packed;           // [3, B, T]
  float* aux;                // [B, 4]
  // CARRY only
  const float* px;           // [B, T]
  const float* py;
  const float* times;        // also read by SPARSE without CARRY
  const float* edge_rows;    // [E, 8]
  const int4* ubodt;         // [n_buckets, 32 or 64] int4
  uint32_t bmask;
  bool wide;                 // the table's layout: wide32 (else cuckoo)
  rtt::RowSource tier;       // the hot tier and fetch counters, or none
  // [B, K, K] the seam's probe results, resolved outside the launch (a
  // table split over a gp mesh: every rank's range probed, merged); null:
  // the seam probes ubodt itself
  const float* seam_dist;
  const float* seam_time;
  rtt::TransParams tp;
  rtt::SparseArgs sa;        // SPARSE only
  CarryPtrs in;
  CarryOutPtrs out;
  const int32_t* slots;      // [B] slab rows, or null: row b is carry row b
  const uint8_t* use;        // [B] with slots: read the slab row
  int64_t S;                 // slab rows
  int32_t* choice;           // [2, B, T] chosen slot and its backpointer, or null
};

// The seam's parts, one carried slot i and one destination slot j at a
// time (seam_column loops i; the log-depth kernels give each (i, j) a
// thread).  SeamRow: what every entry of trace ``bb`` reads: its carry
// row (the slab row through ``slots``, -1 for none), whether that carry is
// active, its chosen slot, and the window's first point's distance and
// time gap from the carried point.
struct SeamRow {
  int64_t row;
  bool active;
  int committed;
  float gc0, dt0;
};

__device__ __forceinline__ SeamRow seam_row(const ViterbiArgs& a, int64_t bb) {
  SeamRow r;
  r.row = bb;
  if (a.slots) {
    const int64_t sl = a.slots[bb];
    r.row = a.use[bb] ? (sl < a.S ? sl : a.S - 1) : -1;
  }
  r.active = r.row >= 0 && a.in.active[r.row] != 0;
  r.committed = r.row >= 0 ? a.in.committed[r.row] : -1;
  const float cx = r.row >= 0 ? a.in.x[r.row] : 0.f;
  const float cy = r.row >= 0 ? a.in.y[r.row] : 0.f;
  const float ct = r.row >= 0 ? a.in.t[r.row] : 0.f;
  const int64_t p0 = bb * a.T;
  r.gc0 = rtt::hypot_like_jax(__fsub_rn(a.px[p0], cx), __fsub_rn(a.py[p0], cy));
  r.dt0 = __fsub_rn(a.times[p0], ct);
  return r;
}

// The window's first candidate j: its edge, offset, edge row and from-node.
struct SeamDst {
  int32_t eb;
  float ob;
  const float* erb;
  int32_t from_b;
};

template <int K>
__device__ __forceinline__ SeamDst seam_dst(const ViterbiArgs& a, int64_t bb, int j) {
  SeamDst d;
  d.eb = a.cand_edge[bb * a.T * K + j];
  d.ob = a.cand_offset[bb * a.T * K + j];
  d.erb = a.edge_rows + (int64_t)(d.eb >= 0 ? d.eb : 0) * 8;
  d.from_b = __float_as_int(d.erb[1]);
  return d;
}

// The seam transition's logp from carried slot i into d (UBODT probe, or
// on a gp mesh the resolved seam_dist / seam_time); *sc: slot i's carried
// score.  ``count``: the probe counts as fetches of a tiered table.
template <int K, bool SPARSE, int kProbeBatch>
__device__ __forceinline__ float seam_logp(const ViterbiArgs& a, int64_t bb,
                                           const SeamRow& r, const SeamDst& d,
                                           int i, int j, bool count, int* hits,
                                           int* fetches, float* sc) {
  const int32_t ea = r.row >= 0 ? a.in.edge[r.row * K + i] : -1;
  const float oa = r.row >= 0 ? a.in.offset[r.row * K + i] : 0.f;
  *sc = r.row >= 0 ? a.in.scores[r.row * K + i] : kNegInf;
  const float* era = a.edge_rows + (int64_t)(ea >= 0 ? ea : 0) * 8;
  float sp_dist, sp_time;
  if (a.seam_dist) {
    const int64_t q = (bb * K + i) * K + j;
    sp_dist = a.seam_dist[q];
    sp_time = a.seam_time[q];
  } else {
    rtt::probe_serial<kProbeBatch>(a.ubodt, a.tier, a.bmask, a.wide,
                                   __float_as_int(era[0]), d.from_b, &sp_dist,
                                   &sp_time, count, hits, fetches);
  }
  return rtt::transition_logp<SPARSE>(ea, d.eb, oa, d.ob, era, d.erb, sp_dist,
                                      sp_time, r.gc0, r.dt0, a.tp, a.sa,
                                      nullptr);
}

// The seam's breakage: too far apart, nothing connects (``any``: some
// destination slot's best is alive), or no live carry.
template <bool SPARSE>
__device__ __forceinline__ bool seam_break(const ViterbiArgs& a,
                                           const SeamRow& r, bool any) {
  const float brk0 = SPARSE ? rtt::sparse_breakage(a.brk, a.sa, r.dt0) : a.brk;
  return r.gc0 > brk0 || !any || !r.active;
}

// The seam: the transition from the carried beam (row ``bb``'s carry, or
// its slab row) into destination slot j of the window's first point.
// Called by whole warps: lanes in the group of ``gmask`` share a trace.
// Returns the first point's score in slot j and sets first_break,
// committed (the carried chosen slot) and lp_committed (the seam logp
// from it to slot j).  ``count``: this lane's probes count as fetches of a
// tiered table (false for a lane that repeats another's trace).
// kProbeBatch: probe_serial's entries loaded at once (the recursion
// kernel's 16; the log-depth kernels give each probe a thread of its own
// instead, seam_logp).
template <int K, bool SPARSE, int kProbeBatch = 1>
__device__ __forceinline__ float seam_column(const ViterbiArgs& a, int64_t bb,
                                             int j, unsigned gmask,
                                             bool& first_break, int& committed,
                                             float& lp_committed,
                                             bool count) {
  const SeamRow r = seam_row(a, bb);
  const SeamDst d = seam_dst<K>(a, bb, j);
  committed = r.committed;
  const int c = committed > 0 ? committed : 0;
  float best = 0.f;
  lp_committed = kNegInf;
  int hits = 0, fetches = 0;
  for (int i = 0; i < K; ++i) {
    float sc;
    const float lp = seam_logp<K, SPARSE, kProbeBatch>(a, bb, r, d, i, j, count,
                                                       &hits, &fetches, &sc);
    if (i == c) lp_committed = lp;
    const float tot = __fadd_rn(sc, lp);
    if (i == 0 || tot > best) best = tot;
  }
  if (a.tier.totals) {  // uniform: the warp's fetches in one atomic each
    const unsigned h = __reduce_add_sync(0xffffffffu, (unsigned)hits);
    const unsigned f = __reduce_add_sync(0xffffffffu, (unsigned)fetches);
    if ((threadIdx.x & 31) == 0) rtt::add_totals(a.tier, h, f - h);
  }
  const bool connected = best > kNegInf / 2;
  const bool any = (__ballot_sync(0xffffffffu, connected) & gmask) != 0u;
  first_break = seam_break<SPARSE>(a, r, any);
  const float e = a.emis[bb * a.T * K + j];
  return first_break ? e : __fadd_rn(best, e);
}

// One point's part of the confidence aux and its local argmax, from its
// K scores: the winner-vs-runner-up margin when two slots are alive at a
// valid point, and pool exhaustion (the last slot filled).
struct PointAux {
  int local;    // argmax of the scores (the first maximum), -1 all dead
  bool two;     // two slots alive at a valid point
  float marg;   // top1 - top2 when ``two``
  bool exh;     // valid point whose K-th candidate exists
};

template <int K>
__device__ __forceinline__ PointAux point_aux(const float (&s)[K], bool vt,
                                              bool last_slot_filled) {
  float top1 = s[0];
  int am = 0;
#pragma unroll
  for (int i = 1; i < K; ++i)
    if (s[i] > top1) { top1 = s[i]; am = i; }
  float top2 = kNegInf;
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (i != am && s[i] > top2) top2 = s[i];
  PointAux p;
  p.local = top1 > kNegInf / 2 ? am : -1;
  p.two = top1 > kNegInf / 2 && top2 > kNegInf / 2 && vt;
  p.marg = p.two ? __fsub_rn(top1, top2) : 0.f;
  p.exh = vt && last_slot_filled;
  return p;
}

// The [4] aux of a trace, accumulated point by point in t order.
struct Aux {
  float amin = INFINITY, asum = 0.f, acnt = 0.f, aexh = 0.f;
  __device__ __forceinline__ void add(const PointAux& p) {
    if (p.two) {
      amin = p.marg < amin ? p.marg : amin;
      asum = __fadd_rn(asum, p.marg);
      acnt = __fadd_rn(acnt, 1.f);
    }
    if (p.exh) aexh = __fadd_rn(aexh, 1.f);
  }
};

// The carry-out of trace b by lane j (one of K): at the last valid point
// ``last`` (-1: none), the scores renormalised by their max (``score`` is
// slot j's at T-1, s[] all K: padded steps froze them, so that is the beam
// there), the candidates, position and chosen slot; to the slab row
// through ``slots`` (a padding row writes nothing) or row b.
template <int K>
__device__ __forceinline__ void carry_out(const ViterbiArgs& a, int64_t b,
                                          int j, const int8_t* idx, int last,
                                          float score, const float (&s)[K]) {
  const int T = a.T;
  const int32_t* ce = a.cand_edge + b * T * K;
  const float* co = a.cand_offset + b * T * K;
  int64_t orow = b;
  if (a.slots) {
    const int64_t sl = a.slots[b];
    orow = sl < a.S ? sl : -1;  // padding rows drop
  }
  if (orow < 0) return;
  const bool any_valid = last >= 0;
  const int at = any_valid ? last : 0;
  float smax = s[0];
#pragma unroll
  for (int i = 1; i < K; ++i) smax = s[i] > smax ? s[i] : smax;
  a.out.scores[orow * K + j] =
      (score > kNegInf / 2 && smax > kNegInf / 2) ? __fsub_rn(score, smax)
                                                  : kNegInf;
  a.out.edge[orow * K + j] = ce[(int64_t)at * K + j];
  a.out.offset[orow * K + j] = co[(int64_t)at * K + j];
  if (j == 0) {
    a.out.x[orow] = a.px[b * T + at];
    a.out.y[orow] = a.py[b * T + at];
    a.out.t[orow] = a.times[b * T + at];
    a.out.active[orow] = any_valid ? 1 : 0;
    a.out.committed[orow] = any_valid ? (int32_t)idx[at] : -1;
  }
}

// The end of trace b, by the K lanes j of its group once the chosen
// slots idx[T] and break flags brk_flag[T] are in shared memory (lanes
// that are not ``live`` pass a real row b and write nothing): with
// CARRY the seam check (the committed slot must reach the window's first
// choice, else the seam is a break), then, for a live lane, the packed
// [3, B, T] output (edge, offset bits, break), the [B, 4] aux (lane 0's
// ``ax``) and with CARRY the carry-out at the last valid point ``last``:
// ``score`` is slot j's score at T-1 and s[] all K of them (padded steps
// froze the scores, so that is the beam there), renormalised by the max.
// Each lane writes its points kBatch at a time, every load of a batch
// before its stores.
template <int K, bool CARRY, int kBatch = 1>
__device__ __forceinline__ void finish_trace(
    const ViterbiArgs& a, int64_t b, int j, bool live, const int8_t* idx,
    int8_t* brk_flag, const Aux& ax, int committed, float lp_committed,
    int last, float score, const float (&s)[K]) {
  const int T = a.T;
  const float* vd = a.valid + b * T;
  const int32_t* ce = a.cand_edge + b * T * K;
  const float* co = a.cand_offset + b * T * K;
  if constexpr (CARRY) {
    const int i0 = idx[0];
    if (j == i0 && committed >= 0 && !brk_flag[0] && vd[0] != 0.f &&
        !(lp_committed > kNegInf / 2))
      brk_flag[0] = 1;
    __syncwarp();
  }

  if (!live) return;
  // (the stores could alias the loads, which would otherwise wait on one
  // another)
  const int64_t plane = a.B * (int64_t)T;
  for (int t0 = j; t0 < T; t0 += kBatch * K) {
    int32_t edge[kBatch], off[kBatch];
    int8_t brk[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * K;
      if (t < T) {
        const int it = idx[t];
        const int sel = it > 0 ? it : 0;
        edge[u] = it >= 0 ? ce[(int64_t)t * K + sel] : -1;
        off[u] = __float_as_int(co[(int64_t)t * K + sel]);
        brk[u] = brk_flag[t];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * K;
      if (t < T) {
        const int64_t o = b * T + t;
        a.packed[o] = edge[u];
        a.packed[plane + o] = off[u];
        a.packed[2 * plane + o] = brk[u];
      }
    }
  }
  if (j == 0) {
    a.aux[b * 4 + 0] = ax.amin;
    a.aux[b * 4 + 1] = ax.asum;
    a.aux[b * 4 + 2] = ax.acnt;
    a.aux[b * 4 + 3] = ax.aexh;
  }

  if constexpr (CARRY) carry_out<K>(a, b, j, idx, last, score, s);
}

// The prefetch ring: each step's [K, K] logp slab, staged kDepth - 1
// steps ahead in shared memory by cp.async (kLp words a trace: a row of
// padding, so that the groups of a warp read distinct banks).
template <int K>
struct Ring {
  static constexpr int kDepth = K >= 32 ? 4 : 8;
  static constexpr int kLp = K * K + K;
};

// Steps per span of the emissions and step scalars staged at once, and
// per pass of the confidence aux (a power of two).  A span is staged a
// span ahead, into one half of a two-span buffer.
constexpr int kChunk = 32;

// Where a block's shared memory goes, for ``traces`` traces of T points
// (no buffer longer than T): the ring (slots x traces x kLp floats); per
// trace, in floats, the aux pass's scores (rows x K) and two spans of
// emissions (span x K) and of the four step scalars (valid, gc, the last
// slot's candidate edge, the time); then per trace T*K backpointers, four
// bytes a point (argmax, break, chosen slot, valid and last-slot flags)
// and the aux pass's flags (rows).
template <int K>
struct Layout {
  int slots, rows, span;
  size_t ring, floats, bytes;
  __host__ __device__ Layout(int traces, int T) {
    slots = T < Ring<K>::kDepth ? T : Ring<K>::kDepth;
    rows = T < kChunk ? T : kChunk;
    span = T < 2 * kChunk ? T : 2 * kChunk;
    ring = (size_t)slots * traces * Ring<K>::kLp * 4;
    floats = ((size_t)rows * K + (size_t)span * (K + 4) + 3) & ~(size_t)3;
    bytes = (size_t)T * (K + 4) + rows;
  }
  __host__ __device__ size_t total(int traces) const {
    return ring + (size_t)traces * (floats * 4 + bytes);
  }
};

template <int K, bool CARRY, bool SPARSE>
__global__ void viterbi_kernel(const ViterbiArgs a) {
  extern __shared__ __align__(16) int8_t smem[];
  using R = Ring<K>;
  const int T = a.T;
  const int traces_per_block = blockDim.x / K;
  const int g = threadIdx.x / K;  // group (trace) within the block
  const int j = threadIdx.x % K;  // destination slot
  const int64_t b = (int64_t)blockIdx.x * traces_per_block + g;
  const bool live = b < a.B;
  // groups past B still run the loop (the shuffles need whole warps) on
  // trace 0's data, and write nothing
  const int64_t bb = live ? b : 0;
  const Layout<K> L(traces_per_block, T);
  float* ring_lp = reinterpret_cast<float*>(smem);
  float* sbuf = reinterpret_cast<float*>(smem + L.ring) + (size_t)g * L.floats;
  float* em_span = sbuf + L.rows * K;            // [span][K] emissions
  float* sc_span = em_span + L.span * K;         // [4][span] step scalars
  int8_t* bp = smem + L.ring + (size_t)traces_per_block * L.floats * 4 +
               (size_t)g * L.bytes;              // backpointers [T][K]
  int8_t* loc = bp + (size_t)T * K;              // argmax per step, -1 dead
  int8_t* brk_flag = loc + T;                    // break per step
  int8_t* idx = brk_flag + T;                    // chosen slot per step
  int8_t* vflag = idx + T;                       // valid | last slot filled << 1
  int8_t* pflag = vflag + T;                     // aux pass: two | exh << 1

  const unsigned lane = threadIdx.x & 31;
  const unsigned gmask = (K == 32) ? 0xffffffffu
                                   : (((1u << K) - 1u) << (lane / K * K));
  const float* em = a.emis + bb * T * K;
  const float* vd = a.valid + bb * T;
  const int32_t* ce = a.cand_edge + bb * T * K;
  const float* tm = SPARSE ? a.times + bb * T : nullptr;
  const float* lp_trace = a.logp + bb * (int64_t)(T - 1) * K * K;

  // The operands reach shared memory ahead of the recursion, by the
  // trace's K lanes: the emissions and step scalars a span of kChunk steps
  // at a time, two spans at the start; each step's logp slab kDepth - 1
  // steps ahead (a commit group a step).
  const bool em16 =
      ((reinterpret_cast<uintptr_t>(em) | reinterpret_cast<uintptr_t>(em_span)) &
       15) == 0;
  const float* gc = a.gc + bb * (T - 1) - 1;  // gc[t] is step t's
  const float* last_edge = reinterpret_cast<const float*>(ce) + K - 1;
  auto stage_span = [&](int t0) {  // steps t0 .. t0 + kChunk - 1
    const int n = T - t0 < kChunk ? T - t0 : kChunk;
    const int h = t0 & (2 * kChunk - 1);  // the span's first row
    float* de = em_span + h * K;
    const float* se = em + (int64_t)t0 * K;
    if (em16 && ((n * K) & 3) == 0) {
      for (int c = j; c < n * K / 4; c += K)
        __pipeline_memcpy_async(de + 4 * c, se + 4 * c, 16);
    } else {
      for (int c = j; c < n * K; c += K)
        __pipeline_memcpy_async(de + c, se + c, 4);
    }
    for (int u = j; u < n; u += K) {
      const int t = t0 + u;
      float* ds = sc_span + h + u;
      __pipeline_memcpy_async(ds, vd + t, 4);
      if (t >= 1) __pipeline_memcpy_async(ds + L.span, gc + t, 4);
      __pipeline_memcpy_async(ds + 2 * L.span, last_edge + (int64_t)t * K, 4);
      if (SPARSE) __pipeline_memcpy_async(ds + 3 * L.span, tm + t, 4);
    }
  };
  const bool lp16 = K >= 4 && (reinterpret_cast<uintptr_t>(a.logp) & 15) == 0;
  // step t's logp slab into ring slot t % kDepth
  auto stage = [&](int t) {
    float* dlp =
        ring_lp + ((int64_t)(t % R::kDepth) * traces_per_block + g) * R::kLp;
    const float* slp = lp_trace + (int64_t)(t - 1) * K * K;
    if (lp16) {
#pragma unroll
      for (int r = 0; r < K / 4; ++r)
        __pipeline_memcpy_async(dlp + 4 * (j + r * K), slp + 4 * (j + r * K),
                                16);
    } else {
#pragma unroll
      for (int r = 0; r < K; ++r)
        __pipeline_memcpy_async(dlp + j + r * K, slp + j + r * K, 4);
    }
  };
  stage_span(0);
  if (T > kChunk) stage_span(kChunk);
  __pipeline_commit();
  for (int t = 1; t < R::kDepth; ++t) {
    if (t < T) stage(t);
    __pipeline_commit();
  }

  Aux ax;
  float s[K];
  float score = em[j];
  bool first_break = true;
  int last = -1;  // last valid point
  // CARRY: the carried committed slot, and the seam logp from it to slot j
  int committed = -1;
  float lp_committed = kNegInf;
  if constexpr (CARRY)
    score = seam_column<K, SPARSE, 16>(a, bb, j, gmask, first_break,
                                       committed, lp_committed, live);

  // the K scores of the current step gathered into s[]
  auto gather = [&]() {
#pragma unroll
    for (int i = 0; i < K; ++i) s[i] = __shfl_sync(0xffffffffu, score, i, K);
  };
  // point t's scores and flags kept for the aux pass
  auto keep = [&](int t, bool vt, bool last_slot_filled) {
    sbuf[(t & (kChunk - 1)) * K + j] = score;
    if (j == 0) vflag[t] = (int8_t)(vt | (last_slot_filled << 1));
    if (vt) last = t;
  };
  // the aux pass over points t0..t1 (one chunk): each lane takes every
  // K-th point, its local argmax and its part of the confidence aux from
  // its K scores; then lane 0 accumulates the parts in point order
  auto aux_pass = [&](int t0, int t1) {
    __syncwarp();
    for (int c = j; t0 + c <= t1; c += K) {
      float sr[K];
#pragma unroll
      for (int i = 0; i < K; ++i) sr[i] = sbuf[c * K + i];
      const int f = vflag[t0 + c];
      const PointAux p = point_aux<K>(sr, (f & 1) != 0, (f & 2) != 0);
      loc[t0 + c] = (int8_t)p.local;
      sbuf[c * K] = p.marg;  // row c is this lane's alone
      pflag[c] = (int8_t)(p.two | (p.exh << 1));
    }
    __syncwarp();
    if (j == 0) {
      for (int c = 0; t0 + c <= t1; ++c) {
        PointAux p;
        p.two = (pflag[c] & 1) != 0;
        p.exh = (pflag[c] & 2) != 0;
        p.marg = sbuf[c * K];
        ax.add(p);
      }
    }
    __syncwarp();
  };

  // the first spans' group (the oldest) has landed; the barrier makes the
  // other lanes' copies visible
  __pipeline_wait_prior(R::kDepth - 1);
  __syncwarp();
  bp[j] = -1;
  if (j == 0) brk_flag[0] = first_break && sc_span[0] != 0.f;
  keep(0, sc_span[0] != 0.f, __float_as_int(sc_span[2 * L.span]) >= 0);
  gather();
  if (T == 1) aux_pass(0, 0);
  float t_prev = SPARSE ? sc_span[3 * L.span] : 0.f;
  for (int t = 1; t < T; ++t) {
    // step t's groups have landed (kDepth - 2 later ones may be in
    // flight); the barrier makes the other lanes' copies visible
    __pipeline_wait_prior(R::kDepth - 2);
    __syncwarp();
    const float* lp =
        ring_lp + ((int64_t)(t % R::kDepth) * traces_per_block + g) * R::kLp;
    float l[K];
#pragma unroll
    for (int i = 0; i < K; ++i) l[i] = lp[i * K + j];
    const int h = t & (2 * kChunk - 1);
    const float e = em_span[h * K + j];
    const bool vt = sc_span[h] != 0.f;
    const float gct = sc_span[L.span + h];
    const bool last_filled = __float_as_int(sc_span[2 * L.span + h]) >= 0;
    const float t_now = SPARSE ? sc_span[3 * L.span + h] : 0.f;
    // refill the ring slot step t - 1 read and, every kChunk steps, the
    // span the last kChunk steps read (every lane is past them); a span is
    // read kChunk steps on, after its group
    if (t + R::kDepth - 1 < T) stage(t + R::kDepth - 1);
    if ((t & (kChunk - 1)) == 0 && t + kChunk < T) stage_span(t + kChunk);
    __pipeline_commit();

    float best = __fadd_rn(s[0], l[0]);
    int bi = 0;
#pragma unroll
    for (int i = 1; i < K; ++i) {
      const float tot = __fadd_rn(s[i], l[i]);
      if (tot > best) { best = tot; bi = i; }
    }
    const bool connected = best > kNegInf / 2;
    const bool any = (__ballot_sync(0xffffffffu, connected) & gmask) != 0u;
    float brk = a.brk;
    if constexpr (SPARSE) {
      brk = rtt::sparse_breakage(a.brk, a.sa, __fsub_rn(t_now, t_prev));
      t_prev = t_now;
    }
    // breakage: too far apart, or nothing connects
    const bool broke = gct > brk || !any;
    float ns = broke ? e : __fadd_rn(best, e);
    ns = vt ? ns : score;  // padding: freeze
    int bpv = (broke || !connected) ? -1 : bi;
    bpv = vt ? bpv : -2;  // -2 = padded step
    bp[(size_t)t * K + j] = (int8_t)bpv;
    if (j == 0) brk_flag[t] = broke && vt;
    score = ns;
    keep(t, vt, last_filled);
    gather();
    if ((t & (kChunk - 1)) == kChunk - 1 || t == T - 1)  // uniform
      aux_pass(t & ~(kChunk - 1), t);
  }
  __pipeline_wait_prior(0);
  __syncwarp();

  if (j == 0) {  // reverse walk; a padded or dead successor restarts at the local argmax
    int nxt = (loc[T - 1] >= 0 && (vflag[T - 1] & 1)) ? loc[T - 1] : -1;
    idx[T - 1] = (int8_t)nxt;
    // point t's and t + 1's flags in registers, the next point's read
    // before this one's store
    bool v_next = (vflag[T - 1] & 1) != 0;
    int l_t = T >= 2 ? loc[T - 2] : 0;
    bool v_t = T >= 2 && (vflag[T - 2] & 1) != 0;
    for (int t = T - 2; t >= 0; --t) {
      const int l_n = t > 0 ? loc[t - 1] : 0;
      const bool v_n = t > 0 && (vflag[t - 1] & 1) != 0;
      const int from_next = nxt >= 0 ? bp[(size_t)(t + 1) * K + nxt] : -1;
      int it = (v_next && nxt >= 0 && from_next >= 0) ? from_next : l_t;
      it = v_t ? it : -1;
      idx[t] = (int8_t)it;
      nxt = it;
      v_next = v_t;
      l_t = l_n;
      v_t = v_n;
    }
  }
  __syncwarp();

  if (a.choice && live) {  // the histogram's inputs: slot, and where it came from
    const int64_t plane = a.B * (int64_t)T;
    for (int t = j; t < T; t += K) {
      const int it = idx[t];
      a.choice[b * T + t] = it;
      a.choice[plane + b * T + t] = it >= 0 ? bp[(size_t)t * K + it] : -1;
    }
  }

  finish_trace<K, CARRY, 8>(a, bb, j, live, idx, brk_flag, ax, committed,
                            lp_committed, last, score, s);
}

// Traces spread over the SMs: blocks of 128 threads while the batch fills
// kSpread of them, else 64 or 32, so that a small batch (the long and
// sparse windows, 16-64 traces) runs on more SMs.
constexpr int64_t kSpread = 32;

template <int K, bool CARRY, bool SPARSE>
int launch(const ViterbiArgs& a, cudaStream_t stream) {
  static std::atomic<bool> opted[rtt::kMaxDevices];
  constexpr size_t kMaxSmem = 227 * 1024;
  int threads = 128;  // whole warps: 32 / K traces share one
  while (threads > 32 && (a.B * K + threads - 1) / threads < kSpread)
    threads /= 2;
  while (threads > 32 && Layout<K>(threads / K, a.T).total(threads / K) > kMaxSmem)
    threads /= 2;
  const size_t smem = Layout<K>(threads / K, a.T).total(threads / K);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above the default: opt in once per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= rtt::kMaxDevices || !opted[dev].load()) {
      e = cudaFuncSetAttribute(viterbi_kernel<K, CARRY, SPARSE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
      if (e != cudaSuccess) return (int)e;
      if (dev < rtt::kMaxDevices) opted[dev].store(true);
    }
  }
  const int64_t traces_per_block = threads / K;
  const int64_t blocks = (a.B + traces_per_block - 1) / traces_per_block;
  viterbi_kernel<K, CARRY, SPARSE><<<(unsigned)blocks, threads, smem,
                                     stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool CARRY, bool SPARSE>
int launch_k(int K, const ViterbiArgs& a, cudaStream_t s) {
  if (a.B <= 0 || a.T <= 0) return 0;
  switch (K) {
    case 1: return launch<1, CARRY, SPARSE>(a, s);
    case 2: return launch<2, CARRY, SPARSE>(a, s);
    case 4: return launch<4, CARRY, SPARSE>(a, s);
    case 8: return launch<8, CARRY, SPARSE>(a, s);
    case 16: return launch<16, CARRY, SPARSE>(a, s);
    case 32: return launch<32, CARRY, SPARSE>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The C entry points' arguments: kernel 4's, and kernel 5's (the carry
// in and out, the slab rows, the seam's table and parameters) in the
// order CHAIN_PARAMS lists them.
inline ViterbiArgs scan_args(const float* emis, const float* logp,
                             const float* gc, const float* valid,
                             const int32_t* cand_edge,
                             const float* cand_offset, int64_t B, int32_t T,
                             float brk, int32_t* packed, float* aux) {
  ViterbiArgs a = {};
  a.emis = emis;
  a.logp = logp;
  a.gc = gc;
  a.valid = valid;
  a.cand_edge = cand_edge;
  a.cand_offset = cand_offset;
  a.B = B;
  a.T = T;
  a.brk = brk;
  a.packed = packed;
  a.aux = aux;
  return a;
}

inline ViterbiArgs chain_args(
    const float* emis, const float* logp, const float* gc, const float* valid,
    const int32_t* cand_edge, const float* cand_offset, const float* px,
    const float* py, const float* times, const float* edge_rows,
    const int32_t* ubodt, int32_t bmask, int32_t wide,
    const int32_t* slot_map, const int32_t* arena, int32_t* counts,
    int64_t* totals, const float* seam_dist, const float* seam_time,
    int64_t B, int32_t T, float brk,
    float sigma, float beta, float radius, float max_route_factor,
    float max_time_factor, float turn_factor, const float* in_scores,
    const int32_t* in_edge, const float* in_offset, const float* in_x,
    const float* in_y, const float* in_t, const uint8_t* in_active,
    const int32_t* in_committed, float* out_scores, int32_t* out_edge,
    float* out_offset, float* out_x, float* out_y, float* out_t,
    uint8_t* out_active, int32_t* out_committed, const int32_t* slots,
    const uint8_t* use, int64_t S, int32_t* packed, float* aux) {
  ViterbiArgs a = {};
  a.emis = emis;
  a.logp = logp;
  a.gc = gc;
  a.valid = valid;
  a.cand_edge = cand_edge;
  a.cand_offset = cand_offset;
  a.B = B;
  a.T = T;
  a.brk = brk;
  a.packed = packed;
  a.aux = aux;
  a.px = px;
  a.py = py;
  a.times = times;
  a.edge_rows = edge_rows;
  a.ubodt = reinterpret_cast<const int4*>(ubodt);
  a.bmask = (uint32_t)bmask;
  a.wide = wide != 0;
  a.tier = {slot_map, reinterpret_cast<const int4*>(arena), counts,
            reinterpret_cast<unsigned long long*>(totals)};
  a.seam_dist = seam_dist;
  a.seam_time = seam_time;
  a.tp = {sigma, beta, radius, max_route_factor, max_time_factor,
          turn_factor};
  a.in = {in_scores, in_edge, in_offset, in_x, in_y, in_t, in_active,
          in_committed};
  a.out = {out_scores, out_edge, out_offset, out_x, out_y, out_t, out_active,
           out_committed};
  a.slots = slots;
  a.use = use;
  a.S = S;
  return a;
}

}  // namespace

#define CHAIN_PARAMS                                                         \
    const float *emis, const float *logp, const float *gc,                   \
    const float *valid, const int32_t *cand_edge, const float *cand_offset,  \
    const float *px, const float *py, const float *times,                    \
    const float *edge_rows, const int32_t *ubodt, int32_t bmask,             \
    int32_t wide, const int32_t *slot_map, const int32_t *arena,             \
    int32_t *counts, int64_t *totals, const float *seam_dist,                \
    const float *seam_time, int64_t B, int32_t T, int32_t K,                 \
    float brk, float sigma,                                                  \
    float beta, float radius,                                                \
    float max_route_factor, float max_time_factor, float turn_factor,        \
    const float *in_scores, const int32_t *in_edge, const float *in_offset,  \
    const float *in_x, const float *in_y, const float *in_t,                 \
    const uint8_t *in_active, const int32_t *in_committed,                   \
    float *out_scores, int32_t *out_edge, float *out_offset, float *out_x,   \
    float *out_y, float *out_t, uint8_t *out_active, int32_t *out_committed, \
    const int32_t *slots, const uint8_t *use, int64_t S, int32_t *packed,    \
    float *aux
#define CHAIN_ARGS                                                           \
    emis, logp, gc, valid, cand_edge, cand_offset, px, py, times, edge_rows, \
    ubodt, bmask, wide, slot_map, arena, counts, totals, seam_dist,          \
    seam_time, B, T, brk, sigma,                                             \
    beta, radius, max_route_factor,                                          \
    max_time_factor, turn_factor, in_scores, in_edge, in_offset, in_x, in_y, \
    in_t, in_active, in_committed, out_scores, out_edge, out_offset, out_x,  \
    out_y, out_t, out_active, out_committed, slots, use, S, packed, aux
