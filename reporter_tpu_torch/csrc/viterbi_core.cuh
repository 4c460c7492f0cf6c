// The per-trace Viterbi shared by kernel 4 (viterbi_scan.cu, a window
// that starts fresh) and kernel 5 (viterbi_chain.cu, a window that
// continues a carried beam).
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
// step.  Backpointers (int8), each step's local argmax and break flag stay
// in shared memory; the confidence aux accumulates during the forward
// pass.  Lane 0 of the group walks back; then the group writes the packed
// [3, B, T] output (edge, offset bits, break) and the [B, 4] aux.
//
// With CARRY, thread j first computes the seam column j: for each carried
// source slot i it probes the UBODT for (to(carry.edge[i]),
// from(cand.edge[0][j])) and applies the dense transition arithmetic
// (transition.cuh, the same roundings as kernel 3), then starts from the
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
  const int4* ubodt;         // [n_buckets, 32] int4
  uint32_t bmask;
  rtt::TransParams tp;
  rtt::SparseArgs sa;        // SPARSE only
  CarryPtrs in;
  CarryOutPtrs out;
  const int32_t* slots;      // [B] slab rows, or null: row b is carry row b
  const uint8_t* use;        // [B] with slots: read the slab row
  int64_t S;                 // slab rows
};

template <int K, bool CARRY, bool SPARSE>
__global__ void viterbi_kernel(const ViterbiArgs a) {
  extern __shared__ int8_t smem[];
  const int T = a.T;
  const int traces_per_block = blockDim.x / K;
  const int g = threadIdx.x / K;  // group (trace) within the block
  const int j = threadIdx.x % K;  // destination slot
  const int64_t b = (int64_t)blockIdx.x * traces_per_block + g;
  const bool live = b < a.B;
  // groups past B still run the loop (the shuffles need whole warps) on
  // trace 0's data, and write nothing
  const int64_t bb = live ? b : 0;
  int8_t* bp = smem + (size_t)g * T * (K + 3);  // backpointers [T][K]
  int8_t* loc = bp + (size_t)T * K;             // argmax per step, -1 dead
  int8_t* brk_flag = loc + T;                   // break per step
  int8_t* idx = brk_flag + T;                   // chosen slot per step

  const unsigned lane = threadIdx.x & 31;
  const unsigned gmask = (K == 32) ? 0xffffffffu
                                   : (((1u << K) - 1u) << (lane / K * K));
  const float* em = a.emis + bb * T * K;
  const float* vd = a.valid + bb * T;
  const int32_t* ce = a.cand_edge + bb * T * K;
  const float* co = a.cand_offset + bb * T * K;

  float amin = INFINITY, asum = 0.f, acnt = 0.f, aexh = 0.f;
  float s[K];
  float score = em[j];
  bool first_break = true;
  int last = -1;  // last valid point
  // CARRY: the carried committed slot, and the seam logp from it to slot j
  int committed = -1;
  float lp_committed = kNegInf;

  if constexpr (CARRY) {
    int64_t row = bb;
    if (a.slots) {
      const int64_t sl = a.slots[bb];
      row = a.use[bb] ? (sl < a.S ? sl : a.S - 1) : -1;
    }
    const bool active = row >= 0 && a.in.active[row] != 0;
    committed = row >= 0 ? a.in.committed[row] : -1;
    const float cx = row >= 0 ? a.in.x[row] : 0.f;
    const float cy = row >= 0 ? a.in.y[row] : 0.f;
    const float ct = row >= 0 ? a.in.t[row] : 0.f;
    const int64_t p0 = bb * T;
    const float gc0 = rtt::hypot_like_jax(__fsub_rn(a.px[p0], cx),
                                          __fsub_rn(a.py[p0], cy));
    const float dt0 = __fsub_rn(a.times[p0], ct);
    const int32_t eb = ce[j];
    const float ob = co[j];
    const float* erb = a.edge_rows + (int64_t)(eb >= 0 ? eb : 0) * 8;
    const int32_t from_b = __float_as_int(erb[1]);
    const int c = committed > 0 ? committed : 0;
    float best = 0.f;
    for (int i = 0; i < K; ++i) {
      const int32_t ea = row >= 0 ? a.in.edge[row * K + i] : -1;
      const float oa = row >= 0 ? a.in.offset[row * K + i] : 0.f;
      const float sc = row >= 0 ? a.in.scores[row * K + i] : kNegInf;
      const float* era = a.edge_rows + (int64_t)(ea >= 0 ? ea : 0) * 8;
      float sp_dist, sp_time;
      rtt::probe_serial(a.ubodt, a.bmask, __float_as_int(era[0]), from_b,
                        &sp_dist, &sp_time);
      const float lp = rtt::transition_logp<SPARSE>(
          ea, eb, oa, ob, era, erb, sp_dist, sp_time, gc0, dt0, a.tp, a.sa,
          nullptr);
      if (i == c) lp_committed = lp;
      const float tot = __fadd_rn(sc, lp);
      if (i == 0 || tot > best) best = tot;
    }
    const bool connected = best > kNegInf / 2;
    const bool any = (__ballot_sync(0xffffffffu, connected) & gmask) != 0u;
    const float brk0 = SPARSE ? rtt::sparse_breakage(a.brk, a.sa, dt0) : a.brk;
    // breakage: too far apart, nothing connects, or no live carry
    first_break = gc0 > brk0 || !any || !active;
    score = first_break ? em[j] : __fadd_rn(best, em[j]);
  }

  // the scores of step t gathered into s[], its local argmax recorded and
  // the confidence aux of the point accumulated
  auto record = [&](int t) {
#pragma unroll
    for (int i = 0; i < K; ++i) s[i] = __shfl_sync(0xffffffffu, score, i, K);
    float top1 = s[0];
    int am = 0;
#pragma unroll
    for (int i = 1; i < K; ++i)
      if (s[i] > top1) { top1 = s[i]; am = i; }
    float top2 = kNegInf;
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (i != am && s[i] > top2) top2 = s[i];
    const bool vt = vd[t] != 0.f;
    if (vt) last = t;
    if (j == 0) loc[t] = (int8_t)(top1 > kNegInf / 2 ? am : -1);
    if (top1 > kNegInf / 2 && top2 > kNegInf / 2 && vt) {
      const float marg = __fsub_rn(top1, top2);
      amin = marg < amin ? marg : amin;
      asum = __fadd_rn(asum, marg);
      acnt = __fadd_rn(acnt, 1.f);
    }
    if (vt && ce[(int64_t)t * K + K - 1] >= 0) aexh = __fadd_rn(aexh, 1.f);
  };

  bp[j] = -1;
  if (j == 0) brk_flag[0] = first_break && vd[0] != 0.f;
  record(0);
  for (int t = 1; t < T; ++t) {
    const float* lp = a.logp + ((bb * (T - 1) + (t - 1)) * K) * K;
    float best = __fadd_rn(s[0], lp[j]);
    int bi = 0;
#pragma unroll
    for (int i = 1; i < K; ++i) {
      const float tot = __fadd_rn(s[i], lp[i * K + j]);
      if (tot > best) { best = tot; bi = i; }
    }
    const bool connected = best > kNegInf / 2;
    const bool any = (__ballot_sync(0xffffffffu, connected) & gmask) != 0u;
    float brk = a.brk;
    if constexpr (SPARSE) {
      const float* tm = a.times + bb * T;
      brk = rtt::sparse_breakage(a.brk, a.sa, __fsub_rn(tm[t], tm[t - 1]));
    }
    // breakage: too far apart, or nothing connects
    const bool broke = a.gc[bb * (T - 1) + (t - 1)] > brk || !any;
    const float e = em[(int64_t)t * K + j];
    const bool vt = vd[t] != 0.f;
    float ns = broke ? e : __fadd_rn(best, e);
    ns = vt ? ns : score;  // padding: freeze
    int bpv = (broke || !connected) ? -1 : bi;
    bpv = vt ? bpv : -2;  // -2 = padded step
    bp[(size_t)t * K + j] = (int8_t)bpv;
    if (j == 0) brk_flag[t] = broke && vt;
    score = ns;
    record(t);
  }
  __syncwarp();

  if (j == 0) {  // reverse walk; a padded or dead successor restarts at the local argmax
    int nxt = (loc[T - 1] >= 0 && vd[T - 1] != 0.f) ? loc[T - 1] : -1;
    idx[T - 1] = (int8_t)nxt;
    for (int t = T - 2; t >= 0; --t) {
      const int from_next = nxt >= 0 ? bp[(size_t)(t + 1) * K + nxt] : -1;
      int it = (vd[t + 1] != 0.f && nxt >= 0 && from_next >= 0) ? from_next
                                                                  : loc[t];
      it = vd[t] != 0.f ? it : -1;
      idx[t] = (int8_t)it;
      nxt = it;
    }
  }
  __syncwarp();

  if constexpr (CARRY) {
    // seam check: the committed slot must reach the window's first
    // choice, else the seam is a break
    const int i0 = idx[0];
    if (j == i0 && committed >= 0 && !brk_flag[0] && vd[0] != 0.f &&
        !(lp_committed > kNegInf / 2))
      brk_flag[0] = 1;
    __syncwarp();
  }

  if (!live) return;
  const int64_t plane = a.B * (int64_t)T;
  for (int t = j; t < T; t += K) {
    const int it = idx[t];
    const int sel = it > 0 ? it : 0;
    const int64_t o = b * T + t;
    a.packed[o] = it >= 0 ? ce[(int64_t)t * K + sel] : -1;
    a.packed[plane + o] = __float_as_int(co[(int64_t)t * K + sel]);
    a.packed[2 * plane + o] = brk_flag[t];
  }
  if (j == 0) {
    a.aux[b * 4 + 0] = amin;
    a.aux[b * 4 + 1] = asum;
    a.aux[b * 4 + 2] = acnt;
    a.aux[b * 4 + 3] = aexh;
  }

  if constexpr (CARRY) {
    // carry-out at the last valid point; padded steps froze the scores,
    // so s[] (step T-1) is the beam there
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
}

template <int K, bool CARRY, bool SPARSE>
int launch(const ViterbiArgs& a, cudaStream_t stream) {
  // shared memory per trace: T*K backpointers + 3*T step bytes; shrink the
  // block (down to one warp) before asking for more than the default 48 KB
  const size_t per_trace = (size_t)a.T * (K + 3);
  int threads = 128;
  while (threads > 32 && (size_t)(threads / K) * per_trace > 48 * 1024)
    threads /= 2;
  const size_t smem = (size_t)(threads / K) * per_trace;
  if (smem > 48 * 1024) {
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_kernel<K, CARRY, SPARSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
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

}  // namespace
