// The log-depth (assoc) Viterbi forward: kernels 4 and 5 with the
// sequential recursion replaced by the reference's associative scan.
// viterbi_assoc_launch is a window that starts fresh (kernel 4's ABI),
// viterbi_chain_assoc_launch one that continues a carried beam, in
// [B]-leading rows or in the session slab (kernel 5's ABI, the slab
// gather, select and scatter fused as there); each has a SPARSE
// instantiation (the per-step gap-conditioned breakage, the sparse seam).
// Every entry point also takes a global workspace (the wrapper's
// ``_assoc_workspace``).  Windows of T < 2 launch kernels 4 and 5: the
// reference runs the scan there.
//
// Replaces reporter_tpu/ops/viterbi.py:674 _forward_assoc and :740
// backtrace_assoc, as chain_trace (:447) calls them with kernel="assoc"
// (:511-534), with the seam, seam check, carry-out, compact gather,
// confidence block and pack_compact of kernels 4 and 5
// (viterbi_core.cuh's seam_column, point_aux and finish_trace).
//
// What it computes, per trace of T points (n = T-1 steps):
//   1. the alive-support recursion (:689-702): which slots are alive
//      after each step, and which steps break (too far apart, or nothing
//      alive connects); serial in T over K-bit masks, exact;
//   2. the segmented tropical affine maps f_t(s) = flag_t ? c_t : s (x)
//      M_t with M_t[i][j] = logp_t[i][j] + emis[t+1][j] (padded steps the
//      identity: 0 on the diagonal, -1e30 off it) and c_t = emis[t+1]
//      where the step breaks (:704-711);
//   3. their inclusive prefix scan in jax.lax.associative_scan's pairing
//      order (:713-720): each combine entry max_k(Ma[i][k] + Mb[k][j])
//      rounds once per add, so the pairing fixes the bits, and a
//      Hillis-Steele or Blelloch tree would give others;
//   4. the scores max_i(init[i] + P_t[i][j]), init added last (:721-722);
//   5. backpointers from the prefix scores, first maximum (:724-737);
//   6. the backtrace as a reverse composition of [K+1] slot maps (:740).
//
// What bounds it: the scan does O(T K^3) adds and compares at O(log T)
// depth (the sequential kernels O(T K^2) at O(T) depth), ~2K times the
// scan kernel's work; its inputs are kernel 4's (logp dominates: [B, T-1,
// K, K] floats), read once, which on paper bounds it at the main path's
// shapes.  In practice latency does: ~4 log2(T) block-wide steps, each
// entry waiting on 2K loads from L2, and the serial alive recursion.
//
// Design: one block of 256 threads per trace.  The levels of the scan
// live in the global workspace (at K = 16, T = 256: 2(T-1) maps of 1 KB
// per trace, too many for shared memory): level 0 holds the n maps,
// level l+1 the pairwise combines of level l.  The up-sweep builds the
// levels; the down-sweep forms each level's prefixes in place: the
// prefix at an even position 2i >= 2 is combine(prefix[i-1] of the level
// above, the element at 2i), written over the consumed odd slot 2i-1;
// the prefix at an odd position is the level above's, where it lies.
// One thread per output entry, a __syncthreads between levels.  The
// alive recursion runs on warp 0 (one ballot a step) from feasibility
// masks staged in shared memory; the backtrace composes int8 maps by
// pointer doubling (exact, so any order gives the reference's result).

#include "viterbi_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;

// elements of all levels over n maps (the wrapper's _assoc_levels sum)
__host__ __device__ __forceinline__ int64_t assoc_elements(int n) {
  int64_t total = n;
  while (n >= 2) {
    n /= 2;
    total += n;
  }
  return total;
}

struct AssocShared {
  uint32_t* feas;   // [n][K] sources feasible into each destination
  uint32_t* ealive; // [T] slots whose emission is alive
  float* init;      // [K] the scores at t = 0
  float* marg;      // [T] point margins
  int* off;         // [kMaxLevels] first element of each level
  int* cnt;         // [kMaxLevels] elements of each level
  uint8_t* flags;   // [E] restart flag of each element
  uint8_t* hard;    // [n] step too long (bit 0), step t+1 valid (bit 1)
  uint8_t* broke;   // [n] step t+1 breaks
  uint8_t* pflags;  // [T] two alive (bit 0), pool exhausted (bit 1)
  int8_t* loc;      // [T] local argmax, -1 all dead
  int8_t* brk_flag; // [T] break flags of the packed output
  int8_t* idx;      // [T] chosen slots
  int8_t* maps;     // 2 x [n][K+1] backtrace maps
  int* first_break; // [1]
};

template <int K>
__host__ __device__ __forceinline__ size_t assoc_smem(int T, AssocShared* sh,
                                                      uint8_t* base) {
  const int n = T - 1;
  const int64_t E = assoc_elements(n);
  size_t o = 0;
  auto take = [&](size_t bytes, size_t align) {
    o = (o + align - 1) / align * align;
    uint8_t* p = base ? base + o : nullptr;
    o += bytes;
    return p;
  };
  uint8_t* feas = take((size_t)n * K * 4, 16);
  uint8_t* ealive = take((size_t)T * 4, 4);
  uint8_t* init = take(K * 4, 4);
  uint8_t* marg = take((size_t)T * 4, 4);
  uint8_t* off = take(kMaxLevels * 4, 4);
  uint8_t* cnt = take(kMaxLevels * 4, 4);
  uint8_t* fb = take(4, 4);
  uint8_t* flags = take((size_t)E, 1);
  uint8_t* hard = take((size_t)n, 1);
  uint8_t* broke = take((size_t)n, 1);
  uint8_t* pflags = take((size_t)T, 1);
  uint8_t* loc = take((size_t)T, 1);
  uint8_t* brk = take((size_t)T, 1);
  uint8_t* idx = take((size_t)T, 1);
  uint8_t* maps = take((size_t)2 * n * (K + 1), 1);
  if (sh) {
    sh->feas = (uint32_t*)feas;
    sh->ealive = (uint32_t*)ealive;
    sh->init = (float*)init;
    sh->marg = (float*)marg;
    sh->off = (int*)off;
    sh->cnt = (int*)cnt;
    sh->first_break = (int*)fb;
    sh->flags = flags;
    sh->hard = hard;
    sh->broke = broke;
    sh->pflags = pflags;
    sh->loc = (int8_t*)loc;
    sh->brk_flag = (int8_t*)brk;
    sh->idx = (int8_t*)idx;
    sh->maps = (int8_t*)maps;
  }
  return o;
}

// One output entry r of combine(A, B) (A the earlier element): r < K*K
// the map entry (i, j) = max_k A[i][k] + B[k][j]; else the restart
// vector's entry j = B's restart flag ? B.c[j] : max_k A.c[k] + B[k][j].
// Elements are [K*K] maps followed by [K] vectors.
template <int K>
__device__ __forceinline__ void combine_entry(const float* A, const float* B,
                                              bool fb, int r, float* out) {
  constexpr int KK = K * K;
  const float* a;
  int j;
  if (r < KK) {
    a = A + (r / K) * K;
    j = r % K;
  } else {
    j = r - KK;
    if (fb) {
      out[r] = B[KK + j];
      return;
    }
    a = A + KK;
  }
  float v = __fadd_rn(a[0], B[j]);
#pragma unroll
  for (int k = 1; k < K; ++k) {
    const float x = __fadd_rn(a[k], B[k * K + j]);
    v = x > v ? x : v;
  }
  out[r] = v;
}

// Where the inclusive prefix of element t of level l lies after the
// down-sweep: position 0 is the level's own first element, an even
// position t >= 2 was written over slot t-1, and an odd one is the
// prefix of position (t-1)/2 of the level above.
__device__ __forceinline__ int prefix_slot(const int* off, int l, int t) {
  while (t & 1) {
    t = (t - 1) >> 1;
    ++l;
  }
  return off[l] + (t ? t - 1 : 0);
}

template <int K, bool CARRY, bool SPARSE>
__global__ void __launch_bounds__(kThreads)
viterbi_assoc_kernel(const ViterbiArgs a, float* ws) {
  extern __shared__ __align__(16) uint8_t assoc_buf[];
  constexpr int KK = K * K;
  constexpr int EL = KK + K;  // floats per element
  const int T = a.T;
  const int n = T - 1;
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  AssocShared sh;
  assoc_smem<K>(T, &sh, assoc_buf);

  const float* em = a.emis + b * T * K;
  const float* lp = a.logp + b * (int64_t)n * KK;
  const float* gc = a.gc + b * n;
  const float* vd = a.valid + b * T;
  const int32_t* ce = a.cand_edge + b * T * K;
  const int64_t E = assoc_elements(n);
  float* lv = ws + b * (E * EL + (int64_t)T * K);  // the levels
  float* S = lv + E * EL;                           // [T][K] scores

  // warp 0: the scores at t = 0, from the carried beam through the seam
  // (every group of K lanes computes the trace's seam) or the emissions
  const int j = lane % K;
  int committed = -1;
  float lp_committed = kNegInf;
  if (tid < 32) {
    bool first_break = true;
    float score = em[j];
    if constexpr (CARRY) {
      const unsigned gmask = (K == 32) ? 0xffffffffu
                                       : (((1u << K) - 1u) << (lane / K * K));
      // every group of K lanes repeats the trace's seam; the first counts
      score = seam_column<K, SPARSE>(a, b, j, gmask, first_break, committed,
                                     lp_committed, lane < K);
    }
    if (lane < K) {
      sh.init[lane] = score;
      S[lane] = score;
    }
    if (lane == 0) {
      sh.first_break[0] = first_break;
      int o = 0, c = n, l = 0;
      for (;;) {  // the levels' sizes and offsets
        sh.off[l] = o;
        sh.cnt[l] = c;
        if (c < 2) break;
        o += c;
        c /= 2;
        ++l;
      }
    }
  }

  // level 0's maps, the feasibility and emission-alive masks, the steps'
  // hard breaks
  for (int w = tid; w < n * KK; w += kThreads) {
    const int t = w / KK, r = w % KK, i = r / K, jj = r % K;
    lv[(int64_t)t * EL + r] =
        vd[t + 1] != 0.f ? __fadd_rn(lp[w], em[(t + 1) * K + jj])
                         : (i == jj ? 0.f : kNegInf);
  }
  for (int w = tid; w < n * K; w += kThreads) {
    const int t = w / K, jj = w % K;
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < K; ++i)
      m |= (uint32_t)(lp[(int64_t)t * KK + i * K + jj] > kNegInf / 2) << i;
    sh.feas[w] = m;
  }
  for (int t = tid; t < T; t += kThreads) {
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) m |= (uint32_t)(em[t * K + i] > kNegInf / 2) << i;
    sh.ealive[t] = m;
  }
  for (int t = tid; t < n; t += kThreads) {
    float brk = a.brk;
    if constexpr (SPARSE) {
      const float* tm = a.times + b * T;
      brk = rtt::sparse_breakage(a.brk, a.sa, __fsub_rn(tm[t + 1], tm[t]));
    }
    sh.hard[t] = (uint8_t)((gc[t] > brk) | ((vd[t + 1] != 0.f) << 1));
  }
  __syncthreads();

  // the alive-support recursion on warp 0: a step breaks when too long or
  // when no alive source reaches any destination; then the alive set is
  // the alive emissions (restart) or those reached; padding freezes it
  if (tid < 32) {
    const bool lk = lane < K;
    uint32_t alive = __ballot_sync(0xffffffffu, lk && sh.init[j] > kNegInf / 2);
    for (int t = 0; t < n; ++t) {
      const uint32_t f = lk ? sh.feas[t * K + lane] : 0u;
      const uint32_t conn = __ballot_sync(0xffffffffu, (alive & f) != 0u);
      const int h = sh.hard[t];
      const bool brk = (h & 1) || conn == 0u;
      const uint32_t ea = sh.ealive[t + 1];
      if (h & 2) alive = brk ? ea : (conn & ea);
      if (lane == 0) {
        sh.broke[t] = brk;
        sh.flags[t] = brk && (h & 2);
      }
    }
  }
  __syncthreads();
  for (int w = tid; w < n * K; w += kThreads) {
    const int t = w / K, jj = w % K;
    lv[(int64_t)t * EL + KK + jj] = sh.flags[t] ? em[(t + 1) * K + jj] : kNegInf;
  }
  __syncthreads();

  // up-sweep: level l+1 element e = combine(level l elements 2e, 2e+1)
  int levels = 0;
  while (sh.cnt[levels] >= 2) {
    const int o = sh.off[levels], o1 = sh.off[levels + 1];
    const int m = sh.cnt[levels] / 2;
    for (int w = tid; w < m * EL; w += kThreads) {
      const int e = w / EL, r = w % EL;
      combine_entry<K>(lv + (int64_t)(o + 2 * e) * EL,
                       lv + (int64_t)(o + 2 * e + 1) * EL,
                       sh.flags[o + 2 * e + 1], r, lv + (int64_t)(o1 + e) * EL);
    }
    for (int e = tid; e < m; e += kThreads)
      sh.flags[o1 + e] = sh.flags[o + 2 * e] | sh.flags[o + 2 * e + 1];
    ++levels;
    __syncthreads();
  }

  // down-sweep: at each level, the prefix at even position t >= 2 is
  // combine(the level above's prefix at t/2 - 1, element t), into slot t-1
  for (int l = levels - 1; l >= 0; --l) {
    const int o = sh.off[l];
    const int m = (sh.cnt[l] - 1) / 2;  // even positions 2 .. cnt-1
    for (int w = tid; w < m * EL; w += kThreads) {
      const int t = 2 * (w / EL + 1), r = w % EL;
      const int pa = prefix_slot(sh.off, l + 1, t / 2 - 1);
      combine_entry<K>(lv + (int64_t)pa * EL, lv + (int64_t)(o + t) * EL,
                       sh.flags[o + t], r, lv + (int64_t)(o + t - 1) * EL);
    }
    for (int i = tid; i < m; i += kThreads) {
      const int t = 2 * (i + 1);
      sh.flags[o + t - 1] =
          sh.flags[prefix_slot(sh.off, l + 1, t / 2 - 1)] | sh.flags[o + t];
    }
    __syncthreads();
  }

  // the scores: the prefix's restart vector where it restarts, else
  // max_i init[i] + P[i][j], init added last
  for (int w = tid; w < n * K; w += kThreads) {
    const int t = w / K, jj = w % K;
    const int ps = prefix_slot(sh.off, 0, t);
    const float* P = lv + (int64_t)ps * EL;
    float v;
    if (sh.flags[ps]) {
      v = P[KK + jj];
    } else {
      v = __fadd_rn(sh.init[0], P[jj]);
#pragma unroll
      for (int i = 1; i < K; ++i) {
        const float x = __fadd_rn(sh.init[i], P[i * K + jj]);
        v = x > v ? x : v;
      }
    }
    S[(t + 1) * K + jj] = v;
  }
  __syncthreads();

  // per point: the local argmax and the confidence aux terms
  for (int t = tid; t < T; t += kThreads) {
    float s[K];
#pragma unroll
    for (int i = 0; i < K; ++i) s[i] = S[t * K + i];
    const PointAux p = point_aux<K>(s, vd[t] != 0.f, ce[t * K + K - 1] >= 0);
    sh.loc[t] = (int8_t)p.local;
    sh.marg[t] = p.marg;
    sh.pflags[t] = (uint8_t)(p.two | (p.exh << 1));
  }
  __syncthreads();

  // backpointers of step t+1 from the prefix scores at t (first maximum)
  // straight into the backtrace's maps: slot n in 0..K-1 chosen at t+1
  // (slot K: none) -> the slot at t
  int8_t* mp = sh.maps;
  for (int w = tid; w < n * (K + 1); w += kThreads) {
    const int t = w / (K + 1), jj = w % (K + 1);
    int v = sh.loc[t];
    if (jj < K && vd[t + 1] != 0.f && !sh.broke[t]) {
      const float* prev = S + t * K;
      const float* l = lp + (int64_t)t * KK + jj;
      float best = __fadd_rn(prev[0], l[0]);
      int bi = 0;
#pragma unroll
      for (int i = 1; i < K; ++i) {
        const float x = __fadd_rn(prev[i], l[i * K]);
        if (x > best) {
          best = x;
          bi = i;
        }
      }
      if (best > kNegInf / 2) v = bi;
    }
    mp[w] = (int8_t)(vd[t] != 0.f ? v : -1);
  }
  __syncthreads();

  // the suffix compositions by pointer doubling: after the pass with
  // stride d, map t is map_t o ... o map_{t+2d-1}
  int8_t* cur = mp;
  int8_t* nxt = mp + n * (K + 1);
  for (int d = 1; d < n; d *= 2) {
    for (int w = tid; w < n * (K + 1); w += kThreads) {
      const int t = w / (K + 1), m = w % (K + 1);
      int v = cur[w];
      if (t + d < n) {
        const int u = cur[(t + d) * (K + 1) + m];
        v = cur[t * (K + 1) + (u >= 0 ? u : K)];
      }
      nxt[w] = (int8_t)v;
    }
    int8_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
    __syncthreads();
  }

  // chosen slots and break flags
  const int last_idx = (sh.loc[n] >= 0 && vd[n] != 0.f) ? sh.loc[n] : -1;
  for (int t = tid; t < T; t += kThreads) {
    sh.idx[t] = (int8_t)(t == n ? last_idx
                                : cur[t * (K + 1) + (last_idx >= 0 ? last_idx : K)]);
    const bool brk = t == 0 ? sh.first_break[0] != 0 : sh.broke[t - 1] != 0;
    sh.brk_flag[t] = (int8_t)(brk && vd[t] != 0.f);
  }
  __syncthreads();

  // warp 0: the seam check, the packed output, aux, carry-out
  if (tid < 32) {
    Aux ax;
    int last = -1;
    if (lane == 0) {
      for (int t = 0; t < T; ++t) {
        const int pf = sh.pflags[t];
        PointAux p;
        p.two = pf & 1;
        p.exh = pf & 2;
        p.marg = sh.marg[t];
        ax.add(p);
        if (vd[t] != 0.f) last = t;
      }
    }
    last = __shfl_sync(0xffffffffu, last, 0);
    float s[K];
#pragma unroll
    for (int i = 0; i < K; ++i) s[i] = S[n * K + i];
    finish_trace<K, CARRY>(a, b, j, lane < K, sh.idx, sh.brk_flag, ax,
                           committed, lp_committed, last, s[j], s);
  }
}

template <int K, bool CARRY, bool SPARSE>
int assoc_launch(const ViterbiArgs& a, float* ws, cudaStream_t stream) {
  if (a.T < 2) return (int)cudaErrorInvalidValue;  // T < 2 runs kernels 4/5
  const size_t smem = assoc_smem<K>(a.T, nullptr, nullptr);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_assoc_kernel<K, CARRY, SPARSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  viterbi_assoc_kernel<K, CARRY, SPARSE><<<(unsigned)a.B, kThreads, smem,
                                           stream>>>(a, ws);
  return (int)cudaGetLastError();
}

template <bool CARRY, bool SPARSE>
int launch_assoc(int K, const ViterbiArgs& a, float* ws, cudaStream_t s) {
  if (a.B <= 0) return 0;
  switch (K) {
    case 1: return assoc_launch<1, CARRY, SPARSE>(a, ws, s);
    case 2: return assoc_launch<2, CARRY, SPARSE>(a, ws, s);
    case 4: return assoc_launch<4, CARRY, SPARSE>(a, ws, s);
    case 8: return assoc_launch<8, CARRY, SPARSE>(a, ws, s);
    case 16: return assoc_launch<16, CARRY, SPARSE>(a, ws, s);
    case 32: return assoc_launch<32, CARRY, SPARSE>(a, ws, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Kernel 4's arguments, then the workspace.
extern "C" int viterbi_assoc_launch(const float* emis, const float* logp,
                                    const float* gc, const float* valid,
                                    const int32_t* cand_edge,
                                    const float* cand_offset, int64_t B,
                                    int32_t T, int32_t K, float brk,
                                    int32_t* packed, float* aux, float* ws,
                                    void* stream) {
  const ViterbiArgs a = scan_args(emis, logp, gc, valid, cand_edge,
                                  cand_offset, B, T, brk, packed, aux);
  return launch_assoc<false, false>(K, a, ws, (cudaStream_t)stream);
}

// Kernel 4's sparse arguments: the dense ones, the workspace, then times
// [B, T] and the sparse model's six scalars.
extern "C" int viterbi_assoc_sparse_launch(
    const float* emis, const float* logp, const float* gc, const float* valid,
    const int32_t* cand_edge, const float* cand_offset, int64_t B, int32_t T,
    int32_t K, float brk, int32_t* packed, float* aux, float* ws,
    const float* times, float beta_ref, float beta_scale, float beta_max,
    float break_speed, float vmax, float plaus_weight, void* stream) {
  ViterbiArgs a = scan_args(emis, logp, gc, valid, cand_edge, cand_offset, B,
                            T, brk, packed, aux);
  a.times = times;
  a.sa = {beta_ref, beta_scale, beta_max, break_speed, vmax, plaus_weight};
  return launch_assoc<false, true>(K, a, ws, (cudaStream_t)stream);
}

// Kernel 5's arguments, then the workspace.
extern "C" int viterbi_chain_assoc_launch(CHAIN_PARAMS, float* ws,
                                          void* stream) {
  const ViterbiArgs a = chain_args(CHAIN_ARGS);
  return launch_assoc<true, false>(K, a, ws, (cudaStream_t)stream);
}

// Kernel 5's arguments, the workspace, then the sparse model's six
// scalars.
extern "C" int viterbi_chain_assoc_sparse_launch(
    CHAIN_PARAMS, float* ws, float beta_ref, float beta_scale, float beta_max,
    float break_speed, float vmax, float plaus_weight, void* stream) {
  ViterbiArgs a = chain_args(CHAIN_ARGS);
  a.sa = {beta_ref, beta_scale, beta_max, break_speed, vmax, plaus_weight};
  return launch_assoc<true, true>(K, a, ws, (cudaStream_t)stream);
}

extern "C" const char* viterbi_assoc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
