// The log-depth (assoc) Viterbi forward: kernels 4 and 5 with the
// sequential recursion replaced by the reference's associative scan.
// viterbi_assoc_launch is a window that starts fresh (kernel 4's ABI),
// viterbi_chain_assoc_launch one that continues a carried beam, in
// [B]-leading rows or in the session slab (kernel 5's ABI, the slab
// gather, select and scatter fused as there); each has a SPARSE
// instantiation (the per-step gap-conditioned breakage, the sparse seam).
// Every entry point also takes a global workspace, used only where the
// scan's levels do not fit in shared memory (viterbi_assoc_workspace
// sizes it; the wrapper's ``_assoc_workspace``).  Windows of T < 2 launch
// kernels 4 and 5: the reference runs the scan there.
//
// Replaces reporter_tpu/ops/viterbi.py:674 _forward_assoc and :740
// backtrace_assoc, as chain_trace (:447) calls them with kernel="assoc"
// (:511-534), with the seam, seam check, carry-out, compact gather,
// confidence block and pack_compact of kernels 4 and 5 (viterbi_core.cuh's
// seam_row / seam_dst / seam_logp, point_aux and carry_out).
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
// depth; its inputs are kernel 4's (logp dominates: [B, T-1, K, K]
// floats), read once, which on paper bounds it at the main path's shapes.
// In practice latency does: ~2 log2(T) dependent levels, the serial alive
// recursion and, with CARRY, the seam's UBODT probes.
//
// Design: one block per trace (128-512 threads, by the size of the scan's
// first level).  A combine (fa|fb, Ma (x) Mb, fb ? cb : ca (x) Mb) splits
// in two: the [K, K] map part never reads a flag or a restart vector; only
// the [K] restart part and the flags depend on the alive recursion.  So:
//   - staging: level 0's maps M_t from logp and emis (coalesced loads, 16
//     a lane in flight), the feasibility masks from the same loads by
//     ballot, the emissions a restart would take, per point the alive
//     emissions and the valid and last-slot flags; with CARRY the seam's
//     K*K UBODT probes and transitions, one thread an entry, all at once;
//   - warp 0 runs what is serial (the seam's reduction in source order,
//     then the alive recursion, one ballot a step, 32 steps' flags held in
//     registers) while the other warps run the maps' up-sweep (level l+1
//     element e = level l elements 2e (x) 2e+1; each thread a 4 x 4 tile
//     of a map, 2 x 4 at K = 16, 16-byte loads, K adds and compares an
//     entry in combine order; named barrier 1 between levels);
//   - the restart pass, block-wide: the up- and down-sweep of the [K]
//     vectors and flags, in place as jax pairs them (the prefix at an even
//     position t >= 2 written over the consumed odd slot t-1), and beside
//     each level of its down-sweep the maps' down-sweep of the level above
//     (the prefix at an even position t >= 2 is the level above's prefix
//     at t/2 - 1 (x) element t, kept apart in a prefix array, since the
//     restart pass reads the elements), only for the positions that
//     points before the first restart read;
//   - level 0's prefixes at the even positions before the first restart,
//     formed into the consumed odd slots; then the scores: from the first
//     restart on the prefix's restart vector, before it max_i(init[i] +
//     P_t[i][j]).
// The levels, their prefixes and vectors live in shared memory when they
// fit with the rest (K = 8 up to T = 256, K = 16 up to T = 64, K = 32 up
// to T = 16), else in the global workspace (L2) with the same layout;
// every other array always in shared memory.  The tails are parallel:
// each point's aux part and argmax, the backpointers, the backtrace by
// pointer doubling (exact, so any order gives the reference's result) and
// the packed output a thread a point; the aux sums in point order on warp
// 0 from values broadcast by shuffle.

#include <type_traits>

#include "viterbi_core.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxLevels = 32;
constexpr size_t kMaxSmem = 227 * 1024;

// The scan's shape over n maps: levels of n, n/2, ... (down to 1), E
// elements in all, P stored prefixes (the even positions >= 2 of every
// level above the first).
struct Levels {
  int count, E, P;
};

__host__ __device__ __forceinline__ Levels count_levels(int n) {
  Levels v{0, 0, 0};
  for (int c = n;; c /= 2) {
    v.E += c;
    if (v.count > 0) v.P += (c - 1) / 2;
    ++v.count;
    if (c < 2) break;
  }
  return v;
}

// A map tile: TI x TJ entries (2 x 4 at K = 16, where a short window's
// levels have few maps and more tiles keep more threads busy), PER tiles
// a map; ES floats a stored map
// (padded by 16 bytes from K = 4, so that the maps two threads of a warp
// combine start in different shared-memory banks).
template <int K>
struct Tile {
  static constexpr int TI = K < 4 ? K : K == 16 ? 2 : 4;
  static constexpr int TJ = K < 4 ? K : 4;
  static constexpr int PER = (K / TI) * (K / TJ);
  static constexpr int ES = K * K + (K >= 4 ? 4 : 0);
};

// floats of the levels' storage: maps [E][ES], prefixes [P][ES], restart
// vectors [E][K] (a multiple of 4, so that each trace's part stays 16-byte
// aligned in the global workspace)
template <int K>
__host__ __device__ __forceinline__ int64_t level_floats(int n) {
  const Levels v = count_levels(n);
  return ((int64_t)(v.E + v.P) * Tile<K>::ES + (int64_t)v.E * K + 3) & ~(int64_t)3;
}

struct AssocShared {
  float* lv;         // maps [E][ES], prefixes [P][ES], vectors [E][K]
  uint32_t* feas;    // [n][K] sources feasible into each destination
  uint32_t* ealive;  // [T] slots whose emission is alive
  float* init;       // [K] the scores at t = 0
  float* S;          // [T][K] the scores (prop, then the selected scores)
  float* marg;       // [T] point margins
  float* seam_tot;   // CARRY [K][K] carried score + seam logp, i -> j
  float* seam_lp;    // CARRY [K][K] seam logp
  int* off;          // [kMaxLevels] first element of each level
  int* cnt;          // [kMaxLevels] elements of each level
  int* poff;         // [kMaxLevels] first stored prefix of each level
  int* misc;         // [0] first break, [1] carried chosen slot, [2] first restart
  uint8_t* flags;    // [E] restart flag of each element (in place: prefixes)
  uint8_t* hard;     // [n] step too long (bit 0), step t+1 valid (bit 1)
  uint8_t* broke;    // [n] step t+1 breaks
  uint8_t* pflags;   // [T] two alive (bit 0), pool exhausted (bit 1)
  uint8_t* vflag;    // [T] valid (bit 0), last candidate slot filled (bit 1)
  int8_t* loc;       // [T] local argmax, -1 all dead
  int8_t* idx;       // [T] chosen slots
  int8_t* maps;      // 2 x [n][K+1] backtrace maps
};

// The dynamic shared memory of a trace of T points (the levels included
// when ``levels``), and with ``sh`` the arrays' addresses from ``base``.
template <int K, bool CARRY>
__host__ __device__ __forceinline__ size_t assoc_smem(int T, bool levels,
                                                      AssocShared* sh,
                                                      uint8_t* base) {
  const int n = T - 1;
  const Levels v = count_levels(n);
  size_t o = 0;
  auto take = [&](size_t bytes, size_t align) {
    o = (o + align - 1) / align * align;
    uint8_t* p = base ? base + o : nullptr;
    o += bytes;
    return p;
  };
  uint8_t* lv = levels ? take((size_t)level_floats<K>(n) * 4, 16) : nullptr;
  uint8_t* feas = take((size_t)n * K * 4, 16);
  uint8_t* ealive = take((size_t)T * 4, 4);
  uint8_t* init = take(K * 4, 4);
  uint8_t* S = take((size_t)T * K * 4, 16);
  uint8_t* marg = take((size_t)T * 4, 4);
  uint8_t* seam = take(CARRY ? (size_t)2 * K * K * 4 : 0, 4);
  uint8_t* off = take(kMaxLevels * 4, 4);
  uint8_t* cnt = take(kMaxLevels * 4, 4);
  uint8_t* poff = take(kMaxLevels * 4, 4);
  uint8_t* misc = take(3 * 4, 4);
  uint8_t* flags = take((size_t)v.E, 1);
  uint8_t* hard = take((size_t)n, 1);
  uint8_t* broke = take((size_t)n, 1);
  uint8_t* pflags = take((size_t)T, 1);
  uint8_t* vflag = take((size_t)T, 1);
  uint8_t* loc = take((size_t)T, 1);
  uint8_t* idx = take((size_t)T, 1);
  uint8_t* maps = take((size_t)2 * n * (K + 1), 1);
  if (sh) {
    sh->lv = (float*)lv;
    sh->feas = (uint32_t*)feas;
    sh->ealive = (uint32_t*)ealive;
    sh->init = (float*)init;
    sh->S = (float*)S;
    sh->marg = (float*)marg;
    sh->seam_tot = (float*)seam;
    sh->seam_lp = (float*)seam + K * K;
    sh->off = (int*)off;
    sh->cnt = (int*)cnt;
    sh->poff = (int*)poff;
    sh->misc = (int*)misc;
    sh->flags = flags;
    sh->hard = hard;
    sh->broke = broke;
    sh->pflags = pflags;
    sh->vflag = vflag;
    sh->loc = (int8_t*)loc;
    sh->idx = (int8_t*)idx;
    sh->maps = (int8_t*)maps;
  }
  return o;
}

// Whether a trace of T points keeps its levels in shared memory, and
// the dynamic shared memory it takes.
template <int K, bool CARRY>
__host__ __forceinline__ size_t assoc_bytes(int T, bool* levels) {
  const size_t with = assoc_smem<K, CARRY>(T, true, nullptr, nullptr);
  *levels = with <= kMaxSmem;
  return *levels ? with : assoc_smem<K, CARRY>(T, false, nullptr, nullptr);
}

template <int I>
__device__ __forceinline__ float lane4(const float4& v) {
  return I == 0 ? v.x : I == 1 ? v.y : I == 2 ? v.z : v.w;
}

// Tile ``tile`` of C = A (x) B: C[i][j] = max_k A[i][k] + B[k][j], k
// ascending, the first sum kept unless a later one is greater (one
// rounding per add: the reference's combine, entry by entry).
template <int K>
__device__ __forceinline__ void map_tile(const float* A, const float* B,
                                         float* C, int tile) {
  using Tl = Tile<K>;
  const int i0 = tile / (K / Tl::TJ) * Tl::TI;
  const int j0 = tile % (K / Tl::TJ) * Tl::TJ;
  float acc[Tl::TI][Tl::TJ];
  if constexpr (K >= 4) {
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 4) {
      float4 a4[Tl::TI], b4[4];
#pragma unroll
      for (int ii = 0; ii < Tl::TI; ++ii)
        a4[ii] = *reinterpret_cast<const float4*>(A + (i0 + ii) * K + k0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        b4[kk] = *reinterpret_cast<const float4*>(B + (k0 + kk) * K + j0);
      auto step = [&](auto kk_c) {
        constexpr int kk = decltype(kk_c)::value;
#pragma unroll
        for (int ii = 0; ii < Tl::TI; ++ii) {
          const float av = lane4<kk>(a4[ii]);
          const float x[4] = {__fadd_rn(av, b4[kk].x), __fadd_rn(av, b4[kk].y),
                              __fadd_rn(av, b4[kk].z), __fadd_rn(av, b4[kk].w)};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[ii][jj] = (k0 + kk == 0 || x[jj] > acc[ii][jj]) ? x[jj]
                                                                : acc[ii][jj];
        }
      };
      step(std::integral_constant<int, 0>());
      step(std::integral_constant<int, 1>());
      step(std::integral_constant<int, 2>());
      step(std::integral_constant<int, 3>());
    }
#pragma unroll
    for (int ii = 0; ii < Tl::TI; ++ii)
      *reinterpret_cast<float4*>(C + (i0 + ii) * K + j0) =
          make_float4(acc[ii][0], acc[ii][1], acc[ii][2], acc[ii][3]);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int ii = 0; ii < Tl::TI; ++ii) {
#pragma unroll
        for (int jj = 0; jj < Tl::TJ; ++jj) {
          const float x = __fadd_rn(A[(i0 + ii) * K + k], B[k * K + j0 + jj]);
          acc[ii][jj] = (k == 0 || x > acc[ii][jj]) ? x : acc[ii][jj];
        }
      }
    }
#pragma unroll
    for (int ii = 0; ii < Tl::TI; ++ii)
#pragma unroll
      for (int jj = 0; jj < Tl::TJ; ++jj) C[(i0 + ii) * K + j0 + jj] = acc[ii][jj];
  }
}

// Entry j of the restart part ca (x) Mb (the combine's order); ``dead``:
// ca is -1e30 in every slot.
template <int K>
__device__ __forceinline__ float vec_entry(const float* ca, const float* Mb, int j,
                                           bool dead) {
  float v = __fadd_rn(dead ? kNegInf : ca[0], Mb[j]);
#pragma unroll
  for (int k = 1; k < K; ++k) {
    const float x = __fadd_rn(dead ? kNegInf : ca[k], Mb[k * K + j]);
    v = x > v ? x : v;
  }
  return v;
}

// Where the inclusive prefix of element t of level l lies after the
// restart pass's in-place down-sweep: position 0 is the level's own first
// element, an even position t >= 2 was written over slot t-1, and an odd
// one is the prefix of position (t-1)/2 of the level above.
__device__ __forceinline__ int prefix_slot(const int* off, int l, int t) {
  while (t & 1) {
    t = (t - 1) >> 1;
    ++l;
  }
  return off[l] + (t ? t - 1 : 0);
}

// The prefix map of element t of level l >= 1 after the map pass: the
// level's first element, or a stored prefix, climbing from odd positions.
template <int K>
__device__ __forceinline__ const float* prefix_map(const float* lv,
                                                   const AssocShared& sh,
                                                   int E, int l, int t) {
  while (t & 1) {
    t = (t - 1) >> 1;
    ++l;
  }
  return t ? lv + (int64_t)(E + sh.poff[l] + t / 2 - 1) * Tile<K>::ES
           : lv + (int64_t)sh.off[l] * Tile<K>::ES;
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

template <int K, bool CARRY, bool SPARSE>
__global__ void __launch_bounds__(kMaxThreads)
viterbi_assoc_kernel(const ViterbiArgs a, float* ws, int64_t ws_per) {
  extern __shared__ __align__(16) uint8_t assoc_buf[];
  constexpr int KK = K * K;
  using Tl = Tile<K>;
  const int T = a.T;
  const int n = T - 1;
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  AssocShared sh;
  assoc_smem<K, CARRY>(T, ws_per == 0, &sh, assoc_buf);
  float* lv = ws_per ? ws + b * ws_per : sh.lv;
  const Levels lvl = count_levels(n);
  const int E = lvl.E;
  constexpr int ES = Tl::ES;
  float* vec = lv + (int64_t)(E + lvl.P) * ES;  // the restart vectors

  const float* em = a.emis + b * T * K;
  const float* lp = a.logp + b * (int64_t)n * KK;
  const float* gc = a.gc + b * n;
  const float* vd = a.valid + b * T;
  const int32_t* ce = a.cand_edge + b * T * K;

  if (tid == 0) {  // the levels' sizes and offsets
    int o = 0, po = 0, c = n;
    for (int l = 0;; ++l) {
      sh.off[l] = o;
      sh.cnt[l] = c;
      sh.poff[l] = po;
      if (l > 0) po += (c - 1) / 2;
      if (c < 2) break;
      o += c;
      c /= 2;
    }
  }

  // level 0's maps and restart vectors and the feasibility masks, a warp
  // a step, kSteps steps' loads in flight at once: lanes read the step's
  // [K, K] logp in order; a ballot gives each row's feasible
  // destinations, lane j collects column j's sources
  {
    constexpr int kPasses = (KK + 31) / 32;                   // loads a step
    constexpr int kSteps = kPasses >= 16 ? 1 : 16 / kPasses;  // steps at once
    constexpr int kRows = (32 / K < K) ? 32 / K : K;          // rows a pass
    for (int t0 = warp; t0 < n; t0 += nwarps * kSteps) {
      float x[kSteps][kPasses], e1[kSteps][kPasses];
      bool vt[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int t = t0 + u * nwarps;
        vt[u] = t < n && __ldg(vd + t + 1) != 0.f;
#pragma unroll
        for (int q = 0; q < kPasses; ++q) {
          const int e = q * 32 + lane;
          const bool in = t < n && e < KK;
          x[u][q] = in ? __ldg(lp + (int64_t)t * KK + e) : kNegInf;
          e1[u][q] = in ? __ldg(em + (t + 1) * K + e % K) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int t = t0 + u * nwarps;
        if (t >= n) break;  // uniform over the warp
        uint32_t m = 0;
#pragma unroll
        for (int q = 0; q < kPasses; ++q) {
          const int e = q * 32 + lane;
          if (e < KK) {
            const int i = e / K, jj = e % K;
            lv[(int64_t)t * ES + e] =
                vt[u] ? __fadd_rn(x[u][q], e1[u][q]) : (i == jj ? 0.f : kNegInf);
          }
          const uint32_t bits = __ballot_sync(0xffffffffu, e < KK && x[u][q] > kNegInf / 2);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            m |= ((bits >> (r * K + (lane % K))) & 1u) << (q * 32 / K + r);
        }
        if (lane < K) {
          sh.feas[t * K + lane] = m;
          vec[t * K + lane] = e1[u][0];  // element t's restart vector, if it restarts
        }
      }
    }
  }
  // per point: the alive emissions, the valid and last-slot flags (point
  // 0's emissions wait in the scores' row 0); per step the hard-break and
  // valid bits
  for (int t = tid; t < T; t += nt) {
    float e[K];
#pragma unroll
    for (int i = 0; i < K; ++i) e[i] = __ldg(em + t * K + i);
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) m |= (uint32_t)(e[i] > kNegInf / 2) << i;
    sh.ealive[t] = m;
    sh.vflag[t] = (uint8_t)((__ldg(vd + t) != 0.f) | ((__ldg(ce + t * K + K - 1) >= 0) << 1));
    if (t == 0)
#pragma unroll
      for (int i = 0; i < K; ++i) sh.S[i] = e[i];
  }
  for (int t = tid; t < n; t += nt) {
    float brk = a.brk;
    if constexpr (SPARSE) {
      const float* tm = a.times + b * T;
      brk = rtt::sparse_breakage(a.brk, a.sa, __fsub_rn(tm[t + 1], tm[t]));
    }
    sh.hard[t] = (uint8_t)((gc[t] > brk) | ((vd[t + 1] != 0.f) << 1));
  }
  // the seam's K*K entries, a thread an entry: carried slot i -> slot j
  if constexpr (CARRY) {
    const SeamRow r = seam_row(a, b);
    int hits = 0, fetches = 0;
    for (int w = tid; w < KK; w += nt) {
      const int i = w / K, jj = w % K;
      const SeamDst d = seam_dst<K>(a, b, jj);
      float sc;
      const float l = seam_logp<K, SPARSE, 1>(a, b, r, d, i, jj, true, &hits,
                                              &fetches, &sc);
      sh.seam_lp[w] = l;
      sh.seam_tot[w] = __fadd_rn(sc, l);
    }
    if (a.tier.totals) {  // the warp's fetches in one atomic each
      const unsigned h = __reduce_add_sync(0xffffffffu, (unsigned)hits);
      const unsigned f = __reduce_add_sync(0xffffffffu, (unsigned)fetches);
      if (lane == 0 && f) rtt::add_totals(a.tier, h, f - h);
    }
  }
  __syncthreads();

  if (warp == 0) {
    // the scores at t = 0: through the seam (the best carried slot into
    // each destination, sources in order), or the emissions
    const int j = lane % K;
    bool first_break = true;
    float score = sh.S[j];  // point 0's emissions
    if constexpr (CARRY) {
      const SeamRow r = seam_row(a, b);
      float best = 0.f;
      for (int i = 0; i < K; ++i) {
        const float tot = sh.seam_tot[i * K + j];
        if (i == 0 || tot > best) best = tot;
      }
      const bool any = __ballot_sync(0xffffffffu, lane < K && best > kNegInf / 2) != 0u;
      first_break = seam_break<SPARSE>(a, r, any);
      if (!first_break) score = __fadd_rn(best, score);
      if (lane == 0) sh.misc[1] = r.committed;
    }
    __syncwarp();
    if (lane < K) {
      sh.init[lane] = score;
      sh.S[lane] = score;
    }
    if (lane == 0) sh.misc[0] = first_break;

    // the alive-support recursion, a ballot a step: a step breaks when too
    // long or when no alive source reaches any destination; then the alive
    // set is the alive emissions (restart) or those reached; padding
    // freezes it.  32 steps at a time: lane c holds step t0 + c's flags
    // and keeps its result, so nothing is stored inside the chain.
    const bool lk = lane < K;
    uint32_t alive = __ballot_sync(0xffffffffu, lk && score > kNegInf / 2);
    int first = n;  // the first step that restarts
    for (int t0 = 0; t0 < n; t0 += 32) {
      const int tl = t0 + lane;
      const int hl = tl < n ? sh.hard[tl] : 0;
      const uint32_t eal = tl < n ? sh.ealive[tl + 1] : 0u;
      const int c_end = n - t0 < 32 ? n - t0 : 32;
      bool brk_l = false;
#pragma unroll 8
      for (int c = 0; c < c_end; ++c) {
        const uint32_t f = lk ? sh.feas[(t0 + c) * K + lane] : 0u;
        const int h = __shfl_sync(0xffffffffu, hl, c);
        const uint32_t ea = __shfl_sync(0xffffffffu, eal, c);
        const uint32_t conn = __ballot_sync(0xffffffffu, (alive & f) != 0u);
        const bool brk = (h & 1) || conn == 0u;
        if (h & 2) alive = brk ? ea : (conn & ea);
        if (lane == c) brk_l = brk;
      }
      const bool fl = brk_l && (hl & 2);
      if (tl < n) {
        sh.broke[tl] = brk_l;
        sh.flags[tl] = fl;
      }
      const unsigned fb = __ballot_sync(0xffffffffu, tl < n && fl);
      if (fb && first == n) first = t0 + __ffs(fb) - 1;
    }
    if (lane == 0) sh.misc[2] = first;
    // with the levels in shared memory, the restart pass's first level
    // here too (it reads level 0 only): see the restart pass below
    if (ws_per == 0 && n >= 2) {
      __syncwarp();
      for (int w = lane; w < (n / 2) * K; w += 32) {
        const int e = w / K, jj = w % K, s1 = 2 * e + 1;
        vec[(int64_t)(n + e) * K + jj] =
            sh.flags[s1] ? vec[(int64_t)s1 * K + jj]
                         : vec_entry<K>(vec + (int64_t)(s1 - 1) * K, lv + (int64_t)s1 * ES, jj,
                                        !sh.flags[s1 - 1]);
      }
      for (int e = lane; e < n / 2; e += 32) sh.flags[n + e] = sh.flags[2 * e] | sh.flags[2 * e + 1];
    }
  } else {
    // the map pass's up-sweep on warps 1.., barrier 1 between levels
    const int wt = tid - 32, nw = nt - 32;
    for (int l = 0; sh.cnt[l] >= 2; ++l) {
      const int o = sh.off[l], o1 = sh.off[l + 1];
      const int m = sh.cnt[l] / 2;
      for (int w = wt; w < m * Tl::PER; w += nw) {
        const int e = w / Tl::PER;
        map_tile<K>(lv + (int64_t)(o + 2 * e) * ES, lv + (int64_t)(o + 2 * e + 1) * ES,
                    lv + (int64_t)(o1 + e) * ES, w % Tl::PER);
      }
      bar_sync(1, nw);
    }
  }
  __syncthreads();

  // the restart pass: the up- and down-sweep of the vectors and flags in
  // place.  Level 0's vector c_t is the staged emissions where step t
  // restarts, else -1e30 in every slot: only the up-sweep's first level
  // reads one that does not restart.
  int levels = ws_per == 0 && n >= 2 ? 1 : 0;  // level 0 done on warp 0
  for (; sh.cnt[levels] >= 2; ++levels) {
    const int o = sh.off[levels], o1 = sh.off[levels + 1];
    const int m = sh.cnt[levels] / 2;
    for (int w = tid; w < m * K; w += nt) {
      const int e = w / K, jj = w % K;
      const int s1 = o + 2 * e + 1;
      vec[(int64_t)(o1 + e) * K + jj] =
          sh.flags[s1] ? vec[(int64_t)s1 * K + jj]
                       : vec_entry<K>(vec + (int64_t)(s1 - 1) * K, lv + (int64_t)s1 * ES, jj,
                                      levels == 0 && !sh.flags[s1 - 1]);
    }
    for (int e = tid; e < m; e += nt)
      sh.flags[o1 + e] = sh.flags[o + 2 * e] | sh.flags[o + 2 * e + 1];
    __syncthreads();
  }
  for (int l = levels - 1; l >= 0; --l) {
    const int o = sh.off[l];
    const int m = (sh.cnt[l] - 1) / 2;  // even positions 2 .. cnt-1
    for (int w = tid; w < m * K; w += nt) {
      const int t = 2 * (w / K + 1), jj = w % K;
      const int ps = prefix_slot(sh.off, l + 1, t / 2 - 1);
      vec[(int64_t)(o + t - 1) * K + jj] =
          sh.flags[o + t] ? vec[(int64_t)(o + t) * K + jj]
                          : vec_entry<K>(vec + (int64_t)ps * K, lv + (int64_t)(o + t) * ES, jj,
                                         false);
    }
    for (int i = tid; i < m; i += nt) {
      const int t = 2 * (i + 1);
      sh.flags[o + t - 1] = sh.flags[prefix_slot(sh.off, l + 1, t / 2 - 1)] | sh.flags[o + t];
    }
    // the map pass's down-sweep of level l + 1 (levels >= 1): only the
    // prefixes that points before the first restart read (a prefix
    // restarts from there on, and its restart vector is the score)
    if (l + 1 < levels) {
      const int lu = l + 1;
      const int mu = min((sh.cnt[lu] - 1) / 2, (sh.misc[2] >> lu) + 1);
      for (int w = tid; w < mu * Tl::PER; w += nt) {
        const int t = 2 * (w / Tl::PER + 1);
        map_tile<K>(prefix_map<K>(lv, sh, E, lu + 1, t / 2 - 1),
                    lv + (int64_t)(sh.off[lu] + t) * ES,
                    lv + (int64_t)(E + sh.poff[lu] + t / 2 - 1) * ES, w % Tl::PER);
      }
    }
    __syncthreads();
  }

  // level 0's prefixes at the even positions before the first restart:
  // the level above's prefix at t/2 - 1 (x) element t, formed into the
  // consumed odd slot t - 1 (nothing reads level 0's odd maps any more)
  const int first = sh.misc[2];
  {
    const int m = ((first < n ? first : n) - 1) / 2;
    for (int w = tid; w < m * Tl::PER; w += nt) {
      const int t = 2 * (w / Tl::PER + 1);
      map_tile<K>(prefix_map<K>(lv, sh, E, 1, t / 2 - 1), lv + (int64_t)t * ES,
                  lv + (int64_t)(t - 1) * ES, w % Tl::PER);
    }
  }
  __syncthreads();

  // the scores: from the first restart on, the prefix's restart vector;
  // before it max_i init[i] + P_t[i][j], i ascending, over level 0's
  // prefix P_t (element 0 itself, an odd position's the level above's, an
  // even one's the map just formed)
  for (int w = tid; w < n * K; w += nt) {
    const int t = w / K, jj = w % K;
    float v;
    if (t >= first) {
      v = vec[(int64_t)prefix_slot(sh.off, 0, t) * K + jj];
    } else {
      const float* P = t == 0 ? lv
                       : (t & 1) ? prefix_map<K>(lv, sh, E, 1, (t - 1) / 2)
                                 : lv + (int64_t)(t - 1) * ES;
      v = __fadd_rn(sh.init[0], P[jj]);
#pragma unroll
      for (int i = 1; i < K; ++i) {
        const float x = __fadd_rn(sh.init[i], P[i * K + jj]);
        v = x > v ? x : v;
      }
    }
    sh.S[(t + 1) * K + jj] = v;
  }
  __syncthreads();

  // per point: the local argmax and the confidence aux terms
  for (int t = tid; t < T; t += nt) {
    float s[K];
#pragma unroll
    for (int i = 0; i < K; ++i) s[i] = sh.S[t * K + i];
    const PointAux p = point_aux<K>(s, sh.vflag[t] & 1, sh.vflag[t] & 2);
    sh.loc[t] = (int8_t)p.local;
    sh.marg[t] = p.marg;
    sh.pflags[t] = (uint8_t)(p.two | (p.exh << 1));
  }
  __syncthreads();

  // backpointers of step t+1 from the prefix scores at t (first maximum)
  // straight into the backtrace's maps: slot n in 0..K-1 chosen at t+1
  // (slot K: none) -> the slot at t
  int8_t* mp = sh.maps;
  for (int w = tid; w < n * (K + 1); w += nt) {
    const int t = w / (K + 1), jj = w % (K + 1);
    int v = sh.loc[t];
    if (jj < K && (sh.vflag[t + 1] & 1) && !sh.broke[t]) {
      const float* prev = sh.S + t * K;
      const float* l = lp + (int64_t)t * KK + jj;
      float lk[K];
#pragma unroll
      for (int i = 0; i < K; ++i) lk[i] = __ldg(l + i * K);
      float best = __fadd_rn(prev[0], lk[0]);
      int bi = 0;
#pragma unroll
      for (int i = 1; i < K; ++i) {
        const float x = __fadd_rn(prev[i], lk[i]);
        if (x > best) {
          best = x;
          bi = i;
        }
      }
      if (best > kNegInf / 2) v = bi;
    }
    mp[w] = (int8_t)((sh.vflag[t] & 1) ? v : -1);
  }
  __syncthreads();

  // the suffix compositions by pointer doubling: after the pass with
  // stride d, map t is map_t o ... o map_{t+2d-1}
  int8_t* cur = mp;
  int8_t* nxt = mp + n * (K + 1);
  for (int d = 1; d < n; d *= 2) {
    for (int w = tid; w < n * (K + 1); w += nt) {
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

  // chosen slots and break flags (with CARRY the seam check: the
  // committed slot must reach the window's first choice, else the seam
  // is a break), and the packed output, a thread a point
  const int last_idx = (sh.loc[n] >= 0 && (sh.vflag[n] & 1)) ? sh.loc[n] : -1;
  const int64_t plane = a.B * (int64_t)T;
  const float* co = a.cand_offset + b * T * K;
  for (int t = tid; t < T; t += nt) {
    const int it = t == n ? last_idx : cur[t * (K + 1) + (last_idx >= 0 ? last_idx : K)];
    sh.idx[t] = (int8_t)it;
    const bool vt = sh.vflag[t] & 1;
    bool brk = (t == 0 ? sh.misc[0] != 0 : sh.broke[t - 1] != 0) && vt;
    if (CARRY && t == 0 && !brk && it >= 0 && sh.misc[1] >= 0 && vt) {
      const int c = sh.misc[1] > 0 ? sh.misc[1] : 0;
      brk = !(sh.seam_lp[c * K + it] > kNegInf / 2);
    }
    const int sel = it > 0 ? it : 0;
    const int64_t o = b * T + t;
    a.packed[o] = it >= 0 ? ce[(int64_t)t * K + sel] : -1;
    a.packed[plane + o] = __float_as_int(co[(int64_t)t * K + sel]);
    a.packed[2 * plane + o] = brk;
  }
  __syncthreads();
  // warp 0: the aux in point order (every lane adds the same parts,
  // broadcast 32 points at a time) and the carry-out
  if (warp == 0) {
    Aux ax;
    int last = -1;
    for (int t0 = 0; t0 < T; t0 += 32) {
      const int t = t0 + lane;
      const int pf = t < T ? sh.pflags[t] : 0;
      const float mg = t < T ? sh.marg[t] : 0.f;
      if (t < T && (sh.vflag[t] & 1)) last = t;
      const int c_end = T - t0 < 32 ? T - t0 : 32;
      for (int c = 0; c < c_end; ++c) {
        PointAux p;
        const int f = __shfl_sync(0xffffffffu, pf, c);
        p.two = f & 1;
        p.exh = f & 2;
        p.marg = __shfl_sync(0xffffffffu, mg, c);
        ax.add(p);
      }
    }
    last = __reduce_max_sync(0xffffffffu, last);
    if (lane == 0) {
      a.aux[b * 4 + 0] = ax.amin;
      a.aux[b * 4 + 1] = ax.asum;
      a.aux[b * 4 + 2] = ax.acnt;
      a.aux[b * 4 + 3] = ax.aexh;
    }
    if constexpr (CARRY) {
      if (lane < K) {
        float s[K];
#pragma unroll
        for (int i = 0; i < K; ++i) s[i] = sh.S[n * K + i];
        carry_out<K>(a, b, lane, sh.idx, last, s[lane], s);
      }
    }
  }
}

// Threads a trace: enough for the first level's map tiles (and with
// CARRY the seam's K*K entries) beside warp 0, 128-512 (the tails' loops
// run a thread a point or a backtrace entry).
template <int K, bool CARRY>
int assoc_threads(int n) {
  int want = (n / 2) * Tile<K>::PER + 32;
  if (CARRY && K * K > want) want = K * K;
  int t = 128;
  while (t < want && t < kMaxThreads) t *= 2;
  return t;
}

template <int K, bool CARRY, bool SPARSE>
int assoc_launch(const ViterbiArgs& a, float* ws, cudaStream_t stream) {
  static std::atomic<bool> opted[rtt::kMaxDevices];
  if (a.T < 2) return (int)cudaErrorInvalidValue;  // T < 2 runs kernels 4/5
  bool levels;
  const size_t smem = assoc_bytes<K, CARRY>(a.T, &levels);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int64_t ws_per = levels ? 0 : level_floats<K>(a.T - 1);
  if (ws_per && ws == nullptr) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above the default: opt in once per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= rtt::kMaxDevices || !opted[dev].load()) {
      e = cudaFuncSetAttribute(viterbi_assoc_kernel<K, CARRY, SPARSE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
      if (e != cudaSuccess) return (int)e;
      if (dev < rtt::kMaxDevices) opted[dev].store(true);
    }
  }
  viterbi_assoc_kernel<K, CARRY, SPARSE>
      <<<(unsigned)a.B, assoc_threads<K, CARRY>(a.T - 1), smem, stream>>>(a, ws, ws_per);
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

template <int K>
int64_t workspace_floats(int T, bool carry) {
  bool levels;
  if (carry)
    assoc_bytes<K, true>(T, &levels);
  else
    assoc_bytes<K, false>(T, &levels);
  return levels ? 0 : level_floats<K>(T - 1);
}

}  // namespace

// Floats of global workspace a trace of T points at K needs (0: its
// levels fit in shared memory), -1 for a K the kernels do not take.
extern "C" int64_t viterbi_assoc_workspace(int32_t T, int32_t K, int32_t carry) {
  if (T < 2) return 0;
  switch (K) {
    case 1: return workspace_floats<1>(T, carry != 0);
    case 2: return workspace_floats<2>(T, carry != 0);
    case 4: return workspace_floats<4>(T, carry != 0);
    case 8: return workspace_floats<8>(T, carry != 0);
    case 16: return workspace_floats<16>(T, carry != 0);
    case 32: return workspace_floats<32>(T, carry != 0);
    default: return -1;
  }
}

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
