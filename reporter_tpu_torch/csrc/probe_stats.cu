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
// Slot [4], the distinct pairs among the needed ones, is written by the
// claim kernel in count mode (ubodt_dedup.cu) over the `need` mask this
// kernel writes.
//
// Bounded by memory on the card: 4 bytes of dist read and a byte of need
// written a pair (a step's candidates and points are K + 3 words).  Both
// kernels take the B * (T-1) steps on a persistent grid (the occupancy
// query), decode a step's trace by a 32-bit fast divmod by T - 1
// (rtt::StepDecode, made on the host), read valid once a step and px, py
// and gc only for a step with a miss, keep the counts in registers across
// a warp's steps (costly and beyond as the step's misses where its gc
// says so), then reduce them by shuffles a warp, in shared memory a block,
// and add them with at most four atomicAdds a block into the int32 [5]
// result, which the launch clears first (a memset: no per-call scratch is
// shared between streams).
//   quad (K % 4 == 0, the matcher's K = 8 and 16): a lane takes 4
//        consecutive pairs of a step, which share i and have j..j+3: one
//        16-byte read of dist, one read of ea and one 16-byte read of
//        eb..eb+3 (each step's edges are read by its lanes, from L1), the
//        4 need bytes as one 4-byte store.  A step is K * K / 4 lanes: 2
//        steps a warp at K = 8, 8 at K = 4, one (in passes of 32 quads)
//        from K = 12.  No shuffle or ballot: lanes diverge freely.
//   row  (any other K, or dist or cand_edge not 16-byte aligned): a warp
//        a step; lanes < K read the two points' candidate edges and
//        shuffles give each pair its two edges; the
//        lanes read the step's dist in passes of 32 pairs; where K * K % 4
//        == 0 lane l writes the need bytes of pairs 4l..4l+3 of each 128
//        from the passes' ballots as one 4-byte store, else each lane its
//        own byte.
// A lane's pair (i, j) steps on by 32 pairs (row) or 32 quads (quad) in
// registers: no division by K in the loop.  At K = 8 the row kernel is
// bound by its instructions a step (shuffles, ballots and (i, j) steps
// for 2 pairs a lane), not by its bytes: hence the quad kernel (PERF.md
// section 6).

#include "common.cuh"

namespace {

constexpr int kThreads = 512;  // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

// The block's counts into stats: a shuffle sum a warp, then warp 0 over
// the warps' sums in shared memory, at most one atomicAdd a counter.
__device__ __forceinline__ void add_counts(unsigned need, unsigned miss,
                                           unsigned costly, unsigned beyond,
                                           int32_t* stats) {
  __shared__ unsigned acc[4][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned c[4] = {need, miss, costly, beyond};
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const unsigned t = __reduce_add_sync(kAll, c[f]);
    if (lane == 0) acc[f][warp] = t;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const unsigned t = __reduce_add_sync(kAll, lane < kWarps ? acc[f][lane] : 0u);
      if (lane == 0 && t) atomicAdd(&stats[f], (int32_t)t);
    }
  }
}

// costly and beyond from a step's misses (gc read and computed only then)
__device__ __forceinline__ void count_misses(unsigned m_row, int64_t p,
                                             const float* __restrict__ px,
                                             const float* __restrict__ py,
                                             float brk, float delta,
                                             unsigned* miss, unsigned* costly,
                                             unsigned* beyond) {
  if (!m_row) return;
  const float gc = rtt::hypot_like_jax(__fsub_rn(__ldg(px + p + 1), __ldg(px + p)),
                                       __fsub_rn(__ldg(py + p + 1), __ldg(py + p)));
  *miss += m_row;
  if (gc <= brk) {
    *costly += m_row;
    if (gc > delta) *beyond += m_row;
  }
}

// row: any K (the launcher takes it where K % 4 != 0).
__global__ void __launch_bounds__(kThreads) probe_stats_kernel(
    const float* __restrict__ dist, const int32_t* __restrict__ cand_edge,
    const float* __restrict__ valid, const float* __restrict__ px,
    const float* __restrict__ py, int64_t n_steps, rtt::StepDecode dec,
    int32_t K, float brk, float delta, int32_t* stats,
    uint8_t* __restrict__ need_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int KK = K * K;
  const bool vec = (KK & 3) == 0;  // a step's need bytes start 4-aligned
  // this lane's first pair (lane) as (i, j), and the step of 32 pairs
  const int i0 = lane / K, j0 = lane - i0 * K;
  const int di = 32 / K, dj = 32 - di * K;
  unsigned c_need = 0, c_miss = 0, c_costly = 0, c_beyond = 0;
  for (int64_t r = (int64_t)blockIdx.x * kWarps + warp; r < n_steps;
       r += (int64_t)gridDim.x * kWarps) {
    const int64_t p = dec.point(r);  // point t of trace b
    const int32_t ea_l = lane < K ? __ldg(cand_edge + p * K + lane) : -1;
    const int32_t eb_l = lane < K ? __ldg(cand_edge + (p + 1) * K + lane) : -1;
    const bool both = __ldg(valid + p) != 0.f && __ldg(valid + p + 1) != 0.f;
    const float* row = dist + r * KK;
    uint8_t* nrow = need_out ? need_out + r * KK : nullptr;
    unsigned m_row = 0;
    int i = i0, j = j0;
    for (int q0 = 0; q0 < KK; q0 += 128) {
      float d[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int q = q0 + 32 * s + lane;
        d[s] = q < KK ? __ldg(row + q) : 0.f;
      }
      unsigned nib = 0;  // vec: the need bits of pairs q0 + 4 lane .. + 3
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (q0 + 32 * s >= KK) break;  // the same for the whole warp
        const int q = q0 + 32 * s + lane;
        const int32_t ea = __shfl_sync(kAll, ea_l, i & 31);
        const int32_t eb = __shfl_sync(kAll, eb_l, j & 31);
        const bool need = q < KK && both && ea >= 0 && eb >= 0 && ea != eb;
        c_need += need;
        m_row += need && !isfinite(d[s]);
        if (vec) {
          const unsigned b = __ballot_sync(kAll, need);
          if ((lane >> 3) == s) nib = (b >> (4 * (lane & 7))) & 0xFu;
        } else if (nrow && q < KK) {
          nrow[q] = need ? 1 : 0;
        }
        i += di;
        j += dj;
        if (j >= K) {
          j -= K;
          ++i;
        }
      }
      if (nrow && vec && q0 + 4 * lane < KK)  // bit c of the nibble to byte c
        *reinterpret_cast<uint32_t*>(nrow + q0 + 4 * lane) =
            (nib * 0x00204081u) & 0x01010101u;
    }
    count_misses(m_row, p, px, py, brk, delta, &c_miss, &c_costly, &c_beyond);
  }
  add_counts(c_need, c_miss, c_costly, c_beyond, stats);
}

// quad: K % 4 == 0, dist and cand_edge 16-byte aligned.
__global__ void __launch_bounds__(kThreads) probe_stats_quad_kernel(
    const float* __restrict__ dist, const int32_t* __restrict__ cand_edge,
    const float* __restrict__ valid, const float* __restrict__ px,
    const float* __restrict__ py, int64_t n_steps, rtt::StepDecode dec,
    int32_t K, float brk, float delta, int32_t* stats,
    uint8_t* __restrict__ need_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int KK = K * K, quads = KK >> 2;
  const int per = quads < 32 ? quads : 32;  // lanes a step: 4, 16 or 32
  const int rows = 32 / per;                // steps a warp at a time
  const int sub = lane / per, g0 = lane - sub * per;
  // this lane's first quad (g0) as (i, j), and the step of 32 quads
  const int i0 = 4 * g0 / K, j0 = 4 * g0 - i0 * K;
  const int di = 128 / K, dj = 128 - di * K;
  unsigned c_need = 0, c_miss = 0, c_costly = 0, c_beyond = 0;
  const int64_t stride = (int64_t)gridDim.x * kWarps * rows;
  for (int64_t r = ((int64_t)blockIdx.x * kWarps + warp) * rows + sub; r < n_steps;
       r += stride) {
    const int64_t p = dec.point(r);  // point t of trace b
    const bool both = __ldg(valid + p) != 0.f && __ldg(valid + p + 1) != 0.f;
    const float4* row = reinterpret_cast<const float4*>(dist + r * KK);
    uint32_t* nrow = need_out ? reinterpret_cast<uint32_t*>(need_out + r * KK) : nullptr;
    const int32_t* ea_row = cand_edge + p * K;
    const int32_t* eb_row = ea_row + K;
    unsigned m_row = 0;
    int i = i0, j = j0;
    for (int g = g0; g < quads; g += 32) {
      const float4 d = __ldg(row + g);
      const int32_t ea = __ldg(ea_row + i);
      const int4 eb = __ldg(reinterpret_cast<const int4*>(eb_row + j));
      const bool ok = both && ea >= 0;
      const bool n0 = ok && eb.x >= 0 && ea != eb.x, n1 = ok && eb.y >= 0 && ea != eb.y;
      const bool n2 = ok && eb.z >= 0 && ea != eb.z, n3 = ok && eb.w >= 0 && ea != eb.w;
      c_need += n0 + n1 + n2 + n3;
      m_row += (n0 && !isfinite(d.x)) + (n1 && !isfinite(d.y)) + (n2 && !isfinite(d.z)) +
               (n3 && !isfinite(d.w));
      if (nrow)
        nrow[g] = (uint32_t)n0 | (uint32_t)n1 << 8 | (uint32_t)n2 << 16 | (uint32_t)n3 << 24;
      i += di;
      j += dj;
      if (j >= K) {
        j -= K;
        ++i;
      }
    }
    count_misses(m_row, p, px, py, brk, delta, &c_miss, &c_costly, &c_beyond);
  }
  add_counts(c_need, c_miss, c_costly, c_beyond, stats);
}

}  // namespace

// dist [B, T-1, K, K] f32; cand_edge [B, T, K] i32; valid, px, py [B, T]
// f32; stats int32 [5] (cleared; slots 0-3 counted here); need_out
// uint8 [B, T-1, K, K] (4-byte aligned) or null.  K at most 32.
extern "C" int probe_stats_launch(const float* dist, const int32_t* cand_edge,
                                  const float* valid, const float* px,
                                  const float* py, int64_t B, int32_t T,
                                  int32_t K, float brk, float delta,
                                  int32_t* stats, uint8_t* need_out,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K > 32 || ((uintptr_t)need_out & 3)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(stats, 0, 5 * sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0 || T < 2 || K <= 0) return 0;
  const int64_t n_steps = B * (int64_t)(T - 1);
  const bool quad = (K & 3) == 0 && !(((uintptr_t)dist | (uintptr_t)cand_edge) & 15);
  static std::atomic<int> cached[2][rtt::kMaxDevices];
  int resident = 0;
  e = quad ? rtt::resident_blocks(probe_stats_quad_kernel, kThreads, cached[1], &resident)
           : rtt::resident_blocks(probe_stats_kernel, kThreads, cached[0], &resident);
  if (e != cudaSuccess) return (int)e;
  // steps a block takes at a time: a warp's 2 (K = 8) or 8 (K = 4) in quad
  const int per_block = quad && K < 12 ? kWarps * 128 / (K * K) : kWarps;
  const int64_t need = (n_steps + per_block - 1) / per_block;
  const int64_t blocks = need < resident ? need : resident;
  const rtt::StepDecode dec = rtt::step_decode(n_steps, T);
  if (quad)
    probe_stats_quad_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        dist, cand_edge, valid, px, py, n_steps, dec, K, brk, delta, stats, need_out);
  else
    probe_stats_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        dist, cand_edge, valid, px, py, n_steps, dec, K, brk, delta, stats, need_out);
  return (int)cudaGetLastError();
}

extern "C" const char* probe_stats_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
