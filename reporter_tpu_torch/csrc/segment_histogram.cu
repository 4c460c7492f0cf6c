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
// chose slot idx >= 0 (-1 otherwise, or where the edge has no segment or
// one outside [0, S)); the chosen route into point t is route[b, t-1,
// src, idx] where src, the backpointer at the chosen slot, is >= 0 (the
// step neither broke nor was disconnected), else +inf: the reference's
// route_dist.  The decode's ``choice`` [2, B, T] output (kernel 4) holds
// idx and src.
//
// Work: a few hundred KB of [B, T] inputs, a gather of one candidate
// edge, one route entry and one segment id per point, and scatter-adds
// into [4, S] bins.  Bounded by memory on paper (0.0005 ms at 512 x 64);
// in practice by the launches and the latency of its dependent loads and
// atomics (tools/histogram_split.py times each part).
//
// Design (T <= 256, every path of the matcher): a warp takes a chunk of
// 64 consecutive points of a row, 2 a lane (t = base + l, base + 32 + l);
// a block of 4 warps takes 4 rows of up to 64 points, 2 of up to 128, or
// one of up to 256, on a persistent grid striding over those groups.
//   1. Every load that does not depend on the segment is issued first,
//      side by side: idx, src, breaks, times[t] and times[t-1]; then the
//      chosen candidate's edge and the chosen route entry (which depends
//      only on src and idx); then the edge's segment: three levels of
//      dependent loads.
//   2. The step into t counts where t-1 (a shuffle, or the warp before's
//      last point through shared memory) is on the same segment and no
//      break lies between: its dt and, where finite, its route metres.
//   3. A segmented scan in t order (32 lanes by shuffles, then slot 0's
//      last lane into slot 1) sums each run of consecutive points on one
//      segment; the run's last point in the chunk adds its point count,
//      time and distance (one to three global atomics a run, where the
//      block-a-row kernel made up to four a point).
//   4. The row's one trace a segment is added at the first of the run
//      starts on that segment, which replaces the compare loop over the
//      row's earlier points for first occurrence.  A row in one warp
//      finds it by __match_any_sync within each slot and, for slot 1, a
//      shuffle of slot 0's 32 run starts; a row over several warps by
//      inserting each run's segment into the row's hash set in shared
//      memory (atomicCAS, linear probing, twice the row's points in
//      slots), where the insert that finds the slot empty adds the trace.
// Past 256 points a row takes a block (histogram_block): its segment ids
// in shared memory, each point's first occurrence tested against the
// row's earlier points and its adds made one at a time (up to 58,000
// points, the shared memory's limit).
// The launcher zeroes the [4, S] output with zero_output on the caller's
// stream, then launches histogram_rows as its programmatic dependent
// (programmatic stream serialization): zero_output lets it start at
// once, so its launch and three levels of loads overlap the zeroing, and
// it waits for the zeroed output (griddepcontrol.wait) before its first
// add.  A memset before an ordinary launch cost ~2 us more at 512 x 64
// (tools/histogram_split.py).  Counts are small integers, exact
// in float32 below 2^24 whatever the order; the two float sums are taken
// in another order than the plain version's, so they agree to rounding
// (the reference's sharded and unsharded histograms are held to rtol
// 1e-5).

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;                // warps a block of histogram_rows
constexpr int kChunk = 64;               // points a warp: 2 a lane
constexpr int kMaxT = kWarps * kChunk;   // histogram_rows' rows: T <= 256
constexpr int kSlots = 2 * kMaxT;        // a block's hash slots
constexpr int kThreads = 256;            // histogram_block's block
constexpr int kZeroThreads = 256;        // zero_output's block
constexpr uint32_t kNone = 0xffffffffu;  // an unmatched point's key

// Zeroes out[0, n); lets its programmatic dependent start at once.
__global__ void __launch_bounds__(kZeroThreads) zero_output(
    float* __restrict__ out, int64_t n) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int64_t step = (int64_t)gridDim.x * kZeroThreads;
  for (int64_t i = (int64_t)blockIdx.x * kZeroThreads + threadIdx.x; i < n; i += step)
    out[i] = 0.f;
}

// ``wpr`` warps a row (1-4), 4 / wpr rows a group of the block.
__global__ void __launch_bounds__(kWarps * 32) histogram_rows(
    const int32_t* __restrict__ choice, const float* __restrict__ route,
    const int32_t* __restrict__ cand_edge, const int32_t* __restrict__ breaks,
    const float* __restrict__ times, const int32_t* __restrict__ edge_seg,
    int64_t B, int32_t T, int32_t K, int32_t S, int32_t wpr,
    float* __restrict__ out) {
  __shared__ uint32_t table[kSlots];
  __shared__ uint32_t last_key[kWarps];  // each warp's last point's key
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rpg = kWarps / wpr;          // rows a group
  const int size = kSlots / rpg;         // a row's hash slots: 128-512
  const int shift = __clz(size) + 1;     // 32 - log2(size)
  const int local = warp / wpr, chunk = warp % wpr;
  uint32_t* tab = table + local * size;
  const int64_t plane = B * (int64_t)T;
  const int64_t groups = (B + rpg - 1) / rpg;
  for (int64_t g = blockIdx.x; g < groups; g += gridDim.x) {
    if (wpr > 1) {
      __syncthreads();  // the last group's inserts are done
      for (int i = threadIdx.x; i < kSlots; i += kWarps * 32) table[i] = kNone;
    }
    const int64_t b = g * rpg + local;
    const int base = chunk * kChunk;
    const bool live = local < rpg && b < B;
    const int64_t row = b * T;
    // level 1: the loads that do not depend on the segment
    int idx[2], src[2], brk[2];
    float t1[2], t0[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = base + 32 * r + lane;
      const bool in = live && t < T, step = in && t > 0;
      idx[r] = in ? __ldg(choice + row + t) : -1;
      src[r] = step ? __ldg(choice + plane + row + t) : -1;
      brk[r] = step ? __ldg(breaks + row + t) : 1;
      t1[r] = step ? __ldg(times + row + t) : 0.f;
      t0[r] = step ? __ldg(times + row + t - 1) : 0.f;
    }
    // level 2: the chosen candidate's edge and the chosen route entry
    int e[2];
    float rd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t t = base + 32 * r + lane;
      e[r] = idx[r] >= 0 ? __ldg(cand_edge + (row + t) * K + idx[r]) : -1;
      rd[r] = idx[r] >= 0 && src[r] >= 0
          ? __ldg(route + ((b * (T - 1) + t - 1) * K + src[r]) * K + idx[r])
          : INFINITY;
    }
    // level 3: the edge's segment
    uint32_t key[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sg = idx[r] >= 0 ? __ldg(edge_seg + (e[r] > 0 ? e[r] : 0)) : -1;
      key[r] = sg >= 0 && sg < S ? (uint32_t)sg : kNone;
    }
    if (wpr > 1) {
      if (lane == 31) last_key[warp] = key[1];
      __syncthreads();  // the table is clear, the last keys written
    }
    // the key of t-1, and the run's first points
    const uint32_t before = chunk > 0 ? last_key[warp - 1] : kNone;
    uint32_t prev[2];
    prev[0] = __shfl_up_sync(kFull, key[0], 1);
    prev[1] = __shfl_up_sync(kFull, key[1], 1);
    const uint32_t wrap = __shfl_sync(kFull, key[0], 31);
    if (lane == 0) prev[0] = before, prev[1] = wrap;
    int cnt[2];
    float dt[2], dd[2];
    bool head[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool same = key[r] != kNone && key[r] == prev[r] && brk[r] == 0;
      dt[r] = same ? __fsub_rn(t1[r], t0[r]) : 0.f;
      dd[r] = same && isfinite(rd[r]) ? rd[r] : 0.f;
      cnt[r] = key[r] != kNone;
      head[r] = key[r] != prev[r];
    }
    // segmented sums of each slot's runs over the lanes, then slot 0's
    // last run into slot 1's first
    bool open[2] = {!head[0], !head[1]};  // no run starts in lanes [0, lane]
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int uc = __shfl_up_sync(kFull, cnt[r], d);
        const float ut = __shfl_up_sync(kFull, dt[r], d);
        const float ud = __shfl_up_sync(kFull, dd[r], d);
        const bool uo = __shfl_up_sync(kFull, open[r], d);
        if (lane >= d && open[r]) {
          cnt[r] += uc;
          dt[r] = __fadd_rn(ut, dt[r]);
          dd[r] = __fadd_rn(ud, dd[r]);
          open[r] = uo;
        }
      }
    }
    const int cc = __shfl_sync(kFull, cnt[0], 31);
    const float ct = __shfl_sync(kFull, dt[0], 31);
    const float cd = __shfl_sync(kFull, dd[0], 31);
    if (open[1]) {
      cnt[1] += cc;
      dt[1] = __fadd_rn(ct, dt[1]);
      dd[1] = __fadd_rn(cd, dd[1]);
    }
    // a row in one warp: a run start is the row's first on its segment
    // where no run start before it in its slot, nor for slot 1 in slot 0,
    // has the segment (the other lanes hold values no segment takes)
    bool first[2] = {false, false};
    if (wpr == 1) {
      const unsigned below = (1u << lane) - 1u;
      const uint32_t v0 = head[0] && key[0] != kNone ? key[0] : 0x80000000u | lane;
      const uint32_t v1 = head[1] && key[1] != kNone ? key[1] : 0x80000020u | lane;
      const unsigned m0 = __match_any_sync(kFull, v0), m1 = __match_any_sync(kFull, v1);
      bool seen = false;
#pragma unroll
      for (int j = 0; j < 32; ++j) seen |= __shfl_sync(kFull, v0, j) == v1;
      first[0] = v0 == key[0] && (m0 & below) == 0;
      first[1] = v1 == key[1] && (m1 & below) == 0 && !seen;
    }
    // zero_output, this launch's primary, has zeroed the output
    asm volatile("griddepcontrol.wait;" ::: "memory");
    uint32_t next[2];
    next[0] = __shfl_down_sync(kFull, key[0], 1);
    next[1] = __shfl_down_sync(kFull, key[1], 1);
    const uint32_t first1 = __shfl_sync(kFull, key[1], 0);
    if (lane == 31) next[0] = first1, next[1] = kNone;  // the chunk's end
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key[r] == kNone) continue;
      const int64_t sg = key[r];
      if (next[r] != key[r]) {  // the run's last point in the chunk
        atomicAdd(out + sg, (float)cnt[r]);
        if (dt[r] != 0.f) atomicAdd(out + 2 * (int64_t)S + sg, dt[r]);
        if (dd[r] != 0.f) atomicAdd(out + 3 * (int64_t)S + sg, dd[r]);
      }
      if (wpr == 1) {
        if (first[r]) atomicAdd(out + S + sg, 1.f);
      } else if (head[r]) {  // a run start: into the row's set of segments
        uint32_t h = (key[r] * 0x9E3779B1u) >> shift;
        for (;;) {
          const uint32_t old = atomicCAS(tab + h, kNone, key[r]);
          if (old == kNone) atomicAdd(out + S + sg, 1.f);
          if (old == kNone || old == key[r]) break;
          h = (h + 1) & (size - 1);
        }
      }
    }
  }
}

// A row of more than kMaxT points: one block, its segment ids in shared
// memory, each point's adds made one at a time.
__global__ void histogram_block(
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
// edge_seg [E] i32; out [4, S] f32, zeroed here on ``stream`` first.
// Launches zero_output, then (B, T > 0) the histogram kernel.
extern "C" int segment_histogram_launch(const int32_t* choice,
                                        const float* route,
                                        const int32_t* cand_edge,
                                        const int32_t* breaks,
                                        const float* times,
                                        const int32_t* edge_seg, int64_t B,
                                        int32_t T, int32_t K, int32_t S,
                                        float* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (B < 0 || B > 0x7fffffffLL || T < 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)T * sizeof(int32_t);
  if (T > kMaxT && smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int64_t n = 4 * (int64_t)S;
  const int64_t zb = (n + 4 * kZeroThreads - 1) / (4 * kZeroThreads);
  zero_output<<<(unsigned)(zb < 2048 ? zb : 2048), kZeroThreads, 0, st>>>(out, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || B == 0 || T == 0) return (int)e;
  if (T <= kMaxT) {
    static std::atomic<int> cached[rtt::kMaxDevices];
    int resident = 0;
    e = rtt::resident_blocks(histogram_rows, kWarps * 32, cached, &resident);
    if (e != cudaSuccess) return (int)e;
    const int wpr = (T + kChunk - 1) / kChunk;
    const int64_t rpg = kWarps / wpr;
    const int64_t groups = (B + rpg - 1) / rpg;
    cudaLaunchAttribute dep;
    dep.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    dep.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(groups < resident ? groups : resident));
    cfg.blockDim = dim3(kWarps * 32);
    cfg.stream = st;
    cfg.attrs = &dep;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, histogram_rows, choice, route, cand_edge, breaks,
                                   times, edge_seg, B, T, K, S, wpr, out);
  }
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(histogram_block,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  histogram_block<<<(unsigned)B, kThreads, smem, st>>>(
      choice, route, cand_edge, breaks, times, edge_seg, B, T, K, S, out);
  return (int)cudaGetLastError();
}

extern "C" const char* segment_histogram_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
