// Candidate sweep (kernel 1 of the match program).
//
// Replaces reporter_tpu/ops/candidates.py:88 _find_candidates and its
// find_candidates_batch vmap (:171), stage "candidate-sweep", with the
// emission of reporter_tpu/ops/viterbi.py:361 precompute_batch (stage
// "emission") and the candidates' edge-row node ids fused in as an
// epilogue.
//
// Work per point: four cell rows of 8*cap floats (the 2x2 quadrant
// block), a projection of the point onto each of the 4*cap shape
// segments, the m = min(4K, 4*cap) nearest by (distance, index), a
// per-edge dedup and the first K.  The bytes are small (each distinct cell
// row once: ~10 MB at 512 x 64 on the metro city, a few microseconds on
// the H100), so instructions and their latency bound it: ~60 per segment
// (an IEEE division, hypot's root and division), then the selection.
//
// Design: one warp per point; the lanes split the segments.
//   1. Lane l computes item l, l + 32, ... (flat index q = c * cap + j of
//      cell c's segment j); each plane of a cell row is one coalesced run.
//   2. Each item's sort key is (float bits of d) << 32 | q as a uint64.  d
//      is +0.0 or more, or kBig: never NaN (d <= radius fails for NaN,
//      which becomes kBig) and never -0.0 (hypot_like_jax returns
//      max(|u|, |v|) * sqrt(...), or +inf), so unsigned order is the
//      reference's order and q breaks every tie lower-index-first as
//      lax.top_k does.  With 4*cap <= 32 one bitonic sort across the warp
//      (__shfl_xor_sync) leaves pool entry i in lane i.  With more items
//      the warp takes them 32 at a time: each chunk is sorted the same
//      way and merged into a running pool of the m smallest keys in
//      shared memory (each key's place is its rank in its own sequence
//      plus a binary search in the other), so any cap stays exact.
//   3. Dedup by ballot: pool entry i is a duplicate when an earlier entry
//      holds the same live edge; __match_any_sync finds earlier lanes of
//      its 32-entry row, and with m > 32 a scan of the earlier rows'
//      edges (staged in shared memory) the rest.  A kept (live, not
//      duplicate) entry's output slot is the count of kept entries before
//      it; every other entry (a miss or a duplicate, kBig in the
//      reference's second top-k) follows the kept ones in pool order.
//      Only slots below kk = min(K, m) are taken; K - kk pads follow.
//   4. Lane o writes slot o of every field, so a warp's stores are
//      contiguous.  Its entry's fields come by shuffle from the lane that
//      computed the item (4*cap <= 32), or are recomputed from the flat
//      index with the same arithmetic (more items).
// out_dist, out_cx and out_cy may be null together (the packed match path
// reads none of them): they are then not written.

#include "common.cuh"

namespace {

using rtt::kBig;
using rtt::kNegInf;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // points (warps) a block
constexpr uint64_t kNoKey = ~0ull;  // a lane past the items: sorts last

struct Item {
  float d, edge, off, qx, qy;
};

// One shape segment of a cell row (plane-major: ax, ay, bx, by, off, len,
// edge, pad runs of cap values).
__device__ __forceinline__ Item sweep_item(const float* __restrict__ row,
                                           int cap, int j, float px,
                                           float py, float radius) {
  const float ax = row[j], ay = row[cap + j];
  const float bx = row[2 * cap + j], by = row[3 * cap + j];
  const float off0 = row[4 * cap + j], slen = row[5 * cap + j];
  const float ef = row[6 * cap + j];
  const float dx = __fsub_rn(bx, ax), dy = __fsub_rn(by, ay);
  const float len2 = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
  float t = 0.f;
  if (len2 > 0.f) {
    const float num = __fmaf_rn(__fsub_rn(px, ax), dx,
                                __fmul_rn(__fsub_rn(py, ay), dy));
    t = __fdiv_rn(num, len2);
  }
  t = fminf(fmaxf(t, 0.f), 1.f);
  Item it;
  it.qx = __fmaf_rn(t, dx, ax);
  it.qy = __fmaf_rn(t, dy, ay);
  const float d = rtt::hypot_like_jax(__fsub_rn(px, it.qx),
                                      __fsub_rn(py, it.qy));
  it.d = (ef >= 0.f && d <= radius) ? d : kBig;
  it.edge = ef;
  it.off = __fmaf_rn(t, slen, off0);
  return it;
}

__device__ __forceinline__ uint64_t sort_key(float d, int q) {
  return ((uint64_t)__float_as_uint(d) << 32) | (uint32_t)q;
}

// Ascending bitonic sort of one key a lane over blocks of n lanes (n a
// power of two <= 32; block 0 ends ascending).  Keys are distinct, or
// kNoKey.
__device__ __forceinline__ uint64_t warp_sort(uint64_t key, int lane, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const uint64_t other = __shfl_xor_sync(kFull, key, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      key = (keep_min == (other < key)) ? other : key;
    }
  }
  return key;
}

// Number of keys below `key` in the ascending a[0, n), n <= N (a power of
// two): a branchless binary search.
template <int N>
__device__ __forceinline__ int rank_in(const uint64_t* a, int n, uint64_t key) {
  int pos = 0;
#pragma unroll
  for (int step = N; step > 0; step >>= 1)
    if (pos + step <= n && a[pos + step - 1] < key) pos += step;
  return pos;
}

// A warp's shared memory: the pool's two buffers and the sorted chunk
// (merge path), the pool's edges (m > 32) and each output slot's pool item
// (flat index, bit 31 set when the slot is not a kept entry).
template <int MAXM>
struct Smem {
  uint64_t pool[2][MAXM];
  uint64_t chunk[32];
  int edge[MAXM];
  int item[32];
};

template <int MAXM>
__global__ void __launch_bounds__(kWarps * 32) candidate_sweep_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ valid, const float* __restrict__ cell_rows,
    const float* __restrict__ edge_rows, int64_t n_points, int cap, int nx,
    int ny, float x0, float y0, float cell, int k, float radius, float sigma,
    int32_t* __restrict__ out_edge, float* __restrict__ out_off,
    float* __restrict__ out_dist, float* __restrict__ out_cx,
    float* __restrict__ out_cy, float* __restrict__ out_emis,
    int32_t* __restrict__ out_to, int32_t* __restrict__ out_from) {
  constexpr int R = MAXM / 32;  // pool rows of 32 entries
  __shared__ Smem<MAXM> smem[kWarps];
  const int lane = threadIdx.x & 31;
  Smem<MAXM>& sm = smem[threadIdx.x >> 5];
  const int64_t p = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= n_points) return;  // the whole warp
  const float x = px[p], y = py[p];
  const unsigned lanes_below = (1u << lane) - 1u;

  // the 2x2 quadrant cells: the point's cell and its neighbour on the
  // side of each axis the point lies in (border clamping may repeat one)
  const float fx = __fdiv_rn(__fsub_rn(x, x0), cell);
  const float fy = __fdiv_rn(__fsub_rn(y, y0), cell);
  const float flx = floorf(fx), fly = floorf(fy);
  const int cx0 = min(max((int)flx, 0), nx - 1);
  const int cy0 = min(max((int)fly, 0), ny - 1);
  const int sx = (__fsub_rn(fx, flx) >= 0.5f) ? 1 : -1;
  const int sy = (__fsub_rn(fy, fly) >= 0.5f) ? 1 : -1;
  const int cx1 = min(max(cx0 + sx, 0), nx - 1);
  const int cy1 = min(max(cy0 + sy, 0), ny - 1);
  // item q = c * cap + j: segment j of cell c (c = 2 * y-side + x-side)
  auto row_of = [&](int c) {
    const int cy = (c & 2) ? cy1 : cy0, cx = (c & 1) ? cx1 : cx0;
    return cell_rows + (int64_t)(cy * nx + cx) * 8 * cap;
  };
  auto item = [&](int q) {
    const int c = q / cap;
    return sweep_item(row_of(c), cap, q - c * cap, x, y, radius);
  };

  const int n_items = 4 * cap;
  const int m = min(4 * k, n_items);
  const int kk = min(k, m);
  // pool entry 32 r + lane, ascending by (distance, flat index)
  uint64_t pk[R];
  Item mine;  // this lane's item (4 * cap <= 32: item `lane`)
  if (n_items <= 32) {
    mine = item(min(lane, n_items - 1));
    int n = 2;
    while (n < n_items) n <<= 1;
    pk[0] = warp_sort(lane < n_items ? sort_key(mine.d, lane) : kNoKey, lane,
                      n);
#pragma unroll
    for (int r = 1; r < R; ++r) pk[r] = kNoKey;  // m <= n_items <= 32
  } else {
    int psize = 0, cur = 0;
    for (int base = 0; base < n_items; base += 32) {
      const int q = base + lane;
      const uint64_t key = warp_sort(
          q < n_items ? sort_key(item(q).d, q) : kNoKey, lane, 32);
      const int nvalid = min(32, n_items - base);
      const int next = min(psize + nvalid, m);
      const uint64_t* in = sm.pool[cur];
      uint64_t* out = sm.pool[cur ^ 1];
      sm.chunk[lane] = key;
      __syncwarp();
      const int at = lane + rank_in<MAXM>(in, psize, key);
      if (lane < nvalid && at < next) out[at] = key;
      for (int i = lane; i < psize; i += 32) {
        const uint64_t v = in[i];
        const int to = i + rank_in<32>(sm.chunk, 32, v);
        if (to < next) out[to] = v;
      }
      __syncwarp();
      psize = next;
      cur ^= 1;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = 32 * r + lane;
      pk[r] = i < m ? sm.pool[cur][i] : kNoKey;
    }
  }

  // dedup: a live entry whose edge an earlier entry holds is dropped to
  // kBig; the kept entries take the first slots, the rest follow
  int ed[R];
  bool kept[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = 32 * r + lane;
    const int q = (int)(uint32_t)pk[r];
    const bool live = i < m && __uint_as_float((uint32_t)(pk[r] >> 32)) < kBig / 2;
    float ef;
    if (n_items <= 32) {
      ef = __shfl_sync(kFull, mine.edge, q & 31);
    } else {
      const int c = live ? q / cap : 0;
      ef = live ? row_of(c)[6 * cap + q - c * cap] : -1.f;
    }
    ed[r] = live ? (int)ef : -1;
    // lanes that hold no live entry get values no edge id takes
    const unsigned same = __match_any_sync(kFull, live ? ed[r] : -1 - lane);
    kept[r] = live && (same & lanes_below) == 0;
    if (R > 1 && i < m) sm.edge[i] = ed[r];
  }
  if (R > 1) {
    __syncwarp();
#pragma unroll
    for (int r = 1; r < R; ++r) {
      if (32 * r >= m) break;
      for (int e = 0; e < 32 * r; ++e)
        kept[r] = kept[r] && sm.edge[e] != ed[r];
    }
  }
  unsigned kept_b[R];
  int n_kept = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    kept_b[r] = __ballot_sync(kFull, kept[r]);
    n_kept += __popc(kept_b[r]);
  }
  int kept_before = 0, rest_before = n_kept;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = 32 * r + lane;
    const unsigned rest_b = __ballot_sync(kFull, i < m && !kept[r]);
    const int slot = kept[r] ? kept_before + __popc(kept_b[r] & lanes_below)
                             : rest_before + __popc(rest_b & lanes_below);
    if (i < m && slot < kk)
      sm.item[slot] = (int)((uint32_t)pk[r] | (kept[r] ? 0u : 0x80000000u));
    kept_before += __popc(kept_b[r]);
    rest_before += __popc(rest_b);
  }
  __syncwarp();

  // lane o writes output slot o: pool entries up to kk, then pads
  const int o = lane;
  const int v = sm.item[o < kk ? o : 0];
  const int q = v & 0x7fffffff;
  const bool live = o < kk && v >= 0;
  Item it = {kBig, -1.f, 0.f, 0.f, 0.f};
  if (n_items <= 32) {
    const int src = q & 31;
    it.d = __shfl_sync(kFull, mine.d, src);
    it.edge = __shfl_sync(kFull, mine.edge, src);
    it.off = __shfl_sync(kFull, mine.off, src);
    it.qx = __shfl_sync(kFull, mine.qx, src);
    it.qy = __shfl_sync(kFull, mine.qy, src);
  } else if (o < kk) {
    it = item(q);
  }
  if (o >= k) return;
  // a pad: a sparse grid can hold fewer items than the beam
  if (o >= kk) it = {kBig, -1.f, 0.f, 0.f, 0.f};
  const int64_t at = p * k + o;
  const int32_t e = live ? (int32_t)it.edge : -1;
  const float dist = live ? it.d : INFINITY;
  out_edge[at] = e;
  out_off[at] = it.off;
  if (out_dist) {  // null on the packed path, which never reads them
    out_dist[at] = dist;
    out_cx[at] = it.qx;
    out_cy[at] = it.qy;
  }
  float em = kNegInf;
  if (live && valid[p] != 0.f) {
    const float qd = __fdiv_rn(dist, sigma);
    em = __fmul_rn(-0.5f, __fmul_rn(qd, qd));
  }
  out_emis[at] = em;
  const int64_t er = (int64_t)(e >= 0 ? e : 0) * 8;
  out_to[at] = __float_as_int(edge_rows[er]);
  out_from[at] = __float_as_int(edge_rows[er + 1]);
}

}  // namespace

extern "C" int candidate_sweep_launch(
    const float* px, const float* py, const float* valid,
    const float* cell_rows, const float* edge_rows, int64_t n_points,
    int32_t cap, int32_t nx, int32_t ny, float x0, float y0, float cell,
    int32_t k, float radius, float sigma, int32_t* out_edge, float* out_off,
    float* out_dist, float* out_cx, float* out_cy, float* out_emis,
    int32_t* out_to, int32_t* out_from, void* stream) {
  if (k < 1 || k > 32 || cap < 1 || cap > (1 << 28))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n_points + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (4 * (k < cap ? k : cap) <= 32)  // m = min(4K, 4 cap): one pool row
    candidate_sweep_kernel<32><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        px, py, valid, cell_rows, edge_rows, n_points, cap, nx, ny, x0, y0,
        cell, k, radius, sigma, out_edge, out_off, out_dist, out_cx, out_cy,
        out_emis, out_to, out_from);
  else
    candidate_sweep_kernel<128><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        px, py, valid, cell_rows, edge_rows, n_points, cap, nx, ny, x0, y0,
        cell, k, radius, sigma, out_edge, out_off, out_dist, out_cx, out_cy,
        out_emis, out_to, out_from);
  return (int)cudaGetLastError();
}

extern "C" const char* candidate_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
