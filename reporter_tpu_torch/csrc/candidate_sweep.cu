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
// segments, the 4K nearest by (distance, index), a per-edge dedup and the
// first K.  On the H100 it is bounded by memory: each point gathers
// 4 * 32 * cap bytes of cell rows, which neighbouring points of a trace
// mostly share through L1/L2; the arithmetic (~30 flops per segment) is
// far below the float32 rate.
//
// Design: one thread per point.  The pool is kept by insertion into a
// sorted local array while the segments are visited in index order, with
// a strict < comparison, which reproduces lax.top_k(-d)'s lower-index-
// first tie rule.  Pool entries store only (distance, index); an entry's
// other fields are recomputed from its index with the same arithmetic,
// so they are identical and the array stays small.  out_dist, out_cx and
// out_cy may be null together (the packed match path reads none of them):
// they are then not written.

#include "common.cuh"

namespace {

using rtt::kBig;
using rtt::kNegInf;

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

template <int MAXM>
__global__ void candidate_sweep_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ valid, const float* __restrict__ cell_rows,
    const float* __restrict__ edge_rows, int64_t n_points, int cap, int nx,
    int ny, float x0, float y0, float cell, int k, float radius, float sigma,
    int32_t* __restrict__ out_edge, float* __restrict__ out_off,
    float* __restrict__ out_dist, float* __restrict__ out_cx,
    float* __restrict__ out_cy, float* __restrict__ out_emis,
    int32_t* __restrict__ out_to, int32_t* __restrict__ out_from) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_points) return;
  const float x = px[p], y = py[p];

  // the 2x2 quadrant cells: the point's cell and its neighbour on the
  // side of each axis the point lies in (border clamping may repeat one)
  const float fx = __fdiv_rn(__fsub_rn(x, x0), cell);
  const float fy = __fdiv_rn(__fsub_rn(y, y0), cell);
  const float flx = floorf(fx), fly = floorf(fy);
  const int cx0 = min(max((int)flx, 0), nx - 1);
  const int cy0 = min(max((int)fly, 0), ny - 1);
  const int sx = (__fsub_rn(fx, flx) >= 0.5f) ? 1 : -1;
  const int sy = (__fsub_rn(fy, fly) >= 0.5f) ? 1 : -1;
  const int ncx[2] = {cx0, min(max(cx0 + sx, 0), nx - 1)};
  const int ncy[2] = {cy0, min(max(cy0 + sy, 0), ny - 1)};
  const float* rows[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    rows[c] = cell_rows + (int64_t)(ncy[c >> 1] * nx + ncx[c & 1]) * 8 * cap;

  // pool: the m nearest items by (distance, flat index), ascending
  const int n_items = 4 * cap;
  const int m = min(4 * k, n_items);
  float pd[MAXM];
  int pidx[MAXM];
  int cnt = 0;
  for (int c = 0; c < 4; ++c) {
    for (int j = 0; j < cap; ++j) {
      const float d = sweep_item(rows[c], cap, j, x, y, radius).d;
      int pos;
      if (cnt < m) {
        pos = cnt++;
      } else if (d < pd[m - 1]) {
        pos = m - 1;
      } else {
        continue;
      }
      while (pos > 0 && d < pd[pos - 1]) {
        pd[pos] = pd[pos - 1];
        pidx[pos] = pidx[pos - 1];
        --pos;
      }
      pd[pos] = d;
      pidx[pos] = c * cap + j;
    }
  }

  // selection: the first K of the pool sorted by (distance with later
  // duplicates of an edge pushed to kBig, pool index).  The live
  // non-duplicate entries come first in pool order, then every kBig entry
  // (misses and duplicates) in pool order.
  int kept[MAXM];  // edge id of a live non-duplicate entry, else -1
  const int kk = min(k, m);
  int o = 0;
  const int64_t base = p * k;
  const bool point_ok = valid[p] != 0.f;
  auto emit = [&](const Item& it, bool live) {
    const int32_t e = live ? (int32_t)it.edge : -1;
    const float dist = live ? it.d : INFINITY;
    out_edge[base + o] = e;
    out_off[base + o] = it.off;
    if (out_dist) {  // null on the packed path, which never reads them
      out_dist[base + o] = dist;
      out_cx[base + o] = it.qx;
      out_cy[base + o] = it.qy;
    }
    float em = kNegInf;
    if (live && point_ok) {
      const float q = __fdiv_rn(dist, sigma);
      em = __fmul_rn(-0.5f, __fmul_rn(q, q));
    }
    out_emis[base + o] = em;
    const int64_t er = (int64_t)(e >= 0 ? e : 0) * 8;
    out_to[base + o] = __float_as_int(edge_rows[er]);
    out_from[base + o] = __float_as_int(edge_rows[er + 1]);
    ++o;
  };
  for (int q = 0; q < m; ++q) {
    int e = -1;
    if (pd[q] < kBig / 2) {
      const int id = pidx[q];
      e = (int)sweep_item(rows[id / cap], cap, id % cap, x, y, radius).edge;
      for (int r = 0; r < q; ++r)
        if (kept[r] == e) { e = -1; break; }
    }
    kept[q] = e;
    if (e >= 0 && o < kk) {
      const int id = pidx[q];
      emit(sweep_item(rows[id / cap], cap, id % cap, x, y, radius), true);
    }
  }
  for (int q = 0; q < m && o < kk; ++q) {
    if (kept[q] >= 0) continue;
    const int id = pidx[q];
    emit(sweep_item(rows[id / cap], cap, id % cap, x, y, radius), false);
  }
  for (; o < k;) {  // a sparse grid can hold fewer items than the beam
    Item pad;
    pad.d = kBig;
    pad.edge = -1.f;
    pad.off = 0.f;
    pad.qx = 0.f;
    pad.qy = 0.f;
    emit(pad, false);
  }
}

}  // namespace

extern "C" int candidate_sweep_launch(
    const float* px, const float* py, const float* valid,
    const float* cell_rows, const float* edge_rows, int64_t n_points,
    int32_t cap, int32_t nx, int32_t ny, float x0, float y0, float cell,
    int32_t k, float radius, float sigma, int32_t* out_edge, float* out_off,
    float* out_dist, float* out_cx, float* out_cy, float* out_emis,
    int32_t* out_to, int32_t* out_from, void* stream) {
  if (k < 1 || k > 32 || cap < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n_points + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (4 * k <= 32)
    candidate_sweep_kernel<32><<<blocks, threads, 0, s>>>(
        px, py, valid, cell_rows, edge_rows, n_points, cap, nx, ny, x0, y0,
        cell, k, radius, sigma, out_edge, out_off, out_dist, out_cx, out_cy,
        out_emis, out_to, out_from);
  else
    candidate_sweep_kernel<128><<<blocks, threads, 0, s>>>(
        px, py, valid, cell_rows, edge_rows, n_points, cap, nx, ny, x0, y0,
        cell, k, radius, sigma, out_edge, out_off, out_dist, out_cx, out_cy,
        out_emis, out_to, out_from);
  return (int)cudaGetLastError();
}

extern "C" const char* candidate_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
