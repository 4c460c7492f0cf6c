// The slot-sharded session slab's gather and scatter (kernel 11c): one dp
// rank's side of a session step whose beam slab is split over the dp
// axis, each rank holding S_local = S / n_dp consecutive slots from its
// first global slot lo.
//
// Replaces reporter_tpu/ops/viterbi.py:1047 _arena_gather_mesh and :1082
// _arena_scatter_mesh, inside :1103 session_step_arena_mesh:
//   slab_gather_owned_launch   for each row b of the step's global [B]
//       slot map, the rank writes the row's carry as int32 bit patterns,
//       [B, 3K + 5] words (scores K, edge K, offset K, x, y, t, active,
//       committed), when it owns slots[b], and zeros otherwise; the sum of
//       the ranks' blocks (the wrapper's psum over dp) is then exactly the
//       owner's bytes, -0.0 and NaN payloads included, and zeros for a
//       padding row (slot == S, owned by nobody);
//   slab_scatter_owned_launch  from the all-gathered [B, 3K + 5] carry-out
//       words of every rank, the rank writes the rows whose slots it owns
//       into its slab and drops the rest (the reference's mode="drop").
// Each live slot appears at most once per step (the dispatcher folds a
// batch to one row per session), so no two rows write one slot.
//
// Work: B x (3K + 5) words each way, ~2 KB of owned rows per rank at the
// session shape; bounded by memory (each owned row read or written once,
// the [B] slot map and the [B, 3K + 5] block once), in practice by the
// launch and two dependent memory latencies (the slot, then the row).
//
// Design: a warp a row.  Lane l copies words l, l + 32, ... (NW <= 4 of
// them at K <= 32) of every row; the leaf, column and per-row stride of
// each of those words depend only on K and the lane, so the lane forms
// them once (LaneMap; K is a template argument, 1-32, so the map folds to
// a few selects) and a row costs one multiply-add an address, with no
// division by the row width.  One lane reads the row's slot and a shuffle
// broadcasts it, so ownership is one warp-uniform test: an unowned row is
// W zeros written (gather) or nothing read (scatter); an owned row's words
// are all read before any is written.  Measured (PERF.md §6, row 11c): both
// kernels sit within 1 us of the launch floor of back-to-back launches,
// the rest being the slot read and the row read it feeds; two or four rows
// a warp, or 16-byte loads, did not help at the step's sizes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows a block takes at a time
constexpr unsigned kAll = 0xffffffffu;

// TraceCarry leaves of a slab shard, [S_local, K] scores / edge / offset
// and [S_local] x, y, t, active (bytes), committed.
struct Leaves {
  int32_t* scores;
  int32_t* edge;
  int32_t* offset;
  int32_t* x;
  int32_t* y;
  int32_t* t;
  uint8_t* active;
  int32_t* committed;
};

__host__ __device__ constexpr int words_a_lane(int K) { return (3 * K + 5 + 31) / 32; }

// Word lane + 32 j of every slab row r lives at base[j] + r * stride[j]
// bytes: stride 4K for the [K]-wide leaves, 4 for x, y, t and committed,
// 1 for the active byte, 0 past the row's end (w >= 3K + 5).
template <int K>
struct LaneMap {
  char* base[words_a_lane(K)];
  int stride[words_a_lane(K)];
};

template <int K>
__device__ __forceinline__ LaneMap<K> lane_map(const Leaves& L, int lane) {
  LaneMap<K> m;
#pragma unroll
  for (int j = 0; j < words_a_lane(K); ++j) {
    const int w = lane + 32 * j;
    char* p = nullptr;
    int s = 4;
    if (w < K) {
      p = reinterpret_cast<char*>(L.scores + w), s = 4 * K;
    } else if (w < 2 * K) {
      p = reinterpret_cast<char*>(L.edge + (w - K)), s = 4 * K;
    } else if (w < 3 * K) {
      p = reinterpret_cast<char*>(L.offset + (w - 2 * K)), s = 4 * K;
    } else {
      switch (w - 3 * K) {
        case 0: p = reinterpret_cast<char*>(L.x); break;
        case 1: p = reinterpret_cast<char*>(L.y); break;
        case 2: p = reinterpret_cast<char*>(L.t); break;
        case 3: p = reinterpret_cast<char*>(L.active), s = 1; break;
        case 4: p = reinterpret_cast<char*>(L.committed); break;
        default: s = 0;
      }
    }
    m.base[j] = p;
    m.stride[j] = s;
  }
  return m;
}

template <int K>
__global__ void __launch_bounds__(32 * kWarps)
    gather_owned(Leaves L, int64_t s_local, int64_t lo, const int32_t* __restrict__ slots,
                 int64_t B, int32_t* __restrict__ out) {
  constexpr int W = 3 * K + 5, NW = words_a_lane(K);
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  int32_t slot = 0;  // lane 0 reads it, before the lane map is formed
  if (lane == 0) slot = __ldg(slots + b);
  const LaneMap<K> m = lane_map<K>(L, lane);
  const int64_t loc = (int64_t)__shfl_sync(kAll, slot, 0) - lo;
  const bool own = loc >= 0 && loc < s_local;
  int32_t v[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    v[j] = 0;
    if (own && m.stride[j] != 0) {
      const char* p = m.base[j] + loc * m.stride[j];
      v[j] = m.stride[j] == 1 ? (int32_t)__ldg(reinterpret_cast<const uint8_t*>(p))
                              : __ldg(reinterpret_cast<const int32_t*>(p));
    }
  }
#pragma unroll
  for (int j = 0; j < NW; ++j)
    if (lane + 32 * j < W) out[b * W + lane + 32 * j] = v[j];
}

template <int K>
__global__ void __launch_bounds__(32 * kWarps)
    scatter_owned(Leaves L, int64_t s_local, int64_t lo, const int32_t* __restrict__ slots,
                  int64_t B, const int32_t* __restrict__ in) {
  constexpr int W = 3 * K + 5, NW = words_a_lane(K);
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  int32_t slot = 0;
  if (lane == 0) slot = __ldg(slots + b);
  const int64_t loc = (int64_t)__shfl_sync(kAll, slot, 0) - lo;
  if (loc < 0 || loc >= s_local) return;  // another rank's row, or padding: nothing read
  int32_t v[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) v[j] = lane + 32 * j < W ? in[b * W + lane + 32 * j] : 0;
  const LaneMap<K> m = lane_map<K>(L, lane);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    if (m.stride[j] == 0) continue;
    char* p = m.base[j] + loc * m.stride[j];
    if (m.stride[j] == 1)
      *reinterpret_cast<uint8_t*>(p) = v[j] != 0;
    else
      *reinterpret_cast<int32_t*>(p) = v[j];
  }
}

inline Leaves leaves(void* scores, void* edge, void* offset, void* x, void* y,
                     void* t, void* active, void* committed) {
  return {static_cast<int32_t*>(scores), static_cast<int32_t*>(edge),
          static_cast<int32_t*>(offset), static_cast<int32_t*>(x),
          static_cast<int32_t*>(y),      static_cast<int32_t*>(t),
          static_cast<uint8_t*>(active), static_cast<int32_t*>(committed)};
}

// The kernel for this k (1-32), a row a warp.
template <int K>
int launch(bool gather, int k, const Leaves& L, int64_t s_local, int64_t lo,
           const int32_t* slots, int64_t B, int32_t* words, cudaStream_t stream) {
  if constexpr (K > 32) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (k != K) return launch<K + 1>(gather, k, L, s_local, lo, slots, B, words, stream);
    const int64_t nb = (B + kWarps - 1) / kWarps;
    if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (gather)
      gather_owned<K><<<(unsigned)nb, 32 * kWarps, 0, stream>>>(L, s_local, lo, slots, B, words);
    else
      scatter_owned<K><<<(unsigned)nb, 32 * kWarps, 0, stream>>>(L, s_local, lo, slots, B, words);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// The shard's eight leaves (the float ones as their bits), its length
// s_local and first global slot lo, the step's [B] global slots, K (1-32);
// out [B, 3K + 5] int32.
extern "C" int slab_gather_owned_launch(void* scores, void* edge, void* offset,
                                        void* x, void* y, void* t, void* active,
                                        void* committed, int64_t s_local,
                                        int64_t lo, const int32_t* slots,
                                        int64_t B, int32_t K, int32_t* out,
                                        void* stream) {
  if (B <= 0) return 0;
  return launch<1>(true, K, leaves(scores, edge, offset, x, y, t, active, committed), s_local,
                   lo, slots, B, out, (cudaStream_t)stream);
}

// The same shard and slots; in [B, 3K + 5] int32, every rank's carry-out
// rows in global row order.
extern "C" int slab_scatter_owned_launch(void* scores, void* edge,
                                         void* offset, void* x, void* y,
                                         void* t, void* active,
                                         void* committed, int64_t s_local,
                                         int64_t lo, const int32_t* slots,
                                         int64_t B, int32_t K,
                                         const int32_t* in, void* stream) {
  if (B <= 0) return 0;
  return launch<1>(false, K, leaves(scores, edge, offset, x, y, t, active, committed), s_local,
                   lo, slots, B, const_cast<int32_t*>(in), (cudaStream_t)stream);
}

extern "C" const char* slab_shard_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
