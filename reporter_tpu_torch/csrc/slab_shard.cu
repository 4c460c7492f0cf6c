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
// the [B] slot map and the [B, 3K + 5] block once), in practice by
// launch latency.
//
// Design: one thread per (row, word): row b = i / W, word w = i % W; the
// thread maps its word to the leaf it lives in and copies 4 bytes (the
// active flag widened from its byte).  Neighbouring threads touch
// neighbouring words of a row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// The address of word w of slab row r (w < 3K + 5; the active byte is
// handled by the caller).
__device__ __forceinline__ int32_t* word(const Leaves& L, int64_t r, int w,
                                         int K) {
  if (w < K) return L.scores + r * K + w;
  if (w < 2 * K) return L.edge + r * K + (w - K);
  if (w < 3 * K) return L.offset + r * K + (w - 2 * K);
  switch (w - 3 * K) {
    case 0: return L.x + r;
    case 1: return L.y + r;
    case 2: return L.t + r;
    default: return L.committed + r;  // 4; 3 is the active byte
  }
}

__global__ void gather_owned(Leaves L, int64_t s_local, int64_t lo,
                             const int32_t* __restrict__ slots, int64_t B,
                             int K, int32_t* __restrict__ out) {
  const int W = 3 * K + 5;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * W) return;
  const int64_t b = i / W;
  const int w = (int)(i % W);
  const int64_t loc = (int64_t)slots[b] - lo;
  int32_t v = 0;
  if (loc >= 0 && loc < s_local)
    v = w == 3 * K + 3 ? (int32_t)L.active[loc] : *word(L, loc, w, K);
  out[i] = v;
}

__global__ void scatter_owned(Leaves L, int64_t s_local, int64_t lo,
                              const int32_t* __restrict__ slots, int64_t B,
                              int K, const int32_t* __restrict__ in) {
  const int W = 3 * K + 5;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * W) return;
  const int64_t b = i / W;
  const int w = (int)(i % W);
  const int64_t loc = (int64_t)slots[b] - lo;
  if (loc < 0 || loc >= s_local) return;  // another rank's row, or padding
  if (w == 3 * K + 3)
    L.active[loc] = in[i] != 0;
  else
    *word(L, loc, w, K) = in[i];
}

inline Leaves leaves(void* scores, void* edge, void* offset, void* x, void* y,
                     void* t, void* active, void* committed) {
  return {static_cast<int32_t*>(scores), static_cast<int32_t*>(edge),
          static_cast<int32_t*>(offset), static_cast<int32_t*>(x),
          static_cast<int32_t*>(y),      static_cast<int32_t*>(t),
          static_cast<uint8_t*>(active), static_cast<int32_t*>(committed)};
}

inline int grid(int64_t B, int K, unsigned* blocks) {
  const int64_t n = B * (3 * K + 5);
  const int64_t nb = (n + kThreads - 1) / kThreads;
  if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)nb;
  return 0;
}

}  // namespace

// The shard's eight leaves (the float ones as their bits), its length
// s_local and first global slot lo, the step's [B] global slots, K; out
// [B, 3K + 5] int32.
extern "C" int slab_gather_owned_launch(void* scores, void* edge, void* offset,
                                        void* x, void* y, void* t, void* active,
                                        void* committed, int64_t s_local,
                                        int64_t lo, const int32_t* slots,
                                        int64_t B, int32_t K, int32_t* out,
                                        void* stream) {
  unsigned blocks = 0;
  if (B <= 0) return 0;
  if (const int e = grid(B, K, &blocks)) return e;
  gather_owned<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      leaves(scores, edge, offset, x, y, t, active, committed), s_local, lo,
      slots, B, K, out);
  return (int)cudaGetLastError();
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
  unsigned blocks = 0;
  if (B <= 0) return 0;
  if (const int e = grid(B, K, &blocks)) return e;
  scatter_owned<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      leaves(scores, edge, offset, x, y, t, active, committed), s_local, lo,
      slots, B, K, in);
  return (int)cudaGetLastError();
}

extern "C" const char* slab_shard_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
