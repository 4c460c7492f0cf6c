// Viterbi scan (kernel 4 of the match program).
//
// Replaces reporter_tpu/ops/viterbi.py:447 chain_trace (scan branch, no
// carry: the step function at :466-480), :610 backtrace, :814 _compact,
// the confidence block at :553 and :865 pack_compact, stages
// "scan-recursion", "backtrace", "compact-gather" and "confidence".
//
// Work per trace: T-1 max-plus [K] x [K, K] steps (K*K adds and compares
// each), then a reverse walk over the backpointers.  On the H100 it is
// bounded by memory (reading logp, [B, T-1, K, K] floats once) as long as
// enough traces run at once; the recursion is sequential in T, so with
// few traces it is bounded by the chain's latency instead.
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

#include "common.cuh"

namespace {

using rtt::kNegInf;

template <int K>
__global__ void viterbi_scan_kernel(
    const float* __restrict__ emis, const float* __restrict__ logp,
    const float* __restrict__ gc, const float* __restrict__ valid,
    const int32_t* __restrict__ cand_edge,
    const float* __restrict__ cand_offset, int64_t B, int T, float brk,
    int32_t* __restrict__ packed, float* __restrict__ aux) {
  extern __shared__ int8_t smem[];
  const int traces_per_block = blockDim.x / K;
  const int g = threadIdx.x / K;  // group (trace) within the block
  const int j = threadIdx.x % K;  // destination slot
  const int64_t b = (int64_t)blockIdx.x * traces_per_block + g;
  const bool live = b < B;
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
  const float* em = emis + bb * T * K;
  const float* vd = valid + bb * T;
  const int32_t* ce = cand_edge + bb * T * K;
  const float* co = cand_offset + bb * T * K;

  float amin = INFINITY, asum = 0.f, acnt = 0.f, aexh = 0.f;
  float s[K];
  float score = em[j];

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
  if (j == 0) brk_flag[0] = vd[0] != 0.f;
  record(0);
  for (int t = 1; t < T; ++t) {
    const float* lp = logp + ((bb * (T - 1) + (t - 1)) * K) * K;
    float best = __fadd_rn(s[0], lp[j]);
    int bi = 0;
#pragma unroll
    for (int i = 1; i < K; ++i) {
      const float tot = __fadd_rn(s[i], lp[i * K + j]);
      if (tot > best) { best = tot; bi = i; }
    }
    const bool connected = best > kNegInf / 2;
    const bool any = (__ballot_sync(0xffffffffu, connected) & gmask) != 0u;
    // breakage: too far apart, or nothing connects
    const bool broke = gc[bb * (T - 1) + (t - 1)] > brk || !any;
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

  if (!live) return;
  const int64_t plane = B * (int64_t)T;
  for (int t = j; t < T; t += K) {
    const int it = idx[t];
    const int sel = it > 0 ? it : 0;
    const int64_t o = b * T + t;
    packed[o] = it >= 0 ? ce[(int64_t)t * K + sel] : -1;
    packed[plane + o] = __float_as_int(co[(int64_t)t * K + sel]);
    packed[2 * plane + o] = brk_flag[t];
  }
  if (j == 0) {
    aux[b * 4 + 0] = amin;
    aux[b * 4 + 1] = asum;
    aux[b * 4 + 2] = acnt;
    aux[b * 4 + 3] = aexh;
  }
}

template <int K>
int launch(const float* emis, const float* logp, const float* gc,
           const float* valid, const int32_t* cand_edge,
           const float* cand_offset, int64_t B, int T, float brk,
           int32_t* packed, float* aux, cudaStream_t stream) {
  // shared memory per trace: T*K backpointers + 3*T step bytes; shrink the
  // block (down to one warp) before asking for more than the default 48 KB
  const size_t per_trace = (size_t)T * (K + 3);
  int threads = 128;
  while (threads > 32 && (size_t)(threads / K) * per_trace > 48 * 1024)
    threads /= 2;
  const size_t smem = (size_t)(threads / K) * per_trace;
  if (smem > 48 * 1024) {
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_scan_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t traces_per_block = threads / K;
  const int64_t blocks = (B + traces_per_block - 1) / traces_per_block;
  viterbi_scan_kernel<K><<<(unsigned)blocks, threads, smem, stream>>>(
      emis, logp, gc, valid, cand_edge, cand_offset, B, T, brk, packed, aux);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int viterbi_scan_launch(const float* emis, const float* logp,
                                   const float* gc, const float* valid,
                                   const int32_t* cand_edge,
                                   const float* cand_offset, int64_t B,
                                   int32_t T, int32_t K, float brk,
                                   int32_t* packed, float* aux,
                                   void* stream) {
  if (B <= 0 || T <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch<1>(emis, logp, gc, valid, cand_edge, cand_offset, B, T, brk, packed, aux, s);
    case 2: return launch<2>(emis, logp, gc, valid, cand_edge, cand_offset, B, T, brk, packed, aux, s);
    case 4: return launch<4>(emis, logp, gc, valid, cand_edge, cand_offset, B, T, brk, packed, aux, s);
    case 8: return launch<8>(emis, logp, gc, valid, cand_edge, cand_offset, B, T, brk, packed, aux, s);
    case 16: return launch<16>(emis, logp, gc, valid, cand_edge, cand_offset, B, T, brk, packed, aux, s);
    case 32: return launch<32>(emis, logp, gc, valid, cand_edge, cand_offset, B, T, brk, packed, aux, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* viterbi_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
