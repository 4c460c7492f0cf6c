// Viterbi scan (kernel 4 of the match program): a window that starts
// fresh, stages "scan-recursion", "backtrace", "compact-gather" and
// "confidence".  The kernel body is viterbi_core.cuh's, without the
// carry; what it replaces, what bounds it and its design are written
// there.  viterbi_scan_sparse_launch runs the SPARSE instantiation: each
// step's breakage threshold from its gap in ``times``.

#include "viterbi_core.cuh"

namespace {

ViterbiArgs scan_args(const float* emis, const float* logp, const float* gc,
                      const float* valid, const int32_t* cand_edge,
                      const float* cand_offset, int64_t B, int32_t T,
                      float brk, int32_t* packed, float* aux) {
  ViterbiArgs a = {};
  a.emis = emis;
  a.logp = logp;
  a.gc = gc;
  a.valid = valid;
  a.cand_edge = cand_edge;
  a.cand_offset = cand_offset;
  a.B = B;
  a.T = T;
  a.brk = brk;
  a.packed = packed;
  a.aux = aux;
  return a;
}

}  // namespace

extern "C" int viterbi_scan_launch(const float* emis, const float* logp,
                                   const float* gc, const float* valid,
                                   const int32_t* cand_edge,
                                   const float* cand_offset, int64_t B,
                                   int32_t T, int32_t K, float brk,
                                   int32_t* packed, float* aux,
                                   void* stream) {
  const ViterbiArgs a = scan_args(emis, logp, gc, valid, cand_edge,
                                  cand_offset, B, T, brk, packed, aux);
  return launch_k<false, false>(K, a, (cudaStream_t)stream);
}

// The dense arguments, then times [B, T] and the sparse model's six
// scalars.
extern "C" int viterbi_scan_sparse_launch(
    const float* emis, const float* logp, const float* gc, const float* valid,
    const int32_t* cand_edge, const float* cand_offset, int64_t B, int32_t T,
    int32_t K, float brk, int32_t* packed, float* aux, const float* times,
    float beta_ref, float beta_scale, float beta_max, float break_speed,
    float vmax, float plaus_weight, void* stream) {
  ViterbiArgs a = scan_args(emis, logp, gc, valid, cand_edge, cand_offset, B,
                            T, brk, packed, aux);
  a.times = times;
  a.sa = {beta_ref, beta_scale, beta_max, break_speed, vmax, plaus_weight};
  return launch_k<false, true>(K, a, (cudaStream_t)stream);
}

extern "C" const char* viterbi_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
