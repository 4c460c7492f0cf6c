// Viterbi scan (kernel 4 of the match program): a window that starts
// fresh, stages "scan-recursion", "backtrace", "compact-gather" and
// "confidence".  The kernel body is viterbi_core.cuh's, without the
// carry; what it replaces, what bounds it and its design are written
// there.

#include "viterbi_core.cuh"

extern "C" int viterbi_scan_launch(const float* emis, const float* logp,
                                   const float* gc, const float* valid,
                                   const int32_t* cand_edge,
                                   const float* cand_offset, int64_t B,
                                   int32_t T, int32_t K, float brk,
                                   int32_t* packed, float* aux,
                                   void* stream) {
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
  return launch_k<false>(K, a, (cudaStream_t)stream);
}

extern "C" const char* viterbi_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
