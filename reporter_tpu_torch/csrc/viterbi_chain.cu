// Viterbi chain (kernel 5 of the match program): a window that continues
// a carried beam, for long traces (one launch per 256-point window, the
// carry chaining window to window) and for session steps (one launch per
// step, the carry in [B]-leading tensors or in the session slab).
//
// Replaces reporter_tpu/ops/viterbi.py:447 chain_trace with its carry
// branch (:487-510 seam transition, :574-607 seam check and carry-out) as
// vmapped by :936 chain_batch_carry_packed, :954 its _aux variant and
// :971 session_step_packed, and :1001 session_step_arena with its slab
// gather (:1029-1037), carried-versus-inactive select and in-place
// scatter (:1042-1043), which are fused into this launch: a row reads
// slab[slots[b]] when use[b], starts from the inactive carry otherwise,
// and writes its successor back to slab[slots[b]] unless slots[b] >= S.
//
// What bounds it and the design are in viterbi_core.cuh (CARRY = true);
// viterbi_chain_sparse_launch runs the SPARSE instantiation (the sparse
// seam transition and gap-conditioned breakage).
//
// The seam adds K*K serial UBODT probes per trace (each two 512-byte
// bucket rows, or one 1 KB row of a wide32 table, random in a table far
// larger than L2) to the scan's work:
// at the session shape [512, 4] they are most of the bytes the launch
// moves.

#include "viterbi_core.cuh"

extern "C" int viterbi_chain_launch(CHAIN_PARAMS, void* stream) {
  const ViterbiArgs a = chain_args(CHAIN_ARGS);
  return launch_k<true, false>(K, a, (cudaStream_t)stream);
}

// The dense arguments, then the sparse model's six scalars.
extern "C" int viterbi_chain_sparse_launch(
    CHAIN_PARAMS, float beta_ref, float beta_scale, float beta_max,
    float break_speed, float vmax, float plaus_weight, void* stream) {
  ViterbiArgs a = chain_args(CHAIN_ARGS);
  a.sa = {beta_ref, beta_scale, beta_max, break_speed, vmax, plaus_weight};
  return launch_k<true, true>(K, a, (cudaStream_t)stream);
}

extern "C" const char* viterbi_chain_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
