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

namespace {

ViterbiArgs chain_args(
    const float* emis, const float* logp, const float* gc, const float* valid,
    const int32_t* cand_edge, const float* cand_offset, const float* px,
    const float* py, const float* times, const float* edge_rows,
    const int32_t* ubodt, int32_t bmask, int32_t wide, int64_t B, int32_t T,
    float brk,
    float sigma, float beta, float radius, float max_route_factor,
    float max_time_factor, float turn_factor, const float* in_scores,
    const int32_t* in_edge, const float* in_offset, const float* in_x,
    const float* in_y, const float* in_t, const uint8_t* in_active,
    const int32_t* in_committed, float* out_scores, int32_t* out_edge,
    float* out_offset, float* out_x, float* out_y, float* out_t,
    uint8_t* out_active, int32_t* out_committed, const int32_t* slots,
    const uint8_t* use, int64_t S, int32_t* packed, float* aux) {
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
  a.px = px;
  a.py = py;
  a.times = times;
  a.edge_rows = edge_rows;
  a.ubodt = reinterpret_cast<const int4*>(ubodt);
  a.bmask = (uint32_t)bmask;
  a.wide = wide != 0;
  a.tp = {sigma, beta, radius, max_route_factor, max_time_factor,
          turn_factor};
  a.in = {in_scores, in_edge, in_offset, in_x, in_y, in_t, in_active,
          in_committed};
  a.out = {out_scores, out_edge, out_offset, out_x, out_y, out_t, out_active,
           out_committed};
  a.slots = slots;
  a.use = use;
  a.S = S;
  return a;
}

}  // namespace

#define CHAIN_PARAMS                                                         \
    const float *emis, const float *logp, const float *gc,                   \
    const float *valid, const int32_t *cand_edge, const float *cand_offset,  \
    const float *px, const float *py, const float *times,                    \
    const float *edge_rows, const int32_t *ubodt, int32_t bmask,             \
    int32_t wide, int64_t B, int32_t T, int32_t K, float brk, float sigma,   \
    float beta, float radius,                                                \
    float max_route_factor, float max_time_factor, float turn_factor,        \
    const float *in_scores, const int32_t *in_edge, const float *in_offset,  \
    const float *in_x, const float *in_y, const float *in_t,                 \
    const uint8_t *in_active, const int32_t *in_committed,                   \
    float *out_scores, int32_t *out_edge, float *out_offset, float *out_x,   \
    float *out_y, float *out_t, uint8_t *out_active, int32_t *out_committed, \
    const int32_t *slots, const uint8_t *use, int64_t S, int32_t *packed,    \
    float *aux
#define CHAIN_ARGS                                                           \
    emis, logp, gc, valid, cand_edge, cand_offset, px, py, times, edge_rows, \
    ubodt, bmask, wide, B, T, brk, sigma, beta, radius, max_route_factor,    \
    max_time_factor, turn_factor, in_scores, in_edge, in_offset, in_x, in_y, \
    in_t, in_active, in_committed, out_scores, out_edge, out_offset, out_x,  \
    out_y, out_t, out_active, out_committed, slots, use, S, packed, aux

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
