// Helpers shared by the port's kernels: float arithmetic, the decode of a
// step of a [B, T] batch, and the occupancy query of persistent grids.
// The kernels repeat the float32 arithmetic of the reference as XLA
// compiles it: XLA's CPU backend always lets LLVM contract a product
// feeding a sum into a fused multiply-add, so the kernels use __fmaf_rn
// exactly at those sites and explicit _rn intrinsics everywhere else (the
// build also passes --fmad=false, so nvcc contracts nothing on its own).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace rtt {

constexpr int kMaxDevices = 64;  // per-device launch caches
constexpr float kBig = 1e30f;      // finite miss marker during selection
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kMinNormal = 1.17549435082228750797e-38f;  // 2^-126

// jnp.hypot's float32 expansion: max * sqrt(1 + (min/max)^2), 0 when
// max == 0, inf when either leg is inf, with 1 + r*r fused as XLA
// compiles it.  hypotf rounds differently.  The larger leg is a NaN leg
// where there is one, as XLA's max and torch.maximum propagate NaN: a
// NaN beside a 0 gives NaN, not the 0 of max == 0 (an inf leg still
// gives inf).  XLA's CPU backend runs with denormals flushed, so a leg
// below 2^-126 reads as 0; here only this helper flushes (the kernels are
// built without -ftz).  With both legs flushed the result is 0 or at least
// the larger leg, so it needs no flush of its own.
__device__ __forceinline__ float hypot_like_jax(float u, float v) {
  const float a0 = fabsf(u), b0 = fabsf(v);
  const float a = a0 < kMinNormal ? 0.f : a0;
  const float b = b0 < kMinNormal ? 0.f : b0;
  const bool inf = isinf(a) || isinf(b);
  const bool big = a > b || a != a;
  const float m = big ? a : b;
  const float n = big ? b : a;
  const float safe = (m == 0.f) ? 1.f : m;
  const float r = __fdiv_rn(n, safe);
  const float x = (m == 0.f)
      ? m : __fmul_rn(m, __fsqrt_rn(__fmaf_rn(r, r, 1.f)));
  return inf ? INFINITY : x;
}

// A step r = b * (T-1) + t of a [B, T] batch's B * (T-1) consecutive-point
// steps, and its first point p = b * T + t = r + b: b = r / (T-1) as
// (umulhi(r, mul) + r) >> shr in 32-bit arithmetic (ops/hashtable.py
// fast_divmod, made on the host by step_decode) when there are fewer than
// 2^31 steps, else in int64.
struct StepDecode {
  int64_t tm1;
  uint32_t mul, shr;
  bool fast;

  __device__ __forceinline__ int64_t point(int64_t r) const {
    if (fast) {
      const uint32_t r32 = (uint32_t)r;
      return r + (int64_t)((__umulhi(r32, mul) + r32) >> shr);
    }
    return r + r / tm1;
  }
};

// l = ceil(log2 d), mul = ceil(2^(32+l) / d) - 2^32 for d = T - 1 >= 1:
// exact for every r < 2^31.
inline StepDecode step_decode(int64_t n_steps, int32_t T) {
  StepDecode dec = {T - 1, 0, 0, n_steps < 0x7fffffffLL};
  const uint64_t d = (uint64_t)(T - 1);
  while ((1ull << dec.shr) < d) ++dec.shr;
  dec.mul = (uint32_t)((((1ull << (32 + dec.shr)) + d - 1) / d) - (1ull << 32));
  return dec;
}

// The blocks of ``kernel`` (``threads`` a block, no dynamic shared
// memory) that the device's SMs hold at once: the occupancy calculator,
// asked once per device and kept in ``cached`` (one array a kernel).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads,
                            std::atomic<int> (&cached)[kMaxDevices],
                            int* resident) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool keep = dev < kMaxDevices;
  *resident = keep ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (*resident > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (e != cudaSuccess) return e;
  *resident = sms * (per_sm > 0 ? per_sm : 1);
  if (keep) cached[dev].store(*resident, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace rtt
