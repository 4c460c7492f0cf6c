// Float helpers shared by the port's kernels.  The kernels repeat the
// float32 arithmetic of the reference as XLA compiles it: XLA's CPU backend
// always lets LLVM contract a product feeding a sum into a fused
// multiply-add, so the kernels use __fmaf_rn exactly at those sites and
// explicit _rn intrinsics everywhere else (the build also passes
// --fmad=false, so nvcc contracts nothing on its own).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rtt {

constexpr int kMaxDevices = 64;  // per-device launch caches
constexpr float kBig = 1e30f;      // finite miss marker during selection
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// jnp.hypot's float32 expansion: max * sqrt(1 + (min/max)^2), 0 when
// max == 0, inf when either leg is inf, with 1 + r*r fused as XLA
// compiles it.  hypotf rounds differently.
__device__ __forceinline__ float hypot_like_jax(float u, float v) {
  const float a = fabsf(u), b = fabsf(v);
  const bool inf = isinf(a) || isinf(b);
  const float m = a > b ? a : b;
  const float n = a > b ? b : a;
  const float safe = (m == 0.f) ? 1.f : m;
  const float r = __fdiv_rn(n, safe);
  const float x = (m == 0.f)
      ? m : __fmul_rn(m, __fsqrt_rn(__fmaf_rn(r, r, 1.f)));
  return inf ? INFINITY : x;
}

}  // namespace rtt
