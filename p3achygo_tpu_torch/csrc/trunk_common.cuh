// Shared by the fused-trunk kernels (trunk.cu, trunk_segment.cu): the board
// geometry of the zero-haloed 21x21 grid and the elementwise chain, rounded
// as the plain PyTorch versions in ops/trunk.py round it.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace p3trunk {

using bf16 = __nv_bfloat16;

constexpr int kBoard = 19;
constexpr int kPos = kBoard * kBoard;  // 361
constexpr int kHaloW = kBoard + 2;     // 21
constexpr int kHaloGrid = kHaloW * kHaloW;  // 441 haloed rows

// The two-branch mish of p3achygo_tpu/nn/trunk_kernel.py:55-60 on
// t = e^-|x|: for x >= 0, x (1 + 2t) / (1 + 2t + 2t^2); below 0,
// x (t^2 + 2t) / (t^2 + 2t + 2). Both branches in one, without a branch:
// n = (x >= 0 ? 1 : t^2) + 2t and d = n + (x >= 0 ? 2t^2 : 2), each sum and
// product rounded where the plain version rounds it (no FMA contraction:
// __fmul_rn / __fadd_rn; 2t and 2t^2 are exact). The quotient is
// __fdividef (~2 ulp) rather than IEEE division: the one place the chain
// departs from the plain version, which moves a rare bf16 rounding by one
// unit and is held to chip_smoke.py's KERNEL_TOL.
__device__ __forceinline__ float mish_f32(float x) {
  const float t = expf(-fabsf(x));
  const float tt = __fmul_rn(t, t);
  const float t2 = 2.0f * t;
  const bool pos = x >= 0.0f;
  const float n = __fadd_rn(pos ? 1.0f : tt, t2);
  const float d = __fadd_rn(n, pos ? 2.0f * tt : 2.0f);
  return __fmul_rn(x, __fdividef(n, d));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// act(v, a, b) = mish(v * a + b) before its rounding to bf16, v already a
// bf16 value.
__device__ __forceinline__ float act_f32(float v, float a, float b) {
  return mish_f32(__fadd_rn(__fmul_rn(v, a), b));
}

// act(v, a, b) = bf16(mish(v * a + b)).
__device__ __forceinline__ bf16 act(float v, float a, float b) {
  return __float2bfloat16(act_f32(v, a, b));
}

// Haloed row of a valid position p.
__device__ __forceinline__ int halo_row(int p) {
  return (p / kBoard + 1) * kHaloW + p % kBoard + 1;
}

}  // namespace p3trunk
