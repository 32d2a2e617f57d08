// Shared by the fused-trunk kernels (trunk_segment.cu, trunk_broadcast.cu):
// the board geometry of the zero-haloed 21x21 grid, the elementwise chain,
// rounded as the plain PyTorch versions in ops/trunk.py round it, and the
// register fragments of a 1x1 product over channels in `reduce_k_order`.
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
// __fmul_rn / __fadd_rn; 2t and 2t^2 are exact). The quotient is the
// approximate division div.approx.ftz (~2 ulp: n times the reciprocal of d)
// rather than IEEE division: the one place the chain departs from the plain
// version, which moves a rare bf16 rounding by one unit and is held to
// chip_smoke.py's KERNEL_TOL. It is __fdividef without the rescaling of a
// denormal divisor, which d in [1, 5] never is; only a denormal n or
// quotient (x < -86) flushes to zero.
__device__ __forceinline__ float mish_f32(float x) {
  const float t = expf(-fabsf(x));
  const float tt = __fmul_rn(t, t);
  const float t2 = 2.0f * t;
  const bool pos = x >= 0.0f;
  const float n = __fadd_rn(pos ? 1.0f : tt, t2);
  const float d = __fadd_rn(n, pos ? 2.0f * tt : 2.0f);
  float q;
  asm("div.approx.ftz.f32 %0, %1, %2;" : "=f"(q) : "f"(n), "f"(d));
  return __fmul_rn(x, q);
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

// bf16(lo) | bf16(hi) << 16, one cvt.rn.bf16x2.f32.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float lo_f(uint32_t v) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(v & 0xFFFFu)));
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(v >> 16)));
}
__device__ __forceinline__ uint32_t act2(uint32_t v, float a0, float b0, float a1,
                                         float b1) {
  return pack2(act_f32(lo_f(v), a0, b0), act_f32(hi_f(v), a1, b1));
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// The A fragments (m16n8k16, a warp's 16 rows p0 - lane / 4 + {0 .. 15})
// of a 1x1 product over the CB channels kc*CB .. of x [*, C], in two steps
// so that the loads of several tiles are in flight together: `load_x`
// fetches x over the chunk's channels of rows p0 and p0 + 8 (zero past the
// board), `act_x` applies act(., a, b) in place (af: a [C] then b [C]). The
// K order is permuted (ops/trunk.py `reduce_k_order`): in each 32-channel
// group q the lane with t4 = lane % 4 loads the 8 channels 32q + 8 t4 ..
// +7, which are logical k (2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9) of k-step 2q
// and the same of k-step 2q + 1, exactly its fragment registers.
template <int C, int CB>
__device__ __forceinline__ void load_x(uint32_t (&a)[CB / 16][4], const bf16* xb,
                                       int p0, int kc, int t4) {
#pragma unroll
  for (int q = 0; q < CB / 32; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + 8 * h;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (p < kPos) {
        v = *reinterpret_cast<const uint4*>(xb + static_cast<size_t>(p) * C + kc * CB +
                                            32 * q + 8 * t4);
      }
      a[2 * q][h] = v.x;
      a[2 * q][2 + h] = v.y;
      a[2 * q + 1][h] = v.z;
      a[2 * q + 1][2 + h] = v.w;
    }
  }
}

template <int C, int CB>
__device__ __forceinline__ void act_x(uint32_t (&a)[CB / 16][4], int p0, int kc,
                                      const float* af, int t4) {
#pragma unroll
  for (int q = 0; q < CB / 32; ++q) {
    const int c0 = kc * CB + 32 * q + 8 * t4;
    const float4 alo = *reinterpret_cast<const float4*>(af + c0);
    const float4 ahi = *reinterpret_cast<const float4*>(af + c0 + 4);
    const float4 blo = *reinterpret_cast<const float4*>(af + C + c0);
    const float4 bhi = *reinterpret_cast<const float4*>(af + C + c0 + 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (p0 + 8 * h < kPos) {
        a[2 * q][h] = act2(a[2 * q][h], alo.x, blo.x, alo.y, blo.y);
        a[2 * q][2 + h] = act2(a[2 * q][2 + h], alo.z, blo.z, alo.w, blo.w);
        a[2 * q + 1][h] = act2(a[2 * q + 1][h], ahi.x, bhi.x, ahi.y, bhi.y);
        a[2 * q + 1][2 + h] = act2(a[2 * q + 1][2 + h], ahi.z, bhi.z, ahi.w, bhi.w);
      }
    }
  }
}

// Accumulator element d[4j + 2h + e] of a 64-row wgmma tile is row p0 + 8h,
// column 8j + 2 t4 + e (p0 = the warp's 16-row base + lane / 4).
//
// The residual of the tile's rows for an N chunk of CB output columns at
// channel c0, the product's output channels in `reduce_k_order`: in each
// 32-channel group q the lane loads channels c0 + 32q + 8 t4 .. +7, which
// are its accumulator columns 8j + 2 t4 + e for j = 4q .. 4q + 3. `cur` may
// be `out` (in place); loading before any store lets the loads be in
// flight together.
template <int C, int CB>
__device__ __forceinline__ void load_residual(uint4 (&r)[2][CB / 32], const bf16* cur,
                                              int p0, int c0, int t4) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + 8 * h;
#pragma unroll
    for (int q = 0; q < CB / 32; ++q) {
      r[h][q] = p < kPos ? *reinterpret_cast<const uint4*>(
                               cur + static_cast<size_t>(p) * C + c0 + 32 * q + 8 * t4)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// out = bf16(f32(residual) + d) for the tile's rows (16-byte stores). With
// `afn` (the next block's affines), also the next reduce's A fragments for
// the K chunk of the same channels: act(out, afn layer 0), zero past the
// board. Pair j = 4q + jj of row h is k-step 2q + jj / 2, register
// h + 2 (jj % 2) of the fragment.
template <int C, int CB>
__device__ __forceinline__ void store_residual(const float (&d)[CB / 2],
                                               const uint4 (&r)[2][CB / 32], bf16* xo,
                                               int p0, int c0, int t4, const float* afn,
                                               uint32_t (&ar)[CB / 16][4]) {
#pragma unroll
  for (int q = 0; q < CB / 32; ++q) {
    const int ch = c0 + 32 * q + 8 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + 8 * h;
      const uint32_t rv[4] = {r[h][q].x, r[h][q].y, r[h][q].z, r[h][q].w};
      uint32_t o[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int e = 4 * (4 * q + jj) + 2 * h;
        o[jj] = pack2(__fadd_rn(lo_f(rv[jj]), d[e]), __fadd_rn(hi_f(rv[jj]), d[e + 1]));
      }
      if (p < kPos) {
        *reinterpret_cast<uint4*>(xo + static_cast<size_t>(p) * C + ch) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
      if (afn != nullptr) {
        const float4 alo = *reinterpret_cast<const float4*>(afn + ch);
        const float4 ahi = *reinterpret_cast<const float4*>(afn + ch + 4);
        const float4 blo = *reinterpret_cast<const float4*>(afn + C + ch);
        const float4 bhi = *reinterpret_cast<const float4*>(afn + C + ch + 4);
        const bool in = p < kPos;
        ar[2 * q][h] = in ? act2(o[0], alo.x, blo.x, alo.y, blo.y) : 0u;
        ar[2 * q][2 + h] = in ? act2(o[1], alo.z, blo.z, alo.w, blo.w) : 0u;
        ar[2 * q + 1][h] = in ? act2(o[2], ahi.x, bhi.x, ahi.y, bhi.y) : 0u;
        ar[2 * q + 1][2 + h] = in ? act2(o[3], ahi.z, bhi.z, ahi.w, bhi.w) : 0u;
      }
    }
  }
}

}  // namespace p3trunk
