// int8 x int8 -> int32 'SAME' convolution of 19x19 boards with the int8
// serving graph's epilogue fused into it.
//
// Not a TPU kernel: in the JAX package this is XLA's convolution with
// `preferred_element_type=int32` (p3achygo_tpu/nn/serve_q.py `_conv_i8`)
// followed by an elementwise chain that XLA fuses into the convolution's
// output (`_chain_q`: dequantize, bias, mish, and the next convolution's
// `_quant_a`). PyTorch has no int8 convolution on the card, and an im2col
// would read each activation nine times, which is what the int8 stream is
// there to avoid. So the port computes the whole chain step here:
//
//   acc[n, p, oc] = sum over taps and input channels of x8 * w8   (exact s32)
//   y = float(acc) * (s_in * s_w[oc])  (+ bias[oc])
//   mode 0: acc as int32 (the raw sums, for checks)
//   mode 1: y as float32 (the last convolution of a chain)
//   mode 2: clip(round_half_even(mish(y) / s_next), -127, 127) as int8
//
// Layouts: x8 [N, 19, 19, Cin] and w8 [Cout, K, K, Cin] (K = 1 or 3), both
// int8 with the channels innermost, so four channels are one 32-bit word for
// `__dp4a`; the output is [N, 19, 19, Cout]. The scales are device pointers
// (s_in and s_next one float each, s_w and bias Cout floats), so the caller
// never reads them back to the host.
//
// Design: one block of 256 threads per (board, tile of 32 output channels).
// The block stages its board as words in shared memory, channel-major with
// the point index innermost ([Cin/4][plane], the plane 19x19 or, for 3x3,
// 21x21 with a zero halo; an odd plane size keeps the staging stores free of
// bank conflicts), and the tile's weights as [tap][Cin/4][32 channels]. Each
// thread owns 8 output channels at 6 points (points pg, pg+64, ...), so
// every step over four input channels is 6 scalar loads of x, two 16-byte
// loads of w and 48 `__dp4a`. The epilogue rounds where the plain PyTorch
// ops round: every product, sum and quotient is an explicit `_rn`
// intrinsic, so nvcc cannot contract them into FMAs, and mish is the port's
// formula (models/blocks.py `mish`) in its operation order.
//
// What bounds it: at the b12c128btl3 widths the card's int8 tensor rate
// (1,979 TOP/s) would make every shape bound by bytes (an int8 read of x, a
// write of int8 or float32), but `__dp4a` runs on the integer pipe at a small
// fraction of that rate, so this simple kernel is bound by its dp4a issue
// rate. Tensor-core (IMMA / s8 wgmma) tiles are later work; chip_smoke.py
// phase 14 prints its time beside the bound.
//
// Interface: plain C, for ctypes. All pointers are device pointers; `bias`
// may be null, `s_next` is read only in mode 2; `stream` is a cudaStream_t;
// `n` is at least 1; Cin is a multiple of 4, Cout of 8, and the staging must
// fit in shared memory (the Python wrapper checks all of these). Returns
// cudaGetLastError() after the launch, or the error of cudaFuncSetAttribute.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBoardLen = 19;
constexpr int kNumLocs = kBoardLen * kBoardLen;  // 361
constexpr int kThreads = 256;
constexpr int kTileOc = 32;                      // output channels per block
constexpr int kGroupOc = 8;                      // output channels per thread
constexpr int kGroups = kTileOc / kGroupOc;      // 4
constexpr int kPosGroups = kThreads / kGroups;   // 64
constexpr int kPos = (kNumLocs + kPosGroups - 1) / kPosGroups;  // 6 points per thread

enum Mode { kAcc = 0, kF32 = 1, kI8 = 2 };

template <int K>
struct Geo {
  static constexpr int kHalo = K / 2;
  static constexpr int kWidth = kBoardLen + 2 * kHalo;
  static constexpr int kPlane = kWidth * kWidth;  // 361 or 441
};

// Words of the staged board, rounded up so the weights start 16-byte aligned.
__host__ __device__ inline int plane_words(int k, int cin4) {
  const int width = kBoardLen + 2 * (k / 2);
  return (cin4 * width * width + 3) & ~3;
}

// models/blocks.py `mish`: u = exp(min(x, 20)), n = u*u + 2u, x*n / (n + 2),
// each operation rounded on its own as the plain PyTorch ops round.
__device__ __forceinline__ float mish_plain(float x) {
  const float u = expf(fminf(x, 20.0f));
  const float n = __fadd_rn(__fmul_rn(u, u), __fmul_rn(2.0f, u));
  return __fdiv_rn(__fmul_rn(x, n), __fadd_rn(n, 2.0f));
}

template <int K, int MODE>
__global__ void __launch_bounds__(kThreads)
conv_i8_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ w,
               const float* __restrict__ s_in, const float* __restrict__ s_w,
               const float* __restrict__ bias, const float* __restrict__ s_next,
               void* __restrict__ out, int cin4, int cout) {
  using G = Geo<K>;
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* xs = smem;                          // [cin4][kPlane]
  int32_t* ws = smem + plane_words(K, cin4);   // [K*K*cin4][kTileOc]
  const int board = blockIdx.x;
  const int oc0 = blockIdx.y * kTileOc;
  const int tid = threadIdx.x;

  // Stage the board: consecutive threads read consecutive words of x.
  const int32_t* xb = x + static_cast<size_t>(board) * kNumLocs * cin4;
  for (int e = tid; e < G::kPlane * cin4; e += kThreads) {
    const int pp = e / cin4;
    const int c4 = e - pp * cin4;
    const int r = pp / G::kWidth - G::kHalo;
    const int c = pp % G::kWidth - G::kHalo;
    int32_t v = 0;
    if (K == 1 || (r >= 0 && r < kBoardLen && c >= 0 && c < kBoardLen))
      v = xb[(r * kBoardLen + c) * cin4 + c4];
    xs[c4 * G::kPlane + pp] = v;
  }
  // Stage the tile's weights, output channel innermost (zero past Cout).
  const int taps4 = K * K * cin4;
  for (int e = tid; e < taps4 * kTileOc; e += kThreads) {
    const int o = e % kTileOc;
    const int rest = e / kTileOc;
    const int oc = oc0 + o;
    ws[e] = oc < cout ? w[static_cast<size_t>(oc) * taps4 + rest] : 0;
  }
  __syncthreads();

  const int g = tid % kGroups;
  const int pg = tid / kGroups;
  const int ocg = oc0 + g * kGroupOc;
  if (ocg >= cout) return;  // Cout is a multiple of 8: a group is all in or all out

  // Each point's index in the staged plane; points past 361 read the centre
  // of point 0's window (in bounds for every tap) and are never stored.
  int base[kPos];
#pragma unroll
  for (int j = 0; j < kPos; ++j) {
    const int p = pg + j * kPosGroups;
    const int q = p < kNumLocs ? p : 0;
    base[j] = (q / kBoardLen + G::kHalo) * G::kWidth + q % kBoardLen + G::kHalo;
  }

  int32_t acc[kPos][kGroupOc];
#pragma unroll
  for (int j = 0; j < kPos; ++j)
#pragma unroll
    for (int o = 0; o < kGroupOc; ++o) acc[j][o] = 0;

#pragma unroll
  for (int tap = 0; tap < K * K; ++tap) {
    const int off = (tap / K - G::kHalo) * G::kWidth + (tap % K - G::kHalo);
    const int32_t* wt = ws + tap * cin4 * kTileOc + g * kGroupOc;
    const int32_t* xt = xs + off;
#pragma unroll 2
    for (int c4 = 0; c4 < cin4; ++c4) {
      const int4 wa = *reinterpret_cast<const int4*>(wt + c4 * kTileOc);
      const int4 wb = *reinterpret_cast<const int4*>(wt + c4 * kTileOc + 4);
      const int32_t wv[kGroupOc] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      const int32_t* xc = xt + c4 * G::kPlane;
#pragma unroll
      for (int j = 0; j < kPos; ++j) {
        const int32_t xv = xc[base[j]];
#pragma unroll
        for (int o = 0; o < kGroupOc; ++o) acc[j][o] = __dp4a(xv, wv[o], acc[j][o]);
      }
    }
  }

  float sc[kGroupOc], bi[kGroupOc];
  float sn = 1.0f;
  if (MODE != kAcc) {
    const float si = *s_in;
#pragma unroll
    for (int o = 0; o < kGroupOc; ++o) {
      sc[o] = __fmul_rn(si, s_w[ocg + o]);
      bi[o] = bias != nullptr ? bias[ocg + o] : 0.0f;
    }
    if (MODE == kI8) sn = *s_next;
  }
#pragma unroll
  for (int j = 0; j < kPos; ++j) {
    const int p = pg + j * kPosGroups;
    if (p >= kNumLocs) continue;
    const size_t idx = (static_cast<size_t>(board) * kNumLocs + p) * cout + ocg;
    if (MODE == kAcc) {
      int4* o4 = reinterpret_cast<int4*>(static_cast<int32_t*>(out) + idx);
      o4[0] = make_int4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      o4[1] = make_int4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
      continue;
    }
    float y[kGroupOc];
#pragma unroll
    for (int o = 0; o < kGroupOc; ++o) {
      y[o] = __fmul_rn(__int2float_rn(acc[j][o]), sc[o]);
      if (bias != nullptr) y[o] = __fadd_rn(y[o], bi[o]);
    }
    if (MODE == kF32) {
      float4* o4 = reinterpret_cast<float4*>(static_cast<float*>(out) + idx);
      o4[0] = make_float4(y[0], y[1], y[2], y[3]);
      o4[1] = make_float4(y[4], y[5], y[6], y[7]);
    } else {
      uint32_t packed[2] = {0u, 0u};
#pragma unroll
      for (int o = 0; o < kGroupOc; ++o) {
        const float q = fminf(fmaxf(rintf(__fdiv_rn(mish_plain(y[o]), sn)), -127.0f), 127.0f);
        const uint32_t byte = static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
        packed[o / 4] |= byte << (8 * (o % 4));
      }
      *reinterpret_cast<uint2*>(static_cast<int8_t*>(out) + idx) =
          make_uint2(packed[0], packed[1]);
    }
  }
}

template <int K, int MODE>
int launch(const void* x, const void* w, const void* s_in, const void* s_w,
           const void* bias, const void* s_next, void* out, int n, int cin,
           int cout, cudaStream_t stream) {
  const int cin4 = cin / 4;
  const size_t smem = sizeof(int32_t) * (static_cast<size_t>(plane_words(K, cin4)) +
                                         static_cast<size_t>(K) * K * cin4 * kTileOc);
  auto kernel = conv_i8_kernel<K, MODE>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n, (cout + kTileOc - 1) / kTileOc);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(w),
      static_cast<const float*>(s_in), static_cast<const float*>(s_w),
      static_cast<const float*>(bias), static_cast<const float*>(s_next), out, cin4, cout);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_mode(int mode, const void* x, const void* w, const void* s_in,
                const void* s_w, const void* bias, const void* s_next, void* out,
                int n, int cin, int cout, cudaStream_t stream) {
  switch (mode) {
    case kAcc: return launch<K, kAcc>(x, w, s_in, s_w, bias, s_next, out, n, cin, cout, stream);
    case kF32: return launch<K, kF32>(x, w, s_in, s_w, bias, s_next, out, n, cin, cout, stream);
    case kI8: return launch<K, kI8>(x, w, s_in, s_w, bias, s_next, out, n, cin, cout, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int p3_conv_i8(const void* x, const void* w, const void* s_in,
                          const void* s_w, const void* bias, const void* s_next,
                          void* out, int mode, int k, int n, int cin, int cout,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1) return launch_mode<1>(mode, x, w, s_in, s_w, bias, s_next, out, n, cin, cout, s);
  if (k == 3) return launch_mode<3>(mode, x, w, s_in, s_w, bias, s_next, out, n, cin, cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

