// The trunk's pre-activation y = mish(x * a[c] + b[c]) on a [N, C, 19, 19]
// tensor in bf16 or float32, channels innermost (torch.channels_last, as
// the trunk's activations lie on the card: the stem reads NHWC planes and
// cuDNN keeps that layout) or contiguous NCHW (after a broadcast mix).
// ops/preact.py `preact` is the wrapper.
//
// Not a port of a TPU kernel. In the JAX package XLA fuses BatchNorm's
// affine and mish into their neighbours; PyTorch's eager forward runs them
// as ten elementwise kernels (x*a, +b, and mish's clamp, exp, u*u, 2*u, +,
// x*n, n+2 and /), each a pass over device memory. This kernel reads x once
// and writes y once: 4 bytes an element in bf16, 8 in float32, so its bound
// is device memory (3.35 TB/s on an H100). Done step by step in float32,
// ~50 instructions an element, it was bound by instruction issue instead,
// at ~62% of that (PERF.md §6); hence the packed bf16 arithmetic below.
//
// Bit-equal to those eager ops (ops/preact.py `preact_reference`), which
// compute each step in float32 from values of the tensor's dtype and round
// it to that dtype (c10's BFloat16(float) is __float2bfloat16, round to
// nearest even, on sm_80 and later): x*a, +b, clamp(max=20), exp (expf,
// not __expf), u*u, 2*u, +, x*n, n+2 and the IEEE division. a and b are
// rounded to the dtype first, as `a.to(x.dtype)` rounds them.
//
// float32 does each step so, with _rn intrinsics (no contraction into an
// FMA) but two: uu + 2u is one FMA (2u is exact, so fma(u, 2, uu) rounds
// the same sum once), and the clamp is fminf, which takes a NaN to 20 where
// torch.clamp keeps it; the NaN still reaches the result through x*n.
//
// bf16 does the same steps in packed bf16x2 instructions, one rounding
// each, which give the float32-then-round bits: the product of two bf16
// values has at most 16 significant bits and is exact in float32, and so is
// the sum of two bf16 values unless their exponents lie more than 16 apart,
// where both roundings give the larger one. So x*a, u*u and x*n are
// __hmul2_rn, +b and n+2 __hadd2_rn (the _rn forms keep nvcc from fusing a
// product and a sum), uu + 2u one __hfma2, the clamp __hmin2. exp runs in
// float32 (expf, then rounded). The division num / den of two bf16 values
// is never a bf16 tie and lies at least 2^-17 of its size from one (a
// quotient of two 8-bit significands against a 9-bit one), so any float32
// quotient within 2^-18 of it rounds to the same bf16: __fdividef (2 ulp)
// for |num| >= 2^-100, where the quotient is a normal number (den lies in
// [2, 2^58] and grows with num), and the IEEE division below that and for
// a NaN.
//
// Design: 16-byte vector loads and stores over the flat tensor (8 bf16 or
// 4 float32 a vector, processed as pairs), kUnroll vectors in flight a
// thread, a persistent grid of as many blocks as fit on the SMs striding
// over the vectors. How a lane finds its channel depends on the layout:
// see the two kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPlane = 361;
constexpr int kThreads = 256;
constexpr int kUnroll = 2;

enum AbKind { kAbsent = 0, kF32 = 1, kBf16 = 2 };

__device__ __forceinline__ float load_ab(const void* p, int kind, int c) {
  return kind == kBf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
                       : static_cast<const float*>(p)[c];
}

template <typename T>
struct Io;

template <>
struct Io<float> {
  using Pair = float2;
  static constexpr int kN = 4;  // elements a 16-byte vector
  __device__ static float round(float v) { return v; }
  __device__ static Pair pair(float lo, float hi) { return make_float2(lo, hi); }

  template <bool kA, bool kB>
  __device__ static float one(float v, float a, float b) {
    if (kA) v = __fmul_rn(v, a);
    if (kB) v = __fadd_rn(v, b);
    const float u = expf(fminf(v, 20.0f));
    const float n = __fmaf_rn(u, 2.0f, __fmul_rn(u, u));
    return __fdiv_rn(__fmul_rn(v, n), __fadd_rn(n, 2.0f));
  }

  template <bool kA, bool kB>
  __device__ static Pair preact(Pair v, Pair a, Pair b) {
    return make_float2(one<kA, kB>(v.x, a.x, b.x), one<kA, kB>(v.y, a.y, b.y));
  }
};

__device__ __forceinline__ float div_bf16(float num, float den) {
  return fabsf(num) >= 0x1p-100f ? __fdividef(num, den) : __fdiv_rn(num, den);
}

template <>
struct Io<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  static constexpr int kN = 8;
  __device__ static __nv_bfloat16 round(float v) { return __float2bfloat16_rn(v); }
  __device__ static Pair pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
    return __halves2bfloat162(lo, hi);
  }

  template <bool kA, bool kB>
  __device__ static Pair preact(Pair v, Pair a, Pair b) {
    const Pair two = __float2bfloat162_rn(2.0f);
    if (kA) v = __hmul2_rn(v, a);
    if (kB) v = __hadd2_rn(v, b);
    const float2 c = __bfloat1622float2(__hmin2(v, __float2bfloat162_rn(20.0f)));
    const Pair u = __floats2bfloat162_rn(expf(c.x), expf(c.y));
    const Pair n = __hfma2(u, two, __hmul2_rn(u, u));
    const float2 num = __bfloat1622float2(__hmul2_rn(v, n));
    const float2 den = __bfloat1622float2(__hadd2_rn(n, two));
    return __floats2bfloat162_rn(div_bf16(num.x, den.x), div_bf16(num.y, den.y));
  }
};

// Channels innermost (torch.channels_last, [N, 19, 19, C] in memory): a
// vector holds channels c0 .. c0 + kN - 1 of one point (C is a multiple of
// 8, so of kN). The grid strides by S vectors, a multiple of C / kN, so each
// thread keeps the same channels throughout and holds their a and b in
// registers.
template <typename T, bool kA, bool kB>
__global__ void __launch_bounds__(kThreads)
    preact_nhwc_kernel(const T* __restrict__ x, T* __restrict__ y, const void* __restrict__ a,
                       const void* __restrict__ b, int a_kind, int b_kind, int C,
                       long long n_vec) {
  using io = Io<T>;
  using Pair = typename io::Pair;
  constexpr int kP = io::kN / 2;  // pairs a vector
  const int groups = C / io::kN;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long S = static_cast<long long>(gridDim.x) * kThreads / groups * groups;
  if (t >= S) return;
  const int c0 = static_cast<int>(t % groups) * io::kN;
  Pair av[kP], bv[kP];
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    const int c = c0 + 2 * k;
    if (kA) av[k] = io::pair(io::round(load_ab(a, a_kind, c)),
                             io::round(load_ab(a, a_kind, c + 1)));
    if (kB) bv[k] = io::pair(io::round(load_ab(b, b_kind, c)),
                             io::round(load_ab(b, b_kind, c + 1)));
  }
  for (long long v0 = t; v0 < n_vec; v0 += kUnroll * S) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * S;
      if (v < n_vec) raw[u] = __ldg(reinterpret_cast<const uint4*>(x) + v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * S;
      if (v >= n_vec) continue;
      const Pair* in = reinterpret_cast<const Pair*>(&raw[u]);
      uint4 out;
      Pair* o = reinterpret_cast<Pair*>(&out);
#pragma unroll
      for (int k = 0; k < kP; ++k) o[k] = io::template preact<kA, kB>(in[k], av[k], bv[k]);
      reinterpret_cast<uint4*>(y)[v] = out;
    }
  }
}

// Contiguous NCHW: the 722-byte (bf16) channel planes are not 16-byte
// aligned, so a vector may straddle two channels: its first element's
// channel is (i / 361) % C and the rest are that one or the next. a and b,
// rounded, sit in shared memory.
template <typename T, bool kA, bool kB>
__global__ void __launch_bounds__(kThreads)
    preact_nchw_kernel(const T* __restrict__ x, T* __restrict__ y, const void* __restrict__ a,
                       const void* __restrict__ b, int a_kind, int b_kind, int C,
                       long long n_vec) {
  using io = Io<T>;
  using Pair = typename io::Pair;
  constexpr int kN = io::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_a = reinterpret_cast<T*>(smem);  // [C], rounded to T
  T* s_b = s_a + C;                     // [C]
  for (int c = threadIdx.x; c < C; c += kThreads) {
    if (kA) s_a[c] = io::round(load_ab(a, a_kind, c));
    if (kB) s_b[c] = io::round(load_ab(b, b_kind, c));
  }
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * kThreads * kUnroll;
  for (long long v0 = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
       v0 < n_vec; v0 += stride) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * kThreads;
      if (v < n_vec) raw[u] = __ldg(reinterpret_cast<const uint4*>(x) + v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * kThreads;
      if (v >= n_vec) continue;
      const long long i0 = v * kN;
      const unsigned plane = static_cast<unsigned>(i0 / kPlane);
      const int r0 = static_cast<int>(i0 - static_cast<long long>(plane) * kPlane);
      const int c0 = static_cast<int>(plane % static_cast<unsigned>(C));
      const int c1 = c0 + 1 == C ? 0 : c0 + 1;
      const Pair* in = reinterpret_cast<const Pair*>(&raw[u]);
      uint4 out;
      Pair* o = reinterpret_cast<Pair*>(&out);
#pragma unroll
      for (int k = 0; k < kN / 2; ++k) {
        const int ca = r0 + 2 * k < kPlane ? c0 : c1;
        const int cb = r0 + 2 * k + 1 < kPlane ? c0 : c1;
        const Pair av = kA ? io::pair(s_a[ca], s_a[cb]) : Pair{};
        const Pair bv = kB ? io::pair(s_b[ca], s_b[cb]) : Pair{};
        o[k] = io::template preact<kA, kB>(in[k], av, bv);
      }
      reinterpret_cast<uint4*>(y)[v] = out;
    }
  }

}

// Blocks of `kernel` that fit on the card at once (at least one an SM).
template <typename K>
int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

template <typename T, bool kA, bool kB>
int launch(const void* x, void* y, const void* a, const void* b, int a_kind, int b_kind,
           int n, int C, int nhwc, cudaStream_t stream) {
  const long long n_vec = static_cast<long long>(n) * C * kPlane / Io<T>::kN;
  if (nhwc) {
    auto kernel = preact_nhwc_kernel<T, kA, kB>;
    static const int resident = resident_blocks(kernel);
    // A thread for every vector, within what fits, and at least one for
    // each channel group.
    const long long groups = C / Io<T>::kN;
    long long want = (n_vec + kThreads - 1) / kThreads;
    if (want > resident) want = resident;
    if (want * kThreads < groups) want = (groups + kThreads - 1) / kThreads;
    kernel<<<static_cast<int>(want), kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), a, b, a_kind, b_kind, C, n_vec);
  } else {
    auto kernel = preact_nchw_kernel<T, kA, kB>;
    static const int resident = resident_blocks(kernel);
    const long long want = (n_vec + kThreads * kUnroll - 1) / (kThreads * kUnroll);
    const int grid = static_cast<int>(want < resident ? (want > 0 ? want : 1) : resident);
    kernel<<<grid, kThreads, 2 * sizeof(T) * static_cast<size_t>(C), stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), a, b, a_kind, b_kind, C, n_vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* x, void* y, const void* a, const void* b, int a_kind, int b_kind,
                 int n, int C, int nhwc, cudaStream_t s) {
  if (a_kind != kAbsent && b_kind != kAbsent)
    return launch<T, true, true>(x, y, a, b, a_kind, b_kind, n, C, nhwc, s);
  if (a_kind != kAbsent) return launch<T, true, false>(x, y, a, b, a_kind, b_kind, n, C, nhwc, s);
  if (b_kind != kAbsent) return launch<T, false, true>(x, y, a, b, a_kind, b_kind, n, C, nhwc, s);
  return launch<T, false, false>(x, y, a, b, a_kind, b_kind, n, C, nhwc, s);
}

}  // namespace

// x, y: [n, C, 19, 19], C a multiple of 8, 16-byte aligned, contiguous
// (nhwc = 0) or channels_last (nhwc = 1), of dtype bf16 (bf16 = 1)
// or float32 (0); a, b: [C] of kind a_kind / b_kind (0 absent, 1 float32,
// 2 bf16). Returns the launch's cudaError_t.
extern "C" int p3_preact(const void* x, void* y, const void* a, const void* b, int n, int C,
                         int bf16, int nhwc, int a_kind, int b_kind, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dtype<__nv_bfloat16>(x, y, a, b, a_kind, b_kind, n, C, nhwc, s)
              : launch_dtype<float>(x, y, a, b, a_kind, b_kind, n, C, nhwc, s);
}
