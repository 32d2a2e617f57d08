// Fused broadcast-block kernel for a batch of 19x19 boards, bf16
// activations.
//
// Replaces the broadcast branch of the Pallas TPU kernel
// p3achygo_tpu/nn/trunk_kernel.py `_make_kernel` (its position mix rounds z
// to bf16 before the affine). The bottleneck runs are trunk_segment.cu.
// Per broadcast block (every product bf16 x bf16 with f32 accumulation;
// act(v, a, b) = bf16(mish(f32(v) * a + b)) with the two-branch mish of
// trunk_kernel.py:55-60, trunk_common.cuh):
//   h = act(x, f) . Wf                       (f32, not rounded)
//   m = bf16(mish(h))
//   z[q] = bf16(sum_p WdT[q, p] m[p] + bd[q])
//   x = bf16(f32(x) + act(z, l) . Wl)
//
// Design. One thread block per board (grid = N): boards are independent,
// since the position mix does not cross boards, so there is no batch
// padding. Products run on the tensor cores through nvcuda::wmma bf16
// 16x16x16 fragments with f32 accumulators. Each warp owns a unit of 16 rows
// times all C output columns, so one A fragment feeds several products.
// Weights are read from device memory (they stay in the 50 MB L2).
// Accumulators leave through a per-warp 16x16 f32 staging tile, where the
// rounding, affine and mish are applied before the bf16 value is stored.
//
// What bounds it on an H100: 57.0 MFLOP per board (the 361x361 mix and two
// CxC 1x1s at C = 128), 164 GFLOP at N = 2880, 0.17 ms at 989 TFLOP/s. This
// version reaches the tensor cores through mma.sync (wmma) rather than
// wgmma and runs one 12-warp block per SM; its redesign for Hopper is the
// next step (ROADMAP Queue 2). Leading dimensions are padded by 16 elements
// to halve shared-memory bank conflicts while keeping the 32-byte fragment
// alignment wmma needs.
//
// Widths: C in {64, 128}; other widths return cudaErrorInvalidValue (the
// Python wrapper refuses them first).
//
// Interface: plain C, for ctypes. Pointers are device pointers, 32-byte
// aligned; `stream` is a cudaStream_t; `num_boards` >= 1. The function sets
// the kernel's dynamic shared-memory limit, launches on `stream` without
// synchronising, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "trunk_common.cuh"

namespace {

using namespace nvcuda;
using namespace p3trunk;

constexpr int kPosTiles = 23;          // 368 rows: 361 positions + 7 pad
constexpr int kPosPad = kPosTiles * 16;
constexpr int kWarps = 12;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 16;  // leading-dimension padding of shared buffers

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc[n] += A[16 x K] . B[K x (16 n)], A row-major at lda, B row-major at
// ldb; A from shared or device memory, B likewise.
template <int NF>
__device__ __forceinline__ void mma_rows(FragC (&acc)[NF], const bf16* A,
                                         int lda, const bf16* B, int ldb,
                                         int K) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, A + k0, lda);
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      FragB fb;
      wmma::load_matrix_sync(fb, B + static_cast<size_t>(k0) * ldb + n * 16, ldb);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

template <int NF>
__device__ __forceinline__ void zero(FragC (&acc)[NF]) {
#pragma unroll
  for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[n], 0.0f);
}

// Stage act(x[p0 .. p0+15], a, b) as bf16 rows into abuf (ld C + kPad);
// rows past the board are zero. x rows are C bf16 values, 16-byte vectors.
template <int C>
__device__ __forceinline__ void stage_act_rows(const bf16* xb,
                                               int p0, const float* a,
                                               const float* b, bf16* abuf,
                                               int lane) {
  constexpr int kVec = 8;
  constexpr int kPerRow = C / kVec;
  for (int v = lane; v < 16 * kPerRow; v += 32) {
    const int r = v / kPerRow;
    const int c0 = (v % kPerRow) * kVec;
    const int p = p0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    uint4 res = make_uint4(0u, 0u, 0u, 0u);
    if (p < kPos) {
      raw = *reinterpret_cast<const uint4*>(xb + static_cast<size_t>(p) * C + c0);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
      bf16* o = reinterpret_cast<bf16*>(&res);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        o[k] = act(__bfloat162float(e[k]), __ldg(a + c0 + k), __ldg(b + c0 + k));
      }
    }
    *reinterpret_cast<uint4*>(abuf + r * (C + kPad) + c0) = res;
  }
}

template <int C>
struct BroadcastShape {
  static constexpr int kLd = C + kPad;
  static constexpr int kMElems = kPosPad * kLd;
  static constexpr int kWarpBytes = 16 * kLd * 2 + 256 * 4;
  static constexpr size_t kSmem = kMElems * 2 + kWarps * kWarpBytes;
  static constexpr int kNf = C / 16;
};

// f_aff, l_aff: f32 [2, C]; wf, wl: bf16 [C, C]; wdt: bf16 [368, 368] with
// wdt[q, p] = Dense kernel[p, q] and zero padding; bd: f32 [361].
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
trunk_broadcast_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                       const float* __restrict__ f_aff,
                       const bf16* __restrict__ wf,
                       const bf16* __restrict__ wdt,
                       const float* __restrict__ bd,
                       const float* __restrict__ l_aff,
                       const bf16* __restrict__ wl) {
  using S = BroadcastShape<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* mbuf = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* wbase = smem + S::kMElems * 2 + warp * S::kWarpBytes;
  bf16* abuf = reinterpret_cast<bf16*>(wbase);
  float* fbuf = reinterpret_cast<float*>(wbase + 16 * S::kLd * 2);

  const size_t board = static_cast<size_t>(blockIdx.x) * kPos * C;
  const bf16* xb = x + board;
  bf16* ob = out + board;

  // m = bf16(mish(act(x, f) . Wf)) into mbuf; pad rows 361..367 are zero.
  for (int t = warp; t < kPosTiles; t += kWarps) {
    const int p0 = t * 16;
    stage_act_rows<C>(xb, p0, f_aff, f_aff + C, abuf, lane);
    __syncwarp();
    FragC acc[S::kNf];
    zero(acc);
    mma_rows(acc, abuf, S::kLd, wf, C, C);
#pragma unroll
    for (int n = 0; n < S::kNf; ++n) {
      wmma::store_matrix_sync(fbuf, acc[n], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int p = p0 + (e >> 4);
        const int c = n * 16 + (e & 15);
        mbuf[p * S::kLd + c] =
            __float2bfloat16(p < kPos ? mish_f32(fbuf[e]) : 0.0f);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // Per tile of 16 destination positions q: z = bf16(WdT . m + bd), then
  // x += act(z, l) . Wl, both within the warp.
  for (int t = warp; t < kPosTiles; t += kWarps) {
    const int q0 = t * 16;
    FragC acc[S::kNf];
    zero(acc);
    mma_rows(acc, wdt + static_cast<size_t>(q0) * kPosPad, kPosPad, mbuf,
             S::kLd, kPosPad);
#pragma unroll
    for (int n = 0; n < S::kNf; ++n) {
      wmma::store_matrix_sync(fbuf, acc[n], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int q = q0 + (e >> 4);
        const int c = n * 16 + (e & 15);
        bf16 v = __float2bfloat16(0.0f);
        if (q < kPos) {
          const float z = round_bf16(__fadd_rn(fbuf[e], __ldg(bd + q)));
          v = act(z, __ldg(l_aff + c), __ldg(l_aff + C + c));
        }
        abuf[(e >> 4) * S::kLd + c] = v;
      }
      __syncwarp();
    }
    zero(acc);
    mma_rows(acc, abuf, S::kLd, wl, C, C);
#pragma unroll
    for (int n = 0; n < S::kNf; ++n) {
      wmma::store_matrix_sync(fbuf, acc[n], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int q = q0 + (e >> 4);
        const int c = n * 16 + (e & 15);
        if (q < kPos) {
          const size_t i = static_cast<size_t>(q) * C + c;
          ob[i] = __float2bfloat16(__fadd_rn(__bfloat162float(xb[i]), fbuf[e]));
        }
      }
      __syncwarp();
    }
  }
}

template <int C>
int launch_broadcast(const void* x, void* out, const void* f_aff,
                     const void* wf, const void* wdt, const void* bd,
                     const void* l_aff, const void* wl, int num_boards,
                     cudaStream_t stream) {
  constexpr size_t smem = BroadcastShape<C>::kSmem;
  auto kernel = trunk_broadcast_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<num_boards, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out),
      static_cast<const float*>(f_aff), static_cast<const bf16*>(wf),
      static_cast<const bf16*>(wdt), static_cast<const float*>(bd),
      static_cast<const float*>(l_aff), static_cast<const bf16*>(wl));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int p3_trunk_broadcast(const void* x, void* out, const void* f_aff,
                                  const void* wf, const void* wdt,
                                  const void* bd, const void* l_aff,
                                  const void* wl, int num_boards, int channels,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 64) {
    return launch_broadcast<64>(x, out, f_aff, wf, wdt, bd, l_aff, wl,
                                num_boards, s);
  }
  if (channels == 128) {
    return launch_broadcast<128>(x, out, f_aff, wf, wdt, bd, l_aff, wl,
                                 num_boards, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
