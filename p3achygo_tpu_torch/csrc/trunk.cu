// Fused residual-trunk kernels for a batch of 19x19 boards, bf16 activations.
//
// Replaces the Pallas TPU kernels of the JAX package's fused serving trunk:
//  - p3_trunk_segment: a run of consecutive bottleneck blocks in one launch.
//    Counterpart of p3achygo_tpu/nn/trunk_kernel2.py `_make_segment_kernel`
//    and of the bottleneck branch of p3achygo_tpu/nn/trunk_kernel.py
//    `_make_kernel`. The two differ only in the f32 summation order of the
//    3x3 (one 9*Cb-deep dot against nine accumulated tap dots).
//  - p3_trunk_broadcast: one broadcast block, the broadcast branch of
//    `_make_kernel` (its position mix rounds z to bf16 before the affine).
//
// Per bottleneck block (every product bf16 x bf16 with f32 accumulation;
// act(v, a, b) = bf16(mish(f32(v) * a + b)) with the two-branch mish of
// trunk_kernel.py:55-60):
//   h = bf16(act(x, r) . Wr)
//   inner x { h = bf16(3x3_SAME(act(h, i), W9)) }
//   x = bf16(f32(x) + act(h, e) . We)
// Per broadcast block:
//   h = act(x, f) . Wf                       (f32, not rounded)
//   m = bf16(mish(h))
//   z[q] = bf16(sum_p WdT[q, p] m[p] + bd[q])
//   x = bf16(f32(x) + act(z, l) . Wl)
//
// Design. One thread block per board (grid = N): boards are independent,
// since neither a 3x3 nor the position mix crosses boards, so there is no
// batch padding. Products run on the tensor cores through nvcuda::wmma bf16
// 16x16x16 fragments with f32 accumulators. Each warp owns a unit of 16 rows
// times up to 64 (segment) or all C (broadcast) output columns, so one A
// fragment feeds several products. Weights are read from device memory
// (a whole trunk is ~2 MB and stays in the 50 MB L2). Accumulators leave
// through a per-warp 16x16 f32 staging tile, where the rounding, affine and
// mish of the next layer are applied before the bf16 value is stored.
//
// The 3x3 without masks or rolls: the activated bottleneck tensor t lives in
// shared memory as a zero-haloed 21x21 grid (position (i, j) at haloed row
// (i+1)*21 + (j+1)). Outputs are computed over the 400 haloed rows 22..421
// (25 tiles of 16, covering every interior row 22..418); tap (di, dj) reads
// the same buffer shifted by di*21 + dj rows (rows 0..443 of 448) at a
// constant leading dimension. Halo rows and guard rows are zeroed once and
// never written; outputs in halo columns are dropped. Two such buffers
// ping-pong between layers. The 1x1 expand reads the last one directly
// (halo rows give outputs that are dropped), so no relayout is needed. The
// residual x stays in device memory: read by the reduce, read and written
// by the expand (each element by one thread).
//
// What bounds it on an H100: a b12c128btl3 trunk is ~1.0 GFLOP per board
// against ~0.2 MB of activations in and out, so it is compute-bound on the
// tensor cores once the elementwise chain stays on chip, which is the point
// of the fusion (the unfused forward streams every mish/affine through
// device memory). This first version reaches the tensor cores through
// mma.sync (wmma) rather than wgmma, loads B fragments from L2/L1 rather
// than staging them with TMA, and runs one 12-warp block per SM (the shared
// memory holds two haloed buffers); it wastes 11% of the 3x3 and expand
// products on halo rows. Leading dimensions are padded by 16 elements to
// halve shared-memory bank conflicts while keeping the 32-byte fragment
// alignment wmma needs.
//
// Widths: (C, Cb) in {(64, 32), (128, 64)} for the segment and C in
// {64, 128} for the broadcast block; other widths return
// cudaErrorInvalidValue (the Python wrapper refuses them first).
//
// Interface: plain C, for ctypes. Pointers are device pointers, 32-byte
// aligned; `stream` is a cudaStream_t; `num_boards` >= 1. Each function sets
// the kernel's dynamic shared-memory limit, launches on `stream` without
// synchronising, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBoard = 19;
constexpr int kPos = kBoard * kBoard;  // 361
constexpr int kHaloW = kBoard + 2;     // 21
constexpr int kHaloRows = 448;         // >= 22 + 400 + 22
constexpr int kOut0 = kHaloW + 1;      // first haloed output row, 22
constexpr int kHaloTiles = 25;         // 400 output rows 22..421
constexpr int kPosTiles = 23;          // 368 rows: 361 positions + 7 pad
constexpr int kPosPad = kPosTiles * 16;
constexpr int kWarps = 12;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 16;  // leading-dimension padding of shared buffers

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// The elementwise math rounds after every operation, in the plain
// version's order (no FMA contraction: __fmul_rn / __fadd_rn), so that only
// the products' summation order differs from it.
__device__ __forceinline__ float mish_f32(float x) {
  const float t = expf(-fabsf(x));
  const float t2 = 2.0f * t;  // exact
  const float n_pos = __fadd_rn(1.0f, t2);
  const float pos = __fdiv_rn(n_pos, __fadd_rn(n_pos, __fmul_rn(t2, t)));
  const float n_neg = __fadd_rn(__fmul_rn(t, t), t2);
  const float neg = __fdiv_rn(n_neg, __fadd_rn(n_neg, 2.0f));
  return __fmul_rn(x, x >= 0.0f ? pos : neg);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// act(v, a, b) = bf16(mish(v * a + b)), v already a bf16 value.
__device__ __forceinline__ bf16 act(float v, float a, float b) {
  return __float2bfloat16(mish_f32(__fadd_rn(__fmul_rn(v, a), b)));
}

// Haloed row of a valid position p, and the position of an interior haloed
// row r (-1 for halo rows).
__device__ __forceinline__ int halo_row(int p) {
  return (p / kBoard + 1) * kHaloW + p % kBoard + 1;
}
__device__ __forceinline__ int halo_pos(int r) {
  const int i = r / kHaloW - 1;
  const int j = r % kHaloW - 1;
  return (i >= 0 && i < kBoard && j >= 0 && j < kBoard) ? i * kBoard + j : -1;
}

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

template <int C, int CB>
struct SegmentShape {
  static constexpr int kLdT = CB + kPad;
  static constexpr int kLdA = C + kPad;
  static constexpr int kTElems = kHaloRows * kLdT;
  static constexpr int kWarpBytes = 16 * kLdA * 2 + 256 * 4;
  static constexpr size_t kSmem = 2 * kTElems * 2 + kWarps * kWarpBytes;
  static constexpr int kNfB = CB / 16 < 4 ? CB / 16 : 4;  // Cout = Cb stages
  static constexpr int kGroupsB = CB / 16 / kNfB;
  static constexpr int kNfC = C / 16 < 4 ? C / 16 : 4;  // Cout = C (expand)
  static constexpr int kGroupsC = C / 16 / kNfC;
};

// aff: f32 [n_blocks, 2 + inner, 2, C] (layer l's affine over its input
// channels: reduce C, inner and expand Cb); wr: bf16 [n_blocks, C, Cb];
// w9: bf16 [n_blocks, inner, 9 * Cb, Cb] in (di, dj) row-major tap order;
// we: bf16 [n_blocks, Cb, C]. x, out: bf16 [N, 361, C]. From the second
// block on, the residual is read back from `out` after this kernel wrote
// it, so neither is __restrict__ (no read-only-cache loads).
template <int C, int CB>
__global__ void __launch_bounds__(kThreads, 1)
trunk_segment_kernel(const bf16* x, bf16* out,
                     const float* __restrict__ aff,
                     const bf16* __restrict__ wr, const bf16* __restrict__ w9,
                     const bf16* __restrict__ we, int n_blocks, int inner) {
  using S = SegmentShape<C, CB>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* tbuf[2] = {reinterpret_cast<bf16*>(smem),
                   reinterpret_cast<bf16*>(smem) + S::kTElems};
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* wbase = smem + 2 * S::kTElems * 2 + warp * S::kWarpBytes;
  bf16* abuf = reinterpret_cast<bf16*>(wbase);
  float* fbuf = reinterpret_cast<float*>(wbase + 16 * S::kLdA * 2);

  const size_t board = static_cast<size_t>(blockIdx.x) * kPos * C;
  const bf16* xin = x + board;
  bf16* xout = out + board;

  // Halo and guard rows stay zero from here on.
  for (int i = threadIdx.x; i < 2 * S::kTElems * 2 / 16; i += kThreads) {
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const int layers = 2 + inner;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const bf16* cur = blk == 0 ? xin : xout;
    const float* baff = aff + static_cast<size_t>(blk) * layers * 2 * C;
    const bf16* bwr = wr + static_cast<size_t>(blk) * C * CB;
    const bf16* bw9 = w9 + static_cast<size_t>(blk) * inner * 9 * CB * CB;
    const bf16* bwe = we + static_cast<size_t>(blk) * CB * C;

    // 1x1 reduce over position tiles -> act(h, layer 1) into tbuf[0].
    {
      const float* a_in = baff;
      const float* a_next = baff + 2 * C;
      for (int u = warp; u < kPosTiles * S::kGroupsB; u += kWarps) {
        const int p0 = (u / S::kGroupsB) * 16;
        const int n0 = (u % S::kGroupsB) * S::kNfB * 16;
        stage_act_rows<C>(cur, p0, a_in, a_in + C, abuf, lane);
        __syncwarp();
        FragC acc[S::kNfB];
        zero(acc);
        mma_rows(acc, abuf, S::kLdA, bwr + n0, CB, C);
        __syncwarp();
#pragma unroll
        for (int n = 0; n < S::kNfB; ++n) {
          wmma::store_matrix_sync(fbuf, acc[n], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int p = p0 + (e >> 4);
            const int c = n0 + n * 16 + (e & 15);
            if (p < kPos) {
              tbuf[0][halo_row(p) * S::kLdT + c] =
                  act(round_bf16(fbuf[e]), __ldg(a_next + c), __ldg(a_next + C + c));
            }
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();

    // Inner 3x3 convolutions, ping-ponging between the haloed buffers.
    for (int j = 0; j < inner; ++j) {
      const bf16* src = tbuf[j & 1];
      bf16* dst = tbuf[(j + 1) & 1];
      const bf16* wj = bw9 + static_cast<size_t>(j) * 9 * CB * CB;
      const float* a_next = baff + (2 + j) * 2 * C;
      for (int u = warp; u < kHaloTiles * S::kGroupsB; u += kWarps) {
        const int r0 = kOut0 + (u / S::kGroupsB) * 16;
        const int n0 = (u % S::kGroupsB) * S::kNfB * 16;
        FragC acc[S::kNfB];
        zero(acc);
#pragma unroll 1
        for (int o = 0; o < 9; ++o) {
          const int shift = (o / 3 - 1) * kHaloW + (o % 3 - 1);
          mma_rows(acc, src + (r0 + shift) * S::kLdT, S::kLdT,
                   wj + static_cast<size_t>(o) * CB * CB + n0, CB, CB);
        }
#pragma unroll
        for (int n = 0; n < S::kNfB; ++n) {
          wmma::store_matrix_sync(fbuf, acc[n], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int r = r0 + (e >> 4);
            const int c = n0 + n * 16 + (e & 15);
            if (halo_pos(r) >= 0) {
              dst[r * S::kLdT + c] =
                  act(round_bf16(fbuf[e]), __ldg(a_next + c), __ldg(a_next + C + c));
            }
          }
          __syncwarp();
        }
      }
      __syncthreads();
    }

    // 1x1 expand over haloed tiles + residual, in place in `out`.
    {
      const bf16* src = tbuf[inner & 1];
      for (int u = warp; u < kHaloTiles * S::kGroupsC; u += kWarps) {
        const int r0 = kOut0 + (u / S::kGroupsC) * 16;
        const int n0 = (u % S::kGroupsC) * S::kNfC * 16;
        FragC acc[S::kNfC];
        zero(acc);
        mma_rows(acc, src + r0 * S::kLdT, S::kLdT, bwe + n0, C, CB);
#pragma unroll
        for (int n = 0; n < S::kNfC; ++n) {
          wmma::store_matrix_sync(fbuf, acc[n], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int p = halo_pos(r0 + (e >> 4));
            const int c = n0 + n * 16 + (e & 15);
            if (p >= 0) {
              const size_t i = static_cast<size_t>(p) * C + c;
              xout[i] = __float2bfloat16(__fadd_rn(__bfloat162float(cur[i]), fbuf[e]));
            }
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
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

template <int C, int CB>
int launch_segment(const void* x, void* out, const void* aff, const void* wr,
                   const void* w9, const void* we, int num_boards,
                   int n_blocks, int inner, cudaStream_t stream) {
  constexpr size_t smem = SegmentShape<C, CB>::kSmem;
  auto kernel = trunk_segment_kernel<C, CB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<num_boards, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out),
      static_cast<const float*>(aff), static_cast<const bf16*>(wr),
      static_cast<const bf16*>(w9), static_cast<const bf16*>(we), n_blocks,
      inner);
  return static_cast<int>(cudaGetLastError());
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

extern "C" int p3_trunk_segment(const void* x, void* out, const void* aff,
                                const void* wr, const void* w9, const void* we,
                                int num_boards, int n_blocks, int inner,
                                int channels, int bottleneck, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 64 && bottleneck == 32) {
    return launch_segment<64, 32>(x, out, aff, wr, w9, we, num_boards,
                                  n_blocks, inner, s);
  }
  if (channels == 128 && bottleneck == 64) {
    return launch_segment<128, 64>(x, out, aff, wr, w9, we, num_boards,
                                   n_blocks, inner, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

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
