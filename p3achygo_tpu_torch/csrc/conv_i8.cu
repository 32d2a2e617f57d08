// int8 x int8 -> int32 'SAME' convolution of 19x19 boards on the s8 tensor
// cores, with the int8 serving graph's epilogue fused into it.
//
// Not a TPU kernel: in the JAX package this is XLA's convolution with
// `preferred_element_type=int32` (p3achygo_tpu/nn/serve_q.py `_conv_i8`)
// followed by the elementwise work XLA fuses into the convolution's output:
// `_chain_q`'s dequantize, bias, mish and the next `_quant_a`, and at a block
// boundary `requant_res` and the next chain's head. The port computes it here:
//
//   acc[n, p, oc] = sum over taps and input channels of x8 * w8   (exact s32)
//   y = float(acc) * (s_in * s_w[oc])  (+ bias[oc])
//   mode 0 ACC:  acc as int32 (the raw sums, for checks)
//   mode 1 F32:  y as float32 (a chain's last convolution)
//   mode 2 I8:   clip(rint(mish(y) / s_next), +-127) as int8 (in-chain)
//   mode 3 RES:  a block's last convolution with the residual stream:
//                  r  = float(q_prev) * s_prev + y
//                  q  = clip(rint(r / s_res), +-127)             -> q8 (int8)
//                  u8 = clip(rint(mish(float(q) * s_res * a0[oc] + b0[oc])
//                                 / s_head), +-127)            -> u8 (int8)
//                the residual stream stays int8 in device memory, and u8 is
//                the next block's first chain head (skipped when a0 is null:
//                the last block, whose stream the heads read)
//   mode 4 MISH: mish(y) as float32 (5: as bf16, round to nearest even),
//                written [N, Cout, 361] as the broadcast mix reads it
//
// Layouts: x8 and q_prev [N, 19, 19, C] and w8 [Cout, K, K, Cin] (K = 1 or
// 3), int8, channels innermost: both operands are K-major, which is what the
// int8 `mma` takes. Outputs [N, 19, 19, Cout] (MISH: [N, Cout, 361]). The
// scales are device pointers (s_in, s_next, s_prev, s_res and s_head one
// float each; s_w, bias, a0 and b0 Cout floats), so the caller never reads
// them back to the host.
//
// Design: an implicit GEMM, M = a board's 361 points (padded to 384), N =
// Cout in tiles of 64, K = taps x Cin (Cin padded to a multiple of 32 with
// zeros). Route: `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` with
// `ldmatrix` fragments, not wgmma. The A rows of a 3x3 tap are the points
// of the board shifted by the tap, which `ldmatrix` takes from one pointer
// per row into a haloed 21x21 plane: the im2col is implicit and every
// activation byte is read from device memory once. wgmma (m64n64k32, A
// by the same per-row `ldmatrix` into registers, or both operands by
// descriptor over a plane stored by 16-byte channel chunks) gave the same
// bits and was not faster on the H100: the epilogues' instruction issue
// binds this kernel (see below), not the tensor cores.
//
// A block of 8 warps owns a tile of 64 output channels: their weights, all
// taps, stay in shared memory ([64][K*K*Cp + 16] bytes) while the block, one
// of a persistent grid, walks the boards b, b + gridDim.x, ... Each board is
// copied by `cp.async` into a plane of [W*W points][Cp + 16] bytes whose halo
// and padding channels were zeroed once and are never written; with two
// stages the next board's copy is in flight while this one is multiplied.
// The 16 extra bytes a row make the eight rows an `ldmatrix` reads fall in
// distinct banks. For a 3x3 a warp unit is 3 m16 tiles x 32 channels (48
// accumulators a thread, 5 `ldmatrix` per 12 `mma` a k-step; 8 m-groups x 2
// channel halves, two units a warp); for a 1x1 it is 1 m16 tile x 32
// channels (six units a warp), and three blocks share an SM. The int8
// epilogues (I8, RES) pass each m16 tile through 16 x 48 bytes of the
// warp's own shared memory, so that a lane reads q_prev and writes q8 and
// u8 16 contiguous bytes at a time where the accumulator fragments hold 2.
//
// Rounding: every product, sum and quotient of the epilogue is an explicit
// `_rn` intrinsic, so nvcc cannot contract them into FMAs, in the order the
// plain PyTorch ops of ops/conv_i8.py `epilogue_reference` take; mish is the
// port's formula (models/blocks.py `mish`). The quantizations divide by a
// scale through its correctly rounded reciprocal and one FMA correction
// (`div_by`), which gives the IEEE quotient's bits. Never build with fast
// math.
//
// What bounds it: at the b12c128btl3 widths the int8 tensor rate (1,979
// TOP/s) makes every site bound by its bytes. This kernel is bound by
// instruction issue instead: `mma.sync` and the `ldmatrix` fragment loads
// of every k-step in the main loop, and in the epilogue mish's `expf` and
// division for every output value (I8, RES and MISH), which the card must
// compute bit for bit as PyTorch's ops do. chip_smoke.py phase 14 prints
// each site's and mode's time beside its bound.
//
// Interface: plain C, for ctypes. `ptrs` is a host array of 14 device
// pointers in the order of `Args` below (null where a mode does not read
// it); `stream` is a cudaStream_t; `n` is at least 1; Cin is a multiple of
// 4, Cout of 8; the staging must fit in shared memory (the Python wrapper
// checks all of these). Returns cudaGetLastError() after the launch, or the
// error of the occupancy query.

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using p3trunk::ldmatrix_x4;
using p3trunk::smem_u32;

constexpr int kBoardLen = 19;
constexpr int kNumLocs = kBoardLen * kBoardLen;  // 361
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileOc = 64;     // output channels a block
constexpr int kWarpOc = 32;     // output channels a warp unit (4 n8 tiles)
// m16 tiles a warp unit: three for 3x3 (B fragments shared over 18 k-steps),
// one for 1x1, whose few k-steps leave the epilogue most of the work: its
// 16 accumulators let three blocks share an SM to hide its latency.
template <int K>
struct WarpTile {
  static constexpr int kM = K == 1 ? 1 : 3;
  static constexpr int kGroups = 24 / kM;  // 24 x 16 = 384 >= 361 rows
  static constexpr int kBlocksPerSm = K == 1 ? 3 : 2;
};
constexpr int kRowPad = 16;     // bytes after each staged row (banks)
constexpr int kStgRow = 48;     // bytes a row of a warp's int8 staging tile
constexpr int kStgBytes = 16 * kStgRow;  // one m16 tile x 32 channels
constexpr int kSmemPerSm = 233472;  // an H100 SM's shared memory
constexpr int kSmemReserved = 1024;  // the runtime's share of it per block

enum Mode { kAcc = 0, kF32 = 1, kI8 = 2, kRes = 3, kMishF32 = 4, kMishBf16 = 5 };

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* s_in;
  const float* s_w;
  const float* bias;
  const float* s_next;
  const int8_t* q_prev;
  const float* s_prev;
  const float* s_res;
  const float* a0;
  const float* b0;
  const float* s_head;
  void* out;
  int8_t* out2;  // RES: u8 (null: no next chain)
};

struct Shape {
  int n, cin, cout, cp, stages;
};

__host__ __device__ inline int padded_cin(int cin) { return (cin + 31) & ~31; }
__host__ __device__ inline int row_bytes(int cp) { return cp + kRowPad; }
__host__ __device__ inline int weight_row_bytes(int k, int cp) { return k * k * cp + kRowPad; }
__host__ __device__ inline int plane_points(int k) {
  const int w = kBoardLen + 2 * (k / 2);
  return w * w;
}
// [64 weight rows][4 per-channel constants x 64][8 warps' staging tiles]
// [stages boards]
__host__ __device__ inline int smem_bytes(int k, int cp, int stages) {
  return kTileOc * weight_row_bytes(k, cp) + 4 * kTileOc * 4 + kWarps * kStgBytes +
         stages * plane_points(k) * row_bytes(cp);
}

// models/blocks.py `mish`: u = exp(min(x, 20)), n = u*u + 2u, x*n / (n + 2),
// each operation rounded on its own as the plain PyTorch ops round.
__device__ __forceinline__ float mish_plain(float x) {
  const float u = expf(fminf(x, 20.0f));
  const float n = __fadd_rn(__fmul_rn(u, u), __fmul_rn(2.0f, u));
  return __fdiv_rn(__fmul_rn(x, n), __fadd_rn(n, 2.0f));
}

// v / s rounded to nearest even, from inv = RN(1/s) (Markstein): q = RN(v *
// inv) is within an ulp of v / s, so r = v - q * s is exact and RN(q + r *
// inv) is the correctly rounded quotient wherever it is a normal number
// (the same bits as `__fdiv_rn`, in three operations instead of a dozen).
// A quotient below 2^-126 may differ, and quantizes to 0 either way.
__device__ __forceinline__ float div_by(float v, float s, float inv) {
  const float q = __fmul_rn(v, inv);
  return __fmaf_rn(__fmaf_rn(-q, s, v), inv, q);
}

// ops/conv_i8.py `quantize`: clip(round_half_even(v / s), -127, 127), with
// inv = RN(1/s).
__device__ __forceinline__ int quant(float v, float s, float inv) {
  return static_cast<int>(fminf(fmaxf(rintf(div_by(v, s, inv)), -127.0f), 127.0f));
}

__device__ __forceinline__ uint16_t pack2(int lo, int hi) {
  return static_cast<uint16_t>((lo & 0xff) | ((hi & 0xff) << 8));
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Issues the copies of board `b`'s 361 rows of Cin bytes into the interior
// of the plane at `plane` (16 bytes a copy where the rows allow it).
template <int K>
__device__ __forceinline__ void stage_board(uint32_t plane, const int8_t* x, int b,
                                            const Shape& sh, bool vec16) {
  constexpr int kHalo = K / 2;
  constexpr int kWidth = kBoardLen + 2 * kHalo;
  const int rb = row_bytes(sh.cp);
  const int8_t* xb = x + static_cast<size_t>(b) * kNumLocs * sh.cin;
  const int chunk = vec16 ? 16 : 4;
  const int per_row = sh.cin / chunk;
  for (int e = threadIdx.x; e < kNumLocs * per_row; e += kThreads) {
    const int p = e / per_row;
    const int c = (e - p * per_row) * chunk;
    const int pp = (p / kBoardLen + kHalo) * kWidth + p % kBoardLen + kHalo;
    const uint32_t dst = plane + pp * rb + c;
    const int8_t* src = xb + p * sh.cin + c;
    if (vec16)
      cp_async16(dst, src);
    else
      cp_async4(dst, src);
  }
  cp_async_commit();
}

// Moves one m16 tile x 32 channels of an int8 [N, 361, Cout] tensor between
// device memory and a warp's staging rows: lane l takes 16 (or, at an odd
// multiple of 8 channels, 8) bytes of row l / 2. Rows past 361 and channels
// past Cout are skipped.
template <bool kStore>
__device__ __forceinline__ void tile_io(int8_t* t, int8_t* stg, int b, int p0, int c0,
                                        int cout, int lane) {
  const int row = lane / 2;
  const int c = c0 + 16 * (lane % 2);
  const int p = p0 + row;
  if (p >= kNumLocs || c >= cout) return;
  int8_t* g = t + (static_cast<size_t>(b) * kNumLocs + p) * cout + c;
  int8_t* s = stg + row * kStgRow + 16 * (lane % 2);
  if (cout % 16 == 0) {
    if (kStore)
      *reinterpret_cast<int4*>(g) = *reinterpret_cast<const int4*>(s);
    else
      *reinterpret_cast<int4*>(s) = *reinterpret_cast<const int4*>(g);
    return;
  }
#pragma unroll
  for (int k = 0; k < 16; k += 8) {
    if (c + k >= cout) break;
    if (kStore)
      *reinterpret_cast<int2*>(g + k) = *reinterpret_cast<const int2*>(s + k);
    else
      *reinterpret_cast<int2*>(s + k) = *reinterpret_cast<const int2*>(g + k);
  }
}

template <int K, int MODE>
__global__ void __launch_bounds__(kThreads, WarpTile<K>::kBlocksPerSm)
conv_i8_kernel(const Args a, const Shape sh) {
  constexpr int kWarpM = WarpTile<K>::kM;
  constexpr int kMGroups = WarpTile<K>::kGroups;
  constexpr int kHalo = K / 2;
  constexpr int kWidth = kBoardLen + 2 * kHalo;
  extern __shared__ __align__(16) int8_t smem[];
  const int cp = sh.cp;
  const int rb = row_bytes(cp);
  const int wrb = weight_row_bytes(K, cp);
  int8_t* ws = smem;                                         // [64][wrb]
  float* consts = reinterpret_cast<float*>(smem + kTileOc * wrb);  // sc, bias, a0, b0
  int8_t* stage_rows = smem + kTileOc * wrb + 4 * kTileOc * 4;      // [8 warps][16][48]
  int8_t* xs = stage_rows + kWarps * kStgBytes;              // [stages][plane][rb]
  const int plane_bytes = plane_points(K) * rb;
  const int oc0 = blockIdx.y * kTileOc;
  const int tid = threadIdx.x;
  const bool vec16 = (sh.cin % 16 == 0) && (reinterpret_cast<uintptr_t>(a.x) % 16 == 0);

  // Zero the boards' planes once: the copies never write the halo or the
  // padding channels.
  for (int e = tid * 16; e < sh.stages * plane_bytes; e += kThreads * 16)
    *reinterpret_cast<int4*>(xs + e) = make_int4(0, 0, 0, 0);
  __syncthreads();
  int b = blockIdx.x;
  if (b < sh.n) stage_board<K>(smem_u32(xs), a.x, b, sh, vec16);

  // The tile's weights, in words (Cin is a multiple of 4): zero past Cout and
  // in the padding channels.
  const int taps_words = K * K * cp / 4;
  const int cin4 = sh.cin / 4;
  for (int e = tid; e < kTileOc * taps_words; e += kThreads) {
    const int o = e / taps_words;
    const int rest = e - o * taps_words;
    const int tap = rest / (cp / 4);
    const int c4 = rest - tap * (cp / 4);
    const int oc = oc0 + o;
    int32_t v = 0;
    if (oc < sh.cout && c4 < cin4)
      v = reinterpret_cast<const int32_t*>(a.w)[(static_cast<size_t>(oc) * K * K + tap) * cin4 +
                                                c4];
    *reinterpret_cast<int32_t*>(ws + o * wrb + tap * cp + c4 * 4) = v;
  }
  if (MODE != kAcc && tid < kTileOc) {
    const int oc = oc0 + tid;
    const bool in = oc < sh.cout;
    consts[tid] = in ? __fmul_rn(*a.s_in, a.s_w[oc]) : 0.0f;
    consts[kTileOc + tid] = (in && a.bias != nullptr) ? a.bias[oc] : 0.0f;
    consts[2 * kTileOc + tid] = (in && a.a0 != nullptr) ? a.a0[oc] : 0.0f;
    consts[3 * kTileOc + tid] = (in && a.b0 != nullptr) ? a.b0[oc] : 0.0f;
  }
  float s_next = 1.0f, s_prev = 1.0f, s_res = 1.0f, s_head = 1.0f;
  const bool head = MODE == kRes && a.out2 != nullptr;  // RES: the next chain's head
  if (MODE == kI8) s_next = *a.s_next;
  if (MODE == kRes) {
    s_prev = *a.s_prev;
    s_res = *a.s_res;
    if (head) s_head = *a.s_head;
  }
  const float inv_next = __frcp_rn(s_next), inv_res = __frcp_rn(s_res),
              inv_head = __frcp_rn(s_head);

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;    // accumulator row within an m8 half
  const int tig = lane % 4;  // accumulator column pair
  // ldmatrix addresses: lane l gives row l % 8 of matrix l / 8.
  const int lr = lane % 8;
  const int lm = lane / 8;
  const int halves = sh.cout - oc0 > kWarpOc ? 2 : 1;
  const int units = kMGroups * halves;

  for (int it = 0; b < sh.n; ++it, b += gridDim.x) {
    const int next = b + gridDim.x;
    const int stage = sh.stages == 2 ? (it & 1) : 0;
    if (sh.stages == 2 && next < sh.n) {
      stage_board<K>(smem_u32(xs + (stage ^ 1) * plane_bytes), a.x, next, sh, vec16);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t xplane = smem_u32(xs + stage * plane_bytes);

    for (int u = warp; u < units; u += kWarps) {
      const int mg = u / halves;
      const int nb = (u - mg * halves) * kWarpOc;  // channel offset in the tile
      if (mg * kWarpM * 16 >= kNumLocs) continue;  // all 16 rows past the board
      // A: row (lr + 8 * (lm & 1)) of each m16 tile, k bytes 16 * (lm >> 1).
      uint32_t a_addr[kWarpM];
#pragma unroll
      for (int j = 0; j < kWarpM; ++j) {
        int p = mg * kWarpM * 16 + j * 16 + lr + 8 * (lm & 1);
        p = p < kNumLocs ? p : 0;  // rows past 361 read point 0; never stored
        const int pp = (p / kBoardLen + kHalo) * kWidth + p % kBoardLen + kHalo;
        a_addr[j] = xplane + pp * rb + 16 * (lm >> 1);
      }
      // B: channel nb + lr + 8 * (lm >> 1) (+16 for the second pair of n8
      // tiles), k bytes 16 * (lm & 1).
      const uint32_t b_addr = smem_u32(ws) + (nb + lr + 8 * (lm >> 1)) * wrb + 16 * (lm & 1);

      int32_t acc[kWarpM][4][4];
#pragma unroll
      for (int j = 0; j < kWarpM; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[j][t][r] = 0;

#pragma unroll
      for (int tap = 0; tap < K * K; ++tap) {
        const int a_off = ((tap / K - kHalo) * kWidth + (tap % K - kHalo)) * rb;
        const uint32_t b_tap = b_addr + tap * cp;
#pragma unroll 2
        for (int kc = 0; kc < cp; kc += 32) {
          uint32_t bf[2][4];
          ldmatrix_x4(bf[0], b_tap + kc);
          ldmatrix_x4(bf[1], b_tap + 16 * wrb + kc);
#pragma unroll
          for (int j = 0; j < kWarpM; ++j) {
            uint32_t af[4];
            ldmatrix_x4(af, a_addr[j] + a_off + kc);
#pragma unroll
            for (int t = 0; t < 4; ++t)
              mma_s8(acc[j][t], af, bf[t / 2][2 * (t % 2)], bf[t / 2][2 * (t % 2) + 1]);
          }
        }
      }

      // Epilogue: acc[j][t][h * 2 + e] is row mg*48 + 16j + g + 8h, channel
      // nb + 8t + 2 tig + e of the tile.
      if (MODE == kI8 || MODE == kRes) {
        // int8 out: each m16 tile goes through the warp's staging rows, so
        // that a lane moves 16 contiguous bytes of a point (q_prev in, q8
        // and u8 out) where the fragments hold 2.
        int8_t* stg = stage_rows + warp * kStgBytes;
        const int c0 = oc0 + nb;
#pragma unroll
        for (int j = 0; j < kWarpM; ++j) {
          const int p0 = mg * kWarpM * 16 + j * 16;
          if (p0 >= kNumLocs) break;  // warp-uniform
          uint32_t qp[4][2];
          if (MODE == kRes) {
            tile_io<false>(const_cast<int8_t*>(a.q_prev), stg, b, p0, c0, sh.cout, lane);
            __syncwarp();
#pragma unroll
            for (int t = 0; t < 4; ++t)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                qp[t][h] = *reinterpret_cast<const uint16_t*>(stg + (g + 8 * h) * kStgRow +
                                                              8 * t + 2 * tig);
            __syncwarp();
          }
          uint32_t o1[4][2], o2[4][2];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int oct = nb + 8 * t + 2 * tig;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              int q[2], hq[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float y = __fmul_rn(__int2float_rn(acc[j][t][2 * h + e]), consts[oct + e]);
                if (a.bias != nullptr) y = __fadd_rn(y, consts[kTileOc + oct + e]);
                if (MODE == kI8) {
                  q[e] = quant(mish_plain(y), s_next, inv_next);
                } else {
                  const int prev = static_cast<int8_t>((qp[t][h] >> (8 * e)) & 0xff);
                  const float r = __fadd_rn(__fmul_rn(static_cast<float>(prev), s_prev), y);
                  q[e] = quant(r, s_res, inv_res);
                  hq[e] = 0;
                  if (head) {
                    const float xn = __fmul_rn(static_cast<float>(q[e]), s_res);
                    hq[e] = quant(mish_plain(__fadd_rn(__fmul_rn(xn, consts[2 * kTileOc + oct + e]),
                                                       consts[3 * kTileOc + oct + e])),
                                  s_head, inv_head);
                  }
                }
              }
              o1[t][h] = pack2(q[0], q[1]);
              if (MODE == kRes) o2[t][h] = pack2(hq[0], hq[1]);
            }
          }
          const int outs = head ? 2 : 1;
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            if (o >= outs) break;
#pragma unroll
            for (int t = 0; t < 4; ++t)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                *reinterpret_cast<uint16_t*>(stg + (g + 8 * h) * kStgRow + 8 * t + 2 * tig) =
                    static_cast<uint16_t>(o == 0 ? o1[t][h] : o2[t][h]);
            __syncwarp();
            tile_io<true>(o == 0 ? static_cast<int8_t*>(a.out) : a.out2, stg, b, p0, c0,
                          sh.cout, lane);
            __syncwarp();
          }
        }
        continue;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int oct = nb + 8 * t + 2 * tig;  // channel in the tile
        const int oc = oc0 + oct;
        if (oc >= sh.cout) continue;  // Cout is a multiple of 8
        float sc[2], bi[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[e] = consts[oct + e];
          bi[e] = consts[kTileOc + oct + e];
        }
#pragma unroll
        for (int j = 0; j < kWarpM; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = mg * kWarpM * 16 + j * 16 + g + 8 * h;
            if (p >= kNumLocs) continue;
            const int32_t* v = &acc[j][t][2 * h];
            const size_t idx = (static_cast<size_t>(b) * kNumLocs + p) * sh.cout + oc;
            if (MODE == kAcc) {
              *reinterpret_cast<int2*>(static_cast<int32_t*>(a.out) + idx) = make_int2(v[0], v[1]);
              continue;
            }
            float y[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              y[e] = __fmul_rn(__int2float_rn(v[e]), sc[e]);
              if (a.bias != nullptr) y[e] = __fadd_rn(y[e], bi[e]);
            }
            if (MODE == kF32) {
              *reinterpret_cast<float2*>(static_cast<float*>(a.out) + idx) =
                  make_float2(y[0], y[1]);
            } else {
              // MISH: [N, Cout, 361].
              const size_t o0 = (static_cast<size_t>(b) * sh.cout + oc) * kNumLocs + p;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float m = mish_plain(y[e]);
                if (MODE == kMishF32)
                  static_cast<float*>(a.out)[o0 + e * kNumLocs] = m;
                else
                  static_cast<__nv_bfloat16*>(a.out)[o0 + e * kNumLocs] = __float2bfloat16_rn(m);
              }
            }
          }
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (sh.stages == 1 && next < sh.n) stage_board<K>(smem_u32(xs), a.x, next, sh, vec16);
  }
}

template <int K, int MODE>
int launch(const Args& a, int n, int cin, int cout, cudaStream_t stream) {
  const int cp = padded_cin(cin);
  const int two = smem_bytes(K, cp, 2);
  // Two stages where the blocks the registers allow fit on an SM, else one.
  const int stages =
      WarpTile<K>::kBlocksPerSm * (two + kSmemReserved) <= kSmemPerSm ? 2 : 1;
  const int smem = smem_bytes(K, cp, stages);
  auto kernel = conv_i8_kernel<K, MODE>;
  int resident = 0;
  const cudaError_t err = p3trunk::resident_blocks(kernel, kThreads, smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (cout + kTileOc - 1) / kTileOc;
  int gx = resident / tiles;
  gx = gx < 1 ? 1 : (gx > n ? n : gx);
  const Shape sh{n, cin, cout, cp, stages};
  kernel<<<dim3(gx, tiles), kThreads, smem, stream>>>(a, sh);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_mode(int mode, const Args& a, int n, int cin, int cout, cudaStream_t s) {
  switch (mode) {
    case kAcc: return launch<K, kAcc>(a, n, cin, cout, s);
    case kF32: return launch<K, kF32>(a, n, cin, cout, s);
    case kI8: return launch<K, kI8>(a, n, cin, cout, s);
    case kRes: return launch<K, kRes>(a, n, cin, cout, s);
    case kMishF32: return launch<K, kMishF32>(a, n, cin, cout, s);
    case kMishBf16: return launch<K, kMishBf16>(a, n, cin, cout, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int p3_conv_i8(void* const* ptrs, int mode, int k, int n, int cin, int cout,
                          void* stream) {
  Args a;
  a.x = static_cast<const int8_t*>(ptrs[0]);
  a.w = static_cast<const int8_t*>(ptrs[1]);
  a.s_in = static_cast<const float*>(ptrs[2]);
  a.s_w = static_cast<const float*>(ptrs[3]);
  a.bias = static_cast<const float*>(ptrs[4]);
  a.s_next = static_cast<const float*>(ptrs[5]);
  a.q_prev = static_cast<const int8_t*>(ptrs[6]);
  a.s_prev = static_cast<const float*>(ptrs[7]);
  a.s_res = static_cast<const float*>(ptrs[8]);
  a.a0 = static_cast<const float*>(ptrs[9]);
  a.b0 = static_cast<const float*>(ptrs[10]);
  a.s_head = static_cast<const float*>(ptrs[11]);
  a.out = ptrs[12];
  a.out2 = static_cast<int8_t*>(ptrs[13]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1) return launch_mode<1>(mode, a, n, cin, cout, s);
  if (k == 3) return launch_mode<3>(mode, a, n, cin, cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
