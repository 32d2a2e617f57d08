// Fused bottleneck-segment kernel for a batch of 19x19 boards, bf16
// activations, for Hopper (sm_90a): wgmma, bulk-async weight staging on
// mbarriers, persistent blocks.
//
// Replaces the Pallas TPU kernels p3achygo_tpu/nn/trunk_kernel2.py
// `_make_segment_kernel` and the bottleneck branch of
// p3achygo_tpu/nn/trunk_kernel.py `_make_kernel`: a run of consecutive
// bottleneck blocks in one launch. Per block (every product bf16 x bf16 with
// f32 accumulation; act(v, a, b) = bf16(mish(f32(v) * a + b)) with the
// two-branch mish of trunk_kernel.py:55-60):
//   h = bf16(act(x, r) . Wr)
//   inner x { h = bf16(3x3_SAME(act(h, i), W9)) }
//   x = bf16(f32(x) + act(h, e) . We)
// Its plain version is ops/trunk.py `trunk_segment_reference`, which rounds
// at exactly these points; only the f32 summation order and the mish's
// division (trunk_common.cuh) differ.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): a b12c128btl3
// 3-block segment is 3 x 91.6 MFLOP per board, 792 GFLOP at N = 2880 boards,
// 0.80 ms on the tensor cores; its 532 MB of activations in and out take
// 0.16 ms. The elementwise chain is the other floor: ~1.2e9 mish at N = 2880,
// at IEEE rounding (expf, two IEEE divisions) ~45 FP32 instructions each,
// ~1.8 ms of the SMs' FP32 lanes, more than the tensor bound. So the design
// keeps the tensor cores fed from shared memory, cuts the elementwise chain
// and keeps it on registers:
//
//  - Products run on wgmma (m64nCBk16, f32 accumulators, A from registers,
//    B from shared memory through a descriptor). mma.sync carries none.
//  - Weights never pass through a consumer thread. The host packs every
//    block's weights once (ops/trunk.py `pack_segment`) into a stream of
//    CB x CB chunks, each already in the no-swizzle core-matrix layout the
//    B descriptor reads: the reduce split along K into C/CB chunks, one
//    chunk per 3x3 tap, the expand split along N into C/CB chunks. One lane
//    of a producer warpgroup copies chunk after chunk with `cp.async.bulk`
//    into a ring of shared-memory stages, completion on one mbarrier per
//    stage; the consumers wait on it and release the stage on a second
//    mbarrier once their wgmma have read it. The blocks' folded-BN affines
//    travel the same way through a two-slot ring. The producer warpgroup
//    hands registers to the consumers (setmaxnreg 32 / 160), which keeps
//    their accumulators and double-buffered A fragments out of local memory.
//  - The 3x3 without halo waste and without masks. The activated bottleneck
//    tensor lives in shared memory as a zero-haloed 21x21 grid (position
//    (i, j) at haloed row (i+1)*21 + (j+1); rows padded to CB+8 elements so
//    that eight consecutive rows fall in distinct banks). An M tile is 64
//    interior positions: ldmatrix takes one row address per lane, so each
//    row of tap (di, dj) is read at halo_row(p) + di*21 + dj. Six tiles (384
//    rows) cover the 361 positions (23 pad rows read position 360 and are
//    dropped), against 25 haloed 16-row tiles over 400 rows before. Halo rows
//    are zeroed once and never written. The expand reads the same rows at
//    shift 0.
//  - The expand feeds the next block's reduce from registers. Both products
//    take their channels (the reduce's K, the expand's N) in one permuted
//    order (ops/trunk.py `reduce_k_order`) in which a lane's expand
//    accumulators of a tile are exactly its A fragments for the next reduce
//    over the same channels, and 16 contiguous bytes of a row in memory. So,
//    tile by tile, the expand adds the residual, stores the new x (16-byte
//    stores), applies the next block's reduce affine and mish, and runs the
//    next reduce's products; x is never read back for a reduce. Only block
//    0's reduce reads x, from the input.
//  - Epilogue on registers: round, the next layer's affine, mish and the
//    bf16 store (or the residual add) read the wgmma accumulators directly;
//    there is no f32 staging tile. In the 3x3, tap o + 1's A fragments load
//    into a second register buffer while tap o's products run (wait_group 1).
//    The two-branch mish is computed without a branch and with one
//    approximate division in place of two IEEE divisions (trunk_common.cuh). Three
//    consumer warpgroups work alternate M tiles (tiles g and g+3), so one
//    group's elementwise work overlaps another's wgmma, and within a group
//    the second tile's A is built while the first tile's products run.
//  - Persistent blocks: min(N, resident blocks) blocks walk over boards
//    (grid stride); the producer runs ahead through the ring, so the next
//    board's first weight copies overlap the current board's last layer. At
//    C <= 128 a board never crosses blocks; leaf batches smaller than the
//    card (N < 132) leave SMs idle.
//  - No atomics: two calls on the same input give identical bits.
//
// Shared memory for (C, CB) = (128, 64): 10 weight stages x 8 KB, two haloed
// buffers 2 x 441 x 72 x 2 B, two affine slots of 5 x 2 x 128 f32, the
// mbarriers: 219,360 B, one 512-thread block per SM.
//
// Wider boards do not fit a block: at (256, 128) two haloed buffers take
// 2 x 441 x 136 x 2 = 239,904 B before any weight stage (the limit is
// 232,448), at (384, 192) one takes 176,400 B; and the expand's register
// hand-off to the next reduce would need 128 more registers a consumer
// thread. So `trunk_segment_cluster_kernel` splits a board's positions over
// a thread-block cluster (its own comment, below): each block keeps, in
// place, the window of grid rows its tiles read, neighbours push boundary
// rows into each other's windows by bulk copies through distributed shared
// memory, rank 0 multicasts each weight item to the cluster, and the expand
// stores x, which the next reduce reads back. A block is one consumer
// warpgroup a tile plus a producer warpgroup, one block per SM. Its shared
// memory:
//   (256, 128): cluster of 2, 3 tiles a block (512 threads, 160 registers
//     a consumer thread); a window of 13 x 21 grid rows x 136 x 2 B =
//     74,256, 4 stages of a 128 x 128 chunk (131,072), one affine slot of
//     5 x 2 x 256 f32 (10,240), 14 mbarriers: 215,680 B.
//   (384, 192): cluster of 3, 2 tiles a block (384 threads, 240 registers
//     a consumer thread); a window of 10 x 21 x 200 x 2 B = 84,000, 5 stages of a
//     192 x 64 item, a chunk's K third (122,880), one affine slot of
//     5 x 2 x 384 f32 (15,360), 16 mbarriers: 222,368 B.
//
// `tiny`'s (16, 8) has a kernel of its own, `trunk_segment_small_kernel`
// (many boards an SM, x in registers, mma.sync; its comment, below).
//
// Widths: (C, CB) in {(16, 8), (64, 32), (128, 64), (256, 128), (384, 192)},
// inner in [0, 3]; others return cudaErrorInvalidValue (the Python wrapper
// refuses them first).
//
// Interface: plain C, for ctypes. Pointers are device pointers, 16-byte
// aligned; `stream` is a cudaStream_t; `num_boards` >= 1. The function sets
// the kernel's dynamic shared-memory limit, launches on `stream` without
// synchronising, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "trunk_common.cuh"

namespace {

using namespace p3trunk;

constexpr int kTileRows = 64;
constexpr int kTiles = 6;  // 384 rows >= 361 positions
constexpr int kGroups = 3;  // consumer warpgroups
constexpr int kTilesPerGroup = kTiles / kGroups;
constexpr int kConsumerWarps = 4 * kGroups;
constexpr int kConsumerThreads = 32 * kConsumerWarps;
// + one producer warpgroup, of which one lane works. setmaxnreg moves
// registers from it to the consumers: 128 x 32 + 384 x 160 = 65,536.
constexpr int kThreads = kConsumerThreads + 128;
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;
constexpr int kMaxInner = 3;
constexpr int kMaxLayers = 2 + kMaxInner;

template <int C, int CB>
struct Shape {
  static constexpr int kLdT = CB + 8;  // haloed row stride, elements
  static constexpr int kTBytes = kHaloGrid * kLdT * 2;
  static constexpr int kChunkElems = CB * CB;
  static constexpr int kChunkBytes = kChunkElems * 2;
  static constexpr int kStages = C == 128 ? 10 : 16;
  static constexpr int kAffBytes = kMaxLayers * 2 * C * 4;
  static constexpr int kSplit = C / CB;  // reduce K chunks, expand N chunks
  static constexpr int kKSteps = CB / 16;
  static constexpr int kAcc = CB / 2;  // f32 accumulators a thread, m64nCB
  static constexpr int kTOff = kStages * kChunkBytes;
  static constexpr int kAffOff = kTOff + 2 * kTBytes;
  static constexpr int kBarOff = kAffOff + 2 * kAffBytes;
  static constexpr int kSmem = kBarOff + (2 * kStages + 4) * 8;
  static_assert(kTBytes % 16 == 0 && kAffOff % 16 == 0 && kBarOff % 8 == 0, "align");
  static_assert(kSmem <= 232448, "shared memory");
};

#ifdef P3_SEGMENT_PROFILE
// Built with -DP3_SEGMENT_PROFILE (probe_trunk.py), the kernel sums the
// clock cycles of consumer thread 0 (warpgroup 0, warp 0) by phase over a
// launch: [0] block 0's reduce and barrier, [1] 3x3 products, [2] 3x3
// epilogues and barriers, [3] expand (+ next reduce) and barrier; [4] the
// board-blocks it ran; the cluster kernel also [5] its waits for weight
// items (inside [0], [1] and [3]). p3_trunk_segment_phase_cycles reads (or
// zeroes) them.
__device__ unsigned long long g_phase_cycles[6];
#define P3_PHASE(k)                        \
  do {                                     \
    const long long now_ = clock64();      \
    phase_cycles[k] += now_ - phase_t;     \
    phase_t = now_;                        \
  } while (0)
#else
#define P3_PHASE(k) \
  do {              \
  } while (0)
#endif

// Descriptor of k-step `ks` of a weight chunk: B^T [CB n][CB k] in 8x8 core
// matrices of 128 contiguous bytes (row n%8, 16 bytes of k), core (n/8, k/8)
// at ((n/8) * (CB/8) + k/8) * 128 bytes. No swizzle: the leading byte offset
// (between cores adjacent in k) is 128, the stride byte offset (between cores
// adjacent in n) CB/8 * 128.
template <int CB>
__device__ __forceinline__ uint64_t b_desc(uint32_t chunk, int ks) {
  return smem_desc(chunk + ks * 256, 128, CB / 8 * 128);
}

// ---- elementwise --------------------------------------------------------

// Accumulator element d[4j + 2h + e] is row p0 + 8h, column 8j + 2 t4 + e.
// act(bf16(d), next layer) into the haloed buffer `dst`.
template <int C, int CB>
__device__ __forceinline__ void store_act(const float (&d)[CB / 2], bf16* dst,
                                          int p0, const float* an, int t4) {
  constexpr int kLdT = Shape<C, CB>::kLdT;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + 8 * h;
    if (p < kPos) {
      bf16* row = dst + halo_row(p) * kLdT;
#pragma unroll
      for (int j = 0; j < CB / 8; ++j) {
        const int c = 8 * j + 2 * t4;
        const float2 a = *reinterpret_cast<const float2*>(an + c);
        const float2 b = *reinterpret_cast<const float2*>(an + C + c);
        *reinterpret_cast<uint32_t*>(row + c) =
            pack2(act_f32(round_bf16(d[4 * j + 2 * h]), a.x, b.x),
                  act_f32(round_bf16(d[4 * j + 2 * h + 1]), a.y, b.y));
      }
    }
  }
}

// ---- the kernel ---------------------------------------------------------

// x, out: bf16 [num_boards, 361, C]; aff: f32 [n_blocks, 2 + inner, 2, C]
// (layer l's affine over its input channels); chunks: bf16 [n_blocks,
// 2 C/CB + 9 inner, CB * CB], the packed weights in stream order. From the
// second block on, the residual is read back from `out` after this kernel
// wrote it, so neither is __restrict__.
template <int C, int CB>
__global__ void __launch_bounds__(kThreads, 1)
trunk_segment_kernel(const bf16* x, bf16* out, const float* __restrict__ aff,
                     const bf16* __restrict__ chunks, int num_boards,
                     int n_blocks, int inner) {
  using S = Shape<C, CB>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t stage0 = smem_u32(smem);
  bf16* tbuf[2] = {reinterpret_cast<bf16*>(smem + S::kTOff),
                   reinterpret_cast<bf16*>(smem + S::kTOff + S::kTBytes)};
  const float* aff_s = reinterpret_cast<const float*>(smem + S::kAffOff);
  const uint32_t bar0 = smem_u32(smem + S::kBarOff);
  // mbarriers: full[s], empty[s] per weight stage; aff_full[i], aff_empty[i]
  // per affine slot. Both rings are walked by counters: item i sits in slot
  // i % slots, in the phase of parity (i / slots) & 1.
  const auto full = [&](uint32_t i) { return bar0 + 8u * (i % S::kStages); };
  const auto empty = [&](uint32_t i) { return bar0 + 8u * (S::kStages + i % S::kStages); };
  const auto aff_full = [&](uint32_t i) { return bar0 + 8u * (2 * S::kStages + (i & 1u)); };
  const auto aff_empty = [&](uint32_t i) {
    return bar0 + 8u * (2 * S::kStages + 2 + (i & 1u));
  };
  const auto parity = [](uint32_t i, uint32_t slots) { return (i / slots) & 1u; };
  const int layers = 2 + inner;
  const int per_block = 2 * S::kSplit + 9 * inner;  // chunks per block

  // Halo rows of both buffers stay zero from here on.
  for (int i = threadIdx.x; i < 2 * S::kTBytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(smem + S::kTOff)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(aff_full(i), 1);
      mbar_init(aff_empty(i), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // Producer: one lane streams the affines and weight chunks, board after
    // board, in the order the consumers take them, as far ahead as the
    // rings allow. Per board: block 0's affines and reduce; then per block
    // its 3x3 taps, the next block's affines, and the expand's N chunks each
    // followed by the next block's reduce K chunk of the same channels.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      const uint32_t aff_bytes = layers * 2 * C * 4;
      uint32_t ci = 0, ai = 0;
      const auto load_aff = [&](int blk) {
        mbar_wait(aff_empty(ai), parity(ai, 2) ^ 1u);
        mbar_expect_tx(aff_full(ai), aff_bytes);
        bulk_load(smem_u32(smem + S::kAffOff + (ai & 1u) * S::kAffBytes),
                  aff + static_cast<size_t>(blk) * layers * 2 * C, aff_bytes, aff_full(ai));
        ++ai;
      };
      const auto load_chunk = [&](int blk, int i) {
        mbar_wait(empty(ci), parity(ci, S::kStages) ^ 1u);
        mbar_expect_tx(full(ci), S::kChunkBytes);
        bulk_load(stage0 + (ci % S::kStages) * S::kChunkBytes,
                  chunks + (static_cast<size_t>(blk) * per_block + i) * S::kChunkElems,
                  S::kChunkBytes, full(ci));
        ++ci;
      };
      const int expand0 = S::kSplit + 9 * inner;  // first expand chunk of a block
      for (int board = blockIdx.x; board < num_boards; board += gridDim.x) {
        load_aff(0);
        for (int kc = 0; kc < S::kSplit; ++kc) load_chunk(0, kc);
        for (int blk = 0; blk < n_blocks; ++blk) {
          const bool has_next = blk + 1 < n_blocks;
          for (int i = S::kSplit; i < expand0; ++i) load_chunk(blk, i);
          if (has_next) load_aff(blk + 1);
          for (int nc = 0; nc < S::kSplit; ++nc) {
            load_chunk(blk, expand0 + nc);
            if (has_next) load_chunk(blk + 1, nc);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    // Consumers: warpgroup g owns M tiles g, g + 3; warp wq of it rows
    // 16 wq .. 16 wq + 15 of each tile.
    const int g = warp >> 2;
    const int wq = warp & 3;
    const int t4 = lane & 3;
    int p0[kTilesPerGroup];   // this lane's accumulator rows p0, p0 + 8
    int lrow[kTilesPerGroup];  // this lane's ldmatrix row (haloed), clamped
#pragma unroll
    for (int i = 0; i < kTilesPerGroup; ++i) {
      const int base = (g + i * kGroups) * kTileRows + wq * 16;
      p0[i] = base + (lane >> 2);
      const int p = base + (lane & 15);
      lrow[i] = halo_row(p < kPos ? p : kPos - 1);
    }
    const int lcol = (lane >> 4) * 8;
    uint32_t ci = 0, ai = 0;  // chunks and affine slots taken so far
    // Waits for chunk i and returns its shared address.
    const auto chunk_at = [&](uint32_t i) {
      mbar_wait(full(i), parity(i, S::kStages));
      return stage0 + (i % S::kStages) * S::kChunkBytes;
    };
    const auto release_chunk = [&](uint32_t i) {
      if (lane == 0) mbar_arrive(empty(i));
    };
    const auto aff_at = [&](uint32_t i) {
      mbar_wait(aff_full(i), parity(i, 2));
      return aff_s + (i & 1u) * (S::kAffBytes / 4);  // [layers][2][C]
    };
#ifdef P3_SEGMENT_PROFILE
    long long phase_cycles[5] = {0, 0, 0, 0, 0};
    long long phase_t = clock64();
#endif

    for (int board = blockIdx.x; board < num_boards; board += gridDim.x) {
      const size_t boff = static_cast<size_t>(board) * kPos * C;
      bf16* xo = out + boff;
      const float* af = aff_at(ai);

      // Block 0's 1x1 reduce from the input, K in kSplit chunks:
      // act(h, layer 1) into tbuf[0]. (Later blocks' reduces run fused with
      // the expand before them.)
      {
        float acc[kTilesPerGroup][S::kAcc];
#pragma unroll
        for (int i = 0; i < kTilesPerGroup; ++i) zero_acc(acc[i]);
        for (int kc = 0; kc < S::kSplit; ++kc) {
          uint32_t a[kTilesPerGroup][S::kKSteps][4];
#pragma unroll
          for (int i = 0; i < kTilesPerGroup; ++i) load_x<C, CB>(a[i], x + boff, p0[i], kc, t4);
          act_x<C, CB>(a[0], p0[0], kc, af, t4);
          const uint32_t chunk = chunk_at(ci + kc);
#pragma unroll
          for (int i = 0; i < kTilesPerGroup; ++i) {
            if (i > 0) act_x<C, CB>(a[i], p0[i], kc, af, t4);
            fence_regs(acc[i]);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < S::kKSteps; ++ks) {
              wgmma_bf16(acc[i], a[i][ks], b_desc<CB>(chunk, ks));
            }
            wgmma_commit();
          }
          wgmma_wait_all();
#pragma unroll
          for (int i = 0; i < kTilesPerGroup; ++i) {
            fence_regs(acc[i]);
            fence_regs(a[i]);
          }
        }
        for (int kc = 0; kc < S::kSplit; ++kc) release_chunk(ci + kc);
        ci += S::kSplit;
#pragma unroll
        for (int i = 0; i < kTilesPerGroup; ++i) {
          store_act<C, CB>(acc[i], tbuf[0], p0[i], af + 2 * C, t4);
        }
      }
      consumer_sync<kConsumerThreads>();
      P3_PHASE(0);

      for (int blk = 0; blk < n_blocks; ++blk) {
        const bf16* cur = blk == 0 ? x + boff : xo;

        // Inner 3x3 convolutions, one chunk per tap, ping-ponging buffers.
        // Tap o + 1's A fragments load while tap o's products run (two
        // register buffers; wait_group 1 frees the older one).
        for (int j = 0; j < inner; ++j) {
          const uint32_t src = smem_u32(tbuf[j & 1]);
          float acc[kTilesPerGroup][S::kAcc];
#pragma unroll
          for (int i = 0; i < kTilesPerGroup; ++i) zero_acc(acc[i]);
          uint32_t a[2][kTilesPerGroup][S::kKSteps][4];
          const auto load_tap = [&](uint32_t (&dst)[kTilesPerGroup][S::kKSteps][4], int o) {
            const int shift = (o / 3 - 1) * kHaloW + (o % 3 - 1);
#pragma unroll
            for (int i = 0; i < kTilesPerGroup; ++i) {
              const uint32_t row = src + ((lrow[i] + shift) * S::kLdT + lcol) * 2;
#pragma unroll
              for (int ks = 0; ks < S::kKSteps; ++ks) ldmatrix_x4(dst[i][ks], row + ks * 32);
            }
          };
          uint32_t chunk = chunk_at(ci);
          load_tap(a[0], 0);
#pragma unroll
          for (int o = 0; o < 9; ++o) {
#pragma unroll
            for (int i = 0; i < kTilesPerGroup; ++i) fence_regs(acc[i]);
            wgmma_fence();
#pragma unroll
            for (int i = 0; i < kTilesPerGroup; ++i) {
#pragma unroll
              for (int ks = 0; ks < S::kKSteps; ++ks) {
                wgmma_bf16(acc[i], a[o & 1][i][ks], b_desc<CB>(chunk, ks));
              }
            }
            wgmma_commit();
            if (o < 8) {
              wgmma_wait<1>();  // tap o - 1 is done: its registers and chunk
              fence_regs(a[(o + 1) & 1]);
              if (o > 0) release_chunk(ci + o - 1);
              chunk = chunk_at(ci + o + 1);
              load_tap(a[(o + 1) & 1], o + 1);
            }
          }
          wgmma_wait_all();
#pragma unroll
          for (int i = 0; i < kTilesPerGroup; ++i) fence_regs(acc[i]);
          fence_regs(a[0]);
          fence_regs(a[1]);
          release_chunk(ci + 7);
          release_chunk(ci + 8);
          ci += 9;
          P3_PHASE(1);
#pragma unroll
          for (int i = 0; i < kTilesPerGroup; ++i) {
            store_act<C, CB>(acc[i], tbuf[(j + 1) & 1], p0[i], af + (2 + j) * 2 * C, t4);
          }
          consumer_sync<kConsumerThreads>();
          P3_PHASE(2);
        }
        // This block's affines are done with (the expand takes none).
        if (lane == 0) mbar_arrive(aff_empty(ai));
        ++ai;

        // 1x1 expand, N in kSplit chunks, + residual, in place in `out`;
        // tile by tile, each N chunk's new x (bf16, in the accumulator
        // layout) is also, after act(., next layer 0), the next block's
        // reduce A fragments for the K chunk of the same channels, so the
        // next reduce runs here from registers: act(h, next layer 1) into
        // tbuf[0]. A tile writes only its own rows, which only it reads in
        // the expand.
        const bool has_next = blk + 1 < n_blocks;
        const float* afn = has_next ? aff_at(ai) : nullptr;
        const uint32_t n_chunks = has_next ? 2 * S::kSplit : S::kSplit;
        {
          const uint32_t src = smem_u32(tbuf[inner & 1]);
#pragma unroll
          for (int i = 0; i < kTilesPerGroup; ++i) {
            const uint32_t row = src + (lrow[i] * S::kLdT + lcol) * 2;
            float acc_r[S::kAcc];
            zero_acc(acc_r);
            uint32_t ar[S::kKSteps][4] = {};
            for (int nc = 0; nc < S::kSplit; ++nc) {
              uint4 res[2][CB / 32];
              load_residual<C, CB>(res, cur, p0[i], nc * CB, t4);
              uint32_t a[S::kKSteps][4];
#pragma unroll
              for (int ks = 0; ks < S::kKSteps; ++ks) ldmatrix_x4(a[ks], row + ks * 32);
              float acc[S::kAcc];
              zero_acc(acc);
              const uint32_t chunk = chunk_at(ci + (has_next ? 2 * nc : nc));
              fence_regs(acc);
              wgmma_fence();
#pragma unroll
              for (int ks = 0; ks < S::kKSteps; ++ks) {
                wgmma_bf16(acc, a[ks], b_desc<CB>(chunk, ks));
              }
              wgmma_commit();
              wgmma_wait_all();  // also the previous chunk's reduce products
              fence_regs(acc);
              fence_regs(a);
              fence_regs(acc_r);
              fence_regs(ar);
              store_residual<C, CB>(acc, res, xo, p0[i], nc * CB, t4, afn, ar);
              if (has_next) {
                const uint32_t rchunk = chunk_at(ci + 2 * nc + 1);
                wgmma_fence();
#pragma unroll
                for (int ks = 0; ks < S::kKSteps; ++ks) {
                  wgmma_bf16(acc_r, ar[ks], b_desc<CB>(rchunk, ks));
                }
                wgmma_commit();
              }
            }
            wgmma_wait_all();
            fence_regs(acc_r);
            fence_regs(ar);
            if (has_next) store_act<C, CB>(acc_r, tbuf[0], p0[i], afn + 2 * C, t4);
          }
        }
        for (uint32_t k = 0; k < n_chunks; ++k) release_chunk(ci + k);
        ci += n_chunks;
        af = afn;
        consumer_sync<kConsumerThreads>();
        P3_PHASE(3);
#ifdef P3_SEGMENT_PROFILE
        ++phase_cycles[4];
#endif
      }
    }
#ifdef P3_SEGMENT_PROFILE
    if (threadIdx.x == 0) {
      for (int k = 0; k < 5; ++k) {
        atomicAdd(&g_phase_cycles[k], static_cast<unsigned long long>(phase_cycles[k]));
      }
    }
#endif
  }
}

template <int C, int CB>
int launch_segment(const void* x, void* out, const void* aff, const void* chunks,
                   int num_boards, int n_blocks, int inner, cudaStream_t stream) {
  using S = Shape<C, CB>;
  if (num_boards < 1 || n_blocks < 1 || inner < 0 || inner > kMaxInner) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = trunk_segment_kernel<C, CB>;
  // Resident blocks on this card, once per process (one card per process).
  static int resident = 0;
  if (resident == 0) {
    const cudaError_t err = resident_blocks(kernel, kThreads, S::kSmem, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = num_boards < resident ? num_boards : resident;
  kernel<<<grid, kThreads, S::kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out),
      static_cast<const float*>(aff), static_cast<const bf16*>(chunks), num_boards,
      n_blocks, inner);
  return static_cast<int>(cudaGetLastError());
}


// ---- the cluster kernel: (C, CB) in {(256, 128), (384, 192)} ------------
//
// A board's six M tiles are shared among the kCluster blocks of a thread-
// block cluster: block r owns tiles r * TB .. r * TB + TB - 1 (TB = 6 /
// kCluster), one consumer warpgroup a tile over all CB output columns
// (m64nCBk16), and keeps one haloed buffer, holding only the window of
// grid rows its tiles' taps read (its board rows and one more on each
// side). One lane of a producer warpgroup streams the weights; the
// warpgroup hands its registers to the consumers (setmaxnreg).
//
// Layer boundaries. The buffer is updated in place. After the products of
// a 3x3 layer every block passes one consumer barrier over the cluster
// (`exchange`: every read of every window is done); then each block stores
// its outputs into its own window, and one thread pushes the rows that a
// neighbour's window holds to that neighbour with a bulk copy from shared
// memory to distributed shared memory, which completes on the neighbour's
// `rows_in` mbarrier (the neighbour arms it with the bytes it expects; two
// alternate, so a push of the next step never counts towards a phase still
// waiting). A block then waits only for its neighbours' rows. A layer thus
// costs one cluster barrier and one wait on the neighbours, with 16-byte
// aligned bulk copies in place of 4-byte remote stores. The reduce stores
// and pushes without a barrier (no window is being read then: the last
// layer's barrier followed every 3x3 read, and the expand reads only its
// own rows), and the last 3x3 layer pushes nothing (only the expand, on
// its own rows, reads its output).
//
// Weights stream as items, a chunk whole at (256, 128), a chunk's three
// 64-channel K slices at (384, 192); every consumer group of every block
// reads every item. Rank 0 fetches each item once for the cluster with a
// multicast bulk copy; a stage's "empty" mbarrier in rank 0 gathers the
// consumer warps of every block. Every product runs item by item with the
// A fragments of one item double-buffered: an item's products run while the
// next item's A loads (x and act(x) for the reduce, ldmatrix from the
// window for the 3x3 and the expand), one loop for all three. The expand
// writes x; the next block's reduce reads it back
// (the register hand-off of the smaller widths would need 128 more
// registers a consumer thread at C = 256).
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s), on the work
// chip_smoke.py `segment_work` counts: a bottleneck block of 3 inner layers
// is 366.7 MFLOP per board at (256, 128) and 825.1 at (384, 192), 1.068 and
// 2.403 ms per block at N = 2880 on the tensor cores; x in and out takes
// 0.318 / 0.477 ms a call. The elementwise chain (act after every product,
// 5 x 361 x CB mish a board-block) runs beside the products.

// Haloed board rows (21 grid rows each) of the window of rank r, when a
// block owns `tb` consecutive 64-position tiles: board rows first .. last of
// its positions, plus one on each side.
__host__ __device__ constexpr int window_first(int r, int tb) { return kTileRows * tb * r / kBoard; }
__host__ __device__ constexpr int window_board_rows(int r, int tb) {
  return ((kTileRows * tb * (r + 1) < kPos ? kTileRows * tb * (r + 1) : kPos) - 1) / kBoard + 2 -
         window_first(r, tb) + 1;
}
__host__ __device__ constexpr int max_window_board_rows(int tb) {
  int m = 0;
  for (int r = 0; r < kTiles / tb; ++r) {
    m = window_board_rows(r, tb) > m ? window_board_rows(r, tb) : m;
  }
  return m;
}

// The grid rows [push_first, push_first + push_rows) that rank `src` pushes
// into the window of rank `dst`: the haloed rows from its first to its last
// own position (positions and the zero halo cells between board rows),
// within dst's window. Both windows lay grid rows out alike, so the range
// is contiguous in both.
__host__ __device__ constexpr int grid_row(int p) {
  return (p / kBoard + 1) * kHaloW + p % kBoard + 1;
}
__host__ __device__ constexpr int push_first(int src, int dst, int tb) {
  const int own = grid_row(kTileRows * tb * src);
  const int win = window_first(dst, tb) * kHaloW;
  return own > win ? own : win;
}
__host__ __device__ constexpr int push_rows(int src, int dst, int tb) {
  const int last = kTileRows * tb * (src + 1) < kPos ? kTileRows * tb * (src + 1) : kPos;
  const int own_end = grid_row(last - 1) + 1;
  const int win_end = (window_first(dst, tb) + window_board_rows(dst, tb)) * kHaloW;
  const int end = own_end < win_end ? own_end : win_end;
  return end > push_first(src, dst, tb) ? end - push_first(src, dst, tb) : 0;
}

template <int C, int CB>
struct WideShape {
  // (256, 128) keeps 3 tiles a block: at 2 (a cluster of 3) each weight
  // item serves fewer tiles, and the kernel ran slower on an H100.
  static constexpr int kCluster = C == 256 ? 2 : 3;
  static constexpr int kTB = kTiles / kCluster;  // tiles = consumer warpgroups a block
  static constexpr int kConsumerWarps = 4 * kTB;
  static constexpr int kConsumerThreads = 32 * kConsumerWarps;
  // + a producer warpgroup (one lane works), which hands its registers to
  // the consumers by setmaxnreg: 24 / 160 a thread at (256, 128), 24 / 240
  // at (384, 192). (With one producer warp and no setmaxnreg the launch
  // bound left a consumer 128 / 168 registers, ptxas spilled, and the
  // kernel ran slower on an H100.)
  static constexpr int kThreads = kConsumerThreads + 128;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs =
      (65536 - 128 * kProducerRegs) / kConsumerThreads / 8 * 8 > 240
          ? 240
          : (65536 - 128 * kProducerRegs) / kConsumerThreads / 8 * 8;
  static constexpr int kLdT = CB + 8;
  static constexpr int kRowBytes = kLdT * 2;
  static constexpr int kWinRows = max_window_board_rows(kTB) * kHaloW;
  static constexpr int kPlaneBytes = kWinRows * kRowBytes;
  static constexpr int kKSteps = CB / 16;
  // k16 steps an item: the whole chunk at (256, 128) (64-row items ran
  // slower there on an H100), a 64-row K slice at (384, 192).
  static constexpr int kItemKSteps = C == 256 ? kKSteps : 4;
  static constexpr int kItems = kKSteps / kItemKSteps;        // items a chunk
  static constexpr int kItemK = 16 * kItemKSteps;
  static constexpr int kItemElems = CB * kItemK;  // B^T [CB n][kItemK k]
  static constexpr int kItemBytes = kItemElems * 2;
  static constexpr int kSplit = C / CB;
  static constexpr int kAcc = CB / 2;  // f32 accumulators a thread, m64nCB
  static constexpr int kAffBytes = kMaxLayers * 2 * C * 4;
  // As many stages (an item and two mbarriers each) as the block's shared
  // memory holds beside the window, the affines and six mbarriers (at
  // most 8).
  static constexpr int kFit = (232448 - kPlaneBytes - kAffBytes - 6 * 8) / (kItemBytes + 2 * 8);
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kPlaneOff = kStages * kItemBytes;
  static constexpr int kAffOff = kPlaneOff + kPlaneBytes;
  static constexpr int kBarOff = kAffOff + kAffBytes;
  // full[s], empty[s]; aff_full, aff_empty; exchange[2]; rows_in[2]
  static constexpr int kSmem = kBarOff + (2 * kStages + 6) * 8;
  static_assert(kTB * kCluster == kTiles && kSplit == 2, "tiling");
  static_assert(CB % 64 == 0 && kItems * kItemKSteps == kKSteps && kStages >= kItems, "items");
  static_assert(kPlaneBytes % 16 == 0 && kRowBytes % 16 == 0 && kAffOff % 16 == 0 &&
                kBarOff % 8 == 0, "align");
  static_assert(kSmem <= 232448, "shared memory");
};

// Descriptor of k16 step `ks` of an item (B^T [n][K] in 8x8 core matrices,
// core (n/8, k/8) at ((n/8) * (K/8) + k/8) * 128 bytes; LBO 128, SBO K/8 *
// 128).
template <int K>
__device__ __forceinline__ uint64_t item_desc(uint32_t item, int ks) {
  return smem_desc(item + ks * 256, 128, K / 8 * 128);
}

// act(bf16(d), next layer) of the tile's rows into this block's window of
// the haloed buffer at `plane` (shared address; `win0` its first grid row),
// then fence_proxy_async, since the rows may leave by a bulk copy.
template <int C, int CB>
__device__ __forceinline__ void store_act_window(const float (&d)[CB / 2], uint32_t plane,
                                                 int win0, int p0, const float* an, int t4) {
  using S = WideShape<C, CB>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + 8 * h;
    if (p >= kPos) continue;
    const uint32_t row = plane + (halo_row(p) - win0) * S::kRowBytes;
#pragma unroll
    for (int j = 0; j < CB / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      const float2 a = *reinterpret_cast<const float2*>(an + c);
      const float2 b = *reinterpret_cast<const float2*>(an + C + c);
      const uint32_t v = pack2(act_f32(round_bf16(d[4 * j + 2 * h]), a.x, b.x),
                               act_f32(round_bf16(d[4 * j + 2 * h + 1]), a.y, b.y));
      asm volatile("st.shared.u32 [%0], %1;" ::"r"(row + c * 2), "r"(v) : "memory");
    }
  }
  fence_proxy_async();
}

// x, out, aff as trunk_segment_kernel's; chunks: bf16 [n_blocks, 2 C/CB +
// 9 inner, CB * CB], each chunk as kItems items of B^T [CB n][kItemK k]
// (`pack_segment`). The grid is a whole number of clusters; each cluster
// walks boards (cluster index, stride clusters).
template <int C, int CB>
__global__ void __launch_bounds__(WideShape<C, CB>::kThreads, 1)
trunk_segment_cluster_kernel(const bf16* x, bf16* out, const float* __restrict__ aff,
                             const bf16* __restrict__ chunks, int num_boards, int n_blocks,
                             int inner) {
  using S = WideShape<C, CB>;
  constexpr int R = S::kCluster;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rank = static_cast<int>(cluster_rank());
  const int cluster_id = blockIdx.x / R;
  const int n_clusters = gridDim.x / R;
  const uint32_t stage0 = smem_u32(smem);
  const uint32_t plane = smem_u32(smem + S::kPlaneOff);
  const float* aff_s = reinterpret_cast<const float*>(smem + S::kAffOff);
  const uint32_t bar0 = smem_u32(smem + S::kBarOff);
  // Ring item i sits in stage i % kStages, in the phase of parity
  // (i / kStages) & 1 of full(i) and of empty(i) (rank 0's counts the
  // consumers of every block). The affines take one slot; exchange e uses
  // exchange(e & 1) in its phase (e >> 1) & 1, push step e rows_in(e & 1)
  // the same way.
  const auto full = [&](uint32_t i) { return bar0 + 8u * (i % S::kStages); };
  const auto empty = [&](uint32_t i) { return bar0 + 8u * (S::kStages + i % S::kStages); };
  const uint32_t aff_full = bar0 + 8u * (2 * S::kStages);
  const uint32_t aff_empty = aff_full + 8u;
  const auto xbar = [&](uint32_t e) { return aff_full + 16u + 8u * (e & 1u); };
  const auto rows_in = [&](uint32_t e) { return aff_full + 32u + 8u * (e & 1u); };
  const auto parity = [](uint32_t i) { return (i / S::kStages) & 1u; };
  const int layers = 2 + inner;
  const int per_block = 2 * S::kSplit + 9 * inner;  // chunks per block

  for (int i = threadIdx.x; i < S::kPlaneBytes / 16; i += S::kThreads) {
    reinterpret_cast<uint4*>(smem + S::kPlaneOff)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), S::kConsumerWarps * R);
    }
    mbar_init(aff_full, 1);
    mbar_init(aff_empty, S::kConsumerWarps);
    mbar_init(xbar(0), R);
    mbar_init(xbar(1), R);
    mbar_init(rows_in(0), 1);
    mbar_init(rows_in(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Every block's mbarriers and zeroed window before any peer uses them.
  cluster_sync_all();

  if (warp >= S::kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(S::kProducerRegs));
    // Producer, one lane: per board and block the affines (this block's own
    // copy), then the block's chunks in stream order, item by item. Rank 0
    // multicasts every item once its stage is free in every block; each
    // block arms its own stage's expected bytes once the stage's previous
    // phase has completed.
    if (warp == S::kConsumerWarps && lane == 0) {
      const uint32_t aff_bytes = layers * 2 * C * 4;
      const uint16_t mask = static_cast<uint16_t>((1u << R) - 1u);
      uint32_t it = 0, ai = 0;
      for (int board = cluster_id; board < num_boards; board += n_clusters) {
        for (int blk = 0; blk < n_blocks; ++blk, ++ai) {
          mbar_wait(aff_empty, (ai & 1u) ^ 1u);
          mbar_expect_tx(aff_full, aff_bytes);
          bulk_load(smem_u32(aff_s), aff + static_cast<size_t>(blk) * layers * 2 * C,
                    aff_bytes, aff_full);
          const bf16* src = chunks + static_cast<size_t>(blk) * per_block * CB * CB;
          for (int i = 0; i < per_block * S::kItems; ++i, ++it) {
            if (rank == 0) {
              mbar_wait(empty(it), parity(it) ^ 1u);
            } else {
              mbar_wait(full(it), parity(it) ^ 1u);
            }
            mbar_expect_tx(full(it), S::kItemBytes);
            if (rank == 0) {
              bulk_load_multicast(stage0 + (it % S::kStages) * S::kItemBytes,
                                  src + static_cast<size_t>(i) * S::kItemElems, S::kItemBytes,
                                  full(it), mask);
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(S::kConsumerRegs));
    const int g = warp >> 2;
    const int wq = warp & 3;
    const int t4 = lane & 3;
    const int base = (rank * S::kTB + g) * kTileRows + wq * 16;  // this warp's tile rows
    const int p0 = base + (lane >> 2);  // this lane's accumulator rows p0, p0 + 8
    const int win0 = window_first(rank, S::kTB) * kHaloW;
    const int lp = base + (lane & 15);
    const int lrow = halo_row(lp < kPos ? lp : kPos - 1) - win0;  // ldmatrix row
    const int lcol = (lane >> 4) * 8;
    // Bytes this block's neighbours push into its window at each step.
    uint32_t in_bytes = 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int s = rank + 2 * k - 1;
      if (s >= 0 && s < R) in_bytes += push_rows(s, rank, S::kTB) * S::kRowBytes;
    }
    uint32_t it = 0, ai = 0, e = 0, pe = 0;  // items, affine loads, exchanges, pushes
#ifdef P3_SEGMENT_PROFILE
    long long phase_cycles[6] = {0, 0, 0, 0, 0, 0};
    long long phase_t = clock64();
#endif
    // Waits for item i; returns its address.
    const auto item_at = [&](uint32_t i) {
#ifdef P3_SEGMENT_PROFILE
      const long long w0 = clock64();
#endif
      mbar_wait(full(i), parity(i));
#ifdef P3_SEGMENT_PROFILE
      phase_cycles[5] += clock64() - w0;
#endif
      return stage0 + (i % S::kStages) * S::kItemBytes;
    };
    const auto release = [&](uint32_t i) {
      if (lane == 0) mbar_arrive_cluster(cluster_map(empty(i), 0));
    };
    // A consumer barrier over the cluster: every block's shared-memory reads
    // before it are done.
    const auto exchange = [&]() {
      consumer_sync<S::kConsumerThreads>();
      if (threadIdx.x == 0) {
        fence_acq_rel_cluster();
        for (int s = 0; s < R; ++s) mbar_arrive_cluster(cluster_map(xbar(e), s));
      }
      mbar_wait_cluster(xbar(e), (e >> 1) & 1u);
      ++e;
    };
    // After every consumer stored its rows of the window (store_act_window):
    // push the rows each neighbour's window holds, then wait for theirs.
    const auto push = [&]() {
      consumer_sync<S::kConsumerThreads>();
      if (threadIdx.x == 0) {
        mbar_expect_tx(rows_in(pe), in_bytes);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int s = rank + 2 * k - 1;
          if (s < 0 || s >= R) continue;
          const int first = push_first(rank, s, S::kTB);
          const int rows = push_rows(rank, s, S::kTB);
          if (rows == 0) continue;
          const int w0 = window_first(s, S::kTB) * kHaloW;
          bulk_copy_to_peer(cluster_map(plane + (first - w0) * S::kRowBytes, s),
                            plane + (first - win0) * S::kRowBytes, rows * S::kRowBytes,
                            cluster_map(rows_in(pe), s));
        }
      }
      mbar_wait(rows_in(pe), (pe >> 1) & 1u);
      ++pe;
    };
    // acc += A . B over `n` consecutive items of the ring, item by item:
    // item i's products run while item i + 1's A fragments load (`load(a,
    // i)`) into the other register buffer; each item is released as soon
    // as its products are done. n is a constant at every call, and the loop
    // unrolls (rolled by two, it ran slower at both widths on an H100).
    const auto run_items = [&](float (&acc)[S::kAcc], int n, auto&& load) {
      uint32_t a[2][S::kItemKSteps][4];
      fence_regs(acc);
      load(a[0], 0);
#pragma unroll
      for (int i = 0; i < n; ++i) {
        const uint32_t b = item_at(it);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < S::kItemKSteps; ++kk) {
          wgmma_bf16(acc, a[i & 1][kk], item_desc<S::kItemK>(b, kk));
        }
        wgmma_commit();
        if (i > 0) {
          wgmma_wait<1>();  // item i - 1 is done: its stage and registers
          release(it - 1);
        }
        if (i + 1 < n) {
          fence_regs(a[(i + 1) & 1]);
          load(a[(i + 1) & 1], i + 1);
        }
        ++it;
      }
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(a[0]);
      fence_regs(a[1]);
      release(it - 1);
    };

    for (int board = cluster_id; board < num_boards; board += n_clusters) {
      const size_t boff = static_cast<size_t>(board) * kPos * C;
      bf16* xo = out + boff;
      for (int blk = 0; blk < n_blocks; ++blk, ++ai) {
        const bf16* cur = blk == 0 ? x + boff : xo;
        mbar_wait(aff_full, ai & 1u);
        const float* af = aff_s;  // [layers][2][C]

        // 1x1 reduce from x, item i = input channels 64 i .. 64 i + 63:
        // act(h, layer 1).
        {
          float acc[S::kAcc];
          zero_acc(acc);
          run_items(acc, C / S::kItemK, [&](uint32_t (&dst)[S::kItemKSteps][4], int i) {
            load_x<C, S::kItemK>(dst, cur, p0, i, t4);
            act_x<C, S::kItemK>(dst, p0, i, af, t4);
          });
          store_act_window<C, CB>(acc, plane, win0, p0, af + 2 * C, t4);
          if (inner > 0) {
            push();
          } else {
            consumer_sync<S::kConsumerThreads>();
          }
          P3_PHASE(0);
        }

        // Inner 3x3 convolutions, one chunk per tap: item s is tap s / kItems,
        // its K slice s % kItems.
        for (int j = 0; j < inner; ++j) {
          float acc[S::kAcc];
          zero_acc(acc);
          run_items(acc, 9 * S::kItems, [&](uint32_t (&dst)[S::kItemKSteps][4], int i) {
            const int o = i / S::kItems;
            const int shift = (o / 3 - 1) * kHaloW + (o % 3 - 1);
            const uint32_t row = plane + (lrow + shift) * S::kRowBytes + lcol * 2 +
                                 (i % S::kItems) * S::kItemK * 2;
#pragma unroll
            for (int kk = 0; kk < S::kItemKSteps; ++kk) ldmatrix_x4(dst[kk], row + kk * 32);
          });
          P3_PHASE(1);
          exchange();  // every window's reads of this layer are done
          store_act_window<C, CB>(acc, plane, win0, p0, af + (2 + j) * 2 * C, t4);
          if (j + 1 < inner) {
            push();
          } else {
            consumer_sync<S::kConsumerThreads>();
          }
          P3_PHASE(2);
        }
        // This block's affines are done with (every warp is past the
        // last consumer barrier, so past its last read of them).
        if (lane == 0) mbar_arrive(aff_empty);

        // 1x1 expand of the tile's rows, N in kSplit chunks, K item by item
        // from this block's own rows, + residual (in 64-channel parts), in
        // place in `out`.
        {
          const uint32_t row = plane + lrow * S::kRowBytes + lcol * 2;
          for (int nc = 0; nc < S::kSplit; ++nc) {
            float acc[S::kAcc];
            zero_acc(acc);
            run_items(acc, S::kItems, [&](uint32_t (&dst)[S::kItemKSteps][4], int i) {
#pragma unroll
              for (int kk = 0; kk < S::kItemKSteps; ++kk) {
                ldmatrix_x4(dst[kk], row + (i * S::kItemK + 16 * kk) * 2);
              }
            });
#pragma unroll
            for (int part = 0; part < CB / 64; ++part) {
              const int c0 = nc * CB + 64 * part;
              uint4 res[2][2];
              load_residual<C, 64>(res, cur, p0, c0, t4);
              uint32_t unused[4][4];
              store_residual<C, 64>(*reinterpret_cast<const float(*)[32]>(acc + 32 * part), res,
                                    xo, p0, c0, t4, nullptr, unused);
            }
          }
        }
        // Every warp's x written, and every read of this block's own rows
        // done, before the next reduce reads x and stores.
        consumer_sync<S::kConsumerThreads>();
        P3_PHASE(3);
#ifdef P3_SEGMENT_PROFILE
        ++phase_cycles[4];
#endif
      }
    }
#ifdef P3_SEGMENT_PROFILE
    if (threadIdx.x == 0 && rank == 0) {
      for (int k = 0; k < 6; ++k) {
        atomicAdd(&g_phase_cycles[k], static_cast<unsigned long long>(phase_cycles[k]));
      }
    }
#endif
  }
  // No block exits while a peer may still read, store into or arrive on
  // its shared memory.
  __syncwarp();
  cluster_sync_all();
}

template <int C, int CB>
int launch_segment_cluster(const void* x, void* out, const void* aff, const void* chunks,
                           int num_boards, int n_blocks, int inner, cudaStream_t stream) {
  using S = WideShape<C, CB>;
  if (num_boards < 1 || n_blocks < 1 || inner < 0 || inner > kMaxInner) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = trunk_segment_cluster_kernel<C, CB>;
  // Resident clusters on this card, once per process (one card per process).
  static int resident = 0;
  if (resident == 0) {
    const cudaError_t err =
        resident_clusters(kernel, S::kThreads, S::kSmem, S::kCluster, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int clusters = num_boards < resident ? num_boards : resident;
  const cudaError_t err = launch_clusters(
      kernel, clusters * S::kCluster, S::kThreads, S::kSmem, S::kCluster, stream,
      static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<const float*>(aff),
      static_cast<const bf16*>(chunks), num_boards, n_blocks, inner);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}


// ---- the small kernel: (C, CB) = (16, 8), `tiny` --------------------------
//
// Replaces `_make_segment_kernel` / `_make_kernel`'s btl branch at the width
// of tiny (config/ci-tiny.json, the scale-out dry run), which ran before as
// the (64, 32) kernel zero-padded: 16x its products and 4x its bytes.
//
// What bounds it on an H100: a 3-block segment of one 3x3 layer a block is
// 1.8 MFLOP a board against 23 KB of x in and out, so bytes (66.5 MB at
// N = 2880, 0.0199 ms at 3.35 TB/s) bound it, and products (0.0052 ms) do
// not. Next comes the elementwise chain: 32 mish a position and block,
// ~1.0e8 at N = 2880, each two MUFU operations (ex2 and the reciprocal;
// ~0.048 ms on the SMs' 16 MUFU lanes at 1.98 GHz), three selects and the
// bf16 packing on the half-rate integer pipe, ~15 instructions in all
// (mish_small). In practice the chain and the products' dependency chains
// decide the time (PERF.md). So the design moves x once, keeps everything
// between in registers and shared memory, keeps several boards an SM in
// flight, and spends few instructions that are not the chain's:
//
//  - A board a block of kSmallWarps warps, several blocks an SM (no
//    persistent 512-thread block): one block's barriers and load waits
//    overlap the others' work. Blocks walk boards by grid stride; the next
//    board's x comes by one bulk copy (cp.async.bulk, 11,552 bytes) into
//    shared memory on an mbarrier while this board computes.
//  - x lives in registers from the first reduce to the last expand. A board
//    is 24 M tiles of 16 rows (23 hold positions); warp w owns tiles w,
//    w + 4, ... and keeps their x as mma fragments: lane t of a quad loads
//    channels 4t .. 4t + 3 of rows g, g + 8, which are logical k (2t, 2t + 1,
//    2t + 8, 2t + 9) of the reduce's m16n8k16 A fragment (ops/trunk.py
//    `small_k_order`), and the expand's two m16n8k8 n-tiles put the same
//    four channels in the same lane's accumulators, with We's columns in
//    that order. So the expand adds the residual in registers and the next
//    block's reduce reads act(x) from there; x is stored once, at the end.
//  - The 3x3 on the tensor cores from a zero-haloed 21x21 grid of the
//    bottleneck in shared memory, 16 bytes a position (one ldmatrix row):
//    taps paired into m16n8k16 steps (one ldmatrix.x4 each), the ninth tap
//    m16n8k8 (ldmatrix.x2). Accumulators of the reduce and of a 3x3 layer
//    go to the grid after act; the last 3x3 layer's feed the expand from
//    registers (the accumulator layout is the m16n8k8 A layout). Two grids
//    alternate, so a layer needs one barrier of its block (its input
//    written), none between the last 3x3, the expand, the next reduce and
//    its store.
//  - Weights as mma B fragments, packed on the host (`pack_segment`): per
//    block 4 + 9 inner words a lane (two reduce, nine a 3x3 layer, two
//    expand), loaded coalesced from L1 / L2 once a block and board.
//  - mish_small: one ex2 and one reciprocal, n and d by exact fmas.
//  - No atomics: two calls on the same input give identical bits.
//
// Tried on an H100 and not kept, none faster: 5 to 8 blocks an SM with
// fewer registers (spills), 8 or 6 warps a board, a non-persistent grid, x
// in shared memory between blocks with tiles interleaved two or three at a
// time, one reciprocal shared by two mish.
//
// Shared memory a block: x 11,552 B, two grids 2 x 441 x 16 B, an
// mbarrier: 25,672 B; 128 threads, at most 128 registers a thread, four
// blocks an SM.

constexpr int kSmallWarps = 4;
constexpr int kSmallThreads = 32 * kSmallWarps;
constexpr int kSmallTiles = 24;  // 16-row M tiles: 384 rows >= 361
constexpr int kSmallLive = (kPos + 15) / 16;  // 23 tiles hold positions
constexpr int kSmallTPW = kSmallTiles / kSmallWarps;  // tiles a warp
constexpr int kSmallMinBlocks = 4;  // blocks an SM (registers: <= 128 a thread)

template <int C, int CB>
struct SmallShape {
  static constexpr int kXBytes = kPos * C * 2;
  static constexpr int kRowBytes = CB * 2;  // a grid row: one position's bottleneck
  static constexpr int kGridBytes = kHaloGrid * kRowBytes;
  static constexpr int kGridOff = kXBytes;
  static constexpr int kBarOff = kGridOff + 2 * kGridBytes;
  static constexpr int kSmem = kBarOff + 8;
  static_assert(C == 16 && CB == 8, "the small kernel's fragments are for (16, 8)");
  static_assert(kXBytes % 16 == 0 && kGridOff % 16 == 0 && kBarOff % 8 == 0, "align");
};

// acc = act(x, a, b) . Wr: x the tile's fragment (rows g, g + 8; channels
// 4t .. 4t + 3, as the A fragment), a / b the reduce affine of those
// channels, w0 / w1 the lane's B fragment; acc rows g, g + 8, bottleneck
// channels 2t, 2t + 1.
__device__ __forceinline__ void small_reduce(float (&acc)[4], const uint32_t (&x)[4],
                                             float4 a, float4 b, uint32_t w0, uint32_t w1) {
  const uint32_t frag[4] = {act2_small(x[0], a.x, b.x, a.y, b.y),
                            act2_small(x[1], a.x, b.x, a.y, b.y),
                            act2_small(x[2], a.z, b.z, a.w, b.w),
                            act2_small(x[3], a.z, b.z, a.w, b.w)};
  zero_acc(acc);
  mma_16816(acc, frag, w0, w1);
}

// act(bf16(acc), a, b) of rows p0 (acc 0, 1) and p0 + 8 (acc 2, 3),
// channels 2t, 2t + 1, into the grid at `grid` (pad rows not stored).
// Plain stores, which the compiler orders against the barriers.
__device__ __forceinline__ void small_store(unsigned char* grid, int p0, const float (&acc)[4],
                                            float2 a, float2 b, int t4) {
  const uint32_t v0 = act2_small(pack2(acc[0], acc[1]), a.x, b.x, a.y, b.y);
  const uint32_t v1 = act2_small(pack2(acc[2], acc[3]), a.x, b.x, a.y, b.y);
  if (p0 < kPos) *reinterpret_cast<uint32_t*>(grid + halo_row(p0) * 16 + t4 * 4) = v0;
  if (p0 + 8 < kPos) *reinterpret_cast<uint32_t*>(grid + halo_row(p0 + 8) * 16 + t4 * 4) = v1;
}

// ldmatrix without the "memory" clobber of hopper.cuh's, so that the
// compiler may interleave one tile's grid reads with another's products and
// stores (a layer reads one grid and stores into the other). The address
// comes from a base laundered after each barrier (`launder`), which keeps
// every read after the barrier that publishes its grid.
__device__ __forceinline__ void small_ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void small_ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}
__device__ __forceinline__ uint32_t launder(uint32_t v) {
  asm volatile("" : "+r"(v)::"memory");
  return v;
}

// acc = the 3x3 over the grid for the tile whose ldmatrix row of this lane
// is at `row` (grid address of position min(p_base + lane % 16, 360)); `off`
// the byte shifts of taps (2k + lane / 16) for k < 4 and of tap 8; w9 the
// lane's nine B words, tap by tap.
__device__ __forceinline__ void small_conv3x3(float (&acc)[4], uint32_t row, const int (&off)[5],
                                              const uint32_t (&w9)[9]) {
  zero_acc(acc);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t a[4];
    small_ldsm_x4(a, row + off[k]);
    mma_16816(acc, a, w9[2 * k], w9[2 * k + 1]);
  }
  uint32_t a0, a1;
  small_ldsm_x2(a0, a1, row + off[4]);
  mma_1688(acc, a0, a1, w9[8]);
}

// x += act(bf16(acc), a, b) . We (rows g, g + 8): the expand's two n-tiles
// put channels 4t, 4t + 1 (we0) and 4t + 2, 4t + 3 (we1) in this lane.
__device__ __forceinline__ void small_expand(uint32_t (&x)[4], const float (&acc)[4], float2 a,
                                             float2 b, uint32_t we0, uint32_t we1) {
  const uint32_t a0 = act2_small(pack2(acc[0], acc[1]), a.x, b.x, a.y, b.y);
  const uint32_t a1 = act2_small(pack2(acc[2], acc[3]), a.x, b.x, a.y, b.y);
  float y0[4], y1[4];
  zero_acc(y0);
  zero_acc(y1);
  mma_1688(y0, a0, a1, we0);
  mma_1688(y1, a0, a1, we1);
  x[0] = pack2(__fadd_rn(bf16_lo(x[0]), y0[0]), __fadd_rn(bf16_hi(x[0]), y0[1]));
  x[1] = pack2(__fadd_rn(bf16_lo(x[1]), y0[2]), __fadd_rn(bf16_hi(x[1]), y0[3]));
  x[2] = pack2(__fadd_rn(bf16_lo(x[2]), y1[0]), __fadd_rn(bf16_hi(x[2]), y1[1]));
  x[3] = pack2(__fadd_rn(bf16_lo(x[3]), y1[2]), __fadd_rn(bf16_hi(x[3]), y1[3]));
}

// x, out: bf16 [num_boards, 361, 16]; aff: f32 [n_blocks, 2 + inner, 2,
// 16] (layers over the bottleneck use entries 0 .. 7); w: the B fragment
// words, u32 [n_blocks, 4 + 9 inner, 32 lanes] (`pack_segment`).
template <int C, int CB>
__global__ void __launch_bounds__(kSmallThreads, kSmallMinBlocks)
trunk_segment_small_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                           const float* __restrict__ aff, const uint32_t* __restrict__ w,
                           int num_boards, int n_blocks, int inner) {
  using S = SmallShape<C, CB>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const uint32_t xs = smem_u32(smem);
  // Grid c of the two (c = 0, 1).
  const auto grid = [&](int c) { return smem + S::kGridOff + c * S::kGridBytes; };
  const uint32_t bar = smem_u32(smem + S::kBarOff);
  const int layers = 2 + inner;
  const int words = 4 + 9 * inner;  // B words a lane and block

  for (int i = threadIdx.x; i < 2 * S::kGridBytes / 16; i += kSmallThreads) {
    reinterpret_cast<uint4*>(smem + S::kGridOff)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const auto load_board = [&](int board) {
    mbar_expect_tx(bar, S::kXBytes);
    bulk_load(xs, x + static_cast<size_t>(board) * kPos * C, S::kXBytes, bar);
  };
  if (threadIdx.x == 0) load_board(blockIdx.x);

  // This lane's rows of its tile i (M tile warp + kSmallWarps * i): p0(i)
  // and p0(i) + 8, and its ldmatrix row's grid offset (pad rows read
  // position 360), recomputed where used rather than held in registers.
  const auto p0 = [&](int i) { return 16 * (warp + kSmallWarps * i) + (lane >> 2); };
  const auto lrow = [&](int i) {
    const int p = 16 * (warp + kSmallWarps * i) + (lane & 15);
    return static_cast<uint32_t>(halo_row(p < kPos ? p : kPos - 1) * 16);
  };
  int off[5];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int o = 2 * k + (lane >> 4);
    off[k] = ((o / 3 - 1) * kHaloW + (o % 3 - 1)) * 16;
  }
  off[4] = (kHaloW + 1) * 16;  // tap 8: (+1, +1)
  const auto live = [&](int i) { return warp + kSmallWarps * i < kSmallLive; };
  const auto aff4 = [&](int blk, int l, int ab) {
    return __ldg(reinterpret_cast<const float4*>(aff + ((blk * layers + l) * 2 + ab) * C +
                                                 4 * t4));
  };
  const auto aff2 = [&](int blk, int l, int ab) {
    return __ldg(reinterpret_cast<const float2*>(aff + ((blk * layers + l) * 2 + ab) * C +
                                                 2 * t4));
  };
  const auto word = [&](int blk, int k) {
    return __ldg(w + (static_cast<size_t>(blk) * words + k) * 32 + lane);
  };

#ifdef P3_SEGMENT_PROFILE
  // Warp 0's clocks (probe_trunk.py): [0] the board's x wait and read and
  // block 0's reduce, [1] the layer barriers, [2] 3x3 layers before a
  // block's last, [3] the last 3x3 + expand + next reduce, [4] board-blocks,
  // [5] the output stores.
  long long phase_cycles[6] = {0, 0, 0, 0, 0, 0};
  long long phase_t = clock64();
#endif
  int cur = 0;  // the grid the next layer reads
  uint32_t phase = 0;
  for (int board = blockIdx.x; board < num_boards; board += gridDim.x, phase ^= 1u) {
    mbar_wait(bar, phase);
    uint32_t xr[kSmallTPW][4];
#pragma unroll
    for (int i = 0; i < kSmallTPW; ++i) {
      uint2 v0 = make_uint2(0u, 0u), v1 = make_uint2(0u, 0u);
      if (p0(i) < kPos) v0 = *reinterpret_cast<const uint2*>(smem + p0(i) * 32 + t4 * 8);
      if (p0(i) + 8 < kPos) v1 = *reinterpret_cast<const uint2*>(smem + (p0(i) + 8) * 32 + t4 * 8);
      xr[i][0] = v0.x;
      xr[i][1] = v1.x;
      xr[i][2] = v0.y;
      xr[i][3] = v1.y;
    }
    __syncthreads();  // every warp has x: the next board may land
    if (threadIdx.x == 0 && board + static_cast<int>(gridDim.x) < num_boards) {
      load_board(board + gridDim.x);
    }

    if (inner == 0) {
      // No 3x3: each tile runs every block from registers.
      for (int blk = 0; blk < n_blocks; ++blk) {
        const float4 ra = aff4(blk, 0, 0), rb = aff4(blk, 0, 1);
        const float2 ea = aff2(blk, 1, 0), eb = aff2(blk, 1, 1);
        const uint32_t w0 = word(blk, 0), w1 = word(blk, 1);
        const uint32_t we0 = word(blk, 2), we1 = word(blk, 3);
#pragma unroll
        for (int i = 0; i < kSmallTPW; ++i) {
          if (!live(i)) continue;
          float acc[4];
          small_reduce(acc, xr[i], ra, rb, w0, w1);
          small_expand(xr[i], acc, ea, eb, we0, we1);
        }
      }
    } else {
      // Block 0's reduce from x: act(h, layer 1) into grid `cur`.
      {
        const float4 ra = aff4(0, 0, 0), rb = aff4(0, 0, 1);
        const float2 na = aff2(0, 1, 0), nb = aff2(0, 1, 1);
        const uint32_t w0 = word(0, 0), w1 = word(0, 1);
#pragma unroll
        for (int i = 0; i < kSmallTPW; ++i) {
          if (!live(i)) continue;
          float acc[4];
          small_reduce(acc, xr[i], ra, rb, w0, w1);
          small_store(grid(cur), p0(i), acc, na, nb, t4);
        }
      }
      P3_PHASE(0);
      for (int blk = 0; blk < n_blocks; ++blk) {
        for (int j = 0; j < inner; ++j) {
          __syncthreads();  // grid `cur` is written
          P3_PHASE(1);
          const uint32_t src = launder(smem_u32(grid(cur)));
          unsigned char* dst = grid(cur ^ 1);
          uint32_t w9[9];
#pragma unroll
          for (int o = 0; o < 9; ++o) w9[o] = word(blk, 2 + 9 * j + o);
          if (j + 1 < inner) {
            // act(h, layer 2 + j) into the other grid.
            const float2 na = aff2(blk, 2 + j, 0), nb = aff2(blk, 2 + j, 1);
#pragma unroll
            for (int i = 0; i < kSmallTPW; ++i) {
              if (!live(i)) continue;
              float acc[4];
              small_conv3x3(acc, src + lrow(i), off, w9);
              small_store(dst, p0(i), acc, na, nb, t4);
            }
            P3_PHASE(2);
          } else {
            // The last 3x3, the expand + residual and, if a block follows,
            // its reduce and act(h, its layer 1) into the other grid, tile
            // by tile.
            const float2 ea = aff2(blk, layers - 1, 0), eb = aff2(blk, layers - 1, 1);
            const uint32_t we0 = word(blk, words - 2), we1 = word(blk, words - 1);
            const bool has_next = blk + 1 < n_blocks;
            const int nx = has_next ? blk + 1 : blk;
            const float4 ra = aff4(nx, 0, 0), rb = aff4(nx, 0, 1);
            const float2 na = aff2(nx, 1, 0), nb = aff2(nx, 1, 1);
            const uint32_t w0 = word(nx, 0), w1 = word(nx, 1);
#pragma unroll
            for (int i = 0; i < kSmallTPW; ++i) {
              if (!live(i)) continue;
              float acc[4];
              small_conv3x3(acc, src + lrow(i), off, w9);
              small_expand(xr[i], acc, ea, eb, we0, we1);
              if (has_next) {
                small_reduce(acc, xr[i], ra, rb, w0, w1);
                small_store(dst, p0(i), acc, na, nb, t4);
              }
            }
            P3_PHASE(3);
          }
          cur ^= 1;
        }
#ifdef P3_SEGMENT_PROFILE
        ++phase_cycles[4];
#endif
      }
    }

    bf16* xo = out + static_cast<size_t>(board) * kPos * C;
#pragma unroll
    for (int i = 0; i < kSmallTPW; ++i) {
      if (p0(i) < kPos) {
        *reinterpret_cast<uint2*>(xo + p0(i) * C + 4 * t4) = make_uint2(xr[i][0], xr[i][2]);
      }
      if (p0(i) + 8 < kPos) {
        *reinterpret_cast<uint2*>(xo + (p0(i) + 8) * C + 4 * t4) = make_uint2(xr[i][1], xr[i][3]);
      }
    }
    P3_PHASE(5);
  }
#ifdef P3_SEGMENT_PROFILE
  if (threadIdx.x == 0) {
    for (int k = 0; k < 6; ++k) {
      atomicAdd(&g_phase_cycles[k], static_cast<unsigned long long>(phase_cycles[k]));
    }
  }
#endif
}

template <int C, int CB>
int launch_segment_small(const void* x, void* out, const void* aff, const void* w,
                         int num_boards, int n_blocks, int inner, cudaStream_t stream) {
  using S = SmallShape<C, CB>;
  if (num_boards < 1 || n_blocks < 1 || inner < 0 || inner > kMaxInner) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = trunk_segment_small_kernel<C, CB>;
  static int resident = 0;
  if (resident == 0) {
    const cudaError_t err = resident_blocks(kernel, kSmallThreads, S::kSmem, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = num_boards < resident ? num_boards : resident;
  kernel<<<grid, kSmallThreads, S::kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<const float*>(aff),
      static_cast<const uint32_t*>(w), num_boards, n_blocks, inner);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int p3_trunk_segment(const void* x, void* out, const void* aff,
                                const void* chunks, int num_boards, int n_blocks,
                                int inner, int channels, int bottleneck,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 16 && bottleneck == 8) {
    return launch_segment_small<16, 8>(x, out, aff, chunks, num_boards, n_blocks, inner, s);
  }
  if (channels == 64 && bottleneck == 32) {
    return launch_segment<64, 32>(x, out, aff, chunks, num_boards, n_blocks, inner, s);
  }
  if (channels == 128 && bottleneck == 64) {
    return launch_segment<128, 64>(x, out, aff, chunks, num_boards, n_blocks, inner, s);
  }
  if (channels == 256 && bottleneck == 128) {
    return launch_segment_cluster<256, 128>(x, out, aff, chunks, num_boards, n_blocks, inner,
                                            s);
  }
  if (channels == 384 && bottleneck == 192) {
    return launch_segment_cluster<384, 192>(x, out, aff, chunks, num_boards, n_blocks, inner,
                                            s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks of the persistent grid at (channels, bottleneck) on this card
// (resident blocks, or resident clusters times the cluster's blocks), or
// minus the cudaError.
extern "C" int p3_trunk_segment_grid(int channels, int bottleneck) {
  int n = 0, per = 1;
  cudaError_t err = cudaErrorInvalidValue;
  if (channels == 16 && bottleneck == 8) {
    err = resident_blocks(trunk_segment_small_kernel<16, 8>, kSmallThreads,
                          SmallShape<16, 8>::kSmem, &n);
  } else if (channels == 64 && bottleneck == 32) {
    err = resident_blocks(trunk_segment_kernel<64, 32>, kThreads, Shape<64, 32>::kSmem, &n);
  } else if (channels == 128 && bottleneck == 64) {
    err = resident_blocks(trunk_segment_kernel<128, 64>, kThreads, Shape<128, 64>::kSmem, &n);
  } else if (channels == 256 && bottleneck == 128) {
    using S = WideShape<256, 128>;
    per = S::kCluster;
    err = resident_clusters(trunk_segment_cluster_kernel<256, 128>, S::kThreads, S::kSmem, per,
                            &n);
  } else if (channels == 384 && bottleneck == 192) {
    using S = WideShape<384, 192>;
    per = S::kCluster;
    err = resident_clusters(trunk_segment_cluster_kernel<384, 192>, S::kThreads, S::kSmem, per,
                            &n);
  }
  return err == cudaSuccess ? n * per : -static_cast<int>(err);
}

// The cluster kernel's row ranges, as it computes them, for the card tests:
// the window of block `rank` (`window_first`, `window_board_rows`, in grid
// rows) and the grid rows block `src` pushes into block `dst`'s window
// after a layer (`push_first`, `push_rows`), when each block owns
// `tiles_per_block` M tiles.
extern "C" void p3_trunk_segment_cluster_rows(int rank, int src, int dst, int tiles_per_block,
                                              int* out) {
  out[0] = window_first(rank, tiles_per_block) * kHaloW;
  out[1] = window_board_rows(rank, tiles_per_block) * kHaloW;
  out[2] = push_first(src, dst, tiles_per_block);
  out[3] = push_rows(src, dst, tiles_per_block);
}

#ifdef P3_SEGMENT_PROFILE
// The phase clocks of the launches since the last reset (see P3_PHASE):
// copies the 6 counters to `out` (host memory), or zeroes them when `reset`.
extern "C" int p3_trunk_segment_phase_cycles(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
    return static_cast<int>(cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles)));
}
#endif
