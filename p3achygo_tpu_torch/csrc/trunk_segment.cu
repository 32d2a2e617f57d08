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
//    board's first weight copies overlap the current board's last layer. A
//    board never crosses blocks. Leaf batches smaller than the card
//    (N < 132) leave SMs idle; splitting a board over a cluster is later work.
//  - No atomics: two calls on the same input give identical bits.
//
// Shared memory for (C, CB) = (128, 64): 10 weight stages x 8 KB, two haloed
// buffers 2 x 441 x 72 x 2 B, two affine slots of 5 x 2 x 128 f32, the
// mbarriers: 219,360 B, one 512-thread block per SM.
//
// Widths: (C, CB) in {(64, 32), (128, 64)}, inner in [0, 3]; others return
// cudaErrorInvalidValue (the Python wrapper refuses them first).
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
// board-blocks it ran. p3_trunk_segment_phase_cycles reads (or zeroes) them.
__device__ unsigned long long g_phase_cycles[5];
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

}  // namespace

extern "C" int p3_trunk_segment(const void* x, void* out, const void* aff,
                                const void* chunks, int num_boards, int n_blocks,
                                int inner, int channels, int bottleneck,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 64 && bottleneck == 32) {
    return launch_segment<64, 32>(x, out, aff, chunks, num_boards, n_blocks, inner, s);
  }
  if (channels == 128 && bottleneck == 64) {
    return launch_segment<128, 64>(x, out, aff, chunks, num_boards, n_blocks, inner, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef P3_SEGMENT_PROFILE
// The phase clocks of the launches since the last reset (see P3_PHASE):
// copies the 5 counters to `out` (host memory), or zeroes them when `reset`.
extern "C" int p3_trunk_segment_phase_cycles(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[5] = {0, 0, 0, 0, 0};
    return static_cast<int>(cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles)));
}
#endif
