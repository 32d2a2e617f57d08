// Fused broadcast-block kernel for a batch of 19x19 boards, bf16
// activations, for Hopper (sm_90a): wgmma for all three products, the
// position mix streamed by bulk-async copies on mbarriers, epilogues on
// registers, persistent blocks.
//
// Replaces the broadcast branch of the Pallas TPU kernel
// p3achygo_tpu/nn/trunk_kernel.py `_make_kernel` (trunk_kernel.py:190-206;
// its position mix rounds z to bf16 before the affine). The bottleneck runs
// are trunk_segment.cu. Per broadcast block (every product bf16 x bf16 with
// f32 accumulation; act(v, a, b) = bf16(mish(f32(v) * a + b)) with the
// two-branch mish of trunk_kernel.py:55-60, trunk_common.cuh):
//   h = act(x, f) . Wf                       (f32, not rounded)
//   m = bf16(mish(h))
//   z[q] = bf16(sum_p WdT[q, p] m[p] + bd[q])
//   x = bf16(f32(x) + act(z, l) . Wl)
// Its plain version is ops/trunk.py `trunk_broadcast_reference`, which
// rounds at exactly these points; only the f32 summation order and the
// mish's division (trunk_common.cuh) differ.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): 57.0 MFLOP per
// board at C = 128 (the 361 x 361 mix and two C x C 1x1s), 164 GFLOP at
// N = 2880 boards, 0.166 ms on the tensor cores; the 532 MB of x in and
// out take 0.159 ms. The elementwise chain is the third floor: act(x, f),
// mish(h) and act(z, l) are 3 x 361 x C mish a board, 4.0e8 at N = 2880,
// ~30 instructions each with the packing (expf, one approximate division),
// ~0.34 ms of the SMs' issue slots at one instruction a cycle, twice the
// tensor bound. So the design keeps every operand of the tensor cores in
// shared memory or registers, keeps the elementwise chain on registers, and
// keeps the code small enough for the instruction cache:
//
//  - All three products on wgmma (f32 accumulators). conv_first: A from
//    registers, x loaded with 16-byte loads and act(x, f) applied there;
//    its K (input channels) in `reduce_k_order`, so a lane's 8 contiguous
//    channels are its A fragments (the segment kernel's block-0 reduce);
//    N in two halves of C/2. The mix: A (WdT) and B (m) both by
//    descriptor, M = 6 tiles of 64 destination positions q, K = 384 source
//    positions, N = C. conv_last: A from registers, B (Wl) by descriptor.
//  - No consumer thread loads a weight from device memory. The host packs
//    the block once (ops/trunk.py `pack_broadcast`): Wf and Wl as C x C
//    B operands in the no-swizzle core-matrix layout, and WdT (zero-padded
//    to 384 x 384) as a stream of 64 q x 32 p chunks (4 KB) in the
//    layout of the mix's A descriptor, tile by tile. One producer lane
//    copies Wf and Wl into shared memory once per persistent block with
//    `cp.async.bulk`; three more, one per consumer warpgroup, stream that
//    group's WdT chunks through its own ring of stages, board after board,
//    completion on one mbarrier per stage, release on a second once the
//    group's wgmma have read it. The producer warpgroup hands registers to
//    the consumers (setmaxnreg 32 / 160, as in the segment kernel), though
//    ptxas keeps the consumer code within the launch bound's 128.
//  - m = bf16(mish(h)) lives in shared memory as the mix's B operand,
//    K-major (B^T [channel][position], positions 361..383 zero): the
//    conv_first accumulators, after mish, are stored transposed by
//    `stmatrix .trans`, 128 contiguous bytes a matrix. m is single-buffered:
//    one consumer barrier a board after conv_first, and a board's m waits
//    (mbarrier, arrive early / wait late) until every warp's mix of the
//    board before has read it, so the next board's x loads and first
//    products run before that wait.
//  - Epilogues on registers. The mix's m64nC accumulators of columns
//    16s .. 16s + 15 are, lane for lane, the A fragment of conv_last's
//    k-step s: bd[q] is added, z rounded, act(z, l) applied and packed in
//    registers, and z never touches shared memory. conv_last's N columns
//    are in `reduce_k_order`, so a lane's accumulators are 8 contiguous
//    channels: the residual is read with 16-byte loads, added in f32 and
//    stored with 16-byte stores. Three consumer warpgroups take two q
//    tiles each (g, g + 3); 12 consumer warps keep the SMs' issue slots
//    busy through the elementwise chain.
//  - Persistent blocks: min(N, resident blocks) blocks walk over boards
//    (grid stride) and the producers run ahead into the next board's WdT
//    chunks. A board never crosses blocks; leaf batches smaller than the
//    card (N < 132) leave SMs idle.
//  - No atomics: two calls on the same input give identical bits.
//
// Shared memory at C = 128: m 384 x 128 x 2 B = 98,304, Wf + Wl 65,536,
// three rings of 5 WdT stages x 4 KB = 61,440, the affines and bd 3,584,
// the mbarriers: 229,120 B, one 512-thread block per SM. At C = 64 the
// rings hold 8 stages each.
//
// At C = 256 m alone is 196,608 B and Wf + Wl 262,144 B (at 384: 294,912
// and 589,824), past a block's 232,448: a broadcast block of C = 256 or 384
// runs as three kernels, conv_first, the mix and conv_last (their own
// comment, below).
//
// `tiny`'s C = 16 has a kernel of its own, `trunk_broadcast_small_kernel`
// (8 boards a mix; its comment, below).
//
// Widths: C in {16, 64, 128, 256, 384}; others return cudaErrorInvalidValue
// (the Python wrapper refuses them first).
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
constexpr int kMixPad = kTiles * kTileRows;
constexpr int kPCores = kMixPad / 8;  // core matrices of m along K
constexpr int kGroups = 3;  // consumer warpgroups
constexpr int kTilesPerGroup = kTiles / kGroups;
constexpr int kConsumerWarps = 4 * kGroups;
constexpr int kConsumerThreads = 32 * kConsumerWarps;
// + one producer warpgroup: lanes 0 of its warps 0..2 stream the WdT rings,
// lane 0 of warp 3 the 1x1 weights. setmaxnreg moves registers from it to
// the consumers: 128 x 32 + 384 x 160 = 65,536.
constexpr int kThreads = kConsumerThreads + 128;
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;
// A WdT chunk: 64 q rows x 32 p columns, two k16 steps.
constexpr int kChunkCols = 32;
constexpr int kChunksPerTile = kMixPad / kChunkCols;
constexpr int kChunkElems = kTileRows * kChunkCols;
constexpr int kChunkBytes = kChunkElems * 2;

template <int C>
struct BroadcastShape {
  static constexpr int kStages = C == 128 ? 5 : 8;  // per consumer warpgroup
  static constexpr int kWBytes = C * C * 2;  // Wf or Wl
  static constexpr int kMBytes = C * kMixPad * 2;
  static constexpr int kKSteps = C / 16;
  static constexpr int kAcc = C / 2;  // f32 accumulators a thread, m64nC
  static constexpr int kWfOff = kMBytes;
  static constexpr int kWlOff = kWfOff + kWBytes;
  static constexpr int kRingOff = kWlOff + kWBytes;
  static constexpr int kAffOff = kRingOff + kGroups * kStages * kChunkBytes;
  static constexpr int kBdOff = kAffOff + 4 * C * 4;
  static constexpr int kBarOff = kBdOff + kMixPad * 4;
  static constexpr int kSmem = kBarOff + (2 * kGroups * kStages + 2) * 8;
  static_assert(kSmem <= 232448, "shared memory");
};

#ifdef P3_BROADCAST_PROFILE
// Built with -DP3_BROADCAST_PROFILE (probe_trunk.py), the kernel sums the
// clock cycles of consumer thread 0 (warpgroup 0, warp 0) by phase over a
// launch: [0] conv_first (products, mish, m stores), [1] the wait for the
// previous board's mix to free m, [2] the consumer barrier after
// conv_first, [3] the mix's products (ring waits included), [4] the mix's
// epilogue, conv_last and the residual store; [5] the boards it ran.
// p3_trunk_broadcast_phase_cycles reads (or zeroes) them.
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

// Descriptor of k-step `ks` of Wf or Wl: B^T [C n][C k] in 8x8 core
// matrices, core (n/8, k/8) at ((n/8) * (C/8) + k/8) * 128 bytes.
template <int C>
__device__ __forceinline__ uint64_t w_desc(uint32_t w, int ks) {
  return smem_desc(w + ks * 256, 128, C / 8 * 128);
}

// The mix's A, k-step `ks` of a WdT chunk: A [64 q][32 p], core (q/8, p/8)
// at ((q/8) * 4 + p/8) * 128 bytes.
__device__ __forceinline__ uint64_t wdt_desc(uint32_t chunk, int ks) {
  return smem_desc(chunk + ks * 256, 128, kChunkCols / 8 * 128);
}

// The mix's B, global k-step `s` (positions 16s .. 16s + 15) of m: B^T
// [C channels][384 positions], core (c/8, p/8) at ((c/8) * 48 + p/8) * 128
// bytes.
__device__ __forceinline__ uint64_t m_desc(uint32_t m, int s) {
  return smem_desc(m + s * 256, 128, kPCores * 128);
}

// ---- the kernel ---------------------------------------------------------

// x, out: bf16 [num_boards, 361, C]; f_aff, l_aff: f32 [2, C]; packed: bf16
// [2 C^2 + 384^2], `pack_broadcast` (Wf, Wl, then the WdT chunk stream of
// tile t, chunk c at (t * 12 + c) * 2048); bd: f32 [361].
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
trunk_broadcast_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                       const float* __restrict__ f_aff, const bf16* __restrict__ packed,
                       const float* __restrict__ bd, const float* __restrict__ l_aff,
                       int num_boards) {
  using S = BroadcastShape<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* aff_s = reinterpret_cast<float*>(smem + S::kAffOff);  // f a, f b, l a, l b
  float* bd_s = reinterpret_cast<float*>(smem + S::kBdOff);  // [384], 0 past 361
  const uint32_t m_s = smem_u32(smem);
  const uint32_t wf_s = smem_u32(smem + S::kWfOff);
  const uint32_t wl_s = smem_u32(smem + S::kWlOff);
  const uint32_t ring0 = smem_u32(smem + S::kRingOff);
  const uint32_t bar0 = smem_u32(smem + S::kBarOff);
  // Ring g's item i (the group's i-th WdT chunk) sits in its stage
  // i % kStages, in the phase of parity (i / kStages) & 1 of full(g, i) and
  // empty(g, i).
  const auto slot = [](int g, uint32_t i) { return g * S::kStages + i % S::kStages; };
  const auto full = [&](int g, uint32_t i) { return bar0 + 8u * slot(g, i); };
  const auto empty = [&](int g, uint32_t i) {
    return bar0 + 8u * (kGroups * S::kStages + slot(g, i));
  };
  const auto stage = [&](int g, uint32_t i) { return ring0 + slot(g, i) * kChunkBytes; };
  const auto parity = [](uint32_t i) { return (i / S::kStages) & 1u; };
  const uint32_t w_full = bar0 + 8u * (2 * kGroups * S::kStages);  // Wf and Wl landed
  const uint32_t m_free = w_full + 8u;  // phase k: every warp's mix of board k done

  for (int i = threadIdx.x; i < 2 * C; i += kThreads) {
    aff_s[i] = f_aff[i];
    aff_s[2 * C + i] = l_aff[i];
  }
  for (int i = threadIdx.x; i < kMixPad; i += kThreads) bd_s[i] = i < kPos ? bd[i] : 0.0f;
  if (threadIdx.x == 0) {
    for (int g = 0; g < kGroups; ++g) {
      for (int s = 0; s < S::kStages; ++s) {
        mbar_init(full(g, s), 1);
        mbar_init(empty(g, s), 4);
      }
    }
    mbar_init(w_full, 1);
    mbar_init(m_free, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // Producers: warp pw < 3 streams consumer group pw's WdT chunks (per
    // board its tiles pw and pw + 3, 12 chunks each, in the order the group
    // takes them) as far ahead as its ring allows; warp 3 copies Wf and Wl.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int pw = warp - kConsumerWarps;
    if (lane == 0 && pw == kGroups) {
      mbar_expect_tx(w_full, 2 * S::kWBytes);
      bulk_load(wf_s, packed, S::kWBytes, w_full);
      bulk_load(wl_s, packed + C * C, S::kWBytes, w_full);
    } else if (lane == 0) {
      const bf16* stream = packed + 2 * C * C;
      uint32_t ci = 0;
      for (int board = blockIdx.x; board < num_boards; board += gridDim.x) {
        for (int r = 0; r < kTilesPerGroup; ++r) {
          const int t = pw + kGroups * r;
          for (int c = 0; c < kChunksPerTile; ++c, ++ci) {
            mbar_wait(empty(pw, ci), parity(ci) ^ 1u);
            mbar_expect_tx(full(pw, ci), kChunkBytes);
            bulk_load(stage(pw, ci),
                      stream + static_cast<size_t>(t * kChunksPerTile + c) * kChunkElems,
                      kChunkBytes, full(pw, ci));
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
    const float* f_a = aff_s;
    const float* l_a = aff_s + 2 * C;
    uint32_t ci = 0;  // WdT chunks taken so far
    mbar_wait(w_full, 0);
#ifdef P3_BROADCAST_PROFILE
    long long phase_cycles[6] = {0, 0, 0, 0, 0, 0};
    long long phase_t = clock64();
#endif

    int i = 0;  // boards this block has run
    for (int board = blockIdx.x; board < num_boards; board += gridDim.x, ++i) {
      const size_t boff = static_cast<size_t>(board) * kPos * C;
      const bf16* xb = x + boff;

      // conv_first: m = bf16(mish(act(x, f) . Wf)) into m, tile by tile,
      // in two halves of C/2 output channels, so that a half's mish has
      // registers to interleave. The tile loops are not unrolled: fully
      // unrolled, the C = 128 kernel is ~11.5k instructions, more than the
      // instruction cache holds, and ran at half this speed.
#pragma unroll 1
      for (int r = 0; r < kTilesPerGroup; ++r) {
        const int base = (g + kGroups * r) * kTileRows + wq * 16;
        const int p0 = base + (lane >> 2);  // this lane's accumulator rows p0, p0 + 8
        uint32_t a[S::kKSteps][4];
        load_x<C, C>(a, xb, p0, 0, t4);
        act_x<C, C>(a, p0, 0, f_a, t4);
        // stmatrix: matrix mi = lane / 8 holds rows (positions) 8 (mi % 2) ..
        // of the warp's 16 and channels 8 (mi / 2) .. of a 16-channel block;
        // the lane gives the address of channel row lane % 8 of it.
        const int mi = lane >> 3;
        const uint32_t st = m_s + ((mi >> 1) * kPCores + base / 8 + (mi & 1)) * 128 + (lane & 7) * 16;
#pragma unroll
        for (int hn = 0; hn < 2; ++hn) {  // output channels hn C/2 .. hn C/2 + C/2 - 1
          float acc[S::kAcc / 2];
          zero_acc(acc);
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < S::kKSteps; ++ks) {
            wgmma_bf16(acc, a[ks], w_desc<C>(wf_s + hn * (C / 16) * (C / 8 * 128), ks));
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(acc);
          if (hn == 1) fence_regs(a);
          if (hn == 0 && r == 0 && i > 0) {
            P3_PHASE(0);
            mbar_wait(m_free, (i - 1) & 1);  // the previous board's mix has read m
            P3_PHASE(1);
          }
#pragma unroll
          for (int jp = 0; jp < C / 32; ++jp) {
            uint32_t v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              v[k] = pack2(mish_f32(acc[8 * jp + 2 * k]), mish_f32(acc[8 * jp + 2 * k + 1]));
            }
            stmatrix_x4_trans(st + (hn * (C / 32) + jp) * 2 * kPCores * 128, v);
          }
        }
      }
      fence_proxy_async();  // m's stores before the mix's wgmma reads
      P3_PHASE(0);
      consumer_sync<kConsumerThreads>();
      P3_PHASE(2);

      // Per tile: z = bf16(WdT . m + bd) (the mix, 12 chunks from the
      // ring), then x + act(z, l) . Wl from registers.
#pragma unroll 1
      for (int r = 0; r < kTilesPerGroup; ++r) {
        const int p0 = (g + kGroups * r) * kTileRows + wq * 16 + (lane >> 2);
        float acc[S::kAcc];
        zero_acc(acc);
        fence_regs(acc);
        for (int c = 0; c < kChunksPerTile; ++c) {
          mbar_wait(full(g, ci + c), parity(ci + c));
          const uint32_t chunk = stage(g, ci + c);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            wgmma_bf16_ss(acc, wdt_desc(chunk, ks), m_desc(m_s, 2 * c + ks));
          }
          wgmma_commit();
          if (c > 0) {
            wgmma_wait<1>();  // chunk c - 1 is read
            if (lane == 0) mbar_arrive(empty(g, ci + c - 1));
          }
        }
        wgmma_wait_all();
        fence_regs(acc);
        if (lane == 0) {
          mbar_arrive(empty(g, ci + kChunksPerTile - 1));
          if (r + 1 == kTilesPerGroup) mbar_arrive(m_free);
        }
        ci += kChunksPerTile;
        P3_PHASE(3);

        // act(bf16(acc + bd), l) as conv_last's A fragments: accumulator
        // columns 16 ks .. 16 ks + 15 (pairs j = 2 ks, 2 ks + 1; rows h) are
        // registers (2 (j % 2) + h) of k-step ks.
        uint32_t al[S::kKSteps][4];
        const float bd0 = bd_s[p0];
        const float bd1 = bd_s[p0 + 8];
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const int c = 8 * j + 2 * t4;
          const float2 la = *reinterpret_cast<const float2*>(l_a + c);
          const float2 lb = *reinterpret_cast<const float2*>(l_a + C + c);
          al[j / 2][2 * (j % 2)] =
              pack2(act_f32(round_bf16(__fadd_rn(acc[4 * j], bd0)), la.x, lb.x),
                    act_f32(round_bf16(__fadd_rn(acc[4 * j + 1], bd0)), la.y, lb.y));
          al[j / 2][2 * (j % 2) + 1] =
              pack2(act_f32(round_bf16(__fadd_rn(acc[4 * j + 2], bd1)), la.x, lb.x),
                    act_f32(round_bf16(__fadd_rn(acc[4 * j + 3], bd1)), la.y, lb.y));
        }
        float acc2[S::kAcc];
        zero_acc(acc2);
        fence_regs(acc2);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < S::kKSteps; ++ks) wgmma_bf16(acc2, al[ks], w_desc<C>(wl_s, ks));
        wgmma_commit();
        uint4 res[2][C / 32];
        load_residual<C, C>(res, xb, p0, 0, t4);
        wgmma_wait_all();
        fence_regs(acc2);
        fence_regs(al);
        store_residual<C, C>(acc2, res, out + boff, p0, 0, t4, nullptr, al);
        P3_PHASE(4);
      }
#ifdef P3_BROADCAST_PROFILE
      ++phase_cycles[5];
#endif
    }
#ifdef P3_BROADCAST_PROFILE
    if (threadIdx.x == 0) {
      for (int k = 0; k < 6; ++k) {
        atomicAdd(&g_phase_cycles[k], static_cast<unsigned long long>(phase_cycles[k]));
      }
    }
#endif
  }
}

template <int C>
int launch_broadcast(const void* x, void* out, const void* f_aff, const void* packed,
                     const void* bd, const void* l_aff, int num_boards,
                     cudaStream_t stream) {
  using S = BroadcastShape<C>;
  if (num_boards < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = trunk_broadcast_kernel<C>;
  // Resident blocks on this card, once per process (one card per process).
  static int resident = 0;
  if (resident == 0) {
    const cudaError_t err = resident_blocks(kernel, kThreads, S::kSmem, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = num_boards < resident ? num_boards : resident;
  kernel<<<grid, kThreads, S::kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out),
      static_cast<const float*>(f_aff), static_cast<const bf16*>(packed),
      static_cast<const float*>(bd), static_cast<const float*>(l_aff), num_boards);
  return static_cast<int>(cudaGetLastError());
}



// ---- C = 256, 384: three kernels a broadcast block -----------------------
//
// At these widths a board's m (196,608 / 294,912 B) and Wf + Wl do not fit
// one block, and splitting a board over a cluster made every product wait
// on its peers. Each of the block's three products is instead a GEMM along
// the dimension it leaves independent, one kernel each, with the
// elementwise chain fused into its prologue or epilogue; every value stored
// between them is one the plain version rounds to bf16:
//
//  (a) conv_first, `trunk_broadcast_first_kernel<C>`: rows (board,
//      position) in units of one board's 64-position tile, K = N = C.
//      A = act(x, f) in registers (16-byte loads, K in `reduce_k_order`,
//      act applied there, positions 361..383 zero); B = Wf, N in
//      `reduce_k_order` too. m = bf16(mish(h)) is stored transposed by
//      `stmatrix .trans` into an 8 KB staging tile (64 channels) and from
//      there to device memory by one bulk copy, in the layout the mix reads
//      as its B operand: per board and 64-position chunk pk, B^T [C
//      channels][64 positions] in 8x8 core matrices, 128 channels (16 KB)
//      contiguous an item (positions 361..383 are mish(0) = 0).
//  (b) the mix, `trunk_broadcast_mix_kernel<C>`: z = WdT . m + bd with
//      M = 384 destination positions q, K = 384 source positions p,
//      N = boards x C. A block keeps three 64-row tiles of WdT resident
//      (144 KB, its three warpgroups' A) and streams m's (board, channel
//      tile) items through a ring; the epilogue rounds z, applies act(z, l)
//      and writes act(z) [N, 361, C] bf16 with 16-byte stores (m's channel
//      order is `reduce_k_order`, so a lane's accumulators are 8
//      contiguous channels). The grid is even: block b takes the q tiles of
//      half b % 2 for every (board, channel tile) b / 2 walks over, so the
//      two blocks that read one item of m run together and the second read
//      hits L2.
//  (c) conv_last, `trunk_broadcast_last_kernel<C>`: as (a), A = act(z) as
//      it is, B = Wl; the epilogue adds the residual x in f32 and stores
//      bf16, in place over act(z) (a unit reads its own rows into
//      registers before it stores them).
//
// Every kernel is warp-specialised: consumer warpgroups (64 rows or one
// 64-row WdT tile each, f32 accumulators) and a producer warpgroup whose
// lane 0 streams the B items by `cp.async.bulk` into a ring, full and empty
// mbarriers per stage, and which hands its registers to the consumers
// (setmaxnreg: a block of 9 warps leaves a thread 168 registers, and A over
// all of K at C = 384 spilled). conv_first runs m64n64k16 passes over Wf
// items of 64 columns x 64 K, conv_last m64n128k16 over Wl items of 128 x
// 64, the mix m64n128k16 over m items of 128 channels x 64 positions; the
// warpgroups a block: conv_first 3 at C = 256, 2 at 384, the mix 3,
// conv_last 2 (each choice the faster on an H100; conv_first loading the
// next unit's x during this one ran slower and was dropped). At
// C = 256 the items of Wf and Wl fit the ring and stay resident; at C = 384
// they stream once per pass of units (L2 hits). Persistent blocks, one a
// SM. No atomics: two calls on the same input give identical bits. One
// wrapper call launches the three kernels; m (N x 384 x C bf16) is scratch
// from the wrapper, act(z) goes through `out`.
//
// What bounds it (the work `chip_smoke.py broadcast_work` counts: x in and
// out, the weights, 2 x 361 C^2 + 361^2 C MACs a board): at N = 2880,
// 0.470 ms (C = 256) and 0.912 ms (C = 384) on the tensor cores. The design
// moves more bytes than that: m out and in, act(z) out and in, x twice,
// about 3.8 / 5.7 GB, 1.1 / 1.7 ms at 3.35 TB/s, and it runs 3 x 361 x C
// mish a board on the SMs' issue slots (~1.2 ms at C = 384), which the
// profile build's clocks show as the largest parts of conv_first and the
// mix (PERF.md).
//
// Shared memory (one block a SM):
//   conv_first: ring 16 x 8,192, staging 2 x 8,192 a warpgroup, f
//     affines 2 C x 4, 32 mbarriers: 182,528 B at C = 256 (3 warpgroups,
//     512 threads), 167,168 B at C = 384 (2, 384 threads).
//   conv_last: ring 8 x 16,384, 16 mbarriers (and the unused affine slot):
//     133,248 / 134,272 B, 384 threads.
//   the mix: three WdT tiles 147,456, ring 5 x 16,384, 11 mbarriers:
//     229,464 B at both widths, 512 threads (bd and the l affines are
//     read through L1).

// A wide kernel's warps: G consumer warpgroups and a producer warpgroup
// (one lane works), which hands its registers to the consumers by
// setmaxnreg: 24 / 240 a thread at G = 2, 24 / 160 at G = 3.
constexpr int kWideProducerRegs = 24;
template <int G>
struct WideWarps {
  static constexpr int kGroups = G;
  static constexpr int kConsumerWarps = 4 * G;
  static constexpr int kThreads = 128 * (G + 1);
  static constexpr int kConsumerRegs =
      (65536 - 128 * kWideProducerRegs) / (128 * G) / 8 * 8 > 240
          ? 240
          : (65536 - 128 * kWideProducerRegs) / (128 * G) / 8 * 8;
};
constexpr int kKItem = 64;  // K rows of every item
constexpr int kMixNTile = 128;
constexpr int kMixItemElems = kMixNTile * kKItem;
constexpr int kMixItemBytes = kMixItemElems * 2;
constexpr int kWdtTileElems = kTileRows * kMixPad;  // a WdT tile: 64 q x 384 p
constexpr int kWdtTileBytes = kWdtTileElems * 2;
constexpr int kMCoreRow = 8 * 64;  // elements of one channel core row of m's chunk

// conv_first / conv_last. Each takes what ran fastest on an H100: conv_first
// 64 output columns a product pass, 3 consumer warpgroups at C = 256 and 2
// at C = 384 (3 spilled); conv_last 128 columns and 2 warpgroups. Wf / Wl
// items of that many columns x 64 K, a ring of 128 KB.
template <int C, bool kFirst>
struct RowsShape : WideWarps<kFirst && C == 256 ? 3 : 2> {
  static constexpr int kNTile = kFirst ? 64 : 128;
  static constexpr int kItemElems = kNTile * kKItem;
  static constexpr int kItemBytes = kItemElems * 2;
  static constexpr int kStages = 128 * 1024 / kItemBytes;
  static constexpr int kNTiles = C / kNTile;
  static constexpr int kKItems = C / kKItem;
  static constexpr int kItems = kNTiles * kKItems;  // one pass over Wf or Wl
  static constexpr bool kResident = kItems <= kStages;
  static constexpr int kStagingOff = kStages * kItemBytes;
  static constexpr int kAffOff =
      kStagingOff + (kFirst ? RowsShape::kGroups * 2 * kItemBytes : 0);
  static constexpr int kBarOff = kAffOff + 2 * C * 4;
  static constexpr int kSmem = kBarOff + 2 * kStages * 8;
  static_assert(kSmem <= 232448, "shared memory");
};

// The mix: 3 consumer warpgroups, a block's 3 q tiles one of 2 parts
// (kParts) of the 6; 128 channels a product pass, m items of 128 channels
// x 64 positions (16 KB), as many stages as fit beside the WdT tiles.
template <int C>
struct MixShape : WideWarps<3> {
  static constexpr int kParts = kTiles / MixShape::kGroups;
  static constexpr int kNTiles = C / kMixNTile;
  static constexpr int kRingOff = MixShape::kGroups * kWdtTileBytes;
  static constexpr int kStages = (232448 - kRingOff - 256) / kMixItemBytes;
  static constexpr int kBarOff = kRingOff + kStages * kMixItemBytes;
  static constexpr int kSmem = kBarOff + (2 * kStages + 1) * 8;
  static_assert(kSmem <= 232448 && kStages >= 4, "shared memory");
};


#ifdef P3_BROADCAST_PROFILE
// The wide kernels' clocks (thread 0 of each block, warpgroup 0): conv_first
// [0] A load and act(x), [1] products (ring waits included), [2] mish and
// the m store, [3] its units; the mix [4] products, [5] act(z) and the
// store, [6] its units; conv_last [7] A load, [8] products, [9] residual
// add and store, [10] its units. p3_trunk_broadcast_wide_cycles reads (or
// zeroes) them.
__device__ unsigned long long g_wide_cycles[11];
#define P3_WIDE(k)                         \
  do {                                     \
    const long long now_ = clock64();      \
    wide_cycles[k] += now_ - wide_t;       \
    wide_t = now_;                         \
  } while (0)
#else
#define P3_WIDE(k) \
  do {             \
  } while (0)
#endif

// k16 step kk of an item: B^T [n][64 k] (64 or 128 rows n), core (n/8,
// k/8) at ((n/8) * 8 + k/8) * 128 bytes.
__device__ __forceinline__ uint64_t item_desc(uint32_t item, int kk) {
  return smem_desc(item + kk * 256, 128, 8 * 128);
}

// k16 step s of a WdT tile: A [64 q][384 p], core (q/8, p/8) at
// ((q/8) * 48 + p/8) * 128 bytes.
__device__ __forceinline__ uint64_t wdt_tile_desc(uint32_t tile, int s) {
  return smem_desc(tile + s * 256, 128, kPCores * 128);
}

// conv_first (kFirst: a = x, act(., f) on the way in, out = m) or conv_last
// (a = act(z) = out, the residual x, out over it). A unit is one board's
// 64-position tile t; block pass P gives warpgroup g unit 2 P + g.
template <int C, bool kFirst>
__device__ __forceinline__ void broadcast_rows(const bf16* a_src, const bf16* x, bf16* dst,
                                               const float* f_aff, const bf16* w,
                                               int num_boards) {
  using S = RowsShape<C, kFirst>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t stage0 = smem_u32(smem);
  const uint32_t staging0 = smem_u32(smem + S::kStagingOff);
  float* aff_s = reinterpret_cast<float*>(smem + S::kAffOff);  // f a [C], f b [C]
  const uint32_t bar0 = smem_u32(smem + S::kBarOff);
  // Item i of the ring sits in stage i % S::kStages, in the phase of parity
  // (i / S::kStages) & 1 of full(i) and empty(i); resident items i < kItems
  // in stage i, phase 0, never released.
  const auto full = [&](uint32_t i) { return bar0 + 8u * (i % S::kStages); };
  const auto empty = [&](uint32_t i) { return bar0 + 8u * (S::kStages + i % S::kStages); };
  const auto stage = [&](uint32_t i) { return stage0 + (i % S::kStages) * S::kItemBytes; };
  const auto parity = [](uint32_t i) { return (i / S::kStages) & 1u; };
  const int units = num_boards * kTiles;
  const int passes = (units + S::kGroups - 1) / S::kGroups;

  if (kFirst) {
    for (int i = threadIdx.x; i < 2 * C; i += S::kThreads) aff_s[i] = f_aff[i];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), S::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= S::kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kWideProducerRegs));
    // Producer: W's items (n tile nt, K chunk kc) in the order nt * kKItems
    // + kc, once if they fit the ring, else once a pass.
    if (warp == S::kConsumerWarps && lane == 0) {
      if constexpr (S::kResident) {
        for (int i = 0; i < S::kItems; ++i) {
          mbar_expect_tx(full(i), S::kItemBytes);
          bulk_load(stage(i), w + static_cast<size_t>(i) * S::kItemElems, S::kItemBytes, full(i));
        }
      } else {
        uint32_t ci = 0;
        for (int P = blockIdx.x; P < passes; P += gridDim.x) {
          for (int i = 0; i < S::kItems; ++i, ++ci) {
            mbar_wait(empty(ci), parity(ci) ^ 1u);
            mbar_expect_tx(full(ci), S::kItemBytes);
            bulk_load(stage(ci), w + static_cast<size_t>(i) * S::kItemElems, S::kItemBytes,
                      full(ci));
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(S::kConsumerRegs));
    const int g = warp >> 2;
    const int wq = warp & 3;
    const int t4 = lane & 3;
    const bool lead = (threadIdx.x & 127) == 0;
    uint32_t ci = 0;  // streamed items taken before this pass
    int sb = 0;       // conv_first's staging buffer
#ifdef P3_BROADCAST_PROFILE
    long long wide_cycles[4] = {0, 0, 0, 0};
    long long wide_t = clock64();
    constexpr int kP = kFirst ? 0 : 7;  // first counter of this kernel
#endif
    for (int P = blockIdx.x; P < passes; P += gridDim.x) {
      const int u = S::kGroups * P + g;
      const bool valid = u < units;
      const int board = valid ? u / kTiles : 0;
      const int t = u % kTiles;
      const int p0 = t * kTileRows + wq * 16 + (lane >> 2);  // rows p0, p0 + 8
      const size_t boff = static_cast<size_t>(board) * kPos * C;
      uint32_t a[C / 16][4];
      if (valid) {
        load_x<C, C>(a, a_src + boff, p0, 0, t4);
        if (kFirst) act_x<C, C>(a, p0, 0, aff_s, t4);
      } else {
#pragma unroll
        for (int k = 0; k < C / 16; ++k) a[k][0] = a[k][1] = a[k][2] = a[k][3] = 0u;
      }
      P3_WIDE(0);
#pragma unroll 1
      for (int nt = 0; nt < S::kNTiles; ++nt) {
        float acc[S::kNTile / 2];
        zero_acc(acc);
        fence_regs(acc);
#pragma unroll
        for (int kc = 0; kc < S::kKItems; ++kc) {
          const uint32_t i = (S::kResident ? 0u : ci) + nt * S::kKItems + kc;
          mbar_wait(full(i), S::kResident ? 0u : parity(i));
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_bf16(acc, a[4 * kc + kk], item_desc(stage(i), kk));
          wgmma_commit();
          if (!S::kResident && kc > 0) {
            wgmma_wait<1>();  // item i - 1 is read
            if (lane == 0) mbar_arrive(empty(i - 1));
          }
        }
        uint4 res[2][S::kNTile / 32];
        if (!kFirst && valid) load_residual<C, S::kNTile>(res, x + boff, p0, nt * S::kNTile, t4);
        wgmma_wait_all();
        fence_regs(acc);
        if (!S::kResident && lane == 0) {
          mbar_arrive(empty((S::kResident ? 0u : ci) + nt * S::kKItems + S::kKItems - 1));
        }
        P3_WIDE(1);
        if constexpr (kFirst) {
          // m = bf16(mish(acc)), transposed by stmatrix into the staging
          // tile [8 channel cores][8 position cores] (half the m item of
          // this board, tile t and channels 64 nt ..), then one bulk copy
          // out.
          const uint32_t buf = staging0 + (2 * g + sb) * S::kItemBytes;
          if (lead) bulk_wait_read<1>();  // the copy out of this buffer two passes ago
          group_sync(1 + g);
          const int mi = lane >> 3;
          const uint32_t st = buf + ((mi >> 1) * 8 + 2 * wq + (mi & 1)) * 128 + (lane & 7) * 16;
#pragma unroll
          for (int jp = 0; jp < S::kNTile / 16; ++jp) {
            uint32_t v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              v[k] = pack2(mish_f32(acc[8 * jp + 2 * k]), mish_f32(acc[8 * jp + 2 * k + 1]));
            }
            stmatrix_x4_trans(st + jp * 2 * 8 * 128, v);
          }
          fence_proxy_async();
          group_sync(1 + g);
          if (lead && valid) {
            bulk_store(dst + ((static_cast<size_t>(board) * kTiles + t) * (C / 8) +
                              nt * (S::kNTile / 8)) * kMCoreRow,
                       buf, S::kItemBytes);
            bulk_commit();
          }
          sb ^= 1;
        } else if (valid) {
          uint32_t unused[S::kNTile / 16][4];
          store_residual<C, S::kNTile>(acc, res, dst + boff, p0, nt * S::kNTile, t4, nullptr,
                                    unused);
        }
        P3_WIDE(2);
      }
      fence_regs(a);
      if (!S::kResident) ci += S::kItems;
#ifdef P3_BROADCAST_PROFILE
      ++wide_cycles[3];
#endif
    }
    if (kFirst && lead) bulk_wait<0>();  // m is out before the block ends
#ifdef P3_BROADCAST_PROFILE
    if (threadIdx.x == 0) {
      for (int k = 0; k < 4; ++k) {
        atomicAdd(&g_wide_cycles[kP + k], static_cast<unsigned long long>(wide_cycles[k]));
      }
    }
#endif
  }
}

// x: bf16 [num_boards, 361, C]; m: bf16 [num_boards, 6, C/8, 8, 64] (the
// mix's B items); f_aff: f32 [2, C]; wf: Wf's items, `pack_broadcast`.
template <int C>
__global__ void __launch_bounds__(RowsShape<C, true>::kThreads, 1)
trunk_broadcast_first_kernel(const bf16* __restrict__ x, bf16* __restrict__ m,
                             const float* __restrict__ f_aff, const bf16* __restrict__ wf,
                             int num_boards) {
  broadcast_rows<C, true>(x, nullptr, m, f_aff, wf, num_boards);
}

// out: act(z) in, bf16 [num_boards, 361, C], the block's output over it;
// x: the residual; wl: Wl's items, `pack_broadcast`.
template <int C>
__global__ void __launch_bounds__(RowsShape<C, false>::kThreads, 1)
trunk_broadcast_last_kernel(bf16* out, const bf16* __restrict__ x,
                            const bf16* __restrict__ wl, int num_boards) {
  broadcast_rows<C, false>(out, x, out, nullptr, wl, num_boards);
}

// m as trunk_broadcast_first_kernel writes it; zact: act(z) out, bf16
// [num_boards, 361, C]; wdt: the six 64-row WdT tiles, each A [64 q][384 p]
// in core matrices; bd: f32 [361]; l_aff: f32 [2, C].
template <int C>
__global__ void __launch_bounds__(MixShape<C>::kThreads, 1)
trunk_broadcast_mix_kernel(const bf16* __restrict__ m, bf16* __restrict__ zact,
                           const bf16* __restrict__ wdt, const float* __restrict__ bd,
                           const float* __restrict__ l_aff, int num_boards) {
  using S = MixShape<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t tiles = smem_u32(smem);
  const uint32_t stage0 = smem_u32(smem + S::kRingOff);
  const uint32_t bar0 = smem_u32(smem + S::kBarOff);
  const auto full = [&](uint32_t i) { return bar0 + 8u * (i % S::kStages); };
  const auto empty = [&](uint32_t i) { return bar0 + 8u * (S::kStages + i % S::kStages); };
  const auto stage = [&](uint32_t i) { return stage0 + (i % S::kStages) * kMixItemBytes; };
  const auto parity = [](uint32_t i) { return (i / S::kStages) & 1u; };
  const uint32_t a_full = bar0 + 8u * (2 * S::kStages);
  const int part = blockIdx.x % S::kParts;  // q tiles S::kGroups * part + g
  const int first = blockIdx.x / S::kParts;
  const int stride = gridDim.x / S::kParts;
  const int units = num_boards * S::kNTiles;  // (board, channel tile)

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), S::kConsumerWarps);
    }
    mbar_init(a_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= S::kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kWideProducerRegs));
    if (warp == S::kConsumerWarps && lane == 0) {
      mbar_expect_tx(a_full, S::kGroups * kWdtTileBytes);
      bulk_load(tiles, wdt + static_cast<size_t>(part) * S::kGroups * kWdtTileElems,
                S::kGroups * kWdtTileBytes, a_full);
      uint32_t ci = 0;
      for (int v = first; v < units; v += stride) {
        const int board = v / S::kNTiles;
        const int nt = v % S::kNTiles;
        const bf16* src = m + (static_cast<size_t>(board) * kTiles * (C / 8) +
                               nt * (kMixNTile / 8)) * kMCoreRow;
        for (int pk = 0; pk < kTiles; ++pk, ++ci) {
          mbar_wait(empty(ci), parity(ci) ^ 1u);
          mbar_expect_tx(full(ci), kMixItemBytes);
          bulk_load(stage(ci), src + static_cast<size_t>(pk) * (C / 8) * kMCoreRow, kMixItemBytes,
                    full(ci));
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(S::kConsumerRegs));
    const int g = warp >> 2;
    const int wq = warp & 3;
    const int t4 = lane & 3;
    const uint32_t tile = tiles + g * kWdtTileBytes;
    const int q0 = (S::kGroups * part + g) * kTileRows + wq * 16 + (lane >> 2);  // q0, q0 + 8
    const float bdq[2] = {q0 < kPos ? bd[q0] : 0.0f, q0 + 8 < kPos ? bd[q0 + 8] : 0.0f};
#ifdef P3_BROADCAST_PROFILE
    long long wide_cycles[3] = {0, 0, 0};
    long long wide_t = clock64();
#endif
    mbar_wait(a_full, 0);
    uint32_t ci = 0;
    for (int v = first; v < units; v += stride) {
      const int board = v / S::kNTiles;
      const int nt = v % S::kNTiles;
      float acc[kMixNTile / 2];
      zero_acc(acc);
      fence_regs(acc);
#pragma unroll
      for (int pk = 0; pk < kTiles; ++pk) {
        mbar_wait(full(ci + pk), parity(ci + pk));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_bf16_ss(acc, wdt_tile_desc(tile, 4 * pk + kk), item_desc(stage(ci + pk), kk));
        }
        wgmma_commit();
        if (pk > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty(ci + pk - 1));
        }
      }
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty(ci + kTiles - 1));
      ci += kTiles;
      P3_WIDE(0);
      // act(bf16(acc + bd[q]), l) of rows q < 361: in each 32-column group
      // qq the lane's columns are channels c = nt * 128 + 32 qq + 8 t4 ..
      // +7 (m's channel order), pair jj at accumulator 4 (4 qq + jj) + 2 h.
      bf16* zb = zact + static_cast<size_t>(board) * kPos * C;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = q0 + 8 * h;
        if (q >= kPos) continue;
#pragma unroll
        for (int qq = 0; qq < kMixNTile / 32; ++qq) {
          const int c = nt * kMixNTile + 32 * qq + 8 * t4;
          uint32_t o[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int e = 4 * (4 * qq + jj) + 2 * h;
            const float2 la = __ldg(reinterpret_cast<const float2*>(l_aff + c + 2 * jj));
            const float2 lb = __ldg(reinterpret_cast<const float2*>(l_aff + C + c + 2 * jj));
            o[jj] = pack2(act_f32(round_bf16(__fadd_rn(acc[e], bdq[h])), la.x, lb.x),
                          act_f32(round_bf16(__fadd_rn(acc[e + 1], bdq[h])), la.y, lb.y));
          }
          *reinterpret_cast<uint4*>(zb + static_cast<size_t>(q) * C + c) =
              make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
      P3_WIDE(1);
#ifdef P3_BROADCAST_PROFILE
      ++wide_cycles[2];
#endif
    }
#ifdef P3_BROADCAST_PROFILE
    if (threadIdx.x == 0) {
      for (int k = 0; k < 3; ++k) {
        atomicAdd(&g_wide_cycles[4 + k], static_cast<unsigned long long>(wide_cycles[k]));
      }
    }
#endif
  }
}

// Resident blocks of the three wide kernels at C, once per process (one
// card per process): conv_first, the mix, conv_last.
template <int C>
cudaError_t wide_resident(int* first, int* mix, int* last) {
  static int r_first = 0, r_mix = 0, r_last = 0;
  cudaError_t err = cudaSuccess;
  if (r_first == 0) {
    using F = RowsShape<C, true>;
    using L = RowsShape<C, false>;
    err = resident_blocks(trunk_broadcast_first_kernel<C>, F::kThreads, F::kSmem, &r_first);
    if (err != cudaSuccess) return err;
    err = resident_blocks(trunk_broadcast_mix_kernel<C>, MixShape<C>::kThreads,
                          MixShape<C>::kSmem, &r_mix);
    if (err != cudaSuccess) return err;
    err = resident_blocks(trunk_broadcast_last_kernel<C>, L::kThreads, L::kSmem, &r_last);
    if (err != cudaSuccess) return err;
  }
  *first = r_first;
  *mix = r_mix;
  *last = r_last;
  return err;
}

// The persistent grid of conv_first or conv_last (S) on num_boards boards.
template <typename S>
int rows_grid(int num_boards, int resident) {
  const int passes = (num_boards * kTiles + S::kGroups - 1) / S::kGroups;
  return passes < resident ? passes : resident;
}

template <int C>
int launch_broadcast_wide(const void* x, void* out, const void* f_aff, const void* packed,
                          const void* bd, const void* l_aff, void* m, int num_boards,
                          cudaStream_t stream) {
  using F = RowsShape<C, true>;
  using L = RowsShape<C, false>;
  using M = MixShape<C>;
  if (num_boards < 1 || m == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int r_first = 0, r_mix = 0, r_last = 0;
  cudaError_t err = wide_resident<C>(&r_first, &r_mix, &r_last);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* w = static_cast<const bf16*>(packed);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  bf16* mb = static_cast<bf16*>(m);
  trunk_broadcast_first_kernel<C><<<rows_grid<F>(num_boards, r_first), F::kThreads, F::kSmem,
                                    stream>>>(xb, mb, static_cast<const float*>(f_aff), w,
                                              num_boards);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int units = num_boards * M::kNTiles;
  const int per_part = r_mix / M::kParts < units ? r_mix / M::kParts : units;
  trunk_broadcast_mix_kernel<C><<<M::kParts * per_part, M::kThreads, M::kSmem, stream>>>(
      mb, ob, w + 2 * C * C, static_cast<const float*>(bd), static_cast<const float*>(l_aff),
      num_boards);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  trunk_broadcast_last_kernel<C><<<rows_grid<L>(num_boards, r_last), L::kThreads, L::kSmem,
                                   stream>>>(ob, xb, w + C * C, num_boards);
  return static_cast<int>(cudaGetLastError());
}


// ---- C = 16, `tiny`: a group of boards a mix ------------------------------
//
// Replaces the broadcast branch of `_make_kernel` at the width of tiny
// (config/ci-tiny.json, the scale-out dry run), which ran before as the
// C = 64 kernel zero-padded: 16x its 1x1 products, 4x its mix, 4x its bytes.
//
// What bounds it on an H100: x in and out, 23 KB a board (66.5 MB at
// N = 2880, 0.0200 ms at 3.35 TB/s). The products are 4.2 MFLOP a board,
// nearly all of them the 361 x 361 mix (0.012 ms at N = 2880); the
// elementwise chain (act(x, f), mish(h), act(z, l): 48 mish a position,
// ~5e7 at N = 2880) ~0.025 ms on the SMs' MUFU lanes. One board cannot feed
// the mix's tensor cores (N = 16), and would read WdT (295 KB) from L2 for
// 23 KB of its own bytes. So:
//
//  - A group of kSmallGroup = 8 boards is one mix: m of the 8 boards, B^T
//    [8 x 16 channels][384 positions] in shared memory (98 KB), N = 128, so
//    each WdT chunk serves 8 boards (wgmma m64n128k16, A = WdT chunks by
//    descriptor, streamed as in the C <= 128 kernel: three producer lanes, a
//    ring per consumer warpgroup, q tiles g and g + 3 for warpgroup g). WdT's
//    L2 reads fall 8x. Blocks walk groups by grid stride; the last group's
//    missing boards compute zeros and store nothing.
//  - conv_first and conv_last on mma.sync m16n8k16 (K = N = 16) from
//    registers. x is loaded 8 bytes a lane: channels 4t .. 4t + 3 of rows g,
//    g + 8, the A fragment with K in `small_k_order`; act(x, f), two
//    n-tiles, mish, and m stored transposed by stmatrix .trans (positions
//    361 .. 383 and missing boards zero, so the mix's K padding adds
//    nothing). The mix's m64n128 accumulators of board b are conv_last's A
//    fragments (bd, round, act(z, l) in registers); Wl's columns are in
//    `small_k_order`, so a lane's outputs are 4 contiguous channels and the
//    residual is loaded, and the output stored, 8 bytes a lane. Wf and Wl
//    are mma B fragments (`pack_broadcast`), in registers for the kernel.
//  - conv_first takes a warp's 16 units in batches of four, the next
//    batch's x loads in flight while this one computes.
//  - m is single-buffered as in the C <= 128 kernel: a group's first x loads
//    and products run before the wait for every warp's mix of the group
//    before (m_free).
//  - No atomics: two calls on the same input give identical bits.
//
// Tried on an H100 and not kept: all 16 units' loads at once (slower),
// 10 ring stages (slower); every WdT chunk copied from the same 4 KB ran no
// faster, so the mix does not wait on WdT's L2 reads (a multicast across a
// cluster would not help). The probe build's clocks (probe_trunk.py broadcast)
// split a group into conv_first, the mix and its epilogue.
//
// Shared memory: m 98,304 B, three rings of 8 stages x 4 KB (98,304), 49
// mbarriers: 197,000 B, one 512-thread block an SM.

constexpr int kSmallGroup = 8;  // boards a group: the mix's N = 8 x 16

template <int C>
struct SmallBroadcastShape {
  static constexpr int kStages = 8;  // per consumer warpgroup
  static constexpr int kN = kSmallGroup * C;
  static constexpr int kMBytes = kN * kMixPad * 2;
  static constexpr int kRingOff = kMBytes;
  static constexpr int kBarOff = kRingOff + kGroups * kStages * kChunkBytes;
  static constexpr int kSmem = kBarOff + (2 * kGroups * kStages + 1) * 8;
  static_assert(C == 16 && kN == 128, "the small kernel's fragments are for C = 16");
  static_assert(kSmem <= 232448, "shared memory");
};

// x, out: bf16 [num_boards, 361, 16]; f_aff, l_aff: f32 [2, 16]; packed:
// bf16 [2 x 256 + 384^2], `pack_broadcast` (Wf's and Wl's B fragment words
// [n-tile][k-group][32 lanes], then the WdT chunk stream of the C <= 128
// kernel); bd: f32 [361].
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
trunk_broadcast_small_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                             const float* __restrict__ f_aff, const bf16* __restrict__ packed,
                             const float* __restrict__ bd, const float* __restrict__ l_aff,
                             int num_boards) {
  using S = SmallBroadcastShape<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t m_s = smem_u32(smem);
  const uint32_t ring0 = smem_u32(smem + S::kRingOff);
  const uint32_t bar0 = smem_u32(smem + S::kBarOff);
  const auto slot = [](int g, uint32_t i) { return g * S::kStages + i % S::kStages; };
  const auto full = [&](int g, uint32_t i) { return bar0 + 8u * slot(g, i); };
  const auto empty = [&](int g, uint32_t i) {
    return bar0 + 8u * (kGroups * S::kStages + slot(g, i));
  };
  const auto stage = [&](int g, uint32_t i) { return ring0 + slot(g, i) * kChunkBytes; };
  const auto parity = [](uint32_t i) { return (i / S::kStages) & 1u; };
  const uint32_t m_free = bar0 + 8u * (2 * kGroups * S::kStages);  // phase k: group k's mix done
  const int n_groups = (num_boards + kSmallGroup - 1) / kSmallGroup;

  if (threadIdx.x == 0) {
    for (int g = 0; g < kGroups; ++g) {
      for (int s = 0; s < S::kStages; ++s) {
        mbar_init(full(g, s), 1);
        mbar_init(empty(g, s), 4);
      }
    }
    mbar_init(m_free, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // Producers: lane 0 of warp pw < 3 streams warpgroup pw's WdT chunks
    // (per group its tiles pw and pw + 3, 12 chunks each).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int pw = warp - kConsumerWarps;
    if (lane == 0 && pw < kGroups) {
      const bf16* stream = packed + 2 * C * C;
      uint32_t ci = 0;
      for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
        for (int r = 0; r < kTilesPerGroup; ++r) {
          const int t = pw + kGroups * r;
          for (int c = 0; c < kChunksPerTile; ++c, ++ci) {
            mbar_wait(empty(pw, ci), parity(ci) ^ 1u);
            mbar_expect_tx(full(pw, ci), kChunkBytes);
            bulk_load(stage(pw, ci),
                      stream + static_cast<size_t>(t * kChunksPerTile + c) * kChunkElems,
                      kChunkBytes, full(pw, ci));
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int g = warp >> 2;
    const int wq = warp & 3;
    const int t4 = lane & 3;
    // B fragment words: [n-tile][k-group] of Wf (K in small_k_order) and of
    // Wl (N in small_k_order).
    const uint32_t* words = reinterpret_cast<const uint32_t*>(packed);
    uint32_t wf[4], wl[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wf[k] = __ldg(words + 32 * k + lane);
      wl[k] = __ldg(words + C * C / 2 + 32 * k + lane);
    }
    const float4 fa = __ldg(reinterpret_cast<const float4*>(f_aff + 4 * t4));
    const float4 fb = __ldg(reinterpret_cast<const float4*>(f_aff + C + 4 * t4));
    // conv_last's K (z's channels) 2t, 2t + 1 and 8 + 2t, 8 + 2t + 1.
    const float2 la0 = __ldg(reinterpret_cast<const float2*>(l_aff + 2 * t4));
    const float2 la1 = __ldg(reinterpret_cast<const float2*>(l_aff + 8 + 2 * t4));
    const float2 lb0 = __ldg(reinterpret_cast<const float2*>(l_aff + C + 2 * t4));
    const float2 lb1 = __ldg(reinterpret_cast<const float2*>(l_aff + C + 8 + 2 * t4));
    uint32_t ci = 0;  // WdT chunks taken so far
    int i = 0;        // groups this block has run
#ifdef P3_BROADCAST_PROFILE
    long long phase_cycles[6] = {0, 0, 0, 0, 0, 0};  // [5]: groups
    long long phase_t = clock64();
#endif
    for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x, ++i) {
      const int board0 = grp * kSmallGroup;

      // conv_first: m = bf16(mish(act(x, f) . Wf)). Warp w's unit k < 16 is
      // board board0 + k / 2, rows 16 s .. 16 s + 15 with s = w + 12 (k % 2),
      // in batches of four units; a batch's x loads are in flight while the
      // batch before computes.
      const auto load_units = [&](uint32_t (&a)[4][4], int kb) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int board = board0 + (kb + kk) / 2;
          const int p = 16 * (warp + kConsumerWarps * (kk % 2)) + (lane >> 2);
          uint2 v0 = make_uint2(0u, 0u), v1 = make_uint2(0u, 0u);
          if (board < num_boards) {
            const bf16* xb = x + static_cast<size_t>(board) * kPos * C + 4 * t4;
            if (p < kPos) v0 = __ldg(reinterpret_cast<const uint2*>(xb + p * C));
            if (p + 8 < kPos) v1 = __ldg(reinterpret_cast<const uint2*>(xb + (p + 8) * C));
          }
          a[kk][0] = v0.x;
          a[kk][1] = v1.x;
          a[kk][2] = v0.y;
          a[kk][3] = v1.y;
        }
      };
      uint32_t next[4][4];
      load_units(next, 0);
#pragma unroll 1
      for (int kb = 0; kb < 2 * kSmallGroup; kb += 4) {
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) a[kk][r] = next[kk][r];
        }
        if (kb + 4 < 2 * kSmallGroup) load_units(next, kb + 4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int b = (kb + kk) / 2;
          const int s = warp + kConsumerWarps * (kk % 2);
          const int p = 16 * s + (lane >> 2);
          if (board0 + b < num_boards) {
            if (p < kPos) {
              a[kk][0] = act2_small(a[kk][0], fa.x, fb.x, fa.y, fb.y);
              a[kk][2] = act2_small(a[kk][2], fa.z, fb.z, fa.w, fb.w);
            }
            if (p + 8 < kPos) {
              a[kk][1] = act2_small(a[kk][1], fa.x, fb.x, fa.y, fb.y);
              a[kk][3] = act2_small(a[kk][3], fa.z, fb.z, fa.w, fb.w);
            }
          }
          float h0[4], h1[4];
          zero_acc(h0);
          zero_acc(h1);
          mma_16816(h0, a[kk], wf[0], wf[1]);
          mma_16816(h1, a[kk], wf[2], wf[3]);
          if (kb == 0 && kk == 0 && i > 0) {
            P3_PHASE(0);
            mbar_wait(m_free, (i - 1) & 1);  // the group before has read m
            P3_PHASE(1);
          }
          // stmatrix: matrix mi = lane / 8 is n-tile mi / 2 (channels
          // 8 (mi / 2) ..), rows 8 (mi % 2) .. of the unit; the lane gives
          // the address of its channel row lane % 8.
          const uint32_t v[4] = {pack2(mish_small(h0[0]), mish_small(h0[1])),
                                 pack2(mish_small(h0[2]), mish_small(h0[3])),
                                 pack2(mish_small(h1[0]), mish_small(h1[1])),
                                 pack2(mish_small(h1[2]), mish_small(h1[3]))};
          const int mi = lane >> 3;
          stmatrix_x4_trans(
              m_s + ((2 * b + (mi >> 1)) * kPCores + 2 * s + (mi & 1)) * 128 + (lane & 7) * 16,
              v);
        }
      }
      fence_proxy_async();  // m's stores before the mix's wgmma reads
      P3_PHASE(0);
      consumer_sync<kConsumerThreads>();
      P3_PHASE(2);

      // Per q tile: z = WdT . m (12 chunks from the ring), then for each
      // board x + act(bf16(z + bd), l) . Wl from registers.
#pragma unroll 1
      for (int r = 0; r < kTilesPerGroup; ++r) {
        const int q0 = (g + kGroups * r) * kTileRows + wq * 16 + (lane >> 2);  // rows q0, q0 + 8
        uint2 res[kSmallGroup][2];
#pragma unroll
        for (int b = 0; b < kSmallGroup; ++b) {
          res[b][0] = res[b][1] = make_uint2(0u, 0u);
          if (board0 + b < num_boards) {
            const bf16* xb = x + static_cast<size_t>(board0 + b) * kPos * C + 4 * t4;
            if (q0 < kPos) res[b][0] = __ldg(reinterpret_cast<const uint2*>(xb + q0 * C));
            if (q0 + 8 < kPos) res[b][1] = __ldg(reinterpret_cast<const uint2*>(xb + (q0 + 8) * C));
          }
        }
        float acc[S::kN / 2];
        zero_acc(acc);
        fence_regs(acc);
        for (int c = 0; c < kChunksPerTile; ++c) {
          mbar_wait(full(g, ci + c), parity(ci + c));
          const uint32_t chunk = stage(g, ci + c);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            wgmma_bf16_ss(acc, wdt_desc(chunk, ks), m_desc(m_s, 2 * c + ks));
          }
          wgmma_commit();
          if (c > 0) {
            wgmma_wait<1>();  // chunk c - 1 is read
            if (lane == 0) mbar_arrive(empty(g, ci + c - 1));
          }
        }
        wgmma_wait_all();
        fence_regs(acc);
        if (lane == 0) {
          mbar_arrive(empty(g, ci + kChunksPerTile - 1));
          if (r + 1 == kTilesPerGroup) mbar_arrive(m_free);
        }
        ci += kChunksPerTile;
        P3_PHASE(3);

        // Board b's columns 16 b .. 16 b + 15 are accumulators 8 b .. 8 b + 7:
        // pairs (row q0, z channels 2t, 2t + 1), (q0 + 8, the same),
        // (q0, 8 + 2t, 8 + 2t + 1), (q0 + 8, the same): conv_last's A.
        const float bd0 = q0 < kPos ? __ldg(bd + q0) : 0.0f;
        const float bd1 = q0 + 8 < kPos ? __ldg(bd + q0 + 8) : 0.0f;
#pragma unroll
        for (int b = 0; b < kSmallGroup; ++b) {
          if (board0 + b >= num_boards) continue;
          const uint32_t al[4] = {
              act2_small(pack2(__fadd_rn(acc[8 * b], bd0), __fadd_rn(acc[8 * b + 1], bd0)),
                         la0.x, lb0.x, la0.y, lb0.y),
              act2_small(pack2(__fadd_rn(acc[8 * b + 2], bd1), __fadd_rn(acc[8 * b + 3], bd1)),
                         la0.x, lb0.x, la0.y, lb0.y),
              act2_small(pack2(__fadd_rn(acc[8 * b + 4], bd0), __fadd_rn(acc[8 * b + 5], bd0)),
                         la1.x, lb1.x, la1.y, lb1.y),
              act2_small(pack2(__fadd_rn(acc[8 * b + 6], bd1), __fadd_rn(acc[8 * b + 7], bd1)),
                         la1.x, lb1.x, la1.y, lb1.y)};
          float y0[4], y1[4];
          zero_acc(y0);
          zero_acc(y1);
          mma_16816(y0, al, wl[0], wl[1]);  // output channels 4t, 4t + 1
          mma_16816(y1, al, wl[2], wl[3]);  // 4t + 2, 4t + 3
          bf16* ob = out + static_cast<size_t>(board0 + b) * kPos * C + 4 * t4;
          if (q0 < kPos) {
            const uint2 rv = res[b][0];
            *reinterpret_cast<uint2*>(ob + q0 * C) = make_uint2(
                pack2(__fadd_rn(bf16_lo(rv.x), y0[0]), __fadd_rn(bf16_hi(rv.x), y0[1])),
                pack2(__fadd_rn(bf16_lo(rv.y), y1[0]), __fadd_rn(bf16_hi(rv.y), y1[1])));
          }
          if (q0 + 8 < kPos) {
            const uint2 rv = res[b][1];
            *reinterpret_cast<uint2*>(ob + (q0 + 8) * C) = make_uint2(
                pack2(__fadd_rn(bf16_lo(rv.x), y0[2]), __fadd_rn(bf16_hi(rv.x), y0[3])),
                pack2(__fadd_rn(bf16_lo(rv.y), y1[2]), __fadd_rn(bf16_hi(rv.y), y1[3])));
          }
        }
        P3_PHASE(4);
      }
#ifdef P3_BROADCAST_PROFILE
      ++phase_cycles[5];
#endif
    }
#ifdef P3_BROADCAST_PROFILE
    if (threadIdx.x == 0) {
      for (int k = 0; k < 6; ++k) {
        atomicAdd(&g_phase_cycles[k], static_cast<unsigned long long>(phase_cycles[k]));
      }
    }
#endif
  }
}

template <int C>
int launch_broadcast_small(const void* x, void* out, const void* f_aff, const void* packed,
                           const void* bd, const void* l_aff, int num_boards,
                           cudaStream_t stream) {
  using S = SmallBroadcastShape<C>;
  if (num_boards < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = trunk_broadcast_small_kernel<C>;
  static int resident = 0;
  if (resident == 0) {
    const cudaError_t err = resident_blocks(kernel, kThreads, S::kSmem, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int groups = (num_boards + kSmallGroup - 1) / kSmallGroup;
  const int grid = groups < resident ? groups : resident;
  kernel<<<grid, kThreads, S::kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out),
      static_cast<const float*>(f_aff), static_cast<const bf16*>(packed),
      static_cast<const float*>(bd), static_cast<const float*>(l_aff), num_boards);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m: scratch of num_boards * 384 * channels bf16 at channels 256 and 384
// (the mix's B), unused (may be null) at the other widths.
extern "C" int p3_trunk_broadcast(const void* x, void* out, const void* f_aff,
                                  const void* packed, const void* bd, const void* l_aff,
                                  void* m, int num_boards, int channels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 16) {
    return launch_broadcast_small<16>(x, out, f_aff, packed, bd, l_aff, num_boards, s);
  }
  if (channels == 64) {
    return launch_broadcast<64>(x, out, f_aff, packed, bd, l_aff, num_boards, s);
  }
  if (channels == 128) {
    return launch_broadcast<128>(x, out, f_aff, packed, bd, l_aff, num_boards, s);
  }
  if (channels == 256) {
    return launch_broadcast_wide<256>(x, out, f_aff, packed, bd, l_aff, m, num_boards, s);
  }
  if (channels == 384) {
    return launch_broadcast_wide<384>(x, out, f_aff, packed, bd, l_aff, m, num_boards, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks of the persistent grid at `channels` on this card (at 256 and
// 384, of conv_first), or minus the cudaError.
extern "C" int p3_trunk_broadcast_grid(int channels) {
  int n = 0, mix = 0, last = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (channels == 16) {
    err = resident_blocks(trunk_broadcast_small_kernel<16>, kThreads,
                          SmallBroadcastShape<16>::kSmem, &n);
  } else if (channels == 64) {
    err = resident_blocks(trunk_broadcast_kernel<64>, kThreads, BroadcastShape<64>::kSmem, &n);
  } else if (channels == 128) {
    err = resident_blocks(trunk_broadcast_kernel<128>, kThreads, BroadcastShape<128>::kSmem, &n);
  } else if (channels == 256) {
    err = wide_resident<256>(&n, &mix, &last);
  } else if (channels == 384) {
    err = wide_resident<384>(&n, &mix, &last);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

#ifdef P3_BROADCAST_PROFILE
// The phase clocks of the launches since the last reset (see P3_PHASE):
// copies the 6 counters to `out` (host memory), or zeroes them when `reset`.
extern "C" int p3_trunk_broadcast_phase_cycles(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
    return static_cast<int>(cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles)));
}

// The wide kernels' clocks (see P3_WIDE): copies the 11 counters to `out`,
// or zeroes them when `reset`.
extern "C" int p3_trunk_broadcast_wide_cycles(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[11] = {};
    return static_cast<int>(cudaMemcpyToSymbol(g_wide_cycles, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_wide_cycles, sizeof(g_wide_cycles)));
}
#endif
