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
// and 589,824), past a block's 232,448. `trunk_broadcast_cluster_kernel`
// (its own comment, below) splits the channels over a thread-block cluster
// of C / 64 blocks, 64 channels each, and reads the K of conv_first and
// conv_last from its peers' shared memory. Its shared memory, one 512-thread
// block per SM: `a` (act(x) or act(z), 384 x 72 x 2 B) 55,296, m (64 x 384
// x 2 B) 49,152, the block's rows of Wf and of Wl (64 x C x 2 B each), three
// rings of WdT stages x 4 KB, affines and bd 2,560, mbarriers:
//   C = 256: cluster of 4, rows 2 x 32,768, 4 stages a ring: 221,912 B.
//   C = 384: cluster of 6, rows 2 x 49,152, 2 stages a ring: 230,008 B.
//
// Widths: C in {64, 128, 256, 384}; others return cudaErrorInvalidValue
// (the Python wrapper refuses them first, and runs narrower blocks, such as
// C = 16, zero-padded to 64).
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
// epilogue, conv_last and the residual store; [5] the boards it ran. The
// cluster kernel (rank 0's thread 0): [0] the exchange before act(x), act(x)
// and the exchange after it, [1] conv_first, [2] the exchange after it, [3]
// the mix's products, [4] act(z), its exchange, conv_last and the store.
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


// ---- the cluster kernel: C in {256, 384} ---------------------------------
//
// Channels split over a cluster of C / 64 blocks: block r owns channels
// 64 r .. 64 r + 63 of m, z and the output. It writes act(x, f) of its
// channels into a shared buffer `a` (positions x 64 channels, rows padded
// to 72 elements); conv_first's A for its 64 output channels is read from
// every block's `a` in rank order by distributed shared memory (16-byte
// loads, the K order of `reduce_k_order`; the loads of 4 blocks at C = 256,
// of 3 at C = 384, issued together); m stays local and so does the
// mix, z[:, slice] = WdT . m[:, slice]; act(z, l) of its channels goes into
// `a` again, and conv_last's A is read from every block's `a` the same way.
// Four consumer barriers over the cluster a board order the uses of `a`:
// every block's reads of the previous act(z) before act(x) is written;
// act(x) before conv_first; every conv_first before act(z) is written;
// act(z) before conv_last. No atomics and no cross-block reduction: a
// block sums all of K itself, in a fixed order.

template <int C>
struct ClusterBroadcastShape {
  static constexpr int kCluster = C / 64;
  static constexpr int kSlice = 64;  // channels a block
  static constexpr int kLdA = kSlice + 8;
  static constexpr int kABytes = kMixPad * kLdA * 2;
  static constexpr int kMBytes = kSlice * kMixPad * 2;
  static constexpr int kWBytes = kSlice * C * 2;  // a block's rows of Wf or Wl
  static constexpr int kStages = C == 256 ? 4 : 2;  // per consumer warpgroup
  static constexpr int kAcc = kSlice / 2;
  static constexpr int kMOff = kABytes;
  static constexpr int kWfOff = kMOff + kMBytes;
  static constexpr int kWlOff = kWfOff + kWBytes;
  static constexpr int kRingOff = kWlOff + kWBytes;
  static constexpr int kAffOff = kRingOff + kGroups * kStages * kChunkBytes;
  static constexpr int kBdOff = kAffOff + 4 * kSlice * 4;
  static constexpr int kBarOff = kBdOff + kMixPad * 4;
  // full, empty per stage and group; w_full; exchange[2]
  static constexpr int kSmem = kBarOff + (2 * kGroups * kStages + 3) * 8;
  static_assert(kMOff % 128 == 0 && kRingOff % 128 == 0 && kAffOff % 16 == 0, "align");
  static_assert(kSmem <= 232448, "shared memory");
};

// conv_first's or conv_last's A fragments over block s's 64 channels of the
// rows p0, p0 + 8: 16-byte loads of channels 32q + 8 t4 .. +7 from block
// s's `a` (as load_x).
template <int C>
__device__ __forceinline__ void load_peer(uint32_t (&a)[4][4], uint32_t peer_a, int p0,
                                          int t4) {
  using S = ClusterBroadcastShape<C>;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 v = ld_cluster_v4(peer_a + ((p0 + 8 * h) * S::kLdA + 32 * q + 8 * t4) * 2);
      a[2 * q][h] = v.x;
      a[2 * q][2 + h] = v.y;
      a[2 * q + 1][h] = v.z;
      a[2 * q + 1][2 + h] = v.w;
    }
  }
}

// acc [64 rows x 64 channels] += A . B over all C of K, A from every
// block's `a` in rank order, B a [64 n][C k] operand at `w`. The loads of
// kBatch blocks' slices are issued together, so a batch waits for one
// round trip through distributed shared memory, not kBatch.
template <int C>
__device__ __forceinline__ void product_over_cluster(float (&acc)[32], uint32_t a_s, uint32_t w,
                                                     int p0, int t4) {
  constexpr int R = ClusterBroadcastShape<C>::kCluster;
  constexpr int kBatch = R <= 4 ? R : R / 2;  // 16 registers of A a block
  static_assert(R % kBatch == 0, "batches");
  uint32_t a[kBatch][4][4];
  fence_regs(acc);
#pragma unroll
  for (int s0 = 0; s0 < R; s0 += kBatch) {
#pragma unroll
    for (int b = 0; b < kBatch; ++b) load_peer<C>(a[b], cluster_map(a_s, s0 + b), p0, t4);
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_bf16(acc, a[b][kk], w_desc<C>(w, 4 * (s0 + b) + kk));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(a);
  }
}

// x, out, f_aff, packed, bd, l_aff as trunk_broadcast_kernel's (packed with
// Wl's K in reduce_k_order too); the grid is a whole number of clusters,
// each cluster walks boards (cluster index, stride clusters).
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
trunk_broadcast_cluster_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                               const float* __restrict__ f_aff,
                               const bf16* __restrict__ packed, const float* __restrict__ bd,
                               const float* __restrict__ l_aff, int num_boards) {
  using S = ClusterBroadcastShape<C>;
  constexpr int R = S::kCluster;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rank = static_cast<int>(cluster_rank());
  const int cluster_id = blockIdx.x / R;
  const int n_clusters = gridDim.x / R;
  const int c0 = rank * S::kSlice;  // this block's channels
  bf16* a_p = reinterpret_cast<bf16*>(smem);
  const uint32_t a_s = smem_u32(smem);
  const uint32_t m_s = smem_u32(smem + S::kMOff);
  const uint32_t wf_s = smem_u32(smem + S::kWfOff);
  const uint32_t wl_s = smem_u32(smem + S::kWlOff);
  const uint32_t ring0 = smem_u32(smem + S::kRingOff);
  float* aff_s = reinterpret_cast<float*>(smem + S::kAffOff);  // f a, f b, l a, l b [64]
  float* bd_s = reinterpret_cast<float*>(smem + S::kBdOff);   // [384], 0 past 361
  const uint32_t bar0 = smem_u32(smem + S::kBarOff);
  const auto slot = [](int g, uint32_t i) { return g * S::kStages + i % S::kStages; };
  const auto full = [&](int g, uint32_t i) { return bar0 + 8u * slot(g, i); };
  const auto empty = [&](int g, uint32_t i) {
    return bar0 + 8u * (kGroups * S::kStages + slot(g, i));
  };
  const auto stage = [&](int g, uint32_t i) { return ring0 + slot(g, i) * kChunkBytes; };
  const auto parity = [](uint32_t i) { return (i / S::kStages) & 1u; };
  const uint32_t w_full = bar0 + 8u * (2 * kGroups * S::kStages);
  const auto xbar = [&](uint32_t e) { return w_full + 8u + 8u * (e & 1u); };

  for (int i = threadIdx.x; i < S::kSlice; i += kThreads) {
    aff_s[i] = f_aff[c0 + i];
    aff_s[S::kSlice + i] = f_aff[C + c0 + i];
    aff_s[2 * S::kSlice + i] = l_aff[c0 + i];
    aff_s[3 * S::kSlice + i] = l_aff[C + c0 + i];
  }
  for (int i = threadIdx.x; i < kMixPad; i += kThreads) bd_s[i] = i < kPos ? bd[i] : 0.0f;
  // Rows 361.. of `a` stay zero from here on.
  for (int i = threadIdx.x; i < S::kABytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) {
    for (int g = 0; g < kGroups; ++g) {
      for (int s = 0; s < S::kStages; ++s) {
        mbar_init(full(g, s), 1);
        mbar_init(empty(g, s), 4);
      }
    }
    mbar_init(w_full, 1);
    mbar_init(xbar(0), R);
    mbar_init(xbar(1), R);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync_all();

  if (warp >= kConsumerWarps) {
    // Producers: warp pw < 3 streams consumer group pw's WdT chunks as in
    // trunk_broadcast_kernel; warp 3 copies this block's rows of Wf and Wl.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int pw = warp - kConsumerWarps;
    if (lane == 0 && pw == kGroups) {
      mbar_expect_tx(w_full, 2 * S::kWBytes);
      bulk_load(wf_s, packed + static_cast<size_t>(c0) * C, S::kWBytes, w_full);
      bulk_load(wl_s, packed + static_cast<size_t>(C) * C + static_cast<size_t>(c0) * C,
                S::kWBytes, w_full);
    } else if (lane == 0) {
      const bf16* stream = packed + 2 * C * C;
      uint32_t ci = 0;
      for (int board = cluster_id; board < num_boards; board += n_clusters) {
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
    const float* f_a = aff_s;
    const float* f_b = aff_s + S::kSlice;
    const float* l_a = aff_s + 2 * S::kSlice;
    const float* l_b = aff_s + 3 * S::kSlice;
    uint32_t ci = 0, e = 0;  // WdT chunks taken, exchanges so far
    const auto exchange = [&]() {
      consumer_sync<kConsumerThreads>();
      if (threadIdx.x == 0) {
        fence_acq_rel_cluster();
        for (int s = 0; s < R; ++s) mbar_arrive_cluster(cluster_map(xbar(e), s));
      }
      mbar_wait_cluster(xbar(e), (e >> 1) & 1u);
      ++e;
    };
    mbar_wait(w_full, 0);
#ifdef P3_BROADCAST_PROFILE
    long long phase_cycles[6] = {0, 0, 0, 0, 0, 0};
    long long phase_t = clock64();
#endif

    for (int board = cluster_id; board < num_boards; board += n_clusters) {
      const size_t boff = static_cast<size_t>(board) * kPos * C;
      const bf16* xb = x + boff;

      exchange();  // every block is done reading the previous board's act(z)
      // act(x, f) of this block's channels into `a`, 16 bytes a thread.
      for (int i = threadIdx.x; i < kPos * (S::kSlice / 8); i += kConsumerThreads) {
        const int p = i / (S::kSlice / 8);
        const int c8 = (i % (S::kSlice / 8)) * 8;
        uint4 v = *reinterpret_cast<const uint4*>(xb + static_cast<size_t>(p) * C + c0 + c8);
        const float4 alo = *reinterpret_cast<const float4*>(f_a + c8);
        const float4 ahi = *reinterpret_cast<const float4*>(f_a + c8 + 4);
        const float4 blo = *reinterpret_cast<const float4*>(f_b + c8);
        const float4 bhi = *reinterpret_cast<const float4*>(f_b + c8 + 4);
        v.x = act2(v.x, alo.x, blo.x, alo.y, blo.y);
        v.y = act2(v.y, alo.z, blo.z, alo.w, blo.w);
        v.z = act2(v.z, ahi.x, bhi.x, ahi.y, bhi.y);
        v.w = act2(v.w, ahi.z, bhi.z, ahi.w, bhi.w);
        *reinterpret_cast<uint4*>(a_p + p * S::kLdA + c8) = v;
      }
      exchange();  // every block's act(x) is written
      P3_PHASE(0);

      // conv_first: m = bf16(mish(act(x, f) . Wf[:, slice])) into m by
      // stmatrix .trans, as trunk_broadcast_kernel.
#pragma unroll 1
      for (int r = 0; r < kTilesPerGroup; ++r) {
        const int base = (g + kGroups * r) * kTileRows + wq * 16;
        float acc[S::kAcc];
        zero_acc(acc);
        product_over_cluster<C>(acc, a_s, wf_s, base + (lane >> 2), t4);
        const int mi = lane >> 3;
        const uint32_t st =
            m_s + ((mi >> 1) * kPCores + base / 8 + (mi & 1)) * 128 + (lane & 7) * 16;
#pragma unroll
        for (int jp = 0; jp < S::kSlice / 16; ++jp) {
          uint32_t v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            v[k] = pack2(mish_f32(acc[8 * jp + 2 * k]), mish_f32(acc[8 * jp + 2 * k + 1]));
          }
          stmatrix_x4_trans(st + jp * 2 * kPCores * 128, v);
        }
      }
      fence_proxy_async();  // m's stores before the mix's wgmma reads
      P3_PHASE(1);
      exchange();  // every block's conv_first has read `a`; m is whole
      P3_PHASE(2);

      // The mix of this block's channels, z = bf16(WdT . m + bd), then
      // act(z, l) into `a` (rows < 361).
#pragma unroll 1
      for (int r = 0; r < kTilesPerGroup; ++r) {
        const int q0 = (g + kGroups * r) * kTileRows + wq * 16 + (lane >> 2);
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
        if (lane == 0) mbar_arrive(empty(g, ci + kChunksPerTile - 1));
        ci += kChunksPerTile;
        P3_PHASE(3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = q0 + 8 * h;
          if (q >= kPos) continue;
          const float bdq = bd_s[q];
#pragma unroll
          for (int j = 0; j < S::kSlice / 8; ++j) {
            const int c = 8 * j + 2 * t4;
            const float2 la = *reinterpret_cast<const float2*>(l_a + c);
            const float2 lb = *reinterpret_cast<const float2*>(l_b + c);
            *reinterpret_cast<uint32_t*>(a_p + q * S::kLdA + c) =
                pack2(act_f32(round_bf16(__fadd_rn(acc[4 * j + 2 * h], bdq)), la.x, lb.x),
                      act_f32(round_bf16(__fadd_rn(acc[4 * j + 2 * h + 1], bdq)), la.y, lb.y));
          }
        }
      }
      exchange();  // every block's act(z) is written

      // conv_last over every block's act(z), + residual, this block's
      // output channels (N in reduce_k_order: 8 contiguous a lane).
#pragma unroll 1
      for (int r = 0; r < kTilesPerGroup; ++r) {
        const int p0 = (g + kGroups * r) * kTileRows + wq * 16 + (lane >> 2);
        uint4 res[2][S::kSlice / 32];
        load_residual<C, S::kSlice>(res, xb, p0, c0, t4);
        float acc[S::kAcc];
        zero_acc(acc);
        product_over_cluster<C>(acc, a_s, wl_s, p0, t4);
        uint32_t unused[S::kSlice / 16][4];
        store_residual<C, S::kSlice>(acc, res, out + boff, p0, c0, t4, nullptr, unused);
      }
      P3_PHASE(4);
#ifdef P3_BROADCAST_PROFILE
      ++phase_cycles[5];
#endif
    }
#ifdef P3_BROADCAST_PROFILE
    if (threadIdx.x == 0 && rank == 0) {
      for (int k = 0; k < 6; ++k) {
        atomicAdd(&g_phase_cycles[k], static_cast<unsigned long long>(phase_cycles[k]));
      }
    }
#endif
  }
  // No block exits while a peer may still read its `a` or arrive on its
  // mbarriers.
  __syncwarp();
  cluster_sync_all();
}

template <int C>
int launch_broadcast_cluster(const void* x, void* out, const void* f_aff, const void* packed,
                             const void* bd, const void* l_aff, int num_boards,
                             cudaStream_t stream) {
  using S = ClusterBroadcastShape<C>;
  if (num_boards < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = trunk_broadcast_cluster_kernel<C>;
  // Resident clusters on this card, once per process (one card per process).
  static int resident = 0;
  if (resident == 0) {
    const cudaError_t err = resident_clusters(kernel, kThreads, S::kSmem, S::kCluster, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int clusters = num_boards < resident ? num_boards : resident;
  const cudaError_t err = launch_clusters(
      kernel, clusters * S::kCluster, kThreads, S::kSmem, S::kCluster, stream,
      static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<const float*>(f_aff),
      static_cast<const bf16*>(packed), static_cast<const float*>(bd),
      static_cast<const float*>(l_aff), num_boards);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int p3_trunk_broadcast(const void* x, void* out, const void* f_aff,
                                  const void* packed, const void* bd, const void* l_aff,
                                  int num_boards, int channels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 64) {
    return launch_broadcast<64>(x, out, f_aff, packed, bd, l_aff, num_boards, s);
  }
  if (channels == 128) {
    return launch_broadcast<128>(x, out, f_aff, packed, bd, l_aff, num_boards, s);
  }
  if (channels == 256) {
    return launch_broadcast_cluster<256>(x, out, f_aff, packed, bd, l_aff, num_boards, s);
  }
  if (channels == 384) {
    return launch_broadcast_cluster<384>(x, out, f_aff, packed, bd, l_aff, num_boards, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks of the persistent grid at `channels` on this card (resident
// blocks, or resident clusters times the cluster's blocks), or minus the
// cudaError.
extern "C" int p3_trunk_broadcast_grid(int channels) {
  int n = 0, per = 1;
  cudaError_t err = cudaErrorInvalidValue;
  if (channels == 64) {
    err = resident_blocks(trunk_broadcast_kernel<64>, kThreads, BroadcastShape<64>::kSmem, &n);
  } else if (channels == 128) {
    err = resident_blocks(trunk_broadcast_kernel<128>, kThreads, BroadcastShape<128>::kSmem, &n);
  } else if (channels == 256) {
    per = ClusterBroadcastShape<256>::kCluster;
    err = resident_clusters(trunk_broadcast_cluster_kernel<256>, kThreads,
                            ClusterBroadcastShape<256>::kSmem, per, &n);
  } else if (channels == 384) {
    per = ClusterBroadcastShape<384>::kCluster;
    err = resident_clusters(trunk_broadcast_cluster_kernel<384>, kThreads,
                            ClusterBroadcastShape<384>::kSmem, per, &n);
  }
  return err == cudaSuccess ? n * per : -static_cast<int>(err);
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
#endif
