// Per-point chain liberty counts for a batch of 19x19 Go boards.
//
// Replaces the Pallas TPU kernel p3achygo_tpu/ops/liberties.py `_libs_kernel`
// (launched by `point_liberties_batch`). The TPU kernel padded each board to
// 384 lanes and built the per-chain histogram and the per-point gather as
// one-hot contractions, because a TPU has no fast scatter or gather. Here
// both are plain shared-memory operations.
//
// Design: one thread block per board, 384 threads (12 warps), one thread per
// point. The block loads the board's chain ids into shared memory and zeroes
// a counts[362] array. Each empty point dedups its <= 4 neighbour chain ids
// and does one shared-memory atomicAdd per distinct id in [0, 361). After a
// barrier, each stone point writes counts[its chain]. Integer atomics make
// the result exact and the same on every run.
//
// What bounds it: each point reads 1 byte of stones and 4 bytes of chain id
// and writes 4 bytes of liberties, about 9 bytes per point and no arithmetic
// to speak of, so the kernel is bound by device-memory traffic (and, at small
// batch, by launch latency). The design touches device memory once per
// input and output and keeps the neighbour reads and the histogram in shared
// memory; coalesced loads come from neighbouring threads reading neighbouring
// points.
//
// Interface: plain C, for ctypes. All pointers are device pointers;
// `stream` is a cudaStream_t; `num_boards` is at least 1 (a grid of 0 blocks
// is a launch error). Returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBoardLen = 19;
constexpr int kNumLocs = kBoardLen * kBoardLen;  // 361
constexpr int kThreads = 384;

__device__ __forceinline__ bool is_chain(int32_t c) {
  return c >= 0 && c < kNumLocs;
}

__global__ void __launch_bounds__(kThreads)
point_liberties_kernel(const int8_t* __restrict__ stones,
                       const int32_t* __restrict__ chain,
                       int32_t* __restrict__ libs) {
  __shared__ int32_t s_chain[kNumLocs];
  __shared__ int32_t s_counts[kNumLocs + 1];

  const int p = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * kNumLocs;

  int8_t st = 0;
  int32_t c = -1;
  if (p < kNumLocs) {
    st = stones[base + p];
    c = chain[base + p];
    s_chain[p] = c;
  }
  if (p <= kNumLocs) s_counts[p] = 0;
  __syncthreads();

  if (p < kNumLocs && st == 0) {
    const int row = p / kBoardLen;
    const int col = p % kBoardLen;
    int32_t n[4];
    n[0] = row > 0 ? s_chain[p - kBoardLen] : -1;
    n[1] = row < kBoardLen - 1 ? s_chain[p + kBoardLen] : -1;
    n[2] = col > 0 ? s_chain[p - 1] : -1;
    n[3] = col < kBoardLen - 1 ? s_chain[p + 1] : -1;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      bool fresh = is_chain(n[d]);
#pragma unroll
      for (int e = 0; e < d; ++e) fresh = fresh && (n[d] != n[e]);
      if (fresh) atomicAdd(&s_counts[n[d]], 1);
    }
  }
  __syncthreads();

  if (p < kNumLocs) {
    libs[base + p] = (st != 0 && is_chain(c)) ? s_counts[c] : 0;
  }
}

}  // namespace

extern "C" int p3_point_liberties(const void* stones, const void* chain,
                                  void* libs, int num_boards, void* stream) {
  point_liberties_kernel<<<num_boards, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(stones), static_cast<const int32_t*>(chain),
      static_cast<int32_t*>(libs));
  return static_cast<int>(cudaGetLastError());
}
