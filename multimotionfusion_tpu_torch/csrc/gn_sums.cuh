// The last-block sums shared by K4 gn_reduce (csrc/gn_reduce.cu) and K11
// gn_multi (csrc/gn_multi.cu): a pass's blocks each write their partials,
// and the block that draws the last ticket sums them in block order into
// the `sums` rows the GN steps read (64 floats a model: [0:28] S_icp's upper
// triangle, [28:56] S_rgb's, [56] ICP count, [57] RGB count, [58]
// sum(diff^2)). This replaces a separate one-block finalize kernel and the
// memset of `sums` before it, with the same additions in the same order.
// Each source that includes this keeps its own ticket counters (one a pass,
// 0 between evaluations), so two evaluations of one source on two streams
// at once are unsafe: the engine runs them on one stream.

#pragma once

#include <cuda_runtime.h>

#include "last_block.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLOTS = 64;
constexpr int STAGE = 10240;  // floats of the last block's staging buffer (40 KB)
constexpr int SUM_BATCH = 16;  // staged partials a summing thread loads at once

// the slot in sums' 64-float row of accumulator i of a pass
template <int PASS>
__device__ __forceinline__ int slot_of(int i) {
  return PASS == 1 ? (i < 28 ? i : 56 + (i - 28)) : 28 + i;
}

// the last block's fixed-order sum over blocks of one pass's partials
// ([blocks, M, NV]: thread t < M x NV owns model t / NV, accumulator t % NV),
// each slot from 0.f in block order (sum_partials); pass 1 also writes zeros
// into every other slot of the ROWS rows of sums.
template <int NV, int PASS, int ROWS>
__device__ __forceinline__ void finish_sums(const float* partials, int M, float* stage,
                                            float* sums) {
  const int MN = M * NV;
  const float s = sum_partials<THREADS, STAGE, SUM_BATCH>(partials, MN, MN, stage);
  if (threadIdx.x < MN) {
    const int m = threadIdx.x / NV, i = threadIdx.x % NV;
    sums[m * SLOTS + slot_of<PASS>(i)] = s;
  }
  if (PASS == 1)
    for (int e = threadIdx.x; e < ROWS * SLOTS; e += THREADS) {
      const int m = e / SLOTS, v = e % SLOTS;
      if (m >= M || (v >= 28 && v < 56) || v >= 59) sums[e] = 0.f;
    }
}

}  // namespace
