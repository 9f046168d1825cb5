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

// true in the block that draws the last ticket, once every block's partials
// are visible; that block sets the counter back to 0. The barrier orders the
// block's partial writes before thread 0's fence, which makes them visible
// to the device before its ticket (the pattern of a cooperative grid sync).
__device__ __forceinline__ bool last_block(unsigned* ticket) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned t = atomicAdd(ticket, 1u);
    last = t == gridDim.x - 1;
    if (last) {
      *ticket = 0u;
      __threadfence();  // the other blocks' partials before this block's reads
    }
  }
  __syncthreads();
  return last;
}

// the last block's fixed-order sum over blocks of one pass's partials
// ([blocks, M, NV]: thread t < M x NV owns model t / NV, accumulator t % NV),
// each slot from 0.f in block order; pass 1 also writes zeros into every
// other slot of the ROWS rows of sums. The partials pass through the staging
// buffer in chunks of whole blocks, a multiple of 4 so that every chunk
// starts 16-byte aligned: each thread has all its 16-byte loads of a chunk
// in flight at once.
template <int NV, int PASS, int ROWS>
__device__ __forceinline__ void finish_sums(const float* partials, int M, float* stage,
                                            float* sums) {
  const int MN = M * NV, blocks = gridDim.x;
  const int chunk = (STAGE / MN) & ~3;  // whole blocks a stage
  float s = 0.f;
  for (int b0 = 0; b0 < blocks; b0 += chunk) {
    const int n = min(chunk, blocks - b0) * MN;
    const float* src = partials + b0 * MN;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* stage4 = reinterpret_cast<float4*>(stage);
    constexpr int PER = STAGE / 4 / THREADS;  // 16-byte loads a thread, at most
    float4 v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = threadIdx.x + k * THREADS;
      if (4 * e + 3 < n) v[k] = __ldcg(src4 + e);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = threadIdx.x + k * THREADS;
      if (4 * e + 3 < n) stage4[e] = v[k];
    }
    for (int e = (n & ~3) + threadIdx.x; e < n; e += THREADS) stage[e] = __ldcg(src + e);
    __syncthreads();
    if (threadIdx.x < MN) {
      // SUM_BATCH loads issued together, then added in block order: the
      // chain of additions no longer waits on one shared-memory load each
      int e = threadIdx.x;
      for (; e + (SUM_BATCH - 1) * MN < n; e += SUM_BATCH * MN) {
        float v[SUM_BATCH];
#pragma unroll
        for (int k = 0; k < SUM_BATCH; ++k) v[k] = stage[e + k * MN];
#pragma unroll
        for (int k = 0; k < SUM_BATCH; ++k) s += v[k];
      }
      for (; e < n; e += MN) s += stage[e];
    }
    __syncthreads();
  }
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
