// The last-block tail shared by the kernels whose blocks each write
// partials and whose last block finishes the work in the same launch: K4
// gn_reduce and K11 gn_multi (through gn_sums.cuh) and K3's SO(3) iteration
// (gn_step.cu). last_block draws the ticket; sum_partials sums the partials
// in block order. Each source keeps its own ticket counters, 0 between
// launches; a kernel that uses one must run on one stream at a time.

#pragma once

#include <cuda_runtime.h>

namespace {

// true in the block that draws the last ticket, once every block's partials
// are visible; that block sets the counter back to 0. The barrier orders the
// block's partial writes before thread 0's fence, which makes them visible
// to the device before its ticket (the pattern of a cooperative grid sync).
// Every thread of the block must call it.
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

// the last block's fixed-order sum over the grid's blocks of partials
// [blocks, stride]: thread t < cols returns column t's sum, from 0.f in
// block order (the other threads return 0.f). The partials pass through
// `stage` (STAGE floats, 16-byte aligned) in chunks of whole blocks, a
// multiple of 4 so that every chunk starts 16-byte aligned: each of the NT
// threads has all its 16-byte loads of a chunk in flight at once. Then
// BATCH staged values are loaded together and added in block order, so the
// chain of additions does not wait on one shared-memory load each. Every
// thread of the block must call it.
template <int NT, int STAGE, int BATCH>
__device__ __forceinline__ float sum_partials(const float* partials, int stride, int cols,
                                              float* stage) {
  const int blocks = gridDim.x;
  const int chunk = (STAGE / stride) & ~3;  // whole blocks a stage
  float s = 0.f;
  for (int b0 = 0; b0 < blocks; b0 += chunk) {
    const int n = min(chunk, blocks - b0) * stride;
    const float* src = partials + b0 * stride;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* stage4 = reinterpret_cast<float4*>(stage);
    constexpr int PER = STAGE / 4 / NT;  // 16-byte loads a thread, at most
    float4 v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = threadIdx.x + k * NT;
      if (4 * e + 3 < n) v[k] = __ldcg(src4 + e);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = threadIdx.x + k * NT;
      if (4 * e + 3 < n) stage4[e] = v[k];
    }
    for (int e = (n & ~3) + threadIdx.x; e < n; e += NT) stage[e] = __ldcg(src + e);
    __syncthreads();
    if (threadIdx.x < cols) {
      int e = threadIdx.x;
      for (; e + (BATCH - 1) * stride < n; e += BATCH * stride) {
        float w[BATCH];
#pragma unroll
        for (int k = 0; k < BATCH; ++k) w[k] = stage[e + k * stride];
#pragma unroll
        for (int k = 0; k < BATCH; ++k) s += w[k];
      }
      for (; e < n; e += stride) s += stage[e];
    }
    __syncthreads();
  }
  return s;
}

}  // namespace
