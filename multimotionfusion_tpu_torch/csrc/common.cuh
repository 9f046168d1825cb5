// Device helpers shared by the kernels of csrc/ (included inside each
// source's anonymous namespace; build_all rebuilds every source when this
// header changes).

// float <-> uint32 with the same order (for integer min/max and sort keys)
__device__ inline unsigned ord32(float f) {
  unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ inline float unord32(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Exclusive prefix sum of v over a block of exactly 1024 threads (32 warps);
// *total gets the block's sum. Every thread must call it.
__device__ int block_exclusive_scan(int v, int* warp_sums /* [32] shared */, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int excl = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[31];
  __syncthreads();
  return excl;
}
