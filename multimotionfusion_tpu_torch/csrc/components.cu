// K17 components: the largest 4-connected component of each label of an
// [L, H, W] mask stack, and its size.
//
// Replaces: multimotionfusion_tpu/segmentation/components.py:61
//   keep_largest_components_batched (with :19 connected_components' sweep).
// Bound on an H100: neither bytes (L*H*W mask bytes in and out) nor
//   operations (64 sweeps of 5 loads and 4 mins per cell): the 64 sweeps are
//   a chain of block barriers, so the kernel is bound by their latency.
// Design: one block per label. The label image sits in shared memory,
//   double-buffered: each sweep reads plane A and writes plane B, then the
//   block synchronises and swaps, which is the reference's Jacobi update
//   (lax.scan over whole-image mins), not an in-place Gauss-Seidel update
//   that would converge in fewer sweeps and hand out other labels. Labels are
//   int16 (the sentinel h*w included); exactly `iters` sweeps run. Then a
//   shared-memory histogram of the label ids (integer atomics: order-free), a
//   first-index argmax over ids 0..h*w-1 (jnp.argmax over sizes[:, :-1]), and
//   the kept mask. A grid whose planes and histogram do not fit in one
//   block's shared memory (beyond ~24,900 cells) passes a global scratch of
//   the same layout with int32 labels instead. Integer work only: the result
//   equals the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;

template <typename L>
__device__ void largest(const unsigned char* __restrict__ mask_g, int h, int w, int iters,
                        int* sizes, L* a, L* b, unsigned char* m, bool copy_mask,
                        bool* __restrict__ keep, int* __restrict__ size_out) {
  __shared__ int red_v[THREADS];
  __shared__ int red_i[THREADS];
  const int n = h * w;
  const int big = n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    unsigned char v = mask_g[i];
    if (copy_mask) m[i] = v;
    a[i] = v ? (L)i : (L)big;
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int v = big;
      if (m[i]) {
        int y = i / w, x = i - y * w;
        v = a[i];
        if (y > 0) v = min(v, (int)a[i - w]);
        if (y < h - 1) v = min(v, (int)a[i + w]);
        if (x > 0) v = min(v, (int)a[i - 1]);
        if (x < w - 1) v = min(v, (int)a[i + 1]);
      }
      b[i] = (L)v;
    }
    __syncthreads();
    L* t = a;
    a = b;
    b = t;
  }
  for (int i = threadIdx.x; i <= n; i += blockDim.x) sizes[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (m[i]) atomicAdd(&sizes[(int)a[i]], 1);
  __syncthreads();
  // first argmax over ids 0..n-1: the largest count, ties to the lower id
  int bv = -1, bi = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int v = sizes[i];
    if (v > bv) {
      bv = v;
      bi = i;
    }
  }
  red_v[threadIdx.x] = bv;
  red_i[threadIdx.x] = bi;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      int ov = red_v[threadIdx.x + s], oi = red_i[threadIdx.x + s];
      if (ov > red_v[threadIdx.x] || (ov == red_v[threadIdx.x] && oi < red_i[threadIdx.x])) {
        red_v[threadIdx.x] = ov;
        red_i[threadIdx.x] = oi;
      }
    }
    __syncthreads();
  }
  const int best = red_i[0];
  for (int i = threadIdx.x; i < n; i += blockDim.x) keep[i] = m[i] && (int)a[i] == best;
  if (threadIdx.x == 0) *size_out = sizes[best];
}

__global__ void components_smem(const unsigned char* __restrict__ masks, int h, int w, int iters,
                                 bool* __restrict__ keep, int* __restrict__ sizes_out) {
  extern __shared__ int smem[];
  const int n = h * w;
  const int l = blockIdx.x;
  int* sizes = smem;
  int16_t* a = reinterpret_cast<int16_t*>(sizes + n + 1);
  int16_t* b = a + n;
  unsigned char* m = reinterpret_cast<unsigned char*>(b + n);
  largest<int16_t>(masks + (size_t)l * n, h, w, iters, sizes, a, b, m, true,
                   keep + (size_t)l * n, sizes_out + l);
}

__global__ void components_global(const unsigned char* __restrict__ masks, int h, int w,
                                  int iters, int* __restrict__ scratch, bool* __restrict__ keep,
                                  int* __restrict__ sizes_out) {
  const int n = h * w;
  const int l = blockIdx.x;
  int* sizes = scratch + (size_t)l * (3 * n + 1);
  const unsigned char* mg = masks + (size_t)l * n;
  largest<int>(mg, h, w, iters, sizes, sizes + n + 1, sizes + 2 * n + 1,
               const_cast<unsigned char*>(mg), false, keep + (size_t)l * n, sizes_out + l);
}

}  // namespace

extern "C" int mmf_components(const bool* masks, int L, int H, int W, int iters, int* scratch,
                              bool* keep, int* sizes, cudaStream_t stream) {
  // scratch: null when the int16 planes, the mask and the histogram fit in
  // shared memory (the wrapper decides), else [L, 3*H*W + 1] int32
  const int n = H * W;
  const unsigned char* mk = reinterpret_cast<const unsigned char*>(masks);
  if (L <= 0) return (int)cudaGetLastError();
  if (scratch != nullptr) {
    components_global<<<L, THREADS, 0, stream>>>(mk, H, W, iters, scratch, keep, sizes);
  } else {
    if (n >= (1 << 15)) return (int)cudaErrorInvalidValue;
    int bytes = 4 * (n + 1) + 2 * n * (int)sizeof(int16_t) + n;
    cudaFuncSetAttribute(components_smem, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    components_smem<<<L, THREADS, bytes, stream>>>(mk, H, W, iters, keep, sizes);
  }
  return (int)cudaGetLastError();
}
