// K17 components: the largest 4-connected component of each label of an
// [L, H, W] mask stack, and its size.
//
// Replaces: multimotionfusion_tpu/segmentation/components.py:61
//   keep_largest_components_batched (with :19 connected_components' sweep).
// What it computes: `iters` (64) Jacobi sweeps of 4-neighbour min-label
//   propagation (a cell's label is its flat index in the mask, h*w outside;
//   each sweep reads the previous sweep's labels only), the size histogram
//   of the labels, the first argmax over ids 0..h*w-1 (jnp.argmax over
//   sizes[:, :-1]) and the kept mask.
// Why tiling is exact: after k sweeps a mask cell's label is the least
//   flat index over the mask cells that a 4-connected path of length <= k
//   inside the mask reaches from it. A path of length <= h from a tile's
//   interior stays within h cells of the tile. So a block that loads its
//   tile plus a halo of h cells (cells outside the image count as not in
//   the mask), runs s <= h sweeps on that region alone (cells beyond the
//   region count as not in the mask) and writes the interior back has the
//   global sweeps' result there exactly: a wrong value at the region's edge
//   moves one cell a sweep and reaches the interior only after h + 1.
//   ceil(iters / h) such passes, each reading the previous pass's label
//   planes from global memory, are the `iters` sweeps.
// Early exit: a sweep that changes no cell of the block's region leaves it
//   at a fixed point of the local operator, so the pass's later sweeps
//   would change nothing there; that block skips them (every pass runs).
// Sizes and argmax, order-free: the last pass's epilogue adds each kept
//   cell to a zeroed [L, h*w + 1] int32 histogram with integer atomics
//   (aggregated in the warp by __match_any_sync); one kernel over the bins
//   packs (count << 32) | (h*w - 1 - id) and takes a 64-bit atomicMax per
//   label (the largest count, ties to the lower id, as the first argmax);
//   the keep pass writes the mask and sizes[l]. One cudaMemsetAsync zeroes
//   the histogram and the words; nothing is read back on the host.
// Bound on an H100: 64 x 9 integer operations a cell (the sweeps) and the
//   masks in and out; the sweeps run in shared memory with a halo overhead
//   of ((tile + 2h) / tile)^2 (2.25 at 64-cell tiles) and a block barrier a
//   sweep. Tiles of 64 x 64 (h = 16, 96 x 96 regions, 4 passes) give 560
//   blocks at 640 x 480 with L = 7; the CRF grid's smaller stacks take
//   32 x 32 tiles (the wrapper chooses). Integer work only: the result
//   equals the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STRIP = 16;  // rows one thread sweeps, top to bottom

// One Jacobi sweep of thread (x, strip)'s cells, column x and rows [r0,
// r0 + STRIP) of the region, from plane a into plane b: up/cur/down slide
// down the column, so a cell costs three loads and a store. a and b never
// overlap, so the loads may run ahead of the stores. Whether a cell changed.
__device__ __forceinline__ bool sweep_strip(const int* __restrict__ a, int* __restrict__ b, int rw,
                                            int x, int r0, int big) {
  bool changed = false;
  int up = r0 > 0 ? a[(r0 - 1) * rw + x] : big;
  int cur = a[r0 * rw + x];
#pragma unroll
  for (int i = 0; i < STRIP; ++i) {
    const int y = r0 + i;
    const int down = y + 1 < rw ? a[(y + 1) * rw + x] : big;
    const int left = x > 0 ? a[y * rw + x - 1] : big;
    const int right = x < rw - 1 ? a[y * rw + x + 1] : big;
    if (cur != big) {  // a mask cell
      const int v = min(min(cur, min(up, down)), min(left, right));
      changed |= v != cur;
      b[y * rw + x] = v;
    }
    up = cur;
    cur = down;
  }
  return changed;
}

// One pass: load the region of tile (blockIdx.x, blockIdx.y) of label
// blockIdx.z with a halo of `halo` cells (from the masks when lab_in is
// null, else from the previous pass's labels), run `sweeps` Jacobi sweeps
// in shared memory (two planes), write the interior to lab_out; with a
// histogram, count every interior mask cell at its label.
__global__ void sweep_pass(const unsigned char* __restrict__ masks, const int* __restrict__ lab_in,
                           int* __restrict__ lab_out, int* __restrict__ hist, int h, int w,
                           int tile, int halo, int sweeps) {
  extern __shared__ int plane[];
  const int rw = tile + 2 * halo;
  int* a = plane;
  int* b = plane + rw * rw;
  const int n = h * w, big = n;
  const size_t base = (size_t)blockIdx.z * n;
  const int y0 = blockIdx.y * tile - halo, x0 = blockIdx.x * tile - halo;
  const int nt = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int r0 = threadIdx.y * STRIP;  // rw is a multiple of STRIP
  const int gx = x0 + (int)threadIdx.x;
  for (int ry = r0; ry < r0 + STRIP; ++ry) {
    const int gy = y0 + ry;
    int v = big;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const int g = gy * w + gx;
      v = lab_in != nullptr ? lab_in[base + g] : (masks[base + g] ? g : big);
    }
    a[ry * rw + threadIdx.x] = v;
    b[ry * rw + threadIdx.x] = v;  // cells outside the mask are never written again
  }
  __syncthreads();
  for (int s = 0; s < sweeps; ++s) {
    const bool changed = sweep_strip(a, b, rw, threadIdx.x, r0, big);
    int* t = a;
    a = b;
    b = t;
    if (!__syncthreads_or(changed)) break;  // a fixed point: the rest change nothing
  }
  const int tn = tile * tile;
  const int lane = tid & 31;
  for (int i0 = 0; i0 < tn; i0 += nt) {  // every lane of a (full) warp runs each trip
    const int i = i0 + tid;
    const int ty = i / tile, tx = i - ty * tile;
    const int gy = blockIdx.y * tile + ty, gx = blockIdx.x * tile + tx;
    const bool inside = i < tn && gy < h && gx < w;
    const int v = inside ? a[(ty + halo) * rw + tx + halo] : big;
    if (inside) lab_out[base + gy * w + gx] = v;
    if (hist != nullptr) {
      const bool counted = inside && v != big;
      const unsigned key = counted ? (unsigned)v : (0x80000000u | (unsigned)lane);
      const unsigned group = __match_any_sync(0xffffffffu, key);
      if (counted && lane == __ffs(group) - 1)
        atomicAdd(hist + (size_t)blockIdx.z * (n + 1) + v, __popc(group));
    }
  }
}

// the packed first argmax of each label's histogram over ids 0..n-1
__global__ void pick(const int* __restrict__ hist, int n, unsigned long long* __restrict__ best) {
  __shared__ unsigned long long part[32];
  const int* hl = hist + (size_t)blockIdx.y * (n + 1);
  unsigned long long m = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int c = hl[i];
    if (c > 0) {
      const unsigned long long v = ((unsigned long long)c << 32) | (unsigned)(n - 1 - i);
      m = v > m ? v : m;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, m, off);
    m = o > m ? o : m;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x >> 5) ? part[lane] : 0ull;
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_down_sync(0xffffffffu, m, off);
      m = o > m ? o : m;
    }
    if (lane == 0 && m != 0) atomicMax(best + blockIdx.y, m);
  }
}

// keep[l] = (label == the chosen id); sizes[l] = its count (0 and id 0 for
// a label without mask cells, as argmax over zeros)
__global__ void keep_pass(const int* __restrict__ lab, int n, const unsigned long long* __restrict__ best,
                          bool* __restrict__ keep, int* __restrict__ sizes) {
  const int l = blockIdx.y;
  const unsigned long long word = best[l];
  const int id = word != 0 ? (n - 1) - (int)(unsigned)(word & 0xffffffffull) : 0;
  const size_t base = (size_t)l * n;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    keep[base + i] = lab[base + i] == id;  // cells outside the mask hold n > id
  if (blockIdx.x == 0 && threadIdx.x == 0) sizes[l] = (int)(word >> 32);
}

int g_smem_set = 0;

}  // namespace

extern "C" int mmf_components(const bool* masks, int L, int H, int W, int iters, int tile,
                              int halo, int* planes, int* counts, bool* keep, int* sizes,
                              cudaStream_t stream) {
  // planes: [2, L, H*W] int32 (the passes' labels, ping-ponged); counts:
  // [2L + L(H*W + 1)] int32, the L 64-bit argmax words then the histogram
  if (L <= 0) return (int)cudaGetLastError();
  const int n = H * W;
  const int rw = tile + 2 * halo;
  const int strips = rw / STRIP;
  const int smem = 2 * rw * rw * (int)sizeof(int);
  if (tile <= 0 || halo <= 0 || rw % STRIP != 0 || rw * strips > 1024 || (rw * strips) % 32 != 0
      || smem > 232448)
    return (int)cudaErrorInvalidValue;
  if (smem > g_smem_set) {
    cudaError_t e = cudaFuncSetAttribute(sweep_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return (int)e;
    g_smem_set = smem;
  }
  unsigned long long* best = reinterpret_cast<unsigned long long*>(counts);
  int* hist = counts + 2 * L;
  cudaMemsetAsync(counts, 0, sizeof(int) * ((size_t)2 * L + (size_t)L * (n + 1)), stream);
  const int passes = iters > 0 ? (iters + halo - 1) / halo : 1;
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile, L);
  const dim3 block(rw, strips);
  const unsigned char* mk = reinterpret_cast<const unsigned char*>(masks);
  const int* in = nullptr;
  int* out = planes;
  for (int k = 0; k < passes; ++k) {
    const int sweeps = min(halo, iters - k * halo);
    sweep_pass<<<grid, block, smem, stream>>>(mk, in, out, k == passes - 1 ? hist : nullptr, H, W,
                                              tile, halo, sweeps > 0 ? sweeps : 0);
    in = out;
    out = out == planes ? planes + (size_t)L * n : planes;
  }
  const int per = 256 * 8;
  pick<<<dim3((n + per - 1) / per, L), 256, 0, stream>>>(hist, n, best);
  keep_pass<<<dim3((n + per - 1) / per, L), 256, 0, stream>>>(in, n, best, keep, sizes);
  return (int)cudaGetLastError();
}
