// K24a slic: the SLIC superpixels of the legacy CRF segmentation, and K24b:
// the superpixel means of a stack of images and the labels back on the pixels.
//
// Replaces: multimotionfusion_tpu/segmentation/slic.py:26 slic (:47 centres'
//   scatter means, :61-76 the 3x3 assignment), :83 downsample_to_superpixels
//   (and legacy_crf.py:104-107, the depth, ICP and confidence means), :95
//   upsample_from_superpixels (with legacy_crf.py:146's one mask per label).
// Bound on an H100: launch latency and the ordered sums. At 640x480 a pass
//   reads 3.7 MB of colour and 1.2 MB of labels; the assignment does 9
//   candidates of ~20 flops per pixel. Microseconds of bytes and flops; a
//   superpixel's sums are chains of ~256-600 dependent adds.
// Design: no float atomics. The centre of superpixel s is the mean over its
//   pixels summed in row-major pixel order, the order of the reference's
//   scatter-add on the CPU, so kernel, plain version and reference agree to
//   the last bit. One warp per superpixel reads the labels of s's bounding
//   box once (pass A): 32 box pixels at a time in row-major order, a ballot
//   marks s's and a popc prefix gives each its slot in the warp's shared
//   memory. The centres stage r, g, b, x, y there as they go (the colour is
//   loaded with the label); the means list the pixel indices, then stage
//   the images' values a slice at a time (coalesced loads, the next slice's
//   in flight while the lanes add). Pass B: lane k adds quantity k's staged
//   values one by one (centres: lanes 0-4 r, g, b, x, y; means: lane k image
//   k, by groups of 32 images), so every sum is the sequential row-major
//   sum; the count is the number of slots. A superpixel larger than the
//   shared memory is summed a part at a time. The bounding boxes, [S, 4]
//   int32 (y min, x min, y max, x max; all -1 for an empty label), come from
//   integer atomics, whose result is the same in any order: the assignment
//   folds each pixel's new label into them in its epilogue, one atomic per
//   field for each run of equal labels in a warp's row; `label_bounds` does
//   the same for a label image handed in from outside; the regular grid's
//   boxes are its cells (closed form). The buffer is reset by one memset
//   (0xff bytes: -1, the largest value as unsigned, so the minima are
//   unsigned atomics). The assignment is one thread per pixel over the 9
//   candidates in (dy, dx) order with strict <, every term in the order of
//   slic.py (built with -fmad=false). All launches are enqueued back to
//   back; nothing is read back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
// the superpixel kernels: one warp per superpixel, SP_WARPS to a block
constexpr int SP_WARPS = 4;
constexpr int ROW = 521;     // the centres' staged pixels a flush (odd: no bank conflicts)
constexpr int LIST = 1024;   // the means' listed pixel indices a flush
constexpr int STAGE = 1024;  // the means' staged values
constexpr int UNROLL = STAGE / 32;  // values a lane loads to stage a slice

__device__ inline int grid_label(int y, int x, int gy, int gx, int sp) {
  int cy = min(max((int)((float)y / (float)sp), 0), gy - 1);
  int cx = min(max((int)((float)x / (float)sp), 0), gx - 1);
  return cy * gx + cx;
}

__device__ inline int label_at(const int* labels, int y, int x, int W, int gy, int gx, int sp) {
  return labels != nullptr ? labels[y * W + x] : grid_label(y, x, gy, gx, sp);
}

struct Window {
  int y0, y1, x0, x1;  // [y0, y1) x [x0, x1)
};

// superpixel s's bounding box; without bounds its grid cell (the last row
// and column of cells also own the pixels beyond gy * sp, gx * sp)
__device__ inline Window window_of(int s, const int* bounds, int H, int W, int gy, int gx,
                                   int sp) {
  Window wd;
  if (bounds != nullptr) {
    int4 b = reinterpret_cast<const int4*>(bounds)[s];
    if (b.z < 0) return Window{0, 0, 0, 0};  // empty
    wd.y0 = b.x;
    wd.x0 = b.y;
    wd.y1 = b.z + 1;
    wd.x1 = b.w + 1;
    return wd;
  }
  int cy = s / gx, cx = s % gx;
  wd.y0 = cy * sp;
  wd.y1 = cy == gy - 1 ? H : (cy + 1) * sp;
  wd.x0 = cx * sp;
  wd.x1 = cx == gx - 1 ? W : (cx + 1) * sp;
  return wd;
}

// The lanes of `act` (a prefix of the warp: consecutive pixels) fold their
// pixel (y, x) into their label l's bounds: one atomic per field for each
// run of equal labels within a row, from the run's first lane. Labels
// outside [0, S) take part in the runs and are left out.
__device__ inline void add_bounds(unsigned act, int l, int y, int x, int S, int* bounds) {
  int lane = threadIdx.x & 31;
  int prev = __shfl_up_sync(act, l, 1);
  bool head = lane == 0 || prev != l || x == 0;
  unsigned heads = __ballot_sync(act, head);
  if (!head || l < 0 || l >= S) return;
  unsigned later = heads & ~((2u << lane) - 1u);
  int end = later != 0u ? __ffs(later) - 2 : 31 - __clz(act);  // the run's last lane
  int* b = bounds + 4 * l;
  atomicMin(reinterpret_cast<unsigned*>(b), (unsigned)y);
  atomicMin(reinterpret_cast<unsigned*>(b + 1), (unsigned)x);
  atomicMax(b + 2, y);
  atomicMax(b + 3, x + end - lane);
}

// Pass A of superpixel s: its box's pixels 32 at a time in row-major box
// order (a run may span rows of a narrow box; each lane steps its pixel 32
// on), Pass::BATCH runs' labels loaded at once with whatever the pass loads
// per pixel (`pass.load`); a ballot marks s's pixels and a popc prefix gives
// each its slot, in row-major order (`pass.put`). `pass.flush(len)` (pass
// B) consumes the slots whenever another batch might not fit and at the end
// (the last time possibly with none). Returns the pixel count. Every lane
// calls it with the same s; pass B is inlined at one call site.
template <class Pass>
__device__ __forceinline__ int scan(int s, const int* labels, Window wd, int W, int gy, int gx,
                                    int sp, Pass& pass) {
  constexpr int BATCH = Pass::BATCH;
  int lane = threadIdx.x & 31;
  unsigned below = (1u << lane) - 1u;
  int bw = wd.x1 - wd.x0, bh = wd.y1 - wd.y0;
  int runs = bw > 0 && bh > 0 ? (bh * bw + 31) >> 5 : 0;
  int dy = bw > 0 ? 32 / bw : 0, dx = bw > 0 ? 32 % bw : 0;
  int y = bw > 0 ? wd.y0 + lane / bw : 0, x = bw > 0 ? wd.x0 + lane % bw : 0;
  int len = 0, total = 0;
  for (int r0 = 0;; r0 += BATCH) {
    bool done = r0 >= runs;
    if (done || len > Pass::CAPACITY - 32 * BATCH) {
      __syncwarp();
      pass.flush(len);
      __syncwarp();
      total += len;
      len = 0;
      if (done) break;
    }
    int pix[BATCH], ys[BATCH], xs[BATCH];
    bool mine[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      bool in = y < wd.y1;
      ys[j] = y;
      xs[j] = x;
      pix[j] = y * W + x;
      mine[j] = in && label_at(labels, y, x, W, gy, gx, sp) == s;
      pass.load(j, in, pix[j]);
      x += dx;
      y += dy;
      if (x >= wd.x1) {
        x -= bw;
        ++y;
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      unsigned m = __ballot_sync(FULL, mine[j]);
      if (mine[j]) pass.put(j, len + __popc(m & below), pix[j], ys[j], xs[j]);
      len += __popc(m);
    }
  }
  return total;
}

// The centres' passes: pass A loads every box pixel's colour with its label
// and stages s's pixels' r, g, b, x, y as five rows of ROW floats; pass B:
// lane q < 5 adds row q one by one.
struct CentrePass {
  static constexpr int CAPACITY = ROW, BATCH = 8;
  const float* image;
  float* stage;  // [5][ROW]
  float acc;
  float r[BATCH], g[BATCH], b[BATCH];
  __device__ __forceinline__ void load(int j, bool in, int p) {
    r[j] = in ? image[3 * p] : 0.f;
    g[j] = in ? image[3 * p + 1] : 0.f;
    b[j] = in ? image[3 * p + 2] : 0.f;
  }
  __device__ __forceinline__ void put(int j, int slot, int, int y, int x) {
    stage[slot] = r[j];
    stage[ROW + slot] = g[j];
    stage[2 * ROW + slot] = b[j];
    stage[3 * ROW + slot] = (float)x;
    stage[4 * ROW + slot] = (float)y;
  }
  __device__ __forceinline__ void flush(int len) {
    int lane = threadIdx.x & 31;
    if (lane < 5) {
      const float* q = stage + lane * ROW;
#pragma unroll 8
      for (int i = 0; i < len; ++i) acc = acc + q[i];
    }
  }
};

// A slice of the means' list: value t (< nq * cnt <= STAGE) is image t /
// cnt (in float: exact for t < 2^12) at the slice's entry t % cnt, loaded
// by lane t % 32 into v[t / 32]; its slot in the stage is k * stride + i.
__device__ __forceinline__ void fetch(const int* list, int i0, int cnt, int nq, int stride,
                                      const float* images, size_t hw, float (&v)[UNROLL],
                                      int (&slot)[UNROLL]) {
  int lane = threadIdx.x & 31, n = nq * cnt;
  float inv = 1.f / (float)cnt;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    int t = 32 * u + lane;
    int k = (int)(((float)t + 0.5f) * inv), i = t - k * cnt;
    slot[u] = t < n ? k * stride + i : -1;
    v[u] = t < n ? images[(size_t)k * hw + list[i0 + i]] : 0.f;
  }
}

// The means' pass B: images k < nq (<= 32) at the listed pixels, added to
// `acc` (lane k's sum of image k) in list order; returns it. The list goes
// by slices: all lanes load a slice (coalesced, UNROLL loads in flight a
// lane) and stage it in shared memory, then lane k adds image k's staged
// values one by one while the next slice's loads are in flight. The
// images' rows are an odd number of floats apart, so the lanes' reads fall
// in distinct banks.
__device__ __forceinline__ float staged_sum(const int* list, int len, int nq, float* stage,
                                           const float* images, size_t hw, float acc) {
  int lane = threadIdx.x & 31;
  int stride = STAGE / nq;
  stride -= (stride & 1) ^ 1;
  float v[UNROLL];
  int slot[UNROLL];
  if (len > 0) fetch(list, 0, min(stride, len), nq, stride, images, hw, v, slot);
  for (int i0 = 0; i0 < len; i0 += stride) {
    int cnt = min(stride, len - i0);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (slot[u] >= 0) stage[slot[u]] = v[u];
    __syncwarp();
    int next = i0 + stride;
    if (next < len) fetch(list, next, min(stride, len - next), nq, stride, images, hw, v, slot);
    if (lane < nq) {
      const float* q = stage + lane * stride;
#pragma unroll 8
      for (int i = 0; i < cnt; ++i) acc = acc + q[i];
    }
    __syncwarp();
  }
  return acc;
}

// The means' passes: pass A lists s's pixel indices; pass B sums every
// image over the list (lane k images k, k + 32, ...) into out[k, s], the
// running sums kept there between lists.
struct MeanPass {
  static constexpr int CAPACITY = LIST, BATCH = 16;
  const float* images;
  size_t hw;
  int n, S, s;
  float* out;
  int* list;
  float* stage;
  bool first;
  __device__ __forceinline__ void load(int, bool, int) {}
  __device__ __forceinline__ void put(int, int slot, int p, int, int) { list[slot] = p; }
  __device__ __forceinline__ void flush(int len) {
    int lane = threadIdx.x & 31;
    for (int k0 = 0; k0 < n; k0 += 32) {
      int nq = min(32, n - k0);
      float* o = out + (size_t)(k0 + lane) * S + s;
      float acc = staged_sum(list, len, nq, stage, images + (size_t)k0 * hw, hw,
                             !first && lane < nq ? *o : 0.f);
      if (lane < nq) *o = acc;
    }
    first = false;
  }
};

// one warp per superpixel: (mean r, g, b, mean x, y, count) in row-major order
__global__ void __launch_bounds__(SP_WARPS * 32)
centres(const float* __restrict__ image, const int* __restrict__ labels,
        const int* __restrict__ bounds, int H, int W, int gy, int gx, int sp,
        float* __restrict__ out) {
  __shared__ float stages[SP_WARPS][5 * ROW];
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int s = blockIdx.x * SP_WARPS + warp;
  if (s >= gy * gx) return;
  CentrePass pass{image, stages[warp], 0.f};
  int cnt = scan(s, labels, window_of(s, bounds, H, W, gy, gx, sp), W, gy, gx, sp, pass);
  float c = (float)cnt;
  float d = fmaxf(c, 1.f);
  if (lane < 5) out[6 * s + lane] = pass.acc / d;
  if (lane == 5) out[6 * s + 5] = c;
}

// one thread per pixel: the best of the 3x3 centres around its label's cell;
// the epilogue folds the new label into `bounds` (reset to -1 before)
__global__ void __launch_bounds__(THREADS)
assign(const float* __restrict__ image, const int* __restrict__ labels,
       const float* __restrict__ cen, int H, int W, int gy, int gx, int sp, float coh,
       float sqrt_c, float spf, int* __restrict__ out, int* __restrict__ bounds) {
  int p = blockIdx.x * THREADS + threadIdx.x;
  bool in = p < H * W;
  unsigned act = __ballot_sync(FULL, in);
  if (!in) return;
  int y = p / W, x = p % W;
  int base = label_at(labels, y, x, W, gy, gx, sp);
  int bcy = min(max(base / gx, 0), gy - 1);
  int bcx = min(max(base % gx, 0), gx - 1);
  float ir = image[3 * p], ig = image[3 * p + 1], ib = image[3 * p + 2];
  float xf = (float)x, yf = (float)y;
  float best = __int_as_float(0x7f800000);
  int bl = base;
  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx) {
      int cid = min(max(bcy + dy, 0), gy - 1) * gx + min(max(bcx + dx, 0), gx - 1);
      const float* c = cen + 6 * cid;
      float d0 = ir - c[0], d1 = ig - c[1], d2 = ib - c[2];
      float dc = d0 * d0 + d1 * d1 + d2 * d2;
      float ex = xf - c[3], ey = yf - c[4];
      float dxs = ex * ex + ey * ey;
      float d = sqrtf(dc) + coh * sqrtf(dxs) * sqrt_c * 255.0f / spf;
      if (d < best) {
        best = d;
        bl = cid;
      }
    }
  }
  out[p] = bl;
  add_bounds(act, bl, y, x, gy * gx, bounds);
}

// one thread per pixel: the bounds of a label image
__global__ void __launch_bounds__(THREADS)
label_bounds(const int* __restrict__ labels, int n, int W, int S, int* __restrict__ bounds) {
  int p = blockIdx.x * THREADS + threadIdx.x;
  bool in = p < n;
  unsigned act = __ballot_sync(FULL, in);
  if (in) add_bounds(act, labels[p], p / W, p % W, S, bounds);
}

// one warp per superpixel: the mean of every image over it (bounds given)
__global__ void __launch_bounds__(SP_WARPS * 32)
means(const float* __restrict__ images, int n, const int* __restrict__ labels,
      const int* __restrict__ bounds, int H, int W, int gy, int gx, float* __restrict__ out) {
  __shared__ int lists[SP_WARPS][LIST];
  __shared__ float stages[SP_WARPS][STAGE];
  int S = gy * gx;
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int s = blockIdx.x * SP_WARPS + warp;
  if (s >= S) return;
  MeanPass pass{images, (size_t)H * W, n, S, s, out, lists[warp], stages[warp], true};
  int cnt = scan(s, labels, window_of(s, bounds, H, W, gy, gx, 0), W, gy, gx, 0, pass);
  float d = fmaxf((float)cnt, 1.f);
  for (int k = lane; k < n; k += 32) out[(size_t)k * S + s] = out[(size_t)k * S + s] / d;
}

// one thread per pixel: mask l of the pixel is (label of its superpixel == l)
__global__ void upsample(const int* __restrict__ lbl_sp, const int* __restrict__ labels, int n,
                         int nl, bool* __restrict__ out) {
  int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= n) return;
  int l = lbl_sp[labels[p]];
  for (int k = 0; k < nl; ++k) out[(size_t)k * n + p] = l == k;
}

}  // namespace

extern "C" int mmf_slic_centres(const float* image, const int* labels, const int* bounds, int H,
                                int W, int gy, int gx, int sp, float* out, cudaStream_t stream) {
  int S = gy * gx;
  centres<<<(S + SP_WARPS - 1) / SP_WARPS, SP_WARPS * 32, 0, stream>>>(image, labels, bounds, H,
                                                                       W, gy, gx, sp, out);
  return (int)cudaGetLastError();
}

extern "C" int mmf_slic_assign(const float* image, const int* labels, const float* cen, int H,
                               int W, int gy, int gx, int sp, float coh, float sqrt_c, float spf,
                               int* out, int* bounds, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(bounds, 0xff, sizeof(int) * 4 * (size_t)gy * gx, stream);
  if (e != cudaSuccess) return (int)e;
  assign<<<(H * W + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      image, labels, cen, H, W, gy, gx, sp, coh, sqrt_c, spf, out, bounds);
  return (int)cudaGetLastError();
}

extern "C" int mmf_slic_bounds(const int* labels, int n, int W, int S, int* bounds,
                               cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(bounds, 0xff, sizeof(int) * 4 * (size_t)S, stream);
  if (e != cudaSuccess) return (int)e;
  label_bounds<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(labels, n, W, S, bounds);
  return (int)cudaGetLastError();
}

extern "C" int mmf_sp_means(const float* images, int n, const int* labels, const int* bounds,
                            int H, int W, int gy, int gx, float* out, cudaStream_t stream) {
  int S = gy * gx;
  if (n > 0)
    means<<<(S + SP_WARPS - 1) / SP_WARPS, SP_WARPS * 32, 0, stream>>>(images, n, labels, bounds,
                                                                       H, W, gy, gx, out);
  return (int)cudaGetLastError();
}

extern "C" int mmf_sp_upsample(const int* lbl_sp, const int* labels, int n, int nl, bool* out,
                               cudaStream_t stream) {
  upsample<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(lbl_sp, labels, n, nl, out);
  return (int)cudaGetLastError();
}
