// K24a slic: the SLIC superpixels of the legacy CRF segmentation, and K24b:
// the superpixel means of a stack of images and the labels back on the pixels.
//
// Replaces: multimotionfusion_tpu/segmentation/slic.py:26 slic (:47 centres'
//   scatter means, :61-76 the 3x3 assignment), :83 downsample_to_superpixels
//   (and legacy_crf.py:104-107, the depth, ICP and confidence means), :95
//   upsample_from_superpixels (with legacy_crf.py:146's one mask per label).
// Bound on an H100: launch latency and the ordered sums. At 640x480 a pass
//   reads 3.7 MB of colour and 1.2 MB of labels; the assignment does 9
//   candidates of ~20 flops per pixel. Microseconds of bytes and flops.
// Design: no float atomics. The centre of superpixel s is the mean over its
//   pixels summed in row-major pixel order, the order of the reference's
//   scatter-add on the CPU, so kernel, plain version and reference agree to
//   the last bit. One warp per superpixel scans a window of the label image
//   row by row, 32 pixels at a time: a ballot marks the pixels of s, and
//   every lane adds the marked pixels' values in lane order (shuffles). The
//   window: a label moves at most one cell per assignment (its 3x3
//   neighbourhood), so after t assignments every pixel of s lies within t
//   cells of s's grid cell; the caller passes t as `radius` (0 for the
//   regular grid, up to the iteration count). The assignment is one thread
//   per pixel over the 9 candidates in (dy, dx) order with strict <, every
//   term in the order of slic.py (built with -fmad=false). The means of K24b
//   scan the same window with one warp per (image, superpixel) and divide
//   by the count they find (the count the centres hold). All launches are
//   enqueued back to back; nothing is read back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ inline int grid_label(int y, int x, int gy, int gx, int sp) {
  int cy = min(max((int)((float)y / (float)sp), 0), gy - 1);
  int cx = min(max((int)((float)x / (float)sp), 0), gx - 1);
  return cy * gx + cx;
}

struct Window {
  int y0, y1, x0, x1;
};

// the pixels within `radius` cells of superpixel s's grid cell (the last
// row and column of cells also own the pixels beyond gy * sp, gx * sp)
__device__ inline Window window_of(int s, int H, int W, int gy, int gx, int sp, int radius) {
  int cy = s / gx, cx = s % gx;
  Window wd;
  wd.y0 = max(cy - radius, 0) * sp;
  wd.y1 = cy + radius >= gy - 1 ? H : (cy + radius + 1) * sp;
  wd.x0 = max(cx - radius, 0) * sp;
  wd.x1 = cx + radius >= gx - 1 ? W : (cx + radius + 1) * sp;
  return wd;
}

__device__ inline int label_at(const int* labels, int y, int x, int W, int gy, int gx, int sp) {
  return labels != nullptr ? labels[y * W + x] : grid_label(y, x, gy, gx, sp);
}

// one warp per superpixel: (mean r, g, b, mean x, y, count) in row-major order
__global__ void __launch_bounds__(THREADS)
centres(const float* __restrict__ image, const int* __restrict__ labels, int H, int W, int gy,
        int gx, int sp, int radius, float* __restrict__ out) {
  int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  int lane = threadIdx.x & 31;
  if (s >= gy * gx) return;
  Window wd = window_of(s, H, W, gy, gx, sp, radius);
  float cnt = 0.f, r = 0.f, g = 0.f, b = 0.f, sx = 0.f, sy = 0.f;
  for (int y = wd.y0; y < wd.y1; ++y) {
    for (int xb = wd.x0; xb < wd.x1; xb += 32) {
      int x = xb + lane;
      bool mine = x < wd.x1 && label_at(labels, y, x, W, gy, gx, sp) == s;
      unsigned m = __ballot_sync(FULL, mine);
      if (m == 0u) continue;
      int p = mine ? y * W + x : 0;
      float vr = image[3 * p], vg = image[3 * p + 1], vb = image[3 * p + 2];
      while (m != 0u) {
        int src = __ffs(m) - 1;
        m &= m - 1u;
        cnt = cnt + 1.f;
        r = r + __shfl_sync(FULL, vr, src);
        g = g + __shfl_sync(FULL, vg, src);
        b = b + __shfl_sync(FULL, vb, src);
        sx = sx + (float)(xb + src);
        sy = sy + (float)y;
      }
    }
  }
  if (lane == 0) {
    float d = fmaxf(cnt, 1.f);
    float* o = out + 6 * s;
    o[0] = r / d;
    o[1] = g / d;
    o[2] = b / d;
    o[3] = sx / d;
    o[4] = sy / d;
    o[5] = cnt;
  }
}

// one thread per pixel: the best of the 3x3 centres around its label's cell
__global__ void __launch_bounds__(THREADS)
assign(const float* __restrict__ image, const int* __restrict__ labels,
       const float* __restrict__ cen, int H, int W, int gy, int gx, int sp, float coh,
       float sqrt_c, float spf, int* __restrict__ out) {
  int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= H * W) return;
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
}

// one warp per (image, superpixel): the mean of the image over the superpixel
__global__ void __launch_bounds__(THREADS)
means(const float* __restrict__ images, int n, const int* __restrict__ labels, int H, int W,
      int gy, int gx, int sp, int radius, float* __restrict__ out) {
  int S = gy * gx;
  int task = blockIdx.x * WARPS + (threadIdx.x >> 5);
  int lane = threadIdx.x & 31;
  if (task >= n * S) return;
  int k = task / S, s = task % S;
  const float* img = images + (size_t)k * H * W;
  Window wd = window_of(s, H, W, gy, gx, sp, radius);
  float cnt = 0.f, acc = 0.f;
  for (int y = wd.y0; y < wd.y1; ++y) {
    for (int xb = wd.x0; xb < wd.x1; xb += 32) {
      int x = xb + lane;
      bool mine = x < wd.x1 && labels[y * W + x] == s;
      unsigned m = __ballot_sync(FULL, mine);
      if (m == 0u) continue;
      float v = mine ? img[y * W + x] : 0.f;
      while (m != 0u) {
        int src = __ffs(m) - 1;
        m &= m - 1u;
        cnt = cnt + 1.f;
        acc = acc + __shfl_sync(FULL, v, src);
      }
    }
  }
  if (lane == 0) out[(size_t)k * S + s] = acc / fmaxf(cnt, 1.f);
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

extern "C" int mmf_slic_centres(const float* image, const int* labels, int H, int W, int gy,
                                int gx, int sp, int radius, float* out, cudaStream_t stream) {
  int S = gy * gx;
  centres<<<(S + WARPS - 1) / WARPS, THREADS, 0, stream>>>(image, labels, H, W, gy, gx, sp,
                                                           radius, out);
  return (int)cudaGetLastError();
}

extern "C" int mmf_slic_assign(const float* image, const int* labels, const float* cen, int H,
                               int W, int gy, int gx, int sp, float coh, float sqrt_c, float spf,
                               int* out, cudaStream_t stream) {
  assign<<<(H * W + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      image, labels, cen, H, W, gy, gx, sp, coh, sqrt_c, spf, out);
  return (int)cudaGetLastError();
}

extern "C" int mmf_sp_means(const float* images, int n, const int* labels, int H, int W, int gy,
                            int gx, int sp, int radius, float* out, cudaStream_t stream) {
  int tasks = n * gy * gx;
  if (tasks > 0)
    means<<<(tasks + WARPS - 1) / WARPS, THREADS, 0, stream>>>(images, n, labels, H, W, gy, gx,
                                                              sp, radius, out);
  return (int)cudaGetLastError();
}

extern "C" int mmf_sp_upsample(const int* lbl_sp, const int* labels, int n, int nl, bool* out,
                               cudaStream_t stream) {
  upsample<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(lbl_sp, labels, n, nl, out);
  return (int)cudaGetLastError();
}
