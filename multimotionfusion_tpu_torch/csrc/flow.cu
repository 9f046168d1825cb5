// K15 flow: the flow-CRF's dense Lucas-Kanade optical flow at the CRF scale.
//
// Replaces: multimotionfusion_tpu/segmentation/flow.py:100 dense_flow and
//   :18 _lk_refine, with ops/image.py:265 resize_bilinear (:247
//   _resize_matrix), :199 gaussian_blur and :104 pyr_down_gauss /
//   :129 build_pyramid folded in.
// Bound on an H100: neither. A 160x120 level is 77 KB a plane, all of it in
//   L2; per pixel and iteration the 9x9 box sums are ~200 operations, which
//   the card does in microseconds. The ~33 launches of a frame (their
//   latency, and the host's enqueue) are the cost.
// Design: mmf_flow_prep enqueues (1) one thread per CRF pixel and image:
//   the two-tap row and column resize (taps computed in double as numpy
//   computes _resize_matrix's rows) into a scratch plane, (2) the separable
//   sigma-1.25 blur, horizontal then vertical, zero padded, taps accumulated
//   from zero in order, (3) two validity-renormalised 5x5 Gaussian
//   downsamples. mmf_lk_level enqueues per level: lk_grad (central
//   differences, and the x2 bilinear upsample of the coarser flow), lk_tensor
//   (the 9x9 box sums of the structure tensor, det, the min-eigenvalue gate),
//   then per iteration lk_warp (the clamped bilinear warp and the temporal
//   difference) and lk_update (the box sums of gx*it and gy*it, the solve,
//   the +-2 px clamp), the flow double-buffered so that no block reads a flow
//   another block is updating. Every box sum adds its vertical taps first,
//   then the horizontal ones, each from zero in tap order, as the plain
//   version; with -fmad=false kernel and plain version agree to the last bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TB = 256;
constexpr int MAX_R = 8;

struct Taps {
  int i0, i1;
  float w0, w1;
};

// row k of the reference's _resize_matrix(n_in, n_out): its two nonzero taps
__device__ inline Taps resize_tap(int k, int n_in, int n_out) {
  double xs = ((double)k + 0.5) * ((double)n_in / (double)n_out) - 0.5;
  xs = fmin(fmax(xs, 0.0), (double)n_in - 1.0);
  double x0 = floor(xs);
  Taps t;
  t.i0 = (int)x0;
  float f = (float)(xs - x0);
  t.i1 = min(t.i0 + 1, n_in - 1);
  t.w0 = 1.0f - f;
  t.w1 = f;
  return t;
}

// bilinear resize of plane `src` [hi, wi] at output (y, x) of [ho, wo]: rows
// first, then columns
__device__ inline float resize_at(const float* __restrict__ src, int hi, int wi, int ho, int wo,
                                  int y, int x) {
  Taps ty = resize_tap(y, hi, ho);
  Taps tx = resize_tap(x, wi, wo);
  float r0 = ty.w0 * src[ty.i0 * wi + tx.i0] + ty.w1 * src[ty.i1 * wi + tx.i0];
  float r1 = ty.w0 * src[ty.i0 * wi + tx.i1] + ty.w1 * src[ty.i1 * wi + tx.i1];
  return tx.w0 * r0 + tx.w1 * r1;
}

struct Blur {
  float k[2 * MAX_R + 1];
};

// resize + horizontal blur pass: tmp[z] = hblur(resize(src_z))
__global__ void resize_hblur(const float* __restrict__ prev, const float* __restrict__ nxt, int H,
                             int W, int hc, int wc, Blur b, int r, float* __restrict__ tmp) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int z = blockIdx.y;
  if (i >= hc * wc) return;
  const float* src = z == 0 ? prev : nxt;
  int y = i / wc, x = i - y * wc;
  float acc = 0.f;
  for (int d = -r; d <= r; ++d) {
    int xx = x + d;
    if (xx < 0 || xx >= wc) continue;
    acc = acc + b.k[d + r] * resize_at(src, H, W, hc, wc, y, xx);
  }
  tmp[z * hc * wc + i] = acc;
}

__global__ void vblur(const float* __restrict__ tmp, int hc, int wc, Blur b, int r,
                      float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int z = blockIdx.y;
  if (i >= hc * wc) return;
  int y = i / wc, x = i - y * wc;
  const float* t = tmp + z * hc * wc;
  float acc = 0.f;
  for (int d = -r; d <= r; ++d) {
    int yy = y + d;
    if (yy < 0 || yy >= hc) continue;
    acc = acc + b.k[d + r] * t[yy * wc + x];
  }
  out[z * hc * wc + i] = acc;
}

// validity-renormalised 5x5 Gaussian downsample by 2 (gate 0): output (x, y)
// centred on input (2x, 2y), taps in row-major order
__global__ void pyr_down(const float* __restrict__ src, int h, int w, int ho, int wo,
                         float* __restrict__ dst) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int z = blockIdx.y;
  if (i >= ho * wo) return;
  const float g[5] = {1.f, 4.f, 6.f, 4.f, 1.f};
  int y = i / wo, x = i - y * wo;
  const float* s = src + z * h * w;
  float num = 0.f, den = 0.f;
  for (int oy = -2; oy <= 2; ++oy) {
    for (int ox = -2; ox <= 2; ++ox) {
      int yy = 2 * y + oy, xx = 2 * x + ox;
      float v = 0.f, valid = 0.f;
      if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
        v = s[yy * w + xx];
        valid = v > 0.f ? 1.f : 0.f;
      }
      float wt = g[oy + 2] * g[ox + 2];
      num = num + wt * (v * valid);
      den = den + wt * valid;
    }
  }
  dst[z * ho * wo + i] = den > 0.f ? num / fmaxf(den, 1e-12f) : 0.f;
}

// ------------------------------------------------------------ Lucas-Kanade

enum { GX = 0, GY, IXX, IXY, IYY, INV_DET, OK, IT, FA, FB };

// gradients and the initial flow (zeros, or the coarser flow x2 upsampled)
__global__ void lk_grad(const float* __restrict__ prev, const float* __restrict__ coarse, int h,
                        int w, int hp, int wp, float* __restrict__ s) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int n = h * w;
  if (i >= n) return;
  int y = i / w, x = i - y * w;
  float gx = 0.f, gy = 0.f;
  if (x > 0 && x < w - 1) gx = 0.5f * (prev[i + 1] - prev[i - 1]);
  if (y > 0 && y < h - 1) gy = 0.5f * (prev[i + w] - prev[i - w]);
  s[GX * n + i] = gx;
  s[GY * n + i] = gy;
  float fx = 0.f, fy = 0.f;
  if (coarse != nullptr) {
    fx = resize_at(coarse, hp, wp, h, w, y, x) * 2.0f;
    fy = resize_at(coarse + hp * wp, hp, wp, h, w, y, x) * 2.0f;
  }
  s[FA * n + i] = fx;
  s[(FA + 1) * n + i] = fy;
}

// the zero-padded 9x9 box sum of a * b at (y, x): vertical sums per column,
// then the horizontal sum, each from zero in tap order
__device__ inline float box_prod(const float* __restrict__ a, const float* __restrict__ b, int h,
                                 int w, int y, int x) {
  float acc = 0.f;
  for (int dx = -4; dx <= 4; ++dx) {
    int xx = x + dx;
    if (xx < 0 || xx >= w) continue;
    float v = 0.f;
    for (int dy = -4; dy <= 4; ++dy) {
      int yy = y + dy;
      if (yy < 0 || yy >= h) continue;
      int q = yy * w + xx;
      v = v + a[q] * b[q];
    }
    acc = acc + v;
  }
  return acc;
}

__global__ void lk_tensor(int h, int w, float* __restrict__ s) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int n = h * w;
  if (i >= n) return;
  int y = i / w, x = i - y * w;
  const float* gx = s + GX * n;
  const float* gy = s + GY * n;
  float ixx = box_prod(gx, gx, h, w, y, x);
  float ixy = box_prod(gx, gy, h, w, y, x);
  float iyy = box_prod(gy, gy, h, w, y, x);
  float det = ixx * iyy - ixy * ixy;
  float tr = ixx + iyy;
  float min_eig = tr / 2.0f - sqrtf(fmaxf(tr * tr / 4.0f - det, 0.0f));
  bool ok = (det > 1e-3f) && (min_eig > 0.5f);
  s[IXX * n + i] = ixx;
  s[IXY * n + i] = ixy;
  s[IYY * n + i] = iyy;
  s[INV_DET * n + i] = ok ? 1.0f / det : 0.f;
  s[OK * n + i] = ok ? 1.f : 0.f;
}

// temporal difference: next warped by the flow in buffer `fin`, minus prev
__global__ void lk_warp(const float* __restrict__ prev, const float* __restrict__ nxt, int h,
                        int w, float umax, float vmax, int fin, float* __restrict__ s) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int n = h * w;
  if (i >= n) return;
  int y = i / w, x = i - y * w;
  float wu = fminf(fmaxf((float)x + s[fin * n + i], 0.0f), umax);
  float wv = fminf(fmaxf((float)y + s[(fin + 1) * n + i], 0.0f), vmax);
  float u0 = floorf(wu), v0 = floorf(wv);
  int u0c = min(max((int)u0, 0), w - 2);
  int v0c = min(max((int)v0, 0), h - 2);
  float tu = wu - u0, tv = wv - v0;
  int q = v0c * w + u0c;
  float warped = nxt[q] * (1.f - tu) * (1.f - tv) + nxt[q + 1] * tu * (1.f - tv) +
                 nxt[q + w] * (1.f - tu) * tv + nxt[q + w + 1] * tu * tv;
  s[IT * n + i] = warped - prev[i];
}

__global__ void lk_update(int h, int w, int fin, int fout, float* __restrict__ s,
                          float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int n = h * w;
  if (i >= n) return;
  int y = i / w, x = i - y * w;
  const float* it = s + IT * n;
  float bx = box_prod(s + GX * n, it, h, w, y, x);
  float by = box_prod(s + GY * n, it, h, w, y, x);
  float ixx = s[IXX * n + i], ixy = s[IXY * n + i], iyy = s[IYY * n + i];
  float inv_det = s[INV_DET * n + i];
  bool ok = s[OK * n + i] > 0.f;
  float dx = fminf(fmaxf(-(iyy * bx - ixy * by) * inv_det, -2.0f), 2.0f);
  float dy = fminf(fmaxf(-(-ixy * bx + ixx * by) * inv_det, -2.0f), 2.0f);
  float fx = s[fin * n + i] + (ok ? dx : 0.f);
  float fy = s[(fin + 1) * n + i] + (ok ? dy : 0.f);
  s[fout * n + i] = fx;
  s[(fout + 1) * n + i] = fy;
  if (out != nullptr) {
    out[2 * i] = fx;
    out[2 * i + 1] = fy;
  }
}

inline int blocks(int n) { return (n + TB - 1) / TB; }

}  // namespace

extern "C" int mmf_flow_prep(const float* prev, const float* nxt, int H, int W, int hc, int wc,
                             float k0, float k1, float k2, float k3, float k4, float k5,
                             float k6, float* tmp, float* pyr0, float* pyr1, float* pyr2,
                             cudaStream_t stream) {
  Blur b{};
  const float k[7] = {k0, k1, k2, k3, k4, k5, k6};
  for (int j = 0; j < 7; ++j) b.k[j] = k[j];
  const int r = 3;
  dim3 g0(blocks(hc * wc), 2);
  resize_hblur<<<g0, TB, 0, stream>>>(prev, nxt, H, W, hc, wc, b, r, tmp);
  vblur<<<g0, TB, 0, stream>>>(tmp, hc, wc, b, r, pyr0);
  int h1 = (hc + 1) / 2, w1 = (wc + 1) / 2;
  pyr_down<<<dim3(blocks(h1 * w1), 2), TB, 0, stream>>>(pyr0, hc, wc, h1, w1, pyr1);
  int h2 = (h1 + 1) / 2, w2 = (w1 + 1) / 2;
  pyr_down<<<dim3(blocks(h2 * w2), 2), TB, 0, stream>>>(pyr1, h1, w1, h2, w2, pyr2);
  return (int)cudaGetLastError();
}

extern "C" int mmf_lk_level(const float* pair, const float* coarse, int h, int w, int hp, int wp,
                            int iters, float umax, float vmax, float* scratch, float* out,
                            cudaStream_t stream) {
  int n = h * w;
  const float* prev = pair;
  const float* nxt = pair + n;
  lk_grad<<<blocks(n), TB, 0, stream>>>(prev, coarse, h, w, hp, wp, scratch);
  lk_tensor<<<blocks(n), TB, 0, stream>>>(h, w, scratch);
  for (int k = 0; k < iters; ++k) {
    int fin = (k % 2 == 0) ? FA : FB;
    int fout = (k % 2 == 0) ? FB : FA;
    lk_warp<<<blocks(n), TB, 0, stream>>>(prev, nxt, h, w, umax, vmax, fin, scratch);
    lk_update<<<blocks(n), TB, 0, stream>>>(h, w, fin, fout, scratch,
                                            k == iters - 1 ? out : nullptr);
  }
  return (int)cudaGetLastError();
}
