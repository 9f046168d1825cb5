// K15 flow: the flow-CRF's dense Lucas-Kanade optical flow at the CRF scale.
//
// Replaces: multimotionfusion_tpu/segmentation/flow.py:100 dense_flow and
//   :18 _lk_refine, with ops/image.py:265 resize_bilinear (:247
//   _resize_matrix), :199 gaussian_blur and :104 pyr_down_gauss /
//   :129 build_pyramid folded in.
// Bound on an H100: neither bytes nor operations. A 160x120 level is 77 KB a
//   plane, all of it in L2; per pixel and iteration the 9x9 box sums are ~40
//   operations. A chain of small dependent steps is the cost: 34 launches a
//   frame when each step was a kernel, now 18 barriers of one cluster.
// Design: mmf_dense_flow is ONE launch of one thread-block cluster of
//   CLUSTER = 16 blocks of 1024 threads (the non-portable size; the portable
//   8 measured slower, PERF.md section 6). Block r of the
//   cluster owns the rows [r h / C, (r + 1) h / C) of every level and plane;
//   what a step reads from other blocks' rows (halo rows, the coarser flow)
//   it reads from global scratch, which stays in L2, with ld.global.cg after
//   a cluster barrier (release / acquire at cluster scope) where the old
//   kernels had a launch boundary. The steps, in order:
//   - the two-tap bilinear resize of both images (taps computed in double
//     as numpy computes _resize_matrix's rows), once a pixel, into shared
//     memory; the horizontal blur of the same rows (block barrier); the
//     vertical blur; two validity-renormalised 5x5 Gaussian downsamples
//     (cluster barrier after each of these three; each stages the rows it
//     reads in shared memory first; the blur's taps accumulated from zero in
//     order);
//   - per level, coarsest first: central differences of the block's rows and
//     4 more each side (computed from the pyramid by each block that reads
//     them, into shared memory) and the initial flow (zeros, or the coarser
//     flow x2 upsampled); the 9x9 box sums of the structure tensor, det and
//     the min-eigenvalue gate,
//     and at the same pixel the clamped bilinear warp and the temporal
//     difference `it`; then per iteration a cluster barrier, the box sums of
//     gx*it and gy*it, the solve, the +-2 px clamp and the flow's update at
//     the own pixel, and there the next iteration's `it` (double-buffered: a
//     neighbour may still read the previous one), `it` of the rows the box
//     sums read staged in shared memory after the barrier; a cluster barrier
//     ends a level. A block keeps its pixels' tensor, gate and flow in shared
//     memory; only `it` and a level's final flow, which other blocks read, go
//     through global scratch.
//   Every box sum is computed as the old kernels' box_prod computed it: per
//   column the vertical taps from zero in tap order, skipping rows outside
//   the image, then the horizontal sum of those column sums from zero in tap
//   order, skipping columns outside. The column sums of a block's rows are
//   computed once into shared memory (per row and column, not nine times a
//   box). With -fmad=false every value is the same float the plain version
//   (segmentation/flow.py) and the 34-launch kernels computed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int FLOW_THREADS = 1024;
constexpr int CLUSTER = 16;  // segmentation/flow.py's CLUSTER
constexpr int BLUR_R = 3;
constexpr int LK_R = 4;
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on an H100

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

// scratch written in this launch: read through L2 only (ld.global.cg)
__device__ inline float ld(const float* p) { return __ldcg(p); }

// bilinear resize of plane `src` (width wi) at the output pixel whose row
// and column taps are ty and tx: rows first, then columns. kScratch: src
// was written in this launch
template <bool kScratch>
__device__ inline float resize_with(const float* src, int wi, Taps ty, Taps tx) {
  auto at = [&](int i) { return kScratch ? ld(src + i) : src[i]; };
  float r0 = ty.w0 * at(ty.i0 * wi + tx.i0) + ty.w1 * at(ty.i1 * wi + tx.i0);
  float r1 = ty.w0 * at(ty.i0 * wi + tx.i1) + ty.w1 * at(ty.i1 * wi + tx.i1);
  return tx.w0 * r0 + tx.w1 * r1;
}

// per-level planes in global scratch (what other blocks read)
enum { IT0 = 0, IT1, FX, FY, PLANES };
// per-pixel state of the block's own rows, in shared memory
enum { SXX = 0, SXY, SYY, SINV, SOK, SFX, SFY, SPREV, STATE };
constexpr int NEAR = 8;  // rows of next staged each side of a block's rows for the warp

struct FlowArgs {
  const float* prev;  // [H, W] full resolution
  const float* nxt;
  int H, W, hc, wc, iters;
  int band;  // the most pixels a block owns at any level
  int halo;  // the most pixels of a block's rows and 4 more each side, at any level
  int near;  // the most pixels of a block's rows, NEAR more above and NEAR + 1 below
  float k[2 * BLUR_R + 1];
  float* scratch;  // flow_scratch_floats(hc, wc) floats
  float* spill;    // without shared memory: [CLUSTER, per_block] floats of global scratch
  int per_block;
  float* out;      // [hc, wc, 2]
};

struct Layout {
  int h[3], w[3];
  float* tmp;     // [2, hc, wc] the horizontal blur of the resized images
  float* pyr[3];  // [2, h_l, w_l] prev, next
  float* s[3];    // [PLANES, h_l, w_l]
};

// the scratch's layout (the wrapper's flow_scratch_floats counts the same)
__device__ inline Layout layout(const FlowArgs& a) {
  Layout L;
  L.h[0] = a.hc;
  L.w[0] = a.wc;
  for (int l = 1; l < 3; ++l) {
    L.h[l] = (L.h[l - 1] + 1) / 2;
    L.w[l] = (L.w[l - 1] + 1) / 2;
  }
  float* p = a.scratch;
  L.tmp = p;
  p += 2 * a.hc * a.wc;
  for (int l = 0; l < 3; ++l) {
    L.pyr[l] = p;
    p += 2 * L.h[l] * L.w[l];
  }
  for (int l = 0; l < 3; ++l) {
    L.s[l] = p;
    p += PLANES * L.h[l] * L.w[l];
  }
  return L;
}

// dst[0, n) = src[0, n) (src written in this launch: through L2), 16 bytes a
// load where both are 16-byte aligned. Every thread of the block calls it.
__device__ inline void copy_in(float* dst, const float* src, int n) {
  int e0 = 0;
  if (((reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(dst)) & 15) == 0) {
    const int n4 = n >> 2;
    for (int e = threadIdx.x; e < n4; e += blockDim.x)
      reinterpret_cast<float4*>(dst)[e] = __ldcg(reinterpret_cast<const float4*>(src) + e);
    e0 = 4 * n4;
  }
  for (int e = e0 + threadIdx.x; e < n; e += blockDim.x) dst[e] = ld(src + e);
}

// pixels [i0, i1) of a plane: this block's rows of an h-row plane
__device__ inline void rows_of(int h, int w, int& i0, int& i1) {
  const int C = gridDim.x, r = blockIdx.x;
  i0 = (int)((long long)h * r / C) * w;
  i1 = (int)((long long)h * (r + 1) / C) * w;
}

// rows [ra, rb) (clipped to the plane) of both images of `src` [2, h, w]
// into dst [2, rows, w] (rows the clipped count); returns the first row
// staged. Every thread of the block calls it; it ends with a block barrier.
__device__ int stage_rows(const float* src, int h, int w, int ra, int rb, float* dst) {
  ra = max(ra, 0);
  rb = min(rb, h);
  const int cnt = max(rb - ra, 0) * w;
  copy_in(dst, src + ra * w, cnt);
  copy_in(dst + cnt, src + h * w + ra * w, cnt);
  __syncthreads();
  return ra;
}

// validity-renormalised 5x5 Gaussian downsample by 2 (gate 0) of this
// block's output rows, both images: output (x, y) centred on input (2x, 2y),
// taps in row-major order; the input rows staged in shared memory `stage`
__device__ void pyr_down(const float* src, int h, int w, int ho, int wo, float* dst,
                         float* stage) {
  const float g[5] = {1.f, 4.f, 6.f, 4.f, 1.f};
  int i0, i1;
  rows_of(ho, wo, i0, i1);
  const int r0 = stage_rows(src, h, w, 2 * (i0 / wo) - 2, 2 * (i1 / wo) + 1, stage);
  const int cnt = (min(2 * (i1 / wo) + 1, h) - r0) * w;
  const int m = i1 - i0;
  for (int e = threadIdx.x; e < 2 * m; e += blockDim.x) {
    const int z = e >= m, i = i0 + e - z * m;
    const int y = i / wo, x = i - y * wo;
    const float* s = stage + z * cnt;
    float num = 0.f, den = 0.f;
    for (int oy = -2; oy <= 2; ++oy) {
      for (int ox = -2; ox <= 2; ++ox) {
        int yy = 2 * y + oy, xx = 2 * x + ox;
        float v = 0.f, valid = 0.f;
        if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
          v = s[(yy - r0) * w + xx];
          valid = v > 0.f ? 1.f : 0.f;
        }
        float wt = g[oy + 2] * g[ox + 2];
        num = num + wt * (v * valid);
        den = den + wt * valid;
      }
    }
    dst[z * ho * wo + i] = den > 0.f ? num / fmaxf(den, 1e-12f) : 0.f;
  }
}

// The zero-padded 9x9 box sums of NP products at this block's pixels
// [i0, i1) of an [h, w] level: prod(q, p) gives the NP products at pixel q,
// done(e, sums) takes the NP box sums of the block's e-th pixel. Per (row,
// column) the vertical taps from zero in tap order into `col` (NP planes of
// the block's pixels), then per pixel the horizontal taps of those from zero
// in tap order, each skipping taps outside the image (box_prod's
// arithmetic). Every thread of the block calls it.
template <int NP, class Prod, class Done>
__device__ void box_sums(int h, int w, int i0, int i1, float* col, Prod prod, Done done) {
  const int m = i1 - i0;
  for (int e = threadIdx.x; e < m; e += blockDim.x) {
    const int i = i0 + e, y = i / w, x = i - y * w;
    float v[NP];
    for (int q = 0; q < NP; ++q) v[q] = 0.f;
#pragma unroll
    for (int dy = -LK_R; dy <= LK_R; ++dy) {
      const int yy = y + dy;
      if (yy < 0 || yy >= h) continue;
      float p[NP];
      prod(yy * w + x, p);
      for (int q = 0; q < NP; ++q) v[q] = v[q] + p[q];
    }
    for (int q = 0; q < NP; ++q) col[q * m + e] = v[q];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < m; e += blockDim.x) {
    const int x = (i0 + e) % w;
    float acc[NP];
    for (int q = 0; q < NP; ++q) acc[q] = 0.f;
#pragma unroll
    for (int dx = -LK_R; dx <= LK_R; ++dx) {
      const int xx = x + dx;
      if (xx < 0 || xx >= w) continue;
      for (int q = 0; q < NP; ++q) acc[q] = acc[q] + col[q * m + e + dx];
    }
    done(e, acc);
  }
  __syncthreads();
}

// kShared: the block's own state and staged rows in shared memory; else in
// its own part of global scratch (grids whose bands do not fit a block's
// shared memory), with the same arithmetic
template <bool kShared>
__global__ void __launch_bounds__(FLOW_THREADS, 1) dense_flow(FlowArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float dyn[];
  float* smem = kShared ? dyn : a.spill + (size_t)blockIdx.x * a.per_block;
  float* st = smem;                   // [STATE, band]: the own pixels' state
  float* col = st + STATE * a.band;    // [3, band]: column sums (and the resized rows)
  float* gs = col + 3 * a.band;        // [2, halo]: gx, gy of the rows the box sums read
  float* ts = gs + 2 * a.halo;         // [halo]: `it` of the same rows
  float* ns = ts + a.halo;             // [near]: next of the rows the warp reads most
  const Layout L = layout(a);
  const int hc = a.hc, wc = a.wc, n0 = hc * wc;
  int i0, i1;

  // ---- resize, blur, pyramids
  rows_of(hc, wc, i0, i1);
  int m = i1 - i0;
  {
    // the resize's taps of the block's rows and of every column, once each
    const int y0 = i0 / wc, rows = m / wc;
    Taps* rtap = reinterpret_cast<Taps*>(gs);
    Taps* ctap = rtap + rows;
    for (int e = threadIdx.x; e < rows + wc; e += blockDim.x)
      rtap[e] = e < rows ? resize_tap(y0 + e, a.H, hc) : resize_tap(e - rows, a.W, wc);
    __syncthreads();
    for (int e = threadIdx.x; e < 2 * m; e += blockDim.x) {
      const int z = e >= m, i = i0 + e - z * m;
      const int y = i / wc, x = i - y * wc;
      col[e] = resize_with<false>(z == 0 ? a.prev : a.nxt, a.W, rtap[y - y0], ctap[x]);
    }
  }
  __syncthreads();  // the horizontal blur reads its own rows only
  for (int e = threadIdx.x; e < 2 * m; e += blockDim.x) {
    const int z = e >= m, i = i0 + e - z * m;
    const int x = i % wc;
    const float* r = col + e - x;  // the row's first pixel
    float acc = 0.f;
    for (int d = -BLUR_R; d <= BLUR_R; ++d) {
      int xx = x + d;
      if (xx < 0 || xx >= wc) continue;
      acc = acc + a.k[d + BLUR_R] * r[xx];
    }
    L.tmp[z * n0 + i] = acc;
  }
  cluster.sync();
  {
    const int r0 = stage_rows(L.tmp, hc, wc, i0 / wc - BLUR_R, i1 / wc + BLUR_R, smem);
    const int cnt = (min(i1 / wc + BLUR_R, hc) - r0) * wc;
    for (int e = threadIdx.x; e < 2 * m; e += blockDim.x) {
      const int z = e >= m, i = i0 + e - z * m;
      const int y = i / wc, x = i - y * wc;
      const float* t = smem + z * cnt;
      float acc = 0.f;
      for (int d = -BLUR_R; d <= BLUR_R; ++d) {
        int yy = y + d;
        if (yy < 0 || yy >= hc) continue;
        acc = acc + a.k[d + BLUR_R] * t[(yy - r0) * wc + x];
      }
      L.pyr[0][z * n0 + i] = acc;
    }
  }
  cluster.sync();
  pyr_down(L.pyr[0], L.h[0], L.w[0], L.h[1], L.w[1], L.pyr[1], smem);
  cluster.sync();
  pyr_down(L.pyr[1], L.h[1], L.w[1], L.h[2], L.w[2], L.pyr[2], smem);
  cluster.sync();

  // ---- Lucas-Kanade, coarsest level first
  for (int l = 2; l >= 0; --l) {
    const int h = L.h[l], w = L.w[l], n = h * w;
    const float* prev = L.pyr[l];
    const float* nxt = L.pyr[l] + n;
    float* s = L.s[l];
    const float* coarse = l < 2 ? L.s[l + 1] + FX * L.h[l + 1] * L.w[l + 1] : nullptr;
    const int hp = l < 2 ? L.h[l + 1] : 0, wp = l < 2 ? L.w[l + 1] : 0;
    const float umax = (float)((double)w - 1.001), vmax = (float)((double)h - 1.001);
    rows_of(h, w, i0, i1);
    m = i1 - i0;

    // the rows [ylo, yhi) the block's box sums read: its own and 4 more each side
    const int ylo = max(i0 / w - LK_R, 0), yhi = min(i1 / w + LK_R, h);
    const int hn = (yhi - ylo) * w, hoff = ylo * w;

    // unit-gain central differences of prev at those rows (0 on the border),
    // from prev's rows [plo, phi) staged in `ns`
    const int plo = max(ylo - 1, 0), phi = min(yhi + 1, h);
    copy_in(ns, prev + plo * w, (phi - plo) * w);
    __syncthreads();
    for (int e = threadIdx.x; e < hn; e += blockDim.x) {
      const int i = hoff + e, y = i / w, x = i - y * w;
      const float* p = ns + (i - plo * w);
      float gx = 0.f, gy = 0.f;
      if (x > 0 && x < w - 1) gx = 0.5f * (p[1] - p[-1]);
      if (y > 0 && y < h - 1) gy = 0.5f * (p[w] - p[-w]);
      gs[e] = gx;
      gs[a.halo + e] = gy;
    }
    __syncthreads();

    // next of the rows [nlo, nhi) (the warp's taps of most pixels), prev of
    // the own, and the initial flow at the own pixels
    const int nlo = max(i0 / w - NEAR, 0), nhi = min(i1 / w + NEAR + 1, h);
    copy_in(ns, nxt + nlo * w, (nhi - nlo) * w);
    copy_in(st + SPREV * a.band, prev + i0, m);
    for (int e = threadIdx.x; e < m; e += blockDim.x) {
      const int i = i0 + e, y = i / w, x = i - y * w;
      float fx = 0.f, fy = 0.f;
      if (coarse != nullptr) {
        const Taps ty = resize_tap(y, hp, h), tx = resize_tap(x, wp, w);
        fx = resize_with<true>(coarse, wp, ty, tx) * 2.0f;
        fy = resize_with<true>(coarse + hp * wp, wp, ty, tx) * 2.0f;
      }
      st[SFX * a.band + e] = fx;
      st[SFY * a.band + e] = fy;
    }
    __syncthreads();

    // temporal difference at the block's e-th pixel: next warped by the
    // flow (fx, fy), minus prev, into `it`
    auto warp_diff = [&](int e, float fx, float fy, float* it) {
      const int i = i0 + e, y = i / w, x = i - y * w;
      float wu = fminf(fmaxf((float)x + fx, 0.0f), umax);
      float wv = fminf(fmaxf((float)y + fy, 0.0f), vmax);
      float u0 = floorf(wu), v0 = floorf(wv);
      int u0c = min(max((int)u0, 0), w - 2);
      int v0c = min(max((int)v0, 0), h - 2);
      float tu = wu - u0, tv = wv - v0;
      float t00, t01, t10, t11;
      if (v0c >= nlo && v0c + 1 < nhi) {  // staged
        const float* r = ns + (v0c - nlo) * w + u0c;
        t00 = r[0], t01 = r[1], t10 = r[w], t11 = r[w + 1];
      } else {
        const int q = v0c * w + u0c;
        t00 = ld(nxt + q), t01 = ld(nxt + q + 1), t10 = ld(nxt + q + w), t11 = ld(nxt + q + w + 1);
      }
      float warped = t00 * (1.f - tu) * (1.f - tv) + t01 * tu * (1.f - tv) +
                     t10 * (1.f - tu) * tv + t11 * tu * tv;
      it[i] = warped - st[SPREV * a.band + e];
    };

    // the structure tensor and its gate, then the first temporal difference
    box_sums<3>(
        h, w, i0, i1, col,
        [&](int q, float* p) {
          const float gx = gs[q - hoff], gy = gs[a.halo + q - hoff];
          p[0] = gx * gx;
          p[1] = gx * gy;
          p[2] = gy * gy;
        },
        [&](int e, const float* b) {
          const float ixx = b[0], ixy = b[1], iyy = b[2];
          float det = ixx * iyy - ixy * ixy;
          float tr = ixx + iyy;
          float min_eig = tr / 2.0f - sqrtf(fmaxf(tr * tr / 4.0f - det, 0.0f));
          bool ok = (det > 1e-3f) && (min_eig > 0.5f);
          st[SXX * a.band + e] = ixx;
          st[SXY * a.band + e] = ixy;
          st[SYY * a.band + e] = iyy;
          st[SINV * a.band + e] = ok ? 1.0f / det : 0.f;
          st[SOK * a.band + e] = ok ? 1.f : 0.f;
          warp_diff(e, st[SFX * a.band + e], st[SFY * a.band + e], s + IT0 * n);
        });

    // per iteration: the box sums of gx*it and gy*it, the solve and the
    // flow's update, then the next iteration's temporal difference
    for (int k = 0; k < a.iters; ++k) {
      const float* it = s + (IT0 + (k & 1)) * n;
      float* it_next = s + (IT0 + ((k + 1) & 1)) * n;
      cluster.sync();  // every block's `it` of this iteration
      copy_in(ts, it + hoff, hn);
      __syncthreads();
      const bool last = k == a.iters - 1;
      box_sums<2>(
          h, w, i0, i1, col,
          [&](int q, float* p) {
            const float t = ts[q - hoff];
            p[0] = gs[q - hoff] * t;
            p[1] = gs[a.halo + q - hoff] * t;
          },
          [&](int e, const float* b) {
            const float bx = b[0], by = b[1];
            float ixx = st[SXX * a.band + e], ixy = st[SXY * a.band + e];
            float iyy = st[SYY * a.band + e], inv_det = st[SINV * a.band + e];
            bool ok = st[SOK * a.band + e] > 0.f;
            float dx = fminf(fmaxf(-(iyy * bx - ixy * by) * inv_det, -2.0f), 2.0f);
            float dy = fminf(fmaxf(-(-ixy * bx + ixx * by) * inv_det, -2.0f), 2.0f);
            float fx = st[SFX * a.band + e] + (ok ? dx : 0.f);
            float fy = st[SFY * a.band + e] + (ok ? dy : 0.f);
            st[SFX * a.band + e] = fx;
            st[SFY * a.band + e] = fy;
            if (!last) {
              warp_diff(e, fx, fy, it_next);
            } else {
              const int i = i0 + e;
              if (l > 0) {
                s[FX * n + i] = fx;
                s[FY * n + i] = fy;
              } else {
                a.out[2 * i] = fx;
                a.out[2 * i + 1] = fy;
              }
            }
          });
    }
    if (l > 0) cluster.sync();  // the next level upsamples this one's flow
  }
}

template <bool kShared>
int launch(const FlowArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaSuccess;
  if (kShared)
    e = cudaFuncSetAttribute(dense_flow<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dense_flow<kShared>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(FLOW_THREADS);
  cfg.dynamicSmemBytes = kShared ? smem : 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, dense_flow<kShared>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// cluster: the blocks the bands were sized for (must be CLUSTER); spill:
// null, or [CLUSTER, max(lk, stage)] floats of global scratch for a grid
// whose bands do not fit a block's shared memory
extern "C" int mmf_dense_flow(const float* prev, const float* nxt, int H, int W, int hc, int wc,
                              int iters, float k0, float k1, float k2, float k3, float k4, float k5,
                              float k6, int cluster, int band, int halo, int near, int stage,
                              float* scratch, float* spill, float* out, cudaStream_t stream) {
  const size_t lk = (size_t)(STATE + 3) * band + 3 * (size_t)halo + near;
  const size_t per_block = lk > (size_t)stage ? lk : (size_t)stage;
  const size_t smem = sizeof(float) * per_block;
  if (cluster != CLUSTER || wc < 5 || hc < 5 || iters < 1 ||
      (spill == nullptr && smem > MAX_SMEM))
    return (int)cudaErrorInvalidValue;
  FlowArgs a{prev, nxt, H, W, hc, wc, iters, band, halo, near, {k0, k1, k2, k3, k4, k5, k6},
             scratch, spill, (int)per_block, out};
  return spill == nullptr ? launch<true>(a, smem, stream) : launch<false>(a, smem, stream);
}
