// K16 crf: Potts mean-field inference of the flow-CRF with a Gaussian and a
// flow-bilateral message.
//
// Replaces: multimotionfusion_tpu/segmentation/crf.py:246 mean_field, :146
//   bilateral_grid_message, :109 bilateral_grid_splat_plan, :84
//   gaussian_message (:45 _blur_batch, :27 _box_sum) and :90
//   _blur_hw_leading.
// Bound on an H100: the launches and the box passes' serial window sums.
//   One iteration touches the [L, H, W] label distribution a few times
//   (7 x 120 x 160 x 4 B = 0.54 MB) and the pooled grid [7 labels, 64
//   slabs, 30 x 40 cells] (2.15 MB), all of it in L2; the arithmetic (box
//   passes, 25-tap slab mix per pixel and label) is a few MFLOP. Every
//   window sum is a chain of 2r + 1 adds in the reference's order, so the
//   adds cannot be shared between windows.
// Design: two launches an iteration, three for the plan.
//   - messages: one launch of two kinds of block. A grid block owns one
//     label and four slabs: it splats its label's Q into the pooled [hp, wp]
//     plane of each slab in shared memory (one thread a pooled cell, the
//     cell's pixels summed in pixel order: no float atomics, equal from run
//     to run), runs the three box passes along hp and then the three along
//     wp on those planes, and writes them out. A Gaussian block owns one
//     label and a band of rows: it loads the band plus 3 r_g rows above and
//     below at full width (coalesced rows, shared memory sized to the band),
//     runs the three passes along H and then the three along W, each zero
//     outside the image as the reference orders them, and writes the band:
//     a wrong value at the loaded rows' edge moves r_g rows a pass and stays
//     out of the band.
//   - pixel_update: one thread a pixel and label: the label's message (the
//     25 slabs around the pixel's own, normalised, the Gaussian message, the
//     self-message taken off), then across the block's labels the Potts term
//     and the softmax, each sum over the labels in label order.
//   - the plan: one block finds fmin/fmax of the features (flow x 10), the
//     slab blur's taps from the data-dependent bin scale (the circulant
//     5-tap kernel per feature axis, wrapping around) and every pixel's slab
//     (rint, one byte); the messages kernel's grid blocks in occupancy mode
//     (Q = 1) give the blurred occupancy; every pixel reads it at its own
//     slab through the slab mix (the normaliser) and takes the initial
//     softmax.
//   A box pass gives each thread CHUNK consecutive outputs of one line: it
//   reads the CHUNK + 2r values they need once (CHUNK (2r + 1) in a thread
//   a sum) and keeps CHUNK independent chains, each the same direct
//   windowed sum in ascending order from 0.f (the reference takes
//   differences of cumulative sums). The slab mix sums 25 nonzero terms
//   where the reference contracts all 64: both round differently by a few
//   ulp (the checks' tolerance says so). Every sum keeps the order of the
//   kernels it replaced, so the results are theirs bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BINS = 8;
constexpr int S = BINS * BINS;
constexpr int MAX_L = 32;
constexpr int QUAD = 4;     // slabs a grid block owns
constexpr int CHUNK = 10;   // outputs a thread takes in a box pass (30 and 40 divide)
constexpr int THREADS = 512;

enum { P_FMIN = 0, P_SCALE = 2, P_W0 = 4, P_W1 = 9 };

// One box pass of radius r in shared memory, times inv, zero outside the
// line. Line k of n_lines starts at (k / inner) * ostride + (k % inner) *
// istride, its element e lies e * estride further; src and dst differ.
// Consecutive threads take consecutive lines, each CHUNK consecutive
// outputs of one: each value is read once and added to every window that
// holds it, in ascending order from 0.f.
__device__ void box_pass(const float* src, float* dst, int n_lines, int len, int inner,
                         int ostride, int istride, int estride, int r, float inv) {
  const int chunks = (len + CHUNK - 1) / CHUNK;
  for (int item = threadIdx.x; item < n_lines * chunks; item += blockDim.x) {
    const int k = item % n_lines, c = item / n_lines;
    const int off = (k / inner) * ostride + (k % inner) * istride;
    const int p0 = c * CHUNK;
    float acc[CHUNK];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) acc[i] = 0.f;
    const int j0 = max(p0 - r, 0), j1 = min(p0 + CHUNK - 1 + r, len - 1);
    for (int j = j0; j <= j1; ++j) {
      const float v = src[off + j * estride];
#pragma unroll
      for (int i = 0; i < CHUNK; ++i)
        if (j >= p0 + i - r && j <= p0 + i + r) acc[i] = acc[i] + v;
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i)
      if (p0 + i < len) dst[off + (p0 + i) * estride] = acc[i] * inv;
  }
}

// The same pass for a radius known when compiling (the path's: r_g = 3 and
// r_b = 10 at the 120 x 160 grid): the CHUNK + 2R values in registers, zero
// beyond the line, each output's 2R + 1 adds unrolled. Adding +0.f changes
// no sum (a sum from +0.f is never -0.f), so every output is the same sum
// as box_pass's, without its per-value window tests.
template <int R>
__device__ void box_pass_r(const float* src, float* dst, int n_lines, int len, int inner,
                           int ostride, int istride, int estride, float inv) {
  const int chunks = (len + CHUNK - 1) / CHUNK;
  for (int item = threadIdx.x; item < n_lines * chunks; item += blockDim.x) {
    const int k = item % n_lines, c = item / n_lines;
    const int off = (k / inner) * ostride + (k % inner) * istride;
    const int p0 = c * CHUNK;
    float v[CHUNK + 2 * R];
#pragma unroll
    for (int d = 0; d < CHUNK + 2 * R; ++d) {
      const int j = p0 - R + d;
      v[d] = (j >= 0 && j < len) ? src[off + j * estride] : 0.f;
    }
    float s[CHUNK];  // CHUNK independent chains, each in ascending order
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) s[i] = 0.f;
#pragma unroll
    for (int t = 0; t <= 2 * R; ++t)
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) s[i] = s[i] + v[i + t];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i)
      if (p0 + i < len) dst[off + (p0 + i) * estride] = s[i] * inv;
  }
}

__device__ void box_pass_any(const float* src, float* dst, int n_lines, int len, int inner,
                             int ostride, int istride, int estride, int r, float inv) {
  if (r == 3)
    box_pass_r<3>(src, dst, n_lines, len, inner, ostride, istride, estride, inv);
  else if (r == 10)
    box_pass_r<10>(src, dst, n_lines, len, inner, ostride, istride, estride, inv);
  else
    box_pass(src, dst, n_lines, len, inner, ostride, istride, estride, r, inv);
}

// three passes along the lines described (a -> b -> a -> b); result in b
__device__ void box3_smem(float* a, float* b, int n_lines, int len, int inner, int ostride,
                          int istride, int estride, int r, float inv) {
  box_pass_any(a, b, n_lines, len, inner, ostride, istride, estride, r, inv);
  __syncthreads();
  box_pass_any(b, a, n_lines, len, inner, ostride, istride, estride, r, inv);
  __syncthreads();
  box_pass_any(a, b, n_lines, len, inner, ostride, istride, estride, r, inv);
  __syncthreads();
}

inline __host__ __device__ int odd(int n) { return n | 1; }  // a bank-spreading row pitch

// grid block: label l's Q (1 a pixel for the occupancy, q null) splatted
// into slabs s0..s0+QUAD-1 of the pooled grid in shared memory (one thread
// a pooled cell, the cell's pixels summed in pixel order), blurred along hp
// then wp; grid[(l * S + s) * ncell + cell]
__device__ void grid_block(int l, int s0, const float* __restrict__ q,
                           const unsigned char* __restrict__ bins, int w, int hp, int wp, int ds,
                           int rb, float inv_b, float* __restrict__ grid, float* sm) {
  const int pitch = odd(wp);
  const int plane = hp * pitch;
  float* a = sm;
  float* b = sm + QUAD * plane;
  const int ncell = hp * wp, npix = hp * ds * w;
  for (int cell = threadIdx.x; cell < ncell; cell += blockDim.x) {
    const int cy = cell / wp, cx = cell - cy * wp;
    float acc[QUAD];
#pragma unroll
    for (int g = 0; g < QUAD; ++g) acc[g] = 0.f;
    if (ds == 4) {  // the pooled path: a cell row is one load of each
      uchar4 tb[4];
      float4 qv[4];
#pragma unroll
      for (int ja = 0; ja < 4; ++ja) {
        const int p = (cy * 4 + ja) * w + cx * 4;  // w % 4 == 0: aligned
        tb[ja] = *reinterpret_cast<const uchar4*>(bins + p);
        qv[ja] = q != nullptr ? *reinterpret_cast<const float4*>(q + (size_t)l * npix + p)
                              : make_float4(1.f, 1.f, 1.f, 1.f);
      }
#pragma unroll
      for (int ja = 0; ja < 4; ++ja) {  // the cell's pixels in row-major order
        const int t[4] = {tb[ja].x - s0, tb[ja].y - s0, tb[ja].z - s0, tb[ja].w - s0};
        const float v[4] = {qv[ja].x, qv[ja].y, qv[ja].z, qv[ja].w};
#pragma unroll
        for (int jb = 0; jb < 4; ++jb)
#pragma unroll
          for (int g = 0; g < QUAD; ++g)
            if (t[jb] == g) acc[g] = acc[g] + v[jb];
      }
    } else {
      for (int j = 0; j < ds * ds; ++j) {  // the cell's pixels in row-major order
        const int ja = j / ds, jb = j - ja * ds;
        const int p = (cy * ds + ja) * w + cx * ds + jb;
        const int t = bins[p] - s0;
        const float v = q != nullptr ? q[(size_t)l * npix + p] : 1.f;
#pragma unroll
        for (int g = 0; g < QUAD; ++g)
          if (t == g) acc[g] = acc[g] + v;
      }
    }
    const int o = cy * pitch + cx;
#pragma unroll
    for (int g = 0; g < QUAD; ++g) a[g * plane + o] = acc[g];
  }
  __syncthreads();
  box3_smem(a, b, QUAD * wp, hp, wp, plane, 1, pitch, rb, inv_b);     // along hp -> b
  box3_smem(b, a, QUAD * hp, wp, hp, plane, pitch, 1, rb, inv_b);     // along wp -> a
  float* out = grid + ((size_t)l * S + s0) * ncell;
  for (int g = 0; g < QUAD; ++g)
    for (int cell = threadIdx.x; cell < ncell; cell += blockDim.x)
      out[(size_t)g * ncell + cell] = a[g * plane + (cell / wp) * pitch + cell % wp];
}

// Gaussian block: rows [b0, b0 + band) of label l's Gaussian message
__device__ void gauss_block(int l, int b0, int band, const float* __restrict__ q, int h, int w,
                            int rg, float inv_g, float* __restrict__ out, float* sm) {
  const int pitch = odd(w);
  const int b1 = min(b0 + band, h);
  const int r0 = max(b0 - 3 * rg, 0), r1 = min(b1 + 3 * rg, h);
  const int rows = r1 - r0;
  float* a = sm;
  float* b = sm + (band + 6 * rg) * pitch;
  const float* ql = q + (size_t)l * h * w;
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
    const int y = i / w, x = i - y * w;
    a[y * pitch + x] = ql[(size_t)(r0 + y) * w + x];
  }
  __syncthreads();
  // along H: one line a column, the loaded rows (the image's edge rows are
  // the lines' ends; the band's halo rows absorb the other ends' error)
  box3_smem(a, b, w, rows, w, 0, 1, pitch, rg, inv_g);
  // along W on the band's rows (full lines)
  const int off = (b0 - r0) * pitch;
  box3_smem(b + off, a + off, b1 - b0, w, 1, pitch, 0, 1, rg, inv_g);
  float* ol = out + (size_t)l * h * w;
  for (int i = threadIdx.x; i < (b1 - b0) * w; i += blockDim.x) {
    const int y = i / w, x = i - y * w;
    ol[(size_t)(b0 + y) * w + x] = a[off + y * pitch + x];
  }
}

// grid blocks first (the longer ones), then the Gaussian blocks
__global__ void messages(const float* __restrict__ q, const unsigned char* __restrict__ bins, int h, int w,
                         int ds, int n_grid_labels, int rb, float inv_b, float* __restrict__ grid,
                         int band, int rg, float inv_g, float* __restrict__ gauss) {
  extern __shared__ float sm[];
  const int quads = S / QUAD;
  const int n_grid = n_grid_labels * quads;
  if ((int)blockIdx.x < n_grid) {
    const int l = blockIdx.x / quads, g = blockIdx.x - l * quads;
    grid_block(l, g * QUAD, q, bins, w, h / ds, w / ds, ds, rb, inv_b, grid, sm);
  } else {
    const int bands = (h + band - 1) / band;
    const int k = blockIdx.x - n_grid;
    const int l = k / bands, bi = k - l * bands;
    gauss_block(l, bi * band, band, q, h, w, rg, inv_g, gauss, sm);
  }
}

int messages_smem(int h, int w, int ds, int band, int rg, bool with_gauss) {
  const int hp = h / ds, wp = w / ds;
  const int grid = 2 * QUAD * hp * odd(wp);
  const int g = with_gauss ? 2 * (band + 6 * rg) * odd(w) : 0;
  return (int)sizeof(float) * (grid > g ? grid : g);
}

int g_smem_set = 0;

cudaError_t launch_messages(const float* q, const unsigned char* bins, int h, int w, int ds,
                            int n_grid_labels, int rb, float inv_b, float* grid, int band,
                            int n_gauss_labels, int rg, float inv_g, float* gauss,
                            cudaStream_t stream) {
  const int smem = messages_smem(h, w, ds, band, rg, n_gauss_labels > 0);
  if (smem > 232448) return cudaErrorInvalidValue;
  if (smem > g_smem_set) {
    cudaError_t e = cudaFuncSetAttribute(messages, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return e;
    g_smem_set = smem;
  }
  const int blocks = n_grid_labels * (S / QUAD) + n_gauss_labels * ((h + band - 1) / band);
  messages<<<blocks, THREADS, smem, stream>>>(q, bins, h, w, ds, n_grid_labels, rb, inv_b, grid,
                                              band, rg, inv_g, gauss);
  return cudaGetLastError();
}

// fmin/fmax of the features, the bin scale and slab taps of each, then every
// pixel's slab (one block)
__global__ void prep(const float* __restrict__ flow, int npix, float fscale, float sigma_f,
                     float* __restrict__ params, unsigned char* __restrict__ bins) {
  __shared__ float mn[2][1024], mx[2][1024];
  __shared__ float lo[2], sc[2];
  float lo0 = INFINITY, lo1 = INFINITY, hi0 = -INFINITY, hi1 = -INFINITY;
#pragma unroll 4
  for (int i = threadIdx.x; i < npix; i += blockDim.x) {
    float f0 = flow[2 * i] * fscale, f1 = flow[2 * i + 1] * fscale;
    lo0 = fminf(lo0, f0);
    hi0 = fmaxf(hi0, f0);
    lo1 = fminf(lo1, f1);
    hi1 = fmaxf(hi1, f1);
  }
  mn[0][threadIdx.x] = lo0;
  mn[1][threadIdx.x] = lo1;
  mx[0][threadIdx.x] = hi0;
  mx[1][threadIdx.x] = hi1;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      for (int c = 0; c < 2; ++c) {
        mn[c][threadIdx.x] = fminf(mn[c][threadIdx.x], mn[c][threadIdx.x + s]);
        mx[c][threadIdx.x] = fmaxf(mx[c][threadIdx.x], mx[c][threadIdx.x + s]);
      }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    for (int c = 0; c < 2; ++c) {
      float scale = (float)(BINS - 1) / fmaxf(mx[c][0] - mn[c][0], 1e-6f);
      params[P_FMIN + c] = mn[c][0];
      params[P_SCALE + c] = scale;
      lo[c] = mn[c][0];
      sc[c] = scale;
      float sb = fmaxf(sigma_f * scale, 1e-3f);
      float wt[5], sum = 0.f;
      for (int k = 0; k < 5; ++k) {
        float o = (float)(k - 2) / sb;
        wt[k] = expf(-0.5f * (o * o));
      }
      for (int k = 0; k < 5; ++k) sum = sum + wt[k];
      for (int k = 0; k < 5; ++k) params[(c == 0 ? P_W0 : P_W1) + k] = wt[k] / sum;
    }
  }
  __syncthreads();
#pragma unroll 4
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    int flat = 0;
    for (int c = 0; c < 2; ++c) {
      float f = flow[2 * p + c] * fscale;
      float v = rintf((f - lo[c]) * sc[c]);
      int b = (int)fminf(fmaxf(v, 0.f), (float)(BINS - 1));
      flat = flat * BINS + b;
    }
    bins[p] = (unsigned char)flat;
  }
}

// sum over the 25 slabs around slab t (the slab blur's nonzero taps) of
// g[s * stride] * w0[k0] w1[k1]
__device__ inline float slab_mix(const float* __restrict__ g, int stride, int t,
                                 const float* __restrict__ params) {
  int t0 = t / BINS, t1 = t - t0 * BINS;
  float acc = 0.f;
  for (int k0 = 0; k0 < 5; ++k0) {
    int s0 = (t0 + k0 - 2 + BINS) & (BINS - 1);
    for (int k1 = 0; k1 < 5; ++k1) {
      int s1 = (t1 + k1 - 2 + BINS) & (BINS - 1);
      acc = acc + g[(s0 * BINS + s1) * stride] * (params[P_W0 + k0] * params[P_W1 + k1]);
    }
  }
  return acc;
}

__device__ inline void softmax_neg(const float* x, int nl, float* out, int npix, int p) {
  float m = -INFINITY;
  for (int l = 0; l < nl; ++l) m = fmaxf(m, x[l]);
  float e[MAX_L], sum = 0.f;
  for (int l = 0; l < nl; ++l) {
    e[l] = expf(x[l] - m);
    sum = sum + e[l];
  }
  for (int l = 0; l < nl; ++l) out[l * npix + p] = e[l] / sum;
}

__device__ inline int cell_of(int p, int w, int ds) {
  int y = p / w, x = p - y * w;
  return (y / ds) * (w / ds) + x / ds;
}

__global__ void norm_q0(const float* __restrict__ unary, const float* __restrict__ occ,
                        const float* __restrict__ params, const unsigned char* __restrict__ bins,
                        int nl,
                        int h, int w, int ds, float* __restrict__ norm, float* __restrict__ q) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  int npix = h * w;
  if (p >= npix) return;
  int ncell = (h / ds) * (w / ds);
  norm[p] = slab_mix(occ + cell_of(p, w, ds), ncell, bins[p], params);
  float xv[MAX_L];
  for (int l = 0; l < nl; ++l) xv[l] = -unary[l * npix + p];
  softmax_neg(xv, nl, q, npix, p);
}

// one thread per (pixel, label), PX pixels a block: the label's message,
// then the Potts term and the softmax over the block's column of labels,
// each sum over the labels in label order
constexpr int PX = 32;

__global__ void pixel_update(const float* __restrict__ q, const float* __restrict__ unary,
                             const float* __restrict__ gauss, const float* __restrict__ grid,
                             const float* __restrict__ params,
                             const unsigned char* __restrict__ bins,
                             const float* __restrict__ norm, int nl, int h, int w, int ds,
                             float wg, float wb, float* __restrict__ out) {
  __shared__ float col[MAX_L][PX];
  __shared__ float wts[25];
  const int px = threadIdx.x, l = threadIdx.y;
  const int p = blockIdx.x * PX + px;
  const int npix = h * w;
  const bool live = p < npix;
  if (l == 0 && px < 25) wts[px] = params[P_W0 + px / 5] * params[P_W1 + px % 5];
  __syncthreads();
  float m = 0.f;
  if (live) {
    const int ncell = (h / ds) * (w / ds);
    const int t = bins[p], t0 = t / BINS, t1 = t - t0 * BINS;
    const float* g = grid + (size_t)l * S * ncell + cell_of(p, w, ds);
    float acc = 0.f;  // slab_mix with the taps' products from shared memory
    for (int k0 = 0; k0 < 5; ++k0) {
      const int s0 = (t0 + k0 - 2 + BINS) & (BINS - 1);
#pragma unroll
      for (int k1 = 0; k1 < 5; ++k1) {
        const int s1 = (t1 + k1 - 2 + BINS) & (BINS - 1);
        acc = acc + g[(size_t)(s0 * BINS + s1) * ncell] * wts[k0 * 5 + k1];
      }
    }
    const float ql = q[(size_t)l * npix + p];
    const float bil = acc / fmaxf(norm[p], 1e-6f);
    m = 0.f + wg * (gauss[(size_t)l * npix + p] - ql);
    m = m + wb * (bil - ql);
  }
  col[l][px] = m;
  __syncthreads();
  float total = 0.f;
  for (int k = 0; k < nl; ++k) total = total + col[k][px];
  const float x = live ? -unary[(size_t)l * npix + p] - (total - m) : 0.f;
  __syncthreads();
  col[l][px] = x;
  __syncthreads();
  float mx = -INFINITY;
  for (int k = 0; k < nl; ++k) mx = fmaxf(mx, col[k][px]);
  const float e = expf(x - mx);
  __syncthreads();
  col[l][px] = e;
  __syncthreads();
  float sum = 0.f;
  for (int k = 0; k < nl; ++k) sum = sum + col[k][px];
  if (live) out[(size_t)l * npix + p] = e / sum;
}

inline int blocks(int n, int t) { return (n + t - 1) / t; }

}  // namespace

extern "C" int mmf_crf_plan(const float* unary, const float* flow, int L, int H, int W, int ds,
                            float fscale, float sigma_f, int rb, float inv_b, float* q0,
                            float* params, unsigned char* bins, float* norm, float* occ,
                            cudaStream_t stream) {
  // bins: [H * W] each pixel's slab; occ: [S, hp * wp], the blurred occupancy
  if (L > MAX_L || (ds != 1 && ds != 4) || H % ds != 0 || W % ds != 0)
    return (int)cudaErrorInvalidValue;
  int npix = H * W;
  prep<<<1, 1024, 0, stream>>>(flow, npix, fscale, sigma_f, params, bins);
  cudaError_t e = launch_messages(nullptr, bins, H, W, ds, 1, rb, inv_b, occ, 1, 0, 0, 0.f,
                                  nullptr, stream);
  if (e != cudaSuccess) return (int)e;
  norm_q0<<<blocks(npix, 256), 256, 0, stream>>>(unary, occ, params, bins, L, H, W, ds, norm, q0);
  return (int)cudaGetLastError();
}

extern "C" int mmf_crf_iteration(const float* q, const float* unary, const float* params,
                                 const unsigned char* bins, const float* norm, int L, int H, int W,
                                 int ds,
                                 int rg, float inv_g, int rb, float inv_b, float wg, float wb,
                                 int band, float* gauss, float* grid, float* out,
                                 cudaStream_t stream) {
  // gauss: [L, H, W]; grid: [L, S, hp * wp]
  if (L > MAX_L || (ds != 1 && ds != 4) || H % ds != 0 || W % ds != 0 || band <= 0)
    return (int)cudaErrorInvalidValue;
  int npix = H * W;
  cudaError_t e = launch_messages(q, bins, H, W, ds, L, rb, inv_b, grid, band, L, rg, inv_g,
                                  gauss, stream);
  if (e != cudaSuccess) return (int)e;
  pixel_update<<<blocks(npix, PX), dim3(PX, L), 0, stream>>>(q, unary, gauss, grid, params, bins,
                                                               norm, L, H, W, ds, wg, wb, out);
  return (int)cudaGetLastError();
}
