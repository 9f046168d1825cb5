// K16 crf: Potts mean-field inference of the flow-CRF with a Gaussian and a
// flow-bilateral message.
//
// Replaces: multimotionfusion_tpu/segmentation/crf.py:246 mean_field, :146
//   bilateral_grid_message, :109 bilateral_grid_splat_plan, :84
//   gaussian_message (:45 _blur_batch, :27 _box_sum) and :90
//   _blur_hw_leading.
// Bound on an H100: the launches. One iteration touches the [L, H, W] label
//   distribution a few times (7 x 120 x 160 x 4 B = 0.54 MB) and the pooled
//   grid [30, 40, 64 slabs, 7 labels] (2.15 MB), all of it in L2; the
//   arithmetic (box passes, 25-tap slab mix per pixel and label) is a few
//   MFLOP. Ten iterations of six small launches are the cost.
// Design: mmf_crf_plan computes what the iterations share: one block finds
//   fmin/fmax of the features (flow x 10) and the slab blur's taps from the
//   data-dependent bin scale (the circulant 5-tap kernel per feature axis,
//   wrapping around); one block per pooled cell bins its pixels (rint) and
//   counts each slab's occupancy; the occupancy is box-blurred; every pixel
//   reads its blurred occupancy at its own slab through the slab mix (the
//   normaliser) and the initial softmax. mmf_crf_iteration enqueues the
//   Gaussian message (three box passes along H in one launch, three along W
//   in another, each line in shared memory), the splat (one block per
//   pooled cell, one thread per slab and label, summing the cell's pixels in
//   a fixed order: no float atomics, equal from run to run), the spatial
//   three-box blur of the grid along each axis, and one pass per pixel that
//   mixes the 25 slabs around its own, normalises, subtracts the
//   self-message, forms the Potts term and takes the softmax. The box sums
//   are direct windowed sums where the reference takes differences of
//   cumulative sums, and the slab mix sums 25 nonzero terms where the
//   reference contracts all 64: both round differently by a few ulp (the
//   checks' tolerance says so).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BINS = 8;
constexpr int S = BINS * BINS;
constexpr int MAX_LINE = 192;
constexpr int MAX_L = 32;
constexpr int MAX_POOL2 = 16;

enum { P_FMIN = 0, P_SCALE = 2, P_W0 = 4, P_W1 = 9 };

// three box passes of radius r along lines of n elements, each pass times
// inv, zero outside the line. Line k (32 lines a block, threadIdx.x) starts
// at (k / inner) * outer_stride + (k % inner) * inner_stride and steps by
// `step`; in and out may be the same array (each block owns its lines).
__global__ void box3(const float* in, float* out, int n_lines, int n, int inner,
                     long outer_stride, long inner_stride, long step, int r, float inv) {
  __shared__ float buf[2][MAX_LINE][32];
  int k = blockIdx.x * 32 + threadIdx.x;
  bool live = k < n_lines;
  long base = live ? (long)(k / inner) * outer_stride + (long)(k % inner) * inner_stride : 0;
  for (int p = threadIdx.y; p < n; p += blockDim.y) buf[0][p][threadIdx.x] = live ? in[base + p * step] : 0.f;
  __syncthreads();
  int cur = 0;
  for (int pass = 0; pass < 3; ++pass) {
    for (int p = threadIdx.y; p < n; p += blockDim.y) {
      float s = 0.f;
      int lo = max(p - r, 0), hi = min(p + r, n - 1);
      for (int j = lo; j <= hi; ++j) s = s + buf[cur][j][threadIdx.x];
      buf[1 - cur][p][threadIdx.x] = s * inv;
    }
    __syncthreads();
    cur = 1 - cur;
  }
  if (live)
    for (int p = threadIdx.y; p < n; p += blockDim.y) out[base + p * step] = buf[cur][p][threadIdx.x];
}

void launch_box3(const float* in, float* out, int n_lines, int n, int inner, long outer_stride,
                 long inner_stride, long step, int r, float inv, cudaStream_t stream) {
  dim3 block(32, 8);
  box3<<<(n_lines + 31) / 32, block, 0, stream>>>(in, out, n_lines, n, inner, outer_stride,
                                                  inner_stride, step, r, inv);
}

__global__ void minmax(const float* __restrict__ flow, int npix, float fscale, float sigma_f,
                       float* __restrict__ params) {
  __shared__ float mn[2][1024], mx[2][1024];
  float lo0 = INFINITY, lo1 = INFINITY, hi0 = -INFINITY, hi1 = -INFINITY;
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
      float sb = fmaxf(sigma_f * scale, 1e-3f);
      float w[5], sum = 0.f;
      for (int k = 0; k < 5; ++k) {
        float o = (float)(k - 2) / sb;
        w[k] = expf(-0.5f * (o * o));
      }
      for (int k = 0; k < 5; ++k) sum = sum + w[k];
      for (int k = 0; k < 5; ++k) params[(c == 0 ? P_W0 : P_W1) + k] = w[k] / sum;
    }
  }
}

__device__ inline int pixel_of(int cell, int j, int wp, int ds, int w) {
  int cy = cell / wp, cx = cell - cy * wp;
  int a = j / ds, b = j - a * ds;
  return (cy * ds + a) * w + cx * ds + b;
}

// per pooled cell: each pixel's slab (written to bins) and the occupancy of
// every slab (threads = S)
__global__ void splat_occ(const float* __restrict__ flow, const float* __restrict__ params,
                          float fscale, int w, int wp, int ds, int* __restrict__ bins,
                          float* __restrict__ occ) {
  __shared__ int bn[MAX_POOL2];
  int cell = blockIdx.x;
  int np = ds * ds;
  if (threadIdx.x < np) {
    int p = pixel_of(cell, threadIdx.x, wp, ds, w);
    int flat = 0;
    for (int c = 0; c < 2; ++c) {
      float f = flow[2 * p + c] * fscale;
      float v = rintf((f - params[P_FMIN + c]) * params[P_SCALE + c]);
      int b = (int)fminf(fmaxf(v, 0.f), (float)(BINS - 1));
      flat = flat * BINS + b;
    }
    bn[threadIdx.x] = flat;
    bins[p] = flat;
  }
  __syncthreads();
  int s = threadIdx.x;
  float acc = 0.f;
  for (int j = 0; j < np; ++j) acc = acc + (bn[j] == s ? 1.f : 0.f);
  occ[cell * S + s] = acc;
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

__global__ void norm_q0(const float* __restrict__ unary, const float* __restrict__ occ,
                        const float* __restrict__ params, const int* __restrict__ bins, int nl,
                        int h, int w, int ds, float* __restrict__ norm, float* __restrict__ q) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  int npix = h * w;
  if (p >= npix) return;
  int y = p / w, x = p - y * w;
  int wp = w / ds;
  int cell = (y / ds) * wp + x / ds;
  norm[p] = slab_mix(occ + cell * S, 1, bins[p], params);
  float xv[MAX_L];
  for (int l = 0; l < nl; ++l) xv[l] = -unary[l * npix + p];
  softmax_neg(xv, nl, q, npix, p);
}

// one block per pooled cell, one thread per (slab, label): the cell's
// pixels of that slab summed in pixel order
__global__ void splat(const float* __restrict__ q, const int* __restrict__ bins, int nl, int w,
                      int wp, int ds, int npix, float* __restrict__ grid) {
  __shared__ int bn[MAX_POOL2];
  __shared__ float qv[MAX_L][MAX_POOL2];
  int cell = blockIdx.x;
  int np = ds * ds;
  for (int j = threadIdx.x; j < np * nl; j += blockDim.x) {
    int l = j / np, jj = j - l * np;
    int p = pixel_of(cell, jj, wp, ds, w);
    qv[l][jj] = q[l * npix + p];
    if (l == 0) bn[jj] = bins[p];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < S * nl; t += blockDim.x) {
    int s = t / nl, l = t - s * nl;
    float acc = 0.f;
    for (int j = 0; j < np; ++j)
      if (bn[j] == s) acc = acc + qv[l][j];
    grid[(long)cell * S * nl + t] = acc;
  }
}

__global__ void pixel_update(const float* __restrict__ q, const float* __restrict__ unary,
                             const float* __restrict__ gauss, const float* __restrict__ grid,
                             const float* __restrict__ params, const int* __restrict__ bins,
                             const float* __restrict__ norm, int nl, int h, int w, int ds,
                             float wg, float wb, float* __restrict__ out) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  int npix = h * w;
  if (p >= npix) return;
  int y = p / w, x = p - y * w;
  int wp = w / ds;
  long cell = (long)(y / ds) * wp + x / ds;
  int t = bins[p];
  float nrm = fmaxf(norm[p], 1e-6f);
  float msg[MAX_L];
  float total = 0.f;
  for (int l = 0; l < nl; ++l) {
    float ql = q[l * npix + p];
    float bil = slab_mix(grid + cell * S * nl + l, nl, t, params) / nrm;
    float m = 0.f + wg * (gauss[l * npix + p] - ql);
    m = m + wb * (bil - ql);
    msg[l] = m;
    total = total + m;
  }
  float xv[MAX_L];
  for (int l = 0; l < nl; ++l) xv[l] = -unary[l * npix + p] - (total - msg[l]);
  softmax_neg(xv, nl, out, npix, p);
}

inline int blocks(int n, int t) { return (n + t - 1) / t; }

}  // namespace

extern "C" int mmf_crf_plan(const float* unary, const float* flow, int L, int H, int W, int ds,
                            float fscale, float sigma_f, int rb, float inv_b, float* q0,
                            float* params, int* bins, float* norm, float* occ,
                            cudaStream_t stream) {
  if (L > MAX_L || ds * ds > MAX_POOL2 || H > MAX_LINE || W > MAX_LINE) return (int)cudaErrorInvalidValue;
  int npix = H * W;
  int hp = H / ds, wp = W / ds;
  minmax<<<1, 1024, 0, stream>>>(flow, npix, fscale, sigma_f, params);
  splat_occ<<<hp * wp, S, 0, stream>>>(flow, params, fscale, W, wp, ds, bins, occ);
  launch_box3(occ, occ, wp * S, hp, S, S, 1, (long)wp * S, rb, inv_b, stream);
  launch_box3(occ, occ, hp * S, wp, S, (long)wp * S, 1, S, rb, inv_b, stream);
  norm_q0<<<blocks(npix, 256), 256, 0, stream>>>(unary, occ, params, bins, L, H, W, ds, norm,
                                                  q0);
  return (int)cudaGetLastError();
}

extern "C" int mmf_crf_iteration(const float* q, const float* unary, const float* params,
                                 const int* bins, const float* norm, int L, int H, int W, int ds,
                                 int rg, float inv_g, int rb, float inv_b, float wg, float wb,
                                 float* gauss, float* grid, float* out, cudaStream_t stream) {
  if (L > MAX_L || ds * ds > MAX_POOL2 || H > MAX_LINE || W > MAX_LINE) return (int)cudaErrorInvalidValue;
  int npix = H * W;
  int hp = H / ds, wp = W / ds;
  long C = (long)S * L;
  // Gaussian message: three box passes along H, then three along W
  launch_box3(q, gauss, L * W, H, W, npix, 1, W, rg, inv_g, stream);
  launch_box3(gauss, gauss + (long)L * npix, L * H, W, H, npix, W, 1, rg, inv_g, stream);
  // bilateral grid: splat, then the spatial blur along each axis
  splat<<<hp * wp, 256, 0, stream>>>(q, bins, L, W, wp, ds, npix, grid);
  launch_box3(grid, grid, (int)(wp * C), hp, (int)C, C, 1, wp * C, rb, inv_b, stream);
  launch_box3(grid, grid, (int)(hp * C), wp, (int)C, wp * C, 1, C, rb, inv_b, stream);
  pixel_update<<<blocks(npix, 128), 128, 0, stream>>>(q, unary, gauss + (long)L * npix, grid,
                                                       params, bins, norm, L, H, W, ds, wg, wb,
                                                       out);
  return (int)cudaGetLastError();
}
