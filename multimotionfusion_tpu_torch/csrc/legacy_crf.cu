// K24c legacy_crf: the dense superpixel CRF of the legacy CoFusion segmentation.
//
// Replaces: multimotionfusion_tpu/segmentation/legacy_crf.py:104-141 (the
//   depth range, the confidence gates, the unaries with the new-model class
//   and their clamps, the 6-D features) and :53 _superpixel_crf (two exact
//   [S, S] Gaussian kernels without self-messages, symmetric normalisation,
//   Potts mean field) with :141's first-index argmax.
// Bound on an H100: bytes. At S = 1,200 superpixels the two kernel matrices
//   are 2 x 5.76 MB; the plan writes them once (about 15 flops an entry, one
//   exp) and every mean-field step reads them once (2 x 1,200^2 x L
//   multiply-adds for L <= 7 labels: ~20 MFLOP, far below the float32 rate).
//   The 11.5 MB sit in the 50 MB L2 between steps.
// Design: the plan is three launches: one block computes the depth range
//   (min and max are exact in any order), then every superpixel's gated
//   unaries (the reference's nan_to_num and clamps), features and
//   Q0 = softmax(-unary); one block per row writes both kernel rows (exp of
//   -0.5 the squared distance, minus the identity) and reduces the row sums
//   in a fixed tree order into 1 / sqrt(max(sum, 1e-12)); a last pass scales
//   each entry by both rows' factors (k * d_i * d_j, in that order). A
//   mean-field step is one launch: one warp per superpixel row forms both
//   products over the L columns (lanes stride over the row, then a fixed
//   shuffle tree), 40 * Ks q + 40 * Ka q, the Potts term and the softmax; the
//   last step also writes the first-index argmax. No float atomics: the
//   results are the same run to run. The products are this function's own,
//   written here; a library GEMM appears only as a yardstick.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXL = 16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PLAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ inline float f_inf() { return __int_as_float(0x7f800000); }

// jnp.nan_to_num(x, posinf=1e5) then min(., 1e5) then max(., 1e-5)
__device__ inline float clamp_unary(float x) {
  if (x != x) x = 0.f;
  else if (x == f_inf()) x = 1e5f;
  else if (x == -f_inf()) x = -3.4028234663852886e38f;
  x = fminf(x, 1e5f);
  return fmaxf(x, 1e-5f);
}

// softmax of the L values x (max-shifted), in place
__device__ inline void softmax(float* x, int L) {
  float mx = x[0];
  for (int l = 1; l < L; ++l) mx = fmaxf(mx, x[l]);
  float sum = 0.f;
  for (int l = 0; l < L; ++l) {
    x[l] = expf(x[l] - mx);
    sum = sum + x[l];
  }
  for (int l = 0; l < L; ++l) x[l] = x[l] / sum;
}

__global__ void __launch_bounds__(PLAN_THREADS)
inputs(const float* __restrict__ lows, const float* __restrict__ mean_color,
       const float* __restrict__ mean_xy, const bool* __restrict__ active, int M, int S,
       int allow_new, float* __restrict__ unary, float* __restrict__ feat,
       float* __restrict__ q0) {
  __shared__ float smin[PLAN_THREADS], smax[PLAN_THREADS];
  const float* low_depth = lows;
  float mn = f_inf(), mx = -f_inf();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    mn = fminf(mn, low_depth[s]);
    mx = fmaxf(mx, low_depth[s]);
  }
  smin[threadIdx.x] = mn;
  smax[threadIdx.x] = mx;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) {
      smin[threadIdx.x] = fminf(smin[threadIdx.x], smin[threadIdx.x + off]);
      smax[threadIdx.x] = fmaxf(smax[threadIdx.x], smax[threadIdx.x + off]);
    }
    __syncthreads();
  }
  const float depth_range = fmaxf(smax[0] - smin[0], 1e-3f);
  const float gate_val = depth_range * 0.01f;
  const int L = M + 1;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    float lowest = f_inf();
    float x[MAXL];
    for (int m = 0; m < M; ++m) {
      float icp = lows[(size_t)(1 + m) * S + s];
      float conf = lows[(size_t)(1 + M + m) * S + s];
      if (m == 0 ? conf < 0.3f : conf <= 0.4f) icp = gate_val;
      float err = active[m] ? icp / depth_range : f_inf();
      if (err < lowest) lowest = err;
      x[m] = clamp_unary(40.0f * err);
    }
    float un_new = fmaxf(5.0f - 40.0f * lowest, 0.01f);
    if (!allow_new) un_new = f_inf();
    x[M] = clamp_unary(un_new);
    for (int l = 0; l < L; ++l) {
      unary[(size_t)s * L + l] = x[l];
      x[l] = -x[l];
    }
    softmax(x, L);
    for (int l = 0; l < L; ++l) q0[(size_t)s * L + l] = x[l];
    float* f = feat + 6 * s;
    f[0] = mean_xy[2 * s] * 0.125f;
    f[1] = mean_xy[2 * s + 1] * 0.125f;
    const float rgb_scale = (float)(1.0 / 30.0);
    f[2] = mean_color[3 * s] * rgb_scale;
    f[3] = mean_color[3 * s + 1] * rgb_scale;
    f[4] = mean_color[3 * s + 2] * rgb_scale;
    f[5] = fminf(low_depth[s] * 2.5f, 100.0f);
  }
}

// one block per row i: both kernel rows (minus the identity) and the
// inverse square roots of their row sums
__global__ void __launch_bounds__(THREADS)
kernel_rows(const float* __restrict__ feat, int S, float* __restrict__ ks,
            float* __restrict__ ka, float* __restrict__ dinv) {
  __shared__ float r1[THREADS], r2[THREADS];
  const int i = blockIdx.x;
  float fi[6];
  for (int k = 0; k < 6; ++k) fi[k] = feat[6 * i + k];
  const float xi = fi[0] * 1.0f / 2.0f, yi = fi[1] * 1.0f / 2.0f;
  float s1 = 0.f, s2 = 0.f;
  for (int j = threadIdx.x; j < S; j += THREADS) {
    const float* fj = feat + 6 * j;
    float dx = xi - fj[0] * 1.0f / 2.0f, dy = yi - fj[1] * 1.0f / 2.0f;
    float dxy = dx * dx + dy * dy;
    float df = 0.f;
    for (int k = 0; k < 6; ++k) {
      float e = fi[k] - fj[k];
      df = k == 0 ? e * e : df + e * e;
    }
    float eye = i == j ? 1.f : 0.f;
    float v1 = expf(-0.5f * dxy) - eye;
    float v2 = expf(-0.5f * df) - eye;
    ks[(size_t)i * S + j] = v1;
    ka[(size_t)i * S + j] = v2;
    s1 = s1 + v1;
    s2 = s2 + v2;
  }
  r1[threadIdx.x] = s1;
  r2[threadIdx.x] = s2;
  __syncthreads();
  for (int off = THREADS / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) {
      r1[threadIdx.x] = r1[threadIdx.x] + r1[threadIdx.x + off];
      r2[threadIdx.x] = r2[threadIdx.x] + r2[threadIdx.x + off];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    dinv[i] = 1.f / sqrtf(fmaxf(r1[0], 1e-12f));
    dinv[S + i] = 1.f / sqrtf(fmaxf(r2[0], 1e-12f));
  }
}

__global__ void normalise(float* __restrict__ ks, float* __restrict__ ka,
                          const float* __restrict__ dinv, int S) {
  size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (size_t)S * S) return;
  int i = (int)(e / S), j = (int)(e % S);
  ks[e] = ks[e] * dinv[i] * dinv[j];
  ka[e] = ka[e] * dinv[S + i] * dinv[S + j];
}

// one warp per row: Q_i <- softmax(-unary_i - Potts(40 Ks_i q + 40 Ka_i q))
__global__ void __launch_bounds__(THREADS)
iterate(const float* __restrict__ q, const float* __restrict__ unary,
        const float* __restrict__ ks, const float* __restrict__ ka, int S, int L, float w_s,
        float w_a, float* __restrict__ out, int* __restrict__ lbl) {
  int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  int lane = threadIdx.x & 31;
  if (i >= S) return;
  float as[MAXL], aa[MAXL];
#pragma unroll
  for (int l = 0; l < MAXL; ++l) {
    as[l] = 0.f;
    aa[l] = 0.f;
  }
  const float* rs = ks + (size_t)i * S;
  const float* ra = ka + (size_t)i * S;
  for (int j = lane; j < S; j += 32) {
    float k1 = rs[j], k2 = ra[j];
    const float* qj = q + (size_t)j * L;
#pragma unroll
    for (int l = 0; l < MAXL; ++l) {
      if (l < L) {
        float qv = qj[l];
        as[l] = as[l] + k1 * qv;
        aa[l] = aa[l] + k2 * qv;
      }
    }
  }
#pragma unroll
  for (int l = 0; l < MAXL; ++l) {
    if (l < L) {
      for (int off = 16; off > 0; off >>= 1) {
        as[l] = as[l] + __shfl_down_sync(FULL, as[l], off);
        aa[l] = aa[l] + __shfl_down_sync(FULL, aa[l], off);
      }
    }
  }
  if (lane != 0) return;
  float msg[MAXL], x[MAXL];
  float tot = 0.f;
#pragma unroll
  for (int l = 0; l < MAXL; ++l) {
    if (l < L) {
      msg[l] = w_s * as[l] + w_a * aa[l];
      tot = tot + msg[l];
    }
  }
#pragma unroll
  for (int l = 0; l < MAXL; ++l)
    if (l < L) x[l] = -unary[(size_t)i * L + l] - (tot - msg[l]);
  softmax(x, L);
  int best = 0;
  for (int l = 0; l < L; ++l) {
    out[(size_t)i * L + l] = x[l];
    if (x[l] > x[best]) best = l;
  }
  if (lbl != nullptr) lbl[i] = best;
}

}  // namespace

extern "C" int mmf_lcrf_plan(const float* lows, const float* mean_color, const float* mean_xy,
                             const bool* active, int M, int S, int allow_new, float* unary,
                             float* feat, float* ks, float* ka, float* dinv, float* q0,
                             cudaStream_t stream) {
  if (M + 1 > MAXL) return (int)cudaErrorInvalidValue;
  inputs<<<1, PLAN_THREADS, 0, stream>>>(lows, mean_color, mean_xy, active, M, S, allow_new,
                                          unary, feat, q0);
  kernel_rows<<<S, THREADS, 0, stream>>>(feat, S, ks, ka, dinv);
  size_t n = (size_t)S * S;
  normalise<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(ks, ka, dinv, S);
  return (int)cudaGetLastError();
}

extern "C" int mmf_lcrf_iterate(const float* q, const float* unary, const float* ks,
                                const float* ka, int S, int L, float w_s, float w_a, float* out,
                                int* lbl, cudaStream_t stream) {
  if (L > MAXL) return (int)cudaErrorInvalidValue;
  iterate<<<(S + WARPS - 1) / WARPS, THREADS, 0, stream>>>(q, unary, ks, ka, S, L, w_s, w_a,
                                                           out, lbl);
  return (int)cudaGetLastError();
}
