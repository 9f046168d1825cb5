// K19 keypoints: patch_score, nms_topk and patch_desc of the patch detector.
//
// Replaces: multimotionfusion_tpu/tracking/superpoint.py:190 patch_detect (the
//   Shi-Tomasi front end :203-218 with ops/image.py:144 sobel_gradients and
//   :199 gaussian_blur, the descriptor :221-235) and :143 _nms_topk (also the
//   selection of superpoint_detect).
// Bound on an H100: bytes, and at 640x480 launch latency. patch_score reads
//   the intensity once and writes two images (3.7 MB); nms_topk reads the
//   score image about once per radix round that runs (at most 8, usually 4)
//   from L2; patch_desc reads 64 samples per keypoint.
// Design:
//   - patch_score: one 32x8 tile per block with a 3-pixel halo of intensity
//     in shared memory; the int16-truncated Sobel products at a 2-pixel halo
//     (zero outside the image, the blur's padding), the horizontal 5-tap
//     passes of the three products and of the intensity, then the vertical
//     passes, the minimum eigenvalue and the 8-pixel border, taps in the
//     reference's order from a zero sum, weights computed on the host as the
//     reference computes them (numpy float32);
//   - nms_topk: the exact top-K of the NMS peak scores with ties to the lower
//     flat index, whatever the number of peaks (a plateau makes every pixel of
//     it a peak). Each pixel's 64-bit key (order-preserving score bits << 32 |
//     0xffffffff - index) is unique, so the K largest keys are the answer. A
//     radix select over the keys, 8 bits a round from the top (the NMS pass
//     histograms the first round; each later round histograms the pixels that
//     match the prefix so far and stops once the rest of a bin is all taken),
//     finds them; one pass gathers the K selected keys and one block sorts
//     them (bitonic) and writes xy, score and valid;
//   - patch_desc: one warp per keypoint, two samples a lane; the mean and the
//     norm are a lane sum then a shuffle-down tree, the order of the plain
//     version (tracking/superpoint.py::_warp_sum).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "common.cuh"

constexpr int TX = 32, TY = 8;
constexpr int BR = 2;    // blur radius
constexpr int HALO = 3;  // Sobel (1) + blur (2)
constexpr int MAX_R = 8; // largest NMS radius
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct Taps {
  float a[5];
};

__device__ inline float neg_inf() { return __uint_as_float(0xff800000u); }

__global__ void __launch_bounds__(TX * TY)
patch_score_kernel(const float* __restrict__ img, int H, int W, Taps k15, Taps k10,
                   float* __restrict__ score, float* __restrict__ blurred) {
  constexpr int IW = TX + 2 * HALO, IH = TY + 2 * HALO;
  constexpr int PW = TX + 2 * BR, PH = TY + 2 * BR;
  __shared__ float s_i[IH][IW];
  __shared__ float s_p[3][PH][PW];
  __shared__ float s_h[4][PH][TX];
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int q = tid; q < IH * IW; q += TX * TY) {
    int ly = q / IW, lx = q % IW;
    int gy = y0 + ly - HALO, gx = x0 + lx - HALO;
    s_i[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[gy * W + gx] : 0.f;
  }
  __syncthreads();
  // Sobel products (taps of ops/image.py's _conv2d, zero taps skipped)
  const float k1 = 0.52201f, k2 = 0.79451f;
  for (int q = tid; q < PH * PW; q += TX * TY) {
    int ly = q / PW, lx = q % PW;
    int gy = y0 + ly - BR, gx = x0 + lx - BR;
    float pxx = 0.f, pyy = 0.f, pxy = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      int cy = ly + 1, cx = lx + 1;
      float gxv = -k1 * s_i[cy - 1][cx - 1];
      gxv = gxv + k1 * s_i[cy - 1][cx + 1];
      gxv = gxv + -k2 * s_i[cy][cx - 1];
      gxv = gxv + k2 * s_i[cy][cx + 1];
      gxv = gxv + -k1 * s_i[cy + 1][cx - 1];
      gxv = gxv + k1 * s_i[cy + 1][cx + 1];
      float gyv = -k1 * s_i[cy - 1][cx - 1];
      gyv = gyv + -k2 * s_i[cy - 1][cx];
      gyv = gyv + -k1 * s_i[cy - 1][cx + 1];
      gyv = gyv + k1 * s_i[cy + 1][cx - 1];
      gyv = gyv + k2 * s_i[cy + 1][cx];
      gyv = gyv + k1 * s_i[cy + 1][cx + 1];
      gxv = truncf(gxv);
      gyv = truncf(gyv);
      pxx = gxv * gxv;
      pyy = gyv * gyv;
      pxy = gxv * gyv;
    }
    s_p[0][ly][lx] = pxx;
    s_p[1][ly][lx] = pyy;
    s_p[2][ly][lx] = pxy;
  }
  __syncthreads();
  // horizontal passes over the tile's columns, rows -2..TY+1
  for (int q = tid; q < PH * TX; q += TX * TY) {
    int ly = q / TX, lx = q % TX;
    for (int c = 0; c < 3; ++c) {
      float acc = 0.f;
      for (int i = 0; i < 2 * BR + 1; ++i) acc = acc + k15.a[i] * s_p[c][ly][lx + i];
      s_h[c][ly][lx] = acc;
    }
    float acc = 0.f;
    for (int i = 0; i < 2 * BR + 1; ++i) acc = acc + k10.a[i] * s_i[ly + 1][lx + 1 + i];
    s_h[3][ly][lx] = acc;
  }
  __syncthreads();
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = x0 + tx, y = y0 + ty;
  if (x >= W || y >= H) return;
  float v[4];
  for (int c = 0; c < 4; ++c) {
    const Taps& k = c < 3 ? k15 : k10;
    float acc = 0.f;
    for (int i = 0; i < 2 * BR + 1; ++i) acc = acc + k.a[i] * s_h[c][ty + i][tx];
    v[c] = acc;
  }
  float ixx = v[0], iyy = v[1], ixy = v[2];
  float tr = ixx + iyy;
  float det = ixx * iyy - ixy * ixy;
  float disc = sqrtf(fmaxf(tr * tr / 4.f - det, 0.f));
  float min_eig = tr / 2.f - disc;
  bool inside = y >= 8 && y < H - 8 && x >= 8 && x < W - 8;
  score[y * W + x] = inside ? min_eig : 0.f;
  blurred[y * W + x] = v[3];
}

// ---------------------------------------------------------------- nms_topk

enum { C_PREFIX = 0, C_MASK = 1, C_KREM = 2, C_DONE = 3, C_COUNT = 4 };

__device__ inline unsigned long long make_key(float s, int i) {
  return ((unsigned long long)ord32(s) << 32) | (unsigned long long)(0xffffffffu - (unsigned)i);
}

__global__ void select_init(unsigned long long* ctl, unsigned* hist, int K) {
  int t = threadIdx.x;
  hist[t] = 0u;
  if (t < 8) ctl[t] = t == C_KREM ? (unsigned long long)K : 0ull;
}

// peak scores (0 off the peaks) and the histogram of the keys' top byte
__global__ void __launch_bounds__(TX * TY)
nms_kernel(const float* __restrict__ heat, int H, int W, float thr, int r,
           float* __restrict__ scores, unsigned* __restrict__ hist) {
  constexpr int SW = TX + 2 * MAX_R;
  __shared__ float s[TY + 2 * MAX_R][SW];
  __shared__ unsigned sh[256];
  const int tid = threadIdx.y * TX + threadIdx.x;
  sh[tid] = 0u;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int lw = TX + 2 * r, lh = TY + 2 * r;
  for (int q = tid; q < lw * lh; q += TX * TY) {
    int ly = q / lw, lx = q % lw;
    int gy = y0 + ly - r, gx = x0 + lx - r;
    s[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? heat[gy * W + gx] : neg_inf();
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x < W && y < H) {
    float v = s[threadIdx.y + r][threadIdx.x + r];
    float m = neg_inf();
    for (int dy = 0; dy <= 2 * r; ++dy)
      for (int dx = 0; dx <= 2 * r; ++dx) m = fmaxf(m, s[threadIdx.y + dy][threadIdx.x + dx]);
    float sc = (v == m && v > thr) ? v : 0.f;
    int p = y * W + x;
    scores[p] = sc;
    atomicAdd(&sh[make_key(sc, p) >> 56], 1u);
  }
  __syncthreads();
  if (sh[tid]) atomicAdd(&hist[tid], sh[tid]);
}

// the histogram of one radix round over the keys that match the prefix
__global__ void __launch_bounds__(THREADS)
hist_kernel(const float* __restrict__ scores, int n, const unsigned long long* __restrict__ ctl,
            unsigned* __restrict__ hist, int shift) {
  if (ctl[C_DONE]) return;
  __shared__ unsigned sh[256];
  sh[threadIdx.x] = 0u;
  __syncthreads();
  const unsigned long long prefix = ctl[C_PREFIX], mask = ctl[C_MASK];
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n; i += gridDim.x * THREADS) {
    unsigned long long key = make_key(scores[i], i);
    if ((key & mask) == prefix) atomicAdd(&sh[(key >> shift) & 255ull], 1u);
  }
  __syncthreads();
  if (sh[threadIdx.x]) atomicAdd(&hist[threadIdx.x], sh[threadIdx.x]);
}

// pick the bin that holds the remaining K-th largest key; reset the histogram
__global__ void pick_kernel(unsigned long long* ctl, unsigned* hist, int shift) {
  __shared__ unsigned h[256];
  const int t = threadIdx.x;
  h[t] = hist[t];
  __syncthreads();
  hist[t] = 0u;
  if (t != 0 || ctl[C_DONE]) return;
  unsigned long long krem = ctl[C_KREM], cum = 0ull;
  int b = 255;
  for (; b > 0; --b) {
    if (cum + h[b] >= krem) break;
    cum += h[b];
  }
  krem -= cum;
  ctl[C_PREFIX] |= (unsigned long long)b << shift;
  ctl[C_MASK] |= 255ull << shift;
  ctl[C_KREM] = krem;
  if ((unsigned long long)h[b] == krem) ctl[C_DONE] = 1ull;
}

// gather the K keys at or above the selected prefix (order does not matter)
__global__ void __launch_bounds__(THREADS)
gather_kernel(const float* __restrict__ scores, int n, unsigned long long* ctl,
              unsigned long long* __restrict__ cand, int K) {
  const unsigned long long prefix = ctl[C_PREFIX], mask = ctl[C_MASK];
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n; i += gridDim.x * THREADS) {
    unsigned long long key = make_key(scores[i], i);
    if ((key & mask) >= prefix) {
      unsigned long long pos = atomicAdd(&ctl[C_COUNT], 1ull);
      if (pos < (unsigned long long)K) cand[pos] = key;
    }
  }
}

// bitonic sort of the K keys, descending, then the outputs
__global__ void __launch_bounds__(1024)
sort_kernel(const unsigned long long* __restrict__ cand, int K, int P, int W,
            float* __restrict__ xy, float* __restrict__ score, bool* __restrict__ valid) {
  __shared__ unsigned long long s[1024];
  const int t = threadIdx.x;
  if (t < P) s[t] = t < K ? cand[t] : 0ull;
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      int ixj = t ^ j;
      if (t < P && ixj > t) {
        unsigned long long a = s[t], b = s[ixj];
        bool desc = (t & k) == 0;
        if (desc ? (a < b) : (a > b)) {
          s[t] = b;
          s[ixj] = a;
        }
      }
      __syncthreads();
    }
  }
  if (t >= K) return;
  unsigned long long key = s[t];
  unsigned idx = 0xffffffffu - (unsigned)(key & 0xffffffffull);
  float sc = unord32((unsigned)(key >> 32));
  xy[2 * t] = (float)(idx % (unsigned)W);
  xy[2 * t + 1] = (float)(idx / (unsigned)W);
  score[t] = sc;
  valid[t] = sc > 0.f;
}

// ---------------------------------------------------------------- patch_desc

__global__ void __launch_bounds__(THREADS)
patch_desc_kernel(const float* __restrict__ blurred, int H, int W, const float* __restrict__ xy,
                  int K, float* __restrict__ desc) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (k >= K) return;  // whole warps
  const float x = xy[2 * k], y = xy[2 * k + 1];
  float v[2];
  for (int h = 0; h < 2; ++h) {
    int s = lane + 32 * h;
    float oy = ((float)(s >> 3) - 3.5f) * 2.f;
    float ox = ((float)(s & 7) - 3.5f) * 2.f;
    int xi = min(max(__float2int_rn(x + ox), 0), W - 1);
    int yi = min(max(__float2int_rn(y + oy), 0), H - 1);
    v[h] = blurred[yi * W + xi];
  }
  float a = v[0] + v[1];
  for (int off = 16; off > 0; off >>= 1) a = a + __shfl_down_sync(FULL, a, off);
  const float mean = __shfl_sync(FULL, a, 0) / 64.f;
  const float c0 = v[0] - mean, c1 = v[1] - mean;
  float b = c0 * c0 + c1 * c1;
  for (int off = 16; off > 0; off >>= 1) b = b + __shfl_down_sync(FULL, b, off);
  const float nrm = fmaxf(sqrtf(__shfl_sync(FULL, b, 0)), 1e-12f);
  desc[k * 64 + lane] = c0 / nrm;
  desc[k * 64 + lane + 32] = c1 / nrm;
}

int blocks_for(int n) {
  int b = (n + THREADS - 1) / THREADS;
  return b < 1 ? 1 : (b > 1024 ? 1024 : b);
}

}  // namespace

extern "C" int mmf_patch_score(const float* img, int H, int W, float a0, float a1, float a2,
                               float a3, float a4, float b0, float b1, float b2, float b3,
                               float b4, float* score, float* blurred, cudaStream_t stream) {
  Taps k15{{a0, a1, a2, a3, a4}}, k10{{b0, b1, b2, b3, b4}};
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  patch_score_kernel<<<grid, dim3(TX, TY), 0, stream>>>(img, H, W, k15, k10, score, blurred);
  return (int)cudaGetLastError();
}

extern "C" int mmf_nms_topk(const float* heat, int H, int W, int K, float thr, int r,
                            float* scores, unsigned* hist, unsigned long long* ctl,
                            unsigned long long* cand, float* xy, float* score, bool* valid,
                            cudaStream_t stream) {
  const int n = H * W;
  select_init<<<1, 256, 0, stream>>>(ctl, hist, K);
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  nms_kernel<<<grid, dim3(TX, TY), 0, stream>>>(heat, H, W, thr, r, scores, hist);
  pick_kernel<<<1, 256, 0, stream>>>(ctl, hist, 56);
  for (int shift = 48; shift >= 0; shift -= 8) {
    hist_kernel<<<blocks_for(n), THREADS, 0, stream>>>(scores, n, ctl, hist, shift);
    pick_kernel<<<1, 256, 0, stream>>>(ctl, hist, shift);
  }
  gather_kernel<<<blocks_for(n), THREADS, 0, stream>>>(scores, n, ctl, cand, K);
  int P = 1;
  while (P < K) P <<= 1;
  sort_kernel<<<1, 1024, 0, stream>>>(cand, K, P, W, xy, score, valid);
  return (int)cudaGetLastError();
}

extern "C" int mmf_patch_desc(const float* blurred, int H, int W, const float* xy, int K,
                              float* desc, cudaStream_t stream) {
  const int per_block = THREADS / 32;
  patch_desc_kernel<<<(K + per_block - 1) / per_block, THREADS, 0, stream>>>(blurred, H, W, xy,
                                                                           K, desc);
  return (int)cudaGetLastError();
}
