// K19 keypoints: patch_score, nms_topk and patch_desc of the patch detector.
//
// Replaces: multimotionfusion_tpu/tracking/superpoint.py:190 patch_detect (the
//   Shi-Tomasi front end :203-218 with ops/image.py:144 sobel_gradients and
//   :199 gaussian_blur, the descriptor :221-235) and :143 _nms_topk (also the
//   selection of superpoint_detect).
// Bound on an H100: bytes, and at 640x480 launch latency. patch_score reads
//   the intensity once and writes two images (3.7 MB); nms_topk reads the
//   heat map once and the peak scores once more from L2 (at most four radix
//   rounds follow, each behind a cluster barrier); patch_desc reads 64
//   samples per keypoint.
// Design:
//   - patch_score: one 32x20 output tile a block of 256 threads, so 480
//     blocks at 640x480 fit the card in one wave; the tile's intensities
//     with a 3-pixel halo in shared memory (every load of a thread in
//     flight together); the int16-truncated Sobel products at a 2-pixel
//     halo (zero outside the image, the blur's padding), six along a row a
//     thread from its 3 x 8 intensities (float2 reads); the horizontal
//     5-tap passes of the three products and of the intensity, four along a
//     row a thread (float4 reads); then each thread's vertical passes down
//     four rows of a column from a window of its eight horizontal sums in
//     registers, the minimum eigenvalue and the 8-pixel border; taps in the
//     reference's order from a zero sum, weights computed on the host as
//     the reference computes them (numpy float32);
//   - nms_topk: the exact top-K of the NMS peak scores with ties to the lower
//     flat index, whatever the number of peaks (a plateau makes every pixel of
//     it a peak), in two launches: nms_kernel (one 32x32 tile a block, the
//     window max as row maxima of the staged rows, then column maxima of
//     those) writes the peak scores; select_kernel, one cluster of 16 blocks
//     (no one-block kernel), selects and ranks. Each pixel's 64-bit key
//     (order-preserving score bits << 32 | 0xffffffff - index) is unique, so
//     the K largest keys are the answer: the zero scores counted and the
//     other keys listed in one pass, then a radix select over the score bits
//     (8 a round from the top, the blocks' histograms summed through
//     distributed shared memory, every block picking the same bin; it stops
//     once the rest of a bin is all taken or at most 1,024 keys are left to
//     rank), the ties at the last byte's score by index rank; every block then
//     ranks a sixteenth of the selected keys among all and writes those
//     ranked below K: xy, score and valid (see select_kernel);
//   - patch_desc: one warp per keypoint, two samples a lane; the mean and the
//     norm are a lane sum then a shuffle-down tree, the order of the plain
//     version (tracking/superpoint.py::_warp_sum).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

#include "common.cuh"

constexpr int BR = 2;    // blur radius
constexpr int HALO = 3;  // Sobel (1) + blur (2)
constexpr int MAX_R = 8; // largest NMS radius
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
// patch_score: a PS_TX x PS_TY output tile a block of PS_T threads. Each
// thread computes PS_PSEG Sobel products along a row (its intensities read
// as float2 pairs, shared between neighbouring taps), then PS_HSEG
// horizontal sums along a row (float4 reads), then PS_RPT vertical sums down
// a column (PS_ROWS thread rows)
constexpr int PS_TX = 32, PS_TY = 20, PS_ROWS = 5, PS_T = 256;
constexpr int PS_RPT = PS_TY / PS_ROWS;  // output rows a thread
constexpr int PS_IW = PS_TX + 2 * HALO, PS_IH = PS_TY + 2 * HALO;  // staged intensities
constexpr int PS_IWP = 40;                                         // their row stride
constexpr int PS_PW = PS_TX + 2 * BR, PS_PH = PS_TY + 2 * BR;      // Sobel products
constexpr int PS_PSEG = 6, PS_HSEG = 4;
static_assert(PS_TY % PS_ROWS == 0 && PS_ROWS * PS_TX <= PS_T, "the vertical pass");
static_assert(PS_PW % PS_PSEG == 0 && PS_PSEG % 2 == 0 && PS_PH * (PS_PW / PS_PSEG) <= PS_T,
              "the products in one pass, float2 reads");
static_assert(PS_TX % PS_HSEG == 0 && PS_HSEG == 4 && PS_PH * (PS_TX / PS_HSEG) <= PS_T,
              "the horizontal sums in one pass, float4 reads");
static_assert(PS_IWP >= PS_TX + 8 && PS_IWP % 4 == 0 && PS_PW % 4 == 0, "16-byte rows");

struct Taps {
  float a[5];
};

__device__ inline float neg_inf() { return __uint_as_float(0xff800000u); }

__global__ void __launch_bounds__(PS_T)
patch_score_kernel(const float* __restrict__ img, int H, int W, Taps k15, Taps k10,
                   float* __restrict__ score, float* __restrict__ blurred) {
  __shared__ __align__(16) float s_i[PS_IH][PS_IWP];
  __shared__ __align__(16) float s_p[3][PS_PH][PS_PW];
  __shared__ __align__(16) float s_h[4][PS_PH][PS_TX];  // horizontal sums, rows -2..PS_TY+1
  const int x0 = blockIdx.x * PS_TX, y0 = blockIdx.y * PS_TY;
  const int tid = threadIdx.x;
  // 1. the intensities with the halo, zero outside the image
  constexpr int NI = (PS_IH * PS_IW + PS_T - 1) / PS_T;
  float v[NI];
#pragma unroll
  for (int e = 0; e < NI; ++e) {
    const int q = tid + e * PS_T;
    const int ly = q / PS_IW, lx = q - ly * PS_IW;
    const int gy = y0 + ly - HALO, gx = x0 + lx - HALO;
    v[e] = (q < PS_IH * PS_IW && gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[gy * W + gx]
                                                                          : 0.f;
  }
#pragma unroll
  for (int e = 0; e < NI; ++e) {
    const int q = tid + e * PS_T;
    if (q < PS_IH * PS_IW) s_i[q / PS_IW][q % PS_IW] = v[e];
  }
  __syncthreads();
  // 2. Sobel products (taps of ops/image.py's _conv2d, zero taps skipped) at
  // PS_PSEG positions of a row, from the 3 x (PS_PSEG + 2) intensities around them
  if (tid < PS_PH * (PS_PW / PS_PSEG)) {
    const float k1 = 0.52201f, k2 = 0.79451f;
    const int ly = tid / (PS_PW / PS_PSEG), lx0 = (tid - ly * (PS_PW / PS_PSEG)) * PS_PSEG;
    float w[3][PS_PSEG + 2];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int j = 0; j < (PS_PSEG + 2) / 2; ++j) {
        const float2 f = reinterpret_cast<const float2*>(&s_i[ly + r][lx0])[j];
        w[r][2 * j] = f.x;
        w[r][2 * j + 1] = f.y;
      }
    const int gy = y0 + ly - BR;
    float p[3][PS_PSEG];
#pragma unroll
    for (int k = 0; k < PS_PSEG; ++k) {
      const int gx = x0 + lx0 + k - BR;
      p[0][k] = p[1][k] = p[2][k] = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        float gxv = -k1 * w[0][k];
        gxv = gxv + k1 * w[0][k + 2];
        gxv = gxv + -k2 * w[1][k];
        gxv = gxv + k2 * w[1][k + 2];
        gxv = gxv + -k1 * w[2][k];
        gxv = gxv + k1 * w[2][k + 2];
        float gyv = -k1 * w[0][k];
        gyv = gyv + -k2 * w[0][k + 1];
        gyv = gyv + -k1 * w[0][k + 2];
        gyv = gyv + k1 * w[2][k];
        gyv = gyv + k2 * w[2][k + 1];
        gyv = gyv + k1 * w[2][k + 2];
        gxv = truncf(gxv);
        gyv = truncf(gyv);
        p[0][k] = gxv * gxv;
        p[1][k] = gyv * gyv;
        p[2][k] = gxv * gyv;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int j = 0; j < PS_PSEG / 2; ++j)
        reinterpret_cast<float2*>(&s_p[c][ly][lx0])[j] = make_float2(p[c][2 * j], p[c][2 * j + 1]);
  }
  __syncthreads();
  // 3. horizontal passes at PS_HSEG columns of a row, rows -2..PS_TY+1: the
  // products' taps, and the intensity's from the staged row
  if (tid < PS_PH * (PS_TX / PS_HSEG)) {
    const int ly = tid / (PS_TX / PS_HSEG), c0 = (tid - ly * (PS_TX / PS_HSEG)) * PS_HSEG;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const Taps& k = c < 3 ? k15 : k10;
      float u[12];  // products c0..c0+7, or intensities at staged columns c0..c0+11
      const float4* src = c < 3 ? reinterpret_cast<const float4*>(&s_p[c][ly][c0])
                                : reinterpret_cast<const float4*>(&s_i[ly + 1][c0]);
#pragma unroll
      for (int j = 0; j < (c < 3 ? 2 : 3); ++j) {
        const float4 f = src[j];
        u[4 * j] = f.x;
        u[4 * j + 1] = f.y;
        u[4 * j + 2] = f.z;
        u[4 * j + 3] = f.w;
      }
      const int off = c < 3 ? 0 : 1;  // the intensity's taps start one column on
      float h[PS_HSEG];
#pragma unroll
      for (int o = 0; o < PS_HSEG; ++o) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < 2 * BR + 1; ++i) acc = acc + k.a[i] * u[off + o + i];
        h[o] = acc;
      }
      *reinterpret_cast<float4*>(&s_h[c][ly][c0]) = make_float4(h[0], h[1], h[2], h[3]);
    }
  }
  __syncthreads();
  // 4. vertical passes: the thread's PS_RPT rows from its column's window
  const int tx = tid % PS_TX, ty = tid / PS_TX;
  const int x = x0 + tx, r0 = ty * PS_RPT;
  if (ty >= PS_ROWS || x >= W) return;
  float o[4][PS_RPT];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const Taps& k = c < 3 ? k15 : k10;
    float w[PS_RPT + 2 * BR];
#pragma unroll
    for (int j = 0; j < PS_RPT + 2 * BR; ++j) w[j] = s_h[c][r0 + j][tx];
#pragma unroll
    for (int r = 0; r < PS_RPT; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 2 * BR + 1; ++i) acc = acc + k.a[i] * w[r + i];
      o[c][r] = acc;
    }
  }
#pragma unroll
  for (int r = 0; r < PS_RPT; ++r) {
    const int y = y0 + r0 + r;
    if (y >= H) break;
    const float ixx = o[0][r], iyy = o[1][r], ixy = o[2][r];
    const float tr = ixx + iyy;
    const float det = ixx * iyy - ixy * ixy;
    const float disc = sqrtf(fmaxf(tr * tr / 4.f - det, 0.f));
    const float min_eig = tr / 2.f - disc;
    const bool inside = y >= 8 && y < H - 8 && x >= 8 && x < W - 8;
    score[y * W + x] = inside ? min_eig : 0.f;
    blurred[y * W + x] = o[3][r];
  }
}

// ---------------------------------------------------------------- nms_topk

// peak scores (0 off the peaks) of an NMS_W x NMS_H tile, four rows a
// thread: the (2R+1)^2 window max as row maxima of the staged rows, then
// column maxima of those (max is exact in any order, so v == m decides as a
// direct window does); one instance a radius, so the taps unroll
constexpr int NMS_W = 32, NMS_H = 32, NMS_T = 256;

template <int R>
__global__ void __launch_bounds__(NMS_T)
nms_kernel(const float* __restrict__ heat, int H, int W, float thr, float* __restrict__ scores) {
  constexpr int LW = NMS_W + 2 * R, LH = NMS_H + 2 * R;
  __shared__ float s[LH][LW];
  __shared__ float rm[LH][NMS_W];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * NMS_W, y0 = blockIdx.y * NMS_H;
#pragma unroll
  for (int e = 0; e < (LH * LW + NMS_T - 1) / NMS_T; ++e) {
    const int q = tid + e * NMS_T;
    if (q < LH * LW) {
      const int ly = q / LW, lx = q - ly * LW;
      const int gy = y0 + ly - R, gx = x0 + lx - R;
      s[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? heat[gy * W + gx] : neg_inf();
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < (LH * NMS_W + NMS_T - 1) / NMS_T; ++e) {
    const int q = tid + e * NMS_T;
    if (q < LH * NMS_W) {
      const int ly = q / NMS_W, lx = q % NMS_W;
      float m = neg_inf();
#pragma unroll
      for (int dx = 0; dx <= 2 * R; ++dx) m = fmaxf(m, s[ly][lx + dx]);
      rm[ly][lx] = m;
    }
  }
  __syncthreads();
  const int tx = tid % NMS_W, x = x0 + tx;
  if (x >= W) return;
#pragma unroll
  for (int e = 0; e < NMS_H / (NMS_T / NMS_W); ++e) {
    const int ty = tid / NMS_W + e * (NMS_T / NMS_W), y = y0 + ty;
    if (y >= H) return;
    float m = neg_inf();
#pragma unroll
    for (int dy = 0; dy <= 2 * R; ++dy) m = fmaxf(m, rm[ty + dy][tx]);
    const float v = s[ty + R][tx + R];
    scores[y * W + x] = (v == m && v > thr) ? v : 0.f;
  }
}

template <int R>
void launch_nms(const float* heat, int H, int W, float thr, float* scores, cudaStream_t stream) {
  dim3 grid((W + NMS_W - 1) / NMS_W, (H + NMS_H - 1) / NMS_H);
  nms_kernel<R><<<grid, NMS_T, 0, stream>>>(heat, H, W, thr, scores);
}

constexpr unsigned ZERO = 0x80000000u;  // ord32(+0.0f): every pixel that is no peak
constexpr int SEL_C = 16;    // blocks of the selection's cluster
constexpr int SEL_T = 1024;  // threads a block
constexpr int MAX_K = 1024;  // tracking/superpoint.py's _MAX_KP
constexpr int RANK_LANES = 16;  // lanes that rank one key
constexpr size_t SEL_STAGE_MAX = 180 * 1024;  // a block's staged bits for the ties, bytes
constexpr int LIST_CAP = 4096;  // the non-zero keys a block lists
static_assert(SEL_T / RANK_LANES * SEL_C >= MAX_K, "one pass ranks MAX_K keys");

struct SelectArgs {
  const float* scores;
  int n, W, K;
  int chunk;   // pixels a block owns (a multiple of 4)
  int staged;  // the chunk's order-preserving score bits fit shared memory
  float* xy;
  float* score;
  bool* valid;
};

// count one key a lane into a shared histogram: the lanes that share the
// first active lane's bin add once, up to four such bins a warp (a plateau
// puts a whole warp into one bin), then one atomic a key
__device__ inline void hist_add(unsigned* h, bool on, unsigned bin) {
  unsigned act = __ballot_sync(FULL, on);
  for (int it = 0; it < 4 && act; ++it) {
    const int lead = __ffs(act) - 1;
    const unsigned b0 = __shfl_sync(FULL, bin, lead);
    const unsigned same = __ballot_sync(FULL, on && bin == b0) & act;
    if ((int)(threadIdx.x & 31) == lead) atomicAdd(&h[b0], (unsigned)__popc(same));
    act &= ~same;
  }
  if ((act >> (threadIdx.x & 31)) & 1u) atomicAdd(&h[bin], 1u);
}

__device__ inline void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// append the keys a warp selects to the block's list
__device__ inline void append_keys(bool sel, unsigned long long key, unsigned* count,
                                   unsigned long long* list) {
  const unsigned m = __ballot_sync(FULL, sel);
  if (m == 0u) return;
  const int lane = threadIdx.x & 31, lead = __ffs(m) - 1;
  unsigned base = 0u;
  if (lane == lead) base = atomicAdd(count, (unsigned)__popc(m));
  base = __shfl_sync(FULL, base, lead);
  if (sel) list[base + (unsigned)__popc(m & ((1u << lane) - 1u))] = key;
}

// The exact top-K of the peak scores: one cluster of SEL_C blocks; block b
// owns the pixels [b chunk, (b + 1) chunk). One pass over them counts the
// zero scores (most pixels: no peak) and lists the block's other keys, the
// order-preserving bits of their scores and their indices (up to
// LIST_CAP; past it every pass reads the scores again).
// A radix select over those 32 bits, 8 a round from the top: every block
// histograms its listed keys that match the prefix (and adds its zeros'
// count); after a cluster barrier every block sums the blocks' histograms
// through distributed shared memory and picks the same bin (the one holding
// the K-th largest). It stops once the rest of a bin is all taken, or once
// at most MAX_K keys lie at or above the prefix (most heat maps: two
// rounds); else, after the last byte, the threshold score T is exact and
// the krem ties at T to take are those of the lowest flat index (a key's
// low word is 0xffffffff - index): each block stages its scores' bits in
// shared memory and ranks its ties in index order after the ties of the
// blocks before it (their last histograms). Each block appends its
// selected keys to a list of its own; after a cluster barrier every block
// copies the n <= MAX_K keys of all lists (in block order) and takes the
// keys [b ceil(n / 16), ...) of that order: 16 lanes count the keys above
// one, and a key whose rank is below K is written at its rank (xy, score
// and valid). No block sorts alone.
__global__ void __launch_bounds__(SEL_T, 1) select_kernel(SelectArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned stage[];  // the chunk's bits, for the ties
  __shared__ unsigned hist[2][256];  // by round parity: other blocks read it after the barrier
  __shared__ unsigned list_u[LIST_CAP];         // the block's non-zero keys' bits
  __shared__ unsigned short list_i[LIST_CAP];   // and their indices in the chunk
  __shared__ unsigned long long cand[MAX_K];  // this block's selected keys
  __shared__ unsigned long long all[MAX_K];   // every block's, in block order
  __shared__ unsigned ncand, nlist, nzero, pick[3], wsum[32], offs[SEL_C + 1];
  const int b = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = min(a.n, b * a.chunk), len = min(a.n, lo + a.chunk) - lo;
  const float* g = a.scores + lo;
  // the order-preserving bits of the pixels lo + i ... lo + i + 3 (i a
  // multiple of 4; ZERO past the chunk)
  auto load4 = [&](int i, unsigned* u) {
    if (i + 3 < len) {
      const float4 f = *reinterpret_cast<const float4*>(g + i);
      u[0] = ord32(f.x), u[1] = ord32(f.y), u[2] = ord32(f.z), u[3] = ord32(f.w);
    } else {
      for (int j = 0; j < 4; ++j) u[j] = i + j < len ? ord32(g[i + j]) : ZERO;
    }
  };
  auto key_of = [&](unsigned u, int i) {
    return ((unsigned long long)u << 32) | (unsigned long long)(0xffffffffu - (unsigned)(lo + i));
  };
  if (tid == 0) {
    ncand = nzero = 0u;
    nlist = len <= 65536 ? 0u : LIST_CAP + 1u;  // a 16-bit index a listed key
  }
  __syncthreads();
  {  // one pass: the zero scores counted, the others listed (while they fit)
    unsigned zeros = 0u;
#pragma unroll 2
    for (int base = 0; base < len; base += 4 * SEL_T) {
      const int i = base + 4 * tid;
      unsigned u[4];
      load4(i, u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        zeros += u[j] == ZERO && i + j < len;
        const bool on = u[j] != ZERO && i + j < len;
        const unsigned m = __ballot_sync(FULL, on);
        if (m == 0u) continue;
        const int lead = __ffs(m) - 1;
        unsigned base_pos = 0u;
        if (lane == lead) base_pos = atomicAdd(&nlist, (unsigned)__popc(m));
        base_pos = __shfl_sync(FULL, base_pos, lead) + (unsigned)__popc(m & ((1u << lane) - 1u));
        if (on && base_pos < (unsigned)LIST_CAP) {
          list_u[base_pos] = u[j];
          list_i[base_pos] = (unsigned short)(i + j);
        }
      }
    }
    zeros = __reduce_add_sync(FULL, zeros);
    if (lane == 0 && zeros) atomicAdd(&nzero, zeros);
  }
  __syncthreads();
  const bool listed = nlist <= LIST_CAP;

  unsigned prefix = 0u, mask = 0u, krem = (unsigned)a.K, bin = 0u;
  bool done = false;
  int shift = 24, buf = 0;
  for (;; shift -= 8, buf ^= 1) {
    unsigned* h = hist[buf];
    if (tid < 256) h[tid] = 0u;
    __syncthreads();
    // the listed keys (else every non-zero key) and the zeros' count
    if (listed) {
      for (int base = 0; base < (int)nlist; base += SEL_T) {
        const int p = base + tid;
        const unsigned u = p < (int)nlist ? list_u[p] : ZERO;
        const bool on = u != ZERO && (u & mask) == prefix;
        if (__any_sync(FULL, on)) hist_add(h, on, (u >> shift) & 255u);
      }
    } else {
      for (int base = 0; base < len; base += 4 * SEL_T) {
        unsigned u[4];
        load4(base + 4 * tid, u);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool on = u[j] != ZERO && (u[j] & mask) == prefix;
          if (__any_sync(FULL, on)) hist_add(h, on, (u[j] >> shift) & 255u);
        }
      }
    }
    if (tid == 0 && nzero && (ZERO & mask) == prefix) atomicAdd(&h[(ZERO >> shift) & 255u], nzero);
    cluster.sync();  // every block's histogram of this round
    // the cluster's histogram, thread t < 256 the bin 255 - t: the pick is
    // the highest bin whose count with the bins above reaches krem, else 0
    unsigned cnt = 0u;
    if (tid < 256) {
      const unsigned* hb = h + 255 - tid;
#pragma unroll
      for (int j = 0; j < SEL_C; ++j) cnt += *cluster.map_shared_rank(hb, j);
    }
    unsigned incl = cnt;  // the count of this bin and the bins above
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31 && warp < 8) wsum[warp] = incl;
    __syncthreads();
    if (tid < 256)
      for (int w = 0; w < warp; ++w) incl += wsum[w];
    const int first = __syncthreads_count(tid < 255 && incl < krem);  // bins above the pick
    if (tid == first) {
      const unsigned cum = incl - cnt;
      pick[0] = (unsigned)(255 - tid);
      pick[1] = cum;
      // the keys at or above the new prefix: the K - krem above it and the
      // bin's; done where the rest of the bin is all taken, or where few
      // enough to rank them all
      pick[2] = cnt == krem - cum || (unsigned)a.K - (krem - cum) + cnt <= (unsigned)MAX_K;
    }
    __syncthreads();
    bin = pick[0];
    krem -= pick[1];
    done = pick[2] != 0u;
    prefix |= bin << shift;
    mask |= 255u << shift;
    if (done || shift == 0) break;
  }

  // the block's selected keys into its list
  if (done && listed && (ZERO & mask) < prefix) {  // the listed keys suffice
    for (int base = 0; base < (int)nlist; base += SEL_T) {
      const int p = base + tid;
      const unsigned u = p < (int)nlist ? list_u[p] : 0u;
      const int i = p < (int)nlist ? list_i[p] : 0;
      append_keys(p < (int)nlist && (u & mask) >= prefix, key_of(u, i), &ncand, cand);
    }
  } else if (done) {  // every key at or above the prefix: K of them, or at most MAX_K
    for (int base = 0; base < len; base += 4 * SEL_T) {
      const int i = base + 4 * tid;
      unsigned u[4];
      load4(i, u);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        append_keys(i + j < len && (u[j] & mask) >= prefix, key_of(u[j], i + j), &ncand, cand);
    }
  } else {  // every key above T, and the first krem ties at T in index order
    const bool staged = a.staged != 0;
    if (staged) {  // the chunk's bits in shared memory: each thread reads a run
      for (int i = 4 * tid; i < len; i += 4 * SEL_T) {
        unsigned u[4];
        load4(i, u);
        if (i + 3 < len) *reinterpret_cast<uint4*>(stage + i) = make_uint4(u[0], u[1], u[2], u[3]);
        else
          for (int j = 0; i + j < len; ++j) stage[i + j] = u[j];
      }
      __syncthreads();
    }
    auto bits = [&](int i) { return staged ? stage[i] : ord32(g[i]); };
    unsigned before = 0u;  // ties in the blocks before this one
    if (warp == 0) {
      const unsigned t = lane < b ? cluster.map_shared_rank(hist[buf], lane)[bin] : 0u;
      before = __reduce_add_sync(FULL, t);
    }
    // thread tid owns the run [tid L, tid L + L) of the chunk
    const int L = (len + SEL_T - 1) / SEL_T, r0 = tid * L, r1 = min(len, r0 + L);
    unsigned ties = 0u;
    for (int i = r0; i < r1; ++i) ties += bits(i) == prefix;
    unsigned incl = ties;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // the ties before each warp's runs
      const unsigned w = wsum[lane];
      unsigned wi = w;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, wi, o);
        if (lane >= o) wi += y;
      }
      wsum[lane] = before + wi - w;
    }
    __syncthreads();
    unsigned rank = wsum[warp] + incl - ties;  // the cluster rank of the run's first tie
    for (int j = 0; j < L; ++j) {
      const int i = r0 + j;
      const unsigned u = i < r1 ? bits(i) : 0u;
      bool sel = false;
      if (i < r1) {
        if (u > prefix) {
          sel = true;
        } else if (u == prefix) {
          sel = rank < krem;
          ++rank;
        }
      }
      append_keys(sel, key_of(u, i), &ncand, cand);
    }
  }
  cluster.sync();  // every block's list
  if (warp == 0) {  // the lists' offsets in block order
    const unsigned c = lane < SEL_C ? *cluster.map_shared_rank(&ncand, lane) : 0u;
    unsigned incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane <= SEL_C) offs[lane] = incl - c;
  }
  __syncthreads();
  for (int t = tid; t < (int)offs[SEL_C]; t += SEL_T) {
    int j = 0;
    while (offs[j + 1] <= (unsigned)t) ++j;
    all[t] = cluster.map_shared_rank(cand, j)[t - offs[j]];
  }
  cluster_arrive_relaxed();  // the lists are copied; a block waits before it exits
  __syncthreads();

  // block b: the keys [b per, (b + 1) per) at their rank among all n; the
  // first K ranks are the answer (the keys are unique)
  const int n = (int)offs[SEL_C];
  const int per = (n + SEL_C - 1) / SEL_C;
  const int q = tid / RANK_LANES, sub = tid % RANK_LANES, i = b * per + q;
  const bool mine = q < per && i < n;
  const unsigned long long key = mine ? all[i] : 0ull;
  unsigned above = 0u;
  if (mine) {
#pragma unroll 4
    for (int j = sub; j < n; j += RANK_LANES) above += all[j] > key;
  }
  for (int o = RANK_LANES / 2; o > 0; o >>= 1) above += __shfl_xor_sync(FULL, above, o);
  if (mine && sub == 0 && above < (unsigned)a.K) {
    const unsigned idx = 0xffffffffu - (unsigned)(key & 0xffffffffull);
    const float sc = unord32((unsigned)(key >> 32));
    a.xy[2 * above] = (float)(idx % (unsigned)a.W);
    a.xy[2 * above + 1] = (float)(idx / (unsigned)a.W);
    a.score[above] = sc;
    a.valid[above] = sc > 0.f;
  }
  cluster_wait();
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

}  // namespace

extern "C" int mmf_patch_score(const float* img, int H, int W, float a0, float a1, float a2,
                               float a3, float a4, float b0, float b1, float b2, float b3,
                               float b4, float* score, float* blurred, cudaStream_t stream) {
  Taps k15{{a0, a1, a2, a3, a4}}, k10{{b0, b1, b2, b3, b4}};
  dim3 grid((W + PS_TX - 1) / PS_TX, (H + PS_TY - 1) / PS_TY);
  patch_score_kernel<<<grid, PS_T, 0, stream>>>(img, H, W, k15, k10, score, blurred);
  return (int)cudaGetLastError();
}

// scores: [H * W] scratch for the peak scores
extern "C" int mmf_nms_topk(const float* heat, int H, int W, int K, float thr, int r,
                            float* scores, float* xy, float* score, bool* valid,
                            cudaStream_t stream) {
  const int n = H * W;
  if (K < 1 || K > MAX_K || K > n || r < 0 || r > MAX_R) return (int)cudaErrorInvalidValue;
  switch (r) {
    case 0: launch_nms<0>(heat, H, W, thr, scores, stream); break;
    case 1: launch_nms<1>(heat, H, W, thr, scores, stream); break;
    case 2: launch_nms<2>(heat, H, W, thr, scores, stream); break;
    case 3: launch_nms<3>(heat, H, W, thr, scores, stream); break;
    case 4: launch_nms<4>(heat, H, W, thr, scores, stream); break;
    case 5: launch_nms<5>(heat, H, W, thr, scores, stream); break;
    case 6: launch_nms<6>(heat, H, W, thr, scores, stream); break;
    case 7: launch_nms<7>(heat, H, W, thr, scores, stream); break;
    default: launch_nms<MAX_R>(heat, H, W, thr, scores, stream); break;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int chunk = ((n + SEL_C - 1) / SEL_C + 3) & ~3;
  const size_t bytes = sizeof(unsigned) * (size_t)chunk;
  const int staged = bytes <= SEL_STAGE_MAX;
  SelectArgs a{scores, n, W, K, chunk, staged, xy, score, valid};
  const size_t smem = staged ? bytes : 0;
  e = cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(select_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SEL_C);
  cfg.blockDim = dim3(SEL_T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SEL_C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, select_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int mmf_patch_desc(const float* blurred, int H, int W, const float* xy, int K,
                              float* desc, cudaStream_t stream) {
  const int per_block = THREADS / 32;
  patch_desc_kernel<<<(K + per_block - 1) / per_block, THREADS, 0, stream>>>(blurred, H, W, xy,
                                                                           K, desc);
  return (int)cudaGetLastError();
}
