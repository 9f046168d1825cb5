// K2 pyramid: the per-level inputs of the odometry, one launch per side.
//
// Replaces: multimotionfusion_tpu/ops/image.py:40 rgb_to_intensity, :104
//   pyr_down_gauss, :137 pyr_down_nearest, :144 sobel_gradients;
//   odometry/levels.py:41 build_frame_pyramids and :59 build_level_data;
//   odometry/rgbd.py:454 rgb_static_valid; and the sampling banks
//   rgbd.py:322 build_compact_bank (level 0) / :269 build_generic_bank.
// Bound on an H100: bytes. Each side reads its level-0 images once and
//   writes every level's fields once: ~48 bytes a level-0 pixel on the frame
//   side, 44 read and 16-32 written on the prediction side; a 640x480 frame's
//   two sides move ~40 MB, about 12 us at the memory rate.
// Design: one launch per side builds all (up to) three levels. A 256-thread
//   block owns a T2 x T2 tile of level 2 and the 2T2 x 2T2 and 4T2 x 4T2
//   tiles of levels 1 and 0 above it, and reads each level-0 pixel of its
//   region from global memory once:
//   1. stage level 0's base fields on the region the block's three levels
//      need (frame: the filtered depth and the intensity of the colour; the
//      prediction: the vertex's depth, its RGB depth and the colour's
//      intensity), 0 outside the image, and (frame side) the model-id test
//      of each level's tile plus its halo;
//   2. compute level 1's base fields on its region from level 0's in shared
//      memory (the 5x5 validity-renormalised Gaussian in the plain version's
//      row-major tap order, zero taps included, so every value is bit-equal);
//   3. warps 0-3 compute level 2's base fields from level 1's, wait at a
//      barrier of their own, then write level 2's and level 1's outputs,
//      while 4. warps 4-7 write the frame side's level-0 outputs, the bulk
//      of the bytes, so the short level-2 chain hides behind them; the
//      prediction's level-0 map, per pixel, is written in step 1 from the
//      loads that stage it.
//   The regions overlap their neighbours' (a block recomputes ~2.4x the
//   level-1 cells it writes), so no block waits for another. Outputs:
//   - frame side: the Sobel taps in _conv2d's order with its zero taps
//     skipped and the int16 truncation, the masked vertex map and its
//     cross-product normals, and the static photometric validity (4x4
//     support window [-2, +1], borders, gradient gate, valid depth); four
//     pixels a thread at levels 0 and 1, written as float4 and 4-byte words
//     where the width is a multiple of 4, one at level 2;
//   - prediction side: at level 0 the sampling map of the filled prediction
//     (bf16 [z_hi, z_lo, n, img, 0, 0], rounded to nearest even as
//     torch.to(bfloat16), or f32 [v, n, depth_last, img] without ICP); at
//     coarse levels the ray-aligned vertices and normals
//     rebuilt from the depth pyramid, and the f32 map [v, n, depth_last, img].
//   Level sizes halve rounding up, as the plain version's strided taps do.
//   The regions (halos before and after each tile) are the constants below;
//   odometry/levels.py's plan derives them from the stencils, and
//   tests/test_torch_levels_plan.py holds both to a brute-force enumeration.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LEVELS = 3;
constexpr int T2 = 8;    // a block's tile at level 2 (T2 << 1 at level 1, T2 << 2 at level 0)
constexpr int NT = 256;  // threads a block
// frame side: each level's staged region is its tile widened by B before and A after
constexpr int FB0 = 14, FA0 = 7, FB1 = 6, FA1 = 3, FB2 = 2, FA2 = 1;
constexpr int FN0 = 4 * T2 + FB0 + FA0, FN1 = 2 * T2 + FB1 + FA1, FN2 = T2 + FB2 + FA2;
// the model-id test of each level: its tile plus the outputs' halo
constexpr int MB = 2, MA = 1;
constexpr int MN0 = 4 * T2 + MB + MA, MN1 = 2 * T2 + MB + MA, MN2 = T2 + MB + MA;
// prediction side
constexpr int PB0 = 6, PA0 = 7, PB1 = 2, PA1 = 3, PB2 = 0, PA2 = 1;
constexpr int PN0 = 4 * T2 + PB0 + PA0, PN1 = 2 * T2 + PB1 + PA1, PN2 = T2 + PB2 + PA2;

struct Cam {
  float fx, fy, cx, cy, inv_fx, inv_fy;
};

__constant__ float GAUSS[5] = {1.f, 4.f, 6.f, 4.f, 1.f};

// _conv2d(stack([img * valid, valid]), GAUSS5, stride 2) centred on s[cy][cx]:
// the num / den ratio of pyr_down_gauss (gate 0), taps in row-major order
template <int N>
__device__ inline float gauss_down(const float (*s)[N], int cy, int cx) {
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int oy = -2; oy <= 2; ++oy) {
#pragma unroll
    for (int ox = -2; ox <= 2; ++ox) {
      float q = s[cy + oy][cx + ox];
      float v = q > 0.f ? 1.f : 0.f;
      float wgt = GAUSS[oy + 2] * GAUSS[ox + 2];
      float tn = wgt * (q * v), td = q > 0.f ? wgt : 0.f;  // td = wgt * v
      bool first = oy == -2 && ox == -2;
      num = first ? tn : num + tn;
      den = first ? td : den + td;
    }
  }
  return den > 0.f ? num / fmaxf(den, 1e-12f) : 0.f;
}

__device__ inline float intensity(float r, float g, float b) {
  return floorf(r * 0.114f + g * 0.299f + b * 0.587f);
}

__device__ inline void vertex(const Cam& c, float d, int x, int y, float cutoff, bool mok,
                              float* v) {
  bool ok = d > 0.f && d < cutoff && mok;
  float z = ok ? d : 0.f;
  v[0] = ok ? z * ((float)x - c.cx) * c.inv_fx : 0.f;
  v[1] = ok ? z * ((float)y - c.cy) * c.inv_fy : 0.f;
  v[2] = z;
}

__device__ inline void normal(const float* v00, const float* v01, const float* v10, float* n) {
  bool ok = v00[2] > 0.f && v01[2] > 0.f && v10[2] > 0.f;
  float a0 = v01[0] - v00[0], a1 = v01[1] - v00[1], a2 = v01[2] - v00[2];
  float b0 = v10[0] - v00[0], b1 = v10[1] - v00[1], b2 = v10[2] - v00[2];
  float c0 = a1 * b2 - a2 * b1, c1 = a2 * b0 - a0 * b2, c2 = a0 * b1 - a1 * b0;
  float nn = sqrtf(c0 * c0 + c1 * c1 + c2 * c2);
  bool nz = nn > 1e-12f;
  float dn = fmaxf(nn, 1e-12f);
  n[0] = (ok && nz) ? c0 / dn : 0.f;
  n[1] = (ok && nz) ? c1 / dn : 0.f;
  n[2] = (ok && nz) ? c2 / dn : 0.f;
}

// the barrier of warps 0-3 alone (warps 4-7 go on with other work)
__device__ inline void sync_low_half() { asm volatile("bar.sync 1, %0;" ::"n"(NT / 2) : "memory"); }

__device__ inline void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// ---------------------------------------------------------------- frame side

struct FrameLevel {  // one level's outputs (depth: levels 1 and 2) and camera
  float *depth, *img, *didx, *didy, *vmap, *nmap;
  uint8_t* sv;
  int H, W, vec;  // vec: W % 4 == 0 and every output 16-byte aligned
  Cam cam;
  float min_scale;
};

struct FrameArgs {
  const float* depth;  // the filtered depth (level 0)
  const uint8_t* rgb;
  const int* mask;  // level-0 model ids
  int levels, mask_id, mask_icp, mask_rgb, use_rgb;
  float cutoff;
  FrameLevel L[LEVELS];
};

struct FramePx {
  float d, img, gx, gy, v[3], n[3];
  bool sv;
};

// One pixel (x, y) of a level from its staged depth sd and intensity si
// (pitch N; the pixel at [ry][rx]) and model-id test sm (pitch M; at [my][mx]).
template <int N, int M>
__device__ inline FramePx frame_pixel(const FrameArgs& a, const FrameLevel& L,
                                      const float (*sd)[N], const float (*si)[N],
                                      const uint8_t (*sm)[M], int rx, int ry, int mx, int my,
                                      int x, int y) {
  FramePx o;
  o.d = sd[ry][rx];
  o.img = si[ry][rx];
  // Sobel (cross-correlation taps of ops/image.py, zero taps skipped)
  const float k1 = 0.52201f, k2 = 0.79451f;
  float gx = -k1 * si[ry - 1][rx - 1];
  gx = gx + k1 * si[ry - 1][rx + 1];
  gx = gx + -k2 * si[ry][rx - 1];
  gx = gx + k2 * si[ry][rx + 1];
  gx = gx + -k1 * si[ry + 1][rx - 1];
  gx = gx + k1 * si[ry + 1][rx + 1];
  float gy = -k1 * si[ry - 1][rx - 1];
  gy = gy + -k2 * si[ry - 1][rx];
  gy = gy + -k1 * si[ry - 1][rx + 1];
  gy = gy + k1 * si[ry + 1][rx - 1];
  gy = gy + k2 * si[ry + 1][rx];
  gy = gy + k1 * si[ry + 1][rx + 1];
  o.gx = truncf(gx);
  o.gy = truncf(gy);

  // vertices (masked by the model id when mask_icp) and normals; a
  // neighbour outside the level is staged 0, so its vertex is 0 as the
  // plain version's zero fill
  bool m00 = (!a.mask_icp) | (sm[my][mx] != 0);
  bool m01 = (!a.mask_icp) | (sm[my][mx + 1] != 0);
  bool m10 = (!a.mask_icp) | (sm[my + 1][mx] != 0);
  float v01[3], v10[3];
  vertex(L.cam, o.d, x, y, a.cutoff, m00, o.v);
  vertex(L.cam, sd[ry][rx + 1], x + 1, y, a.cutoff, m01, v01);
  vertex(L.cam, sd[ry + 1][rx], x, y + 1, a.cutoff, m10, v10);
  normal(o.v, v01, v10, o.n);

  // static photometric validity: every in-bounds pixel of the window
  // [y-2, y+1] x [x-2, x+1] has intensity > 0 (and the model id); every
  // cell read, so the test is selects, not branches
  bool win = true;
#pragma unroll
  for (int dy = -2; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -2; dx <= 1; ++dx) {
      int yy = y + dy, xx = x + dx;
      float im = si[ry + dy][rx + dx];
      bool id = sm[my + dy][mx + dx] != 0;
      bool in = yy >= 0 && yy < L.H && xx >= 0 && xx < L.W;
      win = win & ((!in) | ((im > 0.f) & ((!a.mask_rgb) | id)));
    }
  o.sv = a.use_rgb && win && x < L.W - 5 && y < L.H - 1 &&
         (o.gx * o.gx + o.gy * o.gy) >= L.min_scale && o.d > 0.f;
  return o;
}

// One pixel's outputs at p = y * W + x (level 0's depth is the input).
__device__ inline void frame_store(const FrameLevel& L, bool coarse, int p, const FramePx& o) {
  if (coarse) L.depth[p] = o.d;
  L.img[p] = o.img;
  L.didx[p] = o.gx;
  L.didy[p] = o.gy;
  for (int c = 0; c < 3; ++c) {
    L.vmap[3 * p + c] = o.v[c];
    L.nmap[3 * p + c] = o.n[c];
  }
  L.sv[p] = o.sv ? 1 : 0;
}

// The values of pixels x .. x + 3 of a row at p: a float4 (vec: the width is
// a multiple of 4 and x of 4), else the n of them inside the row.
__device__ inline void put4(float* a, int p, bool vec, int n, const float* v) {
  if (vec) {
    st4(a + p, v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) a[p + i] = v[i];
}

// The same for three channels a pixel (vertices, normals): three float4.
__device__ inline void put12(float* a, int p, bool vec, int n, const float (*v)[3]) {
  if (vec) {
    st4(a + 3 * p, v[0][0], v[0][1], v[0][2], v[1][0]);
    st4(a + 3 * p + 4, v[1][1], v[1][2], v[2][0], v[2][1]);
    st4(a + 3 * p + 8, v[2][2], v[3][0], v[3][1], v[3][2]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n)
      for (int c = 0; c < 3; ++c) a[3 * (p + i) + c] = v[i][c];
}

// Pixels x .. x + 3 of row y of a level (staged fields from (ox, oy), the
// model-id test from (mx0, my0)): frame_pixel's arithmetic for each, with the
// staged reads, the neighbours' vertices and the validity window's cells
// shared by the four; each field stored as soon as it is computed.
template <int N, int M>
__device__ inline void frame_group4(const FrameArgs& a, const FrameLevel& L, bool coarse,
                                   const float (*sd)[N], const float (*si)[N],
                                   const uint8_t (*sm)[M], int ox, int oy, int mx0, int my0,
                                   int x, int y) {
  if (x >= L.W || y >= L.H) return;
  const int rx = x - ox, ry = y - oy, mx = x - mx0, my = y - my0;
  const int p = y * L.W + x, n = min(4, L.W - x);
  const bool vec = L.vec;
  float d[4], gx[4], gy[4];
  {
    float I[3][6];  // intensity of rows y-1 .. y+1, columns x-1 .. x+4
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c) I[r][c] = si[ry - 1 + r][rx - 1 + c];
    const float k1 = 0.52201f, k2 = 0.79451f;
    float img[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // pixel i is column i + 1
      float sx = -k1 * I[0][i];
      sx = sx + k1 * I[0][i + 2];
      sx = sx + -k2 * I[1][i];
      sx = sx + k2 * I[1][i + 2];
      sx = sx + -k1 * I[2][i];
      sx = sx + k1 * I[2][i + 2];
      float sy = -k1 * I[0][i];
      sy = sy + -k2 * I[0][i + 1];
      sy = sy + -k1 * I[0][i + 2];
      sy = sy + k1 * I[2][i];
      sy = sy + k2 * I[2][i + 1];
      sy = sy + k1 * I[2][i + 2];
      gx[i] = truncf(sx);
      gy[i] = truncf(sy);
      d[i] = sd[ry][rx + i];
      img[i] = I[1][i + 1];
    }
    if (coarse) put4(L.depth, p, vec, n, d);
    put4(L.img, p, vec, n, img);
    put4(L.didx, p, vec, n, gx);
    put4(L.didy, p, vec, n, gy);
  }
  {
    // static photometric validity: a window cell out of the image passes
    bool ok[4][7];  // rows y-2 .. y+1, columns x-2 .. x+4
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 7; ++c) {
        int yy = y - 2 + r, xx = x - 2 + c;
        float im = si[ry - 2 + r][rx - 2 + c];
        bool id = sm[my - 2 + r][mx - 2 + c] != 0;
        bool in = yy >= 0 && yy < L.H && xx >= 0 && xx < L.W;
        ok[r][c] = (!in) | ((im > 0.f) & ((!a.mask_rgb) | id));
      }
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool win = a.use_rgb;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = i; c < i + 4; ++c) win = win & ok[r][c];
      bool sv = win & (x + i < L.W - 5) & (y < L.H - 1) &
                ((gx[i] * gx[i] + gy[i] * gy[i]) >= L.min_scale) & (d[i] > 0.f);
      word |= (uint32_t)sv << (8 * i);
      if (!vec && i < n) L.sv[p + i] = sv;
    }
    if (vec) *reinterpret_cast<uint32_t*>(L.sv + p) = word;
  }
  // vertices (masked by the model id when mask_icp) of row y at x .. x + 4
  // and of row y + 1 at x .. x + 3 (staged 0 beyond the level: a zero
  // vertex), then normals
  float V[5][3], U[4][3], nm[4][3];
#pragma unroll
  for (int j = 0; j <= 4; ++j)
    vertex(L.cam, sd[ry][rx + j], x + j, y, a.cutoff, (!a.mask_icp) | (sm[my][mx + j] != 0),
           V[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    vertex(L.cam, sd[ry + 1][rx + j], x + j, y + 1, a.cutoff,
           (!a.mask_icp) | (sm[my + 1][mx + j] != 0), U[j]);
#pragma unroll
  for (int i = 0; i < 4; ++i) normal(V[i], V[i + 1], U[i], nm[i]);
  put12(L.vmap, p, vec, n, V);
  put12(L.nmap, p, vec, n, nm);
}

// The model ids a thread stages of level `level`'s test on [x0, x0 + M) x
// [y0, y0 + M) (loads only: mask_id + 1 outside the level), then their test.
template <int M>
constexpr int MASK_PER = (M * M + NT - 1) / NT;

template <int M>
__device__ inline void load_mask(const FrameArgs& a, int level, int x0, int y0,
                                 int (&id)[MASK_PER<M>]) {
  const FrameLevel& L = a.L[level];
#pragma unroll
  for (int j = 0; j < MASK_PER<M>; ++j) {
    int k = threadIdx.x + j * NT, ry = k / M, rx = k - ry * M;
    int y = y0 + ry, x = x0 + rx;
    bool in = k < M * M && y >= 0 && y < L.H && x >= 0 && x < L.W;
    id[j] = in ? a.mask[(y << level) * a.L[0].W + (x << level)] : a.mask_id + 1;
  }
}

template <int M>
__device__ inline void store_mask(const FrameArgs& a, const int (&id)[MASK_PER<M>],
                                  uint8_t (*sm)[M]) {
#pragma unroll
  for (int j = 0; j < MASK_PER<M>; ++j) {
    int k = threadIdx.x + j * NT;
    if (k < M * M) (&sm[0][0])[k] = id[j] == a.mask_id;
  }
}

__global__ void __launch_bounds__(NT, 3) frame_levels(FrameArgs a) {
  __shared__ float d0[FN0][FN0], i0[FN0][FN0];
  __shared__ float d1[FN1][FN1], i1[FN1][FN1];
  __shared__ float d2[FN2][FN2], i2[FN2][FN2];
  __shared__ uint8_t m0[MN0][MN0], m1[MN1][MN1], m2[MN2][MN2];
  const int t = threadIdx.x;
  const FrameLevel &L0 = a.L[0], &L1 = a.L[1], &L2 = a.L[2];
  // tile origins of levels 0, 1, 2 and their regions' origins
  const int tx0 = 4 * T2 * blockIdx.x, ty0 = 4 * T2 * blockIdx.y;
  const int tx1 = 2 * T2 * blockIdx.x, ty1 = 2 * T2 * blockIdx.y;
  const int tx2 = T2 * blockIdx.x, ty2 = T2 * blockIdx.y;
  const int ox0 = tx0 - FB0, oy0 = ty0 - FB0, ox1 = tx1 - FB1, oy1 = ty1 - FB1;
  const int ox2 = tx2 - FB2, oy2 = ty2 - FB2;

  // 1. level 0's depth and intensity on its region and each level's
  // model-id test (a thread's loads all issued before its first store)
  {
    constexpr int PER = (FN0 * FN0 + NT - 1) / NT;
    float d[PER];
    uint8_t c[PER][3];
    int id0[MASK_PER<MN0>], id1[MASK_PER<MN1>], id2[MASK_PER<MN2>];
    const bool masked = a.mask_icp || a.mask_rgb;
    if (masked) {
      load_mask<MN0>(a, 0, tx0 - MB, ty0 - MB, id0);
      if (a.levels > 1) load_mask<MN1>(a, 1, tx1 - MB, ty1 - MB, id1);
      if (a.levels > 2) load_mask<MN2>(a, 2, tx2 - MB, ty2 - MB, id2);
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int k = t + j * NT, ry = k / FN0, rx = k - ry * FN0;
      int y = oy0 + ry, x = ox0 + rx;
      bool in = k < FN0 * FN0 && y >= 0 && y < L0.H && x >= 0 && x < L0.W;
      int p = in ? y * L0.W + x : 0;
      d[j] = in ? a.depth[p] : 0.f;
      c[j][0] = in ? a.rgb[3 * p] : 0;
      c[j][1] = in ? a.rgb[3 * p + 1] : 0;
      c[j][2] = in ? a.rgb[3 * p + 2] : 0;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int k = t + j * NT;
      if (k < FN0 * FN0) {
        (&d0[0][0])[k] = d[j];
        (&i0[0][0])[k] = intensity((float)c[j][0], (float)c[j][1], (float)c[j][2]);
      }
    }
    if (masked) {
      store_mask<MN0>(a, id0, m0);
      if (a.levels > 1) store_mask<MN1>(a, id1, m1);
      if (a.levels > 2) store_mask<MN2>(a, id2, m2);
    }
  }
  __syncthreads();

  // 2. level 1's depth and intensity on its region
  if (a.levels > 1) {
    for (int k = t; k < FN1 * FN1; k += NT) {
      int ry = k / FN1, rx = k - ry * FN1;
      int y = oy1 + ry, x = ox1 + rx;
      float d = 0.f, im = 0.f;
      if (y >= 0 && y < L1.H && x >= 0 && x < L1.W) {
        d = gauss_down<FN0>(d0, 2 * y - oy0, 2 * x - ox0);
        im = gauss_down<FN0>(i0, 2 * y - oy0, 2 * x - ox0);
      }
      d1[ry][rx] = d;
      i1[ry][rx] = im;
    }
  }
  __syncthreads();

  if (t < NT / 2) {
    // 3. warps 0-3: level 2's depth and intensity, their barrier, then level
    // 2's outputs (a pixel a thread: as four-pixel groups on 16 threads this
    // path outlasts warps 4-7's) and level 1's (four pixels a thread)
    if (a.levels > 2 && t < FN2 * FN2) {
      int ry = t / FN2, rx = t - ry * FN2;
      int y = oy2 + ry, x = ox2 + rx;
      float d = 0.f, im = 0.f;
      if (y >= 0 && y < L2.H && x >= 0 && x < L2.W) {
        d = gauss_down<FN1>(d1, 2 * y - oy1, 2 * x - ox1);
        im = gauss_down<FN1>(i1, 2 * y - oy1, 2 * x - ox1);
      }
      d2[ry][rx] = d;
      i2[ry][rx] = im;
    }
    sync_low_half();
    if (t < T2 * T2) {
      int x = tx2 + t % T2, y = ty2 + t / T2;
      if (a.levels > 2 && x < L2.W && y < L2.H)
        frame_store(L2, true, y * L2.W + x,
                    frame_pixel<FN2, MN2>(a, L2, d2, i2, m2, x - ox2, y - oy2, x - (tx2 - MB),
                                          y - (ty2 - MB), x, y));
    } else if (a.levels > 1) {
      int g = t - T2 * T2;  // 2 T2 rows of T2 / 2 four-pixel groups
      frame_group4<FN1, MN1>(a, L1, true, d1, i1, m1, ox1, oy1, tx1 - MB, ty1 - MB,
                             tx1 + 4 * (g % (T2 / 2)), ty1 + g / (T2 / 2));
    }
  } else {
    // 4. warps 4-7 meanwhile: level 0's outputs, 4 T2 rows of T2 four-pixel groups
    for (int g = t - NT / 2; g < 4 * T2 * T2; g += NT / 2)
      frame_group4<FN0, MN0>(a, L0, false, d0, i0, m0, ox0, oy0, tx0 - MB, ty0 - MB,
                             tx0 + 4 * (g % T2), ty0 + g / T2);
  }
}

// ---------------------------------------------------------------- prediction side

struct PredLevel {
  void* map;  // [H, W, 8] bf16 (level 0, compact) or f32
  int H, W;
  Cam cam;
};

struct PredArgs {
  const float* vertex_conf;  // the filled prediction [H, W, 4]
  const float* normal_rad;   // [H, W, 4]
  const float* color;        // [H, W, 3]
  int levels, compact;
  float max_depth_rgb;
  PredLevel L[LEVELS];
};

__device__ inline uint16_t bf16_bits(float v) {
  __nv_bfloat16 h = __float2bfloat16_rn(v);
  return *reinterpret_cast<uint16_t*>(&h);
}

__device__ inline float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// a coarse level's f32 map at (x, y) from its staged depth z, RGB depth l and
// intensity c (pitch N; the pixel at [ry][rx])
template <int N>
__device__ inline void pred_coarse(const PredLevel& L, const float (*z)[N], const float (*l)[N],
                                   const float (*c)[N], int rx, int ry, int x, int y) {
  if (x >= L.W || y >= L.H) return;
  float v[3], v01[3], v10[3], n[3];  // staged 0 beyond the level: a zero vertex
  vertex(L.cam, z[ry][rx], x, y, 1e9f, true, v);
  vertex(L.cam, z[ry][rx + 1], x + 1, y, 1e9f, true, v01);
  vertex(L.cam, z[ry + 1][rx], x, y + 1, 1e9f, true, v10);
  normal(v, v01, v10, n);
  float4* m = reinterpret_cast<float4*>(L.map) + 2 * (y * L.W + x);
  m[0] = make_float4(v[0], v[1], v[2], n[0]);
  m[1] = make_float4(n[1], n[2], l[ry][rx], c[ry][rx]);
}

// a coarse level's depth, RGB depth and intensity at [ry][rx] of its region
// (level pixel (x, y)) from the finer level's, whose region starts at (fx, fy)
template <int NF, int N>
__device__ inline void pred_down(const PredLevel& L, const float (*zf)[NF],
                                 const float (*lf)[NF], const float (*cf)[NF], float (*z)[N],
                                 float (*l)[N], float (*c)[N], int rx, int ry, int x, int y,
                                 int fx, int fy) {
  float pd = 0.f, dl = 0.f, il = 0.f;
  if (y >= 0 && y < L.H && x >= 0 && x < L.W) {
    pd = gauss_down<NF>(zf, 2 * y - fy, 2 * x - fx);
    dl = gauss_down<NF>(lf, 2 * y - fy, 2 * x - fx);
    il = gauss_down<NF>(cf, 2 * y - fy, 2 * x - fx);
  }
  z[ry][rx] = pd;
  l[ry][rx] = dl;
  c[ry][rx] = il;
}

__global__ void __launch_bounds__(NT, 3) pred_levels(PredArgs a) {
  __shared__ float z0[PN0][PN0], l0[PN0][PN0], c0[PN0][PN0];
  __shared__ float z1[PN1][PN1], l1[PN1][PN1], c1[PN1][PN1];
  __shared__ float z2[PN2][PN2], l2[PN2][PN2], c2[PN2][PN2];
  const int t = threadIdx.x;
  const PredLevel &L0 = a.L[0], &L1 = a.L[1], &L2 = a.L[2];
  const int tx0 = 4 * T2 * blockIdx.x, ty0 = 4 * T2 * blockIdx.y;
  const int tx1 = 2 * T2 * blockIdx.x, ty1 = 2 * T2 * blockIdx.y;
  const int tx2 = T2 * blockIdx.x, ty2 = T2 * blockIdx.y;
  const int ox0 = tx0 - PB0, oy0 = ty0 - PB0, ox1 = tx1 - PB1, oy1 = ty1 - PB1;
  const int ox2 = tx2 - PB2, oy2 = ty2 - PB2;

  // 1. level 0's depth (the vertex's z), RGB depth (vertices_to_depth) and
  // intensity on its region and, where a cell lies in the block's tile,
  // level 0's map: two rounds of a thread's cells, each round's loads issued
  // before its first store (a cell's whole vertex is loaded: its depth alone
  // would read the same sectors); outside the image 0, whose RGB depth and
  // intensity are 0 too
  {
    constexpr int PER = (PN0 * PN0 + NT - 1) / NT, HALF = (PER + 1) / 2;
#pragma unroll
    for (int h = 0; h < PER; h += HALF) {
      float4 vc[HALF], nr[HALF];
      float c[HALF][3];
      int pix[HALF];
      bool own[HALF];
#pragma unroll
      for (int j = 0; j < HALF; ++j) {
        int k = t + (h + j) * NT, ry = k / PN0, rx = k - ry * PN0;
        int y = oy0 + ry, x = ox0 + rx;
        bool in = h + j < PER && k < PN0 * PN0 && y >= 0 && y < L0.H && x >= 0 && x < L0.W;
        own[j] = in && rx >= PB0 && rx < PB0 + 4 * T2 && ry >= PB0 && ry < PB0 + 4 * T2;
        int p = in ? y * L0.W + x : 0;
        pix[j] = p;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        vc[j] = in ? reinterpret_cast<const float4*>(a.vertex_conf)[p] : zero;
        nr[j] = own[j] ? reinterpret_cast<const float4*>(a.normal_rad)[p] : zero;
        c[j][0] = in ? a.color[3 * p] : 0.f;
        c[j][1] = in ? a.color[3 * p + 1] : 0.f;
        c[j][2] = in ? a.color[3 * p + 2] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < HALF; ++j) {
        int k = t + (h + j) * NT;
        if (h + j >= PER || k >= PN0 * PN0) continue;
        float z = vc[j].z;
        float dl = (z > 0.f && z <= a.max_depth_rgb) ? z : 0.f;
        float il = intensity(c[j][0], c[j][1], c[j][2]);
        (&z0[0][0])[k] = z;
        (&l0[0][0])[k] = dl;
        (&c0[0][0])[k] = il;
        if (!own[j]) continue;
        if (a.compact) {
          float zhi = bf16_round(z);
          uint4 out;
          out.x = (uint32_t)bf16_bits(z) | ((uint32_t)bf16_bits(z - zhi) << 16);
          out.y = (uint32_t)bf16_bits(nr[j].x) | ((uint32_t)bf16_bits(nr[j].y) << 16);
          out.z = (uint32_t)bf16_bits(nr[j].z) | ((uint32_t)bf16_bits(il) << 16);
          out.w = 0u;
          reinterpret_cast<uint4*>(L0.map)[pix[j]] = out;
        } else {
          float4* m = reinterpret_cast<float4*>(L0.map) + 2 * pix[j];
          m[0] = make_float4(vc[j].x, vc[j].y, z, nr[j].x);
          m[1] = make_float4(nr[j].y, nr[j].z, dl, il);
        }
      }
    }
  }
  __syncthreads();

  // 2. level 1's fields on its region
  if (a.levels > 1) {
    for (int k = t; k < PN1 * PN1; k += NT) {
      int ry = k / PN1, rx = k - ry * PN1;
      pred_down<PN0, PN1>(L1, z0, l0, c0, z1, l1, c1, rx, ry, ox1 + rx, oy1 + ry, ox0, oy0);
    }
  }
  __syncthreads();

  if (t < NT / 2) {
    // 3. warps 0-3: level 2's fields, their barrier, then level 2's maps (a
    // pixel a thread) and level 1's (four pixels a thread); level 0's maps
    // were written with the staging
    if (a.levels > 2 && t < PN2 * PN2) {
      int ry = t / PN2, rx = t - ry * PN2;
      pred_down<PN1, PN2>(L2, z1, l1, c1, z2, l2, c2, rx, ry, ox2 + rx, oy2 + ry, ox1, oy1);
    }
    sync_low_half();
    if (t < T2 * T2) {
      int x = tx2 + t % T2, y = ty2 + t / T2;
      if (a.levels > 2) pred_coarse<PN2>(L2, z2, l2, c2, x - ox2, y - oy2, x, y);
    } else if (a.levels > 1) {
      for (int q = t - T2 * T2; q < 4 * T2 * T2; q += NT / 2 - T2 * T2) {
        int x = tx1 + q % (2 * T2), y = ty1 + q / (2 * T2);
        pred_coarse<PN1>(L1, z1, l1, c1, x - ox1, y - oy1, x, y);
      }
    }
  }
}

inline Cam cam_of(const float* p) { return Cam{p[0], p[1], p[2], p[3], p[4], p[5]}; }

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

inline dim3 grid_of(int H0, int W0) {
  // level 2's size, each halving rounded up; one block per T2 x T2 tile of it
  int H2 = (((H0 + 1) >> 1) + 1) >> 1, W2 = (((W0 + 1) >> 1) + 1) >> 1;
  return dim3((W2 + T2 - 1) / T2, (H2 + T2 - 1) / T2);
}

static_assert(NT == 256 && 2 * T2 * T2 == NT / 2 && FN2 * FN2 <= NT / 2 && PN2 * PN2 <= NT / 2,
              "warps 0-3: level 2's fields, then its pixels and level 1's four-pixel groups");

}  // namespace

// cams: LEVELS x 7 floats (fx, fy, cx, cy, 1/fx, 1/fy, min_scale); outs:
// LEVELS x 7 pointers (depth, img, didx, didy, vmap, nmap, static_valid;
// level 0's depth is the input), both host arrays read before the launch
extern "C" int mmf_pyramid_frame(int H0, int W0, int levels, const float* depth,
                                 const uint8_t* rgb, const int* mask, int mask_id, int mask_icp,
                                 int mask_rgb, int use_rgb, float cutoff, const float* cams,
                                 void* const* outs, cudaStream_t stream) {
  if (levels < 1 || levels > LEVELS) return (int)cudaErrorInvalidValue;
  FrameArgs a{depth, rgb, mask, levels, mask_id, mask_icp, mask_rgb, use_rgb, cutoff, {}};
  int H = H0, W = W0;
  for (int l = 0; l < levels; ++l) {
    void* const* o = outs + 7 * l;
    FrameLevel& L = a.L[l];
    L = FrameLevel{(float*)o[0], (float*)o[1], (float*)o[2], (float*)o[3], (float*)o[4],
                   (float*)o[5], (uint8_t*)o[6], H, W, 0, cam_of(cams + 7 * l), cams[7 * l + 6]};
    L.vec = W % 4 == 0 && (l == 0 || aligned16(o[0])) && aligned16(o[1]) && aligned16(o[2]) &&
            aligned16(o[3]) && aligned16(o[4]) && aligned16(o[5]) && (uintptr_t)o[6] % 4 == 0;
    H = (H + 1) >> 1;
    W = (W + 1) >> 1;
  }
  frame_levels<<<grid_of(H0, W0), NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// cams: LEVELS x 7 floats as above; maps: LEVELS pointers
extern "C" int mmf_pyramid_pred(int H0, int W0, int levels, int compact,
                                const float* vertex_conf, const float* normal_rad,
                                const float* color, float max_depth_rgb, const float* cams,
                                void* const* maps, cudaStream_t stream) {
  if (levels < 1 || levels > LEVELS) return (int)cudaErrorInvalidValue;
  PredArgs a{vertex_conf, normal_rad, color, levels, compact, max_depth_rgb, {}};
  int H = H0, W = W0;
  for (int l = 0; l < levels; ++l) {
    a.L[l] = PredLevel{maps[l], H, W, cam_of(cams + 7 * l)};
    H = (H + 1) >> 1;
    W = (W + 1) >> 1;
  }
  pred_levels<<<grid_of(H0, W0), NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
