// K2 pyramid: the per-level inputs of the odometry, one launch per level and side.
//
// Replaces: multimotionfusion_tpu/ops/image.py:40 rgb_to_intensity, :104
//   pyr_down_gauss, :137 pyr_down_nearest, :144 sobel_gradients;
//   odometry/levels.py:41 build_frame_pyramids and :59 build_level_data;
//   odometry/rgbd.py:454 rgb_static_valid; and the sampling banks
//   rgbd.py:322 build_compact_bank (level 0) / :269 build_generic_bank.
// Bound on an H100: bytes. A level reads the finer level once (25 taps per
//   output pixel come from L1) and writes ~45 bytes per pixel (frame side)
//   or 16-32 bytes (the prediction's sampling map); the whole pyramid of a
//   640x480 frame moves ~25 MB, a few microseconds at the memory rate.
// Design: a 32x8 block computes the level's base fields (depth, intensity,
//   mask test; or the prediction's depth) for its tile plus a halo in shared
//   memory, then each thread derives everything else from the tile:
//   - frame side: the 5x5 validity-renormalised Gaussian of the finer level
//     (the plain version's tap order, zero taps included), the Sobel taps in
//     _conv2d's order with its zero taps skipped and the int16 truncation,
//     the masked vertex map and its cross-product normals, and the static
//     photometric validity (4x4 support window [-2, +1], borders, gradient
//     gate, valid depth); halo 2 above/left, 1 below/right;
//   - prediction side: at level 0 the sampling map of the filled prediction
//     (bf16 [z_hi, z_lo, n, img, 0, 0], rounded to nearest even as
//     torch.to(bfloat16), or f32 [v, n, depth_last, img] without ICP); at
//     coarse levels the Gaussian pyramids of the prediction's depth, its RGB
//     depth and intensity, the ray-aligned vertices and normals rebuilt from
//     the depth, and the f32 map [v, n, depth_last, img]; halo 1 below/right.
//   This replaces the hundreds of small launches of the plain version's tap
//   loops and shifts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32, TY = 8;
constexpr int HB = 2;  // halo before (rows above, columns left)
constexpr int SX = TX + HB + 1, SY = TY + HB + 1;

struct Cam {
  float fx, fy, cx, cy, inv_fx, inv_fy;
};

__constant__ float GAUSS[5] = {1.f, 4.f, 6.f, 4.f, 1.f};

// _conv2d(stack([img * valid, valid]), GAUSS5, stride 2) at output (x, y):
// the num / den ratio of pyr_down_gauss (gate 0), taps in row-major order
template <typename Src>
__device__ inline float gauss_down(const Src& src, int Hp, int Wp, int x, int y) {
  float num = 0.f, den = 0.f;
  bool first = true;
  for (int oy = -2; oy <= 2; ++oy) {
    for (int ox = -2; ox <= 2; ++ox) {
      int yy = 2 * y + oy, xx = 2 * x + ox;
      float s = 0.f, v = 0.f;
      if (yy >= 0 && yy < Hp && xx >= 0 && xx < Wp) {
        s = src(yy, xx);
        v = s > 0.f ? 1.f : 0.f;
      }
      float wgt = GAUSS[oy + 2] * GAUSS[ox + 2];
      float tn = wgt * (s * v), td = wgt * v;
      num = first ? tn : num + tn;
      den = first ? td : den + td;
      first = false;
    }
  }
  return den > 0.f ? num / fmaxf(den, 1e-12f) : 0.f;
}

__device__ inline float intensity(float r, float g, float b) {
  return floorf(r * 0.114f + g * 0.299f + b * 0.587f);
}

struct DenseSrc {
  const float* a;
  int W;
  __device__ float operator()(int y, int x) const { return a[y * W + x]; }
};

struct RgbIntensitySrc {
  const uint8_t* rgb;
  int W;
  __device__ float operator()(int y, int x) const {
    const uint8_t* c = rgb + 3 * (y * W + x);
    return intensity((float)c[0], (float)c[1], (float)c[2]);
  }
};

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

struct FrameArgs {
  int level, H, W, Hp, Wp;
  const float* src_depth;   // level 0: the filtered depth; else the finer level's
  const float* src_img;     // coarse levels: the finer level's intensity
  const uint8_t* rgb;       // level 0: the frame's colour
  const int* mask;          // full-resolution model ids
  int W0, mask_id, mask_icp, mask_rgb, use_rgb;
  Cam cam;
  float cutoff, min_scale;
  float *depth, *img, *didx, *didy, *vmap, *nmap;
  uint8_t* sv;
};

__global__ void __launch_bounds__(TX * TY) frame_level(FrameArgs a) {
  __shared__ float s_depth[SY][SX];
  __shared__ float s_img[SY][SX];
  __shared__ uint8_t s_mok[SY][SX];
  int x0 = blockIdx.x * TX - HB, y0 = blockIdx.y * TY - HB;
  for (int k = threadIdx.y * TX + threadIdx.x; k < SX * SY; k += TX * TY) {
    int ty = k / SX, tx = k % SX;
    int y = y0 + ty, x = x0 + tx;
    float d = 0.f, im = 0.f;
    uint8_t mok = 0;
    if (y >= 0 && y < a.H && x >= 0 && x < a.W) {
      if (a.level == 0) {
        d = a.src_depth[y * a.W + x];
        im = RgbIntensitySrc{a.rgb, a.W}(y, x);
      } else {
        d = gauss_down(DenseSrc{a.src_depth, a.Wp}, a.Hp, a.Wp, x, y);
        im = gauss_down(DenseSrc{a.src_img, a.Wp}, a.Hp, a.Wp, x, y);
      }
      mok = a.mask[(y << a.level) * a.W0 + (x << a.level)] == a.mask_id;
    }
    s_depth[ty][tx] = d;
    s_img[ty][tx] = im;
    s_mok[ty][tx] = mok;
  }
  __syncthreads();
  int tx = threadIdx.x + HB, ty = threadIdx.y + HB;
  int x = x0 + tx, y = y0 + ty;
  if (x >= a.W || y >= a.H) return;
  int p = y * a.W + x;
  float d = s_depth[ty][tx];
  if (a.level > 0) a.depth[p] = d;
  a.img[p] = s_img[ty][tx];

  // Sobel (cross-correlation taps of ops/image.py, zero taps skipped)
  const float k1 = 0.52201f, k2 = 0.79451f;
  float gx = -k1 * s_img[ty - 1][tx - 1];
  gx = gx + k1 * s_img[ty - 1][tx + 1];
  gx = gx + -k2 * s_img[ty][tx - 1];
  gx = gx + k2 * s_img[ty][tx + 1];
  gx = gx + -k1 * s_img[ty + 1][tx - 1];
  gx = gx + k1 * s_img[ty + 1][tx + 1];
  float gy = -k1 * s_img[ty - 1][tx - 1];
  gy = gy + -k2 * s_img[ty - 1][tx];
  gy = gy + -k1 * s_img[ty - 1][tx + 1];
  gy = gy + k1 * s_img[ty + 1][tx - 1];
  gy = gy + k2 * s_img[ty + 1][tx];
  gy = gy + k1 * s_img[ty + 1][tx + 1];
  gx = truncf(gx);
  gy = truncf(gy);
  a.didx[p] = gx;
  a.didy[p] = gy;

  // vertices (masked by the model id when mask_icp) and normals
  bool m00 = !a.mask_icp || s_mok[ty][tx];
  bool m01 = !a.mask_icp || s_mok[ty][tx + 1];
  bool m10 = !a.mask_icp || s_mok[ty + 1][tx];
  float v00[3], v01[3], v10[3], n[3];
  vertex(a.cam, d, x, y, a.cutoff, m00, v00);
  if (x + 1 < a.W) vertex(a.cam, s_depth[ty][tx + 1], x + 1, y, a.cutoff, m01, v01);
  else v01[0] = v01[1] = v01[2] = 0.f;
  if (y + 1 < a.H) vertex(a.cam, s_depth[ty + 1][tx], x, y + 1, a.cutoff, m10, v10);
  else v10[0] = v10[1] = v10[2] = 0.f;
  normal(v00, v01, v10, n);
  for (int c = 0; c < 3; ++c) {
    a.vmap[3 * p + c] = v00[c];
    a.nmap[3 * p + c] = n[c];
  }

  // static photometric validity: every in-bounds pixel of the window
  // [y-2, y+1] x [x-2, x+1] has intensity > 0 (and the model id)
  bool sv = false;
  if (a.use_rgb) {
    bool win = true;
    for (int dy = -2; dy <= 1; ++dy)
      for (int dx = -2; dx <= 1; ++dx) {
        int yy = y + dy, xx = x + dx;
        if (yy < 0 || yy >= a.H || xx < 0 || xx >= a.W) continue;
        bool ok = s_img[ty + dy][tx + dx] > 0.f && (!a.mask_rgb || s_mok[ty + dy][tx + dx]);
        win = win && ok;
      }
    sv = win && x < a.W - 5 && y < a.H - 1 && (gx * gx + gy * gy) >= a.min_scale && d > 0.f;
  }
  a.sv[p] = sv ? 1 : 0;
}

struct PredArgs {
  int level, H, W, Hp, Wp, compact;
  const float* vertex_conf;  // level 1 sources: the filled prediction [Hp, Wp, 4]
  const float* normal_rad;
  const float* color;        // [.., 3]
  const float* src_pdepth;   // level 2 sources: level 1's outputs
  const float* src_dlast;
  const float* src_ilast;
  Cam cam;
  float max_depth_rgb;
  float *pdepth, *dlast, *ilast;  // this level's pyramids (coarse levels)
  void* map;                      // [H, W, 8] bf16 (compact) or f32
};

struct FilledDepthSrc {  // the prediction's depth (vertex z)
  const float* vc;
  int W;
  __device__ float operator()(int y, int x) const { return vc[4 * (y * W + x) + 2]; }
};

struct FilledRgbDepthSrc {  // vertices_to_depth(vertex, max_depth_rgb)
  const float* vc;
  int W;
  float cutoff;
  __device__ float operator()(int y, int x) const {
    float z = vc[4 * (y * W + x) + 2];
    return (z > 0.f && z <= cutoff) ? z : 0.f;
  }
};

struct FilledIntensitySrc {
  const float* color;
  int W;
  __device__ float operator()(int y, int x) const {
    const float* c = color + 3 * (y * W + x);
    return intensity(c[0], c[1], c[2]);
  }
};

__device__ inline uint16_t bf16_bits(float v) {
  __nv_bfloat16 h = __float2bfloat16_rn(v);
  return *reinterpret_cast<uint16_t*>(&h);
}

__device__ inline float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__global__ void __launch_bounds__(TX * TY) pred_level(PredArgs a) {
  __shared__ float s_pd[TY + 1][TX + 1];
  int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  if (a.level > 0) {
    for (int k = threadIdx.y * TX + threadIdx.x; k < (TX + 1) * (TY + 1); k += TX * TY) {
      int ty = k / (TX + 1), tx = k % (TX + 1);
      int y = y0 + ty, x = x0 + tx;
      float d = 0.f;
      if (y < a.H && x < a.W) {
        d = a.level == 1 ? gauss_down(FilledDepthSrc{a.vertex_conf, a.Wp}, a.Hp, a.Wp, x, y)
                         : gauss_down(DenseSrc{a.src_pdepth, a.Wp}, a.Hp, a.Wp, x, y);
      }
      s_pd[ty][tx] = d;
    }
    __syncthreads();
  }
  int tx = threadIdx.x, ty = threadIdx.y;
  int x = x0 + tx, y = y0 + ty;
  if (x >= a.W || y >= a.H) return;
  int p = y * a.W + x;
  float v[3], n[3], dl, il;
  if (a.level == 0) {
    for (int c = 0; c < 3; ++c) {
      v[c] = a.vertex_conf[4 * p + c];
      n[c] = a.normal_rad[4 * p + c];
    }
    dl = FilledRgbDepthSrc{a.vertex_conf, a.W, a.max_depth_rgb}(y, x);
    il = FilledIntensitySrc{a.color, a.W}(y, x);
    if (a.compact) {
      float z = v[2];
      float zhi = bf16_round(z);
      uint16_t q[8] = {bf16_bits(z), bf16_bits(z - zhi), bf16_bits(n[0]), bf16_bits(n[1]),
                       bf16_bits(n[2]), bf16_bits(il), 0, 0};
      uint4 out;
      out.x = (uint32_t)q[0] | ((uint32_t)q[1] << 16);
      out.y = (uint32_t)q[2] | ((uint32_t)q[3] << 16);
      out.z = (uint32_t)q[4] | ((uint32_t)q[5] << 16);
      out.w = 0u;
      reinterpret_cast<uint4*>(a.map)[p] = out;
      return;
    }
  } else {
    float pd = s_pd[ty][tx];
    if (a.level == 1) {
      dl = gauss_down(FilledRgbDepthSrc{a.vertex_conf, a.Wp, a.max_depth_rgb}, a.Hp, a.Wp, x, y);
      il = gauss_down(FilledIntensitySrc{a.color, a.Wp}, a.Hp, a.Wp, x, y);
    } else {
      dl = gauss_down(DenseSrc{a.src_dlast, a.Wp}, a.Hp, a.Wp, x, y);
      il = gauss_down(DenseSrc{a.src_ilast, a.Wp}, a.Hp, a.Wp, x, y);
    }
    a.pdepth[p] = pd;
    a.dlast[p] = dl;
    a.ilast[p] = il;
    float v01[3], v10[3];
    vertex(a.cam, pd, x, y, 1e9f, true, v);
    if (x + 1 < a.W) vertex(a.cam, s_pd[ty][tx + 1], x + 1, y, 1e9f, true, v01);
    else v01[0] = v01[1] = v01[2] = 0.f;
    if (y + 1 < a.H) vertex(a.cam, s_pd[ty + 1][tx], x, y + 1, 1e9f, true, v10);
    else v10[0] = v10[1] = v10[2] = 0.f;
    normal(v, v01, v10, n);
  }
  float4* m = reinterpret_cast<float4*>(a.map);
  m[2 * p] = make_float4(v[0], v[1], v[2], n[0]);
  m[2 * p + 1] = make_float4(n[1], n[2], dl, il);
}

}  // namespace

extern "C" int mmf_pyramid_frame(int level, int H, int W, int Hp, int Wp, const float* src_depth,
                                 const float* src_img, const uint8_t* rgb, const int* mask,
                                 int W0, int mask_id, int mask_icp, int mask_rgb, int use_rgb,
                                 float fx, float fy, float cx, float cy, float inv_fx,
                                 float inv_fy, float cutoff, float min_scale, float* depth,
                                 float* img, float* didx, float* didy, float* vmap, float* nmap,
                                 uint8_t* sv, cudaStream_t stream) {
  FrameArgs a{level, H, W, Hp, Wp, src_depth, src_img, rgb, mask, W0, mask_id, mask_icp,
              mask_rgb, use_rgb, Cam{fx, fy, cx, cy, inv_fx, inv_fy}, cutoff, min_scale,
              depth, img, didx, didy, vmap, nmap, sv};
  dim3 block(TX, TY), grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  frame_level<<<grid, block, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mmf_pyramid_pred(int level, int H, int W, int Hp, int Wp, int compact,
                                const float* vertex_conf, const float* normal_rad,
                                const float* color, const float* src_pdepth,
                                const float* src_dlast, const float* src_ilast, float fx,
                                float fy, float cx, float cy, float inv_fx, float inv_fy,
                                float max_depth_rgb, float* pdepth, float* dlast, float* ilast,
                                void* map, cudaStream_t stream) {
  PredArgs a{level, H, W, Hp, Wp, compact, vertex_conf, normal_rad, color, src_pdepth,
             src_dlast, src_ilast, Cam{fx, fy, cx, cy, inv_fx, inv_fy}, max_depth_rgb,
             pdepth, dlast, ilast, map};
  dim3 block(TX, TY), grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  pred_level<<<grid, block, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
