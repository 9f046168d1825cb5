// K1 frame_maps: the frame's filtered depth and its surfel candidates.
//
// Replaces: multimotionfusion_tpu/ops/image.py:158 bilateral_depth_filter,
//   ops/maps.py:42 create_vmap and :62 create_nmap, and
//   model/surfel_map.py:123 compute_frame_surfels.
// Bound on an H100: operations in launch 1 (169 taps with one expf each per
//   pixel), bytes in launch 2 (a 16-channel column per pixel, 64 bytes).
// Design: two launches a frame.
//   1. filter: one thread per pixel converts the raw depth (uint16 mm carried
//      as int16 bits, or metres) to metres, writes it, and runs the 13x13
//      bilateral filter tap by tap in the reference's row-major order, so the
//      sums round as the plain version's and the reference's. The spatial
//      term of each tap is rounded from double, as the reference computes
//      it (a Python float times the constant); expf, not __expf.
//   2. surfels: a 32x8 block stages the filtered depth of its tile plus a
//      one-pixel halo (right, bottom) in shared memory, rebuilds the filtered
//      vertices and their cross-product normals from it, the raw vertices
//      from the raw depth, and writes the [16, H*W] surfel candidates and the
//      valid mask. The fusion weighting is read by pointer (it is the output
//      of the odometry on the same stream), so no host value is needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum {
  PX = 0, PY = 1, PZ = 2, CONF = 3, CR = 4, CG = 5, CB = 6, INIT_T = 7, LAST_T = 8,
  NX = 9, NY = 10, NZ = 11, RADIUS = 12, ALIVE = 13, CH = 16
};
constexpr int R = 6;  // bilateral radius
constexpr int TAPS = (2 * R + 1) * (2 * R + 1);
constexpr int TX = 32, TY = 8;

__device__ inline float raw_depth(const void* raw, int is_mm, int p) {
  if (is_mm) {
    int v = (int)reinterpret_cast<const int16_t*>(raw)[p] & 0xFFFF;
    return (float)v * 0.001f;
  }
  return reinterpret_cast<const float*>(raw)[p];
}

__global__ void bilateral(const void* __restrict__ raw, int is_mm, int H, int W, float min_d,
                          float max_d, double sigma_space, float sigma_color,
                          float* __restrict__ depth_m, float* __restrict__ depth_filt) {
  __shared__ float space[TAPS];
  for (int k = threadIdx.x; k < TAPS; k += blockDim.x) {
    int oy = k / (2 * R + 1) - R, ox = k % (2 * R + 1) - R;
    space[k] = (float)((double)(ox * ox + oy * oy) * sigma_space);
  }
  __syncthreads();
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= H * W) return;
  int y = p / W, x = p % W;
  float d = raw_depth(raw, is_mm, p);
  depth_m[p] = d;
  bool valid = d >= min_d && d <= max_d;
  float base = valid ? d : 0.f;
  float sum1 = 0.f, sum2 = 0.f;
  int k = 0;
  for (int oy = -R; oy <= R; ++oy) {
    int yy = y + oy;
    for (int ox = -R; ox <= R; ++ox, ++k) {
      int xx = x + ox;
      float s = 0.f;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
        float dq = raw_depth(raw, is_mm, yy * W + xx);
        s = (dq >= min_d && dq <= max_d) ? dq : 0.f;
      }
      float diff = base - s;
      float c2 = diff * diff;
      float w = expf(-(space[k] + c2 * sigma_color));
      w = s > 0.f ? w : 0.f;
      sum1 = sum1 + s * w;
      sum2 = sum2 + w;
    }
  }
  float out = sum2 > 0.f ? sum1 / fmaxf(sum2, 1e-12f) : 0.f;
  depth_filt[p] = valid ? out : 0.f;
}

struct Cam {
  float fx, fy, cx, cy, inv_fx, inv_fy;
};

// create_vmap at one pixel: valid iff 0 < d < cutoff
__device__ inline void vertex(const Cam& c, float d, int x, int y, float cutoff, float* v) {
  bool ok = d > 0.f && d < cutoff;
  float z = ok ? d : 0.f;
  v[0] = ok ? z * ((float)x - c.cx) * c.inv_fx : 0.f;
  v[1] = ok ? z * ((float)y - c.cy) * c.inv_fy : 0.f;
  v[2] = z;
}

// create_nmap from the pixel's vertex and its right and lower neighbours
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

__global__ void __launch_bounds__(TX * TY)
surfels(const float* __restrict__ depth_m, const float* __restrict__ depth_filt,
        const uint8_t* __restrict__ rgb, int H, int W, Cam c, float cutoff, float max_depth,
        float time, const float* __restrict__ weighting, float rad_scale,
        float* __restrict__ data, uint8_t* __restrict__ valid_out) {
  __shared__ float tile[TY + 1][TX + 1];
  int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  for (int k = threadIdx.y * TX + threadIdx.x; k < (TX + 1) * (TY + 1); k += TX * TY) {
    int ty = k / (TX + 1), tx = k % (TX + 1);
    int yy = y0 + ty, xx = x0 + tx;
    tile[ty][tx] = (yy < H && xx < W) ? depth_filt[yy * W + xx] : 0.f;
  }
  __syncthreads();
  int tx = threadIdx.x, ty = threadIdx.y;
  int x = x0 + tx, y = y0 + ty;
  if (x >= W || y >= H) return;
  int p = y * W + x;
  int N = H * W;
  float vf[3], v01[3], v10[3], n[3], vr[3];
  vertex(c, tile[ty][tx], x, y, cutoff, vf);
  if (x + 1 < W) vertex(c, tile[ty][tx + 1], x + 1, y, cutoff, v01);
  else v01[0] = v01[1] = v01[2] = 0.f;
  if (y + 1 < H) vertex(c, tile[ty + 1][tx], x, y + 1, cutoff, v10);
  else v10[0] = v10[1] = v10[2] = 0.f;
  normal(vf, v01, v10, n);
  vertex(c, depth_m[p], x, y, cutoff, vr);

  float z = vr[2];
  bool valid = z > 0.f && z <= max_depth && (n[0] * n[0] + n[1] * n[1] + n[2] * n[2]) > 0.f;
  // pixel_confidence: exp(-radial^2 / 0.72) * weighting, radial = |(x, y) - c| / 400
  float ys = (float)y - c.cy, xs = (float)x - c.cx;
  float radial = sqrtf(ys * ys + xs * xs) / 400.0f;
  float conf = expf(-(radial * radial) / 0.72f) * (*weighting);
  // radius_from_depth of the filtered vertex and normal
  float radius = vf[2] * rad_scale;
  float radius_n = radius / fmaxf(fabsf(n[2]), 1e-6f);
  float rad = fminf(2.0f * radius, radius_n);

  data[PX * N + p] = vr[0];
  data[PY * N + p] = vr[1];
  data[PZ * N + p] = z;
  data[CONF * N + p] = conf;
  data[CR * N + p] = (float)rgb[3 * p];
  data[CG * N + p] = (float)rgb[3 * p + 1];
  data[CB * N + p] = (float)rgb[3 * p + 2];
  data[INIT_T * N + p] = time;
  data[LAST_T * N + p] = time;
  data[NX * N + p] = n[0];
  data[NY * N + p] = n[1];
  data[NZ * N + p] = n[2];
  data[RADIUS * N + p] = rad;
  data[ALIVE * N + p] = valid ? 1.f : 0.f;
  data[14 * N + p] = 0.f;
  data[15 * N + p] = 0.f;
  valid_out[p] = valid ? 1 : 0;
}

}  // namespace

extern "C" int mmf_frame_depth(const void* raw, int is_mm, int H, int W, float min_d,
                               float max_d, double sigma_space, float sigma_color,
                               float* depth_m, float* depth_filt, cudaStream_t stream) {
  const int threads = 256;
  bilateral<<<(H * W + threads - 1) / threads, threads, 0, stream>>>(
      raw, is_mm, H, W, min_d, max_d, sigma_space, sigma_color, depth_m, depth_filt);
  return (int)cudaGetLastError();
}

extern "C" int mmf_frame_surfels(const float* depth_m, const float* depth_filt,
                                 const uint8_t* rgb, int H, int W, float fx, float fy, float cx,
                                 float cy, float inv_fx, float inv_fy, float cutoff,
                                 float max_depth, float time, const float* weighting,
                                 float rad_scale, float* data, uint8_t* valid,
                                 cudaStream_t stream) {
  Cam c{fx, fy, cx, cy, inv_fx, inv_fy};
  dim3 block(TX, TY), grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  surfels<<<grid, block, 0, stream>>>(depth_m, depth_filt, rgb, H, W, c, cutoff, max_depth,
                                      time, weighting, rad_scale, data, valid);
  return (int)cudaGetLastError();
}
