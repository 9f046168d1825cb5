// K1 frame_maps: the frame's filtered depth and its surfel candidates.
//
// Replaces: multimotionfusion_tpu/ops/image.py:158 bilateral_depth_filter,
//   ops/maps.py:42 create_vmap and :62 create_nmap, and
//   model/surfel_map.py:123 compute_frame_surfels.
// Bound on an H100: operations in launch 1 (169 taps with one expf each per
//   pixel), bytes in launch 2 (a 16-channel column per pixel, 64 bytes).
// Design: two launches a frame.
//   1. filter: a 128-thread block stages its 64x8 tile's depth plus the
//      radius-6 halo once in shared memory, converted to metres (uint16 mm
//      carried as int16 bits, or metres) and zeroed outside [min_d, max_d]
//      and outside the image (the plain version's shifted zero fill), so a
//      tap needs no conversion, range test or bounds test. Each thread
//      filters four pixels of a row, so a staged value is read once for all
//      of them; the 13 taps of a row are unrolled. Each output sums its taps
//      in the reference's row-major order, so the sums round as the plain
//      version's and the reference's. A tap whose depth is 0 adds exactly +0
//      to both sums: its weight is zeroed by a gate of +inf added to the
//      exponent (computed once per staged value; a branch around each tap
//      cost 40 % more, tests/torch_kernel_variants.py --only levels), and a
//      thread whose four centres are all invalid writes zeros without a tap:
//      both leave every bit as it was. The spatial term of each tap is rounded from double, as the
//      reference computes it (a Python float times the constant); expf, not
//      __expf. The metric depth is written beside the filtered one.
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

// the filter's tile: FX pixels a thread along a row, FTX x FTY threads
constexpr int FX = 4, FTX = 16, FTY = 8;
constexpr int FW = FX * FTX, FH = FTY;            // a block's output tile, 64 x 8
constexpr int SW = FW + 2 * R, SH = FH + 2 * R;   // its staged depth, 76 x 20

__device__ inline float raw_depth(const void* raw, int is_mm, int p) {
  if (is_mm) {
    int v = (int)reinterpret_cast<const int16_t*>(raw)[p] & 0xFFFF;
    return (float)v * 0.001f;
  }
  return reinterpret_cast<const float*>(raw)[p];
}

__global__ void __launch_bounds__(FTX * FTY)
bilateral(const void* __restrict__ raw, int is_mm, int H, int W, float min_d, float max_d,
          double sigma_space, float sigma_color, int vec, float* __restrict__ depth_m,
          float* __restrict__ depth_filt) {
  __shared__ float space[TAPS];
  __shared__ __align__(16) float tile[SH][SW];
  const int t = threadIdx.y * FTX + threadIdx.x;
  for (int k = t; k < TAPS; k += FTX * FTY) {
    int oy = k / (2 * R + 1) - R, ox = k % (2 * R + 1) - R;
    space[k] = (float)((double)(ox * ox + oy * oy) * sigma_space);
  }
  // the tile's depth with its halo, in metres, 0 outside the range and the image
  // (a thread's loads all issued before its first store)
  const int x0 = blockIdx.x * FW - R, y0 = blockIdx.y * FH - R;
  constexpr int PER = (SH * SW + FTX * FTY - 1) / (FTX * FTY);
  float dq[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    int k = t + j * FTX * FTY, ty = k / SW, tx = k - ty * SW;
    int y = y0 + ty, x = x0 + tx;
    dq[j] = (k < SH * SW && y >= 0 && y < H && x >= 0 && x < W) ? raw_depth(raw, is_mm, y * W + x)
                                                                  : 0.f;
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    int k = t + j * FTX * FTY;
    if (k < SH * SW) (&tile[0][0])[k] = (dq[j] >= min_d && dq[j] <= max_d) ? dq[j] : 0.f;
  }
  __syncthreads();
  const int y = blockIdx.y * FH + threadIdx.y;
  const int xs = blockIdx.x * FW + threadIdx.x * FX;
  if (y >= H || xs >= W) return;
  // a centre is valid iff its staged depth is > 0 (min_d > 0), and then
  // that depth is the plain version's `base`
  float base[FX], sum1[FX], sum2[FX];
  bool any = false;
#pragma unroll
  for (int i = 0; i < FX; ++i) {
    base[i] = tile[threadIdx.y + R][threadIdx.x * FX + R + i];
    sum1[i] = 0.f;
    sum2[i] = 0.f;
    any = any || base[i] > 0.f;
  }
  if (any) {
#pragma unroll 1
    for (int oy = 0; oy < 2 * R + 1; ++oy) {
      // this row's FX + 2R staged values, as float4 (the row pitch and the
      // thread's first column are multiples of 4 floats)
      float s[FX + 2 * R];
      const float4* row =
          reinterpret_cast<const float4*>(&tile[threadIdx.y + oy][threadIdx.x * FX]);
#pragma unroll
      for (int j = 0; j < (FX + 2 * R) / 4; ++j) {
        float4 q = row[j];
        s[4 * j] = q.x;
        s[4 * j + 1] = q.y;
        s[4 * j + 2] = q.z;
        s[4 * j + 3] = q.w;
      }
      // a zero tap's gate: +inf in the exponent makes its weight expf(-inf) = +0
      float g[FX + 2 * R];
#pragma unroll
      for (int j = 0; j < FX + 2 * R; ++j) g[j] = s[j] > 0.f ? 0.f : __int_as_float(0x7f800000);
#pragma unroll
      for (int ox = 0; ox < 2 * R + 1; ++ox) {
        const float sp = space[oy * (2 * R + 1) + ox];
#pragma unroll
        for (int i = 0; i < FX; ++i) {
          const float sq = s[i + ox];
          float diff = base[i] - sq;
          float c2 = diff * diff;
          // (sp + c2 * sigma_color) >= +0, so adding the gate's +0 leaves it
          // as the reference rounds it
          float w = expf(-((sp + c2 * sigma_color) + g[i + ox]));
          sum1[i] = sum1[i] + sq * w;
          sum2[i] = sum2[i] + w;
        }
      }
    }
  }
  float out[FX], dm[FX];
#pragma unroll
  for (int i = 0; i < FX; ++i) {
    float o = sum2[i] > 0.f ? sum1[i] / fmaxf(sum2[i], 1e-12f) : 0.f;
    out[i] = base[i] > 0.f ? o : 0.f;
    dm[i] = xs + i < W ? raw_depth(raw, is_mm, y * W + xs + i) : 0.f;
  }
  const int p = y * W + xs;
  if (vec) {  // W % 4 == 0: the FX pixels lie in the image, 16-byte aligned
#pragma unroll
    for (int i = 0; i < FX; i += 4) {
      *reinterpret_cast<float4*>(depth_m + p + i) = make_float4(dm[i], dm[i + 1], dm[i + 2],
                                                                dm[i + 3]);
      *reinterpret_cast<float4*>(depth_filt + p + i) = make_float4(out[i], out[i + 1],
                                                                   out[i + 2], out[i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < FX; ++i) {
      if (xs + i < W) {
        depth_m[p + i] = dm[i];
        depth_filt[p + i] = out[i];
      }
    }
  }
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
  static_assert(FX % 4 == 0 && (FX + 2 * R) % 4 == 0 && SW % 4 == 0, "float4 rows and stores");
  int vec = W % 4 == 0 && ((uintptr_t)depth_m | (uintptr_t)depth_filt) % 16 == 0;
  dim3 block(FTX, FTY), grid((W + FW - 1) / FW, (H + FH - 1) / FH);
  bilateral<<<grid, block, 0, stream>>>(raw, is_mm, H, W, min_d, max_d, sigma_space,
                                        sigma_color, vec, depth_m, depth_filt);
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
