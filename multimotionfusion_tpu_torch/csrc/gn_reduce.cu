// K4 gn_reduce: one evaluation of the ICP and photometric 7x7 normal systems.
//
// Replaces: multimotionfusion_tpu/odometry/rgbd.py:809 eval_systems, with
//   :322/:346 build_compact_bank/sample_compact (level 0), :269/:297
//   build_generic_bank/sample_generic (coarse levels), :400 icp_system,
//   :491 rgb_correspondences and :536 rgb_system.
// Bound on an H100: bytes and launch latency. Per evaluated pixel the pass
//   reads ~38 bytes of frame fields and four taps of the prediction map
//   (16 bytes each at level 0, bf16; 32 at the coarse levels, f32); 76,800
//   pixels at levels 0 (stride-2 grid) and 1, 19,200 at level 2. That is a
//   few MB per evaluation, i.e. microseconds, so the four launches per call
//   and the host read of the result dominate.
// Design: every thread evaluates pixels of the (strided) grid: transform by
//   inv(result_Rt), project, fetch the four bilinear taps, apply the ICP gates
//   and the RGB gates (rgb_static_valid precomputed per level), and adds the
//   outer products of its rows to register accumulators: no [P, 7] row matrix
//   is written. Blocks reduce with warp shuffles and shared memory into
//   per-block partials; a second kernel sums the partials in a fixed order.
//   No float atomics, so results are the same run to run.
//   The RGB row weight 1 / (sigma_val + |diff|) needs this iteration's RGB
//   count (sigma_val = count * scale2 unless the error is 0), so the call
//   takes two passes: pass 1 reduces the ICP system, the ICP count, the RGB
//   count and sum(diff^2); its finalize writes them to `sums`; pass 2 reads
//   the count from `sums` on the device (no host round trip) and reduces the
//   weighted RGB system.
// Output `sums` (64 floats): [0:28] upper triangle of S_icp, [28:56] of
//   S_rgb, [56] ICP count, [57] RGB count, [58] sum(diff^2), all on the
//   evaluated grid (the caller scales by stride^2).
// The pose increment inv(result_Rt) is read by pointer from the odometry's
//   state on the card (csrc/gn_step.cu), and every kernel returns at once
//   when the GN loop's done flag is set, so the host enqueues the fixed
//   iteration budget without reading anything back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLOTS = 64;

struct Pose {
  float r[9];
  float t[3];
};

struct Params {
  const float* Tinv;  // [4, 4] row-major inv(result_Rt), read on the card
  const float* done;  // the GN loop's done flag (nullptr: never done)
  float fx, fy, cx, cy;
  int H, W, stride, Hs, Ws;
  int compact, use_icp, use_rgb, rgb_only;
  float dist_thresh, angle_thresh, max_dd, max_depth_rgb, sobel_scale, scale2;
};

__device__ inline float bf16_lo(unsigned v) { return __uint_as_float(v << 16); }
__device__ inline float bf16_hi(unsigned v) { return __uint_as_float(v & 0xffff0000u); }

__device__ inline void load_tap(const void* pred, int compact, int idx, float* t) {
  if (compact) {
    uint4 q = reinterpret_cast<const uint4*>(pred)[idx];
    t[0] = bf16_lo(q.x); t[1] = bf16_hi(q.x);
    t[2] = bf16_lo(q.y); t[3] = bf16_hi(q.y);
    t[4] = bf16_lo(q.z); t[5] = bf16_hi(q.z);
    t[6] = bf16_lo(q.w); t[7] = bf16_hi(q.w);
  } else {
    const float4* f = reinterpret_cast<const float4*>(pred);
    float4 a = f[2 * idx], b = f[2 * idx + 1];
    t[0] = a.x; t[1] = a.y; t[2] = a.z; t[3] = a.w;
    t[4] = b.x; t[5] = b.y; t[6] = b.z; t[7] = b.w;
  }
}

// bilinear blend of channels [c0, c0 + n), valid iff in bounds and every tap
// has a nonzero channel in that range
__device__ inline bool interp(float (*t)[8], float fu, float fv, bool inb, int c0, int n,
                              float* out) {
  bool ok = inb;
  for (int k = 0; k < 4; ++k) {
    bool any = false;
    for (int c = c0; c < c0 + n; ++c) any = any || (t[k][c] != 0.f);
    ok = ok && any;
  }
  for (int c = c0; c < c0 + n; ++c) {
    float v = t[0][c] * (1 - fu) * (1 - fv) + t[1][c] * fu * (1 - fv) +
              t[2][c] * (1 - fu) * fv + t[3][c] * fu * fv;
    out[c - c0] = ok ? v : 0.f;
  }
  return ok;
}

struct Pixel {
  float vcp[3], uf, vf;
  float d[3], n[3], dl, il;
  bool d_ok, n_ok, dl_ok, il_ok;
  float nm[3];  // current normal
  float img, didx, didy;
  bool sv, v_valid;
};

__device__ inline Pose load_pose(const float* T) {
  Pose p;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) p.r[3 * i + j] = T[4 * i + j];
    p.t[i] = T[4 * i + 3];
  }
  return p;
}

__device__ inline bool is_done(const Params& P) { return P.done != nullptr && *P.done != 0.f; }

__device__ inline void eval_pixel(const Params& P, const Pose& T, const void* pred, const float* vmap,
                                  const float* nmap, const float* img, const float* didx,
                                  const float* didy, const uint8_t* sv, int q, Pixel& px) {
  int y = (q / P.Ws) * P.stride, x = (q % P.Ws) * P.stride;
  int p = y * P.W + x;
  float v[3] = {vmap[3 * p], vmap[3 * p + 1], vmap[3 * p + 2]};
  px.nm[0] = nmap[3 * p]; px.nm[1] = nmap[3 * p + 1]; px.nm[2] = nmap[3 * p + 2];
  px.img = img[p]; px.didx = didx[p]; px.didy = didy[p];
  px.sv = sv[p] != 0;
  px.v_valid = v[2] > 0.f;
  for (int r = 0; r < 3; ++r)
    px.vcp[r] = T.r[3 * r] * v[0] + T.r[3 * r + 1] * v[1] + T.r[3 * r + 2] * v[2] + T.t[r];
  float z = px.vcp[2];
  float safe_z = z != 0.f ? z : 1.f;
  px.uf = px.vcp[0] * P.fx / safe_z + P.cx;
  px.vf = px.vcp[1] * P.fy / safe_z + P.cy;

  float u0f = floorf(px.uf), v0f = floorf(px.vf);
  int u0i = (int)fminf(fmaxf(u0f, -1073741824.f), 1073741824.f);
  int v0i = (int)fminf(fmaxf(v0f, -1073741824.f), 1073741824.f);
  bool inb = u0i >= 0 && v0i >= 0 && u0i < P.W - 1 && v0i < P.H - 1;
  int u0c = min(max(u0i, 0), P.W - 2), v0c = min(max(v0i, 0), P.H - 2);
  float fu = px.uf - u0f, fv = px.vf - v0f;
  float t[4][8];
  load_tap(pred, P.compact, v0c * P.W + u0c, t[0]);
  load_tap(pred, P.compact, v0c * P.W + u0c + 1, t[1]);
  load_tap(pred, P.compact, (v0c + 1) * P.W + u0c, t[2]);
  load_tap(pred, P.compact, (v0c + 1) * P.W + u0c + 1, t[3]);

  if (!P.compact) {
    px.d_ok = interp(t, fu, fv, inb, 0, 3, px.d);
    px.n_ok = interp(t, fu, fv, inb, 3, 3, px.n);
    px.dl_ok = interp(t, fu, fv, inb, 6, 1, &px.dl);
    px.il_ok = interp(t, fu, fv, inb, 7, 1, &px.il);
    return;
  }
  // level 0: vertices rebuilt per tap from the tap's pixel ray and the
  // bf16 hi + lo depth
  float u0 = fminf(fmaxf(u0f, 0.f), (float)(P.W - 2));
  float v0 = fminf(fmaxf(v0f, 0.f), (float)(P.H - 2));
  float wg[4] = {(1 - fu) * (1 - fv), fu * (1 - fv), (1 - fu) * fv, fu * fv};
  float d[3] = {0.f, 0.f, 0.f}, dl = 0.f;
  bool d_ok = inb, dl_ok = inb;
  for (int k = 0; k < 4; ++k) {
    float dy = (float)(k >> 1), dx = (float)(k & 1);
    float zt = t[k][0] + t[k][1];
    d_ok = d_ok && (t[k][0] != 0.f);
    float lx = (u0 + dx - P.cx) / P.fx;
    float ly = (v0 + dy - P.cy) / P.fy;
    d[0] = d[0] + wg[k] * (lx * zt);
    d[1] = d[1] + wg[k] * (ly * zt);
    d[2] = d[2] + wg[k] * zt;
    float zr = zt <= P.max_depth_rgb ? zt : 0.f;
    dl_ok = dl_ok && (zr > 0.f);
    dl = dl + wg[k] * zr;
  }
  for (int r = 0; r < 3; ++r) px.d[r] = d_ok ? d[r] : 0.f;
  px.d_ok = d_ok;
  px.n_ok = interp(t, fu, fv, inb, 2, 3, px.n);
  px.il_ok = interp(t, fu, fv, inb, 5, 1, &px.il);
  px.dl = dl_ok ? dl : 0.f;
  px.dl_ok = dl_ok;
}

__device__ inline float norm3(float a, float b, float c) { return sqrtf(a * a + b * b + c * c); }

// RGB correspondence of a sampled pixel: (valid, cp, diff)
__device__ inline bool rgb_corr(const Params& P, const Pixel& px, float* cp, float* diff) {
  bool valid = px.sv && px.dl_ok && px.il_ok && fabsf(px.vcp[2] - px.dl) <= P.max_dd;
  cp[0] = px.dl * (px.uf - P.cx) / P.fx;
  cp[1] = px.dl * (px.vf - P.cy) / P.fy;
  cp[2] = px.dl;
  *diff = valid ? px.img - px.il : 0.f;
  return valid;
}

template <int NV>
__device__ inline void block_reduce(float* acc, float (*sh)[SLOTS], const int* slot,
                                    float* partials) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < NV; ++i) {
    float v = acc[i];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sh[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += sh[w][threadIdx.x];
    partials[blockIdx.x * SLOTS + slot[threadIdx.x]] = s;
  }
}

__constant__ int PASS1_SLOTS[31] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10,
                                    11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
                                    22, 23, 24, 25, 26, 27, 56, 57, 58};
__constant__ int PASS2_SLOTS[28] = {28, 29, 30, 31, 32, 33, 34, 35, 36, 37,
                                    38, 39, 40, 41, 42, 43, 44, 45, 46, 47,
                                    48, 49, 50, 51, 52, 53, 54, 55};

__device__ inline void add_outer(float* acc, const float* row) {
  int k = 0;
  for (int i = 0; i < 7; ++i)
    for (int j = i; j < 7; ++j) acc[k++] += row[i] * row[j];
}

// pass 1: ICP system + ICP count + RGB count + sum(diff^2)
__global__ void __launch_bounds__(THREADS)
pass1(Params P, const void* pred, const float* vmap, const float* nmap, const float* img,
      const float* didx, const float* didy, const uint8_t* sv, float* partials) {
  if (is_done(P)) return;
  const Pose T = load_pose(P.Tinv);
  __shared__ float sh[WARPS][SLOTS];
  float acc[31];
  for (int i = 0; i < 31; ++i) acc[i] = 0.f;
  int n = P.Hs * P.Ws;
  for (int q = blockIdx.x * THREADS + threadIdx.x; q < n; q += gridDim.x * THREADS) {
    Pixel px;
    eval_pixel(P, T, pred, vmap, nmap, img, didx, didy, sv, q, px);
    if (P.use_rgb) {
      float cp[3], diff;
      bool valid = rgb_corr(P, px, cp, &diff);
      acc[29] += valid ? 1.f : 0.f;
      acc[30] += diff * diff;
    }
    if (P.use_icp) {
      float nn = fmaxf(norm3(px.n[0], px.n[1], px.n[2]), 1e-12f);
      float n[3] = {px.n[0] / nn, px.n[1] / nn, px.n[2] / nn};
      bool in_bounds = px.d_ok && px.n_ok && px.vcp[2] > 0.f && px.v_valid;
      float nc[3];
      for (int r = 0; r < 3; ++r)
        nc[r] = T.r[3 * r] * px.nm[0] + T.r[3 * r + 1] * px.nm[1] + T.r[3 * r + 2] * px.nm[2];
      float dist = norm3(px.d[0] - px.vcp[0], px.d[1] - px.vcp[1], px.d[2] - px.vcp[2]);
      float sine = norm3(nc[1] * n[2] - nc[2] * n[1], nc[2] * n[0] - nc[0] * n[2],
                         nc[0] * n[1] - nc[1] * n[0]);
      bool ncurr_valid = (px.nm[0] * px.nm[0] + px.nm[1] * px.nm[1] + px.nm[2] * px.nm[2]) > 0.f;
      bool found = in_bounds && sine < P.angle_thresh && dist <= P.dist_thresh && ncurr_valid;
      if (found) {
        const float* s = px.vcp;
        float r = n[0] * (s[0] - px.d[0]) + n[1] * (s[1] - px.d[1]) + n[2] * (s[2] - px.d[2]);
        float row[7] = {n[0], n[1], n[2], s[1] * n[2] - s[2] * n[1], s[2] * n[0] - s[0] * n[2],
                        s[0] * n[1] - s[1] * n[0], r};
        add_outer(acc, row);
        acc[28] += 1.f;
      }
    }
  }
  block_reduce<31>(acc, sh, PASS1_SLOTS, partials);
}

// pass 2: the weighted RGB system (needs pass 1's RGB count and sum(diff^2))
__global__ void __launch_bounds__(THREADS)
pass2(Params P, const void* pred, const float* vmap, const float* nmap, const float* img,
      const float* didx, const float* didy, const uint8_t* sv, const float* sums,
      float* partials) {
  if (is_done(P)) return;
  const Pose T = load_pose(P.Tinv);
  __shared__ float sh[WARPS][SLOTS];
  float acc[28];
  for (int i = 0; i < 28; ++i) acc[i] = 0.f;
  float rgb_size = sums[57] * P.scale2;
  float tmp_err = sqrtf(sums[58] * P.scale2) / fmaxf(rgb_size, 1.f);
  float sigma_val = tmp_err == 0.f ? 1.f : rgb_size;
  int n = P.Hs * P.Ws;
  for (int q = blockIdx.x * THREADS + threadIdx.x; q < n; q += gridDim.x * THREADS) {
    Pixel px;
    eval_pixel(P, T, pred, vmap, nmap, img, didx, didy, sv, q, px);
    float cp[3], diff;
    if (!rgb_corr(P, px, cp, &diff)) continue;
    float w_raw = sigma_val + fabsf(diff);
    float w = w_raw > 1.19209290e-7f ? 1.f / w_raw : 1.f;
    if (P.rgb_only) w = 1.f;
    float invz = cp[2] != 0.f ? 1.f / cp[2] : 0.f;
    float dIx = w * P.sobel_scale * px.didx;
    float dIy = w * P.sobel_scale * px.didy;
    float v0c = dIx * P.fx * invz;
    float v1c = dIy * P.fy * invz;
    float v2c = -(v0c * cp[0] + v1c * cp[1]) * invz;
    float row[7] = {v0c, v1c, v2c, -cp[2] * v1c + cp[1] * v2c, cp[2] * v0c - cp[0] * v2c,
                    -cp[1] * v0c + cp[0] * v1c, -w * diff};
    add_outer(acc, row);
  }
  block_reduce<28>(acc, sh, PASS2_SLOTS, partials);
}

// fixed-order sum over blocks of the partials of one pass's slots
__global__ void finalize(Params P, const float* partials, int blocks, int pass, float* sums) {
  if (is_done(P)) return;
  int v = threadIdx.x;
  bool mine = pass == 1 ? (v < 28 || (v >= 56 && v < 59)) : (v >= 28 && v < 56);
  if (!mine) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partials[b * SLOTS + v];
  sums[v] = s;
}

}  // namespace

extern "C" int mmf_gn_reduce(const void* pred, int compact, int H, int W, const float* vmap,
                             const float* nmap, const float* img, const float* didx,
                             const float* didy, const uint8_t* static_valid, int stride, int Hs,
                             int Ws, const float* Tinv, const float* done, float fx, float fy, float cx, float cy, int use_icp,
                             int use_rgb, int rgb_only, float dist_thresh, float angle_thresh,
                             float max_dd, float max_depth_rgb, float sobel_scale, float scale2,
                             int blocks, float* partials, float* sums, cudaStream_t stream) {
  Params P;
  P.Tinv = Tinv;
  P.done = done;
  P.fx = fx; P.fy = fy; P.cx = cx; P.cy = cy;
  P.H = H; P.W = W; P.stride = stride; P.Hs = Hs; P.Ws = Ws;
  P.compact = compact; P.use_icp = use_icp; P.use_rgb = use_rgb; P.rgb_only = rgb_only;
  P.dist_thresh = dist_thresh; P.angle_thresh = angle_thresh; P.max_dd = max_dd;
  P.max_depth_rgb = max_depth_rgb; P.sobel_scale = sobel_scale; P.scale2 = scale2;
  cudaMemsetAsync(sums, 0, sizeof(float) * SLOTS, stream);
  pass1<<<blocks, THREADS, 0, stream>>>(P, pred, vmap, nmap, img, didx, didy, static_valid,
                                        partials);
  finalize<<<1, SLOTS, 0, stream>>>(P, partials, blocks, 1, sums);
  if (use_rgb) {
    pass2<<<blocks, THREADS, 0, stream>>>(P, pred, vmap, nmap, img, didx, didy, static_valid,
                                          sums, partials);
    finalize<<<1, SLOTS, 0, stream>>>(P, partials, blocks, 2, sums);
  }
  return (int)cudaGetLastError();
}
