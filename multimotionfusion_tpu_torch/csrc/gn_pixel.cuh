// Per-pixel evaluation shared by K4 gn_reduce (csrc/gn_reduce.cu) and K11
// gn_multi (csrc/gn_multi.cu): the warp of one pixel by an increment, its four
// bilinear taps of the prediction map (bf16 hi/lo depth rays at level 0, f32
// fields at the coarse levels), the ICP and photometric correspondences, and
// the upper-triangle accumulation of a row's outer product. Every expression
// is evaluated in the order of odometry/rgbd.py's plain version.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  int u0c, v0c;  // the taps' top-left corner (clamped)
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
  px.u0c = u0c;
  px.v0c = v0c;
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

// the point-to-plane ICP row [n, s x n, r] of a sampled pixel; false where a
// gate fails (rgbd.py:400 icp_system)
__device__ inline bool icp_row(const Params& P, const Pose& T, const Pixel& px, float* row) {
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
  if (!found) return false;
  const float* s = px.vcp;
  row[0] = n[0];
  row[1] = n[1];
  row[2] = n[2];
  row[3] = s[1] * n[2] - s[2] * n[1];
  row[4] = s[2] * n[0] - s[0] * n[2];
  row[5] = s[0] * n[1] - s[1] * n[0];
  row[6] = n[0] * (s[0] - px.d[0]) + n[1] * (s[1] - px.d[1]) + n[2] * (s[2] - px.d[2]);
  return true;
}

// the weighted photometric row of a sampled pixel, weight 1 / (sigma_val +
// |diff|); false where the correspondence is invalid (rgbd.py:536 rgb_system)
__device__ inline bool rgb_row(const Params& P, const Pixel& px, float sigma_val, float* row) {
  float cp[3], diff;
  if (!rgb_corr(P, px, cp, &diff)) return false;
  float w_raw = sigma_val + fabsf(diff);
  float w = w_raw > 1.19209290e-7f ? 1.f / w_raw : 1.f;
  if (P.rgb_only) w = 1.f;
  float invz = cp[2] != 0.f ? 1.f / cp[2] : 0.f;
  float dIx = w * P.sobel_scale * px.didx;
  float dIy = w * P.sobel_scale * px.didy;
  float v0c = dIx * P.fx * invz;
  float v1c = dIy * P.fy * invz;
  float v2c = -(v0c * cp[0] + v1c * cp[1]) * invz;
  row[0] = v0c;
  row[1] = v1c;
  row[2] = v2c;
  row[3] = -cp[2] * v1c + cp[1] * v2c;
  row[4] = cp[2] * v0c - cp[0] * v2c;
  row[5] = -cp[1] * v0c + cp[0] * v1c;
  row[6] = -w * diff;
  return true;
}

__device__ inline void add_outer(float* acc, const float* row) {
  int k = 0;
  for (int i = 0; i < 7; ++i)
    for (int j = i; j < 7; ++j) acc[k++] += row[i] * row[j];
}

}  // namespace
