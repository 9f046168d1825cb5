// K10 splat_resolve: the 5x5 ray-disk resolve of the next frame's prediction.
//
// Replaces: multimotionfusion_tpu/ops/rasterize.py:366 splat_resolve
//   (pre_gated=False, the static frame step's call, and the composite mode of
//   the multi-model step, :419-471) and, as an epilogue, model/fillin.py:25
//   fill_in (with its `gate`).
// Bound on an H100: bytes. Per pixel: the 5x5 window of the index map (served
//   from L1/L2: neighbouring threads share 24 of 25 taps), one 10-channel
//   gather of each distinct winner surfel in data_local, and 49 bytes of
//   output (colour, vertex+conf, normal+radius, time, valid).
// Design: one thread per pixel walks the taps in the reference order (dy
//   outer, dx inner) and keeps the candidate whose ray-plane hit is strictly
//   nearer (`<`, so ties resolve as in the reference), after the per-candidate
//   gates conf >= threshold, time - last_t <= time_delta, last_t <= max_time,
//   the disk test |hit - p|^2 <= r^2 and hz > 0. It carries the winner's
//   colour, confidence, normal, radius and init time, so no attribute image
//   is materialised.
// Fill-in epilogue (when the frame's inputs are given): where no surfel won
//   the pixel (or always, with passthrough), the thread writes the live
//   frame's colour, filtered vertex (rebuilt from the filtered depth), its
//   confidence at weighting 1.0 and the frame surfel's normal and radius
//   instead, so the resolve writes the filled maps directly.
// Composite mode (the multi-model step: `own` is the winner-model image of
//   the composite index map, `conf_all` the per-model confidence gates): a
//   tap counts only when its pixel's winner model equals this pixel's, and
//   its confidence gate is conf_all of that model instead of one threshold.
//   With a fill gate (the segmentation mask) the epilogue fills only the
//   global model's pixels (mask == 0), as the reference fills in the global
//   model's prediction alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Fill {
  const uint8_t* rgb;         // [H, W, 3] frame colour; nullptr: no fill-in
  const float* depth;         // [H, W] filtered depth
  const float* frame;         // [16, H*W] frame surfels (normals, radius)
  float inv_fx, inv_fy, cutoff;
  int passthrough;
  const int* gate;            // [H, W] mask: fill only where 0; nullptr: everywhere
};

struct Comp {
  const float* conf_all;  // [M] per-model confidence gate; nullptr: static mode
  const int* own;         // [H, W] winner model of each index-map pixel; nullptr with
                          // conf_all: one gate read by pointer (an object slot's)
  int M;
};

enum {
  PX = 0, PY = 1, PZ = 2, CONF = 3, CR = 4, CG = 5, CB = 6, INIT_T = 7, LAST_T = 8,
  NX = 9, NY = 10, NZ = 11, RADIUS = 12
};

__global__ void resolve(const int* __restrict__ index, const float* __restrict__ dl, int B,
                        int H, int W, float fx, float fy, float cx, float cy, float conf_t,
                        float time, float max_time, float time_delta, int window,
                        float* __restrict__ color, float* __restrict__ vertex_conf,
                        float* __restrict__ normal_rad, int* __restrict__ tmap,
                        uint8_t* __restrict__ valid, Fill f, Comp cm) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= H * W) return;
  int y = p / W, x = p % W;
  float lx = ((float)x - cx) / fx;
  float ly = ((float)y - cy) / fy;
  float lnorm = sqrtf(lx * lx + ly * ly + 1.0f);
  float l0 = lx / lnorm, l1 = ly / lnorm, l2 = 1.0f / lnorm;

  float best_z = 3.4e38f;
  int best = -1;
  float att[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int own_p = cm.own != nullptr ? cm.own[p] : 0;
  if (cm.conf_all != nullptr && cm.own == nullptr) conf_t = cm.conf_all[0];
  int r = window / 2;
  for (int dy = -r; dy < window - r; ++dy) {
    int yy = y + dy;
    if (yy < 0 || yy >= H) continue;
    for (int dx = -r; dx < window - r; ++dx) {
      int xx = x + dx;
      if (xx < 0 || xx >= W) continue;
      int c = index[yy * W + xx];
      if (c < 0) continue;
      float gate = conf_t;
      if (cm.own != nullptr) {
        int oq = cm.own[yy * W + xx];
        if (oq != own_p) continue;
        gate = cm.conf_all[oq];  // a tap with a surfel has a model < M
      }
      float conf = dl[CONF * B + c];
      float last = dl[LAST_T * B + c];
      if (!(conf >= gate && time - last <= time_delta && last <= max_time)) continue;
      float px = dl[PX * B + c], py = dl[PY * B + c], pz = dl[PZ * B + c];
      float nx = dl[NX * B + c], ny = dl[NY * B + c], nz = dl[NZ * B + c];
      float rad = dl[RADIUS * B + c];
      float ln = l0 * nx + l1 * ny + l2 * nz;
      float pn = px * nx + py * ny + pz * nz;
      float t = pn / (fabsf(ln) > 1e-12f ? ln : 1e-12f);
      float hx = t * l0, hy = t * l1, hz = t * l2;
      float ex = hx - px, ey = hy - py, ez = hz - pz;
      float d2 = ex * ex + ey * ey + ez * ez;
      if (d2 <= rad * rad && hz > 0.f && hz < best_z) {
        best_z = hz;
        best = c;
        att[0] = dl[CR * B + c];
        att[1] = dl[CG * B + c];
        att[2] = dl[CB * B + c];
        att[3] = conf;
        att[4] = nx;
        att[5] = ny;
        att[6] = nz;
        att[7] = rad;
        att[8] = dl[INIT_T * B + c];
      }
    }
  }
  bool ok = best >= 0;
  float zc = ok ? best_z : 0.f;
  tmap[p] = (int)att[8];
  valid[p] = ok ? 1 : 0;
  if (f.rgb != nullptr && (!ok || f.passthrough) && (f.gate == nullptr || f.gate[p] == 0)) {
    int N = H * W;
    float d = f.depth[p];
    bool vok = d > 0.f && d < f.cutoff;
    float z = vok ? d : 0.f;
    float ys = (float)y - cy, xs = (float)x - cx;
    float radial = sqrtf(ys * ys + xs * xs) / 400.0f;
    color[3 * p + 0] = (float)f.rgb[3 * p + 0];
    color[3 * p + 1] = (float)f.rgb[3 * p + 1];
    color[3 * p + 2] = (float)f.rgb[3 * p + 2];
    vertex_conf[4 * p + 0] = vok ? z * ((float)x - cx) * f.inv_fx : 0.f;
    vertex_conf[4 * p + 1] = vok ? z * ((float)y - cy) * f.inv_fy : 0.f;
    vertex_conf[4 * p + 2] = z;
    vertex_conf[4 * p + 3] = expf(-(radial * radial) / 0.72f) * 1.0f;
    normal_rad[4 * p + 0] = f.frame[NX * N + p];
    normal_rad[4 * p + 1] = f.frame[NY * N + p];
    normal_rad[4 * p + 2] = f.frame[NZ * N + p];
    normal_rad[4 * p + 3] = f.frame[RADIUS * N + p];
    return;
  }
  color[3 * p + 0] = att[0];
  color[3 * p + 1] = att[1];
  color[3 * p + 2] = att[2];
  vertex_conf[4 * p + 0] = lx * zc;
  vertex_conf[4 * p + 1] = ly * zc;
  vertex_conf[4 * p + 2] = zc;
  vertex_conf[4 * p + 3] = att[3];
  normal_rad[4 * p + 0] = att[4];
  normal_rad[4 * p + 1] = att[5];
  normal_rad[4 * p + 2] = att[6];
  normal_rad[4 * p + 3] = att[7];
}

}  // namespace

extern "C" int mmf_splat_resolve(const int* index, const float* data_local, int B, int H, int W,
                                 float fx, float fy, float cx, float cy, float conf_threshold,
                                 float time, float max_time, float time_delta, int window,
                                 float* color, float* vertex_conf, float* normal_rad, int* tmap,
                                 uint8_t* valid, const uint8_t* fill_rgb,
                                 const float* fill_depth, const float* fill_frame,
                                 float inv_fx, float inv_fy, float cutoff, int passthrough,
                                 const int* fill_gate, const float* conf_all, const int* own,
                                 int n_models, cudaStream_t stream) {
  Fill f{fill_rgb, fill_depth, fill_frame, inv_fx, inv_fy, cutoff, passthrough, fill_gate};
  Comp cm{conf_all, own, n_models};
  const int threads = 256;
  int npix = H * W;
  resolve<<<(npix + threads - 1) / threads, threads, 0, stream>>>(
      index, data_local, B, H, W, fx, fy, cx, cy, conf_threshold, time, max_time, time_delta,
      window, color, vertex_conf, normal_rad, tmap, valid, f, cm);
  return (int)cudaGetLastError();
}
