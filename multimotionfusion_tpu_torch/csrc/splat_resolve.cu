// K10 splat_resolve: the 5x5 ray-disk resolve of the next frame's prediction.
//
// Replaces: multimotionfusion_tpu/ops/rasterize.py:366 splat_resolve
//   (pre_gated=False, the static frame step's call, and the composite mode of
//   the multi-model step, :419-471) and, as an epilogue, model/fillin.py:25
//   fill_in (with its `gate`).
// Bound on an H100: bytes. Per pixel: the index map (and, composite, the
//   winner-model image), one 13-channel gather of each distinct candidate
//   surfel in data_local and 49 bytes of output (colour, vertex+conf,
//   normal+radius, time, valid). data_local is [16, B] with B up to 2^19 +
//   5 * 2^16 rows on the multi-model path (54.5 MB, more than the L2).
// Design: one staged window a block. A 256-thread block owns a TW x TH
//   pixel tile (one thread a pixel) and stages the tile widened by the
//   window's halo (r = window / 2 before, window - r - 1 after, on both axes)
//   in shared memory. Each staged position's candidate is gathered ONCE, by
//   one thread (a thread's positions' loads issued together, so their
//   latencies overlap): its id (-1 where there is none or it fails the
//   per-candidate gates conf >= gate, time - last_t <= time_delta,
//   last_t <= max_time, the gate being conf_all of the position's model in
//   composite mode), its model, position, normal, radius, confidence and
//   p . n, packed so that a tap reads three words. A window of 25 taps a
//   pixel costs ~1.7 gathers a pixel (36 x 12 staged positions for 32 x 8
//   pixels). Then every pixel walks its window from shared memory in the
//   reference order (dy outer, dx inner) and keeps the candidate whose
//   ray-plane hit is strictly nearer (`<`, so ties resolve as in the
//   reference) among those that pass the disk test |hit - p|^2 <= r^2 and
//   hz > 0, with the same float expressions as the plain version (the
//   build's -fmad=false keeps each rounding); the depth tests come first, so
//   a farther hit skips the disk's arithmetic (the same conjunction). The
//   tap loop, not the gathers, bounds the kernel (each tap a ray-plane
//   division): the engine's 5x5 window is compiled as a fixed window with
//   the loop unrolled, any other window (up to MAX_WINDOW) as a run-time
//   one. The winner's colour and init time are read once, after the loop,
//   by its id. Stores: float4 for vertex+conf and normal+radius, the colour
//   through shared memory as whole rows.
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
//   model's prediction alone. Slot mode (the legacy step): conf_all without
//   `own`, one gate read by pointer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32, TH = 8;  // a block's pixel tile; a warp is one tile row
constexpr int THREADS = TW * TH;
constexpr int MAX_WINDOW = 7;   // the largest window the staging holds
constexpr int STAGED = (TW + MAX_WINDOW - 1) * (TH + MAX_WINDOW - 1);

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

// the staged window of one block: per position its gated candidate (-1:
// none) with its model, and the candidate's channels, packed so that a tap
// reads three words: (id, model), (p, p . n), (n, radius)
struct Stage {
  float4 pp[STAGED];  // px, py, pz, p . n
  float4 nr[STAGED];  // nx, ny, nz, radius
  int2 key[STAGED];   // id (-1: none), model
  float conf[STAGED];
  float color[THREADS * 3];
};

// WINDOW > 0: the window fixed at compile time (the engine's footprint, the
// tap loop unrolled); 0: the `window` argument
template <int WINDOW>
__global__ void __launch_bounds__(THREADS)
resolve(const int* __restrict__ index, const float* __restrict__ dl, int B, int H, int W,
        float fx, float fy, float cx, float cy, float conf_t, float time, float max_time,
        float time_delta, int window_arg, float* __restrict__ color,
        float* __restrict__ vertex_conf, float* __restrict__ normal_rad,
        int* __restrict__ tmap, uint8_t* __restrict__ valid, Fill f, Comp cm) {
  __shared__ Stage st;
  const int window = WINDOW > 0 ? WINDOW : window_arg;
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int r = window / 2;
  const int sw = TW + window - 1, sh = TH + window - 1;
  if (cm.conf_all != nullptr && cm.own == nullptr) conf_t = cm.conf_all[0];

  // stage: one gather of each position's candidate; a thread's positions'
  // loads are issued together, so their latencies overlap
  constexpr int ROUNDS = (STAGED + THREADS - 1) / THREADS;
  int c[ROUNDS], oq[ROUNDS];
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) {
    const int s = threadIdx.x + k * THREADS;
    const int yy = y0 - r + s / sw, xx = x0 - r + s % sw;
    c[k] = -1;
    oq[k] = -1;
    if (s < sw * sh && yy >= 0 && yy < H && xx >= 0 && xx < W) {
      c[k] = index[yy * W + xx];
      if (cm.own != nullptr) oq[k] = cm.own[yy * W + xx];
    }
  }
  float conf[ROUNDS], last[ROUNDS], gate[ROUNDS];
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) {
    if (c[k] >= 0) {
      gate[k] = conf_t;
      if (cm.own != nullptr) gate[k] = oq[k] >= 0 && oq[k] < cm.M ? cm.conf_all[oq[k]] : 0.f;
      conf[k] = dl[CONF * B + c[k]];
      last[k] = dl[LAST_T * B + c[k]];
    }
  }
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) {
    const int s = threadIdx.x + k * THREADS;
    int ck = c[k];
    if (ck >= 0) {
      if (conf[k] >= gate[k] && time - last[k] <= time_delta && last[k] <= max_time) {
        const float px = dl[PX * B + ck], py = dl[PY * B + ck], pz = dl[PZ * B + ck];
        const float nx = dl[NX * B + ck], ny = dl[NY * B + ck], nz = dl[NZ * B + ck];
        st.pp[s] = make_float4(px, py, pz, px * nx + py * ny + pz * nz);
        st.nr[s] = make_float4(nx, ny, nz, dl[RADIUS * B + ck]);
        st.conf[s] = conf[k];
      } else {
        ck = -1;
      }
    }
    if (s < sw * sh) st.key[s] = make_int2(ck, oq[k]);
  }
  __syncthreads();

  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;
  const int p = y * W + x;
  float col[3] = {0.f, 0.f, 0.f};
  float4 vc, nr = make_float4(0.f, 0.f, 0.f, 0.f);
  if (inside) {
    const float lx = ((float)x - cx) / fx;
    const float ly = ((float)y - cy) / fy;
    const float lnorm = sqrtf(lx * lx + ly * ly + 1.0f);
    const float l0 = lx / lnorm, l1 = ly / lnorm, l2 = 1.0f / lnorm;
    const int own_p = st.key[(ty + r) * sw + tx + r].y;
    float best_z = 3.4e38f;
    int best = -1;  // the winner's staged position
#pragma unroll
    for (int dy = 0; dy < window; ++dy) {
#pragma unroll
      for (int dx = 0; dx < window; ++dx) {
        const int s = (ty + dy) * sw + tx + dx;
        const int2 key = st.key[s];
        if (key.x < 0) continue;
        if (cm.own != nullptr && key.y != own_p) continue;
        const float4 pp = st.pp[s], nw = st.nr[s];
        const float ln = l0 * nw.x + l1 * nw.y + l2 * nw.z;
        const float t = pp.w / (fabsf(ln) > 1e-12f ? ln : 1e-12f);
        const float hz = t * l2;
        // the depth tests first: the disk's arithmetic only for a nearer hit
        if (!(hz > 0.f && hz < best_z)) continue;
        const float hx = t * l0, hy = t * l1;
        const float ex = hx - pp.x, ey = hy - pp.y, ez = hz - pp.z;
        const float d2 = ex * ex + ey * ey + ez * ez;
        if (d2 <= nw.w * nw.w) {
          best_z = hz;
          best = s;
        }
      }
    }
    const bool ok = best >= 0;
    const float zc = ok ? best_z : 0.f;  // lx * 0 keeps lx's sign, as the reference's
    int init_t = 0;
    vc = make_float4(lx * zc, ly * zc, zc, 0.f);
    if (ok) {
      const int c = st.key[best].x;
      col[0] = dl[CR * B + c];
      col[1] = dl[CG * B + c];
      col[2] = dl[CB * B + c];
      init_t = (int)dl[INIT_T * B + c];
      vc.w = st.conf[best];
      nr = st.nr[best];
    }
    tmap[p] = init_t;
    valid[p] = ok ? 1 : 0;
    if (f.rgb != nullptr && (!ok || f.passthrough) && (f.gate == nullptr || f.gate[p] == 0)) {
      const int N = H * W;
      const float d = f.depth[p];
      const bool vok = d > 0.f && d < f.cutoff;
      const float z = vok ? d : 0.f;
      const float ys = (float)y - cy, xs = (float)x - cx;
      const float radial = sqrtf(ys * ys + xs * xs) / 400.0f;
      col[0] = (float)f.rgb[3 * p + 0];
      col[1] = (float)f.rgb[3 * p + 1];
      col[2] = (float)f.rgb[3 * p + 2];
      vc = make_float4(vok ? z * ((float)x - cx) * f.inv_fx : 0.f,
                       vok ? z * ((float)y - cy) * f.inv_fy : 0.f, z,
                       expf(-(radial * radial) / 0.72f) * 1.0f);
      nr = make_float4(f.frame[NX * N + p], f.frame[NY * N + p], f.frame[NZ * N + p],
                       f.frame[RADIUS * N + p]);
    }
    reinterpret_cast<float4*>(vertex_conf)[p] = vc;
    reinterpret_cast<float4*>(normal_rad)[p] = nr;
  }
  // the colour: the warp's row of 32 pixels as 96 consecutive floats
  float* row = st.color + ty * 3 * TW;
  row[3 * tx + 0] = col[0];
  row[3 * tx + 1] = col[1];
  row[3 * tx + 2] = col[2];
  __syncwarp();
  if (y < H) {
    const int n = 3 * min(TW, W - x0);
    float* out = color + 3 * ((size_t)y * W + x0);
    for (int k = tx; k < n; k += TW) out[k] = row[k];
  }
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
  if (window < 1 || window > MAX_WINDOW || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Fill f{fill_rgb, fill_depth, fill_frame, inv_fx, inv_fy, cutoff, passthrough, fill_gate};
  Comp cm{conf_all, own, n_models};
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  auto kernel = window == 5 ? resolve<5> : resolve<0>;
  kernel<<<grid, THREADS, 0, stream>>>(index, data_local, B, H, W, fx, fy, cx, cy,
                                       conf_threshold, time, max_time, time_delta, window, color,
                                       vertex_conf, normal_rad, tmap, valid, f, cm);
  return (int)cudaGetLastError();
}
