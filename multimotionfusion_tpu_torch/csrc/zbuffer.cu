// K6 zbuffer: the data-association index map of the static frame step, and
// K12 zbuffer_flat: the composite index map of the multi-model step.
//
// Replaces: multimotionfusion_tpu/ops/rasterize.py:142 predict_indices
//   (-> :126 _zmin_scatter, :103 _pack_depth_id, :114 _unpack_zmin); K12
//   :181 predict_indices_flat and :242 win_model_image.
// Bound on an H100: bytes. Each surfel is read once (16 channels) and its
//   camera-frame copy written once (data_local, which fuse, clean and the
//   splat resolve read); the index map is 1.2 MB. A few dozen flops per
//   surfel are far below the memory rate.
// Design: one thread per surfel transforms it by inv(pose), writes its
//   data_local column (coalesced: consecutive threads, consecutive surfels of
//   one channel row), applies the gates alive & 0 < z <= max_depth &
//   time - last_t <= time_delta, projects with round-half-even (rintf
//   semantics, as jnp.rint) and atomicMin's the packed key
//   (log-depth bin << id_bits) | id into an int32 [H*W] buffer prefilled with
//   INT_MAX. Integer min is order-independent, so the map is deterministic;
//   depth ties resolve to the lowest id. A second kernel unpacks keys to ids.
//   The transform is read by pointer (a [4, 4] tensor on the card), so the
//   pose never visits the host. The first frame's dedicated splat render
//   (rasterize.py:splat_predict) adds the splat.vert gates conf >= threshold
//   and last_t <= max_time (``gated``) instead of masking a copy of the map.
//   The max depth and the confidence gate may be read by pointer instead
//   (an object slot's, kept on the card: the legacy CRF's per-slot renders).
// K12 (the flat store of all models: the global bucket [0, bg), then slot k's
//   bucket [bg + k bo, bg + (k + 1) bo), model k + 1): the same one-thread-
//   per-surfel scatter, with the surfel's model from its flat id; it is
//   transformed by its model's inv(pose) ([M, 4, 4] on the card), gated by
//   its model's count and max depth, and its key is
//   (zq << (id_bits + 1)) | (is_global << id_bits) | id, object depths moved
//   2 cm nearer before the quantisation (1 << (30 - id_bits) bins), so an
//   object wins a near-tie against the global map. The unpack pass also
//   writes the winner's model (win_model_image, a range test on the id).
//   Integer keys and an integer min: the maps equal the plain version's.
// K13 render_depths (ops/rasterize.py:255 render_model_depths, with
//   engine_multi.py:81 _stride_cols and :952-982): every model's depth on the
//   CRF grid for the segmentation's reprojection term. One thread per
//   surfel of the strided store (every 2nd global column, every object
//   column; an object surfel's slot and position come from its original
//   index) reads its columns in place from the global map and the object
//   slots (no concatenated copy), transforms by its model's inv(pose),
//   applies the same gates as K12 (no confidence gate: the caller passes
//   zeros), projects with the CRF camera and atomicMin's (conf_miss << 21) |
//   log-depth bin (2^20 levels) into its model's plane of [M * Hc * Wc]; a
//   second pass decodes exp2(zq * 8 / 2^20 - 4), 0 where nothing landed.
//   Bound by bytes: ~5 of the 16 channels of ~590k surfels read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "surfel.cuh"

__global__ void scatter_keys(const float* __restrict__ data, int rs, int n,
                             const int* __restrict__ count, const float* __restrict__ Tm,
                             float fx, float fy, float cx, float cy, int W, int H, float time,
                             float time_delta, float max_depth, int gated, float conf_threshold,
                             float max_time, int id_bits, int* __restrict__ keys,
                             float* __restrict__ data_local, const float* __restrict__ max_depth_p,
                             const float* __restrict__ conf_p) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (max_depth_p != nullptr) max_depth = *max_depth_p;
  if (conf_p != nullptr) conf_threshold = *conf_p;
  float pl[3];
  write_local(data, rs, n, i, Tm, data_local, pl);
  float z = pl[2];
  bool ok = (i < *count) && (data[ALIVE * rs + i] > 0.f) && (z > 0.f) && (z <= max_depth) &&
            (time - data[LAST_T * rs + i] <= time_delta);
  if (gated)
    ok = ok && data[CONF * rs + i] >= conf_threshold && data[LAST_T * rs + i] <= max_time;
  int pix;
  if (!ok || !project(pl, fx, fy, cx, cy, W, H, &pix)) return;
  int zq = depth_bin(z, 1 << (31 - id_bits));
  atomicMin(&keys[pix], (zq << id_bits) | i);
}

__global__ void unpack_keys(const int* __restrict__ keys, int n, int id_bits,
                            int* __restrict__ index) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int k = keys[i];
  index[i] = (k != KEY_INVALID) ? (k & ((1 << id_bits) - 1)) : -1;
}

struct Flat {
  int bg, bo, slots;
};

__device__ inline int model_of(const Flat& F, int i) {
  return i < F.bg ? 0 : 1 + (i - F.bg) / F.bo;
}

__global__ void scatter_flat(const float* __restrict__ data, int rs, int n, Flat F,
                             const int* __restrict__ counts, const float* __restrict__ Tinv,
                             const float* __restrict__ maxd, float fx, float fy, float cx,
                             float cy, int W, int H, float time, float time_delta,
                             float z_priority, int id_bits, int* __restrict__ keys,
                             float* __restrict__ data_local) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int m = model_of(F, i);
  int pos = m == 0 ? i : (i - F.bg) % F.bo;
  float pl[3];
  write_local(data, rs, n, i, Tinv + 16 * m, data_local, pl);
  float z = pl[2];
  bool ok = (pos < counts[m]) && (data[ALIVE * rs + i] > 0.f) && (z > 0.f) && (z <= maxd[m]) &&
            (time - data[LAST_T * rs + i] <= time_delta);
  int pix;
  if (!ok || !project(pl, fx, fy, cx, cy, W, H, &pix)) return;
  int zq = depth_bin(m > 0 ? fmaxf(z - z_priority, 1e-3f) : z, 1 << (30 - id_bits));
  int prio = m == 0 ? 1 : 0;
  atomicMin(&keys[pix], (zq << (id_bits + 1)) | (prio << id_bits) | i);
}

__global__ void unpack_flat(const int* __restrict__ keys, int npix, int id_bits, Flat F,
                            int* __restrict__ index, int* __restrict__ win_model) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npix) return;
  int k = keys[i];
  bool won = k != KEY_INVALID;
  int id = won ? (k & ((1 << id_bits) - 1)) : -1;
  index[i] = id;
  win_model[i] = won ? model_of(F, id) : 1 + F.slots;
}

// K13: one thread per strided surfel of the global bucket (every gs-th
// column) and of the slot-major object buckets (every os-th column, slot and
// position from the original index); its model's inv(pose), the CRF camera,
// the gates, and the key (conf_miss << 21) | zq into its model's plane
__global__ void scatter_depths(const float* __restrict__ gdata, int grs, int bg, int gs,
                               const float* __restrict__ odata, int ors, long oss, int bo,
                               int slots, int os, const int* __restrict__ counts,
                               const float* __restrict__ Tinv, const float* __restrict__ maxd,
                               const float* __restrict__ conf, float fx, float fy, float cx,
                               float cy, int W, int H, float time, float time_delta,
                               int* __restrict__ keys) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int ng = (bg + gs - 1) / gs;
  int no = (slots * bo + os - 1) / os;
  if (j >= ng + no) return;
  const float* col;
  int rs, m, pos;
  if (j < ng) {
    pos = j * gs;
    m = 0;
    col = gdata + pos;
    rs = grs;
  } else {
    int oi = (j - ng) * os;
    int slot = oi / bo;
    pos = oi - slot * bo;
    m = slot + 1;
    col = odata + slot * oss + pos;
    rs = ors;
  }
  if (pos >= counts[m] || !(col[ALIVE * rs] > 0.f)) return;
  const float* T = Tinv + 16 * m;
  float p[3] = {col[PX * rs], col[PY * rs], col[PZ * rs]};
  float pl[3];
  for (int r = 0; r < 3; ++r)
    pl[r] = T[4 * r] * p[0] + T[4 * r + 1] * p[1] + T[4 * r + 2] * p[2] + T[4 * r + 3];
  float z = pl[2];
  if (!(z > 0.f) || !(z <= maxd[m]) || !(time - col[LAST_T * rs] <= time_delta)) return;
  int pix;
  if (!project(pl, fx, fy, cx, cy, W, H, &pix)) return;
  int miss = col[CONF * rs] < conf[m] ? 1 : 0;
  int zq = depth_bin(z, 1 << 20);
  atomicMin(&keys[m * W * H + pix], (miss << 21) | zq);
}

__global__ void decode_depths(const int* __restrict__ keys, int n, float* __restrict__ depth) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int k = keys[i];
  const int levels = 1 << 20;
  depth[i] = k != KEY_INVALID
                 ? exp2f((float)(k & (levels - 1)) * (8.0f / (float)levels) - 4.0f)
                 : 0.f;
}

}  // namespace

extern "C" int mmf_render_depths(const float* gdata, int grs, int bg, int gs, const float* odata,
                                 int ors, long oss, int bo, int slots, int os, const int* counts,
                                 const float* T_inv, const float* maxd, const float* conf,
                                 float fx, float fy, float cx, float cy, int W, int H, float time,
                                 float time_delta, int* keys, float* depth, cudaStream_t stream) {
  const int threads = 256;
  int n = (1 + slots) * W * H;
  int ns = (bg + gs - 1) / gs + (slots * bo + os - 1) / os;
  fill_int<<<(n + threads - 1) / threads, threads, 0, stream>>>(keys, n, KEY_INVALID);
  if (ns > 0)
    scatter_depths<<<(ns + threads - 1) / threads, threads, 0, stream>>>(
        gdata, grs, bg, gs, odata, ors, oss, bo, slots, os, counts, T_inv, maxd, conf, fx, fy,
        cx, cy, W, H, time, time_delta, keys);
  decode_depths<<<(n + threads - 1) / threads, threads, 0, stream>>>(keys, n, depth);
  return (int)cudaGetLastError();
}

extern "C" int mmf_zbuffer_flat(const float* data, int row_stride, int bg, int bo, int slots,
                                const int* counts, const float* T_inv, const float* maxd,
                                float fx, float fy, float cx, float cy, int W, int H, float time,
                                float time_delta, float z_priority, int id_bits, int* keys,
                                float* data_local, int* index, int* win_model,
                                cudaStream_t stream) {
  const int threads = 256;
  int npix = W * H;
  int n = bg + slots * bo;
  Flat F{bg, bo, slots};
  fill_int<<<(npix + threads - 1) / threads, threads, 0, stream>>>(keys, npix, KEY_INVALID);
  if (n > 0)
    scatter_flat<<<(n + threads - 1) / threads, threads, 0, stream>>>(
        data, row_stride, n, F, counts, T_inv, maxd, fx, fy, cx, cy, W, H, time, time_delta,
        z_priority, id_bits, keys, data_local);
  unpack_flat<<<(npix + threads - 1) / threads, threads, 0, stream>>>(keys, npix, id_bits, F,
                                                                      index, win_model);
  return (int)cudaGetLastError();
}

extern "C" int mmf_zbuffer(const float* data, int row_stride, int n, const int* count,
                           const float* T_inv, float fx, float fy, float cx, float cy, int W,
                           int H, float time, float time_delta, float max_depth, int gated,
                           float conf_threshold, float max_time, int id_bits, int* keys,
                           float* data_local, int* index, const float* max_depth_p,
                           const float* conf_p, cudaStream_t stream) {
  const int threads = 256;
  int npix = W * H;
  fill_int<<<(npix + threads - 1) / threads, threads, 0, stream>>>(keys, npix, KEY_INVALID);
  if (n > 0)
    scatter_keys<<<(n + threads - 1) / threads, threads, 0, stream>>>(
        data, row_stride, n, count, T_inv, fx, fy, cx, cy, W, H, time, time_delta, max_depth,
        gated, conf_threshold, max_time, id_bits, keys, data_local, max_depth_p, conf_p);
  unpack_keys<<<(npix + threads - 1) / threads, threads, 0, stream>>>(keys, npix, id_bits,
                                                                      index);
  return (int)cudaGetLastError();
}
