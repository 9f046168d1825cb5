// K6 zbuffer: the data-association index map of the static frame step.
//
// Replaces: multimotionfusion_tpu/ops/rasterize.py:142 predict_indices
//   (-> :126 _zmin_scatter, :103 _pack_depth_id, :114 _unpack_zmin).
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KEY_INVALID = 0x7fffffff;
constexpr int CH = 16;
enum { PX = 0, PY = 1, PZ = 2, CONF = 3, LAST_T = 8, NX = 9, NY = 10, NZ = 11, ALIVE = 13 };

struct Pose {
  float r[9];
  float t[3];
};

__global__ void fill_keys(int* __restrict__ keys, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = KEY_INVALID;
}

__global__ void scatter_keys(const float* __restrict__ data, int rs, int n,
                             const int* __restrict__ count, const float* __restrict__ Tm,
                             float fx, float fy, float cx, float cy, int W, int H, float time,
                             float time_delta, float max_depth, int gated, float conf_threshold,
                             float max_time, int id_bits, int* __restrict__ keys,
                             float* __restrict__ data_local) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pose T;
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) T.r[3 * r + c] = Tm[4 * r + c];
    T.t[r] = Tm[4 * r + 3];
  }
  float p[3] = {data[PX * rs + i], data[PY * rs + i], data[PZ * rs + i]};
  float nv[3] = {data[NX * rs + i], data[NY * rs + i], data[NZ * rs + i]};
  float pl[3], nl[3];
  for (int r = 0; r < 3; ++r) {
    pl[r] = T.r[3 * r] * p[0] + T.r[3 * r + 1] * p[1] + T.r[3 * r + 2] * p[2] + T.t[r];
    nl[r] = T.r[3 * r] * nv[0] + T.r[3 * r + 1] * nv[1] + T.r[3 * r + 2] * nv[2];
  }
  for (int c = 0; c < CH; ++c) {
    float v = data[c * rs + i];
    if (c <= PZ) v = pl[c];
    if (c >= NX && c <= NZ) v = nl[c - NX];
    data_local[c * n + i] = v;
  }
  float z = pl[2];
  bool ok = (i < *count) && (data[ALIVE * rs + i] > 0.f) && (z > 0.f) && (z <= max_depth) &&
            (time - data[LAST_T * rs + i] <= time_delta);
  if (gated)
    ok = ok && data[CONF * rs + i] >= conf_threshold && data[LAST_T * rs + i] <= max_time;
  if (!ok) return;
  // z > 0 here, so the reference's safe_z is z itself; __float2int_rn is
  // round-half-even and saturates far outside the image
  int u = __float2int_rn(pl[0] * fx / z + cx);
  int v = __float2int_rn(pl[1] * fy / z + cy);
  if (u < 0 || v < 0 || u >= W || v >= H) return;
  int levels = 1 << (31 - id_bits);
  float zqf = (log2f(fmaxf(z, 1e-6f)) + 4.0f) * ((float)levels / 8.0f);
  int zq = __float2int_rz(zqf);
  zq = min(max(zq, 0), levels - 2);
  atomicMin(&keys[v * W + u], (zq << id_bits) | i);
}

__global__ void unpack_keys(const int* __restrict__ keys, int n, int id_bits,
                            int* __restrict__ index) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int k = keys[i];
  index[i] = (k != KEY_INVALID) ? (k & ((1 << id_bits) - 1)) : -1;
}

}  // namespace

extern "C" int mmf_zbuffer(const float* data, int row_stride, int n, const int* count,
                           const float* T_inv, float fx, float fy, float cx, float cy, int W,
                           int H, float time, float time_delta, float max_depth, int gated,
                           float conf_threshold, float max_time, int id_bits, int* keys,
                           float* data_local, int* index, cudaStream_t stream) {
  const int threads = 256;
  int npix = W * H;
  fill_keys<<<(npix + threads - 1) / threads, threads, 0, stream>>>(keys, npix);
  if (n > 0)
    scatter_keys<<<(n + threads - 1) / threads, threads, 0, stream>>>(
        data, row_stride, n, count, T_inv, fx, fy, cx, cy, W, H, time, time_delta, max_depth,
        gated, conf_threshold, max_time, id_bits, keys, data_local);
  unpack_keys<<<(npix + threads - 1) / threads, threads, 0, stream>>>(keys, npix, id_bits,
                                                                      index);
  return (int)cudaGetLastError();
}
