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
//   CRF grid for the segmentation's reprojection term, from the live columns
//   of the strided store (every gs-th global column, every os-th column of
//   the slot-major object buckets, an object column's slot and position from
//   its flat index), read in place from the global map and the object slots
//   (no concatenated copy): its model's inv(pose), the gates of K12 (no
//   confidence gate: the caller passes zeros), the CRF camera, and the
//   atomicMin of (conf_miss << 21) | log-depth bin (2^20 levels) into its
//   model's plane of [M * Hc * Wc]; then every cell decoded to
//   exp2(zq * 8 / 2^20 - 4), 0 where nothing landed.
//   Bound by bytes: ~6 of the 16 channels of each live column read once and
//   the depth written once.
//   Design: two launches and no fill pass. The keys are a persistent scratch
//   of the caller's (rasterize.depth_scratch), KEY_INVALID between calls:
//   like last_block.cuh's tickets, it serves one stream at a time.
//   scatter_depths runs on a grid that fits the card (blocks an SM from the
//   occupancy API, times the SMs; no more than the capacities' columns
//   need). Each block lists each model's live columns from the counts on
//   the card (a warp's scan in shared memory, read with the poses and
//   gates), and the grid walks only those by grid stride, a column a
//   thread with every load issued first: columns past the counts cost no
//   block, and the main path's ~280k live columns take one trip. In each
//   warp, lanes whose keys land on one cell in a run (the fuse appends in
//   source-pixel order) take the run's minimum by shuffles and its first
//   lane issues the atomicMin: an integer min is exact in any order, so the
//   keys are the per-column atomics'. decode_depths then decodes every cell,
//   four a thread, and sets each key it read back to KEY_INVALID.
//   Measured against one cooperative launch with a grid barrier before the
//   decode, __match_any_sync grouping, no grouping and 2 or 4 columns a
//   thread: each slower (tests/torch_kernel_variants.py --only depths;
//   PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// K13: the models' live columns. Model 0 is the global bucket [0, bg) at
// stride gs; model m >= 1 is slot m - 1's positions [0, min(count, bo)) of
// the slot-major object range [0, slots * bo) strided by os from 0 (a slot's
// first column may lie past its base when os does not divide bo)
constexpr int RD_T = 256;       // threads a block
constexpr int RD_MAX_M = 32;    // models: the global map and 31 slots
constexpr unsigned RD_FULL = 0xffffffffu;

struct DepthArgs {
  const float* gdata;
  const float* odata;
  long oss;  // object slot stride (floats)
  const int* counts;
  const float* Tinv;
  const float* maxd;
  const float* conf;
  int grs, bg, gs, ors, bo, slots, os;
  float fx, fy, cx, cy;
  int W, H;
  float time, time_delta;
  int* keys;  // [M * H * W], KEY_INVALID on entry and on exit
  float* depth;
};

struct DepthShared {
  int start[RD_MAX_M + 1];  // each model's first live column (start[M]: the total)
  int first[RD_MAX_M];      // its first strided index
  float T[RD_MAX_M][12];    // the models' inv(pose), rows 0-2
  float maxd[RD_MAX_M], conf[RD_MAX_M];
};

// the block's copy of the models' live columns (warp 0: a scan of the
// counts), poses and gates (the other threads), read together
__device__ __forceinline__ void stage_models(const DepthArgs& a, DepthShared& S) {
  const int M = a.slots + 1;
  if (threadIdx.x < 32) {
    const int m = threadIdx.x;
    int live = 0, first = 0;
    if (m == 0) {
      live = (min(max(a.counts[0], 0), a.bg) + a.gs - 1) / a.gs;
    } else if (m < M) {
      const int base = (m - 1) * a.bo, c = min(max(a.counts[m], 0), a.bo);
      first = (base + a.os - 1) / a.os;
      live = (base + c + a.os - 1) / a.os - first;
    }
    int x = live;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(RD_FULL, x, off);
      if (m >= off) x += y;
    }
    S.start[m + 1] = x;
    S.first[m] = first;
    if (m == 0) S.start[0] = 0;
  }
  for (int e = threadIdx.x - 32; e >= 0 && e < M * 14; e += RD_T - 32) {
    const int m = e / 14, k = e - m * 14;
    if (k < 12) S.T[m][k] = a.Tinv[16 * m + k];
    else if (k == 12) S.maxd[m] = a.maxd[m];
    else S.conf[m] = a.conf[m];
  }
  __syncthreads();
}

// model m and column pointer of grid column t (< the total)
__device__ __forceinline__ const float* column_of(const DepthArgs& a, const DepthShared& S,
                                                  int t, int* model, int* rs) {
  int lo = 0, hi = a.slots;  // the last model whose first live column is <= t
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (S.start[mid] <= t) lo = mid;
    else hi = mid - 1;
  }
  const int m = lo, j = t - S.start[m];
  *model = m;
  if (m == 0) {
    *rs = a.grs;
    return a.gdata + (long)j * a.gs;
  }
  *rs = a.ors;
  return a.odata + (long)(m - 1) * a.oss + ((S.first[m] + j) * a.os - (m - 1) * a.bo);
}

// a live column a thread (its loads issued before any test), then, in each
// warp, the minimum of each run of lanes whose keys land on one cell (the
// fuse appends in source-pixel order, so neighbours share cells), one
// atomicMin a run: an integer min is exact in any order
__global__ void __launch_bounds__(RD_T) scatter_depths(DepthArgs a) {
  __shared__ DepthShared S;
  stage_models(a, S);
  const int total = S.start[a.slots + 1];
  const int lane = threadIdx.x & 31;
  for (int base = blockIdx.x * RD_T; base < total; base += gridDim.x * RD_T) {
    const int t = base + threadIdx.x;
    bool ok = false;
    int cell = 0, key = 0;
    if (t < total) {
      int m, rs;
      const float* col = column_of(a, S, t, &m, &rs);
      // every value used whatever the gates, so the six loads go out together
      const float alive = col[ALIVE * rs], px = col[PX * rs], py = col[PY * rs],
                  pz = col[PZ * rs], last_t = col[LAST_T * rs], cf = col[CONF * rs];
      const float* T = S.T[m];
      float pl[3];
      for (int r = 0; r < 3; ++r)
        pl[r] = T[4 * r] * px + T[4 * r + 1] * py + T[4 * r + 2] * pz + T[4 * r + 3];
      const float z = pl[2];
      const bool gates = alive > 0.f && z > 0.f && z <= S.maxd[m] &&
                         a.time - last_t <= a.time_delta;
      int pix = 0;
      ok = gates && project(pl, a.fx, a.fy, a.cx, a.cy, a.W, a.H, &pix);
      key = ((cf < S.conf[m] ? 1 : 0) << 21) | depth_bin(z, 1 << 20);
      cell = m * a.W * a.H + pix;
    }
    // runs of equal cells in consecutive lanes (a lane without a key is a run
    // of its own): each run's first lane takes the run's minimum
    const unsigned id = ok ? (unsigned)cell : 0x80000000u | lane;
    const unsigned prev = __shfl_up_sync(RD_FULL, id, 1);
    const unsigned heads = __ballot_sync(RD_FULL, lane == 0 || prev != id);
    const unsigned later = heads & ~((2u << lane) - 1u);  // heads above this lane
    const int next = later ? __ffs(later) - 1 : 32;       // the run's end
    int kmin = key;
    for (int off = 1; off < 32; off <<= 1) {
      const int k2 = __shfl_down_sync(RD_FULL, kmin, off);
      if (lane + off < next) kmin = min(kmin, k2);
    }
    if (ok && ((heads >> lane) & 1u)) atomicMin(&a.keys[cell], kmin);
  }
}

__device__ __forceinline__ float decode_depth(int k) {
  const int levels = 1 << 20;
  return k != KEY_INVALID
             ? exp2f((float)(k & (levels - 1)) * (8.0f / (float)levels) - 4.0f)
             : 0.f;
}

// every cell decoded, four a thread (the cells past the last four one a
// thread), and each key read set back to KEY_INVALID where a column landed
__global__ void __launch_bounds__(RD_T) decode_depths(DepthArgs a) {
  const int n = (a.slots + 1) * a.W * a.H, n4 = n >> 2;
  const int q = blockIdx.x * RD_T + threadIdx.x;
  if (q < n4) {
    int4* k4 = reinterpret_cast<int4*>(a.keys) + q;
    const int4 k = *k4;
    reinterpret_cast<float4*>(a.depth)[q] = make_float4(
        decode_depth(k.x), decode_depth(k.y), decode_depth(k.z), decode_depth(k.w));
    if ((k.x & k.y & k.z & k.w) != KEY_INVALID)
      *k4 = make_int4(KEY_INVALID, KEY_INVALID, KEY_INVALID, KEY_INVALID);
  } else if (q < n4 + (n & 3)) {
    const int i = 4 * n4 + (q - n4);
    const int k = a.keys[i];
    a.depth[i] = decode_depth(k);
    if (k != KEY_INVALID) a.keys[i] = KEY_INVALID;
  }
}

}  // namespace

// keys: [(1 + slots) * W * H] int32, KEY_INVALID, left so. Two launches:
// the scatter on a grid that fits the card (no more blocks than the
// capacities' columns need), then the decode
extern "C" int mmf_render_depths(const float* gdata, int grs, int bg, int gs, const float* odata,
                                 int ors, long oss, int bo, int slots, int os, const int* counts,
                                 const float* T_inv, const float* maxd, const float* conf,
                                 float fx, float fy, float cx, float cy, int W, int H, float time,
                                 float time_delta, int* keys, float* depth, cudaStream_t stream) {
  if (slots < 0 || slots + 1 > RD_MAX_M || gs < 1 || os < 1 || bg < 0 || bo < 0)
    return (int)cudaErrorInvalidValue;
  static int resident[64];  // per device: scatter blocks that fit the card at once
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scatter_depths, RD_T, 0);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    resident[dev] = per_sm * sms;
  }
  const long cols = (bg + gs - 1) / gs + ((long)slots * bo + os - 1) / os;
  const long need = (cols + RD_T - 1) / RD_T;
  const int grid = (int)std::max(1L, std::min((long)resident[dev], need));
  const long n = (long)(1 + slots) * W * H;
  const int decode_grid = (int)std::max(1L, ((n >> 2) + (n & 3) + RD_T - 1) / RD_T);
  DepthArgs a{gdata, odata, oss, counts, T_inv, maxd, conf, grs, bg, gs, ors, bo, slots, os,
              fx, fy, cx, cy, W, H, time, time_delta, keys, depth};
  scatter_depths<<<grid, RD_T, 0, stream>>>(a);
  decode_depths<<<decode_grid, RD_T, 0, stream>>>(a);
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
