// K22 ferns: the fern keyframe database of relocalisation and loop closure.
//
// Replaces: multimotionfusion_tpu/model/ferns.py:107 downsample_frame (with
//   ops/maps.py:42 create_vmap and :62 create_nmap at the sampled pixels),
//   :116 encode, :131 block_hd, the argmax and keyframe fetch of :180
//   find_frame, :142 add_frame, and find_frame's photometric check
//   (:225-244).
// Bound on an H100: latency. The fern-scale frame is 80x60 (4,800 pixels),
//   the code table [K = 500, F = 500] bytes (250 KB) and one keyframe 211 KB;
//   every launch is a few microseconds of work, so the launch count is the
//   cost, and the design keeps it at five launches a frame and no host read.
// Design:
//   1. fern_frame: one thread per fern-scale pixel samples the full-frame
//      colour and filtered depth at (f/2 + f y, f/2 + f x), rebuilds the
//      vertex and its cross-product normal from the pixel and its right and
//      lower full-resolution neighbours exactly as K1 does, and writes the
//      ÷f colour, vertices, normals and depth.
//   2. encode_hd: one block per keyframe encodes the query codes into shared
//      memory (the reference's order: (z*1000) truncated to int32 against the
//      truncated depth threshold, 255 where z <= 0), counts equal valid codes
//      (integers, so the order does not matter) and writes
//      count / max(#valid query codes, 1), -1 at and after `count`; block 0
//      writes the codes. A one-block pass takes the first argmax (the lower
//      index on equal similarities, as jnp.argmax) and, when asked, copies
//      that keyframe's colour, vertices, normals and pose out for the
//      alignment.
//   3. insert: every block reads `count`, the best similarity and the skip
//      flag on the card and decides the insertion itself, then copies codes,
//      pose, time and the fern-scale frame into slot `count`; a one-thread
//      pass bumps `count` and writes the decision.
//   4. photo: one block projects the keyframe's vertices with T_rel,
//      bilinear-samples the live intensity and sums |diff| over the in-bounds
//      pixels in one fixed order (each thread its strided pixels in order, a
//      shuffle-down tree per warp, the warp sums in order), then applies
//      find_frame's five gates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ARGMAX_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint8_t BAD = 255;

struct Cam {
  float fx, fy, cx, cy, inv_fx, inv_fy;
};

// create_vmap at one pixel: valid iff 0 < d < cutoff (as csrc/frame_maps.cu)
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

__global__ void fern_frame(const float* __restrict__ depth, const uint8_t* __restrict__ rgb, int H,
                           int W, int f, int h, int w, Cam c, float cutoff,
                           uint8_t* __restrict__ rgb_s, float* __restrict__ vmap_s,
                           float* __restrict__ nmap_s, float* __restrict__ depth_s) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= h * w) return;
  int y = p / w, x = p % w;
  int Y = f / 2 + f * y, X = f / 2 + f * x;
  float v00[3], v01[3], v10[3], n[3];
  vertex(c, depth[Y * W + X], X, Y, cutoff, v00);
  if (X + 1 < W) vertex(c, depth[Y * W + X + 1], X + 1, Y, cutoff, v01);
  else v01[0] = v01[1] = v01[2] = 0.f;
  if (Y + 1 < H) vertex(c, depth[(Y + 1) * W + X], X, Y + 1, cutoff, v10);
  else v10[0] = v10[1] = v10[2] = 0.f;
  normal(v00, v01, v10, n);
  for (int k = 0; k < 3; ++k) {
    rgb_s[p * 3 + k] = rgb[(Y * W + X) * 3 + k];
    vmap_s[p * 3 + k] = v00[k];
    nmap_s[p * 3 + k] = n[k];
  }
  depth_s[p] = v00[2];
}

__device__ inline uint8_t fern_code(const int* pos, const float* thr, const uint8_t* rgb_s,
                                    const float* vmap_s, int w, int i) {
  int p = pos[2 * i + 1] * w + pos[2 * i];
  float r = (float)rgb_s[p * 3], g = (float)rgb_s[p * 3 + 1], b = (float)rgb_s[p * 3 + 2];
  float z = vmap_s[p * 3 + 2];
  int zmm = (int)(z * 1000.f);
  uint8_t code = (uint8_t)(((r > thr[4 * i]) ? 8 : 0) | ((g > thr[4 * i + 1]) ? 4 : 0) |
                           ((b > thr[4 * i + 2]) ? 2 : 0) | ((zmm > (int)thr[4 * i + 3]) ? 1 : 0));
  return z > 0.f ? code : BAD;
}

__device__ inline int block_sum_int(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int s = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) s += red[k];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(THREADS)
encode_hd(const int* __restrict__ pos, const float* __restrict__ thr, int F,
          const uint8_t* __restrict__ rgb_s, const float* __restrict__ vmap_s, int w,
          const uint8_t* __restrict__ db, const int* __restrict__ count, int K,
          uint8_t* __restrict__ codes_out, float* __restrict__ sim) {
  extern __shared__ uint8_t codes[];
  __shared__ int red[WARPS];
  const int k = blockIdx.x;
  const bool in_db = k < K && k < *count;
  if (k > 0 && !in_db) {
    if (k < K && threadIdx.x == 0) sim[k] = -1.f;
    return;
  }
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    codes[i] = fern_code(pos, thr, rgb_s, vmap_s, w, i);
    if (k == 0) codes_out[i] = codes[i];
  }
  __syncthreads();
  if (!in_db) {
    if (k < K && threadIdx.x == 0) sim[k] = -1.f;
    return;
  }
  int eq = 0, good = 0;
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    uint8_t q = codes[i];
    uint8_t d = db[(size_t)k * F + i];
    good += q != BAD;
    eq += (q != BAD && d != BAD && q == d);
  }
  eq = block_sum_int(eq, red);
  good = block_sum_int(good, red);
  if (threadIdx.x == 0) sim[k] = (float)eq / fmaxf((float)good, 1.f);
}

// the first argmax of sim[0..K), then (optionally) that keyframe copied out
__global__ void __launch_bounds__(ARGMAX_THREADS)
argmax_fetch(const float* __restrict__ sim, int K, int* __restrict__ best,
             float* __restrict__ best_sim, const float* __restrict__ db_rgb,
             const float* __restrict__ db_vmap, const float* __restrict__ db_nmap,
             const float* __restrict__ db_poses, int hw, float* __restrict__ kf_color,
             float* __restrict__ kf_vc, float* __restrict__ kf_nr, float* __restrict__ kf_pose) {
  __shared__ float sv[ARGMAX_THREADS];
  __shared__ int si[ARGMAX_THREADS];
  float bv = 0.f;
  int bi = -1;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    float v = sim[i];
    if (bi < 0 || v > bv) { bv = v; bi = i; }
  }
  sv[threadIdx.x] = bv;
  si[threadIdx.x] = bi;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if ((int)threadIdx.x < half) {
      float ov = sv[threadIdx.x + half];
      int oi = si[threadIdx.x + half];
      int mi = si[threadIdx.x];
      if (oi >= 0 && (mi < 0 || ov > sv[threadIdx.x] || (ov == sv[threadIdx.x] && oi < mi))) {
        sv[threadIdx.x] = ov;
        si[threadIdx.x] = oi;
      }
    }
    __syncthreads();
  }
  const int b = si[0];
  if (threadIdx.x == 0) {
    *best = b;
    *best_sim = sv[0];
  }
  if (kf_color == nullptr) return;
  const size_t base = (size_t)b * hw * 3;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    for (int c = 0; c < 3; ++c) {
      kf_color[p * 3 + c] = db_rgb[base + p * 3 + c];
      kf_vc[p * 4 + c] = db_vmap[base + p * 3 + c];
      kf_nr[p * 4 + c] = db_nmap[base + p * 3 + c];
    }
    kf_vc[p * 4 + 3] = 0.f;
    kf_nr[p * 4 + 3] = 0.f;
  }
  if (threadIdx.x < 16) kf_pose[threadIdx.x] = db_poses[(size_t)b * 16 + threadIdx.x];
}

__device__ inline bool decide(const int* count, const float* best_sim, const uint8_t* skip,
                              int capacity, float threshold) {
  const int c = *count;
  const float dissim = 1.f - fmaxf(*best_sim, 0.f);
  const bool ins = (c == 0 || dissim > threshold) && c < capacity;
  return ins && !(skip != nullptr && *skip);
}

__global__ void insert_copy(const int* __restrict__ count, const float* __restrict__ best_sim,
                            const uint8_t* __restrict__ skip, int capacity, float threshold,
                            const uint8_t* __restrict__ codes, int F,
                            const float* __restrict__ pose, int time,
                            const uint8_t* __restrict__ rgb_s, const float* __restrict__ vmap_s,
                            const float* __restrict__ nmap_s, int hw,
                            uint8_t* __restrict__ db_codes, float* __restrict__ db_poses,
                            int* __restrict__ db_time, float* __restrict__ db_rgb,
                            float* __restrict__ db_vmap, float* __restrict__ db_nmap) {
  if (!decide(count, best_sim, skip, capacity, threshold)) return;
  const size_t slot = (size_t)*count;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 3 * hw) {
    db_rgb[slot * 3 * hw + i] = (float)rgb_s[i];
    db_vmap[slot * 3 * hw + i] = vmap_s[i];
    db_nmap[slot * 3 * hw + i] = nmap_s[i];
  }
  if (i < F) db_codes[slot * F + i] = codes[i];
  if (i < 16) db_poses[slot * 16 + i] = pose[i];
  if (i == 0) db_time[slot] = time;
}

__global__ void insert_count(int* __restrict__ count, const float* __restrict__ best_sim,
                             const uint8_t* __restrict__ skip, int capacity, float threshold,
                             uint8_t* __restrict__ inserted) {
  const bool ins = decide(count, best_sim, skip, capacity, threshold);
  *inserted = ins;
  *count += ins ? 1 : 0;
}

__device__ inline float intensity(float r, float g, float b) {
  return floorf(r * 0.114f + g * 0.299f + b * 0.587f);
}

__device__ inline float live_i(const uint8_t* rgb, int w, int y, int x) {
  const uint8_t* q = rgb + (y * w + x) * 3;
  return intensity((float)q[0], (float)q[1], (float)q[2]);
}

__global__ void __launch_bounds__(THREADS)
photo(const float* __restrict__ T, const float* __restrict__ kf_vc,
      const float* __restrict__ kf_color, const uint8_t* __restrict__ live, int h, int w, Cam c,
      const int* __restrict__ count, const float* __restrict__ best_sim,
      const float* __restrict__ icp_err, const float* __restrict__ icp_count, float min_sim,
      float max_icp, float min_count, float photo_thresh, float* __restrict__ photo_out,
      bool* __restrict__ ok_out) {
  __shared__ float red[WARPS];
  __shared__ int ired[WARPS];
  float acc = 0.f;
  int n = 0;
  for (int p = threadIdx.x; p < h * w; p += blockDim.x) {
    const float vx = kf_vc[p * 4], vy = kf_vc[p * 4 + 1], vz = kf_vc[p * 4 + 2];
    const float px = T[0] * vx + T[1] * vy + T[2] * vz + T[3];
    const float py = T[4] * vx + T[5] * vy + T[6] * vz + T[7];
    const float pz = T[8] * vx + T[9] * vy + T[10] * vz + T[11];
    const float z = fmaxf(pz, 1e-6f);
    const float u = px * c.fx / z + c.cx;
    const float v = py * c.fy / z + c.cy;
    const bool inb = u >= 0.f && v >= 0.f && u < (float)(w - 1) && v < (float)(h - 1) && vz > 0.f;
    if (!inb) continue;
    const float x = fminf(fmaxf(u, 0.f), (float)(w - 1));
    const float y = fminf(fmaxf(v, 0.f), (float)(h - 1));
    const int x0 = (int)floorf(x), y0 = (int)floorf(y);
    const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
    const float fx = x - (float)x0, fy = y - (float)y0;
    const float samp = live_i(live, w, y0, x0) * (1.f - fx) * (1.f - fy) +
                       live_i(live, w, y0, x1) * fx * (1.f - fy) +
                       live_i(live, w, y1, x0) * (1.f - fx) * fy + live_i(live, w, y1, x1) * fx * fy;
    const float kfi = intensity(kf_color[p * 3], kf_color[p * 3 + 1], kf_color[p * 3 + 2]);
    acc = acc + fabsf(samp - kfi);
    n += 1;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    acc = acc + __shfl_down_sync(FULL, acc, off);
    n += __shfl_down_sync(FULL, n, off);
  }
  if (lane == 0) {
    red[warp] = acc;
    ired[warp] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    int cnt = 0;
    for (int k = 0; k < WARPS; ++k) {
      s = s + red[k];
      cnt += ired[k];
    }
    const float err = s / fmaxf((float)cnt, 1.f);
    *photo_out = err;
    *ok_out = *count > 0 && *best_sim > min_sim && *icp_err < max_icp && *icp_count > min_count &&
              err < photo_thresh;
  }
}

}  // namespace

extern "C" int mmf_fern_frame(const float* depth, const uint8_t* rgb, int H, int W, int f, int h,
                              int w, float fx, float fy, float cx, float cy, float inv_fx,
                              float inv_fy, float cutoff, uint8_t* rgb_s, float* vmap_s,
                              float* nmap_s, float* depth_s, cudaStream_t stream) {
  if (h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  Cam c{fx, fy, cx, cy, inv_fx, inv_fy};
  fern_frame<<<(h * w + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      depth, rgb, H, W, f, h, w, c, cutoff, rgb_s, vmap_s, nmap_s, depth_s);
  return (int)cudaGetLastError();
}

extern "C" int mmf_fern_encode_hd(const int* pos, const float* thr, int F, const uint8_t* rgb_s,
                                  const float* vmap_s, int w, const uint8_t* db,
                                  const int* count, int K, uint8_t* codes_out, float* sim,
                                  int* best, float* best_sim, const float* db_rgb,
                                  const float* db_vmap, const float* db_nmap,
                                  const float* db_poses, int hw, float* kf_color, float* kf_vc,
                                  float* kf_nr, float* kf_pose, cudaStream_t stream) {
  if (K < 1 || F < 1 || F > 48 * 1024) return (int)cudaErrorInvalidValue;
  encode_hd<<<K, THREADS, F, stream>>>(pos, thr, F, rgb_s, vmap_s, w, db, count, K, codes_out,
                                       sim);
  argmax_fetch<<<1, ARGMAX_THREADS, 0, stream>>>(sim, K, best, best_sim, db_rgb, db_vmap,
                                                 db_nmap, db_poses, hw, kf_color, kf_vc, kf_nr,
                                                 kf_pose);
  return (int)cudaGetLastError();
}

extern "C" int mmf_fern_insert(int* count, const float* best_sim, const uint8_t* skip,
                               int capacity, float threshold, const uint8_t* codes, int F,
                               const float* pose, int time, const uint8_t* rgb_s,
                               const float* vmap_s, const float* nmap_s, int hw,
                               uint8_t* db_codes, float* db_poses, int* db_time, float* db_rgb,
                               float* db_vmap, float* db_nmap, uint8_t* inserted,
                               cudaStream_t stream) {
  int n = 3 * hw > F ? 3 * hw : F;
  if (n < 16) n = 16;
  insert_copy<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      count, best_sim, skip, capacity, threshold, codes, F, pose, time, rgb_s, vmap_s, nmap_s, hw,
      db_codes, db_poses, db_time, db_rgb, db_vmap, db_nmap);
  insert_count<<<1, 1, 0, stream>>>(count, best_sim, skip, capacity, threshold, inserted);
  return (int)cudaGetLastError();
}

extern "C" int mmf_fern_photo(const float* T, const float* kf_vc, const float* kf_color,
                              const uint8_t* live, int h, int w, float fx, float fy, float cx,
                              float cy, const int* count, const float* best_sim,
                              const float* icp_err, const float* icp_count, float min_sim,
                              float max_icp, float min_count, float photo_thresh,
                              float* photo_out, bool* ok_out, cudaStream_t stream) {
  Cam c{fx, fy, cx, cy, 0.f, 0.f};
  photo<<<1, THREADS, 0, stream>>>(T, kf_vc, kf_color, live, h, w, c, count, best_sim, icp_err,
                                   icp_count, min_sim, max_icp, min_count, photo_thresh,
                                   photo_out, ok_out);
  return (int)cudaGetLastError();
}
