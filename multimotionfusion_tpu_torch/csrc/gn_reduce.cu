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
//   few MB per evaluation, i.e. microseconds, so the launches per call
//   and the host read of the result dominate.
// Design: every thread evaluates pixels of the (strided) grid: transform by
//   inv(result_Rt), project, fetch the four bilinear taps, apply the ICP gates
//   and the RGB gates (rgb_static_valid precomputed per level), and adds the
//   outer products of its rows to register accumulators: no [P, 7] row matrix
//   is written. Blocks reduce with warp shuffles and shared memory into
//   per-block partials ([blocks, 31] for pass 1, then [blocks, 28] for pass
//   2 from the next 16-byte boundary: both stay written after the call). The
//   block that draws a pass's last ticket sums the partials in block order
//   from 0.f (csrc/gn_sums.cuh, shared with K11), the order of the one-block
//   finalize kernel this replaced, so `sums` is bit-equal to it. No float
//   atomics, so results are the same run to run.
//   The RGB row weight 1 / (sigma_val + |diff|) needs this iteration's RGB
//   count (sigma_val = count * scale2 unless the error is 0), so the call
//   takes two passes: pass 1 reduces the ICP system, the ICP count, the RGB
//   count and sum(diff^2), and its last block writes them and zeros in every
//   other slot of `sums`; pass 2 reads the count from `sums` on the device
//   (no host round trip) and reduces the weighted RGB system. One evaluation
//   is 2 launches (1 without RGB). The ticket counters make two evaluations
//   on two streams at once unsafe: the port runs them on one stream.
// Output `sums` (64 floats): [0:28] upper triangle of S_icp, [28:56] of
//   S_rgb, [56] ICP count, [57] RGB count, [58] sum(diff^2), all on the
//   evaluated grid (the caller scales by stride^2).
// The pose increment inv(result_Rt) is read by pointer from the odometry's
//   state on the card (csrc/gn_step.cu), and every kernel returns at once
//   when the GN loop's done flag is set (block 0 of pass 1 then writes the
//   zeros of a finished loop's sums), so the host enqueues the fixed
//   iteration budget without reading anything back.
// Error-image mode (rgbd.py:1062-1075, the legacy CRF's input): one more
//   evaluation of level 0 on the full grid at the final pose, enqueued after
//   the loop with no host read; one thread per pixel writes the two [H, W]
//   images (the ICP distance of rgbd.py:450, 0.001 diff^2 of :532).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_pixel.cuh"
#include "gn_sums.cuh"

namespace {

// the passes' tickets (pass 1, pass 2): 0 between evaluations
__device__ unsigned g_ticket[2];

// block reduction of NV accumulators into this block's row of partials
// ([blocks, NV]): warp shuffles, then the warps' sums in warp order
template <int NV>
__device__ inline void block_reduce(float* acc, float (*sh)[SLOTS], float* partials) {
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
    partials[blockIdx.x * NV + threadIdx.x] = s;
  }
}

// the shared memory of a pass: the block reduction's scratch, then (in the
// last block only) the staging buffer of finish_sums
union __align__(16) PassShared {
  float sh[WARPS][SLOTS];
  float stage[STAGE];
};

// pass 1: ICP system + ICP count + RGB count + sum(diff^2)
__global__ void __launch_bounds__(THREADS)
pass1(Params P, const void* pred, const float* vmap, const float* nmap, const float* img,
      const float* didx, const float* didy, const uint8_t* sv, float* partials, float* sums) {
  if (is_done(P)) {  // sums of a finished loop are zeros
    if (blockIdx.x == 0)
      for (int e = threadIdx.x; e < SLOTS; e += THREADS) sums[e] = 0.f;
    return;
  }
  const Pose T = load_pose(P.Tinv);
  __shared__ PassShared smem;
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
    float row[7];
    if (P.use_icp && icp_row(P, T, px, row)) {
      add_outer(acc, row);
      acc[28] += 1.f;
    }
  }
  block_reduce<31>(acc, smem.sh, partials);
  if (last_block(&g_ticket[0])) finish_sums<31, 1, 1>(partials, 1, smem.stage, sums);
}

// pass 2: the weighted RGB system (needs pass 1's RGB count and sum(diff^2))
__global__ void __launch_bounds__(THREADS)
pass2(Params P, const void* pred, const float* vmap, const float* nmap, const float* img,
      const float* didx, const float* didy, const uint8_t* sv, float* partials, float* sums) {
  if (is_done(P)) return;
  const Pose T = load_pose(P.Tinv);
  __shared__ PassShared smem;
  float acc[28];
  for (int i = 0; i < 28; ++i) acc[i] = 0.f;
  float rgb_size = sums[57] * P.scale2;
  float tmp_err = sqrtf(sums[58] * P.scale2) / fmaxf(rgb_size, 1.f);
  float sigma_val = tmp_err == 0.f ? 1.f : rgb_size;
  int n = P.Hs * P.Ws;
  for (int q = blockIdx.x * THREADS + threadIdx.x; q < n; q += gridDim.x * THREADS) {
    Pixel px;
    eval_pixel(P, T, pred, vmap, nmap, img, didx, didy, sv, q, px);
    float row[7];
    if (rgb_row(P, px, sigma_val, row)) add_outer(acc, row);
  }
  block_reduce<28>(acc, smem.sh, partials);
  if (last_block(&g_ticket[1])) finish_sums<28, 2, 1>(partials, 1, smem.stage, sums);
}

// error-image mode: one thread per pixel of the full level-0 grid at the
// final pose; the ICP distance where the association is in bounds (0 where
// not finite) and 0.001 diff^2 where the photometric correspondence is valid
__global__ void __launch_bounds__(THREADS)
error_images(Params P, const void* pred, const float* vmap, const float* nmap, const float* img,
             const float* didx, const float* didy, const uint8_t* sv, float* icp_img,
             float* rgb_img) {
  int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= P.Hs * P.Ws) return;
  const Pose T = load_pose(P.Tinv);
  Pixel px;
  eval_pixel(P, T, pred, vmap, nmap, img, didx, didy, sv, q, px);
  float e_icp = 0.f, e_rgb = 0.f;
  if (P.use_icp) {
    bool in_bounds = px.d_ok && px.n_ok && px.vcp[2] > 0.f && px.v_valid;
    float dist = norm3(px.d[0] - px.vcp[0], px.d[1] - px.vcp[1], px.d[2] - px.vcp[2]);
    e_icp = in_bounds && isfinite(dist) ? dist : 0.f;
  }
  if (P.use_rgb) {
    float cp[3], diff;
    bool valid = rgb_corr(P, px, cp, &diff);
    e_rgb = valid ? 0.001f * diff * diff : 0.f;
  }
  icp_img[q] = e_icp;
  rgb_img[q] = e_rgb;
}

}  // namespace

extern "C" int mmf_gn_error_images(const void* pred, int compact, int H, int W, const float* vmap,
                                   const float* nmap, const float* img, const float* didx,
                                   const float* didy, const uint8_t* static_valid,
                                   const float* Tinv, float fx, float fy, float cx, float cy,
                                   int use_icp, int use_rgb, float dist_thresh,
                                   float angle_thresh, float max_dd, float max_depth_rgb,
                                   float* icp_img, float* rgb_img, cudaStream_t stream) {
  Params P;
  P.Tinv = Tinv;
  P.done = nullptr;
  P.fx = fx; P.fy = fy; P.cx = cx; P.cy = cy;
  P.H = H; P.W = W; P.stride = 1; P.Hs = H; P.Ws = W;
  P.compact = compact; P.use_icp = use_icp; P.use_rgb = use_rgb; P.rgb_only = 0;
  P.dist_thresh = dist_thresh; P.angle_thresh = angle_thresh; P.max_dd = max_dd;
  P.max_depth_rgb = max_depth_rgb; P.sobel_scale = 0.f; P.scale2 = 1.f;
  error_images<<<(H * W + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      P, pred, vmap, nmap, img, didx, didy, static_valid, icp_img, rgb_img);
  return (int)cudaGetLastError();
}

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
  // pass 2's partials start at the first 16-byte boundary after pass 1's
  float* partials2 = partials + ((blocks * 31 + 3) & ~3);
  pass1<<<blocks, THREADS, 0, stream>>>(P, pred, vmap, nmap, img, didx, didy, static_valid,
                                        partials, sums);
  if (use_rgb)
    pass2<<<blocks, THREADS, 0, stream>>>(P, pred, vmap, nmap, img, didx, didy, static_valid,
                                          partials2, sums);
  return (int)cudaGetLastError();
}
