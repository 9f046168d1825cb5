// K11 gn_multi: the composite multi-model odometry's per-level owner maps and
// one evaluation of every model's ICP and photometric 7x7 systems.
//
// Replaces: multimotionfusion_tpu/odometry/multi.py:157
//   multi_incremental_transformation: its owner erosion and pyramid (:188-223),
//   :125 rgb_static_valid_multi, and the eval_systems body (:298-378) with
//   :66 _per_owner_transform, :98 _seg_systems, :116 _seg_sums and the
//   owner-gated banks and samplers of odometry/rgbd.py:269-397 (own_map,
//   own_gated, own_row, _own_tap_ok).
// Bound on an H100: bytes and launch latency, as K4 (csrc/gn_reduce.cu): a few
//   MB per evaluation (76,800 pixels at levels 0 and 1, 19,200 at level 2,
//   each reading ~46 bytes of frame fields and owners and four taps), so
//   microseconds of traffic against the launches of the loop.
// Design:
//   - owner_prep, one thread per pixel of a level: the row owner is the
//     mask's nearest pyramid (pixel (y << l, x << l) of the full-resolution
//     mask); the tap owner is the prediction's winner model, demoted to "no
//     owner" (M) at a GLOBAL-owned pixel whose diamond of radius 2 (the
//     reference's two 4-neighbour max/min sweeps with jnp.roll, i.e. WRAPPING
//     around the image borders, reproduced as is) holds another owner, then
//     the same nearest pyramid; the photometric validity requires every
//     in-bounds tap of the 4x4 window (offsets -2..+1) to be intensity-valid
//     and owned by the centre's owner, the gradient gate, valid depth and the
//     right/bottom borders.
//   - gn_multi, one thread per pixel of the (strided) grid: the pixel is
//     warped by ITS OWNER's inv(result_Rt), read by pointer from the loop
//     state (row stride `tstride`; 0 makes every model read one pose, the
//     SO(3) pose of the seed arbitration); its four taps must all belong to
//     that owner; the ICP and RGB rows are gn_reduce's (csrc/gn_pixel.cuh).
//     Each block reduces its rows per model (warp shuffles over the lanes of
//     one model, only for the models present in the warp: a lane of another
//     model adds +0 to the same tree) into per-block partials
//     [blocks, M, NV], the slots in use only. No float atomics: results are
//     the same run to run. As in gn_reduce, pass 2 reads each owner's RGB
//     count and sum(diff^2) from pass 1's sums on the card for the row
//     weight 1 / (sigma_val + |diff|).
//   - the last block finalises (csrc/gn_sums.cuh, shared with K4): every
//     block makes its partials visible (__threadfence) and draws a ticket
//     from a counter of the library's own (one per pass; the last block sets
//     it back to 0). The block that draws the last ticket stages the
//     partials through shared memory (16-byte loads, a chunk's all in
//     flight), and each of its threads adds its slot's values in block
//     order from 0.f: the order of the separate one-block finalize
//     kernel this replaces, so `sums` is bit-equal to it (no partial is -0
//     and no sum starts at -0, so skipping the +0 of a model absent from a
//     warp changes no bit). Pass 1's last block writes every slot of `sums`
//     (zeros where neither pass has a value), which replaces the memset;
//     when the loop is done every block returns and block 0 of pass 1
//     writes the zeros. One evaluation is 2 launches (1 without RGB). The
//     counters make two evaluations on two streams at once unsafe: the
//     engine runs them on one stream.
//   - every kernel returns at once when the level loop's done flag (the
//     state's last row) is set: every model has stopped.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_pixel.cuh"
#include "gn_sums.cuh"

namespace {

constexpr int MAXM = 8;

// the passes' tickets (pass 1, pass 2): 0 between evaluations
__device__ unsigned g_ticket[2];

// ---------------------------------------------------------------- owner prep

__global__ void owner_prep(int lvl, const int* __restrict__ mask, const int* __restrict__ pred_own,
                           int H0, int W0, int h, int w, int M, const float* __restrict__ img,
                           const float* __restrict__ didx, const float* __restrict__ didy,
                           const float* __restrict__ depth, float min_scale,
                           int* __restrict__ own_out, int* __restrict__ bank_out,
                           uint8_t* __restrict__ sv_out) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= h * w) return;
  int y = p / w, x = p % w;
  int Y = y << lvl, X = x << lvl;
  int own = mask[Y * W0 + X];
  own_out[p] = own;

  // the 2-px band, wrapping around the borders
  int o0 = pred_own[Y * W0 + X];
  bool differs = false;
  for (int dy = -2; dy <= 2; ++dy)
    for (int dx = -2; dx <= 2; ++dx) {
      if (abs(dy) + abs(dx) > 2) continue;
      int yy = (Y + dy + H0) % H0, xx = (X + dx + W0) % W0;
      differs = differs || pred_own[yy * W0 + xx] != o0;
    }
  bank_out[p] = (o0 == 0 && differs) ? M : o0;

  // owner-aware static photometric validity
  bool ok = img[p] > 0.f && own < M;
  bool all = true;
  for (int oy = -2; oy <= 1; ++oy)
    for (int ox = -2; ox <= 1; ++ox) {
      int yy = y + oy, xx = x + ox;
      if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
      int q = yy * w + xx;
      int t_own = mask[(yy << lvl) * W0 + (xx << lvl)];
      bool t_ok = img[q] > 0.f && t_own < M;
      all = all && t_ok && t_own == own;
    }
  bool valid = all && x < w - 5 && y < h - 1;
  valid = valid && (didx[p] * didx[p] + didy[p] * didy[p] >= min_scale) && depth[p] > 0.f && ok;
  sv_out[p] = valid ? 1 : 0;
}

// ---------------------------------------------------------------- reduction

struct Multi {
  const float* Tinv;  // [M] rows of the loop state, inv(result_Rt) at offset 0
  int tstride;        // floats between two models' poses (0: one shared pose)
  int M;
  const int* own;       // [H, W] row owner
  const int* bank_own;  // [H, W] tap owner
};

// the pixel of grid index q, sampled at its owner's increment with owner-gated
// taps; returns its owner (M where it has none or q is past the grid)
__device__ inline int eval_owned(const Params& P, const Multi& A, const void* pred,
                                 const float* vmap, const float* nmap, const float* img,
                                 const float* didx, const float* didy, const uint8_t* sv, int q,
                                 Pixel& px, Pose& T) {
  if (q >= P.Hs * P.Ws) return A.M;
  int p = (q / P.Ws) * P.stride * P.W + (q % P.Ws) * P.stride;
  int o = A.own[p];
  if (o < 0 || o >= A.M) return A.M;
  T = load_pose(A.Tinv + o * A.tstride);
  eval_pixel(P, T, pred, vmap, nmap, img, didx, didy, sv, q, px);
  int c = px.v0c * P.W + px.u0c;
  bool own_ok = A.bank_own[c] == o && A.bank_own[c + 1] == o && A.bank_own[c + P.W] == o &&
                A.bank_own[c + P.W + 1] == o;
  px.d_ok = px.d_ok && own_ok;
  px.n_ok = px.n_ok && own_ok;
  px.dl_ok = px.dl_ok && own_ok;
  px.il_ok = px.il_ok && own_ok;
  return o;
}

// per-model block reduction of NV accumulators into partials[block][m][i]
// (M x NV floats a block); a warp reduces only the models its lanes hold
template <int NV>
__device__ __forceinline__ void block_reduce_models(const float* acc, int owner, int M,
                                                    float (*sh)[MAXM][32], unsigned* present,
                                                    float* partials) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned todo = __ballot_sync(0xffffffffu, owner < M);
  unsigned models = 0u;
  while (todo) {
    const int m = __shfl_sync(0xffffffffu, owner, __ffs(todo) - 1);
    const bool mine = owner == m;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float v = mine ? acc[i] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) sh[warp][m][i] = v;
    }
    models |= 1u << m;
    todo &= ~__ballot_sync(0xffffffffu, mine);
  }
  if (lane == 0) present[warp] = models;
  __syncthreads();
  const int MN = M * NV;
  for (int t = threadIdx.x; t < MN; t += THREADS) {
    const int m = t / NV, i = t % NV;
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp)
      if (present[wp] >> m & 1u) s += sh[wp][m][i];
    partials[blockIdx.x * MN + t] = s;
  }
}

// the shared memory of a pass: the block reduction's scratch, then (in the
// last block only) the staging buffer of finish_sums
union __align__(16) PassShared {
  float sh[WARPS][MAXM][32];
  float stage[STAGE];
};

// pass 1: per model the ICP system, ICP count, RGB count and sum(diff^2)
__global__ void __launch_bounds__(THREADS)
pass1(Params P, Multi A, const void* pred, const float* vmap, const float* nmap, const float* img,
      const float* didx, const float* didy, const uint8_t* sv, float* partials, float* sums) {
  if (is_done(P)) {  // sums of a finished loop are zeros
    if (blockIdx.x == 0)
      for (int e = threadIdx.x; e < MAXM * SLOTS; e += THREADS) sums[e] = 0.f;
    return;
  }
  __shared__ PassShared smem;
  __shared__ unsigned present[WARPS];
  float acc[31];
#pragma unroll
  for (int i = 0; i < 31; ++i) acc[i] = 0.f;
  Pixel px;
  Pose T;
  int o = eval_owned(P, A, pred, vmap, nmap, img, didx, didy, sv,
                     blockIdx.x * THREADS + threadIdx.x, px, T);
  if (o < A.M) {
    if (P.use_rgb) {
      float cp[3], diff;
      bool valid = rgb_corr(P, px, cp, &diff);
      acc[29] = valid ? 1.f : 0.f;
      acc[30] = diff * diff;
    }
    float row[7];
    if (icp_row(P, T, px, row)) {
      add_outer(acc, row);
      acc[28] = 1.f;
    }
  }
  block_reduce_models<31>(acc, o, A.M, smem.sh, present, partials);
  if (last_block(&g_ticket[0])) finish_sums<31, 1, MAXM>(partials, A.M, smem.stage, sums);
}

// pass 2: per model the weighted RGB system (each owner's count from pass 1)
__global__ void __launch_bounds__(THREADS)
pass2(Params P, Multi A, const void* pred, const float* vmap, const float* nmap, const float* img,
      const float* didx, const float* didy, const uint8_t* sv, float* partials, float* sums) {
  if (is_done(P)) return;
  __shared__ PassShared smem;
  __shared__ unsigned present[WARPS];
  float acc[28];
#pragma unroll
  for (int i = 0; i < 28; ++i) acc[i] = 0.f;
  Pixel px;
  Pose T;
  int o = eval_owned(P, A, pred, vmap, nmap, img, didx, didy, sv,
                     blockIdx.x * THREADS + threadIdx.x, px, T);
  if (o < A.M) {
    float rgb_size = sums[o * SLOTS + 57] * P.scale2;
    float tmp_err = sqrtf(sums[o * SLOTS + 58] * P.scale2) / fmaxf(rgb_size, 1.f);
    float sigma_val = tmp_err == 0.f ? 1.f : rgb_size;
    float row[7];
    if (rgb_row(P, px, sigma_val, row)) add_outer(acc, row);
  }
  block_reduce_models<28>(acc, o, A.M, smem.sh, present, partials);
  if (last_block(&g_ticket[1])) finish_sums<28, 2, MAXM>(partials, A.M, smem.stage, sums);
}

}  // namespace

extern "C" int mmf_owner_prep(int lvl, const int* mask, const int* pred_own, int H0, int W0,
                              int h, int w, int M, const float* img, const float* didx,
                              const float* didy, const float* depth, float min_scale, int* own,
                              int* bank_own, uint8_t* sv, cudaStream_t stream) {
  owner_prep<<<(h * w + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      lvl, mask, pred_own, H0, W0, h, w, M, img, didx, didy, depth, min_scale, own, bank_own, sv);
  return (int)cudaGetLastError();
}

extern "C" int mmf_gn_multi(const void* pred, int compact, int H, int W, const float* vmap,
                            const float* nmap, const float* img, const float* didx,
                            const float* didy, const uint8_t* static_valid, const int* own,
                            const int* bank_own, int stride, int Hs, int Ws, const float* Tinv,
                            int tstride, const float* done, float fx, float fy, float cx,
                            float cy, int M, int use_rgb, float dist_thresh, float angle_thresh,
                            float max_dd, float max_depth_rgb, float sobel_scale, float scale2,
                            int blocks, float* partials, float* sums, cudaStream_t stream) {
  if (M < 1 || M > MAXM) return (int)cudaErrorInvalidValue;
  Params P;
  P.Tinv = Tinv;
  P.done = done;
  P.fx = fx; P.fy = fy; P.cx = cx; P.cy = cy;
  P.H = H; P.W = W; P.stride = stride; P.Hs = Hs; P.Ws = Ws;
  P.compact = compact; P.use_icp = 1; P.use_rgb = use_rgb; P.rgb_only = 0;
  P.dist_thresh = dist_thresh; P.angle_thresh = angle_thresh; P.max_dd = max_dd;
  P.max_depth_rgb = max_depth_rgb; P.sobel_scale = sobel_scale; P.scale2 = scale2;
  Multi A{Tinv, tstride, M, own, bank_own};
  pass1<<<blocks, THREADS, 0, stream>>>(P, A, pred, vmap, nmap, img, didx, didy, static_valid,
                                        partials, sums);
  if (use_rgb)
    pass2<<<blocks, THREADS, 0, stream>>>(P, A, pred, vmap, nmap, img, didx, didy, static_valid,
                                          partials, sums);
  return (int)cudaGetLastError();
}
