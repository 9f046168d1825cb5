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
//   - owner_prep, ONE launch for every level (at most 3): the row owner is
//     the mask's nearest pyramid (pixel (y << l, x << l) of the
//     full-resolution mask); the tap owner is the prediction's winner model,
//     demoted to "no owner" (M) at a GLOBAL-owned pixel whose diamond of
//     radius 2 (the reference's two 4-neighbour max/min sweeps with
//     jnp.roll, i.e. WRAPPING around the image borders, reproduced as is)
//     holds another owner, then the same nearest pyramid; the photometric
//     validity requires every in-bounds tap of the 4x4 window (offsets
//     -2..+1) to be intensity-valid and owned by the centre's owner, the
//     gradient gate, valid depth and the right/bottom borders. The grid is
//     split by level, the coarser first, a block a 32x8 tile, one thread a
//     pixel. A level-0 block stages in shared memory the prediction
//     owners its diamonds read (the tile widened by 2, rows and columns
//     taken modulo the image: the wrap, exact; a division only at a tile
//     on the border); it writes every level's tap owner and the
//     coarser levels' row owners at its pixels that are (y << l, x << l),
//     as the reference erodes at full resolution and samples. Every block
//     stages its level's mask samples and their keys (the owner where the
//     tap's intensity is > 0 and the owner < M, else M) on its tile widened
//     by 2 before and 1 after, and writes its level's validity. Each pixel
//     reads its taps from shared memory, the diamond only at a global-owned
//     pixel and the window only where the cheaper tests hold. Gradients and
//     depth are loaded before the staging, and a thread's staging loads are
//     all issued before its first shared store. Level sizes are the mask's
//     halved rounding up, as the plain version's strided samples; level 0's
//     row owners are the mask itself (the plain version's stride-1 sample
//     is a view of it): not written. Integer logic and the plain version's
//     one float expression: the outputs are exact.
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

// One launch builds every level's maps. A block of OT threads owns an
// OTW x OTH tile of one level's pixels, one thread a pixel; the coarser
// levels' blocks come first in the grid. Level 0's blocks also write the
// coarser levels' owners and eroded owners: the reference erodes at full
// resolution and samples (y << l, x << l), which is a level-0 pixel.
constexpr int OWN_LEVELS = 3;
constexpr int OTW = 32, OTH = 8, OT = OTW * OTH;
constexpr int DIAMOND = 2;  // the erosion's radius at full resolution
// the prediction owners a level-0 tile's diamonds read: the tile widened by
// DIAMOND on each side (rows and columns wrap around)
constexpr int PRED_W = OTW + 2 * DIAMOND, PRED_H = OTH + 2 * DIAMOND;
constexpr int PRED_STAGED = PRED_W * PRED_H;
// the validity window's taps: WB before a pixel and WA after it, each way
constexpr int WB = 2, WA = 1;
constexpr int WIN_W = OTW + WB + WA, WIN_H = OTH + WB + WA, WIN_STAGED = WIN_W * WIN_H;

struct OwnLevel {
  const float* img;
  const float* didx;
  const float* didy;
  const float* depth;
  int* own;   // [h, w]; null at level 0, whose owners are the mask
  int* bank;  // [h, w]
  uint8_t* sv;
  int h, w, tiles_x, block0, block_end;  // h = w = 0: no such level
  float min_scale;
};

struct OwnArgs {
  const int* mask;
  const int* pred_own;
  int H0, W0, M;
  OwnLevel L[OWN_LEVELS];
};

// v modulo n in [0, n), as jnp.roll wraps
__device__ __forceinline__ int wrap(int v, int n) {
  if (v < 0 || v >= n) v = (v % n + n) % n;
  return v;
}

// the eroded prediction owner of level-0 pixel (y, x) and its owner, also as
// level l's pixel (y >> l, x >> l) where y and x are multiples of 2^l
__device__ __forceinline__ void write_owners(const OwnArgs& a, int y, int x, int p, int own,
                                             int bank) {
  a.L[0].bank[p] = bank;
#pragma unroll
  for (int l = 1; l < OWN_LEVELS; ++l) {
    const OwnLevel& C = a.L[l];
    if (C.w > 0 && ((y | x) & ((1 << l) - 1)) == 0) {
      const int q = (y >> l) * C.w + (x >> l);
      C.own[q] = own;
      C.bank[q] = bank;
    }
  }
}

template <int LVL>
__device__ __forceinline__ void owner_tile(const OwnArgs& a, const OwnLevel& L, int tile,
                                           int* s_pred, int* s_own, int* s_key) {
  const int tx = threadIdx.x % OTW, ty = threadIdx.x / OTW;
  const int x0 = (tile % L.tiles_x) * OTW, y0 = (tile / L.tiles_x) * OTH;
  const int x = x0 + tx, y = y0 + ty;
  const bool in = x < L.w && y < L.h;
  const int p = y * L.w + x;
  float gx = 0.f, gy = 0.f, d = 0.f;  // the pixel's own fields, loaded before the staging
  if (in) {
    gx = L.didx[p];
    gy = L.didy[p];
    d = L.depth[p];
  }
  // 1. (level 0) the prediction owners of the tile's diamonds, wrapped; a
  //    thread's loads all issued before its first shared store
  constexpr int NP = (PRED_STAGED + OT - 1) / OT;
  int po[NP];
  if constexpr (LVL == 0) {
    const int Y0 = y0 - DIAMOND, X0 = x0 - DIAMOND;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int i = threadIdx.x + k * OT;
      const int r = i / PRED_W, c = i - r * PRED_W;
      if (i < PRED_STAGED) po[k] = a.pred_own[wrap(Y0 + r, a.H0) * a.W0 + wrap(X0 + c, a.W0)];
    }
  }
  // 2. the level's owner samples and their keys (the owner where the tap is
  //    intensity-valid and owned, else M) on the tile widened by the window
  constexpr int NW = (WIN_STAGED + OT - 1) / OT;
  int wo[NW];
  float wi[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const int i = threadIdx.x + k * OT;
    const int r = i / WIN_W, c = i - r * WIN_W;
    const int yy = y0 - WB + r, xx = x0 - WB + c;
    wo[k] = a.M;
    wi[k] = 0.f;
    if (i < WIN_STAGED && yy >= 0 && yy < L.h && xx >= 0 && xx < L.w) {
      wo[k] = a.mask[(yy << LVL) * a.W0 + (xx << LVL)];
      wi[k] = L.img[yy * L.w + xx];
    }
  }
  if constexpr (LVL == 0) {
#pragma unroll
    for (int k = 0; k < NP; ++k)
      if (threadIdx.x + k * OT < PRED_STAGED) s_pred[threadIdx.x + k * OT] = po[k];
  }
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const int i = threadIdx.x + k * OT;
    if (i < WIN_STAGED) {
      s_own[i] = wo[k];
      s_key[i] = wi[k] > 0.f && wo[k] < a.M ? wo[k] : a.M;
    }
  }
  __syncthreads();
  if (!in) return;

  const int cw = (ty + WB) * WIN_W + tx + WB;
  const int own = s_own[cw];
  if constexpr (LVL == 0) {
    // the 2-px band: the diamond of radius 2 around (y, x), read only at a
    // global-owned pixel (no other is demoted)
    const int cp = (ty + DIAMOND) * PRED_W + tx + DIAMOND;
    const int o0 = s_pred[cp];
    bool differs = false;
    if (o0 == 0) {
#pragma unroll
      for (int dy = -DIAMOND; dy <= DIAMOND; ++dy)
#pragma unroll
        for (int dx = -DIAMOND; dx <= DIAMOND; ++dx)
          if (abs(dy) + abs(dx) <= DIAMOND)
            differs = differs || s_pred[cp + dy * PRED_W + dx] != o0;
    }
    write_owners(a, y, x, p, own, (o0 == 0 && differs) ? a.M : o0);
  }
  // owner-aware static photometric validity: an owner, the right/bottom
  // borders, the gradient gate and valid depth, then (only where those hold)
  // every in-bounds window tap's key equal to the centre's owner (below M:
  // the key of a tap that is not intensity-valid or not owned is M)
  bool valid = own < a.M && x < L.w - 5 && y < L.h - 1;
  valid = valid && (gx * gx + gy * gy >= L.min_scale) && d > 0.f;
  if (valid) {
#pragma unroll
    for (int oy = -WB; oy <= WA; ++oy)
#pragma unroll
      for (int ox = -WB; ox <= WA; ++ox) {
        const int yy = y + oy, xx = x + ox;
        if (yy < 0 || yy >= L.h || xx < 0 || xx >= L.w) continue;
        valid = valid && s_key[cw + oy * WIN_W + ox] == own;
      }
  }
  L.sv[p] = valid ? 1 : 0;
}

__global__ void __launch_bounds__(OT) owner_prep(OwnArgs a) {
  __shared__ int s_pred[PRED_STAGED];
  __shared__ int s_own[WIN_STAGED], s_key[WIN_STAGED];
  const int b = blockIdx.x;
  if (b < a.L[2].block_end)
    owner_tile<2>(a, a.L[2], b - a.L[2].block0, s_pred, s_own, s_key);
  else if (b < a.L[1].block_end)
    owner_tile<1>(a, a.L[1], b - a.L[1].block0, s_pred, s_own, s_key);
  else
    owner_tile<0>(a, a.L[0], b - a.L[0].block0, s_pred, s_own, s_key);
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

extern "C" int mmf_owner_prep(const int* mask, const int* pred_own, int H0, int W0, int M,
                              int levels, const float* img0, const float* didx0,
                              const float* didy0, const float* depth0, float min_scale0,
                              const float* img1, const float* didx1, const float* didy1,
                              const float* depth1, float min_scale1, const float* img2,
                              const float* didx2, const float* didy2, const float* depth2,
                              float min_scale2, int* own_bank, uint8_t* sv, cudaStream_t stream) {
  if (levels < 1 || levels > OWN_LEVELS || H0 < 1 || W0 < 1) return (int)cudaErrorInvalidValue;
  const float* maps[OWN_LEVELS][4] = {{img0, didx0, didy0, depth0},
                                      {img1, didx1, didy1, depth1},
                                      {img2, didx2, didy2, depth2}};
  const float min_scale[OWN_LEVELS] = {min_scale0, min_scale1, min_scale2};
  // level l is the mask's size halved l times rounding up; the outputs lie
  // level after level: own_bank = [bank of every level, own of levels >= 1]
  // (level 0's owners are the mask itself: not written)
  int h[OWN_LEVELS], w[OWN_LEVELS];
  size_t off[OWN_LEVELS], n = 0;
  for (int l = 0; l < levels; ++l) {
    h[l] = ((H0 - 1) >> l) + 1;
    w[l] = ((W0 - 1) >> l) + 1;
    off[l] = n;
    n += (size_t)h[l] * w[l];
  }
  OwnArgs a{mask, pred_own, H0, W0, M, {}};
  int blocks = 0;
  for (int l = OWN_LEVELS - 1; l >= 0; --l) {  // the coarsest level's blocks first
    OwnLevel& L = a.L[l];
    L = OwnLevel{};
    L.block0 = L.block_end = blocks;
    if (l >= levels) continue;
    L.img = maps[l][0];
    L.didx = maps[l][1];
    L.didy = maps[l][2];
    L.depth = maps[l][3];
    L.own = l == 0 ? nullptr : own_bank + n + off[l] - off[1];
    L.bank = own_bank + off[l];
    L.sv = sv + off[l];
    L.h = h[l];
    L.w = w[l];
    L.tiles_x = (w[l] + OTW - 1) / OTW;
    L.min_scale = min_scale[l];
    blocks += L.tiles_x * ((h[l] + OTH - 1) / OTH);
    L.block_end = blocks;
  }
  owner_prep<<<blocks, OT, 0, stream>>>(a);
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
