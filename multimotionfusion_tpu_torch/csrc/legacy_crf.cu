// K24c legacy_crf: the dense superpixel CRF of the legacy CoFusion segmentation.
//
// Replaces: multimotionfusion_tpu/segmentation/legacy_crf.py:104-141 (the
//   depth range, the confidence gates, the unaries with the new-model class
//   and their clamps, the 6-D features) and :53 _superpixel_crf (two exact
//   [S, S] Gaussian kernels without self-messages, symmetric normalisation,
//   Potts mean field) with :141's first-index argmax.
// Bound on an H100: bytes. At S = 1,200 superpixels the two kernel matrices
//   are 2 x 5.76 MB; the plan writes them once (about 15 flops an entry, one
//   exp) and every mean-field step reads them once (2 x 1,200^2 x L
//   multiply-adds for L <= 7 labels: ~20 MFLOP, far below the float32 rate).
//   The 11.5 MB sit in the 50 MB L2 between steps.
// Design:
//   - the plan is two launches and no one-block stage. The first computes
//     both row sums of every row (eight rows a block, so each block reads
//     every superpixel's feature once for eight rows: 150 blocks at S =
//     1,200 instead of one a row, whose 28.8 KB of features a block made
//     34 MB of L2 reads; each row's lanes stride over the row from 0 in j
//     order, then a fixed tree) into 1 / sqrt(max(sum, 1e-12)), the
//     matrices not stored; ceil(S / 256) more blocks of the same launch each
//     reduce the depth range themselves (min and max are exact in any
//     order) and write their superpixels' gated unaries (the reference's
//     nan_to_num and clamps), Q0 = softmax(-unary) and features. The second
//     recomputes every entry (the same expressions, so the same floats: exp
//     of -0.5 the squared distance, minus the identity) and writes it scaled
//     by both rows' factors, k * d_i * d_j in that order. The rows form each
//     feature from the superpixel means with the features' own expressions,
//     so they do not wait for the unary blocks;
//   - the mean field is one cooperative launch for all steps: a grid that
//     fits the card at once, the rows spread evenly over the SMs (ceil(S /
//     SMs) rows a block: 120 blocks of 10 rows at S = 1,200 on 132 SMs;
//     passes of rows by grid stride past that), a grid barrier between
//     steps. A row's labels go four to a warp (two warps a row at the
//     engine's L = 7), so an SM runs 20 warps, not 10: a warp's sums are a
//     chain of shared-memory loads, and one or two rows a warp left each
//     step waiting on them (ten steps on an H100: 0.166 ms at two rows a
//     warp, 0.116 at one, 0.095 at two warps a row).
//     The warps' messages meet in shared memory and one thread a row
//     finishes it. The block copies its rows of both kernels into shared
//     memory once (96 KB a block at S = 1,200) and reads them from there at
//     every step; each step it stages the previous step's Q in shared
//     memory (rows padded to an odd stride, so a warp's 32 rows fall in 32
//     banks). Each row's sums are the one-step kernel's: lane j strides over
//     the row by 32 from 0, then the fixed shuffle tree, then 40 * Ks q + 40
//     * Ka q per label, the Potts term from their sum in label order and the
//     softmax; the last step also writes the first-index argmax. Step t
//     writes its Q into its own slice of the [steps, S, L] history, so a
//     step never overwrites what another block may still read. Where Q does
//     not fit the shared memory it is read from the L2 instead, and where
//     the rows do not, from the L2 too (the same arithmetic);
//   - iterate, one step a launch, stays for the checks.
// No float atomics: the results are the same run to run, and each equals the
// three-launch plan's and the one-launch-a-step mean field's to the bit. The
// products are this function's own, written here; a library GEMM appears
// only as a yardstick. A 16-block cluster (as K15) would have to pull the
// 11.5 MB a step through 16 SMs' share of an H100's L2 bandwidth (about 17
// us a step): the whole card's grid does it instead. One stream at a time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAXL = 16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PLAN_ROWS = 8;  // the plan's rows a block: each feature read once for 8 rows
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t STAGE_MAX = 100 << 10;  // Q staged in shared memory up to this many bytes
constexpr int STAGE_BATCH = 8;  // a thread's loads in flight while Q is staged
constexpr int ROW_BATCH = 8;    // a lane's terms loaded together
constexpr int FIELD_MAX_THREADS = 1024;  // the mean field's widest block
constexpr size_t FIELD_MAX_SMEM = 200 << 10;  // Q, messages and kernel rows staged up to this
constexpr int FIELD_LG = 4;  // the mean field's labels a warp

__device__ inline float f_inf() { return __int_as_float(0x7f800000); }

// jnp.nan_to_num(x, posinf=1e5) then min(., 1e5) then max(., 1e-5)
__device__ inline float clamp_unary(float x) {
  if (x != x) x = 0.f;
  else if (x == f_inf()) x = 1e5f;
  else if (x == -f_inf()) x = -3.4028234663852886e38f;
  x = fminf(x, 1e5f);
  return fmaxf(x, 1e-5f);
}

// softmax of the L values x (max-shifted), in place
__device__ inline void softmax(float* x, int L) {
  float mx = x[0];
  for (int l = 1; l < L; ++l) mx = fmaxf(mx, x[l]);
  float sum = 0.f;
  for (int l = 0; l < L; ++l) {
    x[l] = expf(x[l] - mx);
    sum = sum + x[l];
  }
  for (int l = 0; l < L; ++l) x[l] = x[l] / sum;
}

struct Means {
  const float* lows;  // [1 + 2M, S]: depth, M ICP errors, M confidences
  const float* mean_color;
  const float* mean_xy;
  int S;
};

// superpixel s's 6-D feature (x, y, r, g, b, depth)
__device__ inline void feature(const Means& a, int s, float* f) {
  f[0] = a.mean_xy[2 * s] * 0.125f;
  f[1] = a.mean_xy[2 * s + 1] * 0.125f;
  const float rgb_scale = (float)(1.0 / 30.0);
  f[2] = a.mean_color[3 * s] * rgb_scale;
  f[3] = a.mean_color[3 * s + 1] * rgb_scale;
  f[4] = a.mean_color[3 * s + 2] * rgb_scale;
  f[5] = fminf(a.lows[s] * 2.5f, 100.0f);
}

// entry (i, j) of both kernels, minus the identity
__device__ inline void entries(const float* fi, const float* fj, int i, int j, float* v1,
                               float* v2) {
  const float xi = fi[0] * 1.0f / 2.0f, yi = fi[1] * 1.0f / 2.0f;
  float dx = xi - fj[0] * 1.0f / 2.0f, dy = yi - fj[1] * 1.0f / 2.0f;
  float dxy = dx * dx + dy * dy;
  float df = 0.f;
  for (int k = 0; k < 6; ++k) {
    float e = fi[k] - fj[k];
    df = k == 0 ? e * e : df + e * e;
  }
  float eye = i == j ? 1.f : 0.f;
  *v1 = expf(-0.5f * dxy) - eye;
  *v2 = expf(-0.5f * df) - eye;
}

struct PlanArgs {
  Means mn;
  const bool* active;
  int M, allow_new;
  float* unary;  // [S, L]
  float* feat;   // [S, 6]
  float* q0;     // [S, L]
  float* dinv;   // [2, S]
  float* ks;     // [S, S]
  float* ka;
};

// blocks [0, ceil(S / PLAN_ROWS)): the two row sums of PLAN_ROWS rows;
// the next ceil(S / THREADS) blocks: the depth range, then unaries, Q0 and
// features of THREADS superpixels
__global__ void __launch_bounds__(THREADS) plan_sums(PlanArgs a) {
  __shared__ float r1[PLAN_ROWS][THREADS], r2[PLAN_ROWS][THREADS];
  const int S = a.mn.S, row_blocks = (S + PLAN_ROWS - 1) / PLAN_ROWS;
  if ((int)blockIdx.x < row_blocks) {
    const int i0 = blockIdx.x * PLAN_ROWS;
    float fi[PLAN_ROWS][6], fj[6];
#pragma unroll
    for (int r = 0; r < PLAN_ROWS; ++r) feature(a.mn, min(i0 + r, S - 1), fi[r]);
    float s1[PLAN_ROWS], s2[PLAN_ROWS];
#pragma unroll
    for (int r = 0; r < PLAN_ROWS; ++r) s1[r] = s2[r] = 0.f;
    for (int j = threadIdx.x; j < S; j += THREADS) {
      feature(a.mn, j, fj);
#pragma unroll
      for (int r = 0; r < PLAN_ROWS; ++r) {
        float v1, v2;
        entries(fi[r], fj, i0 + r, j, &v1, &v2);
        s1[r] = s1[r] + v1;
        s2[r] = s2[r] + v2;
      }
    }
#pragma unroll
    for (int r = 0; r < PLAN_ROWS; ++r) {
      r1[r][threadIdx.x] = s1[r];
      r2[r][threadIdx.x] = s2[r];
    }
    __syncthreads();
    for (int off = THREADS / 2; off > 0; off >>= 1) {
      if (threadIdx.x < off) {
#pragma unroll
        for (int r = 0; r < PLAN_ROWS; ++r) {
          r1[r][threadIdx.x] = r1[r][threadIdx.x] + r1[r][threadIdx.x + off];
          r2[r][threadIdx.x] = r2[r][threadIdx.x] + r2[r][threadIdx.x + off];
        }
      }
      __syncthreads();
    }
    if (threadIdx.x < PLAN_ROWS && i0 + threadIdx.x < S) {
      const int r = threadIdx.x;
      a.dinv[i0 + r] = 1.f / sqrtf(fmaxf(r1[r][0], 1e-12f));
      a.dinv[S + i0 + r] = 1.f / sqrtf(fmaxf(r2[r][0], 1e-12f));
    }
    return;
  }
  float(&rmin)[THREADS] = r1[0];
  float(&rmax)[THREADS] = r2[0];
  const float* lows = a.mn.lows;
  float mn = f_inf(), mx = -f_inf();
  for (int s = threadIdx.x; s < S; s += THREADS) {
    mn = fminf(mn, lows[s]);
    mx = fmaxf(mx, lows[s]);
  }
  rmin[threadIdx.x] = mn;
  rmax[threadIdx.x] = mx;
  __syncthreads();
  for (int off = THREADS / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) {
      rmin[threadIdx.x] = fminf(rmin[threadIdx.x], rmin[threadIdx.x + off]);
      rmax[threadIdx.x] = fmaxf(rmax[threadIdx.x], rmax[threadIdx.x + off]);
    }
    __syncthreads();
  }
  const int s = (blockIdx.x - row_blocks) * THREADS + threadIdx.x;
  if (s >= S) return;
  const float depth_range = fmaxf(rmax[0] - rmin[0], 1e-3f);
  const float gate_val = depth_range * 0.01f;
  const int M = a.M, L = M + 1;
  float lowest = f_inf();
  float x[MAXL];
  for (int m = 0; m < M; ++m) {
    float icp = lows[(size_t)(1 + m) * S + s];
    float conf = lows[(size_t)(1 + M + m) * S + s];
    if (m == 0 ? conf < 0.3f : conf <= 0.4f) icp = gate_val;
    float err = a.active[m] ? icp / depth_range : f_inf();
    if (err < lowest) lowest = err;
    x[m] = clamp_unary(40.0f * err);
  }
  float un_new = fmaxf(5.0f - 40.0f * lowest, 0.01f);
  if (!a.allow_new) un_new = f_inf();
  x[M] = clamp_unary(un_new);
  for (int l = 0; l < L; ++l) {
    a.unary[(size_t)s * L + l] = x[l];
    x[l] = -x[l];
  }
  softmax(x, L);
  for (int l = 0; l < L; ++l) a.q0[(size_t)s * L + l] = x[l];
  feature(a.mn, s, a.feat + 6 * s);
}

// PLAN_ROWS rows a block: both kernel rows, each entry times d_i then d_j
__global__ void __launch_bounds__(THREADS) plan_rows(PlanArgs a) {
  const int S = a.mn.S, i0 = blockIdx.x * PLAN_ROWS;
  float fi[PLAN_ROWS][6], fj[6], d1[PLAN_ROWS], d2[PLAN_ROWS];
#pragma unroll
  for (int r = 0; r < PLAN_ROWS; ++r) {
    const int i = min(i0 + r, S - 1);
    feature(a.mn, i, fi[r]);
    d1[r] = a.dinv[i];
    d2[r] = a.dinv[S + i];
  }
  for (int j = threadIdx.x; j < S; j += THREADS) {
    feature(a.mn, j, fj);
    const float dj1 = a.dinv[j], dj2 = a.dinv[S + j];
#pragma unroll
    for (int r = 0; r < PLAN_ROWS; ++r) {
      if (i0 + r >= S) break;
      float v1, v2;
      entries(fi[r], fj, i0 + r, j, &v1, &v2);
      a.ks[(size_t)(i0 + r) * S + j] = v1 * d1[r] * dj1;
      a.ka[(size_t)(i0 + r) * S + j] = v2 * d2[r] * dj2;
    }
  }
}

struct StepArgs {
  const float* unary;
  const float* ks;
  const float* ka;
  int S, L;
  float w_s, w_a;
};

// The sums of row i's products for labels l0 .. l0 + LG - 1 (those below L)
// by one warp: lane j's terms j, j + 32, ... of both kernel rows (rs, ra)
// from 0 in that order, ROW_BATCH of them loaded together, then the fixed
// shuffle tree; Q read from q (row stride ldq; from global memory through
// the L2 when GLOBAL). Lane 0 returns them in as and aa.
template <int LG, bool GLOBAL>
__device__ inline void row_sums(const float* rs, const float* ra, const float* q, int ldq, int S,
                                int L, int l0, int lane, float* as, float* aa) {
#pragma unroll
  for (int l = 0; l < LG; ++l) {
    as[l] = 0.f;
    aa[l] = 0.f;
  }
  auto term = [&](int j, float k1, float k2) {
    const float* qj = q + (size_t)j * ldq + l0;
#pragma unroll
    for (int l = 0; l < LG; ++l) {
      if (l0 + l < L) {
        const float qv = GLOBAL ? __ldcg(qj + l) : qj[l];
        as[l] = as[l] + k1 * qv;
        aa[l] = aa[l] + k2 * qv;
      }
    }
  };
  int j = lane;
  for (; j + 32 * (ROW_BATCH - 1) < S; j += 32 * ROW_BATCH) {
    float k1[ROW_BATCH], k2[ROW_BATCH];
#pragma unroll
    for (int u = 0; u < ROW_BATCH; ++u) {
      k1[u] = rs[j + 32 * u];
      k2[u] = ra[j + 32 * u];
    }
#pragma unroll
    for (int u = 0; u < ROW_BATCH; ++u) term(j + 32 * u, k1[u], k2[u]);
  }
  for (; j < S; j += 32) term(j, rs[j], ra[j]);
#pragma unroll
  for (int l = 0; l < LG; ++l) {
    if (l0 + l < L) {
      for (int off = 16; off > 0; off >>= 1) {
        as[l] = as[l] + __shfl_down_sync(FULL, as[l], off);
        aa[l] = aa[l] + __shfl_down_sync(FULL, aa[l], off);
      }
    }
  }
}

// row i's new Q from its messages msg[0 .. L) (40 Ks_i q + 40 Ka_i q):
// softmax(-unary_i - Potts), written to out, its first-index argmax to lbl
__device__ inline void row_finish(const StepArgs& a, int i, const float* msg,
                                  float* __restrict__ out, int* __restrict__ lbl) {
  const int L = a.L;
  float x[MAXL];
  float tot = 0.f;
  for (int l = 0; l < L; ++l) tot = tot + msg[l];
  for (int l = 0; l < L; ++l) x[l] = -a.unary[(size_t)i * L + l] - (tot - msg[l]);
  softmax(x, L);
  int best = 0;
  for (int l = 0; l < L; ++l) {
    out[(size_t)i * L + l] = x[l];
    if (x[l] > x[best]) best = l;
  }
  if (lbl != nullptr) lbl[i] = best;
}

// one warp per row: one step
__global__ void __launch_bounds__(THREADS)
iterate(StepArgs a, const float* __restrict__ q, float* __restrict__ out, int* __restrict__ lbl) {
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (i >= a.S) return;
  float as[MAXL], aa[MAXL];
  row_sums<MAXL, true>(a.ks + (size_t)i * a.S, a.ka + (size_t)i * a.S, q, a.L, a.S, a.L, 0,
                       lane, as, aa);
  if (lane != 0) return;
  float msg[MAXL];
#pragma unroll
  for (int l = 0; l < MAXL; ++l)
    if (l < a.L) msg[l] = a.w_s * as[l] + a.w_a * aa[l];
  row_finish(a, i, msg, out, lbl);
}

struct FieldArgs {
  StepArgs st;
  const float* q0;
  int steps, ldq;  // ldq: the staged rows' stride (odd)
  int rows;        // rows a block (its warps: rows x groups)
  float* hist;     // [steps, S, L]: Q after each step
  int* lbl;
};

// every step in one cooperative launch, a grid barrier between steps. A
// block takes `rows` rows at a time (by grid stride), each row
// ceil(L / FIELD_LG) warps, warp g of a row summing labels g FIELD_LG ..;
// their messages meet in shared memory, and one thread a row finishes it.
// STAGED: each step's Q copied into shared memory first (`sq`, rows ldq
// apart); ROWS (one pass of rows a block): the block's kernel rows copied
// into shared memory once, before the first step.
template <bool STAGED, bool ROWS>
__global__ void __launch_bounds__(FIELD_MAX_THREADS) mean_field(FieldArgs a) {
  extern __shared__ float smem[];
  const int S = a.st.S, L = a.st.L, SL = S * L, RB = a.rows;
  const int groups = (L + FIELD_LG - 1) / FIELD_LG;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rb = warp / groups, l0 = (warp % groups) * FIELD_LG;
  float* sq = smem;                                         // STAGED: [S, ldq]
  float* msgs = smem + (STAGED ? (size_t)S * a.ldq : 0);   // [RB, MAXL]
  float* rows = msgs + RB * MAXL;                           // ROWS: [RB, 2, S]
  if (ROWS) {
    for (int r = 0; r < RB; ++r) {
      const int i = blockIdx.x * RB + r;
      if (i >= S) break;
      for (int j0 = threadIdx.x; j0 < S; j0 += blockDim.x * ROW_BATCH) {
        float v1[ROW_BATCH], v2[ROW_BATCH];
#pragma unroll
        for (int u = 0; u < ROW_BATCH; ++u) {
          const int j = j0 + u * blockDim.x;
          v1[u] = j < S ? a.st.ks[(size_t)i * S + j] : 0.f;
          v2[u] = j < S ? a.st.ka[(size_t)i * S + j] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < ROW_BATCH; ++u) {
          const int j = j0 + u * blockDim.x;
          if (j < S) {
            rows[(size_t)r * 2 * S + j] = v1[u];
            rows[(size_t)r * 2 * S + S + j] = v2[u];
          }
        }
      }
    }
  }
  for (int t = 0; t < a.steps; ++t) {
    const float* q = t == 0 ? a.q0 : a.hist + (size_t)(t - 1) * SL;
    float* out = a.hist + (size_t)t * SL;
    int* lbl = t == a.steps - 1 ? a.lbl : nullptr;
    if (STAGED) {  // STAGE_BATCH loads in flight a thread
      for (int e0 = threadIdx.x; e0 < SL; e0 += blockDim.x * STAGE_BATCH) {
        float v[STAGE_BATCH];
#pragma unroll
        for (int k = 0; k < STAGE_BATCH; ++k) {
          const int e = e0 + k * blockDim.x;
          v[k] = e < SL ? __ldcg(q + e) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < STAGE_BATCH; ++k) {
          const int e = e0 + k * blockDim.x;
          if (e < SL) sq[a.ldq == L ? e : (e / L) * a.ldq + e % L] = v[k];
        }
      }
    }
    __syncthreads();  // Q staged (and the rows), the last pass's messages read
    for (int i0 = blockIdx.x * RB; i0 < S; i0 += gridDim.x * RB) {
      const int i = i0 + rb;
      if (rb < RB && i < S) {
        const float* rs = ROWS ? rows + (size_t)rb * 2 * S : a.st.ks + (size_t)i * S;
        const float* ra = ROWS ? rows + (size_t)rb * 2 * S + S : a.st.ka + (size_t)i * S;
        float as[FIELD_LG], aa[FIELD_LG];
        if (STAGED) row_sums<FIELD_LG, false>(rs, ra, sq, a.ldq, S, L, l0, lane, as, aa);
        else row_sums<FIELD_LG, true>(rs, ra, q, L, S, L, l0, lane, as, aa);
        if (lane == 0) {
#pragma unroll
          for (int l = 0; l < FIELD_LG; ++l)
            if (l0 + l < L) msgs[rb * MAXL + l0 + l] = a.st.w_s * as[l] + a.st.w_a * aa[l];
        }
      }
      __syncthreads();
      if (threadIdx.x < RB && i0 + threadIdx.x < S)
        row_finish(a.st, i0 + threadIdx.x, msgs + threadIdx.x * MAXL, out, lbl);
      __syncthreads();
    }
    if (t + 1 < a.steps) cg::this_grid().sync();
  }
}

}  // namespace

// dinv: [2, S] scratch
extern "C" int mmf_lcrf_plan(const float* lows, const float* mean_color, const float* mean_xy,
                             const bool* active, int M, int S, int allow_new, float* unary,
                             float* feat, float* ks, float* ka, float* dinv, float* q0,
                             cudaStream_t stream) {
  if (M + 1 > MAXL || M < 1 || S < 1) return (int)cudaErrorInvalidValue;
  PlanArgs a{Means{lows, mean_color, mean_xy, S}, active, M, allow_new, unary, feat, q0, dinv,
             ks, ka};
  const int row_blocks = (S + PLAN_ROWS - 1) / PLAN_ROWS;
  plan_sums<<<row_blocks + (S + THREADS - 1) / THREADS, THREADS, 0, stream>>>(a);
  plan_rows<<<row_blocks, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mmf_lcrf_iterate(const float* q, const float* unary, const float* ks,
                                const float* ka, int S, int L, float w_s, float w_a, float* out,
                                int* lbl, cudaStream_t stream) {
  if (L > MAXL || L < 1 || S < 1) return (int)cudaErrorInvalidValue;
  StepArgs a{unary, ks, ka, S, L, w_s, w_a};
  iterate<<<(S + WARPS - 1) / WARPS, THREADS, 0, stream>>>(a, q, out, lbl);
  return (int)cudaGetLastError();
}

// `steps` >= 1 mean-field steps from q0 in one launch: hist [steps, S, L]
// gets Q after each step, lbl [S] the last one's first-index argmax. The
// rows are spread evenly over the SMs: ceil(S / SMs) rows a block, each row
// ceil(L / FIELD_LG) warps, one block an SM where they fit at once.
extern "C" int mmf_lcrf_mean_field(const float* q0, const float* unary, const float* ks,
                                   const float* ka, int S, int L, float w_s, float w_a,
                                   int steps, float* hist, int* lbl, cudaStream_t stream) {
  if (L > MAXL || L < 1 || S < 1 || steps < 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  static int sms[64];
  static size_t allowed[64][3];
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int groups = (L + FIELD_LG - 1) / FIELD_LG;
  const int rb = min(max((S + sms[dev] - 1) / sms[dev], 1), FIELD_MAX_THREADS / 32 / groups);
  const int threads = 32 * rb * groups, ldq = L | 1;
  const size_t q_bytes = (size_t)S * ldq * sizeof(float);
  const size_t msg_bytes = (size_t)rb * MAXL * sizeof(float);
  const size_t row_bytes = (size_t)rb * 2 * S * sizeof(float);
  const bool staged = q_bytes <= STAGE_MAX;
  const int need = (S + rb - 1) / rb;
  const void* kernels[3] = {(const void*)mean_field<false, false>,
                            (const void*)mean_field<true, false>,
                            (const void*)mean_field<true, true>};
  // the kernel rows in shared memory too where they fit beside Q and every
  // block's rows fit the card at once (one pass)
  int v = staged, per_sm = 0;
  for (int rows = staged && q_bytes + msg_bytes + row_bytes <= FIELD_MAX_SMEM; rows >= 0; --rows) {
    v = staged + rows;
    const size_t smem = (staged ? q_bytes : 0) + msg_bytes + (rows ? row_bytes : 0);
    if (smem > 48 * 1024 && allowed[dev][v] < smem) {
      e = cudaFuncSetAttribute(kernels[v], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      allowed[dev][v] = smem;
    }
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernels[v], threads, smem);
    if (e != cudaSuccess) return (int)e;
    if (!rows || need <= per_sm * sms[dev]) {
      if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
      const int grid = min(need, per_sm * sms[dev]);
      FieldArgs a{StepArgs{unary, ks, ka, S, L, w_s, w_a}, q0, steps, ldq, rb, hist, lbl};
      void* args[] = {&a};
      e = cudaLaunchCooperativeKernel(kernels[v], dim3(grid), dim3(threads), args, smem, stream);
      if (e != cudaSuccess) return (int)e;
      return (int)cudaGetLastError();
    }
  }
  return (int)cudaErrorCooperativeLaunchTooLarge;
}
