// K21 ransac_fit: batched rigid RANSAC with Horn's quaternion fits, B fits
// in one launch set.
//
// Replaces: multimotionfusion_tpu/ops/ransac.py:165 ransac_fit, with :134
//   _sample_minimal_sets, :104 kabsch_fit, :38 _horn_rotation and :127
//   residual_norms (one fit); the vmapped fits of engine_multi.py:293
//   (the per-model seeds) and of the back-dating (tracking/tracker.py).
// Bound on an H100: latency. C = 200 candidates x N = 4096 correspondences is
//   ~3 passes of 12 MFLOP a fit; each block's sums over N and the 40 power
//   steps of its two 4x4 eigenproblems (one thread) set the time.
// Design: three launches for B fits. valid_positions (a block a fit) scans
//   the valid flags once (the rank-th valid index, for every candidate's
//   searchsorted); candidates (a block a candidate and fit, grid (C, B))
//   draws its three ranks from u with the reference's arithmetic, fits the
//   minimal set, evaluates all N points (distances, inlier flags in shared
//   memory, the count), refits on its inliers (centroids, then the centred
//   cross-covariance: a second pass), and takes the mean inlier distance of
//   the refit (a third pass); choose (a block a fit) takes the first argmin
//   over the candidates, the all-valid fallback fit when none passed, and
//   writes T, error, inliers, num_inliers and ok. Every sum over the N points
//   runs in one fixed order, the same for every candidate (each thread sums
//   its strided points in order, then a shuffle-down tree per warp, then the
//   warp sums in order; no float atomics): candidates that end with the same
//   inlier set get bit-equal refits, and the argmin keeps the first of them
//   as the reference's does. ops/ransac.py's plain version sums in the same
//   orders. A fit's points are read through strides (batch, point): shared
//   points have batch stride 0, and the back-dating pairs are read straight
//   from one gather of the track ring.
// Hopeless fits: where a fit's valid count total is at most its gate
//   max(rint(frac total), 3), no candidate can pass (its inlier count is at
//   most total), so its candidate blocks only draw the ranks, write the
//   minimal-set indices, passed = false and score = +inf, and return before
//   the passes over N. choose reads nothing else of a fit where none passed,
//   so every output is the full evaluation's; the per-candidate scratch of
//   such a fit (the fits in cand, n_inl) is left unwritten. choose writes
//   the identity for the fallback fit of fewer than 3 valid points, which is
//   what the fit itself returns there (its weights sum below 3).
// choose's argmin is parallel: each thread keeps the least (value, index)
//   key of its candidates, then a block minimum. That is the serial loop's
//   result (strict <, first index on ties, -0 equal to +0): a NaN score never
//   wins, and a NaN at index 0 keeps index 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "common.cuh"

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_N = 40000;  // the inlier flags of one candidate in shared memory
// candidate blocks resident on an SM: their serial Horn chains overlap. Six
// need <= 40 registers, where ptxas spills (56-64 bytes; 8 with every loop
// rolled); five keep the 48 registers of one fit's kernel and no spill
constexpr int CAND_MIN_BLOCKS = 5;

__device__ inline float pos_inf() { return __uint_as_float(0x7f800000u); }

// one fit's points: coordinate a of point i at p[i * ps + a]
struct Pts {
  const float* p;
  int ps;
  __device__ __forceinline__ float operator()(int i, int a) const { return p[i * ps + a]; }
};

// the batch: fit b's points at p0 + b * bs0 (p1 + b * bs1), point stride ps0 (ps1)
struct Batch {
  const float* u;      // [B, C, 3]
  const float* p0;
  const float* p1;
  const bool* valid;   // [B, N]
  int bs0, ps0, bs1, ps1;
  int N, C;
  __device__ __forceinline__ Pts P0(int b) const { return Pts{p0 + (long)b * bs0, ps0}; }
  __device__ __forceinline__ Pts P1(int b) const { return Pts{p1 + (long)b * bs1, ps1}; }
};

// pos[r] = index of the (r+1)-th valid point; pos[N] = number of valid points
// (block b: fit b's flags and positions)
__global__ void __launch_bounds__(SCAN_THREADS)
valid_positions(const bool* __restrict__ valid_all, int N, int* __restrict__ pos_all) {
  __shared__ int warp_sums[32];
  const bool* valid = valid_all + (long)blockIdx.x * N;
  int* pos = pos_all + (long)blockIdx.x * (N + 1);
  const int ipt = (N + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min((int)threadIdx.x * ipt, N), hi = min(lo + ipt, N);
  int cnt = 0;
  for (int i = lo; i < hi; ++i) cnt += valid[i] ? 1 : 0;
  int total;
  int r = block_exclusive_scan(cnt, warp_sums, &total);
  for (int i = lo; i < hi; ++i)
    if (valid[i]) pos[r++] = i;
  if (threadIdx.x == 0) pos[N] = total;
}

// sum of each of v[0..NV) over the block, in the fixed order; result in out[]
template <int NV>
__device__ void block_sum(const float (&v)[NV], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < NV; ++k) {
    float a = v[k];
    for (int off = 16; off > 0; off >>= 1) a = a + __shfl_down_sync(FULL, a, off);
    if (lane == 0) red[warp * NV + k] = a;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s = s + red[w * NV + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// Horn: the rotation maximising tr(R A^T), by 40 power steps on N + c I
__device__ void horn(const float (&A)[3][3], float (&R)[3][3]) {
  const float sxx = A[0][0], sxy = A[1][0], sxz = A[2][0];
  const float syx = A[0][1], syy = A[1][1], syz = A[2][1];
  const float szx = A[0][2], szy = A[1][2], szz = A[2][2];
  float N[4][4] = {
      {sxx + syy + szz, syz - szy, szx - sxz, sxy - syx},
      {syz - szy, sxx - syy - szz, sxy + syx, szx + sxz},
      {szx - sxz, sxy + syx, syy - sxx - szz, syz + szy},
      {sxy - syx, szx + sxz, syz + szy, szz - sxx - syy},
  };
  float fro = 0.f;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) fro = fro + N[i][j] * N[i][j];
  const float c = sqrtf(fro) + 1e-12f;
  for (int i = 0; i < 4; ++i) N[i][i] = N[i][i] + c;
  const float v0[4] = {1.f, 0.17f, 0.23f, 0.31f};
  float n0 = 0.f;
  for (int i = 0; i < 4; ++i) n0 = n0 + v0[i] * v0[i];
  n0 = sqrtf(n0);
  float v[4];
  for (int i = 0; i < 4; ++i) v[i] = v0[i] / n0;
  for (int it = 0; it < 40; ++it) {
    float w[4];
    for (int i = 0; i < 4; ++i) {
      float acc = 0.f;
      for (int j = 0; j < 4; ++j) acc = acc + N[i][j] * v[j];
      w[i] = acc;
    }
    float nrm = 0.f;
    for (int i = 0; i < 4; ++i) nrm = nrm + w[i] * w[i];
    nrm = fmaxf(sqrtf(nrm), 1e-20f);
    for (int i = 0; i < 4; ++i) v[i] = w[i] / nrm;
  }
  const float qw = v[0], qx = v[1], qy = v[2], qz = v[3];
  R[0][0] = 1.f - 2.f * (qy * qy + qz * qz);
  R[0][1] = 2.f * (qx * qy - qw * qz);
  R[0][2] = 2.f * (qx * qz + qw * qy);
  R[1][0] = 2.f * (qx * qy + qw * qz);
  R[1][1] = 1.f - 2.f * (qx * qx + qz * qz);
  R[1][2] = 2.f * (qy * qz - qw * qx);
  R[2][0] = 2.f * (qx * qz - qw * qy);
  R[2][1] = 2.f * (qy * qz + qw * qx);
  R[2][2] = 1.f - 2.f * (qx * qx + qy * qy);
}

// T = [R | p0m - R p1m], or the identity when the weights sum below 3
__device__ void assemble(const float (&A)[3][3], const float* p0m, const float* p1m, float wsum,
                         float* T) {
  float R[3][3];
  horn(A, R);
  const bool ok = wsum >= 2.999999f;
  for (int i = 0; i < 3; ++i) {
    const float t = p0m[i] - ((R[i][0] * p1m[0] + R[i][1] * p1m[1]) + R[i][2] * p1m[2]);
    for (int j = 0; j < 3; ++j) T[4 * i + j] = ok ? R[i][j] : (i == j ? 1.f : 0.f);
    T[4 * i + 3] = ok ? t : 0.f;
  }
  for (int j = 0; j < 4; ++j) T[12 + j] = j == 3 ? 1.f : 0.f;
}

// |p0_i - T p1_i|
__device__ inline float resid(const float* T, Pts p0, Pts p1, int i) {
  const float x = p1(i, 0), y = p1(i, 1), z = p1(i, 2);
  float d[3];
  for (int r = 0; r < 3; ++r) {
    const float p1t = ((T[4 * r] * x + T[4 * r + 1] * y) + T[4 * r + 2] * z) + T[4 * r + 3];
    d[r] = p0(i, r) - p1t;
  }
  return sqrtf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]);
}

// weighted fit over all N points with block sums (weights 0/1 from wfn);
// writes T (shared) from thread 0 and synchronises
template <class WFn>
__device__ void fit_block(Pts p0, Pts p1, int N, WFn wfn, float* red, float* out, float* T) {
  float m[7] = {};  // the weight, p0 * w, p1 * w
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const float w = wfn(i);
    m[0] = m[0] + w;
    for (int a = 0; a < 3; ++a) {
      m[1 + a] = m[1 + a] + p0(i, a) * w;
      m[4 + a] = m[4 + a] + p1(i, a) * w;
    }
  }
  block_sum<7>(m, red, out);
  const float wsum = out[0];
  const float safe = fmaxf(wsum, 1e-12f);
  float p0m[3], p1m[3];
  for (int a = 0; a < 3; ++a) {
    p0m[a] = out[1 + a] / safe;
    p1m[a] = out[4 + a] / safe;
  }
  __syncthreads();  // out[] is reused below
  float v[9] = {};  // the centred cross-covariance
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const float w = wfn(i);
    float q0[3], q1[3];
    for (int a = 0; a < 3; ++a) {
      q0[a] = (p0(i, a) - p0m[a]) * w;
      q1[a] = p1(i, a) - p1m[a];
    }
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) v[3 * a + b] = v[3 * a + b] + q0[a] * q1[b];
  }
  block_sum<9>(v, red, out);
  if (threadIdx.x == 0) {
    float A[3][3];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) A[a][b] = out[3 * a + b];
    assemble(A, p0m, p1m, wsum, T);
  }
  __syncthreads();
}

struct Cand {
  int* idx;      // [B, C, 3]
  float* T;      // [B, C, 32]: minimal fit, refit
  float* score;  // [B, C]
  int* n_inl;    // [B, C]
  bool* passed;  // [B, C]
};

// candidate c's minimal set: three distinct ranks in [1, total] (sequential
// shifted sampling), each mapped to the rank-th valid index (searchsorted,
// side left)
__device__ void minimal_set(const float* u, int total, const int* pos, int N, int (&ix)[3]) {
  const float tf = (float)total;
  int r0 = (int)floorf(u[0] * fmaxf(tf, 1.f)) + 1;
  int r1 = (int)floorf(u[1] * fmaxf(tf - 1.f, 1.f)) + 1;
  r1 += r1 >= r0 ? 1 : 0;
  int r2 = (int)floorf(u[2] * fmaxf(tf - 2.f, 1.f)) + 1;
  const int lo = min(r0, r1), hi = max(r0, r1);
  r2 += r2 >= lo ? 1 : 0;
  r2 += r2 >= hi ? 1 : 0;
  const int rr[3] = {r0, r1, r2};
  for (int k = 0; k < 3; ++k) {
    const int r = min(max(rr[k], 1), max(total, 1));
    ix[k] = r <= total ? pos[r - 1] : N - 1;
  }
}

__global__ void __launch_bounds__(THREADS, CAND_MIN_BLOCKS)
candidates(Batch f, const int* __restrict__ pos_all, float thr, float frac, Cand cd) {
  extern __shared__ unsigned char s_inl[];
  __shared__ float red[WARPS * 9], out[9], s_T[16], s_R[16];
  const int c = blockIdx.x, b = blockIdx.y, N = f.N;
  const long cb = (long)b * f.C + c;  // this candidate's row of the scratch
  const int* pos = pos_all + (long)b * (N + 1);
  const Pts p0 = f.P0(b), p1 = f.P1(b);
  const bool* valid = f.valid + (long)b * N;
  const int total = pos[N];
  const int gate = max((int)rintf(frac * (float)total), 3);
  if (total <= gate) {  // a hopeless fit: no candidate can pass
    if (threadIdx.x == 0) {
      int ix[3];
      minimal_set(f.u + 3 * cb, total, pos, N, ix);
      for (int k = 0; k < 3; ++k) cd.idx[3 * cb + k] = ix[k];
      cd.score[cb] = pos_inf();
      cd.passed[cb] = false;
    }
    return;
  }
  if (threadIdx.x == 0) {
    int ix[3];
    minimal_set(f.u + 3 * cb, total, pos, N, ix);
    float P0[3][3], P1[3][3];
    for (int k = 0; k < 3; ++k) {
      cd.idx[3 * cb + k] = ix[k];
      for (int a = 0; a < 3; ++a) {
        P0[k][a] = p0(ix[k], a);
        P1[k][a] = p1(ix[k], a);
      }
    }
    // the minimal fit: unit weights, sums over the three points in order
    float wsum = 0.f, p0m[3], p1m[3];
    for (int k = 0; k < 3; ++k) wsum = wsum + 1.f;
    const float safe = fmaxf(wsum, 1e-12f);
    for (int a = 0; a < 3; ++a) {
      float s0 = 0.f, s1 = 0.f;
      for (int k = 0; k < 3; ++k) {
        s0 = s0 + P0[k][a] * 1.f;
        s1 = s1 + P1[k][a] * 1.f;
      }
      p0m[a] = s0 / safe;
      p1m[a] = s1 / safe;
    }
    float A[3][3];
    for (int a = 0; a < 3; ++a)
      for (int bb = 0; bb < 3; ++bb) {
        float s = 0.f;
        for (int k = 0; k < 3; ++k) s = s + ((P0[k][a] - p0m[a]) * 1.f) * (P1[k][bb] - p1m[bb]);
        A[a][bb] = s;
      }
    assemble(A, p0m, p1m, wsum, s_T);
    for (int e = 0; e < 16; ++e) cd.T[32 * cb + e] = s_T[e];
  }
  __syncthreads();
  // distances of all points, inlier flags and count
  float cnt[1] = {0.f};
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const bool in = resid(s_T, p0, p1, i) < thr && valid[i];
    s_inl[i] = in;
    cnt[0] = cnt[0] + (in ? 1.f : 0.f);
  }
  block_sum<1>(cnt, red, out);
  const int n_inl = (int)out[0];
  __syncthreads();
  // refit on the inliers, then the mean inlier distance of the refit
  fit_block(p0, p1, N, [&](int i) { return s_inl[i] ? 1.f : 0.f; }, red, out, s_R);
  float err[1] = {0.f};
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const float d = resid(s_R, p0, p1, i);
    err[0] = err[0] + (s_inl[i] ? d : 0.f);
  }
  block_sum<1>(err, red, out);
  if (threadIdx.x == 0) {
    const bool passed = n_inl > gate;
    const float mean_err = out[0] / fmaxf((float)n_inl, 1.f);
    cd.score[cb] = passed ? mean_err : pos_inf();
    cd.n_inl[cb] = n_inl;
    cd.passed[cb] = passed;
    for (int e = 0; e < 16; ++e) cd.T[32 * cb + 16 + e] = s_R[e];
  }
}

__global__ void __launch_bounds__(THREADS)
choose(Batch f, const int* __restrict__ pos_all, float thr, Cand cd, float* __restrict__ T_all,
       float* __restrict__ error, bool* __restrict__ inliers_all, int* __restrict__ num,
       bool* __restrict__ ok) {
  __shared__ float red[WARPS * 9], out[9], s_T[16], s_M[16];
  __shared__ unsigned long long s_key[WARPS];
  __shared__ int s_best;
  const int b = blockIdx.x, N = f.N, C = f.C;
  const Pts p0 = f.P0(b), p1 = f.P1(b);
  const bool* valid = f.valid + (long)b * N;
  const float* score = cd.score + (long)b * C;
  const bool* passed = cd.passed + (long)b * C;
  // the first argmin: key = (order of the score, index), -0 taken as +0
  unsigned long long key = ~0ull;
  int mine = 0;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float s = score[c];
    mine |= passed[c] ? 1 : 0;
    if (!isnan(s)) {
      const unsigned long long k =
          ((unsigned long long)ord32(s == 0.f ? 0.f : s) << 32) | (unsigned)c;
      key = k < key ? k : key;
    }
  }
  const bool any = __syncthreads_or(mine) != 0;
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(FULL, key, off);
    key = o < key ? o : key;
  }
  if ((threadIdx.x & 31) == 0) s_key[threadIdx.x >> 5] = key;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long k = s_key[0];
    for (int w = 1; w < WARPS; ++w) k = s_key[w] < k ? s_key[w] : k;
    s_best = (isnan(score[0]) || k == ~0ull) ? 0 : (int)(k & 0xffffffffull);
  }
  __syncthreads();
  const long best = (long)b * C + s_best;
  if (any) {
    if (threadIdx.x < 16) {
      s_T[threadIdx.x] = cd.T[32 * best + 16 + threadIdx.x];
      s_M[threadIdx.x] = cd.T[32 * best + threadIdx.x];
    }
    __syncthreads();
  } else if (pos_all[(long)b * (N + 1) + N] < 3) {
    // the fallback's weights sum below 3: its fit is the identity
    if (threadIdx.x < 16) s_T[threadIdx.x] = threadIdx.x % 5 == 0 ? 1.f : 0.f;
    __syncthreads();
  } else {
    // fallback: least squares over all valid points
    fit_block(p0, p1, N, [&](int i) { return valid[i] ? 1.f : 0.f; }, red, out, s_T);
  }
  bool* inliers = inliers_all + (long)b * N;
  for (int i = threadIdx.x; i < N; i += THREADS)
    inliers[i] = any && resid(s_M, p0, p1, i) < thr && valid[i];
  if (threadIdx.x < 16) T_all[16 * b + threadIdx.x] = s_T[threadIdx.x];
  if (threadIdx.x == 0) {
    error[b] = any ? cd.score[best] : pos_inf();
    num[b] = any ? cd.n_inl[best] : 0;
    ok[b] = any;
  }
}

}  // namespace

// B fits: u [B, C, 3], valid [B, N], fit b's points p0 + b * bs0 with point
// stride ps0 (p1 likewise; bs 0: shared points); outputs [B, ...]
extern "C" int mmf_ransac_fit_batch(const float* u, const float* p0, const float* p1,
                                    const bool* valid, int bs0, int ps0, int bs1, int ps1, int B,
                                    int N, int C, float thr, float frac, int* pos, int* idx,
                                    float* cand, float* score, int* n_inl, bool* passed, float* T,
                                    float* error, bool* inliers, int* num, bool* ok,
                                    cudaStream_t stream) {
  if (N > MAX_N || N < 1 || C < 1 || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const Batch f{u, p0, p1, valid, bs0, ps0, bs1, ps1, N, C};
  const Cand cd{idx, cand, score, n_inl, passed};
  valid_positions<<<B, SCAN_THREADS, 0, stream>>>(valid, N, pos);
  candidates<<<dim3(C, B), THREADS, N, stream>>>(f, pos, thr, frac, cd);
  choose<<<B, THREADS, 0, stream>>>(f, pos, thr, cd, T, error, inliers, num, ok);
  return (int)cudaGetLastError();
}

