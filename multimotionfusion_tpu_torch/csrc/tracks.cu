// K20 tracks: mutual_match and the track table's update (add_keypoints,
// prune, last_pair).
//
// Replaces: multimotionfusion_tpu/tracking/tracker.py:83 mutual_match, :116
//   add_keypoints (with :65 backproject_keypoints), :182 prune and :239
//   last_pair.
// Bound on an H100: mutual_match by operations at the default shapes (K = 512
//   queries x T = 4096 tracks x D = 64: 268 MFLOP of dot products, the
//   descriptors themselves are 1.2 MB); the update by latency (it touches
//   K rows and one ring slot of every track).
// Design:
//   - mutual_match: a 64 x 64 tile of (query, track) pairs per block with both
//     descriptor tiles in shared memory; each dot product and both squared
//     norms are summed over d = 0..D-1 in order (the plain version repeats
//     that order), d2 = |q|^2 - 2 q.t + |t|^2 (1e30 where either side is
//     invalid), and the [K, T] matrix is never written: the row and column
//     argmins are 64-bit atomicMins of (order-preserving d2 bits << 32 |
//     index), so ties go to the first index whatever the order of the
//     blocks. A second launch applies the mutual test and the gate;
//   - update, launch 1 (one block of 1024 threads): a block scan of the free
//     slots gives the r-th free slot, a block scan of the unmatched valid
//     keypoints gives each its rank r, and each keypoint writes its matched
//     or new row (back-projected point, ring slot time % H, descriptor, last
//     seen, count); new keypoints beyond the free slots are dropped;
//   - update, launch 2 (one thread per track): clear the next ring slot,
//     then (on tracked frames) prune and form the (p0, p1, valid) pair.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "common.cuh"

constexpr int TQ = 64, TT = 64, DC = 64;  // tile of queries x tracks, descriptor chunk
constexpr int MATCH_THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int MAX_K = 4096;
constexpr unsigned long long NONE = 0xffffffffffffffffull;


__global__ void __launch_bounds__(MATCH_THREADS)
match_tile(const float* __restrict__ q, const float* __restrict__ t,
           const bool* __restrict__ qv, const bool* __restrict__ tv, int K, int T, int D,
           unsigned long long* __restrict__ rowbest, unsigned long long* __restrict__ colbest) {
  __shared__ float sq[TQ][DC + 1];
  __shared__ float st[TT][DC + 1];
  __shared__ float qn[TQ], tn[TT];
  __shared__ unsigned long long rmin[TQ], cmin[TT];
  const int q0 = blockIdx.y * TQ, t0 = blockIdx.x * TT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  if (tid < TQ) rmin[tid] = NONE;
  if (tid < TT) cmin[tid] = NONE;
  float dot[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) dot[i][j] = 0.f;
  float nacc = 0.f;  // |q|^2 of row tid (tid < 64) or |t|^2 of row tid - 64
  for (int d0 = 0; d0 < D; d0 += DC) {
    const int dc = min(DC, D - d0);
    for (int e = tid; e < TQ * DC; e += MATCH_THREADS) {
      int r = e / DC, c = e % DC;
      sq[r][c] = (q0 + r < K && c < dc) ? q[(size_t)(q0 + r) * D + d0 + c] : 0.f;
      st[r][c] = (t0 + r < T && c < dc) ? t[(size_t)(t0 + r) * D + d0 + c] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < dc; ++c) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = sq[ty + 16 * i][c];
      for (int j = 0; j < 4; ++j) b[j] = st[tx + 16 * j][c];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) dot[i][j] = dot[i][j] + a[i] * b[j];
      if (tid < TQ) nacc = nacc + sq[tid][c] * sq[tid][c];
      else if (tid < TQ + TT) nacc = nacc + st[tid - TQ][c] * st[tid - TQ][c];
    }
    __syncthreads();
  }
  if (tid < TQ) qn[tid] = nacc;
  else if (tid < TQ + TT) tn[tid - TQ] = nacc;
  __syncthreads();
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, gq = q0 + r;
    if (gq >= K) continue;
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, gt = t0 + c;
      if (gt >= T) continue;
      float d2 = (qn[r] - 2.f * dot[i][j]) + tn[c];
      if (!(qv[gq] && tv[gt])) d2 = 1e30f;
      const unsigned long long hi = (unsigned long long)ord32(d2) << 32;
      atomicMin(&rmin[r], hi | (unsigned)gt);
      atomicMin(&cmin[c], hi | (unsigned)gq);
    }
  }
  __syncthreads();
  if (tid < TQ && rmin[tid] != NONE) atomicMin(&rowbest[q0 + tid], rmin[tid]);
  if (tid < TT && cmin[tid] != NONE) atomicMin(&colbest[t0 + tid], cmin[tid]);
}

__global__ void match_final(const unsigned long long* __restrict__ rowbest,
                            const unsigned long long* __restrict__ colbest,
                            const bool* __restrict__ qv, int K, float gate2,
                            int* __restrict__ match, bool* __restrict__ matched_t) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const unsigned long long rb = rowbest[k];
  const int bt = (int)(rb & 0xffffffffull);
  const float d2 = unord32((unsigned)(rb >> 32));
  const bool mutual = (int)(colbest[bt] & 0xffffffffull) == k;
  const bool ok = mutual && d2 <= gate2 && qv[k];
  match[k] = ok ? bt : -1;
  if (ok) matched_t[bt] = true;
}

struct Table {
  float* xy;
  float* p3d;
  bool* seen;
  bool* has_depth;
  float* desc;
  int* last_seen;
  int* nvalid;
  bool* active;
};

struct Frame {
  const float* kxy;
  const float* kdesc;
  const bool* kvalid;
  const int* match;
  const float* depth;
  int cap, hist, D, K, H, W;
  float fx, fy, cx, cy;
  int time;
};

__global__ void __launch_bounds__(SCAN_THREADS) update_rows(Table tb, Frame f) {
  __shared__ int s_slot[MAX_K];
  __shared__ int warp_sums[32];
  const int tid = threadIdx.x;
  const int slot = f.time % f.hist;
  for (int r = tid; r < f.K; r += SCAN_THREADS) s_slot[r] = -1;
  // the r-th free slot, in index order (the table as it was before this frame)
  const int ipt = (f.cap + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(tid * ipt, f.cap), hi = min(lo + ipt, f.cap);
  int nfree = 0;
  for (int i = lo; i < hi; ++i) nfree += tb.active[i] ? 0 : 1;
  int total;
  int rank = block_exclusive_scan(nfree, warp_sums, &total);  // synchronises
  for (int i = lo; i < hi; ++i) {
    if (tb.active[i]) continue;
    if (rank < f.K) s_slot[rank] = i;
    ++rank;
  }
  __syncthreads();
  // the rank of each unmatched valid keypoint
  const int kpt = (f.K + SCAN_THREADS - 1) / SCAN_THREADS;
  const int klo = min(tid * kpt, f.K), khi = min(klo + kpt, f.K);
  int nnew = 0;
  for (int k = klo; k < khi; ++k) nnew += (f.kvalid[k] && f.match[k] < 0) ? 1 : 0;
  int want = block_exclusive_scan(nnew, warp_sums, &total);
  for (int k = klo; k < khi; ++k) {
    const int m = f.match[k];
    int tgt = m;
    if (m < 0) {
      if (!f.kvalid[k]) continue;
      tgt = s_slot[want++];
      if (tgt < 0) continue;  // no free slot left: dropped
    }
    const float x = f.kxy[2 * k], y = f.kxy[2 * k + 1];
    const int xi = min(max(__float2int_rn(x), 0), f.W - 1);
    const int yi = min(max(__float2int_rn(y), 0), f.H - 1);
    const float z = f.depth[yi * f.W + xi];
    const bool hd = f.kvalid[k] && z > 0.f;
    const size_t e = (size_t)tgt * f.hist + slot;
    tb.xy[2 * e] = x;
    tb.xy[2 * e + 1] = y;
    tb.p3d[3 * e] = hd ? (z * (x - f.cx)) / f.fx : 0.f;
    tb.p3d[3 * e + 1] = hd ? (z * (y - f.cy)) / f.fy : 0.f;
    tb.p3d[3 * e + 2] = hd ? z : 0.f;
    tb.seen[e] = true;
    tb.has_depth[e] = hd;
    for (int d = 0; d < f.D; ++d) tb.desc[(size_t)tgt * f.D + d] = f.kdesc[(size_t)k * f.D + d];
    tb.last_seen[tgt] = f.time;
    tb.nvalid[tgt] = m >= 0 ? tb.nvalid[tgt] + 1 : 1;
    tb.active[tgt] = true;
  }
}

__global__ void ring_prune_pair(Table tb, int cap, int hist, int time, int pair, int min_kps,
                                int max_age, float* __restrict__ p0, float* __restrict__ p1,
                                bool* __restrict__ pv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  const int nxt = (time + 1) % hist;
  tb.seen[(size_t)i * hist + nxt] = false;
  tb.has_depth[(size_t)i * hist + nxt] = false;
  if (!pair) return;
  const int ls = tb.last_seen[i];
  bool act = tb.active[i];
  const bool drop = act && tb.nvalid[i] < min_kps && (time - ls) > max_age;
  act = act && !drop;
  tb.active[i] = act;
  const int s1 = time % hist, s0 = ((time - 1) % hist + hist) % hist;
  const size_t e0 = (size_t)i * hist + s0, e1 = (size_t)i * hist + s1;
  for (int a = 0; a < 3; ++a) {
    p0[3 * i + a] = tb.p3d[3 * e0 + a];
    p1[3 * i + a] = tb.p3d[3 * e1 + a];
  }
  pv[i] = act && tb.has_depth[e0] && tb.has_depth[e1] && ls == time;
}

}  // namespace

extern "C" int mmf_mutual_match(const float* q, const float* t, const bool* qv, const bool* tv,
                                int K, int T, int D, float gate2, unsigned long long* rowbest,
                                unsigned long long* colbest, int* match, bool* matched_t,
                                cudaStream_t stream) {
  cudaMemsetAsync(rowbest, 0xff, sizeof(unsigned long long) * K, stream);
  cudaMemsetAsync(colbest, 0xff, sizeof(unsigned long long) * T, stream);
  cudaMemsetAsync(matched_t, 0, sizeof(bool) * T, stream);
  dim3 grid((T + TT - 1) / TT, (K + TQ - 1) / TQ);
  match_tile<<<grid, MATCH_THREADS, 0, stream>>>(q, t, qv, tv, K, T, D, rowbest, colbest);
  match_final<<<(K + 255) / 256, 256, 0, stream>>>(rowbest, colbest, qv, K, gate2, match,
                                                    matched_t);
  return (int)cudaGetLastError();
}

extern "C" int mmf_track_update(float* xy, float* p3d, bool* seen, bool* has_depth, float* desc,
                                int* last_seen, int* nvalid, bool* active, const float* kxy,
                                const float* kdesc, const bool* kvalid, const int* match,
                                const float* depth, int cap, int hist, int D, int K, int H, int W,
                                float fx, float fy, float cx, float cy, int time, int pair,
                                int min_kps, int max_age, float* p0, float* p1, bool* pv,
                                cudaStream_t stream) {
  if (K > MAX_K) return (int)cudaErrorInvalidValue;
  Table tb{xy, p3d, seen, has_depth, desc, last_seen, nvalid, active};
  Frame f{kxy, kdesc, kvalid, match, depth, cap, hist, D, K, H, W, fx, fy, cx, cy, time};
  update_rows<<<1, SCAN_THREADS, 0, stream>>>(tb, f);
  ring_prune_pair<<<(cap + 255) / 256, 256, 0, stream>>>(tb, cap, hist, time, pair, min_kps,
                                                         max_age, p0, p1, pv);
  return (int)cudaGetLastError();
}
