// K8 fuse: association, merge arbitration and append of one frame's surfels.
//
// Replaces: multimotionfusion_tpu/model/fusion.py:54 fuse.
// Bound on an H100: bytes. The map is copied once ([16, B] in and out: the
//   function returns a new map), each of the 76,800 checkerboard pixels reads
//   its frame surfel and a 4x4 window of the index map, and each write-back
//   touches one 16-channel surfel column.
// Design (five launches on one stream, no host round trip):
//   1. copy the map into the output (cudaMemcpy2DAsync) and fill the
//      slot -> source inverse map with n_src;
//   2. assoc: one thread per pixel of the [H/2, W/2] subgrid of time parity
//      (x % 2 == y % 2 == time % 2) evaluates participation and the 4x4 window
//      search (offsets -2..+1; |zdiff * lambda| gate, ray distance, normal
//      conformance), reading candidates through the index map straight from
//      data_local; it writes the target id and merge/new flags;
//   3. scan: one block forms the exclusive prefix sum of the new flags in
//      source order (NOT an atomic counter, so append slots, and with them
//      every later surfel id, match the reference) and the new count;
//   4. arbitrate: each source (merges 0..n_cb-1, then appends n_cb..2n_cb-1)
//      atomicMin's its id into inv[dst]: the lowest source id wins a slot,
//      whatever order the threads run in;
//   5. apply: the source that won its slot computes its column (the
//      confidence-weighted merge in the global frame, or the new surfel) and
//      writes it. The camera pose is read by pointer (a [4, 4] tensor on the
//      card, the odometry's output on the same stream).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "surfel.cuh"

constexpr int SCAN_THREADS = 1024;

__global__ void assoc(const float* __restrict__ frame, const uint8_t* __restrict__ fvalid,
                      const int* __restrict__ mask, int mask_id, const int* __restrict__ index,
                      const float* __restrict__ dl, int B, float fx, float fy, float cx, float cy,
                      int W, int H, int par, float depth_cutoff, float gate, int window,
                      int* __restrict__ target, int* __restrict__ flags) {
  int wc = W / 2, hc = H / 2;
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= wc * hc) return;
  int y = 2 * (k / wc) + par, x = 2 * (k % wc) + par;
  int N = W * H;
  int p = y * W + x;
  float fz = frame[PZ * N + p];
  float fnx = frame[NX * N + p], fny = frame[NY * N + p], fnz = frame[NZ * N + p];
  bool neigh = (x > 0 && frame[PZ * N + p - 1] > 0.f) && (x + 1 < W && frame[PZ * N + p + 1] > 0.f) &&
               (y > 0 && frame[PZ * N + p - W] > 0.f) && (y + 1 < H && frame[PZ * N + p + W] > 0.f);
  bool part = (mask[p] == mask_id) && neigh && fvalid[p] && fz > 0.f && fz <= depth_cutoff;

  float xl = ((float)x - cx) / fx;
  float yl = ((float)y - cy) / fy;
  float lam = sqrtf(xl * xl + yl * yl + 1.0f);
  float best_dist = 1000.0f;
  int best = -1;
  int r = window / 2;
  for (int dy = -r; dy < window - r; ++dy) {
    int yy = y + dy;
    if (yy < 0 || yy >= H) continue;
    for (int dx = -r; dx < window - r; ++dx) {
      int xx = x + dx;
      if (xx < 0 || xx >= W) continue;
      int c = index[yy * W + xx];
      if (c < 0) continue;
      assoc_candidate(dl, B, c, fz, fnx, fny, fnz, xl, yl, lam, gate, &best_dist, &best);
    }
  }
  bool merging = part && best >= 0;
  target[k] = best;
  flags[k] = (merging ? 1 : 0) | ((part && !merging) ? 2 : 0);
}

// exclusive prefix sum of the "new" flags over the subgrid in source order
__global__ void scan_new(const int* __restrict__ flags, int n, const int* __restrict__ count,
                         int cap, int* __restrict__ prefix, int* __restrict__ count_out) {
  __shared__ int sh[SCAN_THREADS];
  int tid = threadIdx.x;
  int chunk = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  int lo = min(tid * chunk, n), hi = min(lo + chunk, n);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += (flags[i] >> 1) & 1;
  sh[tid] = s;
  __syncthreads();
  for (int off = 1; off < SCAN_THREADS; off <<= 1) {  // inclusive Hillis-Steele
    int v = (tid >= off) ? sh[tid - off] : 0;
    __syncthreads();
    sh[tid] += v;
    __syncthreads();
  }
  int run = sh[tid] - s;
  for (int i = lo; i < hi; ++i) {
    prefix[i] = run;
    run += (flags[i] >> 1) & 1;
  }
  if (tid == SCAN_THREADS - 1) {
    int c = *count;
    *count_out = c + min(sh[tid], cap - c);
  }
}

__device__ inline int dest(int k, int n_cb, const int* target, const int* flags,
                           const int* prefix, int count, int cap) {
  if (k < n_cb) return (flags[k] & 1) ? target[k] : -1;
  int j = k - n_cb;
  if (!(flags[j] & 2)) return -1;
  int d = count + prefix[j];
  return d < cap ? d : -1;
}

__global__ void arbitrate(const int* __restrict__ target, const int* __restrict__ flags,
                          const int* __restrict__ prefix, const int* __restrict__ count, int n_cb,
                          int cap, int* __restrict__ inv) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 2 * n_cb) return;
  int d = dest(k, n_cb, target, flags, prefix, *count, cap);
  if (d >= 0) atomicMin(&inv[d], k);
}

__global__ void apply(const float* __restrict__ frame, const float* __restrict__ dl, int B,
                      const int* __restrict__ target, const int* __restrict__ flags,
                      const int* __restrict__ prefix, const int* __restrict__ count,
                      const int* __restrict__ inv, int n_cb, int cap, const float* __restrict__ Tm,
                      int W, int H, int par, float time, float* __restrict__ out) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 2 * n_cb) return;
  int d = dest(k, n_cb, target, flags, prefix, *count, cap);
  if (d < 0 || inv[d] != k) return;
  int j = k < n_cb ? k : k - n_cb;
  int wc = W / 2;
  int p = (2 * (j / wc) + par) * W + 2 * (j % wc) + par;
  int N = W * H;
  float nw[CH];
  for (int c = 0; c < CH; ++c) nw[c] = frame[c * N + p];
  transform(nw, Tm);
  if (k >= n_cb) {
    for (int c = 0; c < CH; ++c) out[c * cap + d] = nw[c];
    return;
  }
  int t = target[j];
  float old[CH];
  for (int c = 0; c < CH; ++c) old[c] = dl[c * B + t];
  transform(old, Tm);
  float m[CH];
  merge(old, nw, time, m);
  for (int c = 0; c < CH; ++c) out[c * cap + d] = m[c];
}

}  // namespace

extern "C" int mmf_fuse(const float* data, int row_stride, int cap, const int* count,
                        const float* frame, const uint8_t* frame_valid, const int* mask,
                        int mask_id, const int* index, const float* data_local,
                        const float* pose, float fx, float fy, float cx, float cy, int W, int H, float time, int par,
                        float depth_cutoff, float gate, int window, int* target, int* flags,
                        int* prefix, int* inv, int* count_out, float* out,
                        cudaStream_t stream) {
  const int threads = 256;
  int n_cb = (W / 2) * (H / 2);
  int n_src = 2 * n_cb;
  cudaMemcpy2DAsync(out, sizeof(float) * cap, data, sizeof(float) * row_stride,
                    sizeof(float) * cap, CH, cudaMemcpyDeviceToDevice, stream);
  fill_int<<<(cap + threads - 1) / threads, threads, 0, stream>>>(inv, cap, n_src);
  assoc<<<(n_cb + threads - 1) / threads, threads, 0, stream>>>(
      frame, frame_valid, mask, mask_id, index, data_local, cap, fx, fy, cx, cy, W, H, par,
      depth_cutoff, gate, window, target, flags);
  scan_new<<<1, SCAN_THREADS, 0, stream>>>(flags, n_cb, count, cap, prefix, count_out);
  arbitrate<<<(n_src + threads - 1) / threads, threads, 0, stream>>>(target, flags, prefix,
                                                                      count, n_cb, cap, inv);
  apply<<<(n_src + threads - 1) / threads, threads, 0, stream>>>(
      frame, data_local, cap, target, flags, prefix, count, inv, n_cb, cap, pose, W, H, par, time,
      out);
  return (int)cudaGetLastError();
}
