// K8 fuse: association, merge arbitration and append of one frame's surfels.
//
// Replaces: multimotionfusion_tpu/model/fusion.py:54 fuse.
// Bound on an H100: bytes. The map is copied once ([16, B] in and out: the
//   function returns a new map), each of the 76,800 checkerboard pixels reads
//   its frame surfel and a 4x4 window of the index map, and each write-back
//   touches one 16-channel surfel column.
// Design (four launches on one stream, no host round trip):
//   1. copy the map into the output (cudaMemcpy2DAsync) and fill the
//      slot -> source inverse map with n_src (and, behind it, the append
//      scan's status words and ticket);
//   2. assoc: one thread per pixel of the [H/2, W/2] subgrid of time parity
//      (x % 2 == y % 2 == time % 2) evaluates participation and the 4x4 window
//      search (offsets -2..+1; |zdiff * lambda| gate, ray distance, normal
//      conformance), reading candidates through the index map straight from
//      data_local; it writes the target id and merge/new flags, and, through
//      surfel.cuh's append_scan (one model), the exclusive prefix sum of the
//      new flags in source order (NOT an atomic counter, so append slots, and
//      with them every later surfel id, match the reference); the last tile
//      writes the new count, clipped to the capacity;
//   3. arbitrate: each source (merges 0..n_cb-1, then appends n_cb..2n_cb-1)
//      atomicMin's its id into inv[dst]: the lowest source id wins a slot,
//      whatever order the threads run in;
//   4. apply: the source that won its slot computes its column (the
//      confidence-weighted merge in the global frame, or the new surfel) and
//      writes it. The camera pose is read by pointer (a [4, 4] tensor on the
//      card, the odometry's output on the same stream).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "surfel.cuh"

// the pixel's target id and merge / new flags (bit 0 / bit 1)
__device__ inline int assoc_pixel(int k, const float* __restrict__ frame,
                                  const uint8_t* __restrict__ fvalid, const int* __restrict__ mask,
                                  int mask_id, const int* __restrict__ index,
                                  const float* __restrict__ dl, int B, float fx, float fy,
                                  float cx, float cy, int W, int H, int par, float depth_cutoff,
                                  float gate, int window, int* __restrict__ target) {
  int wc = W / 2;
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
  return (merging ? 1 : 0) | ((part && !merging) ? 2 : 0);
}

// the new count after appending `total` surfels, clipped to the capacity
__device__ inline void write_count(const ScanShared& sc, int tile, int tiles,
                                   const int* __restrict__ count, int cap,
                                   int* __restrict__ count_out) {
  if (tile == tiles - 1 && threadIdx.x == 0) {
    int c = *count;
    *count_out = c + min(sc.total[0], cap - c);
  }
}

__global__ void __launch_bounds__(SCAN_TILE)
assoc(const float* __restrict__ frame, const uint8_t* __restrict__ fvalid,
      const int* __restrict__ mask, int mask_id, const int* __restrict__ index,
      const float* __restrict__ dl, int B, float fx, float fy, float cx, float cy, int W, int H,
      int par, float depth_cutoff, float gate, int window, const int* __restrict__ count,
      unsigned* __restrict__ scan, unsigned fill, int* __restrict__ target,
      int* __restrict__ flags, int* __restrict__ prefix, int* __restrict__ count_out) {
  __shared__ ScanShared sc;
  const int n = (W / 2) * (H / 2), tiles = gridDim.x;
  const int tile = scan_ticket(scan, tiles, 1, fill, sc);
  const int k = tile * SCAN_TILE + threadIdx.x;
  int f = 0;
  if (k < n) {
    f = assoc_pixel(k, frame, fvalid, mask, mask_id, index, dl, B, fx, fy, cx, cy, W, H, par,
                    depth_cutoff, gate, window, target);
    flags[k] = f;
  }
  const int pre = append_scan(scan, 1, tile, (f & 2) != 0, k < n ? 0 : 1, sc);
  if (k < n) prefix[k] = pre;
  write_count(sc, tile, tiles, count, B, count_out);  // B: the capacity
}

// test entry: the append scan alone on given flags
__global__ void __launch_bounds__(SCAN_TILE)
scan_cases(const int* __restrict__ flags, int n, const int* __restrict__ count, int cap,
           unsigned* __restrict__ scan, unsigned fill, int* __restrict__ prefix,
           int* __restrict__ count_out) {
  __shared__ ScanShared sc;
  const int tiles = gridDim.x;
  const int tile = scan_ticket(scan, tiles, 1, fill, sc);
  const int k = tile * SCAN_TILE + threadIdx.x;
  const bool newf = k < n && ((flags[k] >> 1) & 1);
  const int pre = append_scan(scan, 1, tile, newf, k < n ? 0 : 1, sc);
  if (k < n) prefix[k] = pre;
  write_count(sc, tile, tiles, count, cap, count_out);
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
  if (n_cb < 1 || n_src >= (int)SCAN_VALUE) return (int)cudaErrorInvalidValue;
  // inv: [cap] slot -> source, then the append scan's [tiles] status words
  // and its ticket, all filled with n_src
  const int tiles = scan_tiles(n_cb), filled = cap + tiles + 1;
  unsigned* scan = reinterpret_cast<unsigned*>(inv + cap);
  cudaMemcpy2DAsync(out, sizeof(float) * cap, data, sizeof(float) * row_stride,
                    sizeof(float) * cap, CH, cudaMemcpyDeviceToDevice, stream);
  fill_int<<<(filled + threads - 1) / threads, threads, 0, stream>>>(inv, filled, n_src);
  assoc<<<tiles, SCAN_TILE, 0, stream>>>(
      frame, frame_valid, mask, mask_id, index, data_local, cap, fx, fy, cx, cy, W, H, par,
      depth_cutoff, gate, window, count, scan, (unsigned)n_src, target, flags, prefix,
      count_out);
  arbitrate<<<(n_src + threads - 1) / threads, threads, 0, stream>>>(target, flags, prefix,
                                                                      count, n_cb, cap, inv);
  apply<<<(n_src + threads - 1) / threads, threads, 0, stream>>>(
      frame, data_local, cap, target, flags, prefix, count, inv, n_cb, cap, pose, W, H, par, time,
      out);
  return (int)cudaGetLastError();
}

// test entry: the append scan of assoc alone, on given flags (bit 1: new);
// scratch holds scan_tiles(n) + 1 ints
extern "C" int mmf_fuse_scan_cases(const int* flags, int n, const int* count, int cap,
                                   unsigned* scratch, int* prefix, int* count_out,
                                   cudaStream_t stream) {
  if (n < 1 || n >= (int)SCAN_VALUE) return (int)cudaErrorInvalidValue;
  const int tiles = scan_tiles(n), fill = n;
  fill_int<<<(tiles + 1 + 255) / 256, 256, 0, stream>>>(reinterpret_cast<int*>(scratch),
                                                          tiles + 1, fill);
  scan_cases<<<tiles, SCAN_TILE, 0, stream>>>(flags, n, count, cap, scratch, (unsigned)fill,
                                              prefix, count_out);
  return (int)cudaGetLastError();
}
