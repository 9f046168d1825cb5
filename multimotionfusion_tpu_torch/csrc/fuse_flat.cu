// K14 fuse_flat + clean_flat: composite fusion and clean of the multi-model
// step, once over the flat store of all models.
//
// Replaces: multimotionfusion_tpu/model/fusion.py:414 fuse_flat (with :385
//   _transform_per_owner) and :615 clean_flat.
// Bound on an H100: bytes, as K8 and K9 (csrc/fuse.cu, csrc/clean.cu): the
//   [16, N] flat store is copied once in and out (fuse) and read and written
//   once (clean); the checkerboard's 76,800 pixels each read a frame surfel
//   and a 4x4 window of the index map and winner-model image.
// The flat store: the global map's bucket [0, bg) (model 0), then slot k's
//   bucket [bg + k bo, bg + (k + 1) bo) (model k + 1); `counts` [M] are the
//   segments' high-water marks. Poses, max depths, active flags, counts and
//   confidence gates are [M] tensors on the card, read by pointer.
// fuse_flat (five launches, no host round trip):
//   1. copy the store into the output and fill the slot -> source inverse
//      map (and, behind it, the append scan's status words and ticket);
//   2. assoc: one thread per pixel of the time-parity checkerboard:
//      participation (its mask owner is a model, active, depth within
//      min(owner's max depth, cutoff), 4-neighbour depth support), then the
//      4x4 window search (offsets -2..+1) over candidates OF THE OWNER's
//      model only (winner model == mask), K8's gates; then, through
//      surfel.cuh's append_scan (warp m looks back for model m), per model
//      the exclusive prefix sum of the new flags of that model's pixels in
//      source order; the last tile writes the new counts, clipped to each
//      segment's room;
//   3. arbitrate: merges 0..n_cb-1, then appends n_cb..2n_cb-1, atomicMin
//      their source id into inv[dst] (append dst = segment base + count +
//      rank, dropped beyond the segment): the lowest source wins;
//   4. apply: the winning source writes its column, merged or new, in its
//      OWNER's model frame (camera -> model pose of the owner).
// clean_flat (three launches, no compaction; the caller repacks each
//   segment every compact_every frames with K9):
//   1. fill the verdicts with ford(1);
//   2. pixel pass: per index-map winner, the redundancy and z counts over
//      window candidates of the SAME model, each against ITS model's
//      confidence gate, the 3x3 see-through penalty, and an atomicMin of the
//      verdict (-1 = cull vote, else the penalty) through surfel.cuh's
//      order-preserving float -> int map, so the min is thread-order free;
//   3. surfel pass: alive (slot below its segment's count, ALIVE set), the
//      visual cull, the unstable cull against its model's confidence gate,
//      the inactive keep; the penalty applied, ALIVE cleared where culled.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "surfel.cuh"

constexpr int THREADS = 256;
constexpr int MAXM = SCAN_MAXM;

struct Flat {
  int bg, bo, slots;
};

__device__ inline int base_of(const Flat& F, int m) { return m == 0 ? 0 : F.bg + (m - 1) * F.bo; }
__device__ inline int end_of(const Flat& F, int m) { return F.bg + m * F.bo; }
__device__ inline int model_of(const Flat& F, int i) {
  return i < F.bg ? 0 : 1 + (i - F.bg) / F.bo;
}

// ---------------------------------------------------------------- fuse_flat

struct Assoc {
  const float* frame;
  const uint8_t* fvalid;
  const int* mask;
  const int* win;
  const int* index;
  const float* dl;
  int N;  // flat store size
  const float* maxd;
  const bool* active;
  int M;
  float fx, fy, cx, cy;
  int W, H, par;
  float cutoff, gate;
  int window;
};

// the pixel's target id and merge / new flags (bit 0 / bit 1); its owner
__device__ inline int assoc_pixel(const Assoc& a, int k, int* __restrict__ target, int* own_out) {
  int wc = a.W / 2;
  int y = 2 * (k / wc) + a.par, x = 2 * (k % wc) + a.par;
  int NP = a.W * a.H;
  int p = y * a.W + x;
  const float* frame = a.frame;
  int own = a.mask[p];
  *own_out = own;
  float fz = frame[PZ * NP + p];
  float fnx = frame[NX * NP + p], fny = frame[NY * NP + p], fnz = frame[NZ * NP + p];
  bool neigh = (x > 0 && frame[PZ * NP + p - 1] > 0.f) && (x + 1 < a.W && frame[PZ * NP + p + 1] > 0.f) &&
               (y > 0 && frame[PZ * NP + p - a.W] > 0.f) && (y + 1 < a.H && frame[PZ * NP + p + a.W] > 0.f);
  bool owned = own >= 0 && own < a.M;
  bool part = owned && a.active[own] && neigh && a.fvalid[p] && fz > 0.f &&
              fz <= fminf(a.maxd[own], a.cutoff);

  float xl = ((float)x - a.cx) / a.fx;
  float yl = ((float)y - a.cy) / a.fy;
  float lam = sqrtf(xl * xl + yl * yl + 1.0f);
  float best_dist = 1000.0f;
  int best = -1;
  int r = a.window / 2;
  for (int dy = -r; dy < a.window - r; ++dy) {
    int yy = y + dy;
    if (yy < 0 || yy >= a.H) continue;
    for (int dx = -r; dx < a.window - r; ++dx) {
      int xx = x + dx;
      if (xx < 0 || xx >= a.W) continue;
      int c = a.index[yy * a.W + xx];
      if (c < 0 || a.win[yy * a.W + xx] != own) continue;
      assoc_candidate(a.dl, a.N, c, fz, fnx, fny, fnz, xl, yl, lam, a.gate, &best_dist, &best);
    }
  }
  bool merging = part && best >= 0;
  target[k] = best;
  return (merging ? 1 : 0) | ((part && !merging) ? 2 : 0);
}

// the new counts after the appends, clipped to each segment's room
__device__ inline void write_counts(const ScanShared& sc, int tile, int tiles, int M, Flat F,
                                    const int* __restrict__ counts,
                                    int* __restrict__ counts_out) {
  if (tile == tiles - 1 && threadIdx.x < M) {
    const int m = threadIdx.x;
    int c = counts[m];
    int room = max(end_of(F, m) - base_of(F, m) - c, 0);
    counts_out[m] = c + min(sc.total[m], room);
  }
}

// the prefix is written where the pixel has a model (the only pixels whose
// prefix an append reads)
__global__ void __launch_bounds__(SCAN_TILE)
assoc(Assoc a, Flat F, const int* __restrict__ counts, unsigned* __restrict__ scan,
      unsigned fill, int* __restrict__ target, int* __restrict__ flags, int* __restrict__ own_out,
      int* __restrict__ prefix, int* __restrict__ counts_out) {
  __shared__ ScanShared sc;
  const int n = (a.W / 2) * (a.H / 2), tiles = gridDim.x;
  const int tile = scan_ticket(scan, tiles, a.M, fill, sc);
  const int k = tile * SCAN_TILE + threadIdx.x;
  int f = 0, own = a.M;
  if (k < n) {
    f = assoc_pixel(a, k, target, &own);
    flags[k] = f;
    own_out[k] = own;
  }
  const int pre = append_scan(scan, a.M, tile, (f & 2) != 0, own, sc);
  if (k < n && own >= 0 && own < a.M) prefix[k] = pre;
  write_counts(sc, tile, tiles, a.M, F, counts, counts_out);
}

// test entry: the append scan alone on given flags and owners
__global__ void __launch_bounds__(SCAN_TILE)
scan_cases(const int* __restrict__ flags, const int* __restrict__ own, int n, int M, Flat F,
           const int* __restrict__ counts, unsigned* __restrict__ scan, unsigned fill,
           int* __restrict__ prefix, int* __restrict__ counts_out) {
  __shared__ ScanShared sc;
  const int tiles = gridDim.x;
  const int tile = scan_ticket(scan, tiles, M, fill, sc);
  const int k = tile * SCAN_TILE + threadIdx.x;
  const int o = k < n ? own[k] : M;
  const bool newf = k < n && ((flags[k] >> 1) & 1);
  const int pre = append_scan(scan, M, tile, newf, o, sc);
  if (k < n && o >= 0 && o < M) prefix[k] = pre;
  write_counts(sc, tile, tiles, M, F, counts, counts_out);
}

__device__ inline int dest(int k, int n_cb, const int* target, const int* flags, const int* own,
                           const int* prefix, const int* counts, Flat F) {
  if (k < n_cb) return (flags[k] & 1) ? target[k] : -1;
  int j = k - n_cb;
  if (!(flags[j] & 2)) return -1;
  int m = own[j];
  int d = base_of(F, m) + counts[m] + prefix[j];
  return d < end_of(F, m) ? d : -1;
}

__global__ void arbitrate(const int* __restrict__ target, const int* __restrict__ flags,
                          const int* __restrict__ own, const int* __restrict__ prefix,
                          const int* __restrict__ counts, int n_cb, Flat F,
                          int* __restrict__ inv) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 2 * n_cb) return;
  int d = dest(k, n_cb, target, flags, own, prefix, counts, F);
  if (d >= 0) atomicMin(&inv[d], k);
}

__global__ void apply(const float* __restrict__ frame, const float* __restrict__ dl, int N,
                      const int* __restrict__ target, const int* __restrict__ flags,
                      const int* __restrict__ own, const int* __restrict__ prefix,
                      const int* __restrict__ counts, const int* __restrict__ inv, int n_cb,
                      Flat F, const float* __restrict__ poses, int W, int H, int par,
                      float time, float* __restrict__ out) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 2 * n_cb) return;
  int d = dest(k, n_cb, target, flags, own, prefix, counts, F);
  if (d < 0 || inv[d] != k) return;
  int j = k < n_cb ? k : k - n_cb;
  const float* T = poses + 16 * own[j];  // a participating pixel's owner is a model
  int wc = W / 2;
  int p = (2 * (j / wc) + par) * W + 2 * (j % wc) + par;
  int NP = W * H;
  float nw[CH];
  for (int c = 0; c < CH; ++c) nw[c] = frame[c * NP + p];
  transform(nw, T);
  if (k >= n_cb) {
    for (int c = 0; c < CH; ++c) out[c * N + d] = nw[c];
    return;
  }
  int t = target[j];
  float old[CH];
  for (int c = 0; c < CH; ++c) old[c] = dl[c * N + t];
  transform(old, T);
  float m[CH];
  merge(old, nw, time, m);
  for (int c = 0; c < CH; ++c) out[c * N + d] = m[c];
}

// ---------------------------------------------------------------- clean_flat

struct PixelArgs {
  const int* index;
  const float* dl;
  int N;
  const int* win;
  const float* depth;
  const float* conf_all;
  int H, W, window;
  float time, gate, coeff;
};

__global__ void pixel_pass(PixelArgs a, int* __restrict__ vk) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.H * a.W) return;
  int i = a.index[p];
  if (i < 0) return;
  int y = p / a.W, x = p % a.W;
  int own = a.win[p];  // a winner's model
  int count, z_count;
  window_counts(a.index, a.dl, a.N, a.win, own, a.H, a.W, a.window, x, y, i, a.conf_all[own],
                a.time, &count, &z_count);
  bool viol;
  float pen = see_through(a.depth, a.H, a.W, x, y, a.dl[PZ * a.N + i], a.gate, a.coeff, &viol);
  bool cull = count > 8 || z_count > 4;
  atomicMin(&vk[i], ford(cull ? -1.f : pen));
}

struct SurfelArgs {
  const float* data;
  int rs, N;
  Flat F;
  const int* counts;
  const float* conf_all;
  float time, grace, time_delta;
  float* out;
};

__global__ void surfel_pass(SurfelArgs a, const int* __restrict__ vk) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.N) return;
  int m = model_of(a.F, i);
  int pos = i - base_of(a.F, m);
  bool alive = pos < a.counts[m] && a.data[ALIVE * a.rs + i] > 0.f;
  float pen;
  bool keep = keep_surfel(alive, vk[i], a.data[LAST_T * a.rs + i], a.data[CONF * a.rs + i],
                          a.time, a.grace, a.conf_all[m], a.time_delta, &pen);
  for (int c = 0; c < CH; ++c) {
    float x = a.data[c * a.rs + i];
    if (c == CONF) x = x * pen;
    if (c == ALIVE && !keep) x = 0.f;
    a.out[c * a.N + i] = x;
  }
}

}  // namespace

extern "C" int mmf_fuse_flat(const float* data, int row_stride, int bg, int bo, int slots,
                             const int* counts, const float* frame, const uint8_t* frame_valid,
                             const int* mask, const int* win_model, const int* index,
                             const float* data_local, const float* poses, const float* maxd,
                             const bool* active, float fx, float fy, float cx, float cy, int W,
                             int H, float time, int par, float depth_cutoff, float gate,
                             int window, int* target, int* flags, int* own, int* prefix, int* inv,
                             int* counts_out, float* out, cudaStream_t stream) {
  int M = 1 + slots;
  if (M > MAXM) return (int)cudaErrorInvalidValue;
  Flat F{bg, bo, slots};
  int N = bg + slots * bo;
  int n_cb = (W / 2) * (H / 2);
  int n_src = 2 * n_cb;
  if (n_cb < 1 || n_src >= (int)SCAN_VALUE) return (int)cudaErrorInvalidValue;
  // inv: [N] slot -> source, then the append scan's [tiles, M] status words
  // and its ticket, all filled with n_src
  const int tiles = scan_tiles(n_cb), filled = N + tiles * M + 1;
  unsigned* scan = reinterpret_cast<unsigned*>(inv + N);
  cudaMemcpy2DAsync(out, sizeof(float) * N, data, sizeof(float) * row_stride, sizeof(float) * N,
                    CH, cudaMemcpyDeviceToDevice, stream);
  fill_int<<<(filled + THREADS - 1) / THREADS, THREADS, 0, stream>>>(inv, filled, n_src);
  Assoc a{frame, frame_valid, mask, win_model, index, data_local, N, maxd, active, M,
          fx, fy, cx, cy, W, H, par, depth_cutoff, gate, window};
  assoc<<<tiles, SCAN_TILE, 0, stream>>>(a, F, counts, scan, (unsigned)n_src, target, flags, own,
                                         prefix, counts_out);
  arbitrate<<<(n_src + THREADS - 1) / THREADS, THREADS, 0, stream>>>(target, flags, own, prefix,
                                                                      counts, n_cb, F, inv);
  apply<<<(n_src + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      frame, data_local, N, target, flags, own, prefix, counts, inv, n_cb, F, poses, W, H, par,
      time, out);
  return (int)cudaGetLastError();
}

// test entry: the append scan of assoc alone, on given flags (bit 1: new)
// and owners, for the M = 1 + slots models of the layout; scratch holds
// scan_tiles(n) * M + 1 ints
extern "C" int mmf_fuse_flat_scan_cases(const int* flags, const int* own, int n, int bg, int bo,
                                        int slots, const int* counts, unsigned* scratch,
                                        int* prefix, int* counts_out, cudaStream_t stream) {
  const int M = 1 + slots;
  if (M > MAXM || n < 1 || n >= (int)SCAN_VALUE) return (int)cudaErrorInvalidValue;
  const int tiles = scan_tiles(n), fill = n;
  fill_int<<<(tiles * M + 1 + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      reinterpret_cast<int*>(scratch), tiles * M + 1, fill);
  scan_cases<<<tiles, SCAN_TILE, 0, stream>>>(flags, own, n, M, Flat{bg, bo, slots}, counts,
                                              scratch, (unsigned)fill, prefix, counts_out);
  return (int)cudaGetLastError();
}

extern "C" int mmf_clean_flat(const float* data, int row_stride, int bg, int bo, int slots,
                              const int* counts, const int* index, const float* data_local,
                              const int* win_model, const float* depth, const float* conf_all,
                              int H, int W, int window, float time, float time_delta, float grace,
                              float gate, float coeff, int* verdicts, float* out,
                              cudaStream_t stream) {
  Flat F{bg, bo, slots};
  int N = bg + slots * bo;
  fill_verdicts<<<(N + THREADS - 1) / THREADS, THREADS, 0, stream>>>(verdicts, N);
  PixelArgs pa{index, data_local, N, win_model, depth, conf_all, H, W, window, time, gate, coeff};
  pixel_pass<<<(H * W + THREADS - 1) / THREADS, THREADS, 0, stream>>>(pa, verdicts);
  SurfelArgs sa{data, row_stride, N, F, counts, conf_all, time, grace, time_delta, out};
  surfel_pass<<<(N + THREADS - 1) / THREADS, THREADS, 0, stream>>>(sa, verdicts);
  return (int)cudaGetLastError();
}
