// K14 fuse_flat + clean_flat: composite fusion and clean of the multi-model
// step, once over the flat store of all models.
//
// Replaces: multimotionfusion_tpu/model/fusion.py:414 fuse_flat (with :385
//   _transform_per_owner) and :615 clean_flat.
// Bound on an H100: bytes, as K8 and K9 (csrc/fuse.cu, csrc/clean.cu): the
//   [16, N] flat store is copied once in and out (fuse); the clean reads the
//   index map, winner-model image and depth, each winner's channels once and
//   three channels of every row, and writes the rows it changes; the
//   checkerboard's 76,800 pixels each read a frame surfel and a 4x4 window of
//   the index map and winner-model image.
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
//   segment every compact_every frames with K9), IN PLACE on the store:
//   1. fill the verdicts with ford(1);
//   2. pixel pass: per index-map winner, the redundancy and z counts over
//      window candidates of the SAME model, each against ITS model's
//      confidence gate, the 3x3 see-through penalty, and an atomicMin of the
//      verdict (-1 = cull vote, else the penalty) through surfel.cuh's
//      order-preserving float -> int map, so the min is thread-order free.
//      A 256-thread block owns a CTW x CTH pixel tile and stages it widened
//      by the window's halo (window / 2 before, the rest after): one thread
//      gathers each staged winner's position, confidence and times once
//      (a thread's positions' loads issued together, so their latencies
//      overlap), folds its model's confidence gate into the staged model,
//      and every pixel counts from shared memory in window_counts' order
//      (surfel.cuh's window_counts_staged, three words a tap; 35 x 11
//      staged positions for 32 x 8 pixels at the engine's 4x4 window, which
//      is compiled as a fixed window with the loop unrolled);
//   3. surfel pass: alive (slot below its segment's count, ALIVE set), the
//      visual cull, the unstable cull against its model's confidence gate,
//      the inactive keep; it reads ALIVE, LAST_T and CONF of every row and
//      writes CONF only where the penalty is not 1 and ALIVE (+0) only where
//      the row is not kept and ALIVE is not already +0: the other channels
//      and rows are the input's, untouched (x * 1.0f is x).

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

constexpr int CTW = 32, CTH = 8;  // the pixel pass's tile
constexpr int CLEAN_THREADS = CTW * CTH;
constexpr int CLEAN_MAX_WINDOW = 7;  // the largest window the staging holds
constexpr int CLEAN_STAGED = (CTW + CLEAN_MAX_WINDOW - 1) * (CTH + CLEAN_MAX_WINDOW - 1);

struct PixelArgs {
  const int* index;
  const float* dl;
  int N;
  const int* win;
  const float* depth;
  const float* conf_all;
  int M;
  int H, W, window;
  float time, gate, coeff;
};

// WINDOW > 0: the window fixed at compile time (the engine's 4x4, the
// count loop unrolled); 0: a.window
template <int WINDOW>
__global__ void __launch_bounds__(CLEAN_THREADS) pixel_pass(PixelArgs a, int* __restrict__ vk) {
  __shared__ CleanStage<CLEAN_STAGED> st;
  const int window = WINDOW > 0 ? WINDOW : a.window;
  const int tx = threadIdx.x % CTW, ty = threadIdx.x / CTW;
  const int x0 = blockIdx.x * CTW, y0 = blockIdx.y * CTH;
  const int r = window / 2;
  const int sw = CTW + window - 1, sh = CTH + window - 1;
  constexpr int ROUNDS = (CLEAN_STAGED + CLEAN_THREADS - 1) / CLEAN_THREADS;
  int c[ROUNDS], wq[ROUNDS];
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) {
    const int s = threadIdx.x + k * CLEAN_THREADS;
    const int yy = y0 - r + s / sw, xx = x0 - r + s % sw;
    c[k] = -1;
    if (s < sw * sh && yy >= 0 && yy < a.H && xx >= 0 && xx < a.W) {
      c[k] = a.index[yy * a.W + xx];
      wq[k] = a.win[yy * a.W + xx];
    }
  }
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) {
    const int s = threadIdx.x + k * CLEAN_THREADS;
    int m = -1;
    if (c[k] >= 0) {
      const float gate = wq[k] >= 0 && wq[k] < a.M ? a.conf_all[wq[k]] : 0.f;
      st.p[s] = make_float4(a.dl[PX * a.N + c[k]], a.dl[PY * a.N + c[k]], a.dl[PZ * a.N + c[k]],
                            a.dl[INIT_T * a.N + c[k]]);
      st.last[s] = a.dl[LAST_T * a.N + c[k]];
      if (a.dl[CONF * a.N + c[k]] > gate) m = wq[k];
    }
    if (s < sw * sh) st.key[s] = make_int2(c[k], m);
  }
  __syncthreads();
  const int x = x0 + tx, y = y0 + ty;
  if (x >= a.W || y >= a.H) return;
  const int sc = (ty + r) * sw + tx + r;  // the pixel's own staged position
  const int i = st.key[sc].x;
  if (i < 0) return;
  const int own = a.win[y * a.W + x];  // a winner's model
  const float4 q = st.p[sc];
  const float qz = q.z;
  int count, z_count;
  window_counts_staged<CLEAN_STAGED, WINDOW>(st, ty * sw + tx, sw, window, own, i, q.x, q.y,
                                             qz, q.w, a.dl[RADIUS * a.N + i],
                                             fabsf(a.dl[NZ * a.N + i]), a.time, &count,
                                             &z_count);
  bool viol;
  float pen = see_through(a.depth, a.H, a.W, x, y, qz, a.gate, a.coeff, &viol);
  bool cull = count > 8 || z_count > 4;
  atomicMin(&vk[i], ford(cull ? -1.f : pen));
}

struct SurfelArgs {
  float* data;  // cleaned in place
  int rs, N;
  Flat F;
  const int* counts;
  const float* conf_all;
  float time, grace, time_delta;
};

__global__ void surfel_pass(SurfelArgs a, const int* __restrict__ vk) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.N) return;
  int m = model_of(a.F, i);
  int pos = i - base_of(a.F, m);
  const float alive_v = a.data[ALIVE * a.rs + i];
  const float conf = a.data[CONF * a.rs + i];
  bool alive = pos < a.counts[m] && alive_v > 0.f;
  float pen;
  bool keep = keep_surfel(alive, vk[i], a.data[LAST_T * a.rs + i], conf, a.time, a.grace,
                          a.conf_all[m], a.time_delta, &pen);
  if (pen != 1.0f) a.data[CONF * a.rs + i] = conf * pen;
  if (!keep && __float_as_int(alive_v) != 0) a.data[ALIVE * a.rs + i] = 0.f;
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

extern "C" int mmf_clean_flat(float* data, int row_stride, int bg, int bo, int slots,
                              const int* counts, const int* index, const float* data_local,
                              const int* win_model, const float* depth, const float* conf_all,
                              int H, int W, int window, float time, float time_delta, float grace,
                              float gate, float coeff, int* verdicts, cudaStream_t stream) {
  if (window < 1 || window > CLEAN_MAX_WINDOW || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  Flat F{bg, bo, slots};
  int N = bg + slots * bo;
  fill_verdicts<<<(N + THREADS - 1) / THREADS, THREADS, 0, stream>>>(verdicts, N);
  PixelArgs pa{index, data_local, N, win_model, depth, conf_all, 1 + slots, H, W, window, time,
               gate, coeff};
  const dim3 tiles((W + CTW - 1) / CTW, (H + CTH - 1) / CTH);
  auto pixels = window == 4 ? pixel_pass<4> : pixel_pass<0>;
  pixels<<<tiles, CLEAN_THREADS, 0, stream>>>(pa, verdicts);
  SurfelArgs sa{data, row_stride, N, F, counts, conf_all, time, grace, time_delta};
  surfel_pass<<<(N + THREADS - 1) / THREADS, THREADS, 0, stream>>>(sa, verdicts);
  return (int)cudaGetLastError();
}
