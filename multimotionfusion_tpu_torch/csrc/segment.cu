// K18 segment: the flow-CRF's unaries, label fusion and segment finish.
//
// Replaces: multimotionfusion_tpu/segmentation/flow_crf.py:51
//   reprojection_probability, :110 sparse_unary and :155
//   flow_crf_segmentation (:212-216 the unary softmax, :231-276 the
//   posterior fusion, bias and claim floor, :278-355 the minimum-cells gate,
//   border test and nearest upsample, :372-396 the sigma-clipped statistics).
// Bound on an H100: bytes, and at these sizes the launches and the chain of
//   dependent steps. Per frame the [M+1, 120, 160] rows are written and read
//   a few times (~1 MB) and the 640x480 mask and new-label mask are written
//   once (1.5 MB); a few dozen operations per cell.
// Design: mmf_seg_unaries is ONE launch in pull form, no global scratch: a
//   block of UN_T threads owns UN_C consecutive CRF cells, one thread each,
//   and keeps their sparse-error rows [M+1][UN_C] in shared memory, set to
//   +inf. (1) Each thread loads, all in flight together, its warp lane's
//   model's active flag, its cell's centre depth sample and first UN_MODELS
//   model depths, and its first UN_TRACKS tracks' flags and positions (a
//   valid track's cell is the same rounded, clamped expression as the plain
//   version's). (2) After a barrier, the tracks whose cell is one of the
//   block's are listed in shared memory and taken by its threads in turn;
//   a thread loads its entry's velocities, writes its cell's raw fits,
//   outlier row and behind flags while they fly, then mins the track's
//   error per label (0 or 1) into the rows by an int atomicMin on the
//   float's bits (exact for non-negative floats, order-free); the scan goes
//   on over the other tracks. (3) After another barrier, softmax of -errors
//   (the sum in label order) -> -log, read from the rows in shared memory.
//   The same expressions as the three launches it replaces (cells, tracks,
//   softmax), so every output is bit-equal to theirs; every block reads the
//   ~4,096 tracks' flags and positions (from the L2).
//   mmf_seg_fuse: one thread per cell, the fusion and the first argmax of
//   prob - bias (a strict > keeps the first of equal values), the claim
//   floor, and the label stack K17 reads.
//   mmf_seg_finish is ONE launch of one cluster of FIN_C = 16 blocks of
//   1,024 threads (no one-block stage): (1) block b stages the segment ids
//   (int8, M <= 31) and depths of its band of cell rows [b hc / 16,
//   (b + 1) hc / 16) in shared memory and reduces the band's global-cell
//   count and new-label box; (2) through distributed shared memory it
//   pushes each cell of its band to the block whose statistics partial
//   sums it, and its count and box to block 0 (after cluster barrier 0,
//   whose wait follows the band's loads: every block runs before any remote
//   store); (3) between the arrival at and the wait on cluster barrier 1 it
//   writes the mask and new-label mask of its band's pixel rows from its
//   own ids (a warp a row; at 1/4 a cell's four pixels as one 16-byte and
//   one 4-byte store); (4) block 0 writes has_new and the pixel counts (a
//   warp without a segment), and warp l sums segment l, both passes.
//   The statistics' contract order (-fmad=false, the float expressions of
//   the one-block kernel it replaced, so its outputs are bit-equal):
//   partial t < 1024 sums its cells t, t + 1024, ... in ascending order
//   (count, sum, sum of squares: s = s + 1, s + d, s + d * d where the cell
//   is in the segment, has depth > 1e-6 and, in pass 2, lies in pass 1's
//   [mu - band, mu + band]); then a halving tree, red[t] + red[t + s] for
//   s = 512, 256, ..., 1; then n = max(red0, 1), mu = red1 / n, var =
//   red2 / n - mu * mu, sd = sqrt(max(var, 0)), band = max(1.2 sd, 0.05).
//   Block b owns the partials t = b + 16 i (i < 64), so the levels s >= 16
//   pair partials of one block: a lane sums i and i + 32 (s = 512), then
//   __shfl_down_sync 16 ... 1 (s = 256 ... 16); the levels 8 ... 1 pair the
//   blocks' results, pushed to every block before cluster barrier 2 (pass
//   1: each block computes every segment's band) and to block 0 before
//   barrier 3 (pass 2: block 0 writes mean and std). Four cluster barriers.
//   checks.seg_stats_emulated repeats that order with torch ops; the plain
//   version (torch.sum) differs by a few ulp. Labels, masks and counts are
//   integer logic: exact.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_M = 31;
constexpr int TB = 256;

__device__ inline int fbits(float f) { return __float_as_int(f); }

// the unaries: one launch, pull form. Block b owns the cells [b UN_C,
// (b + 1) UN_C), thread i < UN_C cell b UN_C + i; its error rows live in shared
// memory; all UN_T threads scan the tracks. Few cells a block spread the
// cells' arithmetic over the card's SMs (120 blocks at 120 x 160); many
// threads a block keep the scan one round of loads.
constexpr int UN_T = 512;
constexpr int UN_C = 160;
constexpr int UN_TRACKS = 8;  // tracks a thread locates at once (its loads in flight)
constexpr int UN_MODELS = 8;  // models' values a thread loads at once

struct UnArgs {
  const float* depth;
  int H, W;
  const float* pred;  // [M, hc, wc]
  int M, hc, wc;
  const bool* active;
  const float* xy;   // [T, 2]
  const float* vel;  // [M, T]
  const bool* valid;
  int T;
  float scale, thr;
  int allow_new;
  float max_err;
  float* fdc;
  float* p_proj;
  bool* behind;
  float* unary;
};

// cell c's centre depth sample and its first UN_MODELS models' depths
__device__ inline void load_cell(const UnArgs& a, int c, int npix, float& fd, float* pds) {
  int y = c / a.wc, x = c - y * a.wc;
  int ky = a.H / a.hc, kx = a.W / a.wc;
  fd = a.depth[(y * ky + ky / 2) * a.W + x * kx + kx / 2];
#pragma unroll
  for (int k = 0; k < UN_MODELS; ++k) pds[k] = k < a.M ? a.pred[k * npix + c] : 0.f;
}

// cell c from its loaded values: the centre depth sample, every model's raw
// fit, the outlier row and the behind flags (the models past the first
// UN_MODELS loaded UN_MODELS at a time)
__device__ inline void cell_rows(const UnArgs& a, unsigned act, int c, int npix, float fd,
                                 float* pds) {
  a.fdc[c] = fd;
  // any model without depth where the frame has none (read only there)
  bool invalid = false;
  if (fd < 1e-6f)
    for (int m = 0; m < a.M; ++m) invalid = invalid || a.pred[m * npix + c] < 1e-6f;
  float best = -INFINITY;
  bool any_behind = false, any_cover = false;
  for (int m0 = 0; m0 < a.M; m0 += UN_MODELS) {
    if (m0 > 0) {
#pragma unroll
      for (int k = 0; k < UN_MODELS; ++k)
        pds[k] = m0 + k < a.M ? a.pred[(m0 + k) * npix + c] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < UN_MODELS; ++k) {
      const int m = m0 + k;
      if (m >= a.M) break;
      const bool on = act >> m & 1u;
      const float pd = pds[k];
      float raw = expf(-fabsf(fd - pd) / a.max_err);
      raw = pd > 1e-6f ? raw : 0.f;
      float prob = invalid ? 0.f : raw * (on ? 1.f : 0.f);
      a.p_proj[m * npix + c] = prob;
      best = fmaxf(best, prob);
      bool covered = pd > 1e-6f && on;
      bool bh = covered && fd > pd + a.max_err;
      a.behind[m * npix + c] = bh;
      any_behind = any_behind || bh;
      any_cover = any_cover || covered;
    }
  }
  float outlier = (invalid || any_behind || !any_cover) ? 0.f : 1.0f - best;
  a.p_proj[a.M * npix + c] = fd > 1e-6f ? outlier : 0.f;
}

// the block's cell of each of a thread's UN_TRACKS tracks from t0 (-1: the
// track is not valid or its cell is another block's); every flag and
// position is loaded before any is used (one round of loads)
__device__ inline void locate_tracks(const UnArgs& a, int t0, int c0, int* local) {
  bool v[UN_TRACKS];
  float px[UN_TRACKS], py[UN_TRACKS];
#pragma unroll
  for (int k = 0; k < UN_TRACKS; ++k) {
    const int t = t0 + k * UN_T + threadIdx.x;
    const bool in = t < a.T;
    v[k] = in && a.valid[t];
    px[k] = in ? a.xy[2 * t] : 0.f;
    py[k] = in ? a.xy[2 * t + 1] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < UN_TRACKS; ++k) {
    local[k] = -1;
    if (v[k]) {
      int xi = min(max(__float2int_rn(px[k] * a.scale), 0), a.wc - 1);
      int yi = min(max(__float2int_rn(py[k] * a.scale), 0), a.hc - 1);
      int l = yi * a.wc + xi - c0;
      if (l >= 0 && l < UN_C) local[k] = l;
    }
  }
}

// track t's velocity errors under the active models m0 .. m0 + UN_MODELS - 1
__device__ inline void load_velocities(const UnArgs& a, unsigned act, int t, int m0, float* v) {
#pragma unroll
  for (int k = 0; k < UN_MODELS; ++k)
    v[k] = m0 + k < a.M && (act >> (m0 + k) & 1u) ? a.vel[(m0 + k) * a.T + t] : 0.f;
}

// track t, whose cell is the block's cell `local`: its error per label (0 or
// 1) min'd into the block's rows (int atomicMin on the float's bits: exact for
// non-negative floats, order-free). v holds its first UN_MODELS velocities
// (loaded by the caller); the others are loaded UN_MODELS at a time, each
// chunk before any atomic
__device__ inline void track_errors(const UnArgs& a, unsigned act, int t, int local, int* err,
                                    float* v) {
  unsigned over = 0u;  // bit m: active model m's velocity error above the threshold
  bool fits_any = false, known = true;
  for (int m0 = 0; m0 < a.M; m0 += UN_MODELS) {
    if (m0 > 0) load_velocities(a, act, t, m0, v);
#pragma unroll
    for (int k = 0; k < UN_MODELS; ++k) {
      const int m = m0 + k;
      if (m >= a.M || !(act >> m & 1u)) continue;
      over |= (v[k] > a.thr ? 1u : 0u) << m;
      fits_any = fits_any || v[k] < a.thr;
      known = known && isfinite(v[k]);
    }
  }
  for (int m = 0; m < a.M; ++m)
    if (act >> m & 1u) atomicMin(&err[m * UN_C + local], fbits(over >> m & 1u ? 1.f : 0.f));
  if (a.allow_new && known) atomicMin(&err[a.M * UN_C + local], fbits(fits_any ? 1.f : 0.f));
}

__global__ void __launch_bounds__(UN_T) unaries_kernel(UnArgs a) {
  // [M + 1][UN_C] the block's sparse-error rows, then a round's list of the
  // tracks whose cell is the block's (track * UN_C + cell, UN_T * UN_TRACKS)
  extern __shared__ int err[];
  __shared__ int n_list;
  const int npix = a.hc * a.wc, L = a.M + 1;
  const int c0 = blockIdx.x * UN_C, c = c0 + threadIdx.x;
  const bool cell = threadIdx.x < UN_C && c < npix;  // the thread has a cell
  // every load of the first round in flight together: lane m of every warp
  // reads model m's active flag (M < 32), the cell's depths, the first
  // tracks' flags and positions
  const int lane = threadIdx.x & 31;
  const bool my_active = lane < a.M && a.active[lane];
  float fd = 0.f, pds[UN_MODELS];
  if (cell) load_cell(a, c, npix, fd, pds);
  int local[UN_TRACKS];
  locate_tracks(a, 0, c0, local);
  const unsigned act = __ballot_sync(0xffffffffu, my_active);  // bit m: model m is active
  if (threadIdx.x < UN_C)
    for (int l = 0; l < L; ++l) err[l * UN_C + threadIdx.x] = fbits(INFINITY);
  if (threadIdx.x == 0) n_list = 0;
  __syncthreads();
  // every valid track whose cell is one of the block's: each round lists the
  // located tracks, then the block's threads take the list's entries in turn
  // (a thread's located tracks, often clustered, spread over the block)
  int* list = err + L * UN_C;
  for (int t0 = 0;;) {
#pragma unroll
    for (int k = 0; k < UN_TRACKS; ++k)
      if (local[k] >= 0)
        list[atomicAdd(&n_list, 1)] = (t0 + k * UN_T + threadIdx.x) * UN_C + local[k];
    __syncthreads();
    const int n = n_list;
    // the thread's first entry's velocities, then (first round) the cell's
    // rows while they fly (neither touches the error rows)
    const int first = threadIdx.x < n ? list[threadIdx.x] : -1;
    float v[UN_MODELS];
    if (first >= 0) load_velocities(a, act, first / UN_C, 0, v);
    if (t0 == 0 && cell) cell_rows(a, act, c, npix, fd, pds);
    if (first >= 0) track_errors(a, act, first / UN_C, first % UN_C, err, v);
    for (int i = threadIdx.x + UN_T; i < n; i += UN_T) {
      load_velocities(a, act, list[i] / UN_C, 0, v);
      track_errors(a, act, list[i] / UN_C, list[i] % UN_C, err, v);
    }
    t0 += UN_T * UN_TRACKS;
    if (t0 >= a.T) break;
    __syncthreads();  // every thread has read the list
    if (threadIdx.x == 0) n_list = 0;
    locate_tracks(a, t0, c0, local);
    __syncthreads();
  }
  __syncthreads();
  if (!cell) return;
  // softmax of -errors (the sum in label order) -> -log; a cell no track
  // reached (every error +inf: the sum is 0) is uniform
  const int* e = err + threadIdx.x;
  float esum = 0.f;
  for (int l = 0; l < L; ++l) esum = esum + expf(-__int_as_float(e[l * UN_C]));
  const float uniform = (float)(1.0 / (double)L);
  for (int l = 0; l < L; ++l) {
    const float pl = esum > 0.f ? expf(-__int_as_float(e[l * UN_C])) / fmaxf(esum, 1e-12f)
                                : uniform;
    a.unary[l * npix + c] = -logf(fmaxf(pl, 1e-12f));
  }
}

__global__ void fuse(const float* __restrict__ q, const float* __restrict__ flow,
                     const float* __restrict__ p_proj, const bool* __restrict__ behind,
                     const bool* __restrict__ active, int M, int npix, int allow_new,
                     float ramp_lo, float ramp_span, float min_claim, int* __restrict__ lbl,
                     bool* __restrict__ stack) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= npix) return;
  float fx = flow[2 * c], fy = flow[2 * c + 1];
  float magn = sqrtf(fx * fx + fy * fy);
  float ramp = fminf(fmaxf((magn - ramp_lo) / ramp_span, 0.0f), 1.0f);
  int arg = 0;
  float best_b = -INFINITY, best = -INFINITY;
  for (int l = 0; l <= M; ++l) {
    float p_flow = q[l * npix + c] * ramp;
    float pp = p_proj[l * npix + c];
    pp = pp < 0.3f ? 0.f : pp;
    float prob = 1.0f - (1.0f - p_flow) * (1.0f - pp);
    if (l >= 1 && l < M && behind[l * npix + c]) prob = 0.f;
    bool ok = l < M ? active[l] : (allow_new != 0);
    prob = ok ? prob : -1.0f;
    float bias = l < M ? 0.02f * (float)l : 0.f;
    float v = prob - bias;
    if (v > best_b) {
      best_b = v;
      arg = l;
    }
    best = fmaxf(best, prob);
  }
  if (arg > 0 && best < min_claim) arg = 0;
  lbl[c] = arg;
  for (int l = 1; l <= M; ++l) stack[(l - 1) * npix + c] = arg == l;
}

// ---------------------------------------------------------------- finish

constexpr int FIN_C = 16;              // blocks of the finish's cluster
constexpr int FIN_T = 1024;            // threads a block, and the statistics' partials
constexpr int FIN_VT = FIN_T / FIN_C;  // partials a block owns: t = b + FIN_C * i
constexpr size_t MAX_SMEM = 232448;    // a block's shared memory on an H100
constexpr size_t FIN_STATIC = 16 * 1024;  // room left for the kernel's static shared memory
constexpr unsigned FULL = 0xffffffffu;
static_assert(FIN_VT == 64, "a lane sums the partials i and i + 32 of its block");

struct FinishArgs {
  const int* lbl;
  const bool* largest;
  const int* sizes;
  const float* fd;
  int M, hc, wc, H, W, allow_new, min_cells, border;
  float min_frac, scale_w, scale;
  int k;     // pixels a cell where the grid divides the image evenly, else 0
  int band;  // cell rows of the largest band
  int nk;    // cells a partial sums at most: ceil(hc * wc / FIN_T)
  int* mask;
  bool* new_mask;
  bool* has_new;
  int* pix_counts;
  float* mean;
  float* std;
};

__device__ inline void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the cell row (column) of pixel row (column) y: k pixels a cell, or (k = 0)
// the nearest cell at the scale, clamped to the nc cells
__device__ inline int cell_of(int y, int k, int nc, float scale) {
  if (k > 0) return y / k;
  return min(max((int)((float)y * scale), 0), nc - 1);
}

// the first of n pixel rows whose cell row is >= r, else n (cell_of is
// monotone)
__device__ inline int first_row(int r, int n, int k, int nc, float scale) {
  if (k > 0) return min(r * k, n);
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cell_of(mid, 0, nc, scale) >= r) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// a cell of a statistics partial: its depth, and its segment id (-1 where
// the depth is invalid or no cell)
struct Cell {
  float d;
  int key;
};

// the statistics' sums of one lane in contract order: its partials i = lane
// and lane + 32 (t = b + 16 i and t + 512), each over its cells in ascending
// order, then red[t] + red[t + 512] and the shuffle levels 256 ... 16
__device__ inline void lane_sums(const Cell* cells, int nk, int l, bool clip, float lo, float hi,
                                 float& s0, float& s1, float& s2) {
  const int lane = threadIdx.x & 31;
  float u0 = 0.f, u1 = 0.f, u2 = 0.f;
  s0 = s1 = s2 = 0.f;
#pragma unroll 4
  for (int k = 0; k < nk; ++k) {
    const Cell ca = cells[k * FIN_VT + lane], cb = cells[k * FIN_VT + lane + 32];
    const float da = ca.d, db = cb.d;
    bool sa = ca.key == l, sb = cb.key == l;
    if (clip) {
      sa = sa && da >= lo && da <= hi;
      sb = sb && db >= lo && db <= hi;
    }
    if (sa) {
      s0 = s0 + 1.f;
      s1 = s1 + da;
      s2 = s2 + da * da;
    }
    if (sb) {
      u0 = u0 + 1.f;
      u1 = u1 + db;
      u2 = u2 + db * db;
    }
  }
  s0 = s0 + u0;
  s1 = s1 + u1;
  s2 = s2 + u2;
  for (int o = 16; o > 0; o >>= 1) {
    s0 = s0 + __shfl_down_sync(FULL, s0, o);
    s1 = s1 + __shfl_down_sync(FULL, s1, o);
    s2 = s2 + __shfl_down_sync(FULL, s2, o);
  }
}

// the levels 8 ... 1 over the blocks' results (lane j: block j's), then the
// statistics of lane 0's sums
__device__ inline void cluster_levels(float& v0, float& v1, float& v2, float& mu, float& sd) {
  for (int o = FIN_C / 2; o > 0; o >>= 1) {
    v0 = v0 + __shfl_down_sync(FULL, v0, o);
    v1 = v1 + __shfl_down_sync(FULL, v1, o);
    v2 = v2 + __shfl_down_sync(FULL, v2, o);
  }
  const float n = fmaxf(v0, 1.0f);
  mu = v1 / n;
  const float var = v2 / n - mu * mu;
  sd = sqrtf(fmaxf(var, 0.0f));
}

__global__ void __launch_bounds__(FIN_T, 1) finish_kernel(FinishArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char fsm[];
  __shared__ int wred[32][5];
  __shared__ int part[FIN_C][5];        // every block's global-cell count and box (block 0)
  __shared__ float red1[FIN_C][32][3];  // pass 1: every block's tree result, per segment
  __shared__ float red2[FIN_C][32][3];  // pass 2: every block's, in block 0
  const int b = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = a.M, hc = a.hc, wc = a.wc, npix = hc * wc;
  Cell* cells = reinterpret_cast<Cell*>(fsm);                            // [nk][FIN_VT]
  float* fd_own = reinterpret_cast<float*>(cells + a.nk * FIN_VT);       // [band * wc]
  signed char* seg_own = reinterpret_cast<signed char*>(fd_own + a.band * wc);  // [band * wc]

  // the block's partials' cells (pushed by the blocks whose bands hold
  // them): none until pushed
  for (int e = tid; e < a.nk * FIN_VT; e += FIN_T) cells[e] = Cell{0.f, -1};
  cluster_arrive();  // barrier 0: every block runs, its cells cleared

  // 1. the block's band of cell rows: segment ids and depth into shared
  //    memory, the count of global cells and the new label's box
  const int r0 = b * hc / FIN_C, r1 = (b + 1) * hc / FIN_C;
  const int c0 = r0 * wc, c1 = r1 * wc;
  // the labels past the minimum-cells gate (the new label always)
  const unsigned gates =
      __ballot_sync(FULL, lane >= 1 && lane < M && a.sizes[lane - 1] >= a.min_cells) | (1u << M);
  int v[5] = {0, hc, 1, wc, 1};  // count, top, -bottom, left, -right
  for (int c2 = c0 + 2 * tid; c2 < c1; c2 += 2 * FIN_T) {  // two cells a thread
    const bool two = c2 + 1 < c1;
    int lb[2] = {a.lbl[c2], two ? a.lbl[c2 + 1] : 1};
    const float d0 = a.fd[c2], d1 = two ? a.fd[c2 + 1] : 0.f;
    unsigned bits[2] = {0u, 0u};  // the labels whose kept component holds the cell
#pragma unroll 8
    for (int l = 1; l <= M; ++l) {
      bits[0] |= (unsigned)a.largest[(l - 1) * npix + c2] << l;
      if (two) bits[1] |= (unsigned)a.largest[(l - 1) * npix + c2 + 1] << l;
    }
    fd_own[c2 - c0] = d0;
    if (two) fd_own[c2 + 1 - c0] = d1;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q == 1 && !two) break;
      const int c = c2 + q;
      // the segment id: the highest gated label whose kept component holds
      // the cell, else 0 on a global cell, else -1
      const unsigned kept = bits[q] & gates;
      seg_own[c - c0] = (signed char)(kept ? 31 - __clz(kept) : (lb[q] == 0 ? 0 : -1));
      v[0] += lb[q] == 0;
      if ((bits[q] >> M) & 1u) {
        const int y = c / wc, x = c - y * wc;
        v[1] = min(v[1], y);
        v[2] = min(v[2], -y);
        v[3] = min(v[3], x);
        v[4] = min(v[4], -x);
      }
    }
  }
  v[0] = __reduce_add_sync(FULL, v[0]);
  for (int k = 1; k < 5; ++k) v[k] = __reduce_min_sync(FULL, v[k]);
  if (lane == 0)
    for (int k = 0; k < 5; ++k) wred[warp][k] = v[k];
  __syncthreads();
  cluster_wait();
  if (warp == 0) {  // the band's count and box, to block 0
    int w[5];
    for (int k = 0; k < 5; ++k) w[k] = wred[lane][k];
    w[0] = __reduce_add_sync(FULL, w[0]);
    for (int k = 1; k < 5; ++k) w[k] = __reduce_min_sync(FULL, w[k]);
    if (lane < 5) cluster.map_shared_rank(&part[b][0], 0)[lane] = w[lane];
  }
  // each cell of the band to its partial t = c mod 1024 in block t mod 16,
  // entry (c / 1024, t / 16); -1 where the depth is invalid
  for (int c = c0 + tid; c < c1; c += FIN_T) {
    const float d = fd_own[c - c0];
    const int e = (c >> 10) * FIN_VT + ((c & (FIN_T - 1)) >> 4);
    cluster.map_shared_rank(cells, (unsigned)(c & (FIN_C - 1)))[e] =
        Cell{d, d > 1e-6f ? (int)seg_own[c - c0] : -1};
  }
  cluster_arrive();  // barrier 1: every partial's cells pushed

  // 2. the upsample of the band's pixel rows, a warp a row, from the
  //    band's own segment ids, while the other blocks arrive
  {
    const int W = a.W, k = a.k;
    const int y0 = first_row(r0, a.H, k, hc, a.scale), y1 = first_row(r1, a.H, k, hc, a.scale);
    for (int y = y0 + warp; y < y1; y += FIN_T / 32) {
      const signed char* row = seg_own + (cell_of(y, k, hc, a.scale) - r0) * wc;
      int* mrow = a.mask + (size_t)y * W;
      bool* nrow = a.new_mask + (size_t)y * W;
      if (k == 4) {  // a cell's four pixels: one 16-byte and one 4-byte store
        for (int cx = lane; cx < wc; cx += 32) {
          const int s = row[cx];
          const int m = (s < 0 || s == M) ? 0 : s;
          *reinterpret_cast<int4*>(mrow + 4 * cx) = make_int4(m, m, m, m);
          *reinterpret_cast<unsigned*>(nrow + 4 * cx) = s == M ? 0x01010101u : 0u;
        }
      } else {
        for (int x = lane; x < W; x += 32) {
          const int s = row[cell_of(x, k, wc, a.scale)];
          nrow[x] = s == M;
          mrow[x] = (s < 0 || s == M) ? 0 : s;
        }
      }
    }
  }
  cluster_wait();

  // has_new and the pixel counts: block 0, a warp without a segment
  if (b == 0 && warp == (M < 31 ? 31 : 0)) {
    int w[5] = {0, hc, 1, wc, 1};
    if (lane < FIN_C)
      for (int k = 0; k < 5; ++k) w[k] = part[lane][k];
    w[0] = __reduce_add_sync(FULL, w[0]);
    for (int k = 1; k < 5; ++k) w[k] = __reduce_min_sync(FULL, w[k]);
    const int border = a.border;
    const int t = w[1], bt = -w[2], l = w[3], r = -w[4];
    if (lane == 0) {
      const bool at_border = (t < border && bt < border) || (l < border && r < border) ||
                             (t > hc - 1 - border && bt > hc - 1 - border) ||
                             (l > wc - 1 - border && r > wc - 1 - border);
      const float frac = (float)a.sizes[M - 1] / (float)npix;
      *a.has_new = a.allow_new && frac > a.min_frac && !at_border;
      a.pix_counts[0] = (int)((float)w[0] * a.scale_w);
    }
    for (int m = 1 + lane; m < M; m += 32) {
      const int cnt = a.sizes[m - 1] >= a.min_cells ? a.sizes[m - 1] : 0;
      a.pix_counts[m] = (int)((float)cnt * a.scale_w);
    }
  }

  // 3. both passes of the depth statistics, warp l for segment l; each
  //    block's tree results pushed (pass 1 to every block, pass 2 to block 0)
  const int l = warp;
  const bool seg = l <= M;
  float s0, s1, s2, lo = 0.f, hi = 0.f;
  if (seg) {
    lane_sums(cells, a.nk, l, false, 0.f, 0.f, s0, s1, s2);
    s0 = __shfl_sync(FULL, s0, 0);
    s1 = __shfl_sync(FULL, s1, 0);
    s2 = __shfl_sync(FULL, s2, 0);
    if (lane < FIN_C) {
      float* p = cluster.map_shared_rank(&red1[b][l][0], lane);
      p[0] = s0;
      p[1] = s1;
      p[2] = s2;
    }
  }
  cluster.sync();  // barrier 2: every block's pass-1 results in every block
  if (seg) {
    float v0 = 0.f, v1 = 0.f, v2 = 0.f, mu, sd;
    if (lane < FIN_C) {
      v0 = red1[lane][l][0];
      v1 = red1[lane][l][1];
      v2 = red1[lane][l][2];
    }
    cluster_levels(v0, v1, v2, mu, sd);
    const float band = fmaxf(1.2f * sd, 0.05f);
    lo = __shfl_sync(FULL, mu - band, 0);
    hi = __shfl_sync(FULL, mu + band, 0);
    lane_sums(cells, a.nk, l, true, lo, hi, s0, s1, s2);
    if (lane == 0) {
      float* p = cluster.map_shared_rank(&red2[b][l][0], 0);
      p[0] = s0;
      p[1] = s1;
      p[2] = s2;
    }
  }
  cluster.sync();  // barrier 3: every block's pass-2 results in block 0
  if (b == 0 && seg) {
    float v0 = 0.f, v1 = 0.f, v2 = 0.f, mu, sd;
    if (lane < FIN_C) {
      v0 = red2[lane][l][0];
      v1 = red2[lane][l][1];
      v2 = red2[lane][l][2];
    }
    cluster_levels(v0, v1, v2, mu, sd);
    if (lane == 0) {
      a.mean[l] = mu;
      a.std[l] = sd;
    }
  }
}

inline int blocks(int n) { return (n + TB - 1) / TB; }

}  // namespace

extern "C" int mmf_seg_unaries(const float* depth, int H, int W, const float* pred, int M, int hc,
                               int wc, const bool* active, const float* xy, const float* vel,
                               const bool* valid, int T, float scale, float thr, int allow_new,
                               float max_err, float* fdc, float* p_proj, bool* behind,
                               float* unary, cudaStream_t stream) {
  if (M > MAX_M || hc < 1 || wc < 1) return (int)cudaErrorInvalidValue;
  const int npix = hc * wc;
  // at most (MAX_M + 1) * UN_C + UN_T * UN_TRACKS ints: 36.9 KB
  const size_t smem = ((size_t)(M + 1) * UN_C + UN_T * UN_TRACKS) * sizeof(int);
  UnArgs a{depth, H, W, pred, M, hc, wc, active, xy, vel, valid, T, scale, thr, allow_new,
           max_err, fdc, p_proj, behind, unary};
  unaries_kernel<<<(npix + UN_C - 1) / UN_C, UN_T, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mmf_seg_fuse(const float* q, const float* flow, const float* p_proj,
                            const bool* behind, const bool* active, int M, int hc, int wc,
                            int allow_new, float ramp_lo, float ramp_span, float min_claim,
                            int* lbl, bool* stack, cudaStream_t stream) {
  if (M > MAX_M) return (int)cudaErrorInvalidValue;
  int npix = hc * wc;
  fuse<<<blocks(npix), TB, 0, stream>>>(q, flow, p_proj, behind, active, M, npix, allow_new,
                                        ramp_lo, ramp_span, min_claim, lbl, stack);
  return (int)cudaGetLastError();
}

extern "C" int mmf_seg_finish(const int* lbl, const bool* largest, const int* sizes,
                              const float* fd, int M, int hc, int wc, int H, int W, int allow_new,
                              int min_cells, int border, float min_frac, float scale_w,
                              float scale, int* mask, bool* new_mask, bool* has_new,
                              int* pix_counts, float* mean, float* std, cudaStream_t stream) {
  if (M < 1 || M > MAX_M || hc < 1 || wc < 1) return (int)cudaErrorInvalidValue;
  const int npix = hc * wc;
  const bool integer = H == hc * (H / hc) && W == wc * (W / wc) && H / hc == W / wc;
  FinishArgs a{lbl, largest, sizes, fd, M, hc, wc, H, W, allow_new, min_cells, border,
               min_frac, scale_w, scale, integer ? H / hc : 0, (hc + FIN_C - 1) / FIN_C,
               (npix + FIN_T - 1) / FIN_T, mask, new_mask, has_new, pix_counts, mean, std};
  const size_t smem =
      (size_t)a.nk * FIN_VT * sizeof(Cell) + (size_t)a.band * wc * (sizeof(float) + 1);
  if (smem > MAX_SMEM - FIN_STATIC) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(finish_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(FIN_C);
  cfg.blockDim = dim3(FIN_T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = FIN_C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, finish_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
