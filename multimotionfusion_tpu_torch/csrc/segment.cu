// K18 segment: the flow-CRF's unaries, label fusion and segment finish.
//
// Replaces: multimotionfusion_tpu/segmentation/flow_crf.py:51
//   reprojection_probability, :110 sparse_unary and :155
//   flow_crf_segmentation (:212-216 the unary softmax, :231-276 the
//   posterior fusion, bias and claim floor, :278-355 the minimum-cells gate,
//   border test and nearest upsample, :372-396 the sigma-clipped statistics).
// Bound on an H100: bytes, and at these sizes the launches. Per frame the
//   [M+1, 120, 160] rows are written and read a few times (~1 MB) and the
//   640x480 mask and new-label mask are written once (1.5 MB); a few dozen
//   operations per cell.
// Design: mmf_seg_unaries enqueues (1) one thread per CRF cell: the centre
//   depth sample, every model's raw fit, the outlier row, the behind flags,
//   and the sparse-error rows set to +inf; (2) one thread per track: its
//   error per label (0, 1 or +inf) min'd into its cell by an int atomicMin
//   on the float's bits (exact for non-negative floats, order-free); (3) one
//   thread per cell: softmax of -errors (the sum in label order) -> -log.
//   mmf_seg_fuse: one thread per cell, the fusion and the first argmax of
//   prob - bias (a strict > keeps the first of equal values), the claim
//   floor, and the label stack K17 reads. mmf_seg_finish: one block writes
//   each cell's segment id once into shared memory, then sums the global
//   count, the new label's bounding box and both passes of every segment's
//   depth statistics in a fixed order (each thread its cells in order, then
//   a tree); one thread per full-resolution pixel writes the mask and the
//   new-label mask. With -fmad=false every float expression is
//   the plain version's, so labels, masks and counts equal it given equal
//   inputs; the statistics' sums run in another order (a few ulp).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_M = 31;
constexpr int TB = 256;

__device__ inline int fbits(float f) { return __float_as_int(f); }

__global__ void cells(const float* __restrict__ depth, int H, int W,
                      const float* __restrict__ pred, int M, int hc, int wc,
                      const bool* __restrict__ active, float max_err, float* __restrict__ fdc,
                      float* __restrict__ p_proj, bool* __restrict__ behind,
                      int* __restrict__ err) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  int npix = hc * wc;
  if (c >= npix) return;
  int y = c / wc, x = c - y * wc;
  int ky = H / hc, kx = W / wc;
  float fd = depth[(y * ky + ky / 2) * W + x * kx + kx / 2];
  fdc[c] = fd;
  bool invalid = false;
  for (int m = 0; m < M; ++m) invalid = invalid || (fd < 1e-6f && pred[m * npix + c] < 1e-6f);
  float best = -INFINITY;
  bool any_behind = false, any_cover = false;
  for (int m = 0; m < M; ++m) {
    float pd = pred[m * npix + c];
    float raw = expf(-fabsf(fd - pd) / max_err);
    raw = pd > 1e-6f ? raw : 0.f;
    float prob = invalid ? 0.f : raw * (active[m] ? 1.f : 0.f);
    p_proj[m * npix + c] = prob;
    best = fmaxf(best, prob);
    bool covered = pd > 1e-6f && active[m];
    bool bh = covered && fd > pd + max_err;
    behind[m * npix + c] = bh;
    any_behind = any_behind || bh;
    any_cover = any_cover || covered;
  }
  float outlier = (invalid || any_behind || !any_cover) ? 0.f : 1.0f - best;
  p_proj[M * npix + c] = fd > 1e-6f ? outlier : 0.f;
  for (int l = 0; l <= M; ++l) err[l * npix + c] = fbits(INFINITY);
}

__global__ void tracks(const float* __restrict__ xy, const float* __restrict__ vel,
                       const bool* __restrict__ valid, const bool* __restrict__ active, int T,
                       int M, int hc, int wc, float scale, float thr, int allow_new,
                       int* __restrict__ err) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T || !valid[t]) return;
  int npix = hc * wc;
  int xi = min(max(__float2int_rn(xy[2 * t] * scale), 0), wc - 1);
  int yi = min(max(__float2int_rn(xy[2 * t + 1] * scale), 0), hc - 1);
  int c = yi * wc + xi;
  bool fits_any = false, known = true;
  for (int m = 0; m < M; ++m) {
    float v = vel[m * T + t];
    if (active[m]) {
      atomicMin(&err[m * npix + c], fbits(v > thr ? 1.f : 0.f));
      fits_any = fits_any || v < thr;
      known = known && isfinite(v);
    }
  }
  if (allow_new && known) atomicMin(&err[M * npix + c], fbits(fits_any ? 1.f : 0.f));
}

__global__ void softmax_unary(const int* __restrict__ err, int L, int npix,
                              float* __restrict__ unary) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= npix) return;
  float e[MAX_M + 1], esum = 0.f;
  for (int l = 0; l < L; ++l) {
    e[l] = expf(-__int_as_float(err[l * npix + c]));
    esum = esum + e[l];
  }
  float uniform = (float)(1.0 / (double)L);
  for (int l = 0; l < L; ++l) {
    float p = esum > 0.f ? e[l] / fmaxf(esum, 1e-12f) : uniform;
    unary[l * npix + c] = -logf(fmaxf(p, 1e-12f));
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

// the segment id of a cell: 0 global, l on label l's kept component (object
// labels only where their component passed the minimum-cells gate), else -1
__device__ inline int segm_of(const int* __restrict__ lbl, const bool* __restrict__ largest,
                              const int* __restrict__ sizes, int M, int npix, int min_cells,
                              int c) {
  int s = lbl[c] == 0 ? 0 : -1;
  for (int l = 1; l <= M; ++l) {
    bool gate = l == M || sizes[l - 1] >= min_cells;
    if (largest[(l - 1) * npix + c] && gate) s = l;
  }
  return s;
}

__global__ void upsample(const int* __restrict__ lbl, const bool* __restrict__ largest,
                         const int* __restrict__ sizes, int M, int hc, int wc, int H, int W,
                         int min_cells, float scale, int* __restrict__ mask,
                         bool* __restrict__ new_mask) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  int y = i / W, x = i - y * W;
  int cy, cx;
  if (H == hc * (H / hc) && W == wc * (W / wc) && H / hc == W / wc) {
    cy = y / (H / hc);
    cx = x / (W / wc);
  } else {
    cy = min(max((int)((float)y * scale), 0), hc - 1);
    cx = min(max((int)((float)x * scale), 0), wc - 1);
  }
  int s = segm_of(lbl, largest, sizes, M, hc * wc, min_cells, cy * wc + cx);
  new_mask[i] = s == M;
  mask[i] = (s < 0 || s == M) ? 0 : s;
}

// one block: the global count, the new label's bounding box, has_new, the
// pixel counts and both passes of the depth statistics; every cell's
// segment id is computed once into shared memory (int8: M <= 31)
__global__ void stats(const int* __restrict__ lbl, const bool* __restrict__ largest,
                      const int* __restrict__ sizes, const float* __restrict__ fd, int M,
                      int hc, int wc, int allow_new, int min_cells, int border, float min_frac,
                      float scale_w, bool* __restrict__ has_new, int* __restrict__ pix_counts,
                      float* __restrict__ mean, float* __restrict__ std) {
  constexpr int NT = 1024;
  constexpr int NS = MAX_M + 1;
  extern __shared__ signed char seg[];
  __shared__ float red[3][NT];
  __shared__ int ired[NT];
  __shared__ float lo[NS], hi[NS];
  __shared__ int count0, box[4];
  const int npix = hc * wc;
  const int tid = threadIdx.x;

  // the segment ids, the global count and the new label's bounding box
  int c0 = 0, top = hc, bottom = -1, left = wc, right = -1;
  for (int c = tid; c < npix; c += NT) {
    seg[c] = (signed char)segm_of(lbl, largest, sizes, M, npix, min_cells, c);
    c0 += lbl[c] == 0;
    if (largest[(M - 1) * npix + c]) {
      int y = c / wc, x = c - y * wc;
      top = min(top, y);
      bottom = max(bottom, y);
      left = min(left, x);
      right = max(right, x);
    }
  }
  const int vals[5] = {c0, top, -bottom, left, -right};
  for (int k = 0; k < 5; ++k) {
    ired[tid] = vals[k];
    __syncthreads();
    for (int s = NT / 2; s > 0; s >>= 1) {
      if (tid < s) ired[tid] = k == 0 ? ired[tid] + ired[tid + s] : min(ired[tid], ired[tid + s]);
      __syncthreads();
    }
    if (tid == 0) {
      if (k == 0) count0 = ired[0];
      else box[k - 1] = (k == 2 || k == 4) ? -ired[0] : ired[0];
    }
    __syncthreads();
  }
  if (tid == 0) {
    int t = box[0], b = box[1], l = box[2], r = box[3];
    bool at_border = (t < border && b < border) || (l < border && r < border) ||
                     (t > hc - 1 - border && b > hc - 1 - border) ||
                     (l > wc - 1 - border && r > wc - 1 - border);
    float frac = (float)sizes[M - 1] / (float)npix;
    *has_new = allow_new && frac > min_frac && !at_border;
    pix_counts[0] = (int)((float)count0 * scale_w);
    for (int m = 1; m < M; ++m) {
      int cnt = sizes[m - 1] >= min_cells ? sizes[m - 1] : 0;
      pix_counts[m] = (int)((float)cnt * scale_w);
    }
  }
  __syncthreads();

  // depth statistics of segments 0..M, two passes: sums per segment in cell
  // order per thread, then one tree over the threads for all three sums
  for (int pass = 0; pass < 2; ++pass) {
    for (int l = 0; l <= M; ++l) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;  // count, sum, sum of squares
      for (int c = tid; c < npix; c += NT) {
        float d = fd[c];
        bool sel = seg[c] == l && d > 1e-6f;
        if (pass == 1) sel = sel && d >= lo[l] && d <= hi[l];
        if (sel) {
          s0 = s0 + 1.f;
          s1 = s1 + d;
          s2 = s2 + d * d;
        }
      }
      red[0][tid] = s0;
      red[1][tid] = s1;
      red[2][tid] = s2;
      __syncthreads();
      for (int st = NT / 2; st > 0; st >>= 1) {
        if (tid < st)
          for (int k = 0; k < 3; ++k) red[k][tid] = red[k][tid] + red[k][tid + st];
        __syncthreads();
      }
      if (tid == 0) {
        float n = fmaxf(red[0][0], 1.0f);
        float mu = red[1][0] / n;
        float var = red[2][0] / n - mu * mu;
        float sd = sqrtf(fmaxf(var, 0.0f));
        if (pass == 0) {
          float band = fmaxf(1.2f * sd, 0.05f);
          lo[l] = mu - band;
          hi[l] = mu + band;
        } else {
          mean[l] = mu;
          std[l] = sd;
        }
      }
      __syncthreads();
    }
  }
}

inline int blocks(int n) { return (n + TB - 1) / TB; }

}  // namespace

extern "C" int mmf_seg_unaries(const float* depth, int H, int W, const float* pred, int M, int hc,
                               int wc, const bool* active, const float* xy, const float* vel,
                               const bool* valid, int T, float scale, float thr, int allow_new,
                               float max_err, float* fdc, float* p_proj, bool* behind, float* err,
                               float* unary, cudaStream_t stream) {
  if (M > MAX_M) return (int)cudaErrorInvalidValue;
  int npix = hc * wc;
  int* ierr = reinterpret_cast<int*>(err);
  cells<<<blocks(npix), TB, 0, stream>>>(depth, H, W, pred, M, hc, wc, active, max_err, fdc,
                                         p_proj, behind, ierr);
  if (T > 0)
    tracks<<<blocks(T), TB, 0, stream>>>(xy, vel, valid, active, T, M, hc, wc, scale, thr,
                                         allow_new, ierr);
  softmax_unary<<<blocks(npix), TB, 0, stream>>>(ierr, M + 1, npix, unary);
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
  if (M > MAX_M) return (int)cudaErrorInvalidValue;
  int seg_bytes = hc * wc;
  if (seg_bytes > 48 * 1024)
    cudaFuncSetAttribute(stats, cudaFuncAttributeMaxDynamicSharedMemorySize, seg_bytes);
  stats<<<1, 1024, seg_bytes, stream>>>(lbl, largest, sizes, fd, M, hc, wc, allow_new, min_cells,
                                        border, min_frac, scale_w, has_new, pix_counts, mean, std);
  upsample<<<blocks(H * W), TB, 0, stream>>>(lbl, largest, sizes, M, hc, wc, H, W, min_cells,
                                             scale, mask, new_mask);
  return (int)cudaGetLastError();
}
