// K7 + K9 clean: the map's culls and its order-preserving compaction.
//
// Replaces: multimotionfusion_tpu/ops/rasterize.py:58 gather_attr_images (fused
//   into the pixel pass), model/fusion.py:239 clean, and model/surfel_map.py:178
//   compact (also behind :126 init_from_frame).
// Bound on an H100: bytes. The pixel pass reads the index map, a 4x4 window
//   of winners (their attributes from data_local, mostly L2 hits) and a 3x3
//   window of depth; the surfel pass reads and writes each [16, B] column
//   once; the compaction reads the kept columns and writes the packed map.
// Design:
//   - pixel pass: one thread per pixel reads its winner's attributes straight
//     from data_local by index (no [16, H, W] attribute image), counts the
//     redundant and z-ordered neighbours of the 4x4 window (offsets -2..+1),
//     the see-through violations of the 3x3 depth window and the mask
//     penalty, and scatter-mins its verdict (-1 = cull vote, else the
//     confidence penalty) into the winner's slot. Floats are mapped to
//     order-preserving ints first, so atomicMin on the int is a float min,
//     -1 included, and the result does not depend on thread order;
//   - surfel pass: one thread per slot applies the keep logic (alive, visual
//     cull, unstable age, inactive) and the penalty; between compactions it
//     writes the column with the ALIVE flag cleared where culled;
//   - compaction (every compact_every frames, and for init_from_frame):
//     per-block counts of the kept slots, one block scans the block counts
//     (the only serial step: 4096 values at 2^20 slots), then every block
//     scatters its kept columns to base + its local rank (warp ballots), so
//     the order is preserved; slots past the new count are zeroed. The new
//     count stays on the card;
//   - an optional skip flag read on the card (relocalisation's `lost`: fusion
//     is skipped while lost) stops every write to the output, which the
//     engine points at the map's own bucket, so the pre-fusion map stays.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "surfel.cuh"

constexpr int THREADS = 256;
constexpr int SCAN_THREADS = 1024;

struct PixelArgs {
  const int* index;
  const float* dl;
  int B;
  const float* depth;
  const int* mask;
  int mask_id, H, W, window;
  float time, conf_thr, gate, coeff, mask_factor;
  const float* conf_p;  // the confidence gate on the card (a per-slot gate); nullptr: conf_thr
};

__global__ void pixel_pass(PixelArgs a, int* __restrict__ vk) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.H * a.W) return;
  int i = a.index[p];
  if (i < 0) return;
  int y = p / a.W, x = p % a.W;
  int count, z_count;
  const float conf_thr = a.conf_p != nullptr ? *a.conf_p : a.conf_thr;
  window_counts(a.index, a.dl, a.B, nullptr, 0, a.H, a.W, a.window, x, y, i, conf_thr, a.time,
                &count, &z_count);
  float qz = a.dl[PZ * a.B + i];
  bool viol;
  float pen = see_through(a.depth, a.H, a.W, x, y, qz, a.gate, a.coeff, &viol);
  float dp = a.depth[p];
  bool mask_pen = viol && a.mask[p] != a.mask_id && dp > qz - 0.05f && dp < qz + 0.05f;
  if (mask_pen) pen = pen * a.mask_factor;
  bool cull = count > 8 || z_count > 4;
  atomicMin(&vk[i], ford(cull ? -1.f : pen));
}

struct SurfelArgs {
  const float* data;
  int rs_in, B;
  const int* count;
  float time, conf_thr, grace, time_delta;
  int compact;
  float* out;
  int rs_out;
  const float* conf_p;
};

__device__ inline bool keep_slot(const SurfelArgs& a, const int* vk, int i, float* pen) {
  bool alive = i < *a.count && a.data[ALIVE * a.rs_in + i] > 0.f;
  return keep_surfel(alive, vk[i], a.data[LAST_T * a.rs_in + i], a.data[CONF * a.rs_in + i],
                     a.time, a.grace, a.conf_p != nullptr ? *a.conf_p : a.conf_thr, a.time_delta,
                     pen);
}

__global__ void surfel_pass(SurfelArgs a, const int* __restrict__ vk, uint8_t* __restrict__ keep,
                            int* __restrict__ block_counts, const bool* __restrict__ skip) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool k = false;
  const bool write = skip == nullptr || !*skip;
  if (i < a.B) {
    float pen;
    k = keep_slot(a, vk, i, &pen);
    if (a.compact) {
      keep[i] = k;
    } else if (write) {
      for (int c = 0; c < CH; ++c) {
        float v = a.data[c * a.rs_in + i];
        if (c == CONF) v = v * pen;
        if (c == ALIVE && !k) v = 0.f;
        a.out[c * a.rs_out + i] = v;
      }
    }
  }
  if (a.compact) {
    int n = __syncthreads_count(k);
    if (threadIdx.x == 0) block_counts[blockIdx.x] = n;
  }
}

__global__ void count_kept(const uint8_t* __restrict__ keep, int n, int* __restrict__ block_counts) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int k = i < n ? keep[i] != 0 : 0;
  int c = __syncthreads_count(k);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
}

// exclusive scan of the block counts (fixed order) and the new count
__global__ void scan_blocks(const int* __restrict__ counts, int nb, int cap,
                            int* __restrict__ offsets, int* __restrict__ count_out) {
  __shared__ int sh[SCAN_THREADS];
  int tid = threadIdx.x;
  int chunk = (nb + SCAN_THREADS - 1) / SCAN_THREADS;
  int lo = min(tid * chunk, nb), hi = min(lo + chunk, nb);
  int s = 0;
  for (int b = lo; b < hi; ++b) s += counts[b];
  sh[tid] = s;
  __syncthreads();
  for (int off = 1; off < SCAN_THREADS; off <<= 1) {
    int v = tid >= off ? sh[tid - off] : 0;
    __syncthreads();
    sh[tid] += v;
    __syncthreads();
  }
  int run = sh[tid] - s;
  for (int b = lo; b < hi; ++b) {
    offsets[b] = run;
    run += counts[b];
  }
  if (tid == SCAN_THREADS - 1) *count_out = min(sh[tid], cap);
}

// scatter the kept columns of each block to offsets[block] + local rank, and
// zero the slots [count, cap) of the output
__global__ void scatter(const float* __restrict__ src, int rs_src, int n,
                        const uint8_t* __restrict__ keep, const int* __restrict__ vk,
                        const int* __restrict__ offsets, const int* __restrict__ count,
                        float* __restrict__ dst, int rs_dst, int cap,
                        const bool* __restrict__ skip) {
  if (skip != nullptr && *skip) return;
  __shared__ int warp_base[THREADS / 32];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool k = i < n && keep[i] != 0;
  unsigned ballot = __ballot_sync(0xffffffffu, k);
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      int c = warp_base[w];
      warp_base[w] = run;
      run += c;
    }
  }
  __syncthreads();
  if (k && blockIdx.x < (n + THREADS - 1) / THREADS) {
    int d = offsets[blockIdx.x] + warp_base[warp] + __popc(ballot & ((1u << lane) - 1u));
    if (d < cap) {
      float pen = 1.f;
      if (vk != nullptr) {
        float v = fval(vk[i]);
        pen = v < 0.f ? 1.f : v;
      }
      for (int c = 0; c < CH; ++c) {
        float v = src[c * rs_src + i];
        if (c == CONF && vk != nullptr) v = v * pen;
        dst[c * rs_dst + d] = v;
      }
    }
  }
  if (i < cap && i >= *count)
    for (int c = 0; c < CH; ++c) dst[c * rs_dst + i] = 0.f;
}

void launch_compaction(const float* src, int rs_src, int n, const uint8_t* keep, const int* vk,
                       int* block_counts, int* offsets, float* dst, int rs_dst, int cap,
                       int* count_out, const bool* skip, cudaStream_t stream) {
  int nb = (n + THREADS - 1) / THREADS;
  scan_blocks<<<1, SCAN_THREADS, 0, stream>>>(block_counts, nb, cap, offsets, count_out);
  int grid = (max(n, cap) + THREADS - 1) / THREADS;
  scatter<<<grid, THREADS, 0, stream>>>(src, rs_src, n, keep, vk, offsets, count_out, dst,
                                        rs_dst, cap, skip);
}

}  // namespace

extern "C" int mmf_clean(const float* data, int rs_in, int B, const int* count, const int* index,
                         const float* data_local, const float* depth, const int* mask,
                         int mask_id, int H, int W, int window, float time, float time_delta,
                         float conf_thr, float grace, float gate, float coeff, float mask_factor,
                         int compact, int* verdicts, uint8_t* keep, int* block_counts,
                         int* offsets, float* out, int rs_out, int* count_out,
                         const bool* skip, const float* conf_p, cudaStream_t stream) {
  fill_verdicts<<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(verdicts, B);
  PixelArgs pa{index, data_local, B, depth, mask, mask_id, H, W, window,
               time, conf_thr, gate, coeff, mask_factor, conf_p};
  pixel_pass<<<(H * W + THREADS - 1) / THREADS, THREADS, 0, stream>>>(pa, verdicts);
  SurfelArgs sa{data, rs_in, B, count, time, conf_thr, grace, time_delta, compact, out, rs_out,
                conf_p};
  surfel_pass<<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(sa, verdicts, keep,
                                                                    block_counts, skip);
  if (compact)
    launch_compaction(data, rs_in, B, keep, verdicts, block_counts, offsets, out, rs_out, B,
                      count_out, skip, stream);
  return (int)cudaGetLastError();
}

extern "C" int mmf_compact(const float* src, int rs_src, int n, const uint8_t* keep,
                           int* block_counts, int* offsets, float* dst, int rs_dst, int cap,
                           int* count_out, cudaStream_t stream) {
  count_kept<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(keep, n, block_counts);
  launch_compaction(src, rs_src, n, keep, nullptr, block_counts, offsets, dst, rs_dst, cap,
                    count_out, nullptr, stream);
  return (int)cudaGetLastError();
}
