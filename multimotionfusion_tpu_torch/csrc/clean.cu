// K7 + K9 clean: the map's culls and its order-preserving compaction.
//
// Replaces: multimotionfusion_tpu/ops/rasterize.py:58 gather_attr_images (fused
//   into the pixel pass), model/fusion.py:239 clean, and model/surfel_map.py:178
//   compact (also behind :126 init_from_frame, and the multi-model engine's
//   repack of every segment of the flat store, engine_multi.py:1099,1107).
// Bound on an H100: bytes. The pixel pass reads the index map, each staged
//   winner's channels once, the depth and the mask; the surfel pass reads
//   three channels of every slot and writes the [16, B] map (a copy) or only
//   the values that change (in place); the compaction reads the kept columns
//   and writes the packed map.
// Design:
//   - the verdicts are a persistent per-device scratch (fusion.py's
//     verdict_scratch), ford(1.0f) between calls: the pixel pass scatter-mins
//     into it and the pass that reads a slot's verdict (the surfel pass or
//     the compaction) sets it back, so no launch fills it. One stream at a
//     time;
//   - pixel pass (K14's, csrc/fuse_flat.cu): a 256-thread block owns a
//     32 x 8 pixel tile and stages it widened by the window's halo; one
//     thread gathers each staged winner's position and times once and folds
//     the confidence gate (scalar, or by pointer for a slot) into the staged
//     key, and every pixel counts the redundant and z-ordered neighbours of
//     its window (offsets -window/2 ..) from shared memory (surfel.cuh's
//     window_counts_staged; the engine's 4x4 window compiled with the loop
//     unrolled). The 3x3 see-through penalty and the mask penalty stay per
//     pixel. Its verdict (-1 = cull vote, else the confidence penalty) goes
//     to the winner's slot by an atomicMin on the order-preserving int
//     (surfel.cuh's ford), so the result does not depend on thread order;
//   - surfel pass (flag frames): one thread per slot applies the keep logic
//     (alive, visual cull, unstable age, inactive) and the penalty. Into
//     another map it writes CONF * pen and ALIVE (cleared where culled) and
//     copies seven more channels; the other seven are copied by copy blocks
//     that run in the pixel pass's launch (before its tiles, 2,048 columns a
//     block, eight loads in flight a thread), where half the copy overlaps
//     the latency-bound pixel tiles. On the map it read (out == data: the
//     caller gives its input as the output) it writes CONF only where the
//     penalty is not 1 or CONF is a NaN (x * 1.0f is x, but for a NaN's
//     payload) and ALIVE (+0) only where the slot is not kept and ALIVE is
//     not +0, as K14's clean;
//   - compaction (every compact_every frames, init_from_frame, and the
//     multi-model repack of the global segment and every slot segment in
//     one launch): one tile of 1,024 slots a block (four sub-tiles of 256:
//     300 tiles at the first frame's 307,200 columns, 384 at the static
//     map's 393,216), the keep computed in the kernel (the four flags'
//     loads issued together), a single-pass decoupled look-back scan over the
//     tiles with scan.cuh's status words (integer counts, so the ranks are
//     a serial scan's and the order is preserved); each tile scatters its
//     kept columns to base + rank and zeroes its share of the tail without
//     waiting for the count: a
//     tile that drops D columns zeroes the D slots below n - E (E the
//     columns dropped before it), so the tiles together zero [count, n);
//     slots [n, cap) (init_from_frame: 741,376 of 2^20) are zeroed by blocks
//     of their own ahead of the tiles, 2,048 slots each. A segment's last tile writes
//     its count min(kept, cap) to the card. The scan words: two sets that
//     alternate between calls, each launch zeroing the other set (K20's
//     scheme, csrc/tracks.cu);
//   - an optional skip flag read on the card (relocalisation's `lost`: fusion
//     is skipped while lost) stops every write to the output, which the
//     engine points at the map's own bucket, so the pre-fusion map stays; the
//     count is written and the verdicts are reset all the same.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "surfel.cuh"

constexpr int THREADS = 256;
constexpr int MAXSEG = 8;  // compaction segments: the flat store's global one and 7 slots
constexpr int VK_ID = 0x3f800000;  // ford(1.0f): a verdict with no vote
constexpr unsigned FULL = 0xffffffffu;
constexpr int CT = 256;                // a compaction block's threads
constexpr int CWARPS = CT / 32;
constexpr int CSUB = 4;                // its sub-tiles of CT columns
constexpr int CTILE = CT * CSUB;       // the columns of a compaction tile
constexpr int ZCOLS = 8 * CT;          // the columns a zero block zeroes
static_assert(CSUB * CWARPS <= 64, "the tile's counts are at most two a lane of one warp");

// ---------------------------------------------------------------- pixel pass

constexpr int CTW = 32, CTH = 8;  // the pixel pass's tile
constexpr int CLEAN_THREADS = CTW * CTH;
constexpr int CLEAN_MAX_WINDOW = 7;  // the largest window the staging holds
constexpr int CLEAN_STAGED = (CTW + CLEAN_MAX_WINDOW - 1) * (CTH + CLEAN_MAX_WINDOW - 1);

constexpr int COPY_COLS = 8 * CLEAN_THREADS;  // the columns of a copy block
// a flag frame's copy into another map: the channels the pixel pass's copy
// blocks copy (about half the bytes, beside its latency-bound tiles); the
// surfel pass copies the others with CONF and ALIVE
constexpr unsigned PIXEL_COPY = (1u << PX) | (1u << PY) | (1u << PZ) | (1u << CR) | (1u << CG) |
                                (1u << CB) | (1u << INIT_T);

struct PixelArgs {
  const int* index;
  const float* dl;
  int B;
  const float* depth;
  const int* mask;
  int mask_id, H, W, window;
  float time, conf_thr, gate, coeff, mask_factor;
  const float* conf_p;  // the confidence gate on the card (a per-slot gate); nullptr: conf_thr
  int tiles_x, copy_blocks;  // copy blocks first, then the pixel tiles row by row
  const float* src;           // copy blocks: every channel but CONF and ALIVE of [0, B)
  long rs;
  float* dst;
  long rs_out;
  const bool* skip;
};

// a copy block's columns, the channels of PIXEL_COPY
__device__ inline void copy_columns(const PixelArgs& a) {
  if (a.skip != nullptr && *a.skip) return;
  const int col0 = blockIdx.x * COPY_COLS + threadIdx.x;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (!((PIXEL_COPY >> c) & 1u)) continue;
    float v[COPY_COLS / CLEAN_THREADS];
#pragma unroll
    for (int k = 0; k < COPY_COLS / CLEAN_THREADS; ++k) {
      const int i = col0 + k * CLEAN_THREADS;
      v[k] = i < a.B ? a.src[c * a.rs + i] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < COPY_COLS / CLEAN_THREADS; ++k) {
      const int i = col0 + k * CLEAN_THREADS;
      if (i < a.B) a.dst[c * a.rs_out + i] = v[k];
    }
  }
}

// WINDOW > 0: the window fixed at compile time (the engine's 4x4, the count
// loop unrolled); 0: a.window
template <int WINDOW>
__global__ void __launch_bounds__(CLEAN_THREADS) pixel_pass(PixelArgs a, int* __restrict__ vk) {
  __shared__ CleanStage<CLEAN_STAGED> st;
  if ((int)blockIdx.x < a.copy_blocks) {
    copy_columns(a);
    return;
  }
  const int tile = blockIdx.x - a.copy_blocks;
  const int window = WINDOW > 0 ? WINDOW : a.window;
  const int tx = threadIdx.x % CTW, ty = threadIdx.x / CTW;
  const int x0 = (tile % a.tiles_x) * CTW, y0 = (tile / a.tiles_x) * CTH;
  const int r = window / 2;
  const int sw = CTW + window - 1, sh = CTH + window - 1;
  const float conf_thr = a.conf_p != nullptr ? *a.conf_p : a.conf_thr;
  constexpr int ROUNDS = (CLEAN_STAGED + CLEAN_THREADS - 1) / CLEAN_THREADS;
  int c[ROUNDS];
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) {
    const int s = threadIdx.x + k * CLEAN_THREADS;
    const int yy = y0 - r + s / sw, xx = x0 - r + s % sw;
    c[k] = -1;
    if (s < sw * sh && yy >= 0 && yy < a.H && xx >= 0 && xx < a.W) c[k] = a.index[yy * a.W + xx];
  }
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) {
    const int s = threadIdx.x + k * CLEAN_THREADS;
    int m = -1;  // the one model, 0, where the winner passes the confidence gate
    if (c[k] >= 0) {
      st.p[s] = make_float4(a.dl[PX * a.B + c[k]], a.dl[PY * a.B + c[k]], a.dl[PZ * a.B + c[k]],
                            a.dl[INIT_T * a.B + c[k]]);
      st.last[s] = a.dl[LAST_T * a.B + c[k]];
      if (a.dl[CONF * a.B + c[k]] > conf_thr) m = 0;
    }
    if (s < sw * sh) st.key[s] = make_int2(c[k], m);
  }
  __syncthreads();
  const int x = x0 + tx, y = y0 + ty;
  if (x >= a.W || y >= a.H) return;
  const int sc = (ty + r) * sw + tx + r;  // the pixel's own staged position
  const int i = st.key[sc].x;
  if (i < 0) return;
  const float4 q = st.p[sc];
  const float qz = q.z;
  int count, z_count;
  window_counts_staged<CLEAN_STAGED, WINDOW>(st, ty * sw + tx, sw, window, 0, i, q.x, q.y, qz,
                                             q.w, a.dl[RADIUS * a.B + i],
                                             fabsf(a.dl[NZ * a.B + i]), a.time, &count, &z_count);
  bool viol;
  float pen = see_through(a.depth, a.H, a.W, x, y, qz, a.gate, a.coeff, &viol);
  const int p = y * a.W + x;
  const float dp = a.depth[p];
  const bool mask_pen = viol && a.mask[p] != a.mask_id && dp > qz - 0.05f && dp < qz + 0.05f;
  if (mask_pen) pen = pen * a.mask_factor;
  const bool cull = count > 8 || z_count > 4;
  atomicMin(&vk[i], ford(cull ? -1.f : pen));
}

// ---------------------------------------------------------------- surfel pass

struct KeepArgs {  // the keep logic of a clean
  const int* count;
  float time, conf_thr, grace, time_delta;
  const float* conf_p;
};

// slot i's keep verdict and penalty; its verdict word set back to VK_ID
__device__ inline bool clean_keep(const KeepArgs& k, const float* __restrict__ data, long rs,
                                  int* __restrict__ vk, int i, float* pen) {
  const int v = vk[i];
  if (v != VK_ID) vk[i] = VK_ID;
  const bool alive = i < *k.count && data[ALIVE * rs + i] > 0.f;
  return keep_surfel(alive, v, data[LAST_T * rs + i], data[CONF * rs + i], k.time, k.grace,
                     k.conf_p != nullptr ? *k.conf_p : k.conf_thr, k.time_delta, pen);
}

// out == data: in place (only the values that change are written); else
// into out CONF, ALIVE and the channels the pixel pass's copy blocks did
// not copy
__global__ void __launch_bounds__(THREADS)
surfel_pass(float* data, long rs, int B, KeepArgs k, float* out, long rs_out,
            int* __restrict__ vk, const bool* __restrict__ skip) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= B) return;
  float pen;
  const bool keep = clean_keep(k, data, rs, vk, i, &pen);
  if (skip != nullptr && *skip) return;
  const float conf = data[CONF * rs + i], alive_v = data[ALIVE * rs + i];
  if (out == data) {
    if (pen != 1.0f || conf != conf) data[CONF * rs + i] = conf * pen;
    if (!keep && __float_as_int(alive_v) != 0) data[ALIVE * rs + i] = 0.f;
    return;
  }
  float v[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c)
    if (!((PIXEL_COPY >> c) & 1u) && c != CONF && c != ALIVE) v[c] = data[c * rs + i];
#pragma unroll
  for (int c = 0; c < CH; ++c)
    if (!((PIXEL_COPY >> c) & 1u) && c != CONF && c != ALIVE) out[c * rs_out + i] = v[c];
  out[CONF * rs_out + i] = conf * pen;
  out[ALIVE * rs_out + i] = keep ? alive_v : 0.f;
}

// ---------------------------------------------------------------- compaction

enum { KEEP_ARRAY = 0, KEEP_CLEAN = 1, KEEP_COUNTED = 2 };

struct Seg {
  const float* src;
  float* dst;
  long src_rs, dst_rs;  // channel strides
  const int* count_in;  // KEEP_COUNTED: slots below it with ALIVE > 0 are kept
  int* count_out;       // min(kept, cap)
  int n, cap, tile0;    // source columns, destination columns, first tile
};

struct CompactArgs {
  Seg seg[MAXSEG];
  int nseg, tiles;        // segments, tiles of all segments
  int zero_blocks;        // blocks before the tiles that zero segment 0's [n, cap)
  unsigned* scan;         // [tiles + 1] words of this call: 0 before it
  unsigned* next_scan;    // the next call's: set to 0 here
  const uint8_t* keep;    // KEEP_ARRAY
  KeepArgs k;             // KEEP_CLEAN
  int* vk;                // KEEP_CLEAN: the verdicts, set back to VK_ID
  const bool* skip;       // nullptr or the card's skip flag: no write to any dst
};

__device__ inline void zero_column(float* __restrict__ dst, long rs, int d) {
#pragma unroll
  for (int c = 0; c < CH; ++c) dst[c * rs + d] = 0.f;
}

struct CompactShared {
  int tile;
  int cnt[CSUB * CWARPS];  // kept columns of each (sub-tile, warp), then its first rank
  int base, total;         // kept columns before this tile, and up to its end
};

// warp 0 of a tile: publish the tile's aggregate, look back over its
// segment's earlier tiles (scan.cuh's status words and order, 32 at a time
// down to the nearest inclusive prefix), publish the inclusive prefix;
// returns the kept columns before the tile
__device__ inline int look_back(unsigned* words, int tile, int agg) {
  const int lane = threadIdx.x & 31;
  volatile unsigned* st = words;
  int base = 0;
  if (tile > 0) {
    if (lane == 0) st[tile] = SCAN_AGG | (unsigned)agg;
    for (int j0 = tile - 1;; j0 -= 32) {
      const int j = j0 - lane;  // before tile 0: an inclusive prefix of 0
      unsigned w;
      do {
        w = j >= 0 ? st[j] : SCAN_AGG | SCAN_INC;
      } while (__any_sync(FULL, !(w & SCAN_AGG)));
      const unsigned inc = __ballot_sync(FULL, (w & SCAN_INC) != 0u);
      const int stop = inc ? __ffs(inc) - 1 : 31;
      int v = lane <= stop ? (int)(w & SCAN_VALUE) : 0;
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
      base += v;
      if (inc) break;
    }
  }
  if (lane == 0) st[tile] = SCAN_AGG | SCAN_INC | (unsigned)(base + agg);
  return base;
}

template <int MODE>
__global__ void __launch_bounds__(CT) compaction(CompactArgs a) {
  __shared__ CompactShared sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if ((int)blockIdx.x < a.zero_blocks) {  // slots no tile writes: [n, cap) of segment 0
    if (a.skip != nullptr && *a.skip) return;
    const Seg& s = a.seg[0];
    const int c0 = s.n + blockIdx.x * ZCOLS + threadIdx.x;
#pragma unroll
    for (int k = 0; k < ZCOLS / CT; ++k)
      if (c0 + k * CT < s.cap) zero_column(s.dst, s.dst_rs, c0 + k * CT);
    return;
  }
  // the tiles start in ticket order, so every earlier tile is running or done
  if (threadIdx.x == 0) sh.tile = (int)atomicAdd(a.scan + a.tiles, 1u);
  __syncthreads();
  const int tile = sh.tile;
  if (threadIdx.x == 0) a.next_scan[tile] = 0u;
  if (threadIdx.x == 1 && tile == 0) a.next_scan[a.tiles] = 0u;
  Seg s = a.seg[0];
#pragma unroll
  for (int m = 1; m < MAXSEG; ++m)
    if (m < a.nseg && tile >= a.seg[m].tile0) s = a.seg[m];
  const int local = tile - s.tile0, tiles = (s.n + CTILE - 1) / CTILE;
  const int start = local * CTILE, end = min(start + CTILE, s.n);
  // sub-tile k holds the columns start + k CT .. : the keep flags (their
  // loads issued together), then each warp's count
  unsigned keeps = 0u;
  float pen[CSUB];
#pragma unroll
  for (int k = 0; k < CSUB; ++k) {
    const int i = start + k * CT + threadIdx.x;
    bool keep = false;
    pen[k] = 1.f;
    if (i < end) {
      if (MODE == KEEP_ARRAY) keep = a.keep[i] != 0;
      if (MODE == KEEP_CLEAN) keep = clean_keep(a.k, s.src, s.src_rs, a.vk, i, &pen[k]);
      if (MODE == KEEP_COUNTED) keep = i < *s.count_in && s.src[ALIVE * s.src_rs + i] > 0.f;
    }
    keeps |= (unsigned)keep << k;
  }
#pragma unroll
  for (int k = 0; k < CSUB; ++k) {
    const unsigned b = __ballot_sync(FULL, (keeps >> k) & 1u);
    if (lane == 0) sh.cnt[k * CWARPS + warp] = __popc(b);
  }
  __syncthreads();
  if (warp == 0) {  // the (sub-tile, warp) counts in column order: two a lane
    constexpr int NC = CSUB * CWARPS;
    const int c0 = 2 * lane < NC ? sh.cnt[2 * lane] : 0;
    const int c1 = 2 * lane + 1 < NC ? sh.cnt[2 * lane + 1] : 0;
    int incl = c0 + c1;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    const int agg = __shfl_sync(FULL, incl, 31);
    const int base = look_back(a.scan + s.tile0, local, agg);
    const int first = base + incl - c0 - c1;
    if (2 * lane < NC) sh.cnt[2 * lane] = first;
    if (2 * lane + 1 < NC) sh.cnt[2 * lane + 1] = first + c0;
    if (lane == 0) {
      sh.base = base;
      sh.total = base + agg;
    }
  }
  __syncthreads();
  const int base = sh.base, total = sh.total;
  if (local == tiles - 1 && threadIdx.x == 0) *s.count_out = min(total, s.cap);
  if (a.skip != nullptr && *a.skip) return;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < CSUB; ++k) {
    const bool keep = (keeps >> k) & 1u;
    const unsigned b = __ballot_sync(FULL, keep);
    const int d = sh.cnt[k * CWARPS + warp] + __popc(b & below);
    if (keep && d < s.cap) {
      const int i = start + k * CT + threadIdx.x;
      const float* __restrict__ src = s.src;
      float* __restrict__ dst = s.dst;
      float v[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) v[c] = src[c * s.src_rs + i];
      if (MODE == KEEP_CLEAN) v[CONF] = v[CONF] * pen[k];
#pragma unroll
      for (int c = 0; c < CH; ++c) dst[c * s.dst_rs + d] = v[c];
    }
  }
  // this tile's share of [count, n): the slots n - E_incl .. n - E_before
  const int e_before = start - base, e_incl = end - total;
  for (int z = s.n - e_incl + threadIdx.x; z < s.n - e_before && z < s.cap; z += CT)
    zero_column(s.dst, s.dst_rs, z);
}

// the segments' first tiles, this call's scan words (set `parity` of the
// [2, tiles + 1] words) and the launch, one tile of CTILE slots a block
int launch_compaction(int mode, CompactArgs& a, unsigned* scan, int parity,
                      cudaStream_t stream) {
  if (a.nseg < 1 || a.nseg > MAXSEG) return (int)cudaErrorInvalidValue;
  int tiles = 0;
  for (int m = 0; m < a.nseg; ++m) {
    Seg& s = a.seg[m];
    if (s.n < 1 || s.n >= (int)SCAN_VALUE || s.cap < 0) return (int)cudaErrorInvalidValue;
    s.tile0 = tiles;
    tiles += (s.n + CTILE - 1) / CTILE;
  }
  // only compact's one segment may have more slots than columns
  for (int m = 1; m < a.nseg; ++m)
    if (a.seg[m].cap > a.seg[m].n) return (int)cudaErrorInvalidValue;
  a.tiles = tiles;
  a.zero_blocks = (max(a.seg[0].cap - a.seg[0].n, 0) + ZCOLS - 1) / ZCOLS;
  a.scan = scan + parity * (tiles + 1);
  a.next_scan = scan + (1 - parity) * (tiles + 1);
  auto kernel = mode == KEEP_ARRAY ? compaction<KEEP_ARRAY>
                : mode == KEEP_CLEAN ? compaction<KEEP_CLEAN> : compaction<KEEP_COUNTED>;
  kernel<<<a.zero_blocks + tiles, CT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// scan: [2, tiles + 1] words (ceil(B / CTILE) tiles), the set `parity` used
// now, the other zeroed for the next call
extern "C" int mmf_clean(float* data, long rs_in, int B, const int* count, const int* index,
                         const float* data_local, const float* depth, const int* mask,
                         int mask_id, int H, int W, int window, float time, float time_delta,
                         float conf_thr, float grace, float gate, float coeff, float mask_factor,
                         int compact, int* verdicts, unsigned* scan, int parity, float* out,
                         long rs_out, int* count_out, const bool* skip, const float* conf_p,
                         cudaStream_t stream) {
  if (window < 1 || window > CLEAN_MAX_WINDOW || H < 1 || W < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  // a compaction's refusal comes before any launch: the pixel pass's votes
  // are reset only by the pass after it
  if (compact && (out == data || B >= (int)SCAN_VALUE)) return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + CTW - 1) / CTW, tiles = tiles_x * ((H + CTH - 1) / CTH);
  // a flag frame into another map: its copy rides in the pixel pass's launch
  const int copy_blocks =
      PIXEL_COPY != 0u && !compact && out != data ? (B + COPY_COLS - 1) / COPY_COLS : 0;
  PixelArgs pa{index, data_local, B, depth, mask, mask_id, H, W, window,
               time, conf_thr, gate, coeff, mask_factor, conf_p, tiles_x, copy_blocks,
               data, rs_in, out, rs_out, skip};
  auto pixels = window == 4 ? pixel_pass<4> : pixel_pass<0>;
  pixels<<<copy_blocks + tiles, CLEAN_THREADS, 0, stream>>>(pa, verdicts);
  KeepArgs k{count, time, conf_thr, grace, time_delta, conf_p};
  if (!compact) {
    surfel_pass<<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(data, rs_in, B, k, out,
                                                                      rs_out, verdicts, skip);
    return (int)cudaGetLastError();
  }
  CompactArgs a{};
  a.seg[0] = Seg{data, out, rs_in, rs_out, nullptr, count_out, B, B, 0};
  a.nseg = 1;
  a.k = k;
  a.vk = verdicts;
  a.skip = skip;
  return launch_compaction(KEEP_CLEAN, a, scan, parity, stream);
}

extern "C" int mmf_compact(const float* src, long rs_src, int n, const uint8_t* keep, float* dst,
                           long rs_dst, int cap, int* count_out, unsigned* scan, int parity,
                           cudaStream_t stream) {
  CompactArgs a{};
  a.seg[0] = Seg{src, dst, rs_src, rs_dst, nullptr, count_out, n, cap, 0};
  a.nseg = 1;
  a.keep = keep;
  return launch_compaction(KEEP_ARRAY, a, scan, parity, stream);
}

// The multi-model repack: segment 0 (the global map, gn columns) and `slots`
// slot segments (on columns each), each packed into its own destination (cap
// = its size), slot k's source and destination `src_ss` / `dst_ss` floats
// after the one before; keep = slot < counts[m] && ALIVE > 0; counts_out [1 +
// slots] on the card.
extern "C" int mmf_compact_segments(const float* gsrc, long gsrc_rs, float* gdst, long gdst_rs,
                                    int gn, const float* osrc, long osrc_rs, long src_ss,
                                    float* odst, long odst_rs, long dst_ss, int on, int slots,
                                    const int* counts, int* counts_out, unsigned* scan,
                                    int parity, cudaStream_t stream) {
  if (slots < 0 || 1 + slots > MAXSEG) return (int)cudaErrorInvalidValue;
  CompactArgs a{};
  a.seg[0] = Seg{gsrc, gdst, gsrc_rs, gdst_rs, counts, counts_out, gn, gn, 0};
  for (int k = 0; k < slots; ++k)
    a.seg[1 + k] = Seg{osrc + k * src_ss, odst + k * dst_ss, osrc_rs, odst_rs, counts + 1 + k,
                       counts_out + 1 + k, on, on, 0};
  a.nseg = 1 + slots;
  return launch_compaction(KEEP_COUNTED, a, scan, parity, stream);
}
