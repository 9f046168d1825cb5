// K20 tracks: mutual_match and the track table's update (add_keypoints,
// prune, last_pair).
//
// Replaces: multimotionfusion_tpu/tracking/tracker.py:83 mutual_match, :116
//   add_keypoints (with :65 backproject_keypoints), :182 prune and :239
//   last_pair.
// Bound on an H100: mutual_match by operations at the default shapes (K = 512
//   queries x T = 4096 tracks x D = 64: 268 M multiplies and adds of dot
//   products, which -fmad=false keeps apart; the descriptors are 1.2 MB);
//   the update by latency (it touches K rows and one ring slot of every
//   track).
// Design:
//   - mutual_match, two launches, no memset: match_tile takes a 128 x 128
//     tile of (query, track) pairs a block (128 blocks at the default
//     shapes: one wave), both descriptor tiles in shared memory, transposed,
//     an 8 x 4 register tile a thread fed by 16-byte loads; each dot product
//     and both squared norms are summed over d = 0..D-1 in order (the plain
//     version repeats that order; 256 of the threads sum one norm each),
//     d2 = |q|^2 - 2 q.t + |t|^2 (1e30 where either side is invalid; a
//     track's validity is given, or computed as in_history from `active` and
//     `last_seen`). The [K, T] matrix is never written, and no atomic is
//     taken: keys (order-preserving d2 bits << 32 | index, so ties go to the
//     first index) are reduced in registers, a row's across the 32 lanes that
//     hold it (__shfl_xor_sync), a column's across the 16 warps in shared
//     memory, and each block writes its
//     row minima to rowpart [T/128, K] and its column minima to colpart
//     [K/128, T]. Then match_final, one thread per query and per track, takes
//     the minima over the partials (min is exact in any order): per query the
//     mutual test and the gate (match [K]), per track the query of its column
//     minimum (tcol [T]); the public mutual_match also asks for matched_t
//     [T], which the launch's last block (csrc/last_block.cuh) writes as
//     match[tcol[t]] == t;
//   - update, one launch of one thread per track (256 a block), in pull
//     form: track i takes its row from query tcol[i] when match[tcol[i]] ==
//     i (mutual matching makes that query unique), or, if it was free, from
//     the r-th unmatched valid keypoint, r being its rank among the free
//     slots in index order (the single-pass append scan of csrc/scan.cuh
//     over the table as it was before this frame; every block ranks the
//     keypoints' new flags itself, in shared memory). New keypoints beyond
//     the free slots are dropped. A track's own inputs are loaded before the
//     scan, so that they are in flight during it. Then, in the old order, the
//     thread writes the row, clears the next ring slot and (on tracked
//     frames) prunes and forms the (p0, p1, valid) pair; a warp copies each
//     taken row's descriptor, coalesced. The calls alternate between two
//     sets of scan words: each launch sets the other set (the previous
//     call's) back to 0 for the next one, with no tail and no memset.

#include <cuda_runtime.h>
#include <stdint.h>

#include "last_block.cuh"

namespace {

#include "common.cuh"
#include "scan.cuh"

constexpr int TQ = 128, TT = 128, DC = 32;  // tile of queries x tracks, descriptor chunk
constexpr int TPAD = TQ + 4;                 // a chunk row of the transposed tiles
constexpr int RT = 8, CT = 4;                // a thread's queries x tracks
constexpr int LANES = TT / CT;               // the threads that share a query row
constexpr int MATCH_THREADS = (TQ / RT) * LANES;
constexpr int MATCH_WARPS = MATCH_THREADS / 32;
constexpr int MAX_K = 4096;
constexpr unsigned long long NONE = 0xffffffffffffffffull;
static_assert(LANES <= 32 && (LANES & (LANES - 1)) == 0, "a row's lanes lie in one warp");
static_assert(MATCH_THREADS >= TQ + TT, "a thread a norm");

// a track's validity for matching: given, or in_history (active, with a
// keypoint within the ring's span)
struct TrackValid {
  const bool* tv;  // or null: from active and last_seen
  const bool* active;
  const int* last_seen;
  int time, hist;
};

__device__ inline bool track_valid(const TrackValid& v, int t) {
  return v.tv != nullptr ? v.tv[t] : (v.active[t] && (v.time - v.last_seen[t]) <= v.hist);
}

__device__ inline unsigned long long kmin(unsigned long long a, unsigned long long b) {
  return a < b ? a : b;
}

// thread (tx, ty) holds queries RT ty .. RT ty + RT - 1 and tracks
// CT tx .. CT tx + CT - 1 of the block's TQ x TT tile
__global__ void __launch_bounds__(MATCH_THREADS)
match_tile(const float* __restrict__ q, const float* __restrict__ t,
           const bool* __restrict__ qv, TrackValid tvs, int K, int T, int D,
           unsigned long long* __restrict__ rowpart, unsigned long long* __restrict__ colpart) {
  __shared__ __align__(16) float sq[DC][TPAD];  // chunk of the query tile, transposed
  __shared__ __align__(16) float st[DC][TPAD];
  __shared__ float qn[TQ], tn[TT];
  // each warp's column minima, over the query tile once the dot products are done
  static_assert(sizeof(sq) >= sizeof(unsigned long long) * MATCH_WARPS * TT, "room");
  auto cpart = reinterpret_cast<unsigned long long (*)[TT]>(&sq[0][0]);
  const int q0 = blockIdx.y * TQ, t0 = blockIdx.x * TT;
  const int tid = threadIdx.x, tx = tid % LANES, ty = tid / LANES;
  const int lane = tid & 31, warp = tid >> 5;
  float dot[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) dot[i][j] = 0.f;
  float nacc = 0.f;  // |q|^2 of query row tid, or |t|^2 of track row tid - TQ
  for (int d0 = 0; d0 < D; d0 += DC) {
    const int dc = min(DC, D - d0);
    for (int e = tid; e < TQ * DC; e += MATCH_THREADS) {
      const int r = e / DC, c = e % DC;
      sq[c][r] = (q0 + r < K && c < dc) ? q[(size_t)(q0 + r) * D + d0 + c] : 0.f;
      st[c][r] = (t0 + r < T && c < dc) ? t[(size_t)(t0 + r) * D + d0 + c] : 0.f;
    }
    __syncthreads();
    // every chunk column, the zeros past D included (they add exact zeros)
#pragma unroll 8
    for (int c = 0; c < DC; ++c) {
      float a[RT], b[CT];
#pragma unroll
      for (int v = 0; v < RT / 4; ++v) {
        const float4 x = *reinterpret_cast<const float4*>(&sq[c][RT * ty + 4 * v]);
        a[4 * v] = x.x, a[4 * v + 1] = x.y, a[4 * v + 2] = x.z, a[4 * v + 3] = x.w;
      }
#pragma unroll
      for (int v = 0; v < CT / 4; ++v) {
        const float4 x = *reinterpret_cast<const float4*>(&st[c][CT * tx + 4 * v]);
        b[4 * v] = x.x, b[4 * v + 1] = x.y, b[4 * v + 2] = x.z, b[4 * v + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) dot[i][j] = dot[i][j] + a[i] * b[j];
      if (tid < TQ + TT) {
        const float v = tid < TQ ? sq[c][tid] : st[c][tid - TQ];
        nacc = nacc + v * v;
      }
    }
    __syncthreads();
  }
  if (tid < TQ) qn[tid] = nacc;
  else if (tid < TQ + TT) tn[tid - TQ] = nacc;
  __syncthreads();
  bool tok[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) tok[j] = t0 + CT * tx + j < T && track_valid(tvs, t0 + CT * tx + j);
  unsigned long long ck[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) ck[j] = NONE;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = RT * ty + i, gq = q0 + r;
    const bool qok = gq < K && qv[gq];
    unsigned long long rk = NONE;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int c = CT * tx + j, gt = t0 + c;
      if (gq >= K || gt >= T) continue;
      float d2 = (qn[r] - 2.f * dot[i][j]) + tn[c];
      if (!(qok && tok[j])) d2 = 1e30f;
      const unsigned long long hi = (unsigned long long)ord32(d2) << 32;
      rk = kmin(rk, hi | (unsigned)gt);
      ck[j] = kmin(ck[j], hi | (unsigned)gq);
    }
    // a row's TT columns lie in LANES neighbouring lanes of one warp
    for (int off = 1; off < LANES; off <<= 1)
      rk = kmin(rk, __shfl_xor_sync(0xffffffffu, rk, off));
    if (tx == 0 && gq < K) rowpart[(size_t)blockIdx.x * K + gq] = rk;
  }
  // a column's TQ rows: the rows of lanes within each warp, then the warps
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    for (int off = LANES; off < 32; off <<= 1)
      ck[j] = kmin(ck[j], __shfl_xor_sync(0xffffffffu, ck[j], off));
    if (lane < LANES) cpart[warp][CT * tx + j] = ck[j];
  }
  __syncthreads();
  if (tid < TT && t0 + tid < T) {
    unsigned long long m = cpart[0][tid];
    for (int w = 1; w < MATCH_WARPS; ++w) m = kmin(m, cpart[w][tid]);
    colpart[(size_t)blockIdx.y * T + t0 + tid] = m;
  }
}

// the minimum over a row's (or column's) partials: `n` keys `stride` apart
__device__ inline unsigned long long part_min(const unsigned long long* __restrict__ p, int n,
                                              int stride) {
  unsigned long long m = NONE;
  for (int b = 0; b < n; ++b) m = kmin(m, p[(size_t)b * stride]);
  return m;
}

// thread j: query j (j < K): the mutual test and the gate; track j (j < T):
// the query of its column minimum (tcol). With matched_t, the launch's last
// block marks the matched tracks: track j is matched iff match[tcol[j]] == j.
__global__ void match_final(const unsigned long long* __restrict__ rowpart,
                            const unsigned long long* __restrict__ colpart,
                            const bool* __restrict__ qv, int K, int T, float gate2,
                            int* __restrict__ match, int* __restrict__ tcol,
                            bool* __restrict__ matched_t, unsigned* __restrict__ ticket) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int nt = (T + TT - 1) / TT, nq = (K + TQ - 1) / TQ;
  if (j < K) {
    const unsigned long long rb = part_min(rowpart + j, nt, K);
    const int bt = (int)(rb & 0xffffffffull);
    const float d2 = unord32((unsigned)(rb >> 32));
    const bool mutual = (int)(part_min(colpart + bt, nq, T) & 0xffffffffull) == j;
    match[j] = mutual && d2 <= gate2 && qv[j] ? bt : -1;
  }
  if (j < T) tcol[j] = (int)(part_min(colpart + j, nq, T) & 0xffffffffull);
  if (matched_t != nullptr && last_block(ticket)) {
    // 8 tracks a thread at a time: their column minima's queries, then those
    // queries' matches, each batch of loads in flight together
    constexpr int B = 8;
    for (int t0 = 0; t0 < T; t0 += B * blockDim.x) {
      int k[B], mk[B];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int t = t0 + b * blockDim.x + threadIdx.x;
        k[b] = t < T ? __ldcg(tcol + t) : 0;
      }
#pragma unroll
      for (int b = 0; b < B; ++b) mk[b] = __ldcg(match + k[b]);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int t = t0 + b * blockDim.x + threadIdx.x;
        if (t < T) matched_t[t] = mk[b] == t;
      }
    }
  }
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
  const int* tcol;
  const float* depth;
  int cap, hist, D, K, H, W;
  float fx, fy, cx, cy;
  int time, pair, min_kps, max_age;
};

__global__ void __launch_bounds__(SCAN_TILE)
update_tracks(Table tb, Frame f, unsigned* __restrict__ scan, unsigned* __restrict__ next_scan,
              float* __restrict__ p0, float* __restrict__ p1, bool* __restrict__ pv) {
  __shared__ ScanShared sc;
  __shared__ int inv[MAX_K];  // the r-th unmatched valid keypoint
  __shared__ int wcount[SCAN_WARPS];
  __shared__ int src_of[SCAN_TILE];
  float* __restrict__ xy = tb.xy;
  float* __restrict__ p3d = tb.p3d;
  bool* __restrict__ seen = tb.seen;
  bool* __restrict__ has_depth = tb.has_depth;
  float* __restrict__ desc = tb.desc;
  int* __restrict__ last_seen = tb.last_seen;
  int* __restrict__ nvalid = tb.nvalid;
  bool* __restrict__ active = tb.active;
  const float* __restrict__ kxy = f.kxy;
  const float* __restrict__ kdesc = f.kdesc;
  const bool* __restrict__ kvalid = f.kvalid;
  const int* __restrict__ match = f.match;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = scan_tiles(f.cap);

  // the free slots' ranks (the table as it was before this frame)
  const int tile = scan_ticket(scan, tiles, 1, 0u, sc);
  // the next call's scan words (the previous call's, done with): 0 again
  if (tid == 0) next_scan[tile] = 0u;
  if (tid == 1 && tile == 0) next_scan[tiles] = 0u;
  const int i = tile * SCAN_TILE + tid;
  const bool in = i < f.cap;
  const bool was_active = in && active[i];
  // the track's own inputs, loaded before the scan so that they are in flight
  // during it: its column minimum's query, its counters and the pair's slots
  // as they were before this frame
  struct {
    int kc, ls, nv, kc_match;
    float p0[3], p1[3], kc_x, kc_y;
    bool hd0, hd1, kc_valid;
  } pre = {};
  // and the keypoints' new flags (bit j: keypoint tid + 256 j)
  unsigned newbits = 0u;
  for (int j = 0; j * SCAN_TILE < f.K; ++j) {
    const int k = j * SCAN_TILE + tid;
    if (k < f.K && kvalid[k] && match[k] < 0) newbits |= 1u << j;
  }
  if (in) {
    const int hist = f.hist;
    const size_t e0 = (size_t)i * hist + ((f.time - 1) % hist + hist) % hist;
    const size_t e1 = (size_t)i * hist + f.time % hist;
    pre.kc = f.tcol[i];
    pre.ls = last_seen[i];
    pre.nv = nvalid[i];
    for (int a = 0; a < 3; ++a) {
      pre.p0[a] = p3d[3 * e0 + a];
      pre.p1[a] = p3d[3 * e1 + a];
    }
    pre.hd0 = has_depth[e0];
    pre.hd1 = has_depth[e1];
    // the column minimum's query, the source if it matched this track
    pre.kc_match = match[pre.kc];
    pre.kc_x = kxy[2 * pre.kc];
    pre.kc_y = kxy[2 * pre.kc + 1];
    pre.kc_valid = kvalid[pre.kc];
  }
  const int rank = append_scan(scan, 1, tile, in && !was_active, in ? 0 : 1, sc);

  // rank -> keypoint of the unmatched valid keypoints, in index order
  int nnew = 0;
  const unsigned below = (1u << lane) - 1u;
  for (int j = 0; j * SCAN_TILE < f.K; ++j) {
    const int k = j * SCAN_TILE + tid;
    const bool nw = (newbits >> j) & 1u;
    const unsigned b = __ballot_sync(0xffffffffu, nw);
    if (lane == 0) wcount[warp] = __popc(b);
    __syncthreads();
    int base = nnew, round = 0;
    for (int w = 0; w < SCAN_WARPS; ++w) {
      if (w < warp) base += wcount[w];
      round += wcount[w];
    }
    if (nw) inv[base + __popc(b & below)] = k;
    nnew += round;
    __syncthreads();
  }

  // the row track i takes: from the query that matched it, or as a free slot
  int src = -1;
  bool matched = false;
  if (in) {
    if (pre.kc_match == i) {
      src = pre.kc;
      matched = true;
    } else if (!was_active && rank < nnew) {
      src = inv[rank];
    }
  }
  src_of[tid] = src;
  if (in) {
    const int hist = f.hist, slot = f.time % hist;
    const size_t e1 = (size_t)i * hist + slot;
    int ls = pre.ls, nv = pre.nv;
    bool act = was_active;
    float q1[3] = {pre.p1[0], pre.p1[1], pre.p1[2]};
    bool hd1 = pre.hd1;
    if (src >= 0) {
      const float x = matched ? pre.kc_x : kxy[2 * src];
      const float y = matched ? pre.kc_y : kxy[2 * src + 1];
      const int xi = min(max(__float2int_rn(x), 0), f.W - 1);
      const int yi = min(max(__float2int_rn(y), 0), f.H - 1);
      const float z = f.depth[yi * f.W + xi];
      const bool hd = (matched ? pre.kc_valid : kvalid[src]) && z > 0.f;
      q1[0] = hd ? (z * (x - f.cx)) / f.fx : 0.f;
      q1[1] = hd ? (z * (y - f.cy)) / f.fy : 0.f;
      q1[2] = hd ? z : 0.f;
      hd1 = hd;
      xy[2 * e1] = x;
      xy[2 * e1 + 1] = y;
      for (int a = 0; a < 3; ++a) p3d[3 * e1 + a] = q1[a];
      seen[e1] = true;
      has_depth[e1] = hd;
      ls = f.time;
      nv = matched ? nv + 1 : 1;
      act = true;
      last_seen[i] = ls;
      nvalid[i] = nv;
    }
    // clear the next ring slot, then prune and form the pair: the slots as
    // they read after the row's write and the clear
    const int sn = (f.time + 1) % hist, s0 = ((f.time - 1) % hist + hist) % hist;
    seen[(size_t)i * hist + sn] = false;
    has_depth[(size_t)i * hist + sn] = false;
    if (f.pair) {
      const bool drop = act && nv < f.min_kps && (f.time - ls) > f.max_age;
      act = act && !drop;
      if (sn == slot) hd1 = false;
      const bool same = s0 == slot;  // a ring of one slot
      const bool hd0 = same ? hd1 : (sn == s0 ? false : pre.hd0);
      for (int a = 0; a < 3; ++a) {
        p0[3 * i + a] = same ? q1[a] : pre.p0[a];
        p1[3 * i + a] = q1[a];
      }
      pv[i] = act && hd0 && hd1 && ls == f.time;
    }
    if (act != was_active) active[i] = act;
  }
  __syncthreads();
  // each taken row's descriptor, a warp a row
  for (int r = warp; r < SCAN_TILE; r += SCAN_WARPS) {
    const int s = src_of[r];
    if (s < 0) continue;
    const size_t dst = (size_t)(tile * SCAN_TILE + r) * f.D, from = (size_t)s * f.D;
    for (int d = lane; d < f.D; d += 32) desc[dst + d] = kdesc[from + d];
  }
}

}  // namespace

extern "C" int mmf_mutual_match(const float* q, const float* t, const bool* qv, const bool* tv,
                                const bool* active, const int* last_seen, int time, int hist,
                                int K, int T, int D, float gate2, unsigned long long* rowpart,
                                unsigned long long* colpart, int* match, int* tcol,
                                bool* matched_t, unsigned* ticket, cudaStream_t stream) {
  if (K < 1 || T < 1) return (int)cudaErrorInvalidValue;
  TrackValid tvs{tv, active, last_seen, time, hist};
  dim3 grid((T + TT - 1) / TT, (K + TQ - 1) / TQ);
  match_tile<<<grid, MATCH_THREADS, 0, stream>>>(q, t, qv, tvs, K, T, D, rowpart, colpart);
  const int n = K > T ? K : T;
  match_final<<<(n + 255) / 256, 256, 0, stream>>>(rowpart, colpart, qv, K, T, gate2, match,
                                                    tcol, matched_t, ticket);
  return (int)cudaGetLastError();
}

extern "C" int mmf_track_update(float* xy, float* p3d, bool* seen, bool* has_depth, float* desc,
                                int* last_seen, int* nvalid, bool* active, const float* kxy,
                                const float* kdesc, const bool* kvalid, const int* match,
                                const int* tcol, const float* depth, int cap, int hist, int D,
                                int K, int H, int W, float fx, float fy, float cx, float cy,
                                int time, int pair, int min_kps, int max_age, unsigned* scan,
                                unsigned* next_scan, float* p0, float* p1, bool* pv,
                                cudaStream_t stream) {
  if (K < 1 || K > MAX_K || cap < 1) return (int)cudaErrorInvalidValue;
  Table tb{xy, p3d, seen, has_depth, desc, last_seen, nvalid, active};
  Frame f{kxy, kdesc, kvalid, match, tcol, depth, cap, hist, D, K, H, W,
          fx, fy, cx, cy, time, pair, min_kps, max_age};
  const int tiles = scan_tiles(cap);
  // scan, next_scan: [tiles] status words and the scan's ticket each
  update_tracks<<<tiles, SCAN_TILE, 0, stream>>>(tb, f, scan, next_scan, p0, p1, pv);
  return (int)cudaGetLastError();
}
