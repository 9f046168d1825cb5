// The single-pass append scan shared by K8's and K14's association kernels
// (fuse.cu, fuse_flat.cu, through surfel.cuh) and K20's track update
// (tracks.cu: the rank of each free slot of the track table). Included
// inside each source's anonymous namespace; build_all rebuilds every source
// when this header changes.

#pragma once

// The exclusive per-model prefix of the "new" flags over the checkerboard in
// source order (append slot = segment base + count + prefix, so surfel ids
// match the reference's), folded into the kernel that computes the flags
// (K8's and K14's assoc; K8 is the case of one model) as a single-pass
// decoupled look-back scan over its tiles of SCAN_TILE pixels:
//   - a block takes its tile from a ticket (scan_ticket), so the tiles start
//     in order and every predecessor of a tile is running or done: the
//     look-back cannot wait on a block that has not started;
//   - a tile counts its new flags per model with __ballot_sync / __popc over
//     each warp's lanes and scans the warps' counts in shared memory;
//   - warp m publishes model m's tile aggregate, then looks back over its
//     predecessors' status words 32 tiles at a time (adding aggregates until
//     the nearest inclusive prefix) and publishes the tile's inclusive prefix;
//   - a pixel's prefix is its tile's base + its warp's + its rank in the warp.
// Integer sums: exact in any order, so equal to a serial scan's.
// The scratch: [tiles, M] status words, then the ticket word, all filled
// with `fill` (any value below 2^31) before the scan's launch (by a launch
// of its own in K8/K14; in K20 the previous launch's last block sets them
// back to 0, csrc/last_block.cuh): a
// status word is ready when its top bit is set (SCAN_AGG: the aggregate in
// the low 30 bits; SCAN_AGG | SCAN_INC: the inclusive prefix), and the
// ticket counts up from `fill`.
constexpr int SCAN_TILE = 256;
constexpr int SCAN_WARPS = SCAN_TILE / 32;
constexpr int SCAN_MAXM = 8;
constexpr unsigned SCAN_AGG = 0x80000000u;
constexpr unsigned SCAN_INC = 0x40000000u;
constexpr unsigned SCAN_VALUE = 0x3fffffffu;

__host__ __device__ inline int scan_tiles(int n) { return (n + SCAN_TILE - 1) / SCAN_TILE; }

struct ScanShared {
  int tile;
  int warp[SCAN_WARPS][SCAN_MAXM];  // new flags a warp and model, then their prefix in the tile
  int agg[SCAN_MAXM];               // the tile's new flags a model
  int base[SCAN_MAXM];              // a model's new flags in the tiles before this one
  int total[SCAN_MAXM];             // ... up to and including this one
};

// this block's tile (call first, before the block's own work)
__device__ inline int scan_ticket(unsigned* scratch, int tiles, int M, unsigned fill,
                                  ScanShared& sc) {
  if (threadIdx.x == 0) sc.tile = (int)(atomicAdd(scratch + tiles * M, 1u) - fill);
  __syncthreads();
  return sc.tile;
}

// every thread of the block calls it, with its pixel's new flag and model
// (`own` outside [0, M): no model); returns the exclusive prefix of the new
// flags of its model at its pixel (0 where it has no model). Afterwards
// sc.total[m] holds model m's new flags up to this tile's end.
__device__ inline int append_scan(unsigned* scratch, int M, int tile, bool newf, int own,
                                  ScanShared& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int rank = 0;
  for (int m = 0; m < M; ++m) {
    const unsigned b = __ballot_sync(0xffffffffu, newf && own == m);
    if (own == m) rank = __popc(b & below);
    if (lane == 0) sc.warp[warp][m] = __popc(b);
  }
  __syncthreads();
  if (threadIdx.x < M) {
    const int m = threadIdx.x;
    int run = 0;
    for (int w = 0; w < SCAN_WARPS; ++w) {
      const int c = sc.warp[w][m];
      sc.warp[w][m] = run;
      run += c;
    }
    sc.agg[m] = run;
  }
  __syncthreads();
  if (warp < M) {
    const int m = warp, agg = sc.agg[m];
    volatile unsigned* st = scratch + m;  // tile t's word: st[t * M]
    int base = 0;
    if (tile > 0) {
      if (lane == 0) st[tile * M] = SCAN_AGG | (unsigned)agg;
      for (int j0 = tile - 1;; j0 -= 32) {
        const int j = j0 - lane;  // before tile 0: an inclusive prefix of 0
        unsigned w;
        do {
          w = j >= 0 ? st[j * M] : SCAN_AGG | SCAN_INC;
        } while (__any_sync(0xffffffffu, !(w & SCAN_AGG)));
        const unsigned inc = __ballot_sync(0xffffffffu, (w & SCAN_INC) != 0u);
        const int stop = inc ? __ffs(inc) - 1 : 31;  // the nearest inclusive prefix
        int v = lane <= stop ? (int)(w & SCAN_VALUE) : 0;
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        base += v;
        if (inc) break;
      }
    }
    if (lane == 0) {
      st[tile * M] = SCAN_AGG | SCAN_INC | (unsigned)(base + agg);
      sc.base[m] = base;
      sc.total[m] = base + agg;
    }
  }
  __syncthreads();
  return own >= 0 && own < M ? sc.base[own] + sc.warp[warp][own] + rank : 0;
}
