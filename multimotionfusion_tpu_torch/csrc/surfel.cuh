// Surfel-column code shared by the single-model kernels (zbuffer.cu K6,
// fuse.cu K8, clean.cu K9) and their composite counterparts over the flat
// store of all models (zbuffer.cu K12, fuse_flat.cu K14). Included inside
// each source's anonymous namespace; build_all rebuilds every source when
// this header changes. Poses are row-major [4, 4] floats on the card.

constexpr int CH = 16;
enum {
  PX = 0, PY = 1, PZ = 2, CONF = 3, CR = 4, CG = 5, CB = 6, INIT_T = 7, LAST_T = 8,
  NX = 9, NY = 10, NZ = 11, RADIUS = 12, ALIVE = 13
};
constexpr int KEY_INVALID = 0x7fffffff;

__global__ void fill_int(int* __restrict__ a, int n, int v) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) a[i] = v;
}

// float -> int with the same order, so an atomicMin on the int is a float
// min (-1 included) whatever order the threads run in
__device__ inline int ford(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ inline float fval(int i) { return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff); }

__global__ void fill_verdicts(int* __restrict__ vk, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) vk[i] = ford(1.0f);
}

// ------------------------------------------------------------------ z-buffer

// column i of `data` transformed by T into column i of data_local ([16, n]);
// pl gets the transformed position
__device__ inline void write_local(const float* __restrict__ data, int rs, int n, int i,
                                   const float* T, float* __restrict__ data_local, float* pl) {
  float p[3] = {data[PX * rs + i], data[PY * rs + i], data[PZ * rs + i]};
  float nv[3] = {data[NX * rs + i], data[NY * rs + i], data[NZ * rs + i]};
  float nl[3];
  for (int r = 0; r < 3; ++r) {
    pl[r] = T[4 * r] * p[0] + T[4 * r + 1] * p[1] + T[4 * r + 2] * p[2] + T[4 * r + 3];
    nl[r] = T[4 * r] * nv[0] + T[4 * r + 1] * nv[1] + T[4 * r + 2] * nv[2];
  }
  for (int c = 0; c < CH; ++c) {
    float v = data[c * rs + i];
    if (c <= PZ) v = pl[c];
    if (c >= NX && c <= NZ) v = nl[c - NX];
    data_local[c * n + i] = v;
  }
}

// the pixel of a camera-frame point (z > 0: the reference's safe_z is z
// itself; __float2int_rn is round-half-even and saturates far outside the
// image); false when it falls outside
__device__ inline bool project(const float* pl, float fx, float fy, float cx, float cy, int W,
                               int H, int* pix) {
  int u = __float2int_rn(pl[0] * fx / pl[2] + cx);
  int v = __float2int_rn(pl[1] * fy / pl[2] + cy);
  if (u < 0 || v < 0 || u >= W || v >= H) return false;
  *pix = v * W + u;
  return true;
}

// log-depth bin of z in [0, levels - 2]
__device__ inline int depth_bin(float z, int levels) {
  float zqf = (log2f(fmaxf(z, 1e-6f)) + 4.0f) * ((float)levels / 8.0f);
  int zq = __float2int_rz(zqf);
  return min(max(zq, 0), levels - 2);
}

// ---------------------------------------------------------------------- fuse

// one candidate c of the 4x4 association window: the |zdiff * lambda| gate,
// the ray distance and the normal conformance; the nearest ray wins
__device__ inline void assoc_candidate(const float* __restrict__ dl, int B, int c, float fz,
                                       float fnx, float fny, float fnz, float xl, float yl,
                                       float lam, float gate, float* best_dist, int* best) {
  float cpx = dl[PX * B + c], cpy = dl[PY * B + c], cpz = dl[PZ * B + c];
  bool z_ok = fabsf((cpz - fz) * lam) < gate;
  float rx = yl * cpz - cpy;
  float ry = cpx - xl * cpz;
  float rz = xl * cpy - yl * cpx;
  float dist = sqrtf(rx * rx + ry * ry + rz * rz);
  float cnx = dl[NX * B + c], cny = dl[NY * B + c], cnz = dl[NZ * B + c];
  float cosang = fminf(fmaxf(cnx * fnx + cny * fny + cnz * fnz, -1.0f), 1.0f);
  bool n_ok = (fabsf(cnz) < 0.75f) || (fabsf(acosf(cosang)) < 0.5f);
  if (z_ok && n_ok && dist < *best_dist) {
    *best_dist = dist;
    *best = c;
  }
}

// position and normal of a column transformed by T, in place
__device__ inline void transform(float* s, const float* T) {
  float p0 = s[PX], p1 = s[PY], p2 = s[PZ];
  float n0 = s[NX], n1 = s[NY], n2 = s[NZ];
  for (int r = 0; r < 3; ++r) {
    s[PX + r] = T[4 * r] * p0 + T[4 * r + 1] * p1 + T[4 * r + 2] * p2 + T[4 * r + 3];
    s[NX + r] = T[4 * r] * n0 + T[4 * r + 1] * n1 + T[4 * r + 2] * n2;
  }
}

// the confidence-weighted merge of a new column into an old one (both in
// the model's frame); the radius gate keeps the old geometry
__device__ inline void merge(const float* old, const float* nw, float time, float* m) {
  float ck = old[CONF], a = nw[CONF];
  float csum = fmaxf(ck + a, 1e-12f);
  bool rad_ok = nw[RADIUS] < 1.5f * old[RADIUS];
  for (int c = 0; c < CH; ++c) m[c] = old[c];
  if (rad_ok) {
    const int lin[6] = {PX, PY, PZ, CR, CG, CB};
    for (int q = 0; q < 6; ++q) {
      int c = lin[q];
      m[c] = (ck * old[c] + a * nw[c]) / csum;
    }
    float nmx = (ck * old[NX] + a * nw[NX]) / csum;
    float nmy = (ck * old[NY] + a * nw[NY]) / csum;
    float nmz = (ck * old[NZ] + a * nw[NZ]) / csum;
    float nn = sqrtf(fmaxf(nmx * nmx + nmy * nmy + nmz * nmz, 1e-12f));
    m[NX] = nmx / nn;
    m[NY] = nmy / nn;
    m[NZ] = nmz / nn;
    m[RADIUS] = (ck * old[RADIUS] + a * nw[RADIUS]) / csum;
  }
  m[CONF] = ck + a;
  m[LAST_T] = time;
}

// ---------------------------------------------------------- the append scan

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
// with `fill` (any value below 2^31) by a launch before the scan's: a
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

// --------------------------------------------------------------------- clean

// the redundant and z-ordered neighbours of winner i (at pixel x, y) in the
// window (offsets -window/2 ..): candidates of the winner-model image `win`
// equal to `own` only, unless win is null (one model)
__device__ inline void window_counts(const int* __restrict__ index, const float* __restrict__ dl,
                                     int B, const int* __restrict__ win, int own, int H, int W,
                                     int window, int x, int y, int i, float conf_thr, float time,
                                     int* count, int* z_count) {
  float qx = dl[PX * B + i], qy = dl[PY * B + i], qz = dl[PZ * B + i];
  float q_init = dl[INIT_T * B + i], q_rad = dl[RADIUS * B + i];
  float q_nz = fabsf(dl[NZ * B + i]);
  int n_red = 0, n_z = 0;
  int r = window / 2;
  for (int dy = -r; dy < window - r; ++dy) {
    int yy = y + dy;
    for (int dx = -r; dx < window - r; ++dx) {
      int xx = x + dx;
      if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
      int q = yy * W + xx;
      int c = index[q];
      if (c < 0 || c == i || (win != nullptr && win[q] != own)) continue;
      float cpx = dl[PX * B + c], cpy = dl[PY * B + c], czp = dl[PZ * B + c];
      float cconf = dl[CONF * B + c], cinit = dl[INIT_T * B + c], clast = dl[LAST_T * B + c];
      float ex = cpx - qx, ey = cpy - qy;
      float xy_dist = sqrtf(ex * ex + ey * ey);
      bool red = cinit < q_init && cconf > conf_thr && czp > qz && (czp - qz < 0.01f) &&
                 xy_dist < q_rad * 1.4f;
      bool zc = clast == time && cconf > conf_thr && czp > qz && (czp - qz > 0.01f) &&
                q_nz > 0.85f;
      n_red += red;
      n_z += zc;
    }
  }
  *count = n_red;
  *z_count = n_z;
}

// the 3x3 see-through penalty at pixel (x, y) for a winner at depth qz;
// *viol tells whether any neighbour lies behind it by more than the gate
__device__ inline float see_through(const float* __restrict__ depth, int H, int W, int x, int y,
                                    float qz, float gate, float coeff, bool* viol) {
  int violations = 0;
  float viol_sum = 0.f;
  for (int dy = -1; dy <= 1; ++dy)
    for (int dx = -1; dx <= 1; ++dx) {
      int yy = y + dy, xx = x + dx;
      float d = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? depth[yy * W + xx] : 0.f;
      float delta = d - qz;
      bool hit = d > 0.f && delta > gate;
      violations += hit;
      viol_sum = viol_sum + (hit ? delta : 0.f);
    }
  *viol = violations > 0;
  float avg_v = viol_sum / fmaxf((float)violations, 1.f);
  return *viol ? 1.f / (1.f + coeff * avg_v) : 1.f;
}

// a slot's keep verdict from its scatter-min verdict v (-1 = culled, else
// the confidence penalty, returned in *pen): the visual cull, the unstable
// cull below conf_thr after `grace`, the inactive keep after time_delta
__device__ inline bool keep_surfel(bool alive, int v_ord, float last_t, float conf, float time,
                                   float grace, float conf_thr, float time_delta, float* pen) {
  float v = fval(v_ord);
  bool culled = v < 0.f;
  *pen = culled ? 1.f : v;
  bool keep = alive && !culled;
  bool unstable_dead = (time - last_t) > grace && conf < conf_thr;
  keep = keep && !unstable_dead;
  return keep || (alive && last_t > 0.f && (time - last_t) > time_delta);
}
