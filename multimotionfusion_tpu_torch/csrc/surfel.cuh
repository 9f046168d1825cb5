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

#include "scan.cuh"

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

// A window staged in shared memory (K14's clean, fuse_flat.cu): per staged
// position of an image tile widened by the window's halo, the index map's
// winner (-1: none or off the image) with its model where the winner passes
// that model's confidence gate (cconf > conf_all[model]; else -1, which no
// pixel's model equals), and the winner's channels that window_counts
// reads, packed so that a tap reads three words.
template <int N>
struct CleanStage {
  float4 p[N];     // px, py, pz, init_t
  int2 key[N];     // winner, gated model
  float last[N];   // last_t
};

// window_counts over a staged window whose first position is s0 (rows sw
// apart): the same candidates in the same order and the same tests, the
// confidence gate already folded into the staged model and czp > qz, which
// both counts need, tested first; WINDOW > 0 fixes the window at compile
// time (the loops unrolled)
template <int N, int WINDOW>
__device__ inline void window_counts_staged(const CleanStage<N>& st, int s0, int sw, int window,
                                            int own, int i, float qx, float qy, float qz,
                                            float q_init, float q_rad, float q_nz, float time,
                                            int* count, int* z_count) {
  int n_red = 0, n_z = 0;
  if (WINDOW > 0) window = WINDOW;
#pragma unroll
  for (int dy = 0; dy < window; ++dy) {
#pragma unroll
    for (int dx = 0; dx < window; ++dx) {
      const int s = s0 + dy * sw + dx;
      const int2 key = st.key[s];
      if (key.x < 0 || key.x == i || key.y != own) continue;
      const float4 c = st.p[s];
      const float czp = c.z;
      if (!(czp > qz)) continue;
      const float ex = c.x - qx, ey = c.y - qy;
      const float xy_dist = sqrtf(ex * ex + ey * ey);
      const bool red = c.w < q_init && (czp - qz < 0.01f) && xy_dist < q_rad * 1.4f;
      const bool zc = st.last[s] == time && (czp - qz > 0.01f) && q_nz > 0.85f;
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
