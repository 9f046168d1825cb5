// K23 deformation: the embedded deformation graph applied to points.
//
// Replaces: multimotionfusion_tpu/model/deformation.py:123 deform_points and
//   :193 apply_to_map (the constraint points of :163 optimise go through the
//   first entry; optimise's Gauss-Newton solve stays dense linear algebra in
//   model/deformation.py).
// Bound on an H100: bytes for apply_to_map (each of 2^20 surfels reads five
//   channels and writes three: ~33 MB, ~0.01 ms at 3.35 TB/s); the constraint
//   entry (300 points) is latency.
// Design: one thread per point. The graph (at most a few hundred nodes:
//   position, time, A, t, valid; 17 floats each) goes to shared memory once
//   per block. Each thread
//   - finds the left insertion point of its time among the node times with
//     the reference's own binary search (jnp.searchsorted's default "scan"
//     method: ceil(log2(N + 1)) halvings of [0, N), going left where
//     time <= times[mid]), which is also what it returns for unsorted times;
//   - takes the look_back clipped candidates around it, with +inf distance
//     for invalid nodes, and keeps the k + 1 nearest in ascending order with
//     lax.top_k's tie order (the lower candidate position first);
//   - weighs the k nearest by max(1 - d/dmax, 0)^2 (a NaN from inf/inf
//     propagates, as jnp.maximum does, into the uniform 1/k fallback taken
//     where the weights sum to <= 1e-9) and blends the node transforms,
//     every float expression in the plain version's order (built with
//     -fmad=false, so it rounds as PyTorch's separate operations do).
//   The constraint entry also writes each point's chosen nodes and weights
//   (the analytic Jacobian reads them); the map entry gates on the alive flag
//   and the map count, reads the accept flag by pointer (no host value) and
//   writes PX, PY and PZ in place.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SEL = 16;  // k + 1
enum { PX = 0, PY = 1, PZ = 2, INIT_T = 7, ALIVE = 13 };

struct Graph {
  const float* pos;    // [N, 3]
  const float* times;  // [N]
  const float* A;      // [N, 9] row-major
  const float* t;      // [N, 3]
  const uint8_t* valid;
  int N, levels, k, look_back;
};

__device__ inline float pos_inf() { return __uint_as_float(0x7f800000u); }

// shared layout: pos 3N | times N | A 9N | t 3N | valid N (as float)
__device__ void load_graph(const Graph& g, float* s) {
  const int N = g.N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    for (int c = 0; c < 3; ++c) s[3 * i + c] = g.pos[3 * i + c];
    s[3 * N + i] = g.times[i];
    for (int c = 0; c < 9; ++c) s[4 * N + 9 * i + c] = g.A[9 * i + c];
    for (int c = 0; c < 3; ++c) s[13 * N + 3 * i + c] = g.t[3 * i + c];
    s[16 * N + i] = g.valid[i] ? 1.f : 0.f;
  }
  __syncthreads();
}

__device__ void deform_one(const Graph& g, const float* s, const float* p, float time, float* out,
                           int* nid_out, float* wgt_out) {
  const int N = g.N;
  const float* pos = s;
  const float* times = s + 3 * N;
  const float* A = s + 4 * N;
  const float* t = s + 13 * N;
  const float* valid = s + 16 * N;
  unsigned low = 0, high = (unsigned)N;
  for (int l = 0; l < g.levels; ++l) {
    const unsigned mid = (low + high) / 2u;
    if (time <= times[mid]) high = mid;
    else low = mid;
  }
  const int idx0 = (int)high;
  const int off0 = (-g.look_back) >= 0 ? (-g.look_back) / 2 : -((g.look_back + 1) / 2);
  float bd[MAX_SEL];
  int bj[MAX_SEL], bn[MAX_SEL];
  const int sel = g.k + 1;
  for (int q = 0; q < sel; ++q) {
    bd[q] = pos_inf();
    bj[q] = 0x7fffffff;
    bn[q] = 0;
  }
  for (int j = 0; j < g.look_back; ++j) {
    const int c = min(max(idx0 + off0 + j, 0), N - 1);
    const float dx = p[0] - pos[3 * c], dy = p[1] - pos[3 * c + 1], dz = p[2] - pos[3 * c + 2];
    const float d = valid[c] > 0.f ? sqrtf(dx * dx + dy * dy + dz * dz) : pos_inf();
    if (!(d < bd[sel - 1] || (d == bd[sel - 1] && j < bj[sel - 1]))) continue;
    int q = sel - 1;
    while (q > 0 && (d < bd[q - 1] || (d == bd[q - 1] && j < bj[q - 1]))) {
      bd[q] = bd[q - 1];
      bj[q] = bj[q - 1];
      bn[q] = bn[q - 1];
      --q;
    }
    bd[q] = d;
    bj[q] = j;
    bn[q] = c;
  }
  const int k = g.k;
  const float dmax = fmaxf(bd[k], 1e-9f);
  float w[MAX_SEL];
  float wsum = 0.f;
  for (int q = 0; q < k; ++q) {
    float v = 1.f - bd[q] / dmax;
    v = v < 0.f ? 0.f : v;  // NaN stays NaN, as jnp.maximum
    w[q] = v * v;
    wsum = wsum + w[q];
  }
  const bool use = wsum > 1e-9f;
  const float den = fmaxf(wsum, 1e-9f);
  for (int q = 0; q < k; ++q) w[q] = use ? w[q] / den : 1.f / (float)k;
  float o[3] = {0.f, 0.f, 0.f};
  for (int q = 0; q < k; ++q) {
    const int n = bn[q];
    const float d0 = p[0] - pos[3 * n], d1 = p[1] - pos[3 * n + 1], d2 = p[2] - pos[3 * n + 2];
    const float* An = A + 9 * n;
    for (int i = 0; i < 3; ++i) {
      const float m = An[3 * i] * d0 + An[3 * i + 1] * d1 + An[3 * i + 2] * d2 + pos[3 * n + i] +
                      t[3 * n + i];
      o[i] = o[i] + w[q] * m;
    }
    if (nid_out != nullptr) {
      nid_out[q] = n;
      wgt_out[q] = w[q];
    }
  }
  out[0] = o[0];
  out[1] = o[1];
  out[2] = o[2];
}

__global__ void __launch_bounds__(THREADS)
deform_points(const float* __restrict__ pts, const float* __restrict__ ptimes, int P, Graph g,
              float* __restrict__ out, int* __restrict__ nid, float* __restrict__ wgt) {
  extern __shared__ float s[];
  load_graph(g, s);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const float p[3] = {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
  deform_one(g, s, p, ptimes[i], out + 3 * i, nid + (size_t)i * g.k, wgt + (size_t)i * g.k);
}

__global__ void __launch_bounds__(THREADS)
deform_map(float* __restrict__ data, long rs, int cap, const int* __restrict__ count,
           const bool* __restrict__ gate, Graph g) {
  if (gate != nullptr && !*gate) return;
  extern __shared__ float s[];
  load_graph(g, s);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap || i >= *count || !(data[ALIVE * rs + i] > 0.f)) return;
  const float p[3] = {data[PX * rs + i], data[PY * rs + i], data[PZ * rs + i]};
  float o[3];
  deform_one(g, s, p, data[INIT_T * rs + i], o, nullptr, nullptr);
  data[PX * rs + i] = o[0];
  data[PY * rs + i] = o[1];
  data[PZ * rs + i] = o[2];
}

int smem_bytes(int N) { return 17 * N * (int)sizeof(float); }

template <typename Kern>
int prepare(Kern kern, int N, int k, int look_back) {
  if (N < 1 || k < 1 || k + 1 > MAX_SEL || look_back < k + 1) return (int)cudaErrorInvalidValue;
  const int bytes = smem_bytes(N);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" int mmf_deform_points(const float* pts, const float* ptimes, int P, const float* pos,
                                 const float* times, const float* A, const float* t,
                                 const uint8_t* valid, int N, int levels, int k, int look_back,
                                 float* out, int* nid, float* wgt, cudaStream_t stream) {
  int err = prepare(deform_points, N, k, look_back);
  if (err) return err;
  if (P < 1) return 0;
  Graph g{pos, times, A, t, valid, N, levels, k, look_back};
  deform_points<<<(P + THREADS - 1) / THREADS, THREADS, smem_bytes(N), stream>>>(pts, ptimes, P,
                                                                                 g, out, nid, wgt);
  return (int)cudaGetLastError();
}

extern "C" int mmf_deform_map(float* data, long rs, int cap, const int* count, const bool* gate,
                              const float* pos, const float* times, const float* A,
                              const float* t, const uint8_t* valid, int N, int levels, int k,
                              int look_back, cudaStream_t stream) {
  int err = prepare(deform_map, N, k, look_back);
  if (err) return err;
  Graph g{pos, times, A, t, valid, N, levels, k, look_back};
  deform_map<<<(cap + THREADS - 1) / THREADS, THREADS, smem_bytes(N), stream>>>(data, rs, cap,
                                                                               count, gate, g);
  return (int)cudaGetLastError();
}
