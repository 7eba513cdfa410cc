// The sLSTM recurrence (xLSTM's scalar-memory cell) on Hopper: K6, the
// forward, and K6b, its backward.
//
// Replaces no TPU kernel: the reference runs this cell as a lax.scan over
// time in plain jnp on every device (repro/kernels/ref.py:419
// slstm_scan, called through repro/kernels/ops.py:166), which XLA
// compiles into one loop. Eager PyTorch has no such loop: the plain
// version (kernels/ref.py slstm_walk) launches about 15 element-wise
// kernels a time step, and its autograd backward as many again, so at
// 2048 steps a layer the training step would spend its time launching.
// K6 and K6b walk the whole sequence inside one launch each.
//
// Function, per channel (batch row, head, e), in float32:
//
//   lf = log_sigmoid(f),  m' = max(lf + m, i),
//   iw = exp(i - m'),     fw = exp(lf + m - m'),
//   c' = fw c + iw tanh(z),  n' = fw n + iw,
//   y = sigmoid(o) c' / max(n', 1e-6)
//
// Contract: gates [b, s, h, 4, e] (i, f, z, o) in float32 or bf16, y [b,
// s, h, e] in the gates' dtype; the state (c, n, m) [b, h, e] float32
// each, zeros when the in-pointers are null; the state after step s - 1
// out when its pointers are non-null. With `states` non-null K6 also
// saves the state before each step, [3, b, s, h, e] float32 (c, n, m):
// what K6b reads. K6b takes gates, dy [b, s, h, e] (the gates' dtype),
// those saved states and the final state's cotangent (zeros when null),
// and writes dgates [b, s, h, 4, e] (the gates' dtype) and the initial
// state's cotangent (where its pointers are non-null). Its order of
// operations is kernels/ref.py slstm_scan_bwd's, step by step: the
// clamp max(n', 1e-6) passes no gradient to n' where it binds and half at
// a tie, as the max of m' splits a tie evenly, as JAX's and torch's
// maximum do.
//
// What bounds it on the H100. At the training shape (b 2, s 2048, 4
// heads of 512, bf16) the forward moves 33.6 MB of gates and 8.4 MB of y,
// 12.5 us at 3.35 TB/s, plus 100.7 MB of saved states when it saves them;
// its ~40 float32 operations a channel and step are 0.34 G operations, 5
// us at 67 TFLOP/s. But the recurrence is sequential in time and has
// only b h e = 4096 independent channels: 32 warps on a card of 132 SMs.
// So neither the bytes nor the operations bound it, but the dependent
// chain of each step times s: the stabiliser m' = max(lf + m, i) (two
// dependent float operations a step) and c' = fw c + ... (one FFMA after
// fw), with the loads of each step's gates in flight beside it.
//
// Design (simple and right first): one thread a channel, threads along e
// (so each gate's load and y's store are coalesced over a warp), the
// state in registers for the whole walk. Each thread loads the gates of
// the next U steps into registers while it computes the current U (a
// register double buffer), so the loads' latency hides behind the
// arithmetic of the steps before. K6b walks back from the last step
// with the same double buffer over gates, dy and the saved states, and
// recomputes each step's forward from its saved state: the saved states
// cost 12 bytes a channel and step written by K6 and read by K6b (the
// alternative, recomputing them in K6b, needs a forward walk first and
// the same bytes in scratch).
//
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // threads (channels) a block
constexpr int U_FWD = 8;       // steps a register tile, forward
constexpr int U_BWD = 4;       // steps a register tile, backward
constexpr float N_MIN = 1e-6f;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// log_sigmoid(x) = -softplus(-x) = min(x, 0) - log1p(exp(-|x|)), JAX's
// logaddexp form (finite for the +-1e30 of padding)
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// d max(a, b) / da: 1 above, 0.5 at a tie, 0 below
__device__ __forceinline__ float tie_weight(float a, float b) {
  return a > b ? 1.f : (a == b ? 0.5f : 0.f);
}

struct Geo {
  int b, s, h, e;
  long long ch;      // this thread's channel, (b, h, e) row-major
  long long gbase;   // gates offset of step 0, gate 0
  long long ybase;   // y / dy / states offset of step 0
  long long gstep;   // h 4 e: gates elements a step
  long long ystep;   // h e: y elements a step
  long long plane;   // b s h e: one of the saved states' planes
};

__device__ __forceinline__ bool geo(int b, int s, int h, int e, Geo& g) {
  g.ch = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g.ch >= (long long)b * h * e) return false;
  const int ei = (int)(g.ch % e);
  const long long bh = g.ch / e;
  const int hi = (int)(bh % h);
  const long long bi = bh / h;
  g.b = b, g.s = s, g.h = h, g.e = e;
  g.gbase = (bi * s * h + hi) * 4LL * e + ei;
  g.ybase = (bi * s * h + hi) * (long long)e + ei;
  g.gstep = 4LL * h * e;
  g.ystep = (long long)h * e;
  g.plane = (long long)b * s * h * e;
  return true;
}

template <typename T>
__device__ __forceinline__ void load_fwd(const T* gates, const Geo& g,
                                         int t0, float (&buf)[U_FWD][4]) {
#pragma unroll
  for (int u = 0; u < U_FWD; ++u) {
    const int t = t0 + u;
    if (t < g.s) {
      const T* p = gates + g.gbase + t * g.gstep;
#pragma unroll
      for (int k = 0; k < 4; ++k) buf[u][k] = load(p + k * g.e);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    slstm_fwd_kernel(const T* __restrict__ gates,
                     const float* __restrict__ c0,
                     const float* __restrict__ n0,
                     const float* __restrict__ m0, T* __restrict__ y,
                     float* __restrict__ c1, float* __restrict__ n1,
                     float* __restrict__ m1, float* __restrict__ states,
                     int b, int s, int h, int e) {
  Geo g;
  if (!geo(b, s, h, e, g)) return;
  float c = c0 ? c0[g.ch] : 0.f;
  float n = n0 ? n0[g.ch] : 0.f;
  float m = m0 ? m0[g.ch] : 0.f;
  float cur[U_FWD][4], nxt[U_FWD][4] = {};
  load_fwd(gates, g, 0, cur);
  for (int t0 = 0; t0 < s; t0 += U_FWD) {
    if (t0 + U_FWD < s) load_fwd(gates, g, t0 + U_FWD, nxt);
#pragma unroll
    for (int u = 0; u < U_FWD; ++u) {
      const int t = t0 + u;
      if (t >= s) break;
      const long long yo = g.ybase + t * g.ystep;
      if (states) {
        states[yo] = c;
        states[g.plane + yo] = n;
        states[2 * g.plane + yo] = m;
      }
      const float gi = cur[u][0], gf = cur[u][1];
      const float gz = cur[u][2], go = cur[u][3];
      const float lf = log_sigmoid(gf);
      const float m_new = fmaxf(lf + m, gi);
      const float iw = expf(gi - m_new);
      const float fw = expf(lf + m - m_new);
      c = fw * c + iw * tanhf(gz);
      n = fw * n + iw;
      m = m_new;
      store(y + yo, sigmoid(go) * c / fmaxf(n, N_MIN));
    }
#pragma unroll
    for (int u = 0; u < U_FWD; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) cur[u][k] = nxt[u][k];
  }
  if (c1) c1[g.ch] = c;
  if (n1) n1[g.ch] = n;
  if (m1) m1[g.ch] = m;
}

// the backward's tile u holds step t = s - 1 - (r0 + u): gates (4), dy,
// and the saved state before the step (c, n, m)
template <typename T>
__device__ __forceinline__ void load_bwd(const T* gates, const T* dy,
                                         const float* states, const Geo& g,
                                         int r0, float (&buf)[U_BWD][8]) {
#pragma unroll
  for (int u = 0; u < U_BWD; ++u) {
    const int t = g.s - 1 - (r0 + u);
    if (t >= 0) {
      const T* p = gates + g.gbase + t * g.gstep;
#pragma unroll
      for (int k = 0; k < 4; ++k) buf[u][k] = load(p + k * g.e);
      const long long yo = g.ybase + t * g.ystep;
      buf[u][4] = load(dy + yo);
      buf[u][5] = states[yo];
      buf[u][6] = states[g.plane + yo];
      buf[u][7] = states[2 * g.plane + yo];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    slstm_bwd_kernel(const T* __restrict__ gates, const T* __restrict__ dy,
                     const float* __restrict__ states,
                     const float* __restrict__ dc1,
                     const float* __restrict__ dn1,
                     const float* __restrict__ dm1, T* __restrict__ dgates,
                     float* __restrict__ dc0, float* __restrict__ dn0,
                     float* __restrict__ dm0, int b, int s, int h, int e) {
  Geo g;
  if (!geo(b, s, h, e, g)) return;
  float dc = dc1 ? dc1[g.ch] : 0.f;
  float dn = dn1 ? dn1[g.ch] : 0.f;
  float dm = dm1 ? dm1[g.ch] : 0.f;
  float cur[U_BWD][8], nxt[U_BWD][8] = {};
  load_bwd(gates, dy, states, g, 0, cur);
  for (int r0 = 0; r0 < s; r0 += U_BWD) {
    if (r0 + U_BWD < s) load_bwd(gates, dy, states, g, r0 + U_BWD, nxt);
#pragma unroll
    for (int u = 0; u < U_BWD; ++u) {
      const int t = s - 1 - (r0 + u);
      if (t < 0) break;
      const float gi = cur[u][0], gf = cur[u][1];
      const float gz = cur[u][2], go = cur[u][3];
      const float gy = cur[u][4];
      const float c = cur[u][5], n = cur[u][6], m = cur[u][7];
      // the step's forward, recomputed from the saved state
      const float lf = log_sigmoid(gf);
      const float a = lf + m;
      const float mn = fmaxf(a, gi);
      const float iw = expf(gi - mn);
      const float fw = expf(a - mn);
      const float tz = tanhf(gz);
      const float cn = fw * c + iw * tz;
      const float nn = fw * n + iw;
      const float sg = sigmoid(go);
      const float nd = fmaxf(nn, N_MIN);
      // y = sg cn / nd
      const float p = sg * cn;
      const float dp = gy / nd;
      const float dnd = -(gy * p) / (nd * nd);
      const float dcn = dc + dp * sg;
      const float dnn = dn + dnd * tie_weight(nn, N_MIN);
      const float dgo = dp * cn * sg * (1.f - sg);
      // cn = fw c + iw tz, nn = fw n + iw
      const float dfw = dcn * c + dnn * n;
      const float diw = dcn * tz + dnn;
      const float dgz = dcn * iw * (1.f - tz * tz);
      dc = dcn * fw;
      dn = dnn * fw;
      // iw = exp(i - mn), fw = exp(a - mn), mn = max(a, i)
      const float e_i = diw * iw, e_f = dfw * fw;
      const float dmn = dm - e_i - e_f;
      const float wa = tie_weight(a, gi);
      const float da = e_f + dmn * wa;
      const float dgi = e_i + dmn * (1.f - wa);
      // a = lf + m, lf = log_sigmoid(f)
      dm = da;
      const float dgf = da * sigmoid(-gf);
      T* q = dgates + g.gbase + t * g.gstep;
      store(q, dgi);
      store(q + g.e, dgf);
      store(q + 2 * g.e, dgz);
      store(q + 3 * g.e, dgo);
    }
#pragma unroll
    for (int u = 0; u < U_BWD; ++u)
#pragma unroll
      for (int k = 0; k < 8; ++k) cur[u][k] = nxt[u][k];
  }
  if (dc0) dc0[g.ch] = dc;
  if (dn0) dn0[g.ch] = dn;
  if (dm0) dm0[g.ch] = dm;
}

int blocks_for(int b, int h, int e) {
  const long long ch = (long long)b * h * e;
  return (int)((ch + THREADS - 1) / THREADS);
}

}  // namespace

// K6. dtype: 0 float32, 1 bfloat16 (gates and y). Returns 0, a
// cudaError_t from the launch, or -1 for a dtype it has no body for.
extern "C" int slstm_scan_fwd(const void* gates, const float* c0,
                              const float* n0, const float* m0, void* y,
                              float* c1, float* n1, float* m1,
                              float* states, int b, int s, int h, int e,
                              int dtype, void* stream) {
  if ((long long)b * h * e == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = blocks_for(b, h, e);
  if (dtype == 0) {
    slstm_fwd_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(gates), c0, n0, m0, static_cast<float*>(y),
        c1, n1, m1, states, b, s, h, e);
  } else if (dtype == 1) {
    slstm_fwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(gates), c0, n0, m0,
        static_cast<__nv_bfloat16*>(y), c1, n1, m1, states, b, s, h, e);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

// K6b. dtype as K6's (gates, dy and dgates). Returns as K6.
extern "C" int slstm_scan_bwd(const void* gates, const void* dy,
                              const float* states, const float* dc1,
                              const float* dn1, const float* dm1,
                              void* dgates, float* dc0, float* dn0,
                              float* dm0, int b, int s, int h, int e,
                              int dtype, void* stream) {
  if ((long long)b * h * e == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = blocks_for(b, h, e);
  if (dtype == 0) {
    slstm_bwd_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(gates), static_cast<const float*>(dy),
        states, dc1, dn1, dm1, static_cast<float*>(dgates), dc0, dn0, dm0,
        b, s, h, e);
  } else if (dtype == 1) {
    slstm_bwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(gates),
        static_cast<const __nv_bfloat16*>(dy), states, dc1, dn1, dm1,
        static_cast<__nv_bfloat16*>(dgates), dc0, dn0, dm0, b, s, h, e);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

// The launch shape: out[0] threads a block, out[1] steps a register tile
// of the forward, out[2] of the backward. Returns 0.
extern "C" int slstm_scan_shape(int* out) {
  out[0] = THREADS;
  out[1] = U_FWD;
  out[2] = U_BWD;
  return 0;
}
