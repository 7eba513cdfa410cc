// Fused vocabulary cross-entropy on Hopper: loss statistics, dh and dW of
// softmax cross-entropy over a tied head, without the [n, vocab] logits
// ever reaching device memory.
//
// Replaces the TPU kernel repro/kernels/fused_xent.py:109 softmax_xent
// (bodies _p1_kernel :28 and _p2_kernel :64). The port reaches it from
// the trainer's loss (core/vocab.py loss_and_dy, one-rank branch), with
// the bf16 embedding table [V, d] read in place as the head.
//
// Contract: h [n, d] float32 (final-norm output), w [V, d] float32 or
// bfloat16, labels int32 [n] in [0, V), scale float32 [n] (mask / denom).
//   fused_xent_fwd: lse [n] = logsumexp_v(h w^T), labl [n] = the label's
//     logit; pm, pl [n, ceil(V/128)] float32 scratch.
//   fused_xent_bwd: dlog = (softmax - onehot) * scale, dh [n, d] =
//     dlog w, dw [V, d] = dlog^T h, both float32; dlog [n, Vc] float32
//     scratch for one vocabulary chunk of Vc columns (Vc % 128 == 0).
// Requires d % 8 == 0. Everything is computed in float32 (w upcast while
// it is staged), as the reference computes it.
//
// Design: every product is one tiled float32 GEMM core (128 x 128 output
// tile, 8-deep k steps through shared memory, 8 x 8 outputs a thread,
// the next k step's loads in flight while the current one computes).
//   pass 1 (fwd): blocks own (row tile, vocab tile); the epilogue reduces
//     each row's tile to (max, sum of exp) and picks the label logit; a
//     second kernel combines the tiles into lse.
//   pass 2 (bwd), per vocabulary chunk: blocks owning (row tile, vocab
//     tile) recompute the logits and write dlog for the chunk; blocks
//     owning (vocab tile, d tile) loop over every row and write the
//     chunk's dW rows; blocks owning (row tile, d tile) loop over the
//     chunk's vocabulary and add into dh. Each output element has one
//     writer: no atomics, and the result is deterministic.
// Logits exist only as one [n, Vc] chunk of dlog (64 MB at n = 2048,
// Vc = 8192), never as [n, V] (1 GB).
//
// Bound on the H100: operations. The function needs three GEMM-shaped
// products of 2 n d V flops each (logits, dh, dW): 3.2 TFLOP a call at
// n = d = 2048, V = 128256, against 0.5 GB of table read and 1 GB of dW
// written — thousands of flops a byte. The design spends a fourth product
// (the logits recomputed in pass 2) to keep them out of device memory,
// and runs the GEMMs on the CUDA cores in float32 (the reference's
// arithmetic); tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int GT = 256;      // threads a block
constexpr int TB = 128;      // output tile rows and columns
constexpr int BK = 8;        // k depth per shared-memory step
constexpr int LDS = TB + 4;  // padded k-major row of a staged tile

__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int u = 0; u < 4; ++u) f[u] = __bfloat162float(e[u]);
}

// An operand whose depth is contiguous: element (row r, depth k) at
// p[r * ld + k]. Rows at or past `rows` and depth at or past K read 0.
template <typename T>
struct DepthMajor {
  const T* p;
  int ld, rows, K;
  __device__ void load(int r0, int k0, float (&f)[4]) const {
    const int r = r0 + (threadIdx.x >> 1), k = k0 + (threadIdx.x & 1) * 4;
    if (r < rows && k < K) {
      load4(p + static_cast<size_t>(r) * ld + k, f);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) f[u] = 0.f;
    }
  }
  __device__ void store(const float (&f)[4], float* s) const {
    const int r = threadIdx.x >> 1, k = (threadIdx.x & 1) * 4;
#pragma unroll
    for (int u = 0; u < 4; ++u) s[(k + u) * LDS + r] = f[u];
  }
};

// An operand whose rows are contiguous: element (row r, depth k) at
// p[k * ld + r]. rows % 4 == 0; depth at or past K reads 0.
template <typename T>
struct RowMajor {
  const T* p;
  int ld, rows, K;
  __device__ void load(int r0, int k0, float (&f)[4]) const {
    const int k = k0 + (threadIdx.x >> 5), r = r0 + (threadIdx.x & 31) * 4;
    if (r < rows && k < K) {
      load4(p + static_cast<size_t>(k) * ld + r, f);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) f[u] = 0.f;
    }
  }
  __device__ void store(const float (&f)[4], float* s) const {
    const int k = threadIdx.x >> 5, r = (threadIdx.x & 31) * 4;
    *reinterpret_cast<float4*>(s + k * LDS + r) =
        make_float4(f[0], f[1], f[2], f[3]);
  }
};

// Output row / column of a thread's accumulator entry i (ty or tx = the
// thread's 16-way index): two groups of 4, 64 apart.
__device__ __forceinline__ int sub(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

// acc[i][j] = sum_k A(a0 + sub(ty, i), k) * B(b0 + sub(tx, j), k).
template <class LA, class LB>
__device__ __forceinline__ void gemm(const LA& A, const LB& B, int a0, int b0,
                                     int K, float (&acc)[8][8], float* As,
                                     float* Bs) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float fa[4], fb[4];
  A.load(a0, 0, fa);
  B.load(b0, 0, fb);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous step's reads of As/Bs are done
    A.store(fa, As);
    B.store(fb, Bs);
    __syncthreads();
    if (k0 + BK < K) {  // next step's loads in flight during the math
      A.load(a0, k0 + BK, fa);
      B.load(b0, k0 + BK, fb);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float* a_row = As + kk * LDS;
      const float* b_row = Bs + kk * LDS;
      const float4 x0 = *reinterpret_cast<const float4*>(a_row + ty * 4);
      const float4 x1 = *reinterpret_cast<const float4*>(a_row + 64 + ty * 4);
      const float4 y0 = *reinterpret_cast<const float4*>(b_row + tx * 4);
      const float4 y1 = *reinterpret_cast<const float4*>(b_row + 64 + tx * 4);
      const float a[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float b[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Reduction over the 16 lanes that share a row (consecutive lanes).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// pass 1: per (row tile, vocab tile) max and sum of exp of the logits,
// and the label logit of the rows whose label falls in the tile.
template <typename TW>
__global__ void __launch_bounds__(GT)
    stats_kernel(const float* __restrict__ h, const TW* __restrict__ w,
                 const int* __restrict__ labels, float* __restrict__ pm,
                 float* __restrict__ pl, float* __restrict__ labl, int n,
                 int d, int V, int nvt) {
  __shared__ __align__(16) float As[BK * LDS];
  __shared__ __align__(16) float Bs[BK * LDS];
  const int v0 = blockIdx.x * TB, m0 = blockIdx.y * TB;
  float acc[8][8];
  gemm(DepthMajor<float>{h, d, n, d}, DepthMajor<TW>{w, d, V, d}, m0, v0, d,
       acc, As, Bs);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + sub(ty, i);
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (v0 + sub(tx, j) < V) tmax = fmaxf(tmax, acc[i][j]);
    tmax = row_max(tmax);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (v0 + sub(tx, j) < V) s += expf(acc[i][j] - tmax);
    s = row_sum(s);
    if (row < n) {
      if (tx == 0) {
        pm[static_cast<size_t>(row) * nvt + blockIdx.x] = tmax;
        pl[static_cast<size_t>(row) * nvt + blockIdx.x] = s;
      }
      const int lab = labels[row];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (v0 + sub(tx, j) == lab) labl[row] = acc[i][j];
    }
  }
}

// lse[row] from the per-tile (max, sum) pairs; one warp a row.
__global__ void __launch_bounds__(GT)
    lse_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
               float* __restrict__ lse, int n, int nvt) {
  const int row = blockIdx.x * (GT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* m = pm + static_cast<size_t>(row) * nvt;
  const float* l = pl + static_cast<size_t>(row) * nvt;
  float mx = -INFINITY;
  for (int t = lane; t < nvt; t += 32) mx = fmaxf(mx, m[t]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float s = 0.f;
  for (int t = lane; t < nvt; t += 32) s += l[t] * expf(m[t] - mx);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) lse[row] = mx + logf(fmaxf(s, 1e-30f));
}

// pass 2a: dlog[row, c] = (exp(logit - lse) - onehot) * scale[row] for the
// chunk's columns c0 + c (c < Vc); columns at or past V are 0.
template <typename TW>
__global__ void __launch_bounds__(GT)
    dlog_kernel(const float* __restrict__ h, const TW* __restrict__ w,
                const int* __restrict__ labels,
                const float* __restrict__ lse,
                const float* __restrict__ scale, float* __restrict__ dlog,
                int n, int d, int V, int c0, int Vc) {
  __shared__ __align__(16) float As[BK * LDS];
  __shared__ __align__(16) float Bs[BK * LDS];
  const int v0 = blockIdx.x * TB, m0 = blockIdx.y * TB;
  float acc[8][8];
  gemm(DepthMajor<float>{h, d, n, d},
       DepthMajor<TW>{w + static_cast<size_t>(c0) * d, d, V - c0, d}, m0, v0,
       d, acc, As, Bs);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + sub(ty, i);
    if (row >= n) continue;
    const float l = lse[row], sc = scale[row];
    const int lab = labels[row] - c0;
    float* dst = dlog + static_cast<size_t>(row) * Vc + v0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = half * 4 + u, c = v0 + sub(tx, j);
        const float p = c0 + c < V ? expf(acc[i][j] - l) : 0.f;
        o[u] = (p - (c == lab ? 1.f : 0.f)) * sc;
      }
      *reinterpret_cast<float4*>(dst + half * 64 + tx * 4) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// pass 2b: dw[c0 + c, :] = sum_rows dlog[row, c] * h[row, :] for c < cw.
__global__ void __launch_bounds__(GT)
    dw_kernel(const float* __restrict__ dlog, const float* __restrict__ h,
              float* __restrict__ dw, int n, int d, int c0, int Vc, int cw) {
  __shared__ __align__(16) float As[BK * LDS];
  __shared__ __align__(16) float Bs[BK * LDS];
  const int e0 = blockIdx.x * TB, c_0 = blockIdx.y * TB;
  float acc[8][8];
  gemm(RowMajor<float>{dlog, Vc, Vc, n}, RowMajor<float>{h, d, d, n}, c_0,
       e0, n, acc, As, Bs);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c_0 + sub(ty, i);
    if (c >= cw) continue;
    float* dst = dw + static_cast<size_t>(c0 + c) * d + e0;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (e0 + half * 64 + tx * 4 < d)
        *reinterpret_cast<float4*>(dst + half * 64 + tx * 4) = make_float4(
            acc[i][half * 4], acc[i][half * 4 + 1], acc[i][half * 4 + 2],
            acc[i][half * 4 + 3]);
  }
}

// pass 2c: dh[row, :] (+)= sum_{c < cw} dlog[row, c] * w[c0 + c, :].
template <typename TW>
__global__ void __launch_bounds__(GT)
    dh_kernel(const float* __restrict__ dlog, const TW* __restrict__ w,
              float* __restrict__ dh, int n, int d, int c0, int Vc, int cw,
              int accumulate) {
  __shared__ __align__(16) float As[BK * LDS];
  __shared__ __align__(16) float Bs[BK * LDS];
  const int e0 = blockIdx.x * TB, m0 = blockIdx.y * TB;
  float acc[8][8];
  gemm(DepthMajor<float>{dlog, Vc, n, cw},
       RowMajor<TW>{w + static_cast<size_t>(c0) * d, d, d, cw}, m0, e0, cw,
       acc, As, Bs);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + sub(ty, i);
    if (row >= n) continue;
    float* dst = dh + static_cast<size_t>(row) * d + e0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = half * 64 + tx * 4;
      if (e0 + e >= d) continue;
      float4 o = make_float4(acc[i][half * 4], acc[i][half * 4 + 1],
                             acc[i][half * 4 + 2], acc[i][half * 4 + 3]);
      if (accumulate) {
        const float4 prev = *reinterpret_cast<const float4*>(dst + e);
        o.x += prev.x;
        o.y += prev.y;
        o.z += prev.z;
        o.w += prev.w;
      }
      *reinterpret_cast<float4*>(dst + e) = o;
    }
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename TW>
int fwd(const float* h, const void* w, const int* labels, float* lse,
        float* labl, float* pm, float* pl, int n, int d, int V,
        cudaStream_t st) {
  const int nvt = cdiv(V, TB);
  stats_kernel<TW><<<dim3(nvt, cdiv(n, TB)), GT, 0, st>>>(
      h, static_cast<const TW*>(w), labels, pm, pl, labl, n, d, V, nvt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lse_kernel<<<cdiv(n, GT / 32), GT, 0, st>>>(pm, pl, lse, n, nvt);
  return static_cast<int>(cudaGetLastError());
}

template <typename TW>
int bwd(const float* h, const void* w_, const int* labels, const float* lse,
        const float* scale, float* dh, float* dw, float* dlog, int n, int d,
        int V, int Vc, cudaStream_t st) {
  const TW* w = static_cast<const TW*>(w_);
  for (int c0 = 0; c0 < V; c0 += Vc) {
    const int cw = V - c0 < Vc ? V - c0 : Vc;
    dlog_kernel<TW><<<dim3(Vc / TB, cdiv(n, TB)), GT, 0, st>>>(
        h, w, labels, lse, scale, dlog, n, d, V, c0, Vc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dw_kernel<<<dim3(cdiv(d, TB), cdiv(cw, TB)), GT, 0, st>>>(
        dlog, h, dw, n, d, c0, Vc, cw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dh_kernel<TW><<<dim3(cdiv(d, TB), cdiv(n, TB)), GT, 0, st>>>(
        dlog, w, dh, n, d, c0, Vc, cw, c0 > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// w_dtype codes: 0 float32, 1 bfloat16. Returns 0, a cudaError_t, or -1
// for a dtype or shape without an instantiation.
extern "C" int fused_xent_fwd(int w_dtype, const float* h, const void* w,
                              const int* labels, float* lse, float* labl,
                              float* pm, float* pl, int n, int d, int V,
                              void* stream) {
  if (n == 0) return 0;
  if (d % 8 != 0 || V < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0)
    return fwd<float>(h, w, labels, lse, labl, pm, pl, n, d, V, st);
  if (w_dtype == 1)
    return fwd<__nv_bfloat16>(h, w, labels, lse, labl, pm, pl, n, d, V, st);
  return -1;
}

extern "C" int fused_xent_bwd(int w_dtype, const float* h, const void* w,
                              const int* labels, const float* lse,
                              const float* scale, float* dh, float* dw,
                              float* dlog, int n, int d, int V, int Vc,
                              void* stream) {
  if (n == 0) return 0;
  if (d % 8 != 0 || V < 1 || Vc < TB || Vc % TB != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0)
    return bwd<float>(h, w, labels, lse, scale, dh, dw, dlog, n, d, V, Vc,
                      st);
  if (w_dtype == 1)
    return bwd<__nv_bfloat16>(h, w, labels, lse, scale, dh, dw, dlog, n, d,
                              V, Vc, st);
  return -1;
}
