// Fused vocabulary cross-entropy on Hopper: loss statistics, dh and dW of
// softmax cross-entropy over a tied or an untied head, without the
// [n, vocab] logits ever reaching device memory.
//
// Replaces the TPU kernel repro/kernels/fused_xent.py:109 softmax_xent
// (bodies _p1_kernel :28 and _p2_kernel :64). The port reaches it from
// the trainer's loss (core/vocab.py loss_and_dy), with the head read in
// place: the bf16 embedding table [V, d] of a tied model (llama3.2-1b),
// or the bf16 head.w [d, V] of an untied one (gpt-1.5B) — the whole head,
// or one data rank's vocabulary shard of it (its own contiguous tensor),
// whose two passes run apart around a combine of lse over the shards.
//
// Contract: h [n, d] float32 (final-norm output); w float32 or bfloat16,
// either a table [V, d] (layout TABLE) or a head [d, V] (layout HEAD);
// labels int32 [n] in [0, V), or outside it (-1: the row's label lies in
// another vocabulary shard when w is one shard of a sharded head), scale
// float32 [n] (mask / denom).
//   fused_xent_fwd: lse [n] = logsumexp_v(logits), labl [n] = the label's
//     logit, 0 for a label outside [0, V) (written by lse_kernel, after
//     the stats kernels, which write only the labels they see); pm, pl
//     [n, ceil(V/128)] float32 scratch; hs bf16 [2, n, d]
//     scratch (bf16 w only: h split into two bf16 terms, kept for the
//     backward call).
//   fused_xent_split: hs from h alone (a bwd call after another call's
//     fwd: the sharded loss combines lse across shards between the two).
//   fused_xent_bwd: dlog = (softmax - onehot) * scale (lse given: this
//     call's fwd output or a combination over shards; a label outside
//     [0, V) adds no one-hot), dh [n, d] and dw,
//     both float32, dw in w's layout ([V, d] or [d, V]); dlog scratch for
//     one vocabulary chunk of Vc columns (Vc % 128 == 0): float32 [n, Vc]
//     for a float32 w, bf16 [2, n, Vc] (two terms) for a bf16 w.
// Requires d % 8 == 0; a float32 head needs V % 8 == 0 (16-byte rows), a
// bf16 head V % 2 == 0 (4-byte rows: see "A head whose rows are not
// 16-byte aligned" below).
//
// Bound on the H100: operations. The function is three GEMM-shaped
// products of 2 n d V flops each (logits, dh, dW): 3.2 TFLOP a call at
// n = d = 2048, V = 128256, 3.26 ms at the bf16 tensor-core peak, against
// 0.5 GB of table read and 1 GB of dW written (~2,000 flops a byte).
//
// bf16 w (the training path): every product on the tensor cores (wgmma,
// mma_tile.cuh). The reference keeps float32 logits, and the port is
// held to its float32 plain version (loss 1e-5 relative, dh and dW 1e-4
// of the largest |plain|). One bf16 pass, with h and dlog rounded to
// bf16, misses that rule several times over (dh and dW). So the float32
// operands are split into two bf16 terms, x = hi + lo with hi = bf16(x)
// and lo = bf16(x - hi): hi + lo holds 16 significant bits, and a
// product of a bf16 value by a bf16 table entry is exact in the float32
// accumulator. The table is bf16 already and needs no split. The terms
// summed into one float32 accumulator, lo * lo left out:
//   logits = h_hi w^T + h_lo w^T              (pass 1 and again in 2a)
//   dh     = dlog_hi w + dlog_lo w
//   dW     = dlog_hi^T h_hi + dlog_hi^T h_lo + dlog_lo^T h_hi
// That stays within a tenth of the rule (tests/test_torch_train_kernels.py
// emulates it on the CPU), with dh and dW summed in partials of 256
// (mainloop, PROMOTE). Nine bf16 products, 9.7 TFLOP a call: 9.8 ms
// at peak is this design's own floor, three times the function's bound.
//   split: h -> hs (hi, lo), one elementwise pass inside the fwd call.
//   GEMM core (mainloop): a block of two consumer warpgroups owns a
//     128 x 128 float32 output tile, 64 rows a warpgroup held as two
//     m64n64 accumulators. 64-deep k tiles of every operand land in the
//     128-byte swizzle through a cp.async ring (4 stages two tiles
//     ahead; 3 stages one ahead for dW, whose stage holds four operand
//     tiles), one k tile of wgmma in flight. Rows and 16-byte
//     chunks past the matrix read as zeros, so d needs only d % 8 == 0;
//     table rows past V give logit 0 and are kept out of the max, the
//     sum and dlog by index.
//   pass 1 (stats_tc): blocks own (row tile, vocab tile); the epilogue
//     reduces each row's tile to (max, sum of exp) by quad shuffles on
//     the accumulator fragments and picks the label logit; lse_kernel
//     combines the tiles.
//   pass 2, per vocabulary chunk, three grids with one writer per
//     output element (no atomics, deterministic):
//     dlog_tc: (row tile, vocab tile) recomputes the logits with the
//       same device code, products and order as pass 1, so exp(logit -
//       lse) is consistent with pass 1's lse bit for bit, and writes
//       dlog as two bf16 terms;
//     dw_tc: (d tile, vocab tile) over all n rows, both operands
//       MN-major (A transposed in the wgmma: no transposed copy of dlog);
//     dh_tc: (d tile, row tile) over the chunk, adding into dh.
//   The logits exist only as the [2, n, Vc] bf16 dlog of one chunk (64
//   MB at n = 2048, Vc = 8192).
//   A [d, V] head needs no transposed copy: wgmma reads either major
//   order of a bf16 operand from shared memory, so each product takes
//   the head's tiles in place with the other transpose flag (the logits'
//   B operand MN-major, dh's K-major), and dw_tc computes dW^T = h^T dlog
//   (the same three terms) so that it stores rows of the [d, V] gradient.
//   A head whose rows are not 16-byte aligned (V % 8 != 0, whisper's
//   51866 columns: rows of 103,732 bytes) is still read in place, as
//   layout HEAD4: its tiles are filled with 4-byte cp.async copies into
//   the same swizzled tile (fill4), each pair of columns zero-filled on
//   its own at or past the last column, so the 16-byte chunk that
//   straddles a row's end brings its real columns and zeros and no copy
//   reads past the row; the logits past V are kept out by index, as
//   before, and dW is stored at the head's own pitch V, two columns a
//   store (V even: no pair straddles the end). V % 8 == 0 keeps the
//   16-byte copies (HEAD), instruction for instruction.
//
// float32 w: the CUDA-core body below (gemm and its five kernels), in
// float32 throughout, as the reference computes it: 128 x 128 output
// tiles, 8-deep k steps through shared memory, 8 x 8 outputs a thread,
// the same pass structure (stats / lse, then dlog, dW and dh per chunk);
// a [d, V] head is read with strided float4 loads along its rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

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

// An operand whose depth is contiguous: element (row r, depth k) at
// p[r * ld + k]. Rows at or past `rows` and depth at or past K read 0.
struct DepthMajor {
  const float* p;
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
struct RowMajor {
  const float* p;
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

// The table's layouts (the C entry's `layout`): TABLE, w [V, d] (the tied
// embedding); HEAD, w [d, V] (an untied head; needs V % 8 == 0).
constexpr int TABLE = 0, HEAD = 1;

// logits = h w^T over every d: the block's TB x TB tile at (m0, v0);
// w's rows from v_lo on (a chunk's first column).
template <int LAYOUT>
__device__ __forceinline__ void logits(const float* h, const float* w,
                                       int n, int d, int V, int v_lo,
                                       int m0, int v0, float (&acc)[8][8],
                                       float* As, float* Bs) {
  if constexpr (LAYOUT == HEAD)
    gemm(DepthMajor{h, d, n, d}, RowMajor{w + v_lo, V, V - v_lo, d}, m0,
         v0, d, acc, As, Bs);
  else
    gemm(DepthMajor{h, d, n, d},
         DepthMajor{w + static_cast<size_t>(v_lo) * d, d, V - v_lo, d}, m0,
         v0, d, acc, As, Bs);
}

// pass 1: per (row tile, vocab tile) max and sum of exp of the logits,
// and the label logit of the rows whose label falls in the tile.
template <int LAYOUT>
__global__ void __launch_bounds__(GT)
    stats_kernel(const float* __restrict__ h, const float* __restrict__ w,
                 const int* __restrict__ labels, float* __restrict__ pm,
                 float* __restrict__ pl, float* __restrict__ labl, int n,
                 int d, int V, int nvt) {
  __shared__ __align__(16) float As[BK * LDS];
  __shared__ __align__(16) float Bs[BK * LDS];
  const int v0 = blockIdx.x * TB, m0 = blockIdx.y * TB;
  float acc[8][8];
  logits<LAYOUT>(h, w, n, d, V, 0, m0, v0, acc, As, Bs);
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

// lse[row] from the per-tile (max, sum) pairs; one warp a row. A row whose
// label lies outside [0, V) (another shard's) gets label logit 0: no
// stats tile wrote it.
__global__ void __launch_bounds__(GT)
    lse_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
               const int* __restrict__ labels, float* __restrict__ lse,
               float* __restrict__ labl, int n, int nvt, int V) {
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
  if (lane == 0) {
    lse[row] = mx + logf(fmaxf(s, 1e-30f));
    const int lab = labels[row];
    if (lab < 0 || lab >= V) labl[row] = 0.f;
  }
}

// pass 2a: dlog[row, c] = (exp(logit - lse) - onehot) * scale[row] for the
// chunk's columns c0 + c (c < Vc); columns at or past V are 0.
template <int LAYOUT>
__global__ void __launch_bounds__(GT)
    dlog_kernel(const float* __restrict__ h, const float* __restrict__ w,
                const int* __restrict__ labels,
                const float* __restrict__ lse,
                const float* __restrict__ scale, float* __restrict__ dlog,
                int n, int d, int V, int c0, int Vc) {
  __shared__ __align__(16) float As[BK * LDS];
  __shared__ __align__(16) float Bs[BK * LDS];
  const int v0 = blockIdx.x * TB, m0 = blockIdx.y * TB;
  float acc[8][8];
  logits<LAYOUT>(h, w, n, d, V, c0, m0, v0, acc, As, Bs);
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

// pass 2b: dw[c0 + c, :] = sum_rows dlog[row, c] * h[row, :] for c < cw
// (TABLE); HEAD: dw[:, c0 + c], the product taken as h^T dlog so that a
// thread stores four consecutive vocab columns of one row of d.
template <int LAYOUT>
__global__ void __launch_bounds__(GT)
    dw_kernel(const float* __restrict__ dlog, const float* __restrict__ h,
              float* __restrict__ dw, int n, int d, int V, int c0, int Vc,
              int cw) {
  __shared__ __align__(16) float As[BK * LDS];
  __shared__ __align__(16) float Bs[BK * LDS];
  const int e0 = blockIdx.x * TB, c_0 = blockIdx.y * TB;
  float acc[8][8];
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  if constexpr (LAYOUT == HEAD) {
    gemm(RowMajor{h, d, d, n}, RowMajor{dlog, Vc, Vc, n}, e0, c_0, n, acc,
         As, Bs);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = e0 + sub(ty, i);
      if (e >= d) continue;
      float* dst = dw + static_cast<size_t>(e) * V + c0 + c_0;
#pragma unroll
      for (int half = 0; half < 2; ++half)
        if (c_0 + half * 64 + tx * 4 < cw)
          *reinterpret_cast<float4*>(dst + half * 64 + tx * 4) = make_float4(
              acc[i][half * 4], acc[i][half * 4 + 1], acc[i][half * 4 + 2],
              acc[i][half * 4 + 3]);
    }
    return;
  }
  gemm(RowMajor{dlog, Vc, Vc, n}, RowMajor{h, d, d, n}, c_0,
       e0, n, acc, As, Bs);
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

// pass 2c: dh[row, :] (+)= sum_{c < cw} dlog[row, c] * w[c0 + c, :]
// (HEAD: w[:, c0 + c], read along its rows).
template <int LAYOUT>
__global__ void __launch_bounds__(GT)
    dh_kernel(const float* __restrict__ dlog, const float* __restrict__ w,
              float* __restrict__ dh, int n, int d, int V, int c0, int Vc,
              int cw, int accumulate) {
  __shared__ __align__(16) float As[BK * LDS];
  __shared__ __align__(16) float Bs[BK * LDS];
  const int e0 = blockIdx.x * TB, m0 = blockIdx.y * TB;
  float acc[8][8];
  if constexpr (LAYOUT == HEAD)
    gemm(DepthMajor{dlog, Vc, n, cw}, DepthMajor{w + c0, V, d, cw}, m0, e0,
         cw, acc, As, Bs);
  else
    gemm(DepthMajor{dlog, Vc, n, cw},
         RowMajor{w + static_cast<size_t>(c0) * d, d, d, cw}, m0, e0, cw,
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

template <int LAYOUT>
int fwd_cc(const float* h, const float* w, const int* labels, float* lse,
           float* labl, float* pm, float* pl, int n, int d, int V,
           cudaStream_t st) {
  const int nvt = cdiv(V, TB);
  stats_kernel<LAYOUT><<<dim3(nvt, cdiv(n, TB)), GT, 0, st>>>(
      h, w, labels, pm, pl, labl, n, d, V, nvt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lse_kernel<<<cdiv(n, GT / 32), GT, 0, st>>>(pm, pl, labels, lse, labl,
                                              n, nvt, V);
  return static_cast<int>(cudaGetLastError());
}

template <int LAYOUT>
int bwd_cc(const float* h, const float* w, const int* labels,
           const float* lse, const float* scale, float* dh, float* dw,
           float* dlog, int n, int d, int V, int Vc, cudaStream_t st) {
  for (int c0 = 0; c0 < V; c0 += Vc) {
    const int cw = V - c0 < Vc ? V - c0 : Vc;
    dlog_kernel<LAYOUT><<<dim3(Vc / TB, cdiv(n, TB)), GT, 0, st>>>(
        h, w, labels, lse, scale, dlog, n, d, V, c0, Vc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dw_kernel<LAYOUT><<<dim3(cdiv(d, TB), cdiv(cw, TB)), GT, 0, st>>>(
        dlog, h, dw, n, d, V, c0, Vc, cw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dh_kernel<LAYOUT><<<dim3(cdiv(d, TB), cdiv(n, TB)), GT, 0, st>>>(
        dlog, w, dh, n, d, V, c0, Vc, cw, c0 > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// ---- bf16 table: the tensor-core body ----------------------------------- //

namespace xtc {

using namespace mma;
using bf16 = __nv_bfloat16;

constexpr int NT = 2 * WG;          // threads: two consumer warpgroups
constexpr int BT = 128;             // output tile rows and columns
constexpr int BK = 64;              // depth of a k tile (128-byte rows)
constexpr int TILE = BT * BK * 2;   // bytes of one staged operand tile
constexpr int HALF = 64 * 128;      // bytes of 64 rows of a column block

// Fills a swizzled bf16 tile of R rows x W columns (mma_tile.cuh's
// layout) with element (r, c) = src[(r0 + r) * ld + c0 + c]; rows at or
// past `rows` and 16-byte chunks at or past column `cols` read as zeros.
// The block's threads share the copy, neighbours on neighbouring chunks.
template <int R, int W>
__device__ __forceinline__ void fill(uint32_t dst, const bf16* src, int ld,
                                     int r0, int rows, int c0, int cols) {
  constexpr int C = W / 8;
  static_assert(R * C % NT == 0, "tile");
#pragma unroll
  for (int i = 0; i < R * C / NT; ++i) {
    const int q = threadIdx.x + i * NT, r = q / C, c = q % C;
    const bool ok = r0 + r < rows && c0 + c * 8 < cols;
    const size_t at =
        ok ? static_cast<size_t>(r0 + r) * ld + c0 + c * 8 : 0;
    cp16(dst + swz<R>(r, c), src + at, ok);
  }
}

// fill for a source whose rows are 4-byte aligned only (ld and c0 even,
// cols even): each 16-byte chunk of the tile lands as four 4-byte copies,
// a pair of columns zero-filled at or past column `cols` (or past
// `rows`) without a read, so no copy passes a row's end.
template <int R, int W>
__device__ __forceinline__ void fill4(uint32_t dst, const bf16* src, int ld,
                                      int r0, int rows, int c0, int cols) {
  constexpr int C = W / 8;
  static_assert(R * C % NT == 0, "tile");
#pragma unroll
  for (int i = 0; i < R * C / NT; ++i) {
    const int q = threadIdx.x + i * NT, r = q / C, c = q % C;
    const bool row_ok = r0 + r < rows;
    const size_t at =
        row_ok ? static_cast<size_t>(r0 + r) * ld + c0 + c * 8 : 0;
    const uint32_t to = dst + swz<R>(r, c);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool ok = row_ok && c0 + c * 8 + 2 * u < cols;
      cp4(to + 4 * u, src + (ok ? at + 2 * u : 0), ok);
    }
  }
}

// A [d, V] head with V % 8 != 0 (V even): HEAD's products over tiles
// filled by fill4 (the C entries pick it; the float32 body has none).
constexpr int HEAD4 = 2;

// The three products. load() stages k tile kt of the block's operands at
// s; mma() issues this warpgroup's wgmmas on a staged k tile into its
// 64 x 128 accumulator (two m64n64 halves). A operand of warpgroup g:
// its 64 rows (K-major tile) or 64 columns (MN-major tile), HALF bytes
// in.

// logits = h w^T: output rows of h (m0..), columns = vocab entries
// (v0..); h_hi and h_lo over the same staged w tile. h is K-major; the
// table's rows (TABLE) are K-major too, while a [d, V] head (HEAD) is read
// in place as an MN-major tile of 64 rows of d by 128 vocab columns.
template <int LAYOUT>
struct Logits {
  static constexpr int STAGE = 3 * TILE, STAGES = 4, PROMOTE = 0;
  const bf16* hs;  // [2, n, d]: hi, lo
  const bf16* w;   // [V, d] (TABLE) or [d, V] (HEAD, HEAD4)
  int n, d, V;
  __device__ int k_tiles() const { return (d + BK - 1) / BK; }
  __device__ __forceinline__ void load(uint32_t s, int m0, int v0,
                                       int kt) const {
    const int k0 = kt * BK;
    fill<BT, BK>(s, hs, d, m0, n, k0, d);
    fill<BT, BK>(s + TILE, hs + static_cast<size_t>(n) * d, d, m0, n, k0, d);
    if constexpr (LAYOUT == HEAD4)
      fill4<BK, BT>(s + 2 * TILE, w, V, k0, d, v0, V);
    else if constexpr (LAYOUT == HEAD)
      fill<BK, BT>(s + 2 * TILE, w, V, k0, d, v0, V);
    else
      fill<BT, BK>(s + 2 * TILE, w, d, v0, V, k0, d);
  }
  __device__ __forceinline__ void mma(uint32_t s, float (&acc)[2][32],
                                      int zero) const {
    constexpr int TB_ = LAYOUT != TABLE;  // B MN-major
    const uint32_t a = s + (threadIdx.x / WG) * HALF, b = s + 2 * TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint64_t db = TB_ ? desc_mn<BK>(b + j * HALF, kk)
                                : desc_k<BT>(b + j * HALF, kk);
        wgmma_ss_t<0, TB_>(acc[j], desc_k<BT>(a, kk), db, kk > 0 || !zero);
        wgmma_ss_t<0, TB_>(acc[j], desc_k<BT>(a + TILE, kk), db, 1);
      }
  }
};

// dh = dlog w over one chunk: output rows (m0..) by columns of d (e0..);
// dlog_hi and dlog_lo K-major (the chunk's columns are the depth). The
// chunk's table rows (TABLE) are MN-major (the depth runs down them, as V
// in P V); a [d, V] head (HEAD) holds the depth along its rows, so its
// tile of 128 rows of d by 64 vocab columns is K-major.
template <int LAYOUT>
struct DH {
  static constexpr int STAGE = 3 * TILE, STAGES = 4, PROMOTE = 4;
  const bf16* dl;  // [2, n, Vc]
  const bf16* w;   // the chunk's first table row [cw, d] (TABLE), or its
                   // first column of the head [d, V] (HEAD)
  int n, d, Vc, cw, V;
  __device__ int k_tiles() const { return (cw + BK - 1) / BK; }
  __device__ __forceinline__ void load(uint32_t s, int m0, int e0,
                                       int kt) const {
    const int k0 = kt * BK;
    fill<BT, BK>(s, dl, Vc, m0, n, k0, Vc);
    fill<BT, BK>(s + TILE, dl + static_cast<size_t>(n) * Vc, Vc, m0, n, k0,
                 Vc);
    if constexpr (LAYOUT == HEAD4)
      fill4<BT, BK>(s + 2 * TILE, w, V, e0, d, k0, cw);
    else if constexpr (LAYOUT == HEAD)
      fill<BT, BK>(s + 2 * TILE, w, V, e0, d, k0, cw);
    else
      fill<BK, BT>(s + 2 * TILE, w, d, k0, cw, e0, d);
  }
  __device__ __forceinline__ void mma(uint32_t s, float (&acc)[2][32],
                                      int zero) const {
    constexpr int TB_ = LAYOUT == TABLE;  // B MN-major
    const uint32_t a = s + (threadIdx.x / WG) * HALF, b = s + 2 * TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint64_t db = TB_ ? desc_mn<BK>(b + j * HALF, kk)
                                : desc_k<BT>(b + j * HALF, kk);
        wgmma_ss_t<0, TB_>(acc[j], desc_k<BT>(a, kk), db, kk > 0 || !zero);
        wgmma_ss_t<0, TB_>(acc[j], desc_k<BT>(a + TILE, kk), db, 1);
      }
  }
};

// dW = dlog^T h over all n rows (TABLE): output rows = the chunk's
// columns (c0..) by columns of d (e0..); HEAD takes dW^T = h^T dlog, rows
// of d by the chunk's columns, so that the [d, V] gradient is stored
// along its rows. The depth (rows of dlog and h) runs down every tile, so
// all are MN-major and A is transposed in the wgmma. The three products
// hi hi, hi lo and lo hi are the same terms in either order.
template <int LAYOUT>
struct DW {
  static constexpr int STAGE = 4 * TILE, STAGES = 3, PROMOTE = 4;
  const bf16* dl;  // [2, n, Vc]
  const bf16* hs;  // [2, n, d]
  int n, d, Vc;
  __device__ int k_tiles() const { return (n + BK - 1) / BK; }
  // a0, b0: the output tile's first row and column
  __device__ __forceinline__ void load(uint32_t s, int a0, int b0,
                                       int kt) const {
    const int k0 = kt * BK;
    const bool head = LAYOUT != TABLE;
    const int c0 = head ? b0 : a0, e0 = head ? a0 : b0;
    // A's two terms, then B's
    const uint32_t sd = head ? s + 2 * TILE : s, sh = head ? s : s + 2 * TILE;
    fill<BK, BT>(sd, dl, Vc, k0, n, c0, Vc);
    fill<BK, BT>(sd + TILE, dl + static_cast<size_t>(n) * Vc, Vc, k0, n, c0,
                 Vc);
    fill<BK, BT>(sh, hs, d, k0, n, e0, d);
    fill<BK, BT>(sh + TILE, hs + static_cast<size_t>(n) * d, d, k0, n, e0,
                 d);
  }
  __device__ __forceinline__ void mma(uint32_t s, float (&acc)[2][32],
                                      int zero) const {
    const uint32_t a = s + (threadIdx.x / WG) * HALF, b = s + 2 * TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t hi = desc_mn<BK>(a, kk), lo = desc_mn<BK>(a + TILE, kk);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint64_t bh = desc_mn<BK>(b + j * HALF, kk);
        const uint64_t bl = desc_mn<BK>(b + TILE + j * HALF, kk);
        wgmma_ss_t<1, 1>(acc[j], hi, bh, kk > 0 || !zero);
        wgmma_ss_t<1, 1>(acc[j], hi, bl, 1);
        wgmma_ss_t<1, 1>(acc[j], lo, bh, 1);
      }
    }
  }
};

// acc = the block's 128 x 128 product tile at (a0, b0) over every k tile.
// A ring of STAGES k tiles, PF = STAGES - 2 of them in flight ahead of the
// one multiplied; one k tile of wgmma in flight. The load issued at k
// tile kt overwrites tile kt - 2's stage, whose wgmma every warpgroup has
// waited for before the barrier. The first wgmma into an accumulator
// overwrites it (scale-d 0): no instruction but a wgmma writes it while
// one is in flight, so ptxas need not serialise them.
// PROMOTE = k: the wgmmas sum k k tiles into a partial that is then
// added to acc on the CUDA cores. The tensor cores' float32 sums lose low
// bits over a long depth (dh sums 8192 vocab columns a chunk, dW n rows);
// partials at most 256 deep keep dh and dW well inside their limit, for
// a few percent of the call.
template <class P>
__device__ __forceinline__ void mainloop(const P& p, uint32_t sm, int a0,
                                         int b0, float (&acc)[2][32]) {
  constexpr int S = P::STAGES, PF = S - 2, PR = P::PROMOTE;
  float part[2][32];
  float(&run)[2][32] = PR ? part : acc;  // what the wgmmas accumulate
  if (PR) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  }
  const int KT = p.k_tiles();
#pragma unroll
  for (int i = 0; i < PF; ++i) {
    if (i < KT) p.load(sm + i * P::STAGE, a0, b0, i);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<PF - 1>();
    fence_async_smem();
    __syncthreads();
    if (kt + PF < KT)
      p.load(sm + ((kt + PF) % S) * P::STAGE, a0, b0, kt + PF);
    cp_commit();
    reg_fence(run[0]);
    reg_fence(run[1]);
    wg_fence();
    p.mma(sm + (kt % S) * P::STAGE, run, PR ? kt % PR == 0 : kt == 0);
    wg_commit();
    if (PR && (kt % PR == PR - 1 || kt == KT - 1)) {
      wg_wait<0>();
      reg_fence(run[0]);
      reg_fence(run[1]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][i] += part[j][i];
    } else {
      wg_wait<1>();
      reg_fence(run[0]);
      reg_fence(run[1]);
    }
  }
  wg_wait<0>();
  reg_fence(acc[0]);
  reg_fence(acc[1]);
}

template <class P>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(P::STAGES) * P::STAGE + 1024;  // + align
}

__device__ __forceinline__ uint32_t ring(uint8_t* smem) {
  return (smem_u32(smem) + 1023) & ~1023u;
}

// Fragment coordinates: entry 4q + 2hh + c of half j of this thread's
// accumulator is tile row row0() + 8 hh, tile column col0() + 64 j + 8 q
// + c (mma_tile.cuh's m64n64 layout, warpgroup g's rows 64 g ..).
__device__ __forceinline__ int row0() {
  const int t = threadIdx.x % WG;
  return (threadIdx.x / WG) * 64 + (t / 32) * 16 + (t % 32) / 4;
}
__device__ __forceinline__ int col0() { return 2 * (threadIdx.x % 4); }

// split: hs[0] = bf16(h), hs[1] = bf16(h - hs[0]), four values a thread.
__global__ void __launch_bounds__(256)
    xent_split(const float* __restrict__ h, bf16* __restrict__ hs,
               size_t count) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= count) return;
  const float4 x = *reinterpret_cast<const float4*>(h + i);
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  const __nv_bfloat162 la = __floats2bfloat162_rn(x.x - fa.x, x.y - fa.y);
  const __nv_bfloat162 lb = __floats2bfloat162_rn(x.z - fb.x, x.w - fb.y);
  __nv_bfloat162* hi = reinterpret_cast<__nv_bfloat162*>(hs + i);
  __nv_bfloat162* lo = reinterpret_cast<__nv_bfloat162*>(hs + count + i);
  hi[0] = a;
  hi[1] = b;
  lo[0] = la;
  lo[1] = lb;
}

// pass 1: per (row tile, vocab tile) max and sum of exp of the logits,
// and the label logit of the rows whose label falls in the tile.
template <int LAYOUT>
__global__ void __launch_bounds__(NT, 1)
    stats_tc(Logits<LAYOUT> p, const int* __restrict__ labels,
             float* __restrict__ pm,
             float* __restrict__ pl, float* __restrict__ labl, int nvt) {
  extern __shared__ __align__(1024) uint8_t smem_x[];
  const int m0 = blockIdx.x * BT, v0 = blockIdx.y * BT;
  float acc[2][32];
  mainloop(p, ring(smem_x), m0, v0, acc);
  const int cb = v0 + col0();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + row0() + 8 * hh;
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (cb + 64 * j + 8 * q + c < p.V)
            tmax = fmaxf(tmax, acc[j][4 * q + 2 * hh + c]);
    tmax = quad_max(tmax);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (cb + 64 * j + 8 * q + c < p.V)
            s += expf(acc[j][4 * q + 2 * hh + c] - tmax);
    s = quad_sum(s);
    if (row >= p.n) continue;
    if (threadIdx.x % 4 == 0) {
      pm[static_cast<size_t>(row) * nvt + blockIdx.y] = tmax;
      pl[static_cast<size_t>(row) * nvt + blockIdx.y] = s;
    }
    const int lab = labels[row];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (cb + 64 * j + 8 * q + c == lab)
            labl[row] = acc[j][4 * q + 2 * hh + c];
  }
}

// pass 2a: dlog[row, v - c0] = (exp(logit - lse) - onehot) * scale[row]
// for the chunk's vocab tile blockIdx.y, as two bf16 terms (dl[0] = hi,
// dl[1] = lo); columns at or past V are 0.
template <int LAYOUT>
__global__ void __launch_bounds__(NT, 1)
    dlog_tc(Logits<LAYOUT> p, const int* __restrict__ labels,
            const float* __restrict__ lse, const float* __restrict__ scale,
            bf16* __restrict__ dl, int c0, int Vc) {
  extern __shared__ __align__(1024) uint8_t smem_x[];
  const int m0 = blockIdx.x * BT, v0 = c0 + blockIdx.y * BT;
  float acc[2][32];
  mainloop(p, ring(smem_x), m0, v0, acc);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + row0() + 8 * hh;
    if (row >= p.n) continue;
    const float l = lse[row], sc = scale[row];
    const int lab = labels[row];
    bf16* hi = dl + static_cast<size_t>(row) * Vc;
    bf16* lo = hi + static_cast<size_t>(p.n) * Vc;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int v = v0 + col0() + 64 * j + 8 * q;
        float o[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float pr =
              v + c < p.V ? expf(acc[j][4 * q + 2 * hh + c] - l) : 0.f;
          o[c] = (pr - (v + c == lab ? 1.f : 0.f)) * sc;
        }
        const __nv_bfloat162 a = __floats2bfloat162_rn(o[0], o[1]);
        const float2 fa = __bfloat1622float2(a);
        *reinterpret_cast<__nv_bfloat162*>(hi + v - c0) = a;
        *reinterpret_cast<__nv_bfloat162*>(lo + v - c0) =
            __floats2bfloat162_rn(o[0] - fa.x, o[1] - fa.y);
      }
  }
}

// pass 2b: dw[c0 + c, :] = sum_rows dlog[row, c] h[row, :] for the chunk's
// columns c < cw of vocab tile blockIdx.y, d tile blockIdx.x (HEAD: dw[:,
// c0 + c], leading dimension V).
template <int LAYOUT>
__global__ void __launch_bounds__(NT, 1)
    dw_tc(DW<LAYOUT> p, float* __restrict__ dw, int c0, int cw, int V) {
  extern __shared__ __align__(1024) uint8_t smem_x[];
  const int e0 = blockIdx.x * BT, t0 = blockIdx.y * BT;
  float acc[2][32];
  if constexpr (LAYOUT != TABLE) {
    mainloop(p, ring(smem_x), e0, t0, acc);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int e = e0 + row0() + 8 * hh;
      if (e >= p.d) continue;
      float* dst = dw + static_cast<size_t>(e) * V + c0;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int c = t0 + col0() + 64 * j + 8 * q;
          if (c < cw)
            *reinterpret_cast<float2*>(dst + c) = make_float2(
                acc[j][4 * q + 2 * hh], acc[j][4 * q + 2 * hh + 1]);
        }
    }
    return;
  }
  mainloop(p, ring(smem_x), t0, e0, acc);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int c = t0 + row0() + 8 * hh;
    if (c >= cw) continue;
    float* dst = dw + static_cast<size_t>(c0 + c) * p.d;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int e = e0 + col0() + 64 * j + 8 * q;
        if (e < p.d)
          *reinterpret_cast<float2*>(dst + e) = make_float2(
              acc[j][4 * q + 2 * hh], acc[j][4 * q + 2 * hh + 1]);
      }
  }
}

// pass 2c: dh[row, :] (+)= sum_{c < cw} dlog[row, c] w[c0 + c, :] for row
// tile blockIdx.y, d tile blockIdx.x.
template <int LAYOUT>
__global__ void __launch_bounds__(NT, 1)
    dh_tc(DH<LAYOUT> p, float* __restrict__ dh, int accumulate) {
  extern __shared__ __align__(1024) uint8_t smem_x[];
  const int e0 = blockIdx.x * BT, m0 = blockIdx.y * BT;
  float acc[2][32];
  mainloop(p, ring(smem_x), m0, e0, acc);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + row0() + 8 * hh;
    if (row >= p.n) continue;
    float* dst = dh + static_cast<size_t>(row) * p.d;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int e = e0 + col0() + 64 * j + 8 * q;
        if (e >= p.d) continue;
        float2 o = make_float2(acc[j][4 * q + 2 * hh],
                               acc[j][4 * q + 2 * hh + 1]);
        if (accumulate) {
          const float2 prev = *reinterpret_cast<const float2*>(dst + e);
          o.x += prev.x;
          o.y += prev.y;
        }
        *reinterpret_cast<float2*>(dst + e) = o;
      }
  }
}

template <int LAYOUT>
int fwd(const float* h, const bf16* w, const int* labels, float* lse,
        float* labl, float* pm, float* pl, bf16* hs, int n, int d, int V,
        cudaStream_t st) {
  const size_t count = static_cast<size_t>(n) * d;
  xent_split<<<static_cast<unsigned>((count / 4 + 255) / 256), 256, 0,
               st>>>(h, hs, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nvt = cdiv(V, BT);
  constexpr size_t smem = smem_bytes<Logits<LAYOUT>>();
  err = allow_smem(stats_tc<LAYOUT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_tc<LAYOUT><<<dim3(cdiv(n, BT), nvt), NT, smem, st>>>(
      Logits<LAYOUT>{hs, w, n, d, V}, labels, pm, pl, labl, nvt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lse_kernel<<<cdiv(n, GT / 32), GT, 0, st>>>(pm, pl, labels, lse, labl,
                                              n, nvt, V);
  return static_cast<int>(cudaGetLastError());
}

template <int LAYOUT>
int bwd(const bf16* hs, const bf16* w, const int* labels, const float* lse,
        const float* scale, float* dh, float* dw, bf16* dl, int n, int d,
        int V, int Vc, cudaStream_t st) {
  constexpr size_t sl = smem_bytes<Logits<LAYOUT>>(),
                   sw = smem_bytes<DW<LAYOUT>>(),
                   sh = smem_bytes<DH<LAYOUT>>();
  cudaError_t err = allow_smem(dlog_tc<LAYOUT>, sl);
  if (err == cudaSuccess) err = allow_smem(dw_tc<LAYOUT>, sw);
  if (err == cudaSuccess) err = allow_smem(dh_tc<LAYOUT>, sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int c0 = 0; c0 < V; c0 += Vc) {
    const int cw = V - c0 < Vc ? V - c0 : Vc, ct = cdiv(cw, BT);
    dlog_tc<LAYOUT><<<dim3(cdiv(n, BT), ct), NT, sl, st>>>(
        Logits<LAYOUT>{hs, w, n, d, V}, labels, lse, scale, dl, c0, Vc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dw_tc<LAYOUT><<<dim3(cdiv(d, BT), ct), NT, sw, st>>>(
        DW<LAYOUT>{dl, hs, n, d, Vc}, dw, c0, cw, V);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // the chunk's part of w: rows c0.. of a table, columns c0.. of a head
    const bf16* wc = w + (LAYOUT != TABLE ? static_cast<size_t>(c0)
                                          : static_cast<size_t>(c0) * d);
    dh_tc<LAYOUT><<<dim3(cdiv(d, BT), cdiv(n, BT)), NT, sh, st>>>(
        DH<LAYOUT>{dl, wc, n, d, Vc, cw, V}, dh, c0 > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace xtc

namespace {

template <int LAYOUT>
int fwd_any(int w_dtype, const float* h, const void* w, const int* labels,
            float* lse, float* labl, float* pm, float* pl, void* hs, int n,
            int d, int V, cudaStream_t st) {
  if constexpr (LAYOUT == xtc::HEAD4) {   // bf16 only
    if (w_dtype != 1 || hs == nullptr) return -1;
  } else if (w_dtype == 0) {
    return fwd_cc<LAYOUT>(h, static_cast<const float*>(w), labels, lse,
                          labl, pm, pl, n, d, V, st);
  }
  if (w_dtype == 1 && hs != nullptr)
    return xtc::fwd<LAYOUT>(h, static_cast<const __nv_bfloat16*>(w), labels,
                            lse, labl, pm, pl,
                            static_cast<__nv_bfloat16*>(hs), n, d, V, st);
  return -1;
}

template <int LAYOUT>
int bwd_any(int w_dtype, const float* h, const void* w, const int* labels,
            const float* lse, const float* scale, float* dh, float* dw,
            void* dlog, const void* hs, int n, int d, int V, int Vc,
            cudaStream_t st) {
  if constexpr (LAYOUT == xtc::HEAD4) {   // bf16 only
    if (w_dtype != 1 || hs == nullptr) return -1;
  } else if (w_dtype == 0) {
    return bwd_cc<LAYOUT>(h, static_cast<const float*>(w), labels, lse,
                          scale, dh, dw, static_cast<float*>(dlog), n, d, V,
                          Vc, st);
  }
  if (w_dtype == 1 && hs != nullptr)
    return xtc::bwd<LAYOUT>(static_cast<const __nv_bfloat16*>(hs),
                            static_cast<const __nv_bfloat16*>(w), labels,
                            lse, scale, dh, dw,
                            static_cast<__nv_bfloat16*>(dlog), n, d, V, Vc,
                            st);
  return -1;
}

// d % 8 == 0; a [d, V] head also needs V even (its rows 4-byte aligned;
// fwd_any / bwd_any refuse a float32 one unless V % 8 == 0)
bool shape_ok(int layout, int d, int V) {
  return d % 8 == 0 && V >= 1 && (layout == TABLE || V % 2 == 0);
}

}  // namespace

// w_dtype codes: 0 float32 (the CUDA-core body), 1 bfloat16 (the
// tensor-core body, which needs the hs scratch). layout: 0 a [V, d]
// table (the tied embedding), 1 a [d, V] head (an untied head.w; V % 8 !=
// 0 runs HEAD4, bf16 only), read in place either way; dw has w's layout. Returns 0, a cudaError_t, or -1
// for a dtype, layout or shape without an instantiation.
extern "C" int fused_xent_fwd(int w_dtype, int layout, const float* h,
                              const void* w, const int* labels, float* lse,
                              float* labl, float* pm, float* pl, void* hs,
                              int n, int d, int V, void* stream) {
  if (n == 0) return 0;
  if (!shape_ok(layout, d, V)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == TABLE)
    return fwd_any<TABLE>(w_dtype, h, w, labels, lse, labl, pm, pl, hs, n, d,
                          V, st);
  if (layout == HEAD && V % 8 != 0)
    return fwd_any<xtc::HEAD4>(w_dtype, h, w, labels, lse, labl, pm, pl, hs,
                               n, d, V, st);
  if (layout == HEAD)
    return fwd_any<HEAD>(w_dtype, h, w, labels, lse, labl, pm, pl, hs, n, d,
                         V, st);
  return -1;
}

// hs bf16 [2, count]: hi and lo terms of h float32 [count] (count % 4 ==
// 0), as fused_xent_fwd writes them for a bf16 w.
extern "C" int fused_xent_split(const float* h, void* hs, long long count,
                                void* stream) {
  if (count <= 0) return 0;
  if (count % 4) return -1;
  xtc::xent_split<<<static_cast<unsigned>((count / 4 + 255) / 256), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      h, static_cast<__nv_bfloat16*>(hs), static_cast<size_t>(count));
  return static_cast<int>(cudaGetLastError());
}

// hs: the split of h that fused_xent_fwd (or fused_xent_split) wrote
// (bf16 w only).
extern "C" int fused_xent_bwd(int w_dtype, int layout, const float* h,
                              const void* w, const int* labels,
                              const float* lse, const float* scale,
                              float* dh, float* dw, void* dlog,
                              const void* hs, int n, int d, int V, int Vc,
                              void* stream) {
  if (n == 0) return 0;
  if (!shape_ok(layout, d, V) || Vc < TB || Vc % TB != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == TABLE)
    return bwd_any<TABLE>(w_dtype, h, w, labels, lse, scale, dh, dw, dlog,
                          hs, n, d, V, Vc, st);
  if (layout == HEAD && V % 8 != 0)
    return bwd_any<xtc::HEAD4>(w_dtype, h, w, labels, lse, scale, dh, dw,
                               dlog, hs, n, d, V, Vc, st);
  if (layout == HEAD)
    return bwd_any<HEAD>(w_dtype, h, w, labels, lse, scale, dh, dw, dlog,
                         hs, n, d, V, Vc, st);
  return -1;
}
