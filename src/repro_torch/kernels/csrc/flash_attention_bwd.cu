// Flash attention backward on Hopper: dQ, dK, dV of flash_attention_fwd's
// contract from q, k, v, the output O, its cotangent dO and the forward's
// per-row log-sum-exp.
//
// Replaces the attention backward the JAX package takes with jax.vjp of
// ops.attention inside Tape.prim (repro/core/tape.py:134-168, called from
// blocks.py:131-139); it has no Pallas source of its own.
//
// Math (S = scale * q k^T, P = exp(S - lse), D = rowsum(dO * O)):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),
//   dQ = scale * dS K,  dK = scale * dS^T q.
// GQA: the rep q heads of a kv head sum into its dK, dV.
//
// Layout: two deterministic passes, no atomics.
//   * dq_kernel: one block owns one (batch row, kv head) and BM query
//     rows (all rep q heads, ordered m = i * rep + r as in the forward);
//     it forms D for its rows (written to device memory for the second
//     pass), then walks the K/V tiles up to its causal limit and
//     accumulates dQ in registers.
//   * dkdv_kernel: one block owns one (batch row, kv head) and BN keys;
//     it walks the query-row tiles from the first that can see its keys
//     and accumulates dK and dV in registers.
// Both recompute S and P from q, k and lse; the [sq, sk] matrices never
// reach device memory. Scores, products and sums run in float32 on the
// CUDA cores; dq, dk, dv are written in float32.
//
// Bound on the H100: operations. The five products of the backward (S
// twice, dP twice and dV, dK, dQ once each over the visible pairs; the
// least work is five) are 2.5x the forward's two: 43 GFLOP a causal call
// at the training shape, far above the card's ~295 flops per byte of the
// 20 MB it reads and writes. The design reads each K/V tile once per
// query tile block and each query tile once per key tile block, and
// skips tiles wholly outside the causal mask.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BM = 64;  // query rows per tile
constexpr int BN = 64;  // keys per tile
constexpr int RG = BM / 4;           // row groups of 4 rows
constexpr int CG = THREADS / RG;     // column groups
constexpr int NS = BN / CG;          // score columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Query rows m0 .. m0+BM-1 of (batch row b, kv head gi) from x [b, sq, H, W]
// into dst [BM][W+1] as float32 * mul; rows at or past M = rep * sq are 0.
template <typename T, int W>
__device__ void load_rows(const T* __restrict__ x, float* dst, int m0, int M,
                          int b, int gi, int rep, int sq, int H, float mul) {
  for (int idx = threadIdx.x; idx < BM * W; idx += THREADS) {
    const int r = idx / W, d = idx % W, m = m0 + r;
    float val = 0.f;
    if (m < M) {
      const int i = m / rep, h = gi * rep + m % rep;
      val = to_f32(x[((static_cast<size_t>(b) * sq + i) * H + h) * W + d]) *
            mul;
    }
    dst[r * (W + 1) + d] = val;
  }
}

// Keys n0 .. n0+BN-1 of (b, gi) from x [b, S, G, W] into dst [BN][W+1];
// keys at or past S are 0.
template <typename T, int W>
__device__ void load_keys(const T* __restrict__ x, float* dst, int n0, int S,
                          int b, int G, int gi) {
  for (int idx = threadIdx.x; idx < BN * W; idx += THREADS) {
    const int r = idx / W, d = idx % W, n = n0 + r;
    dst[r * (W + 1) + d] =
        n < S ? to_f32(x[((static_cast<size_t>(b) * S + n) * G + gi) * W + d])
              : 0.f;
  }
}

// The thread's 4 x NS block of S = Qs Ks^T and dP = dOs Vs^T for rows
// tr*4 .. tr*4+3 and columns tc + j*CG of the current tiles.
template <int E, int EV>
__device__ __forceinline__ void scores(const float* Qs, const float* Ks,
                                       const float* dOs, const float* Vs,
                                       int tr, int tc, float (&s)[4][NS],
                                       float (&dp)[4][NS]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < E; ++d) {
    float qv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr * 4 + i) * (E + 1) + d];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float kd = Ks[(tc + j * CG) * (E + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][j] = fmaf(qv[i], kd, s[i][j]);
    }
  }
#pragma unroll 8
  for (int e = 0; e < EV; ++e) {
    float ov[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ov[i] = dOs[(tr * 4 + i) * (EV + 1) + e];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float ve = Vs[(tc + j * CG) * (EV + 1) + e];
#pragma unroll
      for (int i = 0; i < 4; ++i) dp[i][j] = fmaf(ov[i], ve, dp[i][j]);
    }
  }
}

// Keys visible to query row m: k < lim. Rows at or past M see none.
__device__ __forceinline__ int row_limit(int m, int M, int rep, int causal,
                                         int q_offset, int S) {
  if (m >= M) return 0;
  const int L = causal ? q_offset + m / rep + 1 : S;
  return min(max(L, 0), S);
}

template <int E, int EV>
struct BwdSmem {
  static constexpr int dq_floats = BM * (E + 1) + BM * (EV + 1) +
                                   BN * (E + 1) + BN * (EV + 1) +
                                   BM * (BN + 1) + 2 * BM;
  static constexpr int dkdv_floats = dq_floats + BM * (BN + 1);
};

template <typename T, int E, int EV>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ Dg, float* __restrict__ dq, int sq, int H,
              int G, int S, int causal, int q_offset, float scale) {
  constexpr int NA = E / CG;
  static_assert(E % CG == 0 && EV % 2 == 0, "tile");
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BM * (E + 1);
  float* Ks = dOs + BM * (EV + 1);
  float* Vs = Ks + BN * (E + 1);
  float* dSs = Vs + BN * (EV + 1);
  float* lse_s = dSs + BM * (BN + 1);
  float* D_s = lse_s + BM;

  const int b = blockIdx.x / G, gi = blockIdx.x % G;
  const int rep = H / G, M = rep * sq, m0 = blockIdx.y * BM;
  const int tr = threadIdx.x / CG, tc = threadIdx.x % CG;

  load_rows<T, E>(q, Qs, m0, M, b, gi, rep, sq, H, scale);
  load_rows<T, EV>(dout, dOs, m0, M, b, gi, rep, sq, H, 1.f);
  __syncthreads();
  {
    // D = rowsum(dO * O): two threads per row, half the columns each
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, m = m0 + r;
    float acc = 0.f;
    if (m < M) {
      const int i = m / rep, h = gi * rep + m % rep;
      const T* orow = o + ((static_cast<size_t>(b) * sq + i) * H + h) * EV;
      for (int e = half * (EV / 2); e < (half + 1) * (EV / 2); ++e)
        acc = fmaf(dOs[r * (EV + 1) + e], to_f32(orow[e]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      float l = INFINITY;  // rows past M: P = exp(S - inf) = 0
      if (m < M) {
        const int i = m / rep, h = gi * rep + m % rep;
        const size_t st = (static_cast<size_t>(b) * H + h) * sq + i;
        l = lse[st];
        Dg[st] = acc;
      }
      lse_s[r] = l;
      D_s[r] = acc;
    }
  }

  int lim[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    lim[i] = row_limit(m0 + tr * 4 + i, M, rep, causal, q_offset, S);
  const int m_last = min(m0 + BM, M) - 1;
  const int kend = row_limit(m_last, M, rep, causal, q_offset, S);
  const int n_tiles = (kend + BN - 1) / BN;

  float acc[4][NA];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[i][a] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * BN;
    __syncthreads();  // previous tile's K and dS reads are done
    load_keys<T, E>(k, Ks, n0, S, b, G, gi);
    load_keys<T, EV>(v, Vs, n0, S, b, G, gi);
    __syncthreads();
    float s[4][NS], dp[4][NS];
    scores<E, EV>(Qs, Ks, dOs, Vs, tr, tc, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const float l = lse_s[r], dd = D_s[r];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int c = tc + j * CG;
        const float p =
            (n0 + c < lim[i] && l != -INFINITY) ? expf(s[i][j] - l) : 0.f;
        dSs[r * (BN + 1) + c] = p * (dp[i][j] - dd);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(tr * 4 + i) * (BN + 1) + n];
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const float kv = Ks[n * (E + 1) + tc + a * CG];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][a] = fmaf(dsv[i], kv, acc[i][a]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tr * 4 + i;
    if (m >= M) continue;
    const int iq = m / rep, h = gi * rep + m % rep;
    float* dst = dq + ((static_cast<size_t>(b) * sq + iq) * H + h) * E;
#pragma unroll
    for (int a = 0; a < NA; ++a) dst[tc + a * CG] = acc[i][a] * scale;
  }
}

template <typename T, int E, int EV>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ Dg,
                float* __restrict__ dk, float* __restrict__ dv, int sq, int H,
                int G, int S, int causal, int q_offset, float scale) {
  constexpr int NK = E / CG, NV = EV / CG;
  static_assert(E % CG == 0 && EV % CG == 0 && BN == 4 * RG, "tile");
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BM * (E + 1);
  float* Ks = dOs + BM * (EV + 1);
  float* Vs = Ks + BN * (E + 1);
  float* Ps = Vs + BN * (EV + 1);
  float* lse_s = Ps + BM * (BN + 1);
  float* D_s = lse_s + BM;
  float* dSs = D_s + BM;

  const int b = blockIdx.x / G, gi = blockIdx.x % G;
  const int rep = H / G, M = rep * sq, n0 = blockIdx.y * BN;
  const int tr = threadIdx.x / CG, tc = threadIdx.x % CG;

  load_keys<T, E>(k, Ks, n0, S, b, G, gi);
  load_keys<T, EV>(v, Vs, n0, S, b, G, gi);

  // first query row that can see key n0 (causal), as a tile index
  int i_first = causal ? max(n0 - q_offset, 0) : 0;
  const int t0 = min(i_first, sq) * rep / BM;
  const int n_tiles = (M + BM - 1) / BM;

  float dK[4][NK], dV[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int a = 0; a < NK; ++a) dK[i][a] = 0.f;
#pragma unroll
    for (int a = 0; a < NV; ++a) dV[i][a] = 0.f;
  }

  for (int t = t0; t < n_tiles; ++t) {
    const int m0 = t * BM;
    __syncthreads();  // previous tile's Q, dO, P, dS reads are done
    load_rows<T, E>(q, Qs, m0, M, b, gi, rep, sq, H, scale);
    load_rows<T, EV>(dout, dOs, m0, M, b, gi, rep, sq, H, 1.f);
    if (threadIdx.x < BM) {
      const int m = m0 + threadIdx.x;
      float l = INFINITY, dd = 0.f;
      if (m < M) {
        const int i = m / rep, h = gi * rep + m % rep;
        const size_t st = (static_cast<size_t>(b) * H + h) * sq + i;
        l = lse[st];
        dd = Dg[st];
      }
      lse_s[threadIdx.x] = l;
      D_s[threadIdx.x] = dd;
    }
    __syncthreads();
    float s[4][NS], dp[4][NS];
    scores<E, EV>(Qs, Ks, dOs, Vs, tr, tc, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const int lim = row_limit(m0 + r, M, rep, causal, q_offset, S);
      const float l = lse_s[r], dd = D_s[r];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int c = tc + j * CG;
        const float p =
            (n0 + c < lim && l != -INFINITY) ? expf(s[i][j] - l) : 0.f;
        Ps[r * (BN + 1) + c] = p;
        dSs[r * (BN + 1) + c] = p * (dp[i][j] - dd);
      }
    }
    __syncthreads();
    // key side: thread owns keys tr*4 .. tr*4+3, columns tc + a*CG
#pragma unroll 4
    for (int m = 0; m < BM; ++m) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[m * (BN + 1) + tr * 4 + i];
        dsv[i] = dSs[m * (BN + 1) + tr * 4 + i];
      }
#pragma unroll
      for (int a = 0; a < NV; ++a) {
        const float ov = dOs[m * (EV + 1) + tc + a * CG];
#pragma unroll
        for (int i = 0; i < 4; ++i) dV[i][a] = fmaf(pv[i], ov, dV[i][a]);
      }
#pragma unroll
      for (int a = 0; a < NK; ++a) {
        const float qv = Qs[m * (E + 1) + tc + a * CG];  // scale * q
#pragma unroll
        for (int i = 0; i < 4; ++i) dK[i][a] = fmaf(dsv[i], qv, dK[i][a]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + tr * 4 + i;
    if (n >= S) continue;
    const size_t row = (static_cast<size_t>(b) * S + n) * G + gi;
#pragma unroll
    for (int a = 0; a < NK; ++a) dk[row * E + tc + a * CG] = dK[i][a];
#pragma unroll
    for (int a = 0; a < NV; ++a) dv[row * EV + tc + a * CG] = dV[i][a];
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern* kern, size_t bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int E, int EV>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* D, float* dq, float* dk,
        float* dv, int b, int sq, int H, int G, int S, int causal,
        int q_offset, float scale, cudaStream_t stream) {
  const size_t smem_q = BwdSmem<E, EV>::dq_floats * sizeof(float);
  const size_t smem_kv = BwdSmem<E, EV>::dkdv_floats * sizeof(float);
  auto kq = dq_kernel<T, E, EV>;
  auto kkv = dkdv_kernel<T, E, EV>;
  cudaError_t err = allow_smem(kq, smem_q);
  if (err == cudaSuccess) err = allow_smem(kkv, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const int M = H / G * sq;
  kq<<<dim3(b * G, (M + BM - 1) / BM), THREADS, smem_q, stream>>>(
      tq, tk, tv, static_cast<const T*>(o), tdo, lse, D, dq, sq, H, G, S,
      causal, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S > 0)
    kkv<<<dim3(b * G, (S + BN - 1) / BN), THREADS, smem_kv, stream>>>(
        tq, tk, tv, tdo, lse, D, dk, dv, sq, H, G, S, causal, q_offset,
        scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (q, k, v, o, dout share one).
// lse [b, H, sq] from flash_attention_fwd; D [b, H, sq] float32 scratch;
// dq [b, sq, H, E], dk [b, S, G, E], dv [b, S, G, EV] float32 outputs.
// Head dim 64 only. Returns 0, a cudaError_t, or -1 for a shape or dtype
// without an instantiation.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* D, float* dq, float* dk, float* dv,
                                   int b, int sq, int H, int G, int S, int E,
                                   int EV, int causal, int q_offset,
                                   float scale, void* stream) {
  if (b == 0 || sq == 0) return 0;
  if (E != 64 || EV != 64) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float, 64, 64>(q, k, v, o, dout, lse, D, dq, dk, dv, b, sq, H,
                              G, S, causal, q_offset, scale, st);
  if (dtype == 1)
    return run<__nv_bfloat16, 64, 64>(q, k, v, o, dout, lse, D, dq, dk, dv,
                                      b, sq, H, G, S, causal, q_offset, scale,
                                      st);
  return -1;
}
