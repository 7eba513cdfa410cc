// CUDA-core body of the slotted and paged serving attention kernels
// (sm_90a): float32 or mixed float32/bf16 dtypes and the window + stats
// contract (bf16 q over bf16 caches or bf16/int8 pools runs the
// tensor-core body, attention_tc.cuh), and K1's float32 path.
//
// One thread block owns one (batch row b, kv head gi) pair and BM "query
// rows" of it. A query row is one (q position i, q head r of the kv
// head's group) pair, ordered m = i * rep + r, so the rep q heads that
// share a kv head read each K/V tile once from device memory (GQA), and
// consecutive rows of a tile sit at consecutive q positions (the causal
// limit of the tile is its last row's). The block walks the K/V tiles of
// BN keys in shared memory, converted to float32 (int8 pools are
// dequantised there, value * scale[page, kv head], the reference's
// product), and keeps the online-softmax state (m, l, acc) of its rows
// in float32 registers. Tiles wholly past the block's causal or window
// limit are never loaded.
//
// Thread layout: 128 threads = RG row groups x CG column groups. Thread
// (tr, tc) owns the four rows tr*4..tr*4+3; of a tile's scores it owns
// the columns tc + j*CG, of the accumulator the value columns tc + a*CG.
// A row's partial max and sum reduce over the CG lanes of its group,
// which are consecutive lanes of one warp.
//
// Masking: a score outside the mask is -inf and its probability exactly
// 0; a row that sees no key keeps l == 0 and writes exact zeros (and
// m = -inf), as the plain version does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int THREADS = 128;
constexpr int BN = 64;  // keys per tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T from device memory (16-byte aligned) to float32 * mul.
template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ src,
                                       float* __restrict__ dst, float mul) {
  constexpr int N = 16 / sizeof(T);
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int u = 0; u < N; ++u) dst[u] = to_f32(e[u]) * mul;
}

// Shared memory of one block: Q [BM][E+1], K [BN][E+1], V [BN][EV],
// P [BM][BN+1], all float32 (the +1 pads keep strided reads off one bank).
template <int BM, int E, int EV>
struct Smem {
  static constexpr int floats =
      BM * (E + 1) + BN * (E + 1) + BN * EV + BM * (BN + 1);
  static constexpr size_t bytes = floats * sizeof(float);
};

// Fills one K/V tile (keys n0 .. n0+BN-1) of a contiguous cache
// k [b, S, G, E], v [b, S, G, EV]. Keys at or past S read as zeros.
template <typename T, int E, int EV>
struct ContigKV {
  const T* k;
  const T* v;
  int S, G;
  __device__ int limit() const { return S; }
  __device__ void load(float* Ks, float* Vs, int n0, int b, int gi) const {
    constexpr int VK = 16 / sizeof(T);
    for (int c = threadIdx.x; c < BN * (E / VK); c += THREADS) {
      const int r = c / (E / VK), d0 = (c % (E / VK)) * VK, n = n0 + r;
      float* dst = Ks + r * (E + 1) + d0;
      if (n < S)
        load16(k + ((static_cast<size_t>(b) * S + n) * G + gi) * E + d0, dst,
               1.f);
      else
        for (int u = 0; u < VK; ++u) dst[u] = 0.f;
    }
    for (int c = threadIdx.x; c < BN * (EV / VK); c += THREADS) {
      const int r = c / (EV / VK), d0 = (c % (EV / VK)) * VK, n = n0 + r;
      float* dst = Vs + r * EV + d0;
      if (n < S)
        load16(v + ((static_cast<size_t>(b) * S + n) * G + gi) * EV + d0,
               dst, 1.f);
      else
        for (int u = 0; u < VK; ++u) dst[u] = 0.f;
    }
  }
};

// Fills one K/V tile from page pools k [n_pages, ps, G, E] and
// v [n_pages, ps, G, EV] through row b's page table (ppr entries, ids
// clipped to [0, n_pages-1]); logical key n lives at page pt[n / ps],
// offset n % ps. With scales (int8 pools) each value is dequantised as
// value * scale[page, gi]. Keys at or past ppr*ps read as zeros.
template <typename T, int E, int EV>
struct PagedKV {
  const T* k;
  const T* v;
  const float* ks;  // [n_pages, G] or null
  const float* vs;
  const int* pt;    // [b, ppr]
  int ppr, ps, n_pages, G;
  __device__ int limit() const { return ppr * ps; }
  __device__ __forceinline__ int page_of(int b, int n) const {
    int p = pt[static_cast<size_t>(b) * ppr + n / ps];
    return p < 0 ? 0 : (p >= n_pages ? n_pages - 1 : p);
  }
  __device__ void load(float* Ks, float* Vs, int n0, int b, int gi) const {
    constexpr int VK = 16 / sizeof(T);
    const int lim = ppr * ps;
    for (int c = threadIdx.x; c < BN * (E / VK); c += THREADS) {
      const int r = c / (E / VK), d0 = (c % (E / VK)) * VK, n = n0 + r;
      float* dst = Ks + r * (E + 1) + d0;
      if (n < lim) {
        const int p = page_of(b, n);
        load16(k + ((static_cast<size_t>(p) * ps + n % ps) * G + gi) * E + d0,
               dst, ks ? ks[p * G + gi] : 1.f);
      } else {
        for (int u = 0; u < VK; ++u) dst[u] = 0.f;
      }
    }
    for (int c = threadIdx.x; c < BN * (EV / VK); c += THREADS) {
      const int r = c / (EV / VK), d0 = (c % (EV / VK)) * VK, n = n0 + r;
      float* dst = Vs + r * EV + d0;
      if (n < lim) {
        const int p = page_of(b, n);
        load16(v + ((static_cast<size_t>(p) * ps + n % ps) * G + gi) * EV + d0,
               dst, vs ? vs[p * G + gi] : 1.f);
      } else {
        for (int u = 0; u < VK; ++u) dst[u] = 0.f;
      }
    }
  }
};

// The block body. q [b, sq, H, E]; out [b, sq, H, EV] in TQ; p0 is the
// block's batch row position: causal rows see keys k <= p0 + i, window
// rows keys k < p0. With stats (m_out non-null) also writes m, l
// [b, H, sq] and the unnormalised acc [b, H, sq, EV] in float32; with
// lse_out non-null the per-row log-sum-exp m + log(l) [b, H, sq] in
// float32 (-inf for a row that sees no key).
template <typename TQ, int E, int EV, int BM, typename KV>
__device__ __forceinline__ void attend(const TQ* __restrict__ q,
                                       TQ* __restrict__ out,
                                       float* __restrict__ m_out,
                                       float* __restrict__ l_out,
                                       float* __restrict__ acc_out,
                                       float* __restrict__ lse_out, int p0,
                                       int sq,
                                       int H, int G, int window, float scale,
                                       const KV& kv) {
  constexpr int RG = BM / 4;
  constexpr int CG = THREADS / RG;
  constexpr int NS = BN / CG;
  constexpr int NA = EV / CG;
  static_assert(THREADS % RG == 0 && CG <= 32 && 32 % CG == 0, "layout");
  static_assert(BN % CG == 0 && EV % CG == 0, "tile");

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * (E + 1);
  float* Vs = Ks + BN * (E + 1);
  float* Ps = Vs + BN * EV;

  const int b = blockIdx.x / G, gi = blockIdx.x % G;
  const int rep = H / G;
  const int M = rep * sq;
  const int m0 = blockIdx.y * BM;
  const int tr = threadIdx.x / CG, tc = threadIdx.x % CG;
  const int S_lim = kv.limit();

  // Q tile, scaled in float32; rows past M are zeros.
  for (int idx = threadIdx.x; idx < BM * E; idx += THREADS) {
    const int r = idx / E, d = idx % E, m = m0 + r;
    float val = 0.f;
    if (m < M) {
      const int i = m / rep, h = gi * rep + m % rep;
      val = to_f32(q[((static_cast<size_t>(b) * sq + i) * H + h) * E + d]) *
            scale;
    }
    Qs[r * (E + 1) + d] = val;
  }

  // per-row key limit: key k is visible iff k < lim
  int lim[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tr * 4 + i;
    int L = 0;
    if (m < M) L = window ? p0 : p0 + m / rep + 1;
    lim[i] = min(max(L, 0), S_lim);
  }
  const int m_last = min(m0 + BM, M) - 1;
  int kend = window ? p0 : p0 + m_last / rep + 1;
  kend = min(max(kend, 0), S_lim);
  const int n_tiles = (kend + BN - 1) / BN;

  float mrow[4], lrow[4], acc[4][NA];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.f;
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[i][a] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * BN;
    __syncthreads();  // the previous tile's K/V/P reads are done
    kv.load(Ks, Vs, n0, b, gi);
    __syncthreads();

    float s[4][NS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) s[i][j] = 0.f;
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (n0 + tc + j * CG >= lim[i]) s[i][j] = -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = CG / 2; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float mnew = fmaxf(mrow[i], tmax);
      float psum = 0.f, corr = 1.f;
      if (mnew == -INFINITY) {
#pragma unroll
        for (int j = 0; j < NS; ++j) s[i][j] = 0.f;
      } else {
        corr = expf(mrow[i] - mnew);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - mnew);
          s[i][j] = p;
          psum += p;
        }
      }
#pragma unroll
      for (int off = CG / 2; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      lrow[i] = lrow[i] * corr + psum;
      mrow[i] = mnew;
#pragma unroll
      for (int a = 0; a < NA; ++a) acc[i][a] *= corr;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        Ps[(tr * 4 + i) * (BN + 1) + tc + j * CG] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr * 4 + i) * (BN + 1) + n];
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const float vv = Vs[n * EV + tc + a * CG];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][a] = fmaf(pv[i], vv, acc[i][a]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tr * 4 + i;
    if (m >= M) continue;
    const int iq = m / rep, h = gi * rep + m % rep;
    const float den = fmaxf(lrow[i], 1e-30f);
    TQ* o = out + ((static_cast<size_t>(b) * sq + iq) * H + h) * EV;
#pragma unroll
    for (int a = 0; a < NA; ++a) o[tc + a * CG] = from_f32<TQ>(acc[i][a] / den);
    if (lse_out != nullptr && tc == 0)
      lse_out[(static_cast<size_t>(b) * H + h) * sq + iq] =
          lrow[i] > 0.f ? mrow[i] + logf(lrow[i]) : -INFINITY;
    if (m_out != nullptr) {
      const size_t st = (static_cast<size_t>(b) * H + h) * sq + iq;
      if (tc == 0) {
        m_out[st] = mrow[i];
        l_out[st] = lrow[i];
      }
#pragma unroll
      for (int a = 0; a < NA; ++a) acc_out[st * EV + tc + a * CG] = acc[i][a];
    }
  }
}

// Rows per block: 16 when the (q position x q head) rows of one kv head
// fit (decode), else 64.
inline int pick_bm(int rows) { return rows <= 16 ? 16 : 64; }

// Raise the instantiation's dynamic shared memory cap to what it needs.
template <typename Kern>
inline cudaError_t allow_smem(Kern* kern, size_t bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace attn
