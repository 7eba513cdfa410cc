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
// Bound on the H100: operations. The five products of the backward (S,
// dP, dV, dQ and dK over the visible pairs) are 2.5x the forward's two:
// 43 GFLOP a causal call at the training shape (sq = sk = 2048, 32 q heads
// over 8 kv heads, e = 64), far above the card's ~295 flops per byte of
// the 20 MB it reads and writes. So the products belong on the tensor
// cores.
//
// Layout: two deterministic passes, no atomics; both recompute S and P
// from q, k and lse, so the [sq, sk] matrices never reach device memory.
//   * dQ pass: one block owns one (batch row, kv head) and 64 query rows
//     (all rep q heads, ordered m = i * rep + r as in the forward); it
//     forms D for its rows (written to device memory for the second
//     pass), then walks the K/V tiles up to its causal limit and
//     accumulates dQ. Blocks go in reverse query order, longest first.
//   * dK/dV pass: one block owns one (batch row, kv head) and 64 keys,
//     with K and V resident in shared memory; its three warpgroups split
//     the query tiles (all rep q heads) from the first that can see its
//     keys, each accumulating a partial dK and dV, which the first adds
//     in a fixed order at the end. Key tile 0 sees the most query tiles
//     and is issued first; the split cuts the longest block, which alone
//     would outlast the rest of the pass, to a third.
// The two passes do seven products (S twice, dP twice, dQ, dK, dV)
// against the bound's five.
//
// bf16 inputs: tensor-core bodies (dq_tc, dkdv_tc; mma_tile.cuh). Tiles
// of 64 rows stay bf16 in shared memory in the 128-byte swizzle, the
// streamed operand (K/V for the dQ pass, q/dO with their lse and D for
// the dK/dV pass) in a two-stage cp.async ring per warpgroup. S and dP
// (or S^T = K q^T and dP^T = V dO^T in the dK/dV pass, keys as the wgmma
// rows) are wgmma products of shared-memory operands; P and dS are
// formed in float32 on the accumulator fragments (one ex2 instruction an
// element), rounded to bf16 in registers and fed as the register A
// operand of dQ += dS K, dV += P^T dO and dK += dS^T q, as FlashAttention
// does. Only tiles that reach a row's causal limit are masked. 49 KB of
// shared memory for a dQ block, 116 KB for a dK/dV block (one an SM).
//
// Head dims: 64, 128 and 96 (gpt-1.5B). The tiles are whole 64-column
// blocks of the 128-byte swizzle, so e = 96 runs the 128-wide bodies with
// the last 32 columns of every q, k, v and dO tile zero-filled by
// cp.async from a zero source size (no extra bytes read); the products
// add exact zeros over them, and dq, dk and dv are stored for 96 columns.
// 4/3 of a 96-wide tile's products. At 128 (and 96) a dQ block takes
// 97 KB and a dK/dV block splits its query tiles over two warpgroups
// (kv_wg) in 163 KB: each holds 64 keys' dK and dV, 128 float registers a
// thread.
//
// float32 inputs: the CUDA-core bodies (cc::dq_kernel, cc::dkdv_kernel):
// scores, products and sums in float32 on the CUDA cores. No path of the
// port runs them on the card; they serve float32 callers and tests.
//
// dq, dk, dv are written in float32 by both bodies.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int BM = 64;  // query rows a tile
constexpr int BN = 64;  // keys a tile

template <int E, int EV>
struct DqSmem {
  static constexpr int q = BM * E * 2, dout = BM * EV * 2;
  static constexpr int k = BN * E * 2;
  static constexpr int stage = BN * (E + EV) * 2;  // K then V
  static constexpr int tiles = q + dout + 2 * stage;
  static constexpr size_t bytes = tiles + 2 * BM * 4 + 1024;  // lse, D
};

// Warpgroups of a dK/dV block (tile widths E, EV): they share the block's
// resident K and V and split its query tiles, so the key tiles that see
// the most queries (the first, under the causal mask) take no longer than
// the average SM's share of the pass. Three at a head dim of 64; two at
// 128 (or 96, padded to it), where a warpgroup's dK and dV accumulators
// take 128 float registers a thread and its ring 64 KB: three would need
// more than the 168 registers a thread of 384 and the 227 KB of shared
// memory a block can have.
template <int E, int EV>
__host__ __device__ constexpr int kv_wg() {
  return E + EV > 128 ? 2 : 3;
}

template <int E, int EV>
struct DkdvSmem {
  static constexpr int NWG = kv_wg<E, EV>();
  static constexpr int k = BN * E * 2, v = BN * EV * 2;
  static constexpr int q = BM * E * 2;
  static constexpr int stage = BM * (E + EV) * 2;  // q then dO
  static constexpr int ring = 2 * stage;           // a warpgroup's stages
  static constexpr int tiles = k + v + NWG * ring;
  // + per warpgroup and stage the tile's lse and D; + alignment
  static constexpr size_t bytes = tiles + NWG * 2 * 2 * BM * 4 + 1024;
  // the rings then hold the partial dK, dV of warpgroups 1..
  static_assert(NWG * ring >= (NWG - 1) * BN * (E + EV) * 4, "ring");
  static_assert(bytes <= 232448, "shared memory of a block");
};

// ER, EVR: the head dims of q/k and v in device memory; E, EV: the tile
// widths, padded up to whole 64-column blocks (96 -> 128, zeros past ER).
template <int ER, int EVR>
__global__ void __launch_bounds__(mma::WG)
    dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ o,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ Dg, float* __restrict__ dq, int sq, int H,
          int G, int S, int causal, int q_offset, float scale) {
  using namespace mma;
  constexpr int E = pad64(ER), EV = pad64(EVR);
  using L = DqSmem<E, EV>;
  extern __shared__ uint8_t smem_dq[];
  const uint32_t sQ = (smem_u32(smem_dq) + 1023) & ~1023u;
  const uint32_t sdO = sQ + L::q, sKV = sdO + L::dout;
  float* lse_s = reinterpret_cast<float*>(smem_dq + (sQ - smem_u32(smem_dq))
                                          + L::tiles);
  float* D_s = lse_s + BM;

  const int b = blockIdx.x / G, gi = blockIdx.x % G;
  const Rows rows(b, gi, sq, H, G, S, causal, q_offset);
  const int M = rows.M;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);

  const int lim[2] = {rows.limit(m0 + r0), rows.limit(m0 + r0 + 8)};
  const int lo = rows.min_limit<BM>(m0);
  const int n_tiles = (rows.limit(min(m0 + BM, M) - 1) + BN - 1) / BN;
  const float sl2 = scale * LOG2E;
  const int kv_stride = G * ER, v_stride = G * EVR;  // between keys

  load_tile<BM, E, ER>(sQ, q, [&](int r) -> const bf16* {
    return m0 + r < M ? q + rows.row(m0 + r) * ER : nullptr;
  });
  load_tile<BM, EV, EVR>(sdO, dout, [&](int r) -> const bf16* {
    return m0 + r < M ? dout + rows.row(m0 + r) * EVR : nullptr;
  });
  auto load_kv = [&](int t) {
    const uint32_t sK = sKV + (t & 1) * L::stage;
    const int n0 = t * BN;
    const size_t key0 = static_cast<size_t>(b) * S + n0;
    const bf16* kt = k + (key0 * G + gi) * ER;
    const bf16* vt = v + (key0 * G + gi) * EVR;
    load_tile<BN, E, ER>(sK, k, [&](int r) -> const bf16* {
      return n0 + r < S ? kt + r * kv_stride : nullptr;
    });
    load_tile<BN, EV, EVR>(sK + L::k, v, [&](int r) -> const bf16* {
      return n0 + r < S ? vt + r * v_stride : nullptr;
    });
  };
  if (n_tiles > 0) load_kv(0);
  cp_commit();

  {
    // D = rowsum(dO * O) in float32: two threads a row, half the columns
    // each; written to device memory for the dK/dV pass
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, m = m0 + r;
    float acc = 0.f;
    if (m < M) {
      const size_t at = rows.row(m) * EVR + half * EVR / 2;
      const uint4* orow = reinterpret_cast<const uint4*>(o + at);
      const uint4* drow = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
      for (int u = 0; u < EVR / 16; ++u) {
        const uint4 ov = __ldg(orow + u), dv = __ldg(drow + u);
        const __nv_bfloat162* op =
            reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* dp =
            reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 x = __bfloat1622float2(op[w]);
          const float2 y = __bfloat1622float2(dp[w]);
          acc = fmaf(y.x, x.x, acc);
          acc = fmaf(y.y, x.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      float l = 0.f;
      if (m < M) {
        const size_t st = rows.stat(m);
        l = lse[st];
        Dg[st] = acc;
      }
      lse_s[r] = l;
      D_s[r] = acc;
    }
  }
  __syncthreads();
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = lse_s[r0 + 8 * h];
    l2[h] = l == -INFINITY ? INFINITY : l * LOG2E;  // no key: P = 0
    dd[h] = D_s[r0 + 8 * h];
  }

  float acc[E / 64][32];
#pragma unroll
  for (int eb = 0; eb < E / 64; ++eb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[eb][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * BN;
    if (t + 1 < n_tiles) {
      load_kv(t + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const uint32_t sK = sKV + (t & 1) * L::stage, sV = sK + L::k;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    reg_fence(s);
    reg_fence(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < E / 16; ++kk)
      wgmma_ss(s, desc_k<BM>(sQ, kk), desc_k<BN>(sK, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < EV / 16; ++kk)
      wgmma_ss(dp, desc_k<BM>(sdO, kk), desc_k<BN>(sV, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    const bool edge = n0 + BN > lo;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * h + c;
          const float p = (edge && n0 + 8 * j + c0 + c >= lim[h])
                              ? 0.f
                              : fast_exp2(fmaf(s[i], sl2, -l2[h]));
          s[i] = p * (dp[i] - dd[h]);  // dS
        }
    uint32_t a[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) to_a(s, kk, a[kk]);
#pragma unroll
    for (int eb = 0; eb < E / 64; ++eb) reg_fence(acc[eb]);
    reg_fence(a);
    wg_fence();
#pragma unroll
    for (int eb = 0; eb < E / 64; ++eb)
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(acc[eb], a[kk], desc_mn<BN>(sK + eb * BN * 128, kk));
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int eb = 0; eb < E / 64; ++eb) reg_fence(acc[eb]);
    __syncthreads();  // this stage's K/V reads are done before its refill
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + r0 + 8 * h;
    if (m >= M) continue;
    float* dst = dq + rows.row(m) * ER;
#pragma unroll
    for (int eb = 0; eb < E / 64; ++eb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (eb * 64 + 8 * j >= ER) continue;  // pad columns: not stored
        *reinterpret_cast<float2*>(dst + eb * 64 + 8 * j + c0) =
            make_float2(acc[eb][4 * j + 2 * h] * scale,
                        acc[eb][4 * j + 2 * h + 1] * scale);
      }
  }
}

template <int ER, int EVR>
__global__ void __launch_bounds__(
    kv_wg<mma::pad64(ER), mma::pad64(EVR)>() * mma::WG)
    dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ Dg,
            float* __restrict__ dk, float* __restrict__ dv, int sq, int H,
            int G, int S, int causal, int q_offset, float scale) {
  using namespace mma;
  constexpr int E = pad64(ER), EV = pad64(EVR);
  using L = DkdvSmem<E, EV>;
  constexpr int KV_WG = L::NWG;
  extern __shared__ uint8_t smem_kv[];
  const uint32_t sK = (smem_u32(smem_kv) + 1023) & ~1023u;
  const uint32_t sV = sK + L::k, sRings = sV + L::v;
  uint8_t* gen = smem_kv + (sK - smem_u32(smem_kv));  // generic view of sK

  const int b = blockIdx.x / G, gi = blockIdx.x % G;
  const Rows rows(b, gi, sq, H, G, S, causal, q_offset);
  const int M = rows.M, n0 = blockIdx.y * BN;
  const int wg = threadIdx.x / WG, tl = threadIdx.x % WG;
  const int warp = tl >> 5, lane = tl & 31;
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  const float sl2 = scale * LOG2E;
  // this warpgroup's ring (two stages of q, dO) and its lse, D per stage
  const uint32_t sRing = sRings + wg * L::ring;
  const uint32_t sStat = sK + L::tiles + wg * 2 * 2 * BM * 4;
  const float* stat = reinterpret_cast<const float*>(
      gen + L::tiles + wg * 2 * 2 * BM * 4);

  if (wg == 0) {  // K and V, resident for the block
    const size_t key0 = static_cast<size_t>(b) * S + n0;
    const bf16* kt = k + (key0 * G + gi) * ER;
    const bf16* vt = v + (key0 * G + gi) * EVR;
    load_tile<BN, E, ER>(sK, k, [&](int r) -> const bf16* {
      return n0 + r < S ? kt + r * (G * ER) : nullptr;
    });
    load_tile<BN, EV, EVR>(sV, v, [&](int r) -> const bf16* {
      return n0 + r < S ? vt + r * (G * EVR) : nullptr;
    });
  }
  // the query tiles that can see key n0 (causal) start at t0; warpgroup wg
  // takes t0 + wg, t0 + wg + KV_WG, ...
  const int i_first = causal ? max(n0 - q_offset, 0) : 0;
  const int t0 = min(i_first, sq) * rows.rep.d / BM + wg;
  const int n_qt = (M + BM - 1) / BM;
  auto load_q = [&](int t, int st) {
    const int m0 = t * BM;
    const uint32_t sQ = sRing + st * L::stage;
    load_tile<BM, E, ER>(sQ, q, [&](int r) -> const bf16* {
      return m0 + r < M ? q + rows.row(m0 + r) * ER : nullptr;
    });
    load_tile<BM, EV, EVR>(sQ + L::q, dout, [&](int r) -> const bf16* {
      return m0 + r < M ? dout + rows.row(m0 + r) * EVR : nullptr;
    });
    // lse and D of the tile's rows: threads 0-63 lse, 64-127 D
    const int r = tl & (BM - 1), m = m0 + r;
    cp4(sStat + (st * 2 * BM + (tl < BM ? 0 : BM) + r) * 4,
        (tl < BM ? lse : Dg) + (m < M ? rows.stat(m) : 0), m < M);
  };
  if (t0 < n_qt) load_q(t0, 0);
  cp_commit();
  cp_wait<0>();
  fence_async_smem();
  __syncthreads();  // K and V are in for every warpgroup

  float dK[E / 64][32], dV[EV / 64][32];
#pragma unroll
  for (int eb = 0; eb < E / 64; ++eb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dK[eb][i] = 0.f;
#pragma unroll
  for (int eb = 0; eb < EV / 64; ++eb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dV[eb][i] = 0.f;
  const int key[2] = {n0 + r0, n0 + r0 + 8};

  for (int t = t0, u = 0; t < n_qt; t += KV_WG, ++u) {
    const int st = u & 1, m0 = t * BM;
    if (t + KV_WG < n_qt) {
      load_q(t + KV_WG, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    fence_async_smem();
    wg_barrier(1 + wg);
    const uint32_t sQ = sRing + st * L::stage, sdO = sQ + L::q;
    const float* lse_s = stat + st * 2 * BM;
    const float* D_s = lse_s + BM;

    // S^T = K q^T and dP^T = V dO^T: keys are the rows, query rows the
    // columns
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    reg_fence(s);
    reg_fence(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < E / 16; ++kk)
      wgmma_ss(s, desc_k<BN>(sK, kk), desc_k<BM>(sQ, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < EV / 16; ++kk)
      wgmma_ss(dp, desc_k<BN>(sV, kk), desc_k<BM>(sdO, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    const bool edge = n0 + BN > rows.min_limit<BM>(m0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + c0 + c;
        const float l = lse_s[col], dd = D_s[col];
        const float l2 = l == -INFINITY ? INFINITY : l * LOG2E;
        const int lim = edge ? rows.limit(m0 + col) : S;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + c;
          const float p =
              key[h] >= lim ? 0.f : fast_exp2(fmaf(s[i], sl2, -l2));
          s[i] = p;
          dp[i] = p * (dp[i] - dd);  // dS^T
        }
      }
    uint32_t ap[BM / 16][4], ads[BM / 16][4];
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      to_a(s, kk, ap[kk]);
      to_a(dp, kk, ads[kk]);
    }
#pragma unroll
    for (int eb = 0; eb < EV / 64; ++eb) reg_fence(dV[eb]);
#pragma unroll
    for (int eb = 0; eb < E / 64; ++eb) reg_fence(dK[eb]);
    reg_fence(ap);
    reg_fence(ads);
    wg_fence();
#pragma unroll
    for (int eb = 0; eb < EV / 64; ++eb)
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        wgmma_rs(dV[eb], ap[kk], desc_mn<BM>(sdO + eb * BM * 128, kk));
#pragma unroll
    for (int eb = 0; eb < E / 64; ++eb)
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        wgmma_rs(dK[eb], ads[kk], desc_mn<BM>(sQ + eb * BM * 128, kk));
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int eb = 0; eb < EV / 64; ++eb) reg_fence(dV[eb]);
#pragma unroll
    for (int eb = 0; eb < E / 64; ++eb) reg_fence(dK[eb]);
    wg_barrier(1 + wg);  // this stage's reads are done before its refill
  }

  // warpgroups 1.. hand their partial dK, dV to warpgroup 0 through the
  // rings, which it adds in warpgroup order: a fixed summation order
  constexpr int NV = (E + EV) / 64 * 32;  // partial values a thread
  float* part = reinterpret_cast<float*>(gen + L::k + L::v);
  __syncthreads();  // every ring read is done
  if (wg > 0) {
    float* mine = part + (wg - 1) * NV * WG + tl;
#pragma unroll
    for (int eb = 0; eb < E / 64; ++eb)
#pragma unroll
      for (int i = 0; i < 32; ++i) mine[(eb * 32 + i) * WG] = dK[eb][i];
#pragma unroll
    for (int eb = 0; eb < EV / 64; ++eb)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mine[((E / 64 + eb) * 32 + i) * WG] = dV[eb][i];
  }
  __syncthreads();
  if (wg > 0) return;
  for (int w = 1; w < KV_WG; ++w) {
    const float* theirs = part + (w - 1) * NV * WG + tl;
#pragma unroll
    for (int eb = 0; eb < E / 64; ++eb)
#pragma unroll
      for (int i = 0; i < 32; ++i) dK[eb][i] += theirs[(eb * 32 + i) * WG];
#pragma unroll
    for (int eb = 0; eb < EV / 64; ++eb)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dV[eb][i] += theirs[((E / 64 + eb) * 32 + i) * WG];
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = key[h];
    if (n >= S) continue;
    const size_t row = (static_cast<size_t>(b) * S + n) * G + gi;
    // the pad columns (past ER, EVR) are not stored
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int eb = 0; eb < E / 64; ++eb)
        if (eb * 64 + 8 * j < ER)
          *reinterpret_cast<float2*>(dk + row * ER + eb * 64 + 8 * j + c0) =
              make_float2(dK[eb][4 * j + 2 * h] * scale,
                          dK[eb][4 * j + 2 * h + 1] * scale);
#pragma unroll
      for (int eb = 0; eb < EV / 64; ++eb)
        if (eb * 64 + 8 * j < EVR)
          *reinterpret_cast<float2*>(dv + row * EVR + eb * 64 + 8 * j +
                                     c0) =
              make_float2(dV[eb][4 * j + 2 * h], dV[eb][4 * j + 2 * h + 1]);
    }
  }
}

template <int ER, int EVR>
int run_tc(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* D, float* dq,
           float* dk, float* dv, int b, int sq, int H, int G, int S,
           int causal, int q_offset, float scale, cudaStream_t stream) {
  constexpr int E = mma::pad64(ER), EV = mma::pad64(EVR);
  using LQ = DqSmem<E, EV>;
  using LKV = DkdvSmem<E, EV>;
  auto kq = dq_tc<ER, EVR>;
  auto kkv = dkdv_tc<ER, EVR>;
  cudaError_t err = mma::allow_smem(kq, LQ::bytes);
  if (err == cudaSuccess) err = mma::allow_smem(kkv, LKV::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  const int M = H / G * sq;
  kq<<<dim3(b * G, (M + BM - 1) / BM), mma::WG, LQ::bytes, stream>>>(
      tq, tk, tv, static_cast<const bf16*>(o), tdo, lse, D, dq, sq, H, G, S,
      causal, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S > 0)
    kkv<<<dim3(b * G, (S + BN - 1) / BN), LKV::NWG * mma::WG, LKV::bytes,
          stream>>>(tq, tk, tv, tdo, lse, D, dk, dv, sq, H, G, S, causal,
                    q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The CUDA-core bodies (float32 inputs).
namespace cc {

constexpr int THREADS = 128;
constexpr int BM = 64;  // query rows per tile
constexpr int BN = 64;  // keys per tile
constexpr int RG = BM / 4;           // row groups of 4 rows
constexpr int CG = THREADS / RG;     // column groups
constexpr int NS = BN / CG;          // score columns per thread

// Query rows m0 .. m0+BM-1 of (batch row b, kv head gi) from x [b, sq, H, W]
// into dst [BM][W+1] as float32 * mul; rows at or past M = rep * sq are 0.
template <int W>
__device__ void load_rows(const float* __restrict__ x, float* dst, int m0,
                          int M, int b, int gi, int rep, int sq, int H,
                          float mul) {
  for (int idx = threadIdx.x; idx < BM * W; idx += THREADS) {
    const int r = idx / W, d = idx % W, m = m0 + r;
    float val = 0.f;
    if (m < M) {
      const int i = m / rep, h = gi * rep + m % rep;
      val = x[((static_cast<size_t>(b) * sq + i) * H + h) * W + d] * mul;
    }
    dst[r * (W + 1) + d] = val;
  }
}

// Keys n0 .. n0+BN-1 of (b, gi) from x [b, S, G, W] into dst [BN][W+1];
// keys at or past S are 0.
template <int W>
__device__ void load_keys(const float* __restrict__ x, float* dst, int n0,
                          int S, int b, int G, int gi) {
  for (int idx = threadIdx.x; idx < BN * W; idx += THREADS) {
    const int r = idx / W, d = idx % W, n = n0 + r;
    dst[r * (W + 1) + d] =
        n < S ? x[((static_cast<size_t>(b) * S + n) * G + gi) * W + d] : 0.f;
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

template <int E, int EV>
struct BwdSmem {
  static constexpr int dq_floats = BM * (E + 1) + BM * (EV + 1) +
                                   BN * (E + 1) + BN * (EV + 1) +
                                   BM * (BN + 1) + 2 * BM;
  static constexpr int dkdv_floats = dq_floats + BM * (BN + 1);
};

template <int E, int EV>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ dout, const float* __restrict__ lse,
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

  load_rows<E>(q, Qs, m0, M, b, gi, rep, sq, H, scale);
  load_rows<EV>(dout, dOs, m0, M, b, gi, rep, sq, H, 1.f);
  __syncthreads();
  {
    // D = rowsum(dO * O): two threads per row, half the columns each
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, m = m0 + r;
    float acc = 0.f;
    if (m < M) {
      const int i = m / rep, h = gi * rep + m % rep;
      const float* orow = o + ((static_cast<size_t>(b) * sq + i) * H + h) * EV;
      for (int e = half * (EV / 2); e < (half + 1) * (EV / 2); ++e)
        acc = fmaf(dOs[r * (EV + 1) + e], orow[e], acc);
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

  const mma::Rows rows(b, gi, sq, H, G, S, causal, q_offset);
  int lim[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) lim[i] = rows.limit(m0 + tr * 4 + i);
  const int kend = rows.limit(min(m0 + BM, M) - 1);
  const int n_tiles = (kend + BN - 1) / BN;

  float acc[4][NA];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[i][a] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * BN;
    __syncthreads();  // previous tile's K and dS reads are done
    load_keys<E>(k, Ks, n0, S, b, G, gi);
    load_keys<EV>(v, Vs, n0, S, b, G, gi);
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

template <int E, int EV>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
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

  load_keys<E>(k, Ks, n0, S, b, G, gi);
  load_keys<EV>(v, Vs, n0, S, b, G, gi);

  // first query row that can see key n0 (causal), as a tile index
  int i_first = causal ? max(n0 - q_offset, 0) : 0;
  const int t0 = min(i_first, sq) * rep / BM;
  const int n_tiles = (M + BM - 1) / BM;
  const mma::Rows rows(b, gi, sq, H, G, S, causal, q_offset);

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
    load_rows<E>(q, Qs, m0, M, b, gi, rep, sq, H, scale);
    load_rows<EV>(dout, dOs, m0, M, b, gi, rep, sq, H, 1.f);
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
      const int lim = rows.limit(m0 + r);
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

template <int E, int EV>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* D, float* dq, float* dk,
        float* dv, int b, int sq, int H, int G, int S, int causal,
        int q_offset, float scale, cudaStream_t stream) {
  const size_t smem_q = BwdSmem<E, EV>::dq_floats * sizeof(float);
  const size_t smem_kv = BwdSmem<E, EV>::dkdv_floats * sizeof(float);
  auto kq = dq_kernel<E, EV>;
  auto kkv = dkdv_kernel<E, EV>;
  cudaError_t err = mma::allow_smem(kq, smem_q);
  if (err == cudaSuccess) err = mma::allow_smem(kkv, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const int M = H / G * sq;
  kq<<<dim3(b * G, (M + BM - 1) / BM), THREADS, smem_q, stream>>>(
      tq, tk, tv, static_cast<const float*>(o), tdo, lse, D, dq, sq, H, G, S,
      causal, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S > 0)
    kkv<<<dim3(b * G, (S + BN - 1) / BN), THREADS, smem_kv, stream>>>(
        tq, tk, tv, tdo, lse, D, dk, dv, sq, H, G, S, causal, q_offset,
        scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cc

namespace {

template <int E>
int run(int dtype, const void* q, const void* k, const void* v,
        const void* o, const void* dout, const float* lse, float* D,
        float* dq, float* dk, float* dv, int b, int sq, int H, int G, int S,
        int causal, int q_offset, float scale, cudaStream_t st) {
  if (dtype == 0)
    return cc::run<E, E>(q, k, v, o, dout, lse, D, dq, dk, dv, b, sq, H, G,
                         S, causal, q_offset, scale, st);
  if (dtype == 1)
    return run_tc<E, E>(q, k, v, o, dout, lse, D, dq, dk, dv, b, sq, H, G,
                        S, causal, q_offset, scale, st);
  return -1;
}

}  // namespace

// dtype codes: 0 float32 (CUDA-core bodies), 1 bfloat16 (tensor-core
// bodies); q, k, v, o, dout share one. lse [b, H, sq] from
// flash_attention_fwd; D [b, H, sq] float32 scratch; dq [b, sq, H, E],
// dk [b, S, G, E], dv [b, S, G, EV] float32 outputs. Head dims E == EV in
// {64, 96 (the 128-wide tensor-core bodies with zero pad columns), 128}.
// Returns 0, a cudaError_t, or -1 for a shape or dtype without an
// instantiation.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* D, float* dq, float* dk, float* dv,
                                   int b, int sq, int H, int G, int S, int E,
                                   int EV, int causal, int q_offset,
                                   float scale, void* stream) {
  if (b == 0 || sq == 0) return 0;
  if (E != EV) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (E) {
    case 64:
      return run<64>(dtype, q, k, v, o, dout, lse, D, dq, dk, dv, b, sq, H,
                     G, S, causal, q_offset, scale, st);
    case 96:
      return run<96>(dtype, q, k, v, o, dout, lse, D, dq, dk, dv, b, sq, H,
                     G, S, causal, q_offset, scale, st);
    case 128:
      return run<128>(dtype, q, k, v, o, dout, lse, D, dq, dk, dv, b, sq, H,
                      G, S, causal, q_offset, scale, st);
    default:
      return -1;
  }
}
