// Flash attention forward on Hopper: the training path's attention with a
// static query offset, causal or bidirectional, returning the per-row
// log-sum-exp beside the output as the residual of the backward
// (flash_attention_bwd.cu).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:82
// flash_attention (body _fwd_kernel :31), which the JAX package reaches
// from blocks.py:120 apply_attn through ops.py:80-87. Unlike the TPU
// kernel, it applies q_offset to the causal mask (row i sees keys
// k <= q_offset + i), so sq < sk windows are exact.
//
// Contract: q [b, sq, H, E], k [b, sk, G, E], v [b, sk, G, EV] in float32
// or bfloat16 (one dtype for all three); causal == 1: row i sees keys
// k <= q_offset + i; causal == 0: every row sees every key k < sk.
// out [b, sq, H, EV] in q's dtype, lse [b, H, sq] float32 (m + log l,
// -inf for a row that sees no key; its output is exact zeros).
//
// Bound on the H100: operations. At the training shape (sq = sk = 2048,
// 32 q heads over 8 kv heads, e = 64) a causal call does 2 * (e + ev)
// flops for each of 32 * 2048 * 2049 / 2 visible (query, key) pairs,
// 17.2 GFLOP, against 2 * 8 MB of q/out and 4 MB of K/V: ~1300 flops a
// byte, far above the card's ~295. So the products belong on the tensor
// cores.
//
// bf16 inputs: the tensor-core body (flash_fwd_tc, mma_tile.cuh). One
// warpgroup (128 threads) owns one (batch row, kv head) and 64 query rows
// m = i * rep + r (all rep q heads of the kv head, so each K/V tile is
// read once for them: GQA). Q stays in shared memory as bf16; K/V tiles
// of 64 keys stream through a two-stage cp.async ring, the next tile in
// flight while the current one is multiplied. S = Q K^T is a wgmma with
// both operands in shared memory; the online softmax (m, l, rescale)
// runs in float32 on the accumulator fragments, masking only the tiles
// that reach a row's causal limit, with one ex2 instruction an element
// and O rescaled only when a row's max moved; P is rounded to bf16 in
// registers and is the register A operand of O += P V, so it never
// returns to shared memory. Tiles wholly past the block's causal limit
// are never loaded; blocks are issued in reverse query order, the longest
// (last) rows first. 41 KB of shared memory a block, several blocks an SM
// hiding one another's softmax behind their products.
//
// Head dims: 64, 128 (two 64-column blocks: 81 KB a block) and 96
// (gpt-1.5B). The tensor-core tiles are whole 64-column blocks in the
// 128-byte swizzle, so e = 96 runs the 128-wide body: q, K and V fill 96
// columns from device memory and the last 32 are zero-filled by cp.async
// with a zero source size (no extra bytes read), S and P V add exact
// zeros over them, and only 96 output columns are stored. That spends 4/3
// of the products of a 96-wide tile; the softmax scale is the caller's,
// 1/sqrt(96).
//
// float32 inputs: the CUDA-core body shared with the serving kernels
// (attention_tile.cuh attend), products in float32 on the CUDA cores.
// No path of the port runs it on the card; it serves float32 callers and
// tests.
#include "attention_tile.cuh"
#include "mma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int BM = 64;  // query rows a block (one m64 wgmma tile)
constexpr int BN = 64;  // keys a tile

template <int E, int EV>
struct FwdSmem {
  static constexpr int q = BM * E * 2;
  static constexpr int k = BN * E * 2;
  static constexpr int stage = BN * (E + EV) * 2;  // K then V
  static constexpr size_t bytes = q + 2 * stage + 1024;  // + alignment
};

// ER, EVR: the head dims of q/k and v in device memory; E, EV: the tile
// widths, padded up to whole 64-column blocks (96 -> 128, zeros past ER).
template <int ER, int EVR>
__global__ void __launch_bounds__(mma::WG)
    flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int sq, int H, int G, int S,
                 int causal, int q_offset, float scale) {
  using namespace mma;
  constexpr int E = pad64(ER), EV = pad64(EVR);
  using L = FwdSmem<E, EV>;
  extern __shared__ uint8_t smem_fwd[];
  const uint32_t sQ = (smem_u32(smem_fwd) + 1023) & ~1023u;
  const uint32_t sKV = sQ + L::q;

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

  float o[EV / 64][32];
#pragma unroll
  for (int ob = 0; ob < EV / 64; ++ob)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[ob][i] = 0.f;
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

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

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    reg_fence(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < E / 16; ++kk)
      wgmma_ss(s, desc_k<BM>(sQ, kk), desc_k<BN>(sK, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    reg_fence(s);

    // online softmax in the log2 domain on the fragments (the running max
    // mx is of scale * log2(e) * S; the scale is positive, so the max of
    // the raw scores gives it)
    const bool edge = n0 + BN > lo;
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * h + c;
          if (edge && n0 + 8 * j + c0 + c >= lim[h]) s[i] = -INFINITY;
          tmax = fmaxf(tmax, s[i]);
        }
      const float mnew = fmaxf(mx[h], quad_max(tmax) * sl2);
      const float msafe = mnew == -INFINITY ? 0.f : mnew;
      corr[h] = fast_exp2(mx[h] - msafe);
      mx[h] = mnew;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * h + c;
          s[i] = fast_exp2(fmaf(s[i], sl2, -msafe));
          psum += s[i];
        }
      l[h] = l[h] * corr[h] + psum;  // this thread's share; the quad sums last
    }
    // rescale O only where a row's max moved (once the max settles, most
    // tiles leave every row's max in place)
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int ob = 0; ob < EV / 64; ++ob)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[ob][i] *= corr[(i >> 1) & 1];
    }

    uint32_t a[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) to_a(s, kk, a[kk]);
#pragma unroll
    for (int ob = 0; ob < EV / 64; ++ob) reg_fence(o[ob]);
    reg_fence(a);
    wg_fence();
#pragma unroll
    for (int ob = 0; ob < EV / 64; ++ob)
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(o[ob], a[kk], desc_mn<BN>(sV + ob * BN * 128, kk));
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int ob = 0; ob < EV / 64; ++ob) reg_fence(o[ob]);
    __syncthreads();  // this stage's K/V reads are done before its refill
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lsum = quad_sum(l[h]);
    const int m = m0 + r0 + 8 * h;
    if (m >= M) continue;
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    bf16* orow = out + rows.row(m) * EVR;
#pragma unroll
    for (int ob = 0; ob < EV / 64; ++ob)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (ob * 64 + 8 * j >= EVR) continue;  // pad columns: not stored
        *reinterpret_cast<__nv_bfloat162*>(orow + ob * 64 + 8 * j + c0) =
            __floats2bfloat162_rn(o[ob][4 * j + 2 * h] * inv,
                                  o[ob][4 * j + 2 * h + 1] * inv);
      }
    if ((lane & 3) == 0)
      lse[rows.stat(m)] =
          lsum > 0.f ? (mx[h] + log2f(lsum)) * LN2 : -INFINITY;
  }
}

template <int E, int EV>
int run_tc(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int sq, int H, int G, int S, int causal,
           int q_offset, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_tc<E, EV>;
  constexpr size_t smem = FwdSmem<mma::pad64(E), mma::pad64(EV)>::bytes;
  cudaError_t err = mma::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = H / G * sq;
  dim3 grid(b * G, (rows + BM - 1) / BM);
  kern<<<grid, mma::WG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, sq, H, G,
      S, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

using attn::THREADS;

template <int E, int EV, int BMC>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int sq, int H, int G, int S,
                     int causal, int q_offset, float scale) {
  const attn::ContigKV<float, E, EV> kv{k, v, S, G};
  // bidirectional rows are the window contract with the whole of K/V
  attn::attend<float, E, EV, BMC>(q, out, nullptr, nullptr, nullptr, lse,
                              causal ? q_offset : S, sq, H, G, !causal,
                              scale, kv);
}

template <int E, int EV, int BMC>
int run_cuda_core(const void* q, const void* k, const void* v, void* out,
                  float* lse, int b, int sq, int H, int G, int S, int causal,
                  int q_offset, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<E, EV, BMC>;
  constexpr size_t smem = attn::Smem<BMC, E, EV>::bytes;
  cudaError_t err = attn::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = H / G * sq;
  dim3 grid(b * G, (rows + BMC - 1) / BMC);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, sq, H, G, S,
      causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace {

template <int E>
int run(int dtype, const void* q, const void* k, const void* v, void* out,
        float* lse, int b, int sq, int H, int G, int S, int causal,
        int q_offset, float scale, cudaStream_t st) {
  if (dtype == 0)
    return run_cuda_core<E, E, 64>(q, k, v, out, lse, b, sq, H, G, S, causal,
                                   q_offset, scale, st);
  if (dtype == 1)
    return run_tc<E, E>(q, k, v, out, lse, b, sq, H, G, S, causal, q_offset,
                        scale, st);
  return -1;
}

}  // namespace

// dtype codes: 0 float32 (CUDA-core body), 1 bfloat16 (tensor-core body).
// Head dims E == EV in {64 (llama3.2-1b), 96 (gpt-1.5B: the 128-wide
// tensor-core body with zero pad columns), 128}. Returns 0, a
// cudaError_t, or -1 for a shape or dtype without an instantiation.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int b, int sq, int H, int G, int S, int E,
                                   int EV, int causal, int q_offset,
                                   float scale, void* stream) {
  if (b == 0 || sq == 0) return 0;
  if (E != EV) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (E) {
    case 64:
      return run<64>(dtype, q, k, v, out, lse, b, sq, H, G, S, causal,
                     q_offset, scale, st);
    case 96:
      return run<96>(dtype, q, k, v, out, lse, b, sq, H, G, S, causal,
                     q_offset, scale, st);
    case 128:
      return run<128>(dtype, q, k, v, out, lse, b, sq, H, G, S, causal,
                      q_offset, scale, st);
    default:
      return -1;
  }
}
