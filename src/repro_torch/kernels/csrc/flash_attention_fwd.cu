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
// byte, far above the card's ~295. The design answers the bytes the way
// the serving kernels do (attention_tile.cuh: one block owns all rep q
// heads of a kv head, so each K/V tile is read once per block, and tiles
// past a block's causal limit are never loaded) and runs the products on
// the CUDA cores in float32; a tensor-core (wgmma) path is later work.
#include "attention_tile.cuh"

namespace {

using attn::THREADS;

template <typename T, int E, int EV, int BM>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int sq, int H, int G, int S,
                     int causal, int q_offset, float scale) {
  const attn::ContigKV<T, E, EV> kv{k, v, S, G};
  // bidirectional rows are the window contract with the whole of K/V
  attn::attend<T, E, EV, BM>(q, out, nullptr, nullptr, nullptr, lse,
                             causal ? q_offset : S, sq, H, G, !causal, scale,
                             kv);
}

template <typename T, int E, int EV, int BM>
int run(const void* q, const void* k, const void* v, void* out, float* lse,
        int b, int sq, int H, int G, int S, int causal, int q_offset,
        float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, E, EV, BM>;
  constexpr size_t smem = attn::Smem<BM, E, EV>::bytes;
  cudaError_t err = attn::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = H / G * sq;
  dim3 grid(b * G, (rows + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, H, G, S,
      causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16. Head dim 64 only (llama3.2-1b).
// Returns 0, a cudaError_t, or -1 for a shape or dtype without an
// instantiation.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int b, int sq, int H, int G, int S, int E,
                                   int EV, int causal, int q_offset,
                                   float scale, void* stream) {
  if (b == 0 || sq == 0) return 0;
  if (E != 64 || EV != 64) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float, 64, 64, 64>(q, k, v, out, lse, b, sq, H, G, S, causal,
                                  q_offset, scale, st);
  if (dtype == 1)
    return run<__nv_bfloat16, 64, 64, 64>(q, k, v, out, lse, b, sq, H, G, S,
                                          causal, q_offset, scale, st);
  return -1;
}
