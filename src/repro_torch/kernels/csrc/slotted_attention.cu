// Slotted attention on Hopper: attention over a contiguous KV cache where
// every batch row (serving slot) sits at its own position.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:117
// flash_attention_slotted (body _slotted_kernel :63), and through it the
// decode_attention wrapper (:195).
//
// Contract: q [b, sq, H, E], k [b, S, G, E], v [b, S, G, EV] in float32 or
// bfloat16, pos int32 [b]. window == 0: row i of batch row b sees keys
// k <= pos[b] + i (causal); window == 1: every row sees k < pos[b] (the
// decode-attention contract, pos = cache length). out [b, sq, H, EV] in
// q's dtype; with m non-null also the float32 stats m, l [b, H, sq] and
// the unnormalised acc [b, H, sq, EV].
//
// Bound on the H100: bytes. At decode (sq = 1) every K/V byte up to the
// row's position is read once for 4*rep flops per byte pair (rep = 4 for
// llama3.2-1b), far below the card's ~295 flops per byte; a causal
// prefill chunk of 512 rows lifts that to ~hundreds and approaches the
// compute line. The design answers the bytes: one block serves all rep
// q heads of a kv head (each K/V tile leaves device memory once per
// block, not once per q head), and tiles past a block's causal limit are
// never read. Scores and products run on the CUDA cores in float32; a
// tensor-core (wgmma) path is later work.
#include "attention_tile.cuh"

namespace {

using attn::THREADS;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* out;
  float* m;
  float* l;
  float* acc;
  int b, sq, H, G, S, window;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int E, int EV, int BM>
__global__ void __launch_bounds__(THREADS)
    slotted_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                   const TKV* __restrict__ v, const int* __restrict__ pos,
                   TQ* __restrict__ out, float* __restrict__ m_out,
                   float* __restrict__ l_out, float* __restrict__ acc_out,
                   int sq, int H, int G, int S, int window, float scale) {
  const attn::ContigKV<TKV, E, EV> kv{k, v, S, G};
  attn::attend<TQ, E, EV, BM>(q, out, m_out, l_out, acc_out, nullptr,
                              pos[blockIdx.x / G], sq, H, G, window, scale,
                              kv);
}

template <typename TQ, typename TKV, int E, int EV, int BM>
int run(const Args& a) {
  auto kern = slotted_kernel<TQ, TKV, E, EV, BM>;
  constexpr size_t smem = attn::Smem<BM, E, EV>::bytes;
  cudaError_t err = attn::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = a.H / a.G * a.sq;
  dim3 grid(a.b * a.G, (rows + BM - 1) / BM);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.pos, static_cast<TQ*>(a.out), a.m, a.l,
      a.acc, a.sq, a.H, a.G, a.S, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// Head dims 64 (llama3.2-1b) and 128 (jamba-v0.1-52b); other widths come
// with their configs. At E = EV = 128 a BM-64 block takes 115,456 bytes of
// dynamic shared memory (allow_smem raises the cap) and 64 accumulator
// registers a thread.
template <typename TQ, typename TKV>
int by_shape(const Args& a, int E, int EV) {
  const bool small = attn::pick_bm(a.H / a.G * a.sq) == 16;
  if (E == 64 && EV == 64)
    return small ? run<TQ, TKV, 64, 64, 16>(a) : run<TQ, TKV, 64, 64, 64>(a);
  if (E == 128 && EV == 128)
    return small ? run<TQ, TKV, 128, 128, 16>(a)
                 : run<TQ, TKV, 128, 128, 64>(a);
  return -1;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (q and cache may differ: a session's
// kv_cache_dtype need not be its compute dtype). Returns 0, a cudaError_t,
// or -1 for a shape or dtype without an instantiation.
extern "C" int slotted_attention(int q_dtype, int kv_dtype, const void* q,
                                 const void* k, const void* v, const int* pos,
                                 void* out, float* m, float* l, float* acc,
                                 int b, int sq, int H, int G, int S, int E,
                                 int EV, int window, float scale,
                                 void* stream) {
  const Args a{q, k, v, pos, out, m, l, acc, b, sq, H, G, S, window, scale,
               static_cast<cudaStream_t>(stream)};
  if (b == 0 || sq == 0) return 0;
  if (q_dtype == 0 && kv_dtype == 0) return by_shape<float, float>(a, E, EV);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_shape<__nv_bfloat16, __nv_bfloat16>(a, E, EV);
  if (q_dtype == 1 && kv_dtype == 0)
    return by_shape<__nv_bfloat16, float>(a, E, EV);
  if (q_dtype == 0 && kv_dtype == 1)
    return by_shape<float, __nv_bfloat16>(a, E, EV);
  return -1;
}
