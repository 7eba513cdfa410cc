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
// Bound on the H100: a causal prefill chunk of 512 rows at the serving
// shape (8 rows at positions 0..1536, 32 q heads over 8 kv heads, e = 64)
// does 2 * (e + ev) flops for each visible (query, key) pair, ~34 GFLOP
// against ~22 MB of q, out and K/V: operations, far above the card's ~295
// flops a byte. A decode step (sq = 1) reads every K/V byte up to the
// row's position once for 4 * rep flops a byte pair: bytes.
//
// bf16 q and cache, causal (the serving path): the tensor-core body
// (attention_tc.cuh, on mma_tile.cuh's tiles and wgmma). One warpgroup
// owns 64 query rows of one (batch row, kv head), Q resident in shared
// memory, K/V tiles of 64 keys in a two-stage cp.async ring, S = Q K^T
// and O += P V on the tensor cores with P rounded to bf16 in registers;
// tiles past a block's causal limit are never loaded. When the grid has
// under two blocks an SM (decode: b * G blocks), the wrapper splits the
// keys: each block takes a contiguous range of whole tiles and writes
// float32 (m, l, acc) to scratch, and combine_e* merges the splits in
// fixed order into the bf16 out. Instantiated for e = 64 (llama3.2-1b)
// and e = 128 (jamba-v0.1-52b).
//
// float32 or mixed dtypes, and the window + stats contract: the CUDA-core
// body (attention_tile.cuh attend), products in float32.
#include "attention_tc.cuh"
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
  float* part;
  int b, sq, H, G, S, window, ns;
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

// ---- bf16 tensor-core path ---------------------------------------------- //

using attn_tc::Contig;
using attn_tc::Params;
using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(mma::WG)
    slotted_tc_e64(const Params<Contig<64>> p) {
  attn_tc::attend<64>(p);
}
__global__ void __launch_bounds__(mma::WG)
    slotted_tc_e128(const Params<Contig<128>> p) {
  attn_tc::attend<128>(p);
}
__global__ void __launch_bounds__(32 * attn_tc::COMBINE_ROWS)
    combine_e64(const float* part, bf16* out, int ns, int R, int sq, int H) {
  attn_tc::combine<64>(part, out, ns, R, sq, H);
}
__global__ void __launch_bounds__(32 * attn_tc::COMBINE_ROWS)
    combine_e128(const float* part, bf16* out, int ns, int R, int sq,
                 int H) {
  attn_tc::combine<128>(part, out, ns, R, sq, H);
}

template <int E, typename Kern, typename Comb>
int run_tc(const Args& a, Kern kern, Comb comb) {
  const Params<Contig<E>> p{static_cast<const bf16*>(a.q),
                            static_cast<bf16*>(a.out),
                            a.part,
                            a.pos,
                            a.sq,
                            a.H,
                            a.ns,
                            a.b * a.H * a.sq,
                            a.scale,
                            {static_cast<const bf16*>(a.k),
                             static_cast<const bf16*>(a.v), a.S, a.G}};
  return attn_tc::launch<E>(kern, comb, p, a.b, a.stream);
}

int by_shape_tc(const Args& a, int E, int EV) {
  if (E == 64 && EV == 64) return run_tc<64>(a, slotted_tc_e64, combine_e64);
  if (E == 128 && EV == 128)
    return run_tc<128>(a, slotted_tc_e128, combine_e128);
  return -1;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (q and cache may differ: a session's
// kv_cache_dtype need not be its compute dtype). n_split key splits (bf16
// causal only; > 1 needs part, float32 [n_split * b * H * sq * (EV + 2)]).
// Returns 0, a cudaError_t, or -1 for a shape, dtype or split without an
// instantiation.
extern "C" int slotted_attention(int q_dtype, int kv_dtype, const void* q,
                                 const void* k, const void* v, const int* pos,
                                 void* out, float* m, float* l, float* acc,
                                 float* part, int b, int sq, int H, int G,
                                 int S, int E, int EV, int window,
                                 int n_split, float scale, void* stream) {
  const Args a{q, k,  v, pos, out, m,      l,       acc,   part,
               b, sq, H, G,   S,   window, n_split, scale,
               static_cast<cudaStream_t>(stream)};
  if (b == 0 || sq == 0) return 0;
  if (n_split < 1 || (n_split > 1 && part == nullptr)) return -1;
  if (q_dtype == 1 && kv_dtype == 1 && window == 0)
    return by_shape_tc(a, E, EV);
  if (n_split != 1) return -1;
  if (q_dtype == 0 && kv_dtype == 0) return by_shape<float, float>(a, E, EV);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_shape<__nv_bfloat16, __nv_bfloat16>(a, E, EV);
  if (q_dtype == 1 && kv_dtype == 0)
    return by_shape<__nv_bfloat16, float>(a, E, EV);
  if (q_dtype == 0 && kv_dtype == 1)
    return by_shape<float, __nv_bfloat16>(a, E, EV);
  return -1;
}
