// Paged attention on Hopper: attention read straight from a KV page pool
// through per-row page tables, with optional int8 pages.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:265
// paged_attention (body _paged_kernel :215).
//
// Contract: q [b, sq, H, E] (float32 or bfloat16); pools k [n_pages, ps,
// G, E], v [n_pages, ps, G, EV] in float32, bfloat16 or int8 (then with
// float32 scales [n_pages, G] per page and kv head, dequantised in the
// kernel as value * scale); page_tables int32 [b, ppr], ids clipped to
// [0, n_pages-1]; pos int32 [b], the absolute position of each row's
// q[:, 0]. Row i of batch row b sees logical keys k <= pos[b] + i, so
// sentinel tail entries (which alias live pages) are masked by the causal
// test. The caller folds slot_mask into pos (masked rows get -sq): such a
// row sees no key and writes exact zeros. out [b, sq, H, EV] in q's dtype.
//
// Bound on the H100: as for the slotted kernel, operations for a 512-row
// causal prefill chunk (~31 GFLOP at the serving shape) and bytes for a
// decode step, which reads every live page once for a handful of flops a
// byte.
//
// bf16 q over bf16 or int8 pools (the serving path): the tensor-core body
// of the slotted kernel (attention_tc.cuh) with the page pool as its row
// source. Each block resolves its own page ids (the TPU kernel prefetched
// them as scalars ahead of the grid), one per key row of a tile, and
// cp.async copies the rows straight from their pages; K/V tiles of 64 keys
// in a two-stage ring, S and O += P V on the tensor cores, P rounded to
// bf16 in registers. int8 pages land raw in the ring (half of bf16's
// bytes), are converted to bf16 in one register pass (exact), and their
// scales are applied to S's columns (K) and P's columns (V), never in
// device memory. Small grids (decode) split the keys over blocks and
// combine_e64 merges the splits, as in the slotted kernel. Instantiated
// for e = 64 (llama3.2-1b).
//
// float32 q or pools, and bf16 q over float32 pools: the CUDA-core body
// (attention_tile.cuh attend), int8 dequantised in shared memory.
#include "attention_tc.cuh"
#include "attention_tile.cuh"

namespace {

using attn::THREADS;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* pt;
  const int* pos;
  void* out;
  float* part;
  int b, sq, H, G, n_pages, ps, ppr, ns;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int E, int EV, int BM>
__global__ void __launch_bounds__(THREADS)
    paged_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                 const TKV* __restrict__ v, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ pt,
                 const int* __restrict__ pos, TQ* __restrict__ out, int sq,
                 int H, int G, int n_pages, int ps, int ppr, float scale) {
  const attn::PagedKV<TKV, E, EV> kv{k, v, ks, vs, pt, ppr, ps, n_pages, G};
  attn::attend<TQ, E, EV, BM>(q, out, nullptr, nullptr, nullptr, nullptr,
                              pos[blockIdx.x / G], sq, H,
                              G, /*window=*/0, scale, kv);
}

template <typename TQ, typename TKV, int E, int EV, int BM>
int run(const Args& a) {
  auto kern = paged_kernel<TQ, TKV, E, EV, BM>;
  constexpr size_t smem = attn::Smem<BM, E, EV>::bytes;
  cudaError_t err = attn::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = a.H / a.G * a.sq;
  dim3 grid(a.b * a.G, (rows + BM - 1) / BM);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.ks, a.vs, a.pt, a.pos,
      static_cast<TQ*>(a.out), a.sq, a.H, a.G, a.n_pages, a.ps, a.ppr,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

// Head dim 64 only (llama3.2-1b); other widths come with their configs.
template <typename TQ, typename TKV>
int by_shape(const Args& a, int E, int EV) {
  const bool small = attn::pick_bm(a.H / a.G * a.sq) == 16;
  if (E == 64 && EV == 64)
    return small ? run<TQ, TKV, 64, 64, 16>(a) : run<TQ, TKV, 64, 64, 64>(a);
  return -1;
}

// float32 q over any pool
int by_pool(const Args& a, int kv_dtype, int E, int EV) {
  if (kv_dtype == 0) return by_shape<float, float>(a, E, EV);
  if (kv_dtype == 1) return by_shape<float, __nv_bfloat16>(a, E, EV);
  if (kv_dtype == 2) return by_shape<float, int8_t>(a, E, EV);
  return -1;
}

// ---- bf16 q: tensor-core path ------------------------------------------- //

using attn_tc::Paged;
using attn_tc::Params;
using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(mma::WG)
    paged_tc_bf16(const Params<Paged<64, bf16>> p) {
  attn_tc::attend<64>(p);
}
__global__ void __launch_bounds__(mma::WG)
    paged_tc_int8(const Params<Paged<64, int8_t>> p) {
  attn_tc::attend<64>(p);
}
__global__ void __launch_bounds__(32 * attn_tc::COMBINE_ROWS)
    combine_e64(const float* part, bf16* out, int ns, int R, int sq, int H) {
  attn_tc::combine<64>(part, out, ns, R, sq, H);
}

template <typename T, typename Kern>
int run_tc(const Args& a, Kern kern) {
  const Params<Paged<64, T>> p{
      static_cast<const bf16*>(a.q),
      static_cast<bf16*>(a.out),
      a.part,
      a.pos,
      a.sq,
      a.H,
      a.ns,
      a.b * a.H * a.sq,
      a.scale,
      {static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.ks, a.vs,
       a.pt, a.ppr, a.ps, a.n_pages, a.G}};
  return attn_tc::launch<64>(kern, combine_e64, p, a.b, a.stream);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (pools only; needs scales).
// n_split key splits (bf16 q over bf16 or int8 pools only; > 1 needs part,
// float32 [n_split * b * H * sq * (EV + 2)]). Returns 0, a cudaError_t, or
// -1 for a shape, dtype or split without an instantiation.
extern "C" int paged_attention(int q_dtype, int kv_dtype, const void* q,
                               const void* k_pool, const void* v_pool,
                               const float* k_scale, const float* v_scale,
                               const int* page_tables, const int* pos,
                               void* out, float* part, int b, int sq, int H,
                               int G, int n_pages, int ps, int ppr, int E,
                               int EV, int n_split, float scale,
                               void* stream) {
  const Args a{q,   k_pool, v_pool, k_scale, v_scale, page_tables,
               pos, out,    part,   b,       sq,      H,
               G,   n_pages, ps,    ppr,     n_split, scale,
               static_cast<cudaStream_t>(stream)};
  if (b == 0 || sq == 0) return 0;
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)) return -1;
  if (n_split < 1 || (n_split > 1 && part == nullptr)) return -1;
  if (q_dtype == 1 && (kv_dtype == 1 || kv_dtype == 2)) {
    if (E != 64 || EV != 64) return -1;
    return kv_dtype == 1 ? run_tc<bf16>(a, paged_tc_bf16)
                         : run_tc<int8_t>(a, paged_tc_int8);
  }
  if (n_split != 1) return -1;
  if (q_dtype == 0) return by_pool(a, kv_dtype, E, EV);
  if (q_dtype == 1 && kv_dtype == 0)
    return by_shape<__nv_bfloat16, float>(a, E, EV);
  return -1;
}
