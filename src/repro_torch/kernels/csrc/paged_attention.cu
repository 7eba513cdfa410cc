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
// Bound on the H100: bytes, as for the slotted kernel: a decode step
// reads every live page once for a handful of flops per byte. Each block
// resolves its own page ids (the TPU kernel prefetched them as scalars
// ahead of the grid), loads whole pages of a 64-key tile in 16-byte
// vectors, and serves all q heads of one kv head from that tile; int8
// pools halve the bytes of a bf16 pool and are dequantised in shared
// memory, never in device memory.
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
  int b, sq, H, G, n_pages, ps, ppr;
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

template <typename TQ>
int by_pool(const Args& a, int kv_dtype, int E, int EV) {
  if (kv_dtype == 0) return by_shape<TQ, float>(a, E, EV);
  if (kv_dtype == 1) return by_shape<TQ, __nv_bfloat16>(a, E, EV);
  if (kv_dtype == 2) return by_shape<TQ, int8_t>(a, E, EV);
  return -1;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (pools only; needs scales).
// Returns 0, a cudaError_t, or -1 for a shape or dtype without an
// instantiation.
extern "C" int paged_attention(int q_dtype, int kv_dtype, const void* q,
                               const void* k_pool, const void* v_pool,
                               const float* k_scale, const float* v_scale,
                               const int* page_tables, const int* pos,
                               void* out, int b, int sq, int H, int G,
                               int n_pages, int ps, int ppr, int E, int EV,
                               float scale, void* stream) {
  const Args a{q,  k_pool, v_pool, k_scale, v_scale, page_tables,
               pos, out,   b,      sq,      H,       G,
               n_pages, ps, ppr,   scale,   static_cast<cudaStream_t>(stream)};
  if (b == 0 || sq == 0) return 0;
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)) return -1;
  if (q_dtype == 0) return by_pool<float>(a, kv_dtype, E, EV);
  if (q_dtype == 1) return by_pool<__nv_bfloat16>(a, kv_dtype, E, EV);
  return -1;
}
