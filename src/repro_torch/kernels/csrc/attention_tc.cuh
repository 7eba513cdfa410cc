// Tensor-core body of the slotted and paged serving attention kernels
// (sm_90a): bf16 q over a bf16 contiguous cache, a bf16 page pool, or an
// int8 page pool with float32 scales per page and kv head.
//
// * One warpgroup (128 threads) owns one (batch row b, kv head gi), 64
//   query rows m = i * rep + r of it (all rep q heads of the kv head, so
//   each K/V tile is read once for them: GQA) and a contiguous range of
//   whole 64-key tiles (a key split, below). Row i of batch row b sees
//   keys k <= pos[b] + i, clamped to the cache (mma::Rows with q_offset
//   pos[b]); a row that sees no key writes exact zeros.
// * Q stays in shared memory as a swizzled bf16 tile. K/V tiles stream
//   through a two-stage cp.async ring, the next tile in flight while the
//   current one is multiplied. Rows of a tile come from a row source:
//   contiguous [b, S, G, E], or the page pool through pt[b, n / ps] with
//   ids clipped to [0, n_pages - 1]. Keys at or past the block's last row
//   limit are never read (zero-filled), so tiles wholly past it are
//   never loaded.
// * S = Q K^T is a wgmma with both operands in shared memory; the online
//   softmax runs on the accumulator fragments in the log2 domain (one
//   ex2 an element, O rescaled only when a row's max moved); P is rounded
//   to bf16 in registers and is the register A operand of O += P V.
// * int8 pools: cp.async cannot scale, so the raw int8 tile lands in the
//   ring and each thread converts the chunks it copied itself to bf16 in
//   one register pass (exact: |v| <= 127 fits bf16's 8 significant
//   bits). K's scale (per key: its page's) multiplies S's columns before
//   the softmax; V's scale multiplies P's columns before P is rounded to
//   bf16, while l sums the unscaled P. That is the plain version's
//   value * scale product in another order, and the ring holds int8
//   bytes, half of bf16's.
// * Key splits: with ns > 1 (gridDim.z) block z takes the tiles
//   [z T / ns, (z + 1) T / ns) of the T tiles its rows see, and writes its
//   float32 (m in the log2 domain, l, unnormalised acc) to scratch; the
//   combine kernel merges the splits in fixed order and writes bf16 out.
//   A split that sees no key writes m = -inf, l = 0, acc = 0 and adds
//   nothing. Deterministic, no atomics.
#pragma once

#include "mma_tile.cuh"

namespace attn_tc {

using bf16 = __nv_bfloat16;
constexpr int BM = 64;  // query rows a block (one m64 wgmma tile)
constexpr int BN = 64;  // keys a tile

// ---- row sources -------------------------------------------------------- //

// Contiguous cache k, v [b, S, G, E] (bf16).
template <int E>
struct Contig {
  static constexpr bool paged = false, quant = false;
  const bf16* k;
  const bf16* v;
  int S, G;
  __device__ int keys() const { return S; }
  __device__ __forceinline__ int64_t row(int b, int gi, int n) const {
    return ((static_cast<int64_t>(b) * S + n) * G + gi) * E;
  }
};

// Page pools k, v [n_pages, ps, G, E] (bf16, or int8 with float32 scales
// ks, vs [n_pages, G]); logical key n of batch row b lives at page
// pt[b, n / ps] (clipped to [0, n_pages - 1]), offset n % ps.
template <int E, typename T>
struct Paged {
  static constexpr bool paged = true, quant = sizeof(T) == 1;
  const T* k;
  const T* v;
  const float* ks;
  const float* vs;
  const int* pt;  // [b, ppr]
  int ppr, ps, n_pages, G;
  __device__ int keys() const { return ppr * ps; }
  // the page of entry j (= n / ps) of row b's table
  __device__ __forceinline__ int page(int b, int j) const {
    const int p = __ldg(pt + static_cast<size_t>(b) * ppr + j);
    return p < 0 ? 0 : (p >= n_pages ? n_pages - 1 : p);
  }
};

template <int E, typename KV>
struct Layout {
  static constexpr int q = BM * E * 2;    // Q, bf16
  static constexpr int tile = BN * E * 2;  // one K or V tile, bf16
  // a ring stage: K then V tile in bf16 (landed in place), or raw int8 K
  // and V tiles and their keys' K and V scales
  static constexpr int raw = BN * E;
  static constexpr int stage = KV::quant ? 2 * raw + 2 * BN * 4 : 2 * tile;
  // int8: the current stage's tiles converted to bf16
  static constexpr int conv = KV::quant ? 2 * tile : 0;
  static constexpr size_t bytes = q + conv + 2 * stage + 1024;  // + align
};

// Arguments of a block: q [b, sq, H, E]; out [b, sq, H, E] (ns == 1) or
// part (ns > 1): m, l [ns, R] then acc [ns, R, E], R = b * H * sq rows.
template <typename KV>
struct Params {
  const bf16* q;
  bf16* out;
  float* part;
  const int* pos;
  int sq, H, ns, R;
  float scale;
  KV kv;
};

// ---- tile loads ---------------------------------------------------------- //

__device__ __forceinline__ uint4 ld_shared16(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ void st_shared16(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Fills swizzled bf16 K and V tiles (BN rows x E) from row offsets
// off(r) (elements; < 0 for a row read as zeros), shared by K and V.
// Thread t copies chunk t % C of rows t / C + j * STEP, as load_tile.
template <int E, typename Off>
__device__ __forceinline__ void load_kv16(uint32_t sK, uint32_t sV,
                                          const bf16* k, const bf16* v,
                                          Off off) {
  constexpr int C = E / 8, STEP = mma::WG / C;
  static_assert(BN % STEP == 0 && STEP % 8 == 0, "tile");
  const int t = threadIdx.x % mma::WG, r0 = t / C, c = t % C;
  const uint32_t d = mma::swz<BN>(r0, c);
#pragma unroll
  for (int j = 0; j < BN / STEP; ++j) {
    const int64_t e = off(r0 + j * STEP);
    const bool ok = e >= 0;
    const int64_t src = ok ? e + c * 8 : 0;
    mma::cp16(sK + d + j * STEP * 128, k + src, ok);
    mma::cp16(sV + d + j * STEP * 128, v + src, ok);
  }
}

// Raw int8 K and V tiles (BN rows x E bytes, row-major) at sK, sV.
// Thread t copies chunk t % C (16 values) of rows t / C + j * STEP; it
// converts the same chunks later (convert8), so no barrier sits between.
template <int E, typename Off>
__device__ __forceinline__ void load_kv8(uint32_t sK, uint32_t sV,
                                         const int8_t* k, const int8_t* v,
                                         Off off) {
  constexpr int C = E / 16, STEP = mma::WG / C;
  static_assert(BN % STEP == 0, "tile");
  const int t = threadIdx.x % mma::WG, r0 = t / C, c = t % C;
#pragma unroll
  for (int j = 0; j < BN / STEP; ++j) {
    const int r = r0 + j * STEP;
    const int64_t e = off(r);
    const bool ok = e >= 0;
    const int64_t src = ok ? e + c * 16 : 0;
    mma::cp16(sK + r * E + c * 16, k + src, ok);
    mma::cp16(sV + r * E + c * 16, v + src, ok);
  }
}

__device__ __forceinline__ uint2 i8x4_bf16(uint32_t w) {
  return make_uint2(
      mma::pack_bf16(static_cast<float>(static_cast<int8_t>(w)),
                     static_cast<float>(static_cast<int8_t>(w >> 8))),
      mma::pack_bf16(static_cast<float>(static_cast<int8_t>(w >> 16)),
                     static_cast<float>(static_cast<int8_t>(w >> 24))));
}

// The chunks this thread copied in load_kv8, converted to bf16 into the
// swizzled tile at dst (16 values: bf16 chunks 2c and 2c + 1 of the row).
template <int E>
__device__ __forceinline__ void convert8(uint32_t raw, uint32_t dst) {
  constexpr int C = E / 16, STEP = mma::WG / C;
  const int t = threadIdx.x % mma::WG, r0 = t / C, c = t % C;
#pragma unroll
  for (int j = 0; j < BN / STEP; ++j) {
    const int r = r0 + j * STEP;
    const uint4 w = ld_shared16(raw + r * E + c * 16);
    const uint2 a = i8x4_bf16(w.x), b = i8x4_bf16(w.y);
    const uint2 x = i8x4_bf16(w.z), y = i8x4_bf16(w.w);
    st_shared16(dst + mma::swz<BN>(r, 2 * c), make_uint4(a.x, a.y, b.x, b.y));
    st_shared16(dst + mma::swz<BN>(r, 2 * c + 1),
                make_uint4(x.x, x.y, y.x, y.y));
  }
}

// ---- the block body ------------------------------------------------------ //

template <int E, typename KV>
__device__ __forceinline__ void attend(const Params<KV>& p) {
  static_assert(E % 64 == 0, "head dim");
  using namespace mma;
  using L = Layout<E, KV>;
  extern __shared__ uint8_t smem_tc[];
  const uint32_t base = smem_u32(smem_tc);
  const uint32_t sQ = (base + 1023) & ~1023u;
  const uint8_t* gsmem = smem_tc + (sQ - base);  // generic view of sQ
  const uint32_t sConv = sQ + L::q;
  const uint32_t sRing = sConv + L::conv;
  const KV& kv = p.kv;

  const int G = kv.G;
  const int b = blockIdx.x / G, gi = blockIdx.x % G;
  const Rows rows(b, gi, p.sq, p.H, G, kv.keys(), /*causal=*/1, p.pos[b]);
  const int M = rows.M;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);

  const int lim[2] = {rows.limit(m0 + r0), rows.limit(m0 + r0 + 8)};
  const int lo = rows.min_limit<BM>(m0);
  const int kend = rows.limit(min(m0 + BM, M) - 1);  // keys the rows see
  const int n_tiles = (kend + BN - 1) / BN;
  const int split = blockIdx.z;
  const int t_lo = split * n_tiles / p.ns;
  const int t_hi = (split + 1) * n_tiles / p.ns;
  const float sl2 = p.scale * LOG2E;

  load_tile<BM, E>(sQ, p.q, [&](int r) -> const bf16* {
    return m0 + r < M ? p.q + rows.row(m0 + r) * E : nullptr;
  });

  FastDiv ps_div(1);
  if constexpr (KV::paged) ps_div = FastDiv(kv.ps);
  auto load_kv = [&](int t) {
    const uint32_t st = sRing + (t & 1) * L::stage;
    const int n0 = t * BN;
    if constexpr (!KV::paged) {
      load_kv16<E>(st, st + L::tile, kv.k, kv.v, [&](int r) -> int64_t {
        return n0 + r < kend ? kv.row(b, gi, n0 + r) : -1;
      });
    } else {
      auto off = [&](int r) -> int64_t {
        const int n = n0 + r;
        if (n >= kend) return -1;
        const int j = ps_div.div(n);
        return ((static_cast<int64_t>(kv.page(b, j)) * kv.ps + n -
                 j * kv.ps) * G + gi) * E;
      };
      if constexpr (KV::quant) {
        load_kv8<E>(st, st + L::raw, kv.k, kv.v, off);
        // the tile's K scales (threads 0..63) and V scales (64..127)
        const int t8 = threadIdx.x % WG, key = t8 % BN, n = n0 + key;
        const bool ok = n < kend;
        const float* src = t8 < BN ? kv.ks : kv.vs;
        cp4(st + 2 * L::raw + t8 * 4,
            ok ? src + kv.page(b, ps_div.div(n)) * G + gi : src, ok);
      } else {
        load_kv16<E>(st, st + L::tile, kv.k, kv.v, off);
      }
    }
  };
  if (t_lo < t_hi) load_kv(t_lo);
  cp_commit();

  float o[E / 64][32];
#pragma unroll
  for (int ob = 0; ob < E / 64; ++ob)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[ob][i] = 0.f;
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = t_lo; t < t_hi; ++t) {
    const int n0 = t * BN;
    if (t + 1 < t_hi) {
      load_kv(t + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    const uint32_t st = sRing + (t & 1) * L::stage;
    uint32_t sK = st, sV = st + L::tile;
    if constexpr (KV::quant) {
      sK = sConv;
      sV = sConv + L::tile;
      convert8<E>(st, sK);
      convert8<E>(st + L::raw, sV);
    }
    fence_async_smem();
    __syncthreads();

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

    // int8: the keys' scales on S's columns (before the mask: a masked
    // key's scale may be a zero fill); V's follow K's in the stage
    [[maybe_unused]] const float* ksc =
        reinterpret_cast<const float*>(gsmem + (st - sQ) + 2 * L::raw);
    if constexpr (KV::quant) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 f =
            *reinterpret_cast<const float2*>(ksc + 8 * j + c0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[4 * j + 2 * h] *= f.x;
          s[4 * j + 2 * h + 1] *= f.y;
        }
      }
    }

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
    // int8: V's scales on P's columns, after l took the unscaled P
    if constexpr (KV::quant) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 f =
            *reinterpret_cast<const float2*>(ksc + BN + 8 * j + c0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[4 * j + 2 * h] *= f.x;
          s[4 * j + 2 * h + 1] *= f.y;
        }
      }
    }
    // rescale O only where a row's max moved
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int ob = 0; ob < E / 64; ++ob)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[ob][i] *= corr[(i >> 1) & 1];
    }

    uint32_t a[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) to_a(s, kk, a[kk]);
#pragma unroll
    for (int ob = 0; ob < E / 64; ++ob) reg_fence(o[ob]);
    reg_fence(a);
    wg_fence();
#pragma unroll
    for (int ob = 0; ob < E / 64; ++ob)
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(o[ob], a[kk], desc_mn<BN>(sV + ob * BN * 128, kk));
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int ob = 0; ob < E / 64; ++ob) reg_fence(o[ob]);
    __syncthreads();  // this stage's reads are done before its refill
  }
  cp_wait<0>();  // Q alone was in flight when the range is empty

  float* pm = p.part;
  float* pl = p.part + static_cast<size_t>(p.ns) * p.R;
  float* pa = p.part + 2 * static_cast<size_t>(p.ns) * p.R;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lsum = quad_sum(l[h]);
    const int m = m0 + r0 + 8 * h;
    if (m >= M) continue;
    if (p.ns == 1) {
      const float inv = 1.f / fmaxf(lsum, 1e-30f);
      bf16* orow = p.out + rows.row(m) * E;
#pragma unroll
      for (int ob = 0; ob < E / 64; ++ob)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + ob * 64 + 8 * j + c0) =
              __floats2bfloat162_rn(o[ob][4 * j + 2 * h] * inv,
                                    o[ob][4 * j + 2 * h + 1] * inv);
    } else {
      const size_t r = static_cast<size_t>(split) * p.R + rows.stat(m);
      if ((lane & 3) == 0) {
        pm[r] = mx[h];
        pl[r] = lsum;
      }
      float* arow = pa + r * E;
#pragma unroll
      for (int ob = 0; ob < E / 64; ++ob)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(arow + ob * 64 + 8 * j + c0) =
              make_float2(o[ob][4 * j + 2 * h], o[ob][4 * j + 2 * h + 1]);
    }
  }
}

// Merges the ns key splits of part (m in the log2 domain, l, acc) in
// split order into out [b, sq, H, E] bf16; one warp a row of [b, H, sq].
template <int E>
__device__ __forceinline__ void combine(const float* __restrict__ part,
                                        bf16* __restrict__ out, int ns,
                                        int R, int sq, int H) {
  constexpr int V = E / 32;  // values a lane
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  const size_t nR = static_cast<size_t>(ns) * R;
  float mmax = -INFINITY;
  for (int z = 0; z < ns; ++z)
    mmax = fmaxf(mmax, part[z * static_cast<size_t>(R) + r]);
  const float msafe = mmax == -INFINITY ? 0.f : mmax;
  float lsum = 0.f, acc[V];
#pragma unroll
  for (int u = 0; u < V; ++u) acc[u] = 0.f;
  for (int z = 0; z < ns; ++z) {
    const size_t zr = z * static_cast<size_t>(R) + r;
    const float w = exp2f(part[zr] - msafe);  // 0 for an empty split
    lsum += part[nR + zr] * w;
    const float* a = part + 2 * nR + zr * E + lane * V;
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] += a[u] * w;
  }
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  const int i = r % sq, h = (r / sq) % H, b = r / (sq * H);
  bf16* o = out + ((static_cast<size_t>(b) * sq + i) * H + h) * E + lane * V;
#pragma unroll
  for (int u = 0; u < V; u += 2)
    *reinterpret_cast<__nv_bfloat162*>(o + u) =
        __floats2bfloat162_rn(acc[u] * inv, acc[u + 1] * inv);
}

constexpr int COMBINE_ROWS = 4;  // rows (warps) a combine block

// Launches the body kernel over (b * G, row tiles, ns) and, with ns > 1,
// the combine kernel. Returns 0 or a cudaError_t.
template <int E, typename KV>
inline int launch(void (*kern)(Params<KV>), void (*comb)(const float*, bf16*,
                                                          int, int, int, int),
                  const Params<KV>& p, int b, cudaStream_t stream) {
  constexpr size_t smem = Layout<E, KV>::bytes;
  cudaError_t err = mma::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = p.H / p.kv.G * p.sq;
  dim3 grid(b * p.kv.G, (rows + BM - 1) / BM, p.ns);
  kern<<<grid, mma::WG, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.ns == 1) return static_cast<int>(err);
  comb<<<(p.R + COMBINE_ROWS - 1) / COMBINE_ROWS, 32 * COMBINE_ROWS, 0,
         stream>>>(p.part, p.out, p.ns, p.R, p.sq, p.H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn_tc
