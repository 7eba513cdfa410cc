// Selective scan backward (K5b): the gradient of the Mamba-1 diagonal SSM
// on Hopper.
//
// Replaces no Pallas kernel: the reference takes this gradient from
// jax.vjp over the jnp scan (repro/core/tape.py:148, over
// repro/kernels/ref.py:208 selective_scan) inside the Mamba block's prim.
// Its plain version is repro_torch/kernels/ref.py selective_scan_bwd.
//
//   forward:  h_t = a_t h_{t-1} + dt_t B_t x_t,  a_t = exp(dt_t A),
//             y_t = C_t . h_t + D x_t            (h_{-1} = 0)
//   backward: g_t = C_t dy_t + a_{t+1} g_{t+1}   (the state cotangent)
//             w_t = g_t a_t h_{t-1}
//             dx_t = D dy_t + dt_t sum_n g_t B_t
//             ddt_t = sum_n (w_t A + g_t B_t x_t)
//             dA = sum_{b,t} dt_t w_t,  dD = sum_{b,t} dy_t x_t
//             dB_t = sum_d g_t dt_t x_t,  dC_t = sum_d dy_t h_t
//
// Contract: x, dt, dy [b, s, d]; A [d, N]; B, C [b, s, N]; D [d]; all
// float32 and contiguous; outputs dx, ddt [b, s, d], dA [d, N], dB, dC
// [b, s, N], dD [d]; the workspace (selective_scan_bwd_workspace gives
// its size in floats) holds the chunks' states and carries and the
// partial sums.
//
// What bounds it on the H100. At the training shape (b 1, s 4096, d 8192,
// N 16) it must read x, dt, dy and write dx, ddt: 5 * 134 MB = 0.67 GB,
// 0.20 ms at 3.35 TB/s; and it needs exp(dt A) for every (b, t, d, n)
// once, 537 M MUFU.EX2 at 16 a clock per SM, 0.13 ms at 1980 MHz. Both
// recurrences are sequential in t, and a walk of the whole sequence gives
// only b * d * N / 4 threads of work (128 blocks at b 1: under one wave,
// bound by the latency of each step). The recurrences are linear, so
// this design cuts the sequence into chunks of CK steps that run in
// parallel (32 chunks x 128 channel blocks at the training shape, ~15
// waves of two blocks an SM), and carries between chunks in a short
// sequential pass. It reads x, dt, dy twice (1.2 GB in all) and takes
// four exponentials an update (the chunk walk, the chunk's
// sub-checkpoints, a tile's states, the reverse step): a MUFU floor of
// ~0.51 ms, below what bounds it on the card, the reverse walk's
// instructions (~160 a step of a warp, 40% of them the sums over a
// channel's lanes and a warp's channels) at 16 warps an SM. Keeping
// the tile's a_t in registers for the reverse step would save the
// fourth, but it spills at the 128-register cap of two blocks an SM and
// measured slower (PERF.md). Float32 throughout, no tensor cores, no
// TMA.
//
// Design, four launches on the caller's stream. For chunk k (steps t0 to
// t1 - 1), with pi_t = a_t0 ... a_t (the decay from the chunk's start):
// 1. chunk_kernel: a block a (channel block, chunk, batch row) walks its
//    chunk forward from a zero state (its steps staged in shared memory
//    through a cp.async ring) and writes, per (d, n), the local end
//    state hl_k, the decay P_k = pi_{t1-1} and the cotangent the chunk
//    sends into the chunk before it when its own carry is zero,
//    gh_k = sum_t pi_t C_t dy_t (= a_t0 g_t0). One exponential an update.
// 2. carry_kernel: a thread a (b, d, n) walks the chunks: the entry
//    states H_0 = 0, H_{k+1} = P_k H_k + hl_k forward, and the carries
//    c_{K-1} = 0, c_{k-1} = gh_k + P_k c_k backward (c_k = a_t1 g_t1,
//    what chunk k + 1 adds to chunk k's last cotangent). 32 steps at
//    s 4096, their loads issued eight chunks at a time.
// 3. bwd_kernel: a block a (channel block, chunk, batch row) holds CH
//    channels, the N states of a channel split over L = N / 4 lanes of a
//    warp (4 states a lane). It walks its chunk forward from H_k, keeping
//    the state at every T steps in shared memory; then, tile by tile from
//    the last, it recomputes the tile's T + 1 states into registers and
//    walks them back from the carry c_k. Each tile's x, dt,
//    (dy,) B and C reach shared memory by cp.async through a ring of two
//    slots: the next tile's copies are in flight while this one is
//    walked, a barrier a tile (two walking back). dx and ddt sum over a
//    channel's lanes two steps at a time (a reduce-scatter of the pair's
//    four sums: one store a lane) and go straight out; dA and dD
//    accumulate in registers (one partial a chunk and batch row). dB and
//    dC sum over channels: within a warp by a reduce-scatter of shuffles
//    (the warp's channels halve the values a level, then plain xor sums),
//    across the block's warps in shared memory, and across blocks as
//    per-block partials in the workspace.
// 4. reduce_kernel: the per-block partials of dB, dC and the per-chunk
//    partials of dA, dD summed in a fixed order. No float atomics, so two
//    runs give the same bits.
//
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;  // threads a block: THREADS / L channels
constexpr int MIN_BLOCKS = 2; // reverse-walk blocks an SM: <= 128 registers
constexpr int WARPS = THREADS / 32;
constexpr int P = 4;          // states a lane
constexpr int T = 8;          // steps a register tile
constexpr int CK = 128;       // steps a chunk
constexpr int SUB = CK / T;   // sub-checkpoints a chunk (shared memory)
static_assert(T % 2 == 0 && CK % T == 0, "steps are walked back in pairs");
constexpr int CT = 16;        // steps a staged tile of the chunk walk
constexpr int CSTAGES = 3;    // tiles of the chunk walk's cp.async ring
constexpr int CB = 8;         // chunks a batch of the carry pass's loads
constexpr int KERNELS = 4;    // launches a call
constexpr float LOG2E = 1.4426950408889634f;

template <int N>
__host__ __device__ constexpr int lanes() {
  return N / P;
}
template <int N>
__host__ __device__ constexpr int channels() {
  return THREADS / lanes<N>();
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void unpack(const float4 q, float* v) {
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 4 bytes from src into shared memory, or a zero when !valid (src is then
// not read)
__device__ __forceinline__ void cp4(uint32_t dst, const float* src,
                                    bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// Shared memory of bwd_kernel: sub-checkpoints [SUB][P][THREADS] (a
// thread's own, conflict-free), the warps' dB / dC sums of a tile
// [T][WARPS][2 N], then two staged tiles (a ring: the next tile's copies
// run while this one is walked), each x, dt, dy [T][CH], B, C [T][N].
template <int N>
struct Smem {
  static constexpr int SUBF = SUB * P * THREADS;
  static constexpr int RED = T * WARPS * 2 * N;
  static constexpr int XT = T * channels<N>(), BT = T * N;
  static constexpr int STG = 3 * XT + 2 * BT;
  static constexpr size_t bytes = sizeof(float) * (SUBF + RED + 2 * STG);
};

// [b][nck][d][N] index of chunk k's entry for channel c, states n0..n0+3
__device__ __forceinline__ size_t chunk_at(int b, int k, int c, int n0,
                                           int nck, int d, int N) {
  return ((static_cast<size_t>(b) * nck + k) * d + c) * N + n0;
}

// Shared memory of chunk_kernel: a ring of CSTAGES tiles of CT steps, each
// x, dt, dy [CT][CH], B, C [CT][N].
template <int N>
struct ChunkSmem {
  static constexpr int XT = CT * channels<N>(), BT = CT * N;
  static constexpr int STG = 3 * XT + 2 * BT;
  static constexpr size_t bytes = sizeof(float) * CSTAGES * STG;
};

// 1. Each chunk from a zero state: hl (local end state), pd (decay), gh
// (the cotangent sent back), each [b][nck][d][N]. The chunk's steps reach
// shared memory through a cp.async ring, CSTAGES - 1 tiles ahead of the
// walk.
template <int N>
__global__ void __launch_bounds__(THREADS)
    chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ dy,
                 float* __restrict__ hl, float* __restrict__ pd,
                 float* __restrict__ gh, int s, int d, int nck) {
  constexpr int L = lanes<N>(), CH = channels<N>();
  using S = ChunkSmem<N>;
  extern __shared__ float4 smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int ch = tid / L, c0 = blockIdx.x * CH, c = c0 + ch;
  const int n0 = (tid % L) * P;
  const bool live = c < d;
  float a2[P], h[P], pi[P], g[P];
  unpack(ld4(A + static_cast<size_t>(live ? c : 0) * N + n0), a2);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    a2[p] = __fmul_rn(a2[p], LOG2E);
    h[p] = 0.f, pi[p] = 1.f, g[p] = 0.f;
  }
  const size_t row0 = static_cast<size_t>(b) * s;
  const int t0 = k * CK, t1 = min(s, t0 + CK);
  const int ntile = (t1 - t0 + CT - 1) / CT;
  // tile q's steps into ring slot q % CSTAGES, zeros past s and d; every
  // thread commits one group a call, a tile or none
  auto issue = [&](int q) {
    if (q < ntile) {
      const int ta = t0 + q * CT, nt = min(CT, t1 - ta);
      float* base = ring + (q % CSTAGES) * S::STG;
      for (int e = tid; e < S::XT; e += THREADS) {
        const int r = e / CH, cl = e % CH;
        const bool ok = r < nt && c0 + cl < d;
        const size_t gi = ok ? (row0 + ta + r) * d + c0 + cl : 0;
        cp4(smem_u32(base + e), x + gi, ok);
        cp4(smem_u32(base + S::XT + e), dt + gi, ok);
        cp4(smem_u32(base + 2 * S::XT + e), dy + gi, ok);
      }
      for (int e = tid; e < S::BT; e += THREADS) {
        const bool ok = e / N < nt;
        const size_t gi = ok ? (row0 + ta) * N + e : 0;
        cp4(smem_u32(base + 3 * S::XT + e), Bm + gi, ok);
        cp4(smem_u32(base + 3 * S::XT + S::BT + e), Cm + gi, ok);
      }
    }
    cp_commit();
  };
  for (int q = 0; q < CSTAGES - 1; ++q) issue(q);
  for (int q = 0; q < ntile; ++q) {
    issue(q + CSTAGES - 1);
    cp_wait<CSTAGES - 1>();  // tile q has landed (this thread's copies)
    __syncthreads();         // and every thread's
    const float* tx = ring + (q % CSTAGES) * S::STG;
    const float* tdt = tx + S::XT;
    const float* tdy = tdt + S::XT;
    const float* tb = tdy + S::XT;
    const float* tc = tb + S::BT;
    const int nt = min(CT, t1 - t0 - q * CT);
#pragma unroll 4
    for (int r = 0; r < nt; ++r) {
      const float xv = tx[r * CH + ch], dv = tdt[r * CH + ch];
      const float dyv = tdy[r * CH + ch];
      float bv[P], cv[P];
      unpack(*reinterpret_cast<const float4*>(tb + r * N + n0), bv);
      unpack(*reinterpret_cast<const float4*>(tc + r * N + n0), cv);
      const float dx = __fmul_rn(dv, xv);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float a = ex2(__fmul_rn(dv, a2[p]));
        h[p] = __fmaf_rn(a, h[p], __fmul_rn(dx, bv[p]));
        pi[p] = __fmul_rn(pi[p], a);
        g[p] = __fmaf_rn(pi[p], __fmul_rn(cv[p], dyv), g[p]);
      }
    }
    __syncthreads();  // slot q % CSTAGES is free for tile q + CSTAGES
  }
  if (!live) return;
  const size_t o = chunk_at(b, k, c, n0, nck, d, N);
  st4(hl + o, h);
  st4(pd + o, pi);
  st4(gh + o, g);
}

// 2. Across the chunks, one thread a (b, d, n): the entry states ent and
// the carries car from hl, pd and gh, CB chunks' loads at a time (each
// step's loads do not wait on the last step's sum).
__global__ void carry_kernel(const float* __restrict__ hl,
                             const float* __restrict__ pd,
                             const float* __restrict__ gh,
                             float* __restrict__ ent,
                             float* __restrict__ car, int bsz, int nck,
                             size_t dn) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
  if (e >= bsz * dn) return;
  const size_t at = (e / dn) * nck * dn + e % dn;  // chunk 0 of row e / dn
  float H = 0.f, G = 0.f;
  for (int k0 = 0; k0 < nck; k0 += CB) {
    float lv[CB], pv[CB];
#pragma unroll
    for (int u = 0; u < CB; ++u) {
      const bool ok = k0 + u < nck;
      lv[u] = ok ? hl[at + (k0 + u) * dn] : 0.f;
      pv[u] = ok ? pd[at + (k0 + u) * dn] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < CB; ++u) {
      if (k0 + u < nck) {
        ent[at + (k0 + u) * dn] = H;
        H = __fmaf_rn(pv[u], H, lv[u]);
      }
    }
  }
  for (int k1 = nck; k1 > 0; k1 -= CB) {  // chunks k1 - 1 down to k1 - CB
    float lv[CB], pv[CB];
#pragma unroll
    for (int u = 0; u < CB; ++u) {
      const int k = k1 - 1 - u;
      lv[u] = k >= 0 ? gh[at + k * dn] : 0.f;
      pv[u] = k >= 0 ? pd[at + k * dn] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < CB; ++u) {
      const int k = k1 - 1 - u;
      if (k >= 0) {
        car[at + k * dn] = G;
        G = __fmaf_rn(pv[u], G, lv[u]);
      }
    }
  }
}

// 3. The reverse walk of each chunk from its entry state and carry. part
// [nblk][b s][2 N] (dB then dC, per channel block); dApart [b nck][d][N],
// dDpart [b nck][d] (per chunk and batch row).
template <int N>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ D,
               const float* __restrict__ dy, const float* __restrict__ ent,
               const float* __restrict__ car, float* __restrict__ dxo,
               float* __restrict__ ddto, float* __restrict__ part,
               float* __restrict__ dApart, float* __restrict__ dDpart,
               int bsz, int s, int d, int nck) {
  constexpr int L = lanes<N>(), CH = channels<N>();
  static_assert(P == 4 && (L & (L - 1)) == 0 && L >= 1 && L <= 8, "split");
  using S = Smem<N>;
  extern __shared__ float4 smem_raw[];
  float* sub = reinterpret_cast<float*>(smem_raw);
  float* red = sub + S::SUBF;
  float* stg = red + S::RED;  // the two staged tiles

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int k = blockIdx.y, b = blockIdx.z, j = tid % L, n0 = j * P;
  const int ch = tid / L, c0 = blockIdx.x * CH, c = c0 + ch;
  const bool live = c < d;
  const int cc = live ? c : 0;  // a channel to address; dead lanes read 0
  const size_t row0 = static_cast<size_t>(b) * s;
  const size_t nrows = static_cast<size_t>(bsz) * s;
  const int t0 = k * CK, t1 = min(s, t0 + CK);
  const int nsub = (t1 - t0 + T - 1) / T;

  float a2[P], Af[P], G[P], dA[P], h[P];
  unpack(ld4(A + static_cast<size_t>(cc) * N + n0), Af);
  const size_t at = chunk_at(b, k, cc, n0, nck, d, N);
  unpack(*reinterpret_cast<const float4*>(ent + at), h);
  unpack(*reinterpret_cast<const float4*>(car + at), G);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    Af[p] = live ? Af[p] : 0.f;
    a2[p] = __fmul_rn(Af[p], LOG2E);
    h[p] = live ? h[p] : 0.f;
    G[p] = live ? G[p] : 0.f;
    dA[p] = 0.f;
  }
  const float Dd = live ? __ldg(D + cc) : 0.f;
  float dD = 0.f;

  // The block walks nsub - 1 tiles forward (the sub-checkpoints), then
  // all nsub tiles back, last first: tile number i of that sequence is
  // chunk tile q, walked back when rev.
  const int nseq = 2 * nsub - 1;
  auto tile_of = [&](int i, int& q, bool& rev) {
    rev = i >= nsub - 1;
    q = rev ? 2 * nsub - 2 - i : i;
  };
  // tile i's steps of the block's channels into ring slot i % 2 by
  // cp.async, zeros past s and d; a reverse tile also takes dy and C
  auto issue = [&](int i) {
    int q;
    bool rev;
    tile_of(i, q, rev);
    const int ta = t0 + q * T, nt = min(T, t1 - ta);
    float* base = stg + (i % 2) * S::STG;
    for (int e = tid; e < S::XT; e += THREADS) {
      const int r = e / CH, cl = e % CH;
      const bool ok = r < nt && c0 + cl < d;
      const size_t g = ok ? (row0 + ta + r) * d + c0 + cl : 0;
      cp4(smem_u32(base + e), x + g, ok);
      cp4(smem_u32(base + S::XT + e), dt + g, ok);
      if (rev) cp4(smem_u32(base + 2 * S::XT + e), dy + g, ok);
    }
    for (int e = tid; e < S::BT; e += THREADS) {
      const bool ok = e / N < nt;
      const size_t g = ok ? (row0 + ta) * N + e : 0;
      cp4(smem_u32(base + 3 * S::XT + e), Bm + g, ok);
      if (rev) cp4(smem_u32(base + 3 * S::XT + S::BT + e), Cm + g, ok);
    }
    cp_commit();
  };
  // one step: out = a h + dt x B
  auto advance = [&](const float* hp, float xv, float dv, const float* bv,
                     float* out) {
    const float dx = __fmul_rn(dv, xv);
#pragma unroll
    for (int p = 0; p < P; ++p)
      out[p] = __fmaf_rn(ex2(__fmul_rn(dv, a2[p])), hp[p],
                         __fmul_rn(dx, bv[p]));
  };
  // lane-bit masks: the first two channel bits halve the dB / dC values,
  // the rest sum whole
  constexpr int O1 = L, O2 = 2 * L;
  const bool hi1 = lane & O1, hi2 = lane & O2;
  constexpr int FULL = 31 & ~(4 * L - 1);  // lane bits of whole sums
  const bool writer = (lane & FULL) == 0;
  const int n_red = n0 + 2 * hi1 + hi2;  // the state a writer lane holds

  issue(0);
  for (int i = 0; i < nseq; ++i) {
    // tile i has landed, and every thread is done with ring slot (i + 1)
    // % 2 and with red: the next tile's copies go out behind this walk
    cp_wait<0>();
    __syncthreads();
    if (i + 1 < nseq) issue(i + 1);
    int q;
    bool rev;
    tile_of(i, q, rev);
    const int ta = t0 + q * T, nt = min(T, t1 - ta);
    const float* tx = stg + (i % 2) * S::STG;
    const float* tdt = tx + S::XT;
    const float* tdy = tdt + S::XT;
    const float* tb = tdy + S::XT;
    const float* tc = tb + S::BT;
    // the inputs of tile step r of this thread's channel (zeros on a
    // dead lane: its channel was staged as zeros)
    auto load = [&](int r, float& xv, float& dv, float* bv) {
      xv = tx[r * CH + ch];
      dv = tdt[r * CH + ch];
      unpack(*reinterpret_cast<const float4*>(tb + r * N + n0), bv);
    };
    if (!rev) {  // the state before tile q, then walk the tile
#pragma unroll
      for (int p = 0; p < P; ++p) sub[(q * P + p) * THREADS + tid] = h[p];
#pragma unroll
      for (int r = 0; r < T; ++r) {
        float xv, dv, bv[P];
        load(r, xv, dv, bv);
        advance(h, xv, dv, bv, h);
      }
      continue;
    }
    // steps r + 1 (when `upper`, else zeros) and r: dx and ddt from the
    // lanes' partial sums s1, s2, one store a lane (L 4), two (L 2) or
    // four (L 1)
    auto sum_pair = [&](int r, bool upper, const float* s1,
                        const float* s2) {
      const size_t rows[2] = {row0 + ta + r + 1, row0 + ta + r};
      if constexpr (L == 4) {
        const bool b0 = j & 1, b1 = j & 2;
        float k0 = b0 ? s2[r + 1] : s1[r + 1], k1 = b0 ? s2[r] : s1[r];
        const float o0 = b0 ? s1[r + 1] : s2[r + 1], o1 = b0 ? s1[r] : s2[r];
        k0 = __fadd_rn(k0, __shfl_xor_sync(0xffffffffu, o0, 1));
        k1 = __fadd_rn(k1, __shfl_xor_sync(0xffffffffu, o1, 1));
        float kk = b1 ? k1 : k0;
        kk = __fadd_rn(kk, __shfl_xor_sync(0xffffffffu, b1 ? k0 : k1, 2));
        if (live && (b1 || upper))
          (b0 ? ddto : dxo)[rows[b1] * d + c] = kk;
      } else if constexpr (L == 2) {
        const bool b0 = j & 1;
        float k0 = b0 ? s2[r + 1] : s1[r + 1], k1 = b0 ? s2[r] : s1[r];
        const float o0 = b0 ? s1[r + 1] : s2[r + 1], o1 = b0 ? s1[r] : s2[r];
        k0 = __fadd_rn(k0, __shfl_xor_sync(0xffffffffu, o0, 1));
        k1 = __fadd_rn(k1, __shfl_xor_sync(0xffffffffu, o1, 1));
        float* out = b0 ? ddto : dxo;
        if (live && upper) out[rows[0] * d + c] = k0;
        if (live) out[rows[1] * d + c] = k1;
      } else {
        if (live && upper) {
          dxo[rows[0] * d + c] = s1[r + 1];
          ddto[rows[0] * d + c] = s2[r + 1];
        }
        if (live) {
          dxo[rows[1] * d + c] = s1[r];
          ddto[rows[1] * d + c] = s2[r];
        }
      }
    };
    // the tile's states and decays, then its steps back; a full tile
    // (all but a chunk's last) without the step guards
    auto walk_back = [&](auto full) {
      constexpr bool F = decltype(full)::value;
      float hist[T + 1][P];
#pragma unroll
      for (int p = 0; p < P; ++p)
        hist[0][p] = q == nsub - 1 ? h[p] : sub[(q * P + p) * THREADS + tid];
#pragma unroll
      for (int r = 0; r < T; ++r) {
        if (F || r < nt) {
          float xv, dv, bv[P];
          load(r, xv, dv, bv);
          advance(hist[r], xv, dv, bv, hist[r + 1]);
        }
      }
      // a step's partial sums over this lane's states of dx (D dy on a
      // channel's first lane) and ddt, summed over the channel's lanes a
      // pair of steps at a time: a reduce-scatter leaves each lane one
      // of the pair's four sums to store
      float s1[T], s2[T];
#pragma unroll
      for (int r = 0; r < T; ++r) s1[r] = s2[r] = 0.f;
#pragma unroll
      for (int r = T - 1; r >= 0; --r) {
        if (F || r < nt) {
          float xv, dv, bv[P], cv[P];
          load(r, xv, dv, bv);
          unpack(*reinterpret_cast<const float4*>(tc + r * N + n0), cv);
          const float dyv = tdy[r * CH + ch];
          float sgB = 0.f, swA = 0.f, vB[P], vC[P];
          const float dvx = __fmul_rn(dv, xv);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float a = ex2(__fmul_rn(dv, a2[p]));
            const float g = __fmaf_rn(cv[p], dyv, G[p]);
            const float w = __fmul_rn(__fmul_rn(g, a), hist[r][p]);
            sgB = __fmaf_rn(g, bv[p], sgB);
            swA = __fmaf_rn(w, Af[p], swA);
            dA[p] = __fmaf_rn(dv, w, dA[p]);
            vB[p] = __fmul_rn(g, dvx);
            vC[p] = __fmul_rn(dyv, hist[r + 1][p]);
            G[p] = __fmul_rn(a, g);
          }
          s1[r] = __fmaf_rn(dv, sgB, j == 0 ? __fmul_rn(Dd, dyv) : 0.f);
          s2[r] = __fmaf_rn(xv, sgB, swA);
          if (r % 2 == 0) sum_pair(r, F || r + 1 < nt, s1, s2);
          dD = __fmaf_rn(dyv, xv, dD);
          // the warp's channels: 4 values -> 2 (bit O1) -> 1 (bit O2),
          // then whole sums over the remaining channel bits
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sb = hi1 ? vB[e] : vB[e + 2];
            const float sc = hi1 ? vC[e] : vC[e + 2];
            const float rb = __shfl_xor_sync(0xffffffffu, sb, O1);
            const float rc = __shfl_xor_sync(0xffffffffu, sc, O1);
            vB[e] = __fadd_rn(hi1 ? vB[e + 2] : vB[e], rb);
            vC[e] = __fadd_rn(hi1 ? vC[e + 2] : vC[e], rc);
          }
          {
            const float sb = hi2 ? vB[0] : vB[1];
            const float sc = hi2 ? vC[0] : vC[1];
            const float rb = __shfl_xor_sync(0xffffffffu, sb, O2);
            const float rc = __shfl_xor_sync(0xffffffffu, sc, O2);
            vB[0] = __fadd_rn(hi2 ? vB[1] : vB[0], rb);
            vC[0] = __fadd_rn(hi2 ? vC[1] : vC[0], rc);
          }
#pragma unroll
          for (int o = 4 * L; o < 32; o *= 2) {
            vB[0] = __fadd_rn(vB[0], __shfl_xor_sync(0xffffffffu, vB[0], o));
            vC[0] = __fadd_rn(vC[0], __shfl_xor_sync(0xffffffffu, vC[0], o));
          }
          if (writer) {
            float* rw = red + (r * WARPS + warp) * 2 * N;
            rw[n_red] = vB[0];
            rw[N + n_red] = vC[0];
          }
        }
      }
    };
    if (nt == T)
      walk_back(std::true_type{});
    else
      walk_back(std::false_type{});
    __syncthreads();  // every warp's sums of the tile are in red
    for (int e = tid; e < nt * 2 * N; e += THREADS) {
      const int r = e / (2 * N), m = e % (2 * N);
      const float* rr = red + r * WARPS * 2 * N + m;
      float acc = rr[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) acc = __fadd_rn(acc, rr[w * 2 * N]);
      part[(blockIdx.x * nrows + row0 + ta + r) * 2 * N + m] = acc;
    }
    // the next tile's barrier frees red and this ring slot
  }
  if (live) {
    const size_t pk = static_cast<size_t>(b) * nck + k;
    st4(dApart + (pk * d + c) * N + n0, dA);
    if (j == 0) dDpart[pk * d + c] = dD;
  }
}

// 4. Fixed-order sums: dB, dC over the nblk channel blocks; dA, dD over
// the npart = b * nck chunks.
template <int N>
__global__ void reduce_kernel(const float* __restrict__ part,
                              const float* __restrict__ dApart,
                              const float* __restrict__ dDpart,
                              float* __restrict__ dB, float* __restrict__ dC,
                              float* __restrict__ dA, float* __restrict__ dD,
                              int bsz, int s, int d, int nblk, int npart) {
  const size_t nrows = static_cast<size_t>(bsz) * s;
  const size_t n_bc = nrows * 2 * N, n_a = static_cast<size_t>(d) * N;
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < n_bc) {
    float acc = part[e];
    for (int k = 1; k < nblk; ++k) acc = __fadd_rn(acc, part[k * n_bc + e]);
    const size_t row = e / (2 * N);
    const int m = static_cast<int>(e % (2 * N));
    if (m < N)
      dB[row * N + m] = acc;
    else
      dC[row * N + m - N] = acc;
  } else if (e < n_bc + n_a) {
    const size_t i = e - n_bc;
    float acc = dApart[i];
    for (int k = 1; k < npart; ++k) acc = __fadd_rn(acc, dApart[k * n_a + i]);
    dA[i] = acc;
  } else if (e < n_bc + n_a + d) {
    const size_t i = e - n_bc - n_a;
    float acc = dDpart[i];
    for (int k = 1; k < npart; ++k)
      acc = __fadd_rn(acc, dDpart[static_cast<size_t>(k) * d + i]);
    dD[i] = acc;
  }
}

struct Work {
  size_t chunk, part, dA, dD;  // floats of each workspace part
};
template <int N>
Work workspace(int b, int s, int d) {
  const size_t nck = (s + CK - 1) / CK;
  const size_t nblk = (d + channels<N>() - 1) / channels<N>();
  const size_t per = static_cast<size_t>(b) * nck * d;  // chunk partials
  return {5 * per * N, nblk * b * static_cast<size_t>(s) * 2 * N, per * N,
          per};
}

template <int N>
int run(const float* x, const float* dt, const float* A, const float* B,
        const float* C, const float* D, const float* dy, float* dx,
        float* ddt, float* dA, float* dB, float* dC, float* dD, float* ws,
        int b, int s, int d, cudaStream_t st) {
  const Work w = workspace<N>(b, s, d);
  const int nck = (s + CK - 1) / CK;
  const int nblk = (d + channels<N>() - 1) / channels<N>();
  const size_t nst = w.chunk / 5;  // floats of one [b][nck][d][N] array
  float* hl = ws;
  float* pd = hl + nst;
  float* gh = pd + nst;
  float* ent = gh + nst;
  float* car = ent + nst;
  float* part = ws + w.chunk;
  float* dApart = part + w.part;
  float* dDpart = dApart + w.dA;
  const dim3 grid(nblk, nck, b);
  auto chunk = chunk_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ChunkSmem<N>::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk<<<grid, THREADS, ChunkSmem<N>::bytes, st>>>(x, dt, A, B, C, dy, hl,
                                                    pd, gh, s, d, nck);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t dn = static_cast<size_t>(d) * N;
  const int ct = 256;
  carry_kernel<<<static_cast<unsigned>((b * dn + ct - 1) / ct), ct, 0,
                 st>>>(hl, pd, gh, ent, car, b, nck, dn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = bwd_kernel<N>;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Smem<N>::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, THREADS, Smem<N>::bytes, st>>>(x, dt, A, B, C, D, dy, ent,
                                              car, dx, ddt, part, dApart,
                                              dDpart, b, s, d, nck);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(b) * s * 2 * N + dn + d;
  const int rt = 256;
  reduce_kernel<N><<<static_cast<unsigned>((total + rt - 1) / rt), rt, 0,
                     st>>>(part, dApart, dDpart, dB, dC, dA, dD, b, s, d,
                           nblk, b * nck);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int occupancy(int* out) {
  auto kern = bwd_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem<N>::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, THREADS,
                                                      Smem<N>::bytes);
  out[0] = blocks;
  out[1] = THREADS;
  out[2] = static_cast<int>(Smem<N>::bytes);
  out[3] = lanes<N>();
  out[4] = CK;
  out[5] = T;
  out[6] = KERNELS;
  return static_cast<int>(err);
}

}  // namespace

// State sizes 4, 8 and 16. Returns 0, a cudaError_t, or -1 for a state
// size without an instantiation. ws holds selective_scan_bwd_workspace's
// floats; b, s and d are positive.
extern "C" int selective_scan_bwd(const float* x, const float* dt,
                                  const float* A, const float* B,
                                  const float* C, const float* D,
                                  const float* dy, float* dx, float* ddt,
                                  float* dA, float* dB, float* dC, float* dD,
                                  float* ws, int b, int s, int d, int n,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4:
      return run<4>(x, dt, A, B, C, D, dy, dx, ddt, dA, dB, dC, dD, ws, b, s,
                    d, st);
    case 8:
      return run<8>(x, dt, A, B, C, D, dy, dx, ddt, dA, dB, dC, dD, ws, b, s,
                    d, st);
    case 16:
      return run<16>(x, dt, A, B, C, D, dy, dx, ddt, dA, dB, dC, dD, ws, b,
                     s, d, st);
    default:
      return -1;
  }
}

// out[0..3]: floats of the chunks' local states, decays, cotangents,
// entry states and carries, the per-block dB / dC partials, the
// per-chunk dA and dD partials. Returns 0 or -1.
extern "C" int selective_scan_bwd_workspace(int b, int s, int d, int n,
                                            long long* out) {
  Work w;
  switch (n) {
    case 4: w = workspace<4>(b, s, d); break;
    case 8: w = workspace<8>(b, s, d); break;
    case 16: w = workspace<16>(b, s, d); break;
    default: return -1;
  }
  out[0] = static_cast<long long>(w.chunk);
  out[1] = static_cast<long long>(w.part);
  out[2] = static_cast<long long>(w.dA);
  out[3] = static_cast<long long>(w.dD);
  return 0;
}

// The reverse walk's launch shape: out[0] blocks resident on an SM (the
// CUDA occupancy query), out[1] threads a block, out[2] dynamic shared
// memory a block in bytes, out[3] lanes a channel, out[4] steps a chunk,
// out[5] steps a register tile, out[6] kernels a call. Returns 0, a
// cudaError_t, or -1.
extern "C" int selective_scan_bwd_occupancy(int n, int* out) {
  switch (n) {
    case 4: return occupancy<4>(out);
    case 8: return occupancy<8>(out);
    case 16: return occupancy<16>(out);
    default: return -1;
  }
}
