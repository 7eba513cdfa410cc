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
// its size in floats) holds the state checkpoints and the partial sums.
//
// What bounds it on the H100. At the training shape (b 1, s 4096, d 8192,
// N 16) it must read x, dt, dy and write dx, ddt: 5 * 134 MB = 0.67 GB,
// 0.20 ms at 3.35 TB/s; and it needs exp(dt A) for every (b, t, d, n)
// once, 537 M MUFU.EX2 at 16 a clock per SM, 0.13 ms at 1980 MHz. This
// design recomputes: four exponentials an update (the checkpoint pass,
// the chunk's sub-checkpoints, the tile's states, the reverse step), so
// its MUFU floor is ~0.51 ms, and the cross-channel sums of dB and dC
// cost warp shuffles of the same order. A first, simple design: float32
// throughout, no tensor cores, no TMA.
//
// Design, three launches on the caller's stream:
// 1. ck_kernel: a forward walk that writes the state at the start of every
//    CK-step chunk, [b, s/CK, d, N] (17 MB at the training shape), never
//    the state of every step (2.1 GB).
// 2. bwd_kernel: a block holds CH channels of one batch row, the N states
//    of a channel split over L = N / 4 lanes of a warp (4 states a lane).
//    It walks the chunks from last to first. For each chunk it walks
//    forward from the chunk's checkpoint, keeping the state at every T
//    steps in shared memory; then, tile by tile from the last, it
//    recomputes the tile's T + 1 states into registers and walks them
//    back, carrying a_{t+1} g_{t+1} in registers across tiles and chunks.
//    Each tile's x, dt, dy, B and C are staged into shared memory by the
//    whole block in coalesced loads first, so a step waits on no load
//    from device memory (with a load a step, the walk was bound by the
//    memory latency: 8 warps an SM at b 1 cannot hide it).
//    dx, ddt go straight out; dA and dD accumulate in registers (one
//    partial a batch row). dB and dC sum over channels: within a warp by
//    a reduce-scatter of shuffles (the warp's channels halve the values a
//    level, then plain xor sums), across the block's warps in shared
//    memory, and across blocks as per-block partials in the workspace.
// 3. reduce_kernel: the per-block partials of dB, dC and the per-row
//    partials of dA, dD summed in a fixed order. No float atomics, so two
//    runs give the same bits.
//
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // threads a block: THREADS / L channels
constexpr int WARPS = THREADS / 32;
constexpr int P = 4;          // states a lane
constexpr int T = 16;         // steps a register tile
constexpr int CK = 128;       // steps a checkpointed chunk
constexpr int SUB = CK / T;   // sub-checkpoints a chunk (shared memory)
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

// Shared memory of bwd_kernel: sub-checkpoints [SUB][P][THREADS] (a
// thread's own, conflict-free), the warps' dB / dC sums of a tile
// [T][WARPS][2 N], then the tile's inputs: x, dt, dy [T][CH], B, C [T][N].
template <int N>
struct Smem {
  static constexpr int SUBF = SUB * P * THREADS;
  static constexpr int RED = T * WARPS * 2 * N;
  static constexpr int XT = T * channels<N>(), BT = T * N;
  static constexpr size_t bytes =
      sizeof(float) * (SUBF + RED + 3 * XT + 2 * BT);
};

// 1. The state before step k CK of each chunk k: ck [b][nck][d][N].
template <int N>
__global__ void __launch_bounds__(THREADS)
    ck_kernel(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ Bm,
              float* __restrict__ ck, int s, int d, int nck) {
  constexpr int L = lanes<N>(), CH = channels<N>();
  const int tid = threadIdx.x, b = blockIdx.y;
  const int c = blockIdx.x * CH + tid / L, n0 = (tid % L) * P;
  if (c >= d) return;  // no barrier or shuffle in this kernel
  float a2[P], h[P];
  unpack(ld4(A + static_cast<size_t>(c) * N + n0), a2);
#pragma unroll
  for (int p = 0; p < P; ++p) a2[p] = __fmul_rn(a2[p], LOG2E), h[p] = 0.f;
  const size_t row0 = static_cast<size_t>(b) * s;
  for (int k = 0; k < nck; ++k) {
    float4* dst = reinterpret_cast<float4*>(
        ck + ((static_cast<size_t>(b) * nck + k) * d + c) * N + n0);
    *dst = make_float4(h[0], h[1], h[2], h[3]);
    if (k == nck - 1) break;
    const int t0 = k * CK;  // every step of a chunk before the last is < s
#pragma unroll 8
    for (int t = t0; t < t0 + CK; ++t) {
      const size_t r = row0 + t;
      const float xv = __ldg(x + r * d + c), dv = __ldg(dt + r * d + c);
      float bv[P];
      unpack(ld4(Bm + r * N + n0), bv);
      const float dx = __fmul_rn(dv, xv);
#pragma unroll
      for (int p = 0; p < P; ++p)
        h[p] = __fmaf_rn(ex2(__fmul_rn(dv, a2[p])), h[p],
                         __fmul_rn(dx, bv[p]));
    }
  }
}

// 2. The reverse walk. part [nblk][b s][2 N] (dB then dC, per block);
// dApart [b][d][N], dDpart [b][d] (per batch row).
template <int N>
__global__ void __launch_bounds__(THREADS, 2)
    bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ D,
               const float* __restrict__ dy, const float* __restrict__ ck,
               float* __restrict__ dxo, float* __restrict__ ddto,
               float* __restrict__ part, float* __restrict__ dApart,
               float* __restrict__ dDpart, int bsz, int s, int d, int nck) {
  constexpr int L = lanes<N>(), CH = channels<N>();
  static_assert(P == 4 && (L & (L - 1)) == 0 && L >= 1 && L <= 8, "split");
  using S = Smem<N>;
  extern __shared__ float4 smem_raw[];
  float* sub = reinterpret_cast<float*>(smem_raw);
  float* red = sub + S::SUBF;
  float* tx = red + S::RED;  // the staged tile
  float* tdt = tx + S::XT;
  float* tdy = tdt + S::XT;
  float* tb = tdy + S::XT;
  float* tc = tb + S::BT;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.y, j = tid % L, n0 = j * P, ch = tid / L;
  const int c0 = blockIdx.x * CH, c = c0 + ch;
  const bool live = c < d;
  const int cc = live ? c : 0;  // a channel to address; dead lanes read 0
  const size_t row0 = static_cast<size_t>(b) * s;
  const size_t nrows = static_cast<size_t>(bsz) * s;

  float a2[P], Af[P], G[P], dA[P];
  unpack(ld4(A + static_cast<size_t>(cc) * N + n0), Af);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    Af[p] = live ? Af[p] : 0.f;
    a2[p] = __fmul_rn(Af[p], LOG2E);
    G[p] = 0.f;
    dA[p] = 0.f;
  }
  const float Dd = live ? __ldg(D + cc) : 0.f;
  float dD = 0.f;

  // steps [ta, ta + nt) of the block's channels into the tile, in
  // coalesced loads (zeros past s and d); the reverse walk also takes dy
  // and C. Barriers on both sides: the last tile's readers are done, and
  // this one's writes land before anyone reads.
  auto stage = [&](int ta, int nt, bool rev) {
    __syncthreads();
    for (int e = tid; e < S::XT; e += THREADS) {
      const int i = e / CH, cl = e % CH;
      const bool ok = i < nt && c0 + cl < d;
      const size_t g = (row0 + ta + i) * d + c0 + cl;
      tx[e] = ok ? __ldg(x + g) : 0.f;
      tdt[e] = ok ? __ldg(dt + g) : 0.f;
      if (rev) tdy[e] = ok ? __ldg(dy + g) : 0.f;
    }
    for (int e = tid; e < S::BT; e += THREADS) {
      const bool ok = e / N < nt;
      const size_t g = (row0 + ta) * N + e;
      tb[e] = ok ? __ldg(Bm + g) : 0.f;
      if (rev) tc[e] = ok ? __ldg(Cm + g) : 0.f;
    }
    __syncthreads();
  };
  // the inputs of tile step i of this thread's channel (zeros on a dead
  // lane: its channel was staged as zeros)
  auto load = [&](int i, float& xv, float& dv, float* bv) {
    xv = tx[i * CH + ch];
    dv = tdt[i * CH + ch];
    unpack(*reinterpret_cast<const float4*>(tb + i * N + n0), bv);
  };
  auto advance = [&](float* h, float xv, float dv, const float* bv,
                     float* out) {
    const float dx = __fmul_rn(dv, xv);
#pragma unroll
    for (int p = 0; p < P; ++p)
      out[p] = __fmaf_rn(ex2(__fmul_rn(dv, a2[p])), h[p],
                         __fmul_rn(dx, bv[p]));
  };
  // lane-bit masks: the first two channel bits halve the dB / dC values,
  // the rest sum whole
  constexpr int O1 = L, O2 = 2 * L;
  const bool hi1 = lane & O1, hi2 = lane & O2;
  constexpr int FULL = 31 & ~(4 * L - 1);  // lane bits of whole sums
  const bool writer = (lane & FULL) == 0;
  const int n_red = n0 + 2 * hi1 + hi2;  // the state a writer lane holds

  for (int k = nck - 1; k >= 0; --k) {
    const int t0 = k * CK, t1 = min(s, t0 + CK);
    const int nsub = (t1 - t0 + T - 1) / T;
    float h[P];
    unpack(*reinterpret_cast<const float4*>(
               ck + ((static_cast<size_t>(b) * nck + k) * d + cc) * N + n0),
           h);
    // the chunk's sub-checkpoints: the state before each tile
    for (int q = 0; q < nsub; ++q) {
#pragma unroll
      for (int p = 0; p < P; ++p) sub[(q * P + p) * THREADS + tid] = h[p];
      if (q == nsub - 1) break;
      stage(t0 + q * T, T, false);
#pragma unroll 4
      for (int i = 0; i < T; ++i) {
        float xv, dv, bv[P];
        load(i, xv, dv, bv);
        advance(h, xv, dv, bv, h);
      }
    }
    // the tiles, last first
    for (int q = nsub - 1; q >= 0; --q) {
      const int ta = t0 + q * T, nt = min(T, t1 - ta);
      stage(ta, nt, true);
      float hist[T + 1][P];
#pragma unroll
      for (int p = 0; p < P; ++p) hist[0][p] = sub[(q * P + p) * THREADS + tid];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        if (i < nt) {
          float xv, dv, bv[P];
          load(i, xv, dv, bv);
          advance(hist[i], xv, dv, bv, hist[i + 1]);
        }
      }
#pragma unroll
      for (int i = T - 1; i >= 0; --i) {
        if (i < nt) {
          const size_t r = row0 + ta + i;
          float xv, dv, bv[P], cv[P];
          load(i, xv, dv, bv);
          unpack(*reinterpret_cast<const float4*>(tc + i * N + n0), cv);
          const float dyv = tdy[i * CH + ch];
          float sgB = 0.f, swA = 0.f, vB[P], vC[P];
          const float dvx = __fmul_rn(dv, xv);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float a = ex2(__fmul_rn(dv, a2[p]));
            const float g = __fmaf_rn(cv[p], dyv, G[p]);
            const float w = __fmul_rn(__fmul_rn(g, a), hist[i][p]);
            sgB = __fmaf_rn(g, bv[p], sgB);
            swA = __fmaf_rn(w, Af[p], swA);
            dA[p] = __fmaf_rn(dv, w, dA[p]);
            vB[p] = __fmul_rn(g, dvx);
            vC[p] = __fmul_rn(dyv, hist[i + 1][p]);
            G[p] = __fmul_rn(a, g);
          }
          // the channel's lanes: sum over its N states
#pragma unroll
          for (int o = 1; o < L; o *= 2) {
            sgB = __fadd_rn(sgB, __shfl_xor_sync(0xffffffffu, sgB, o));
            swA = __fadd_rn(swA, __shfl_xor_sync(0xffffffffu, swA, o));
          }
          if (live && j == 0) {
            dxo[r * d + c] = __fmaf_rn(dv, sgB, __fmul_rn(Dd, dyv));
            ddto[r * d + c] = __fmaf_rn(xv, sgB, swA);
          }
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
            float* rw = red + (i * WARPS + warp) * 2 * N;
            rw[n_red] = vB[0];
            rw[N + n_red] = vC[0];
          }
        }
      }
      __syncthreads();  // every warp's sums of the tile are in red
      for (int e = tid; e < nt * 2 * N; e += THREADS) {
        const int i = e / (2 * N), m = e % (2 * N);
        const float* rr = red + i * WARPS * 2 * N + m;
        float acc = rr[0];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) acc = __fadd_rn(acc, rr[w * 2 * N]);
        part[(blockIdx.x * nrows + row0 + ta + i) * 2 * N + m] = acc;
      }
      // the next tile's stage() begins with the barrier that frees red
    }
  }
  if (live) {
    *reinterpret_cast<float4*>(
        dApart + (static_cast<size_t>(b) * d + c) * N + n0) =
        make_float4(dA[0], dA[1], dA[2], dA[3]);
    if (j == 0) dDpart[static_cast<size_t>(b) * d + c] = dD;
  }
}

// 3. Fixed-order sums: dB, dC over the nblk channel blocks; dA, dD over
// the batch rows.
template <int N>
__global__ void reduce_kernel(const float* __restrict__ part,
                              const float* __restrict__ dApart,
                              const float* __restrict__ dDpart,
                              float* __restrict__ dB, float* __restrict__ dC,
                              float* __restrict__ dA, float* __restrict__ dD,
                              int bsz, int s, int d, int nblk) {
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
    for (int k = 1; k < bsz; ++k) acc = __fadd_rn(acc, dApart[k * n_a + i]);
    dA[i] = acc;
  } else if (e < n_bc + n_a + d) {
    const size_t i = e - n_bc - n_a;
    float acc = dDpart[i];
    for (int k = 1; k < bsz; ++k) acc = __fadd_rn(acc, dDpart[k * d + i]);
    dD[i] = acc;
  }
}

struct Work {
  size_t ck, part, dA, dD;  // floats of each workspace part
};
template <int N>
Work workspace(int b, int s, int d) {
  const size_t nck = (s + CK - 1) / CK;
  const size_t nblk = (d + channels<N>() - 1) / channels<N>();
  return {static_cast<size_t>(b) * nck * d * N,
          nblk * b * static_cast<size_t>(s) * 2 * N,
          static_cast<size_t>(b) * d * N, static_cast<size_t>(b) * d};
}

template <int N>
int run(const float* x, const float* dt, const float* A, const float* B,
        const float* C, const float* D, const float* dy, float* dx,
        float* ddt, float* dA, float* dB, float* dC, float* dD, float* ws,
        int b, int s, int d, cudaStream_t st) {
  const Work w = workspace<N>(b, s, d);
  float* ck = ws;
  float* part = ck + w.ck;
  float* dApart = part + w.part;
  float* dDpart = dApart + w.dA;
  const int nck = (s + CK - 1) / CK;
  const int nblk = (d + channels<N>() - 1) / channels<N>();
  dim3 grid(nblk, b);
  ck_kernel<N><<<grid, THREADS, 0, st>>>(x, dt, A, B, ck, s, d, nck);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = bwd_kernel<N>;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Smem<N>::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, THREADS, Smem<N>::bytes, st>>>(
      x, dt, A, B, C, D, dy, ck, dx, ddt, part, dApart, dDpart, b, s, d, nck);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(b) * s * 2 * N +
                       static_cast<size_t>(d) * N + d;
  const int rt = 256;
  reduce_kernel<N><<<static_cast<unsigned>((total + rt - 1) / rt), rt, 0,
                     st>>>(part, dApart, dDpart, dB, dC, dA, dD, b, s, d,
                           nblk);
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

// out[0..3]: floats of the state checkpoints, the per-block dB / dC
// partials, the per-row dA and dD partials. Returns 0 or -1.
extern "C" int selective_scan_bwd_workspace(int b, int s, int d, int n,
                                            long long* out) {
  Work w;
  switch (n) {
    case 4: w = workspace<4>(b, s, d); break;
    case 8: w = workspace<8>(b, s, d); break;
    case 16: w = workspace<16>(b, s, d); break;
    default: return -1;
  }
  out[0] = static_cast<long long>(w.ck);
  out[1] = static_cast<long long>(w.part);
  out[2] = static_cast<long long>(w.dA);
  out[3] = static_cast<long long>(w.dD);
  return 0;
}

// The reverse walk's launch shape: out[0] blocks resident on an SM (the
// CUDA occupancy query), out[1] threads a block, out[2] dynamic shared
// memory a block in bytes, out[3] lanes a channel. Returns 0, a
// cudaError_t, or -1.
extern "C" int selective_scan_bwd_occupancy(int n, int* out) {
  switch (n) {
    case 4: return occupancy<4>(out);
    case 8: return occupancy<8>(out);
    case 16: return occupancy<16>(out);
    default: return -1;
  }
}
