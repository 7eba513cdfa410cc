// Selective scan (the Mamba-1 diagonal SSM) on Hopper.
//
// Replaces the TPU kernel repro/kernels/selective_scan.py:57
// selective_scan (body _scan_kernel :23). It computes the reference
// function repro/kernels/ref.py:208 selective_scan, including the initial
// state h0 and the final state, which the TPU kernel refuses:
//
//   h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,   y_t = C_t . h_t + D x_t
//
// Contract: x, dt [b, s, d]; A [d, N]; B, C [b, s, N]; D [d]; optional
// h0 [b, d, N]; all float32 and contiguous. y [b, s, d]; with h_out
// non-null also the state after the last step, [b, d, N].
//
// What bounds it on the H100. At b 8, s 512, d 8192, N 16 the function
// moves 407 MB (x, dt, y dominate): 0.12 ms at 3.35 TB/s. It also needs
// b s d N = 537 M exponentials, one special-function (MUFU) instruction
// each, and the MUFU pipes take 16 a clock per SM: 537 M / (132 SMs *
// 16) = 254 k clocks, 0.128 ms at the 1980 MHz boost clock (the MUFU
// floor). Every update also takes four float32 instructions (dt A',
// dx B, a h + u, h C) at 128 a clock per SM, 0.07 ms. The MUFU
// instructions share the SM's MIO queue with shared-memory loads and
// stores and warp shuffles, so those count against the MUFU time too.
// So the floor is ~0.13-0.15 ms, set by the MUFU pipes and the bytes
// together; the kernel keeps loads in flight behind the arithmetic and
// keeps the MIO work of an update small.
//
// Design:
// * The N states of a channel are split over L lanes of a warp, P = N / L
//   states each (N 16: 2 lanes of 8 states), so a launch has b d L
//   threads: at the shape above 131 k threads, 31 warps of work an SM
//   against 15.5 with one thread a channel; __launch_bounds__ keeps
//   registers at or below 64, so 32 warps an SM are resident. Each lane
//   walks the whole sequence with its P states, A and D in registers; y's
//   partial sums over the lanes meet in log2(L) xor shuffles, in a fixed
//   order. Every lane of a channel re-reads B_t and C_t for its states
//   from shared memory each step, so more lanes a channel mean more MIO
//   work an update: on the H100, 4 lanes of 4 states run about a third
//   slower than 2 of 8, and 1 lane of 16 about as fast, with half the
//   warps (tools/scan_sweep.py times the three).
// * One update is FMUL (dt A'), MUFU.EX2, FMUL (dx B), FFMA (a h + u),
//   FFMA (h C): A' = A log2(e) is formed once per lane, so exp(dt A) is
//   ex2.approx.ftz(dt A'), and dx = dt x once per step, not per state.
// * The block stages its tiles of T steps (x, dt for its channels; B, C)
//   in shared memory through a two-stage cp.async ring, 16-byte copies
//   (4-byte ones when d is not a multiple of 4), zero-filled past s and
//   d, with one barrier a tile; each thread's copies are fixed at compile
//   time, so a tile costs a few address adds. y goes to a shared tile as
//   it is computed and leaves in 16-byte stores after the next barrier,
//   not as one scattered 4-byte store per step.
//
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // threads a block: THREADS / L channels
constexpr int MIN_BLOCKS = 4;  // blocks an SM: at most 64 registers
constexpr int T = 16;          // time steps a staged tile
constexpr int STAGES = 2;      // tiles of the cp.async ring
constexpr float LOG2E = 1.4426950408889634f;

// Lanes a channel for each state size: 8 states a lane (4 for N = 4).
template <int N>
__host__ __device__ constexpr int lanes() {
  return N >= 8 ? N / 8 : 1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// E floats (4 or 1) from src, or zeros when !valid (src is then not read).
template <int E>
__device__ __forceinline__ void cp(uint32_t dst, const float* src,
                                   bool valid) {
  if constexpr (E == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
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
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The block's shared memory: STAGES ring slots of x, dt [T][CH] and B, C
// [T][N], then two y tiles [T][CH] (written while a tile is computed,
// stored to device memory after the next barrier).
template <int N, int L>
struct Smem {
  static constexpr int CH = THREADS / L;  // channels a block
  static constexpr int X = T * CH, BC = T * N;
  static constexpr int STAGE = 2 * X + 2 * BC;  // floats
  static constexpr int Y = STAGES * STAGE;      // first y tile
  static constexpr size_t bytes = sizeof(float) * (Y + 2 * X);
};

// How a thread moves [T][CH] tiles between device and shared memory: E
// floats a copy (16 bytes when rows of d floats are 16-byte aligned),
// rows lr + i RSTEP of the tile for i < NPASS, at column lc.
template <int CH, bool V4>
struct Rows {
  static constexpr int E = V4 ? 4 : 1;
  static constexpr int CPR = CH / E;  // copies a tile row
  static constexpr int RSTEP = THREADS / CPR, NPASS = T / RSTEP;
  static_assert(THREADS % CPR == 0 && T % RSTEP == 0, "tile rows");
};

template <int N, bool V4>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ D,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_out, int s, int d) {
  constexpr int L = lanes<N>(), P = N / L;
  using S = Smem<N, L>;
  constexpr int CH = S::CH, QBC = S::BC / 4;
  using R = Rows<CH, V4>;
  constexpr int E = R::E;
  static_assert(P % 4 == 0 && (L & (L - 1)) == 0 && L <= 32, "split");
  static_assert(2 * QBC <= THREADS, "B, C copies");
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const uint32_t sbase = smem_u32(sm);

  const int tid = threadIdx.x, b = blockIdx.y, c0 = blockIdx.x * CH;
  const int ch = tid / L, j = tid % L, n0 = j * P;
  const int c = c0 + ch;
  const bool live = c < d;
  const size_t row0 = static_cast<size_t>(b) * s;  // first (b, t) row

  // this thread's copies: x, dt and y rows lr + i RSTEP at column lc; one
  // 16-byte chunk of B or C (threads below 2 QBC)
  const int lr = tid / R::CPR, lc = E * (tid % R::CPR);
  const bool col_ok = c0 + lc < d;
  const size_t rd = static_cast<size_t>(R::RSTEP) * d;
  const size_t g_xy = (row0 + lr) * d + c0 + lc;
  const uint32_t s_xy = 4 * (lr * CH + lc);
  const bool bc = tid < 2 * QBC;
  const int e_bc = 4 * (tid % QBC);
  const float* g_bc = (tid < QBC ? Bm : Cm) + row0 * N + e_bc;
  const uint32_t s_bc = 4 * (2 * S::X + (tid < QBC ? 0 : S::BC) + e_bc);

  auto load = [&](int tile) {
    const int t0 = tile * T;
    const uint32_t slot = sbase + 4 * (tile % STAGES) * S::STAGE;
    const size_t off = g_xy + static_cast<size_t>(t0) * d;
#pragma unroll
    for (int i = 0; i < R::NPASS; ++i) {
      const bool ok = col_ok && t0 + lr + i * R::RSTEP < s;
      const size_t at = ok ? off + i * rd : 0;
      const uint32_t dst = slot + s_xy + 4 * i * R::RSTEP * CH;
      cp<E>(dst, x + at, ok);
      cp<E>(dst + 4 * S::X, dt + at, ok);
    }
    if (bc) {
      const bool ok = t0 + e_bc / N < s;
      cp<4>(slot + s_bc, ok ? g_bc + static_cast<size_t>(t0) * N : Bm, ok);
    }
  };
  // the y rows of tile `tile` (staged in y buffer tile & 1) to y
  auto store = [&](int tile) {
    const int t0 = tile * T;
    const float* ys = sm + S::Y + (tile & 1) * S::X + lr * CH + lc;
    float* dst = y + g_xy + static_cast<size_t>(t0) * d;
#pragma unroll
    for (int i = 0; i < R::NPASS; ++i) {
      if (col_ok && t0 + lr + i * R::RSTEP < s) {
        if constexpr (E == 4)
          *reinterpret_cast<float4*>(dst + i * rd) =
              *reinterpret_cast<const float4*>(ys + i * R::RSTEP * CH);
        else
          dst[i * rd] = ys[i * R::RSTEP * CH];
      }
    }
  };

  float a2[P], h[P];
  float Dd = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    a2[p] = live ? __fmul_rn(A[static_cast<size_t>(c) * N + n0 + p], LOG2E)
                 : 0.f;
    h[p] = (live && h0 != nullptr)
               ? h0[(static_cast<size_t>(b) * d + c) * N + n0 + p]
               : 0.f;
  }
  if (live) Dd = D[c];

  const int n_tiles = (s + T - 1) / T;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) load(i);
    cp_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_wait<STAGES - 2>();  // this thread's copies of tile it have landed
    __syncthreads();        // everyone's; tile it - 1 and its y are done
    if (it + STAGES - 1 < n_tiles) load(it + STAGES - 1);
    cp_commit();
    if (it > 0) store(it - 1);

    const float* xs = sm + (it % STAGES) * S::STAGE;
    const float* ds = xs + S::X;
    const float* bs = ds + S::X + n0;
    const float* cs = bs + S::BC;
    float* ys = sm + S::Y + (it & 1) * S::X;
    const int nt = min(T, s - it * T);

    auto step = [&](int tt) {
      const float xv = xs[tt * CH + ch], dv = ds[tt * CH + ch];
      float bv[P], cv[P];
#pragma unroll
      for (int p = 0; p < P; p += 4) {
        const float4 bq = *reinterpret_cast<const float4*>(bs + tt * N + p);
        const float4 cq = *reinterpret_cast<const float4*>(cs + tt * N + p);
        bv[p] = bq.x, bv[p + 1] = bq.y, bv[p + 2] = bq.z, bv[p + 3] = bq.w;
        cv[p] = cq.x, cv[p + 1] = cq.y, cv[p + 2] = cq.z, cv[p + 3] = cq.w;
      }
      const float dx = __fmul_rn(dv, xv);
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float a = ex2(__fmul_rn(dv, a2[p]));
        h[p] = __fmaf_rn(a, h[p], __fmul_rn(dx, bv[p]));
        acc = p == 0 ? __fmul_rn(h[p], cv[p]) : __fmaf_rn(h[p], cv[p], acc);
      }
      // every lane of the channel ends with the same sum (each add is of
      // the same two values), and writes it to the same word
#pragma unroll
      for (int o = 1; o < L; o *= 2)
        acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
      ys[tt * CH + ch] = __fmaf_rn(xv, Dd, acc);
    };
    if (nt == T) {
#pragma unroll
      for (int tt = 0; tt < T; ++tt) step(tt);
    } else {
      for (int tt = 0; tt < nt; ++tt) step(tt);
    }
  }
  cp_wait<0>();  // only empty groups are left
  if (n_tiles > 0) {
    __syncthreads();
    store(n_tiles - 1);
  }
  if (live && h_out != nullptr) {
#pragma unroll
    for (int p = 0; p < P; ++p)
      h_out[(static_cast<size_t>(b) * d + c) * N + n0 + p] = h[p];
  }
}

template <int N, bool V4>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* B, const float* C, const float* D,
                   const float* h0, float* y, float* h_out, int b, int s,
                   int d, cudaStream_t stream) {
  using S = Smem<N, lanes<N>()>;
  auto kern = scan_kernel<N, V4>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((d + S::CH - 1) / S::CH, b);
  kern<<<grid, THREADS, S::bytes, stream>>>(x, dt, A, B, C, D, h0, y, h_out,
                                            s, d);
  return cudaGetLastError();
}

// 16-byte copies need rows of a multiple of 4 floats.
template <int N>
int run(const float* x, const float* dt, const float* A, const float* B,
        const float* C, const float* D, const float* h0, float* y,
        float* h_out, int b, int s, int d, cudaStream_t stream) {
  return static_cast<int>(
      d % 4 == 0 ? launch<N, true>(x, dt, A, B, C, D, h0, y, h_out, b, s, d,
                                   stream)
                 : launch<N, false>(x, dt, A, B, C, D, h0, y, h_out, b, s,
                                    d, stream));
}

template <int N>
int occupancy(int d, int* out) {
  using S = Smem<N, lanes<N>()>;
  auto kern = d % 4 == 0 ? scan_kernel<N, true> : scan_kernel<N, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, THREADS,
                                                      S::bytes);
  out[0] = blocks;
  out[1] = THREADS;
  out[2] = static_cast<int>(S::bytes);
  out[3] = lanes<N>();
  return static_cast<int>(err);
}

}  // namespace

// State sizes 4, 8 and 16 (Jamba's d_state is 16). Returns 0, a
// cudaError_t, or -1 for a state size without an instantiation.
extern "C" int selective_scan(const float* x, const float* dt,
                              const float* A, const float* B, const float* C,
                              const float* D, const float* h0, float* y,
                              float* h_out, int b, int s, int d, int n,
                              void* stream) {
  if (b == 0 || d == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4:
      return run<4>(x, dt, A, B, C, D, h0, y, h_out, b, s, d, st);
    case 8:
      return run<8>(x, dt, A, B, C, D, h0, y, h_out, b, s, d, st);
    case 16:
      return run<16>(x, dt, A, B, C, D, h0, y, h_out, b, s, d, st);
    default:
      return -1;
  }
}

// The launch shape of state size n over d channels: out[0] blocks
// resident on an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// out[1] threads a block, out[2] dynamic shared memory a block in bytes,
// out[3] lanes a channel. Returns 0, a cudaError_t, or -1.
extern "C" int selective_scan_occupancy(int n, int d, int* out) {
  switch (n) {
    case 4:
      return occupancy<4>(d, out);
    case 8:
      return occupancy<8>(d, out);
    case 16:
      return occupancy<16>(d, out);
    default:
      return -1;
  }
}
