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
// Design: one thread owns one (batch row, channel) pair and walks the
// sequence with its N state values, A[channel, :] and D[channel] in
// registers, so the recurrence needs no cross-thread step at all (the
// TPU kernel's chunks and associative scan exist to feed its vector
// unit). Neighbouring threads own neighbouring channels: every load of
// x and dt and every store of y is one coalesced 512-byte row of the
// block. The block stages B_t and C_t (N floats each, shared by all its
// channels) in shared memory one tile of T steps at a time, and each
// thread issues the loads of its T steps of x and dt together before the
// tile's arithmetic, so 2T loads are in flight per thread.
//
// Bound on the H100: bytes. The function reads x, dt, B, C, A, D (and
// h0) once and writes y (and h): at b 8, s 512, d 8192, N 16 that is
// 407 MB, 0.12 ms at 3.35 TB/s. Its arithmetic, b s d N = 537 M updates
// of about 8 float32 operations, is 0.064 ms at the 67 TFLOP/s float32
// rate, so bytes decide by the card's published rates. The 537 M
// exponentials are the closer limit in practice: the special-function
// units issue 16 a cycle per SM, about 0.15 ms for the card at its boost
// clock, and expf adds a few FMA-pipe instructions around each.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // channels per block
constexpr int T = 16;         // time steps per staged tile

template <int N>
__global__ void __launch_bounds__(THREADS)
    scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ D,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_out, int s, int d) {
  __shared__ float Bs[T][N];
  __shared__ float Cs[T][N];
  const int b = blockIdx.y;
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const bool live = c < d;
  const size_t row0 = static_cast<size_t>(b) * s;  // first (b, t) row

  float a_row[N], h[N];
  float Dd = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a_row[n] = live ? A[static_cast<size_t>(c) * N + n] : 0.f;
    h[n] = (live && h0 != nullptr)
               ? h0[(static_cast<size_t>(b) * d + c) * N + n]
               : 0.f;
  }
  if (live) Dd = D[c];

  for (int t0 = 0; t0 < s; t0 += T) {
    const int nt = min(T, s - t0);
    __syncthreads();  // the previous tile's reads of Bs/Cs are done
    for (int i = threadIdx.x; i < T * N; i += THREADS) {
      const int tt = i / N, nn = i % N;
      float bv = 0.f, cv = 0.f;
      if (tt < nt) {
        bv = Bm[(row0 + t0 + tt) * N + nn];
        cv = Cm[(row0 + t0 + tt) * N + nn];
      }
      Bs[tt][nn] = bv;
      Cs[tt][nn] = cv;
    }
    float xv[T], dv[T];
#pragma unroll
    for (int tt = 0; tt < T; ++tt) {
      xv[tt] = 0.f;
      dv[tt] = 0.f;
      if (live && tt < nt) {
        const size_t at = (row0 + t0 + tt) * d + c;
        xv[tt] = x[at];
        dv[tt] = dt[at];
      }
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < T; ++tt) {
      if (tt < nt) {  // uniform over the block
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          // the plain version's order: a = exp(dt A), u = (dt B) x
          const float a = expf(dv[tt] * a_row[n]);
          h[n] = fmaf(a, h[n], dv[tt] * Bs[tt][n] * xv[tt]);
          acc = fmaf(h[n], Cs[tt][n], acc);
        }
        if (live) y[(row0 + t0 + tt) * d + c] = acc + xv[tt] * Dd;
      }
    }
  }
  if (live && h_out != nullptr) {
#pragma unroll
    for (int n = 0; n < N; ++n)
      h_out[(static_cast<size_t>(b) * d + c) * N + n] = h[n];
  }
}

template <int N>
int run(const float* x, const float* dt, const float* A, const float* B,
        const float* C, const float* D, const float* h0, float* y,
        float* h_out, int b, int s, int d, cudaStream_t stream) {
  dim3 grid((d + THREADS - 1) / THREADS, b);
  scan_kernel<N><<<grid, THREADS, 0, stream>>>(x, dt, A, B, C, D, h0, y,
                                               h_out, s, d);
  return static_cast<int>(cudaGetLastError());
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
