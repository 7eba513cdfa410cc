// Tensor-core tile pieces for Hopper (sm_90a), shared by the bf16 flash
// attention kernels (flash_attention_fwd.cu, flash_attention_bwd.cu).
//
// * Tiles in shared memory are bf16, R rows x W columns (W a multiple of
//   64), stored as W/64 column blocks of R rows x 128 bytes. Chunk c (16
//   bytes, 8 values) of row r of a block sits at r*128 + ((c ^ (r%8))*16):
//   the 128-byte swizzle that wgmma's shared-memory descriptors read (and
//   that TMA's SWIZZLE_128B writes), with the tile 1024-byte aligned.
//   Tiles are filled with 16-byte cp.async copies (zero-filled past the
//   rows the caller names), so the next tile is in flight while the
//   current one is multiplied.
// * Products are wgmma.mma_async m64n64k16, bf16 in, float32 accumulate,
//   issued by one warpgroup (128 threads): A from shared memory (a
//   K-major tile: the contraction runs along the 128-byte rows) or from
//   registers (a float32 accumulator rounded to bf16 in place, so P and
//   dS never go back to shared memory); B from shared memory, K-major or
//   MN-major (the contraction runs down the rows, as for V in P.V).
//   Wider products (a head dim of 128) are two N = 64 products over the
//   two column blocks; a head dim of 96 runs as 128 with its last 32
//   columns zero-filled in shared memory (load_tile's WV).
// * The m64n64 float32 accumulator of thread t of a warpgroup (warp
//   w = t/32, lane l = t%32) holds 32 values: element 4j + 2h + c is row
//   16w + l/4 + 8h, column 8j + 2(l%4) + c. A row's values live in the
//   four lanes of one quad, so row reductions are two shuffles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mma {

constexpr int WG = 128;  // threads of a warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of chunk c of row r in a swizzled tile of R rows.
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// ---- cp.async ----------------------------------------------------------- //

// 16 bytes from src, or zeros when !valid (src is then not read).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes from src, or zeros when !valid.
__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's landed cp.async writes visible to wgmma's reads
// (the async proxy); then a barrier publishes them to the warpgroup.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Fills a swizzled R x W tile at dst: row r from row(r) (WV <= W
// contiguous bf16, 16-byte aligned), or zeros where row(r) is null; the
// columns past WV (a head dim padded up to the 64-column blocks) are
// zero-filled without a read of device memory. The calling warpgroup
// shares the copy: thread t copies chunk t % C of rows t / C + k * WG / C,
// so neighbouring threads copy neighbouring 16-byte chunks of a row, and
// a thread's chunks sit at one swizzled column.
template <int R, int W, int WV = W, typename RowPtr>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* any,
                                          RowPtr row) {
  constexpr int C = W / 8, STEP = WG / C;
  static_assert(WG % C == 0 && R % STEP == 0 && STEP % 8 == 0, "tile");
  static_assert(WV % 8 == 0 && WV <= W, "valid columns");
  const int t = threadIdx.x % WG, r0 = t / C, c = t % C;
  const bool col = WV == W || c * 8 < WV;
  dst += swz<R>(r0, c);
#pragma unroll
  for (int k = 0; k < R / STEP; ++k) {
    const __nv_bfloat16* src = col ? row(r0 + k * STEP) : nullptr;
    cp16(dst + k * STEP * 128, src ? src + c * 8 : any, src != nullptr);
  }
}

// A head dim padded up to whole 64-column blocks of the swizzled tiles
// (96 -> 128: the pad columns are zeros in shared memory, so every
// product over them adds exact zeros).
__host__ __device__ constexpr int pad64(int e) {
  return (e + 63) / 64 * 64;
}

// ---- wgmma -------------------------------------------------------------- //

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all >> 4), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand, k-step kk (columns 16kk .. 16kk+15) of a tile of R
// rows: 32 bytes along the swizzled row, 1024 bytes between 8-row groups.
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * (R * 128) + (kk & 3) * 32, 16, 1024);
}
// MN-major B operand, k-step kk (rows 16kk .. 16kk+15) of a tile whose
// columns are N: 1024 bytes between 8-row groups (stride), one column
// block (R * 128 bytes) between 64-wide N groups (leading).
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 2048, R * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins registers at this point of the program: accumulators and A
// fragments are written before wg_fence and read after wg_wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) asm volatile("" : "+r"(a[i][u])::"memory");
}

#define MMA_D32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define MMA_D32_LIST                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A B, m64n64k16, both operands K-major in shared memory (scores:
// the contraction runs along the head dim). acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MMA_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MMA_D32(d)
      : "l"(da), "l"(db), "r"(acc));
}
// d += A B, m64n64k16: A from registers (see to_a), B MN-major in shared
// memory (the contraction runs down its rows, as for V in P V).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MMA_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MMA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (+)= A B, m64n64k16, both operands in shared memory, each K-major
// (TA or TB = 0: desc_k) or MN-major (1: desc_mn, the contraction runs
// down the tile's rows; for A, the tile's 64 columns are A's rows).
// wgmma_ss is the <0, 0> case. acc = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[32], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MMA_D32_LIST
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : MMA_D32(d)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}
#undef MMA_D32
#undef MMA_D32_LIST

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// The register A operand of k-step kk (columns 16kk .. 16kk+15) of an
// m64n64 float32 accumulator, rounded to bf16: the accumulator's and A's
// fragment layouts coincide, so each thread converts its own values.
__device__ __forceinline__ void to_a(const float (&p)[32], int kk,
                                     uint32_t (&a)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
    a[u] = pack_bf16(p[8 * kk + 2 * u], p[8 * kk + 2 * u + 1]);
}

// Barrier of one warpgroup (id 1 + its index; 0 is __syncthreads').
__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WG) : "memory");
}

// 2^x in one special-function instruction (2^x below 2^-126 flushes to
// zero; -inf gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- the flash contract ------------------------------------------------- //

// n / d for 0 <= n < 2^31 and a divisor d >= 1 fixed for the block: a
// multiply-high and a shift (the round-up method PyTorch's IntDivider
// uses).
struct FastDiv {
  uint32_t d, mul, shift;
  __device__ explicit FastDiv(int divisor) : d(divisor), shift(0) {
    while ((1u << shift) < d) ++shift;
    mul = static_cast<uint32_t>(((1ull << 32) * ((1ull << shift) - d)) / d +
                                1);
  }
  __device__ __forceinline__ int div(int n) const {
    const uint32_t t = __umulhi(static_cast<uint32_t>(n), mul);
    return static_cast<int>((t + static_cast<uint32_t>(n)) >> shift);
  }
};

// The query rows of one (batch row b, kv head gi): row m = i * rep + r is
// position i of q head gi * rep + r, so the rep q heads that share a kv
// head share its K/V tiles (GQA) and a tile's last row has its causal
// limit. Causal rows see keys k <= q_offset + i, bidirectional rows every
// k < S; rows at or past M = rep * sq see none.
struct Rows {
  FastDiv rep;
  int M, causal, q_offset, S, H, sq;
  size_t first;  // row (b, 0, gi * rep) of a [b, sq, H, *] tensor
  int head0;     // head b * H + gi * rep of a [b, H, sq] tensor
  __device__ Rows(int b, int gi, int sq_, int H_, int G, int S_, int causal_,
                  int q_offset_)
      : rep(H_ / G),
        M(H_ / G * sq_),
        causal(causal_),
        q_offset(q_offset_),
        S(S_),
        H(H_),
        sq(sq_),
        first(static_cast<size_t>(b) * sq_ * H_ + gi * (H_ / G)),
        head0(b * H_ + gi * (H_ / G)) {}
  // index of row m in [b * sq * H] (rows of q, dO, out, dq)
  __device__ __forceinline__ size_t row(int m) const {
    const int i = rep.div(m);
    return first + static_cast<size_t>(i) * H + (m - i * rep.d);
  }
  // index of row m in [b, H, sq] (lse, D)
  __device__ __forceinline__ size_t stat(int m) const {
    const int i = rep.div(m);
    return static_cast<size_t>(head0 + m - i * rep.d) * sq + i;
  }
  // keys visible to row m: k < limit
  __device__ __forceinline__ int limit(int m) const {
    if (m >= M) return 0;
    const int L = causal ? q_offset + rep.div(m) + 1 : S;
    return min(max(L, 0), S);
  }
  // the smallest limit among rows m0 .. m0+BM-1: only key tiles that
  // reach it need the mask (limits grow with m; a block with rows past M
  // masks every tile)
  template <int BM>
  __device__ __forceinline__ int min_limit(int m0) const {
    return m0 + BM > M ? 0 : limit(m0);
  }
};

// Raise a kernel's dynamic shared memory cap to what it needs.
template <typename Kern>
inline cudaError_t allow_smem(Kern* kern, size_t bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace mma
