// Hopper's warpgroup products for the bf16 attention kernels (attention.cu's
// K6, flash_fwd.cu's K4 and K7a, attention_bwd.cu's K7b, attnblock.cu's
// K3):
// wgmma.mma_async m64nNk16 with bf16
// operands and fp32 accumulation, A from shared memory or from registers,
// B from shared memory through a matrix descriptor; and the shared-memory
// tile layout both read.
//
// Layout (the 128-byte swizzle, wgmma's and TMA's SWIZZLE_128B): a tile of
// `rows` rows and W bf16 columns (W a multiple of 64) is stored as W/64
// column blocks of 64 columns, each rows x 128 bytes, row r of a block at
// byte 128 r, its 16-byte chunk j (columns 8j..8j+7) at chunk j ^ (r % 8).
// Every 8 rows of a block (1,024 bytes, 1,024-byte aligned) are one swizzle
// atom. One such tile serves as either operand major-ness:
//   K-major (k along the columns: Q, K, dO, V as the second factor of a
//   score product, Q, K, dO, V as A): k-step kk (16 columns) starts at
//   column block kk / 4, 32 (kk % 4) bytes in; SBO = 1,024 bytes (the
//   next 8 rows).
//   MN-major (k along the rows, n along the columns: V of P V, dO of
//   P^T dO, Q of dS^T Q, K of dS K): k-step kk starts at row 16 kk;
//   SBO = 1,024 bytes (the next 8 rows along k), LBO = rows x 128 bytes
//   (the next 64 columns along n).
//
// Fragments: the accumulator of m64nNk16 gives warp w of the warpgroup rows
// 16w..16w+15 in mma.sync's C layout, n-tile j (columns 8j..8j+7) in
// d[4j..4j+3]; an A operand from registers is mma.sync m16n8k16's A
// fragment of the warp's 16 rows (mma_bf16.cuh). So a score accumulator
// turns into the A operand of the next product as bfm::pack_a or
// bfm::split_a of two n-tiles, as on mma.sync.
//
// Shared memory written by threads (cp.async or plain stores) is made
// visible to wgmma, which reads it through the async proxy, by
// fence.proxy.async before the barrier that publishes it.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace wg {

using bfm::bf16;

// byte offset of the 16-byte chunk (row r, columns 8j..8j+7) in a tile of
// `rows` rows
__device__ __forceinline__ int chunk_offset(int r, int j, int rows) {
  return (j >> 3) * rows * 128 + r * 128 + (((j & 7) ^ (r & 7)) << 4);
}

// `rows` rows of width W of a head's slice into a swizzled tile: row r of
// the source at src + (r0 + r) * stride, channels [0, ch) real, the rest
// and the rows at or past T zero. 16-byte cp.async copies when vec (ch,
// the row stride and the base a multiple of 8 elements), else element by
// element (plain stores, done at the next barrier).
template <int rows, int W, int threads>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int r0, int T,
                                          int ch, bool vec) {
  char* base = reinterpret_cast<char*>(dst);
  constexpr int chunks = W / 8;
  if (vec) {
    for (int i = threadIdx.x; i < rows * chunks; i += threads) {
      const int r = i / chunks, j = i - r * chunks, t = r0 + r;
      const bool ok = t < T && 8 * j < ch;
      bfm::cp16(reinterpret_cast<bf16*>(base + chunk_offset(r, j, rows)),
                ok ? src + (long long)t * stride + 8 * j : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * W; i += threads) {
      const int r = i / W, c = i - r * W, t = r0 + r;
      bf16* d = reinterpret_cast<bf16*>(base + chunk_offset(r, c >> 3, rows)) +
                (c & 7);
      *d = (t < T && c < ch) ? src[(long long)t * stride + c]
                             : __float2bfloat16(0.f);
    }
  }
}

// the matrix descriptor of a 128-byte-swizzled operand at p
__device__ __forceinline__ uint64_t desc(const void* p, int lbo_bytes,
                                         int sbo_bytes) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A K-major operand tile (rows x W) at p; its k-step kk starts k_step(rows,
// kk) further on (the descriptor's address field counts 16 bytes, and
// every tile lies below 256 KB, so the sum stays in the field)
__device__ __forceinline__ uint64_t desc_k(const bf16* p) {
  return desc(p, 16, 1024);
}
__host__ __device__ constexpr uint64_t k_step(int rows, int kk) {
  return (uint64_t)((kk >> 2) * rows * 128 + (kk & 3) * 32) >> 4;
}

// An MN-major operand tile (rows along k, W columns along n) at p; its
// k-step kk (16 rows) starts mn_step(kk) further on
__device__ __forceinline__ uint64_t desc_mn(const bf16* p, int rows) {
  return desc(p, rows * 128, 1024);
}
__host__ __device__ constexpr uint64_t mn_step(int kk) {
  return (uint64_t)kk * 16 * 128 >> 4;
}

// the first 1,024-byte boundary at or after p (the swizzle's atoms)
__device__ __forceinline__ char* align1024(void* p) {
  return reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// n-tiles a[N/8][4] of an m64nN accumulator as wgmma's N/2 registers
template <int N>
__device__ __forceinline__ float (&flat(float (&a)[N / 8][4]))[N / 2] {
  return *reinterpret_cast<float(*)[N / 2]>(&a[0][0]);
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) a[n][0] = a[n][1] = a[n][2] = a[n][3] = 0.f;
}

// 2^x on the SFU (ex2.approx: about 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}
// Ties each register of an accumulator (or of a register A operand) to
// this point of the program, so that the compiler moves no instruction that
// reads or defines it across (CUTLASS's warpgroup_fence_operand). Before
// wgmma.fence it keeps the other instructions that define the operands out
// of the products' pipeline stage, where ptxas would serialise the products
// (C7515); after wgmma.wait_group it keeps their readers after the wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// threads' shared-memory writes, before the barrier, for wgmma's reads
__device__ __forceinline__ void fence_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The accumulator operand lists of the three widths
#define WG_D16(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WG_D32(d)                                                            \
  WG_D16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
      "+f"(d[30]), "+f"(d[31])
#define WG_D64(d)                                                            \
  WG_D32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),             \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
// ... as outputs only
#define WG_W32(d)                                                            \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),    \
      "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]),           \
      "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),       \
      "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),       \
      "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),       \
      "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),       \
      "=f"(d[31])
#define WG_W64(d)                                                            \
  WG_W32(d), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),             \
      "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]),       \
      "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]),       \
      "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]),       \
      "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),       \
      "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]),       \
      "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
#define WG_R16                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_R32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"
#define WG_R64                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A B, A (64 x 16) and B (16 x N) from shared memory, both K-major;
// acc = 0 overwrites d
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int acc);

// (the operand numbers after the N/2 accumulators: A, B, acc)
#define WG_SS(N, RL, DL, IA, IB, IC)                                         \
  template <>                                                                \
  __device__ __forceinline__ void mma_ss<N>(float(&d)[N / 2], uint64_t a,    \
                                            uint64_t b, int acc) {           \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %" IC ", 0;\n"                     \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " RL       \
        ", %" IA ", %" IB ", p, 1, 1, 0, 0;\n}\n"                             \
        : DL(d)                                                              \
        : "l"(a), "l"(b), "r"(acc));                                         \
  }

// d = A B, A (64 x 16) and B (16 x N) from shared memory, both K-major:
// the first k-step of a product whose accumulator enters it holding
// nothing (its registers are outputs only, so that no instruction that
// wrote them last is tied to the product)
template <int N>
__device__ __forceinline__ void mma_ss_first(float (&d)[N / 2], uint64_t a,
                                             uint64_t b);

// (the operand numbers after the N/2 accumulators: A, B, a zero)
#define WG_SS0(N, RL, DL, IA, IB, IC)                                        \
  template <>                                                                \
  __device__ __forceinline__ void mma_ss_first<N>(float(&d)[N / 2],          \
                                                  uint64_t a, uint64_t b) {  \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %" IC ", 0;\n"                     \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " RL       \
        ", %" IA ", %" IB ", p, 1, 1, 0, 0;\n}\n"                             \
        : DL(d)                                                              \
        : "l"(a), "l"(b), "r"(0));                                           \
  }

// d (+)= A B, A (64 x 16) from registers (a: the warp's mma.sync A
// fragment), B (16 x N) from shared memory, MN-major
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int acc);

// (the operand numbers after the N/2 accumulators: a0..a3, B, acc)
#define WG_RS(N, RL, DL, I0, I1, I2, I3, IB, IC)                             \
  template <>                                                                \
  __device__ __forceinline__ void mma_rs<N>(                                 \
      float(&d)[N / 2], const uint32_t(&a)[4], uint64_t b, int acc) {        \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %" IC ", 0;\n"                     \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " RL       \
        ", {%" I0 ", %" I1 ", %" I2 ", %" I3 "}, %" IB ", p, 1, 1, 1;\n}\n"   \
        : DL(d)                                                              \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));     \
  }

// the score products (N = the streamed tile's rows: 32, 64 or 128) and the
// products into the head width (N = W: 64 or 128)
WG_SS(32, WG_R16, WG_D16, "16", "17", "18")
WG_SS(64, WG_R32, WG_D32, "32", "33", "34")
WG_SS(128, WG_R64, WG_D64, "64", "65", "66")
WG_SS0(64, WG_R32, WG_W32, "32", "33", "34")
WG_SS0(128, WG_R64, WG_W64, "64", "65", "66")
WG_RS(64, WG_R32, WG_D32, "32", "33", "34", "35", "36", "37")
WG_RS(128, WG_R64, WG_D64, "64", "65", "66", "67", "68", "69")

// the accumulator lists of the widths below 16 and above 64 registers, and
// their register lists (the score products of attnblock.cu's bf16 K3)
#define WG_D8(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),                \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define WG_D96(d)                                                            \
  WG_D64(d), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), \
      "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),       \
      "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),       \
      "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),       \
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]),       \
      "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]),       \
      "+f"(d[94]), "+f"(d[95])
#define WG_D128(d)                                                           \
  WG_D96(d), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), \
      "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),  \
      "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),  \
      "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),  \
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),  \
      "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),  \
      "+f"(d[126]), "+f"(d[127])
#define WG_R8                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define WG_R96                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "       \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "        \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "        \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "        \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "        \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "        \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "        \
  "%93, %94, %95}"
#define WG_R128                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "       \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "        \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "        \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "        \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "        \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "        \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "        \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "        \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "       \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "       \
  "%127}"

// d (+)= A B, A (64 x 16) from registers (a: the warp's mma.sync A
// fragment), B (16 x N) from shared memory, K-major (attnblock.cu's bf16
// K3: the weights stored as W^T, K of the scores, V^T of P V)
template <int N>
__device__ __forceinline__ void mma_rs_k(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int acc);

// (the operand numbers after the N/2 accumulators: a0..a3, B, acc)
#define WG_RSK(N, RL, DL, I0, I1, I2, I3, IB, IC)                            \
  template <>                                                                \
  __device__ __forceinline__ void mma_rs_k<N>(                               \
      float(&d)[N / 2], const uint32_t(&a)[4], uint64_t b, int acc) {        \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %" IC ", 0;\n"                     \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " RL       \
        ", {%" I0 ", %" I1 ", %" I2 ", %" I3 "}, %" IB ", p, 1, 1, 0;\n}\n"   \
        : DL(d)                                                              \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));     \
  }

WG_RSK(16, WG_R8, WG_D8, "8", "9", "10", "11", "12", "13")
WG_RSK(32, WG_R16, WG_D16, "16", "17", "18", "19", "20", "21")
WG_RSK(64, WG_R32, WG_D32, "32", "33", "34", "35", "36", "37")
WG_RSK(128, WG_R64, WG_D64, "64", "65", "66", "67", "68", "69")
WG_RSK(192, WG_R96, WG_D96, "96", "97", "98", "99", "100", "101")
WG_RSK(256, WG_R128, WG_D128, "128", "129", "130", "131", "132", "133")

// ... as outputs only, for the first k-step of a product (attnblock.cu)
#define WG_W8(d)                                                             \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),                \
      "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
#define WG_W16(d)                                                            \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),                \
      "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),            \
      "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),       \
      "=f"(d[15])
#define WG_W96(d)                                                            \
  WG_W64(d), "=f"(d[64]), "=f"(d[65]), "=f"(d[66]), "=f"(d[67]), "=f"(d[68]), \
      "=f"(d[69]), "=f"(d[70]), "=f"(d[71]), "=f"(d[72]), "=f"(d[73]),       \
      "=f"(d[74]), "=f"(d[75]), "=f"(d[76]), "=f"(d[77]), "=f"(d[78]),       \
      "=f"(d[79]), "=f"(d[80]), "=f"(d[81]), "=f"(d[82]), "=f"(d[83]),       \
      "=f"(d[84]), "=f"(d[85]), "=f"(d[86]), "=f"(d[87]), "=f"(d[88]),       \
      "=f"(d[89]), "=f"(d[90]), "=f"(d[91]), "=f"(d[92]), "=f"(d[93]),       \
      "=f"(d[94]), "=f"(d[95])
#define WG_W128(d)                                                           \
  WG_W96(d), "=f"(d[96]), "=f"(d[97]), "=f"(d[98]), "=f"(d[99]), "=f"(d[100]), \
      "=f"(d[101]), "=f"(d[102]), "=f"(d[103]), "=f"(d[104]), "=f"(d[105]),  \
      "=f"(d[106]), "=f"(d[107]), "=f"(d[108]), "=f"(d[109]), "=f"(d[110]),  \
      "=f"(d[111]), "=f"(d[112]), "=f"(d[113]), "=f"(d[114]), "=f"(d[115]),  \
      "=f"(d[116]), "=f"(d[117]), "=f"(d[118]), "=f"(d[119]), "=f"(d[120]),  \
      "=f"(d[121]), "=f"(d[122]), "=f"(d[123]), "=f"(d[124]), "=f"(d[125]),  \
      "=f"(d[126]), "=f"(d[127])

// d = A B, A (64 x 16) from registers, B (16 x N) K-major (mma_rs_k's
// first k-step: its accumulator holds nothing on entry, so that no earlier
// value of it is kept live across the instructions before the product)
template <int N>
__device__ __forceinline__ void mma_rs_k_first(float (&d)[N / 2],
                                               const uint32_t (&a)[4],
                                               uint64_t b);
// the same with B MN-major (mma_rs's first k-step)
template <int N>
__device__ __forceinline__ void mma_rs_first(float (&d)[N / 2],
                                             const uint32_t (&a)[4],
                                             uint64_t b);

// (the operand numbers after the N/2 accumulators: a0..a3, B, a zero)
#define WG_RS0(NAME, TB, N, RL, DL, I0, I1, I2, I3, IB, IC)                 \
  template <>                                                                \
  __device__ __forceinline__ void NAME<N>(                                   \
      float(&d)[N / 2], const uint32_t(&a)[4], uint64_t b) {                 \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %" IC ", 0;\n"                     \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " RL       \
        ", {%" I0 ", %" I1 ", %" I2 ", %" I3 "}, %" IB ", p, 1, 1, " #TB     \
        ";\n}\n"                                                             \
        : DL(d)                                                              \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));       \
  }

WG_RS0(mma_rs_k_first, 0, 16, WG_R8, WG_W8, "8", "9", "10", "11", "12", "13")
WG_RS0(mma_rs_k_first, 0, 32, WG_R16, WG_W16, "16", "17", "18", "19", "20",
       "21")
WG_RS0(mma_rs_k_first, 0, 64, WG_R32, WG_W32, "32", "33", "34", "35", "36",
       "37")
WG_RS0(mma_rs_k_first, 0, 128, WG_R64, WG_W64, "64", "65", "66", "67", "68",
       "69")
WG_RS0(mma_rs_k_first, 0, 192, WG_R96, WG_W96, "96", "97", "98", "99", "100",
       "101")
WG_RS0(mma_rs_k_first, 0, 256, WG_R128, WG_W128, "128", "129", "130", "131",
       "132", "133")
WG_RS0(mma_rs_first, 1, 64, WG_R32, WG_W32, "32", "33", "34", "35", "36",
       "37")

#undef WG_SS
#undef WG_SS0
#undef WG_W32
#undef WG_W64
#undef WG_RS
#undef WG_D16
#undef WG_D32
#undef WG_D64
#undef WG_R16
#undef WG_R32
#undef WG_R64
#undef WG_RSK
#undef WG_D8
#undef WG_D96
#undef WG_D128
#undef WG_R8
#undef WG_R96
#undef WG_R128
#undef WG_RS0
#undef WG_W8
#undef WG_W16
#undef WG_W96
#undef WG_W128

}  // namespace wg
