// Helpers shared by the tensor-core attention kernels (flash_fwd.cu,
// attention_bwd.cu): the 3xTF32 split product on mma.sync, the quad
// shuffles that turn an accumulator tile into an A operand, and cp.async.
//
// 3xTF32: each fp32 operand x becomes big = tf32(x) (cvt.rna: the low 13
// mantissa bits rounded to nearest, ties away from zero) and
// small = tf32(x - big); a product is a_small*b_big + a_big*b_small +
// a_big*b_big, each tf32 product exact in the fp32 accumulator. The dropped
// a_small*b_small and the rounding of the small halves leave about 2^-21 of
// each product, against 2^-11 for one TF32 product: close to fp32, which
// the tolerances against the plain fp32 versions need (CUTLASS calls the
// same split OpMultiplyAddFastF32).
//
// The tensor cores do not round their fp32 accumulation to nearest, so the
// error of a chain of mma into one accumulator grows with its length, as
// one-sided rounding would: on the H100 a 4096-key chain (1,536 mma) put
// the forward's output and K7b's dqkv 2.5e-5 and 3.5e-5 of their max from
// the plain fp32 versions (an emulation with rounding toward zero gives the
// same size). The kernels therefore keep chains short and add across them
// in fp32 on the CUDA cores: a score tile's big products and its small
// terms go to two accumulators (mma3_split: 8 mma at the full magnitude
// instead of 24), the forward sums each key tile's P V in a fresh
// accumulator, and the backward moves its dK and dV accumulators to memory
// every few tiles.
//
// Fragments of mma.sync.m16n8k8 with tf32 operands, for lane = 4*g + q
// (g = lane >> 2, q = lane & 3):
//   A (16x8, row-major)  a0 (g, q)  a1 (g+8, q)  a2 (g, q+4)  a3 (g+8, q+4)
//   B (8x8, "col": B[k][n]) b0 (k=q, n=g)  b1 (k=q+4, n=g)
//   C (16x8)             c0 (g, 2q)  c1 (g, 2q+1)  c2 (g+8, 2q)  c3 (g+8, 2q+1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// Operands already split: an A fragment (4 values) and a B fragment (2).
struct A {
  uint32_t big[4], small[4];
};
struct B {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ A split_a(float a0, float a1, float a2, float a3) {
  A r;
  split(a0, r.big[0], r.small[0]);
  split(a1, r.big[1], r.small[1]);
  split(a2, r.big[2], r.small[2]);
  split(a3, r.big[3], r.small[3]);
  return r;
}

__device__ __forceinline__ B split_b(float b0, float b1) {
  B r;
  split(b0, r.big[0], r.small[0]);
  split(b1, r.big[1], r.small[1]);
  return r;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a*b on a zero accumulator (no registers zeroed per call).
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  const float z = 0.f;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(z));
}

// d += a*b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const A& a, const B& b) {
  mma(d, a.small, b.big[0], b.big[1]);
  mma(d, a.big, b.small[0], b.small[1]);
  mma(d, a.big, b.big[0], b.big[1]);
}

// The same product with the big term into `big` and the two small terms
// into `small`; the caller adds small to big once the chain is done.
__device__ __forceinline__ void mma3_split(float (&big)[4],
                                           float (&small)[4], const A& a,
                                           const B& b) {
  mma(small, a.small, b.big[0], b.big[1]);
  mma(small, a.big, b.small[0], b.small[1]);
  mma(big, a.big, b.big[0], b.big[1]);
}

// acc += a*b in 3xTF32 through a fresh accumulator: the three products go
// into d = 0 and d is added to acc in fp32 on the CUDA cores (rounded to
// nearest), so no mma chain runs longer than three products of one k-step.
// For the attention of K6 and K3 (attn_tile.cuh; flash_fwd.cuh's scores
// for K6 and K7a, and K7b's recomputed scores), whose absolute tolerance
// of 1e-5 a chain of 16 score k-steps (head width 128) exceeds at
// T = 1024, as it did K7a's lse at T = 2048.
__device__ __forceinline__ void mma3_add(float (&acc)[4], const A& a,
                                         const B& b) {
  float d[4];
  mma_zero(d, a.small, b.big[0], b.big[1]);
  mma(d, a.big, b.small[0], b.small[1]);
  mma(d, a.big, b.big[0], b.big[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// The accumulator tile c (16 rows x 8 columns, C layout) as the A operand
// of the next product (its 8 columns become the k index): a0 = c(g, q) sits
// in lane 4g + q/2 as its c0 or c1 (by the parity of q), a2 = c(g, q+4) in
// lane 4g + 2 + q/2; the rows g+8 likewise from c2, c3.
__device__ __forceinline__ A relayout(const float (&c)[4], int lane) {
  const int src0 = (lane & ~3) | ((lane & 3) >> 1), src1 = src0 + 2;
  const bool odd = lane & 1;
  float v[8];  // c0..c3 of lane src0, then of lane src1
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = __shfl_sync(0xffffffffu, c[i], src0);
    v[4 + i] = __shfl_sync(0xffffffffu, c[i], src1);
  }
  return split_a(odd ? v[1] : v[0], odd ? v[3] : v[2], odd ? v[5] : v[4],
                 odd ? v[7] : v[6]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// cp.async of 16 or 4 bytes; src_bytes = 0 writes zeros (rows past T,
// channels past the head width) and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most one group is in flight (the two-stage ring).
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// `rows` rows of width `w` (a multiple of 4) of a head's slice: row r of
// the source at src + (r0 + r) * stride, channels [0, ch) real, the rest
// and the rows at or past T zero; into dst with row stride ld. 16-byte
// copies when vec (ch, the row stride and the base a multiple of 4 floats),
// else 4-byte copies.
template <int rows, int w, int threads>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, long long stride,
                                          int r0, int T, int ch, bool vec) {
  if (vec) {
    constexpr int chunks = w / 4;
    for (int i = threadIdx.x; i < rows * chunks; i += threads) {
      const int r = i / chunks, c = (i - r * chunks) * 4, t = r0 + r;
      const bool ok = t < T && c < ch;
      cp_async16(dst + r * ld + c, ok ? src + (long long)t * stride + c : src,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * w; i += threads) {
      const int r = i / w, c = i - r * w, t = r0 + r;
      const bool ok = t < T && c < ch;
      cp_async4(dst + r * ld + c, ok ? src + (long long)t * stride + c : src,
                ok);
    }
  }
}

}  // namespace tc
