// Helpers shared by the bf16 tensor-core kernels (attnblock.cu's bf16 K3;
// the bf16 entries of attention.cu, flash_fwd.cu and attention_bwd.cu, all
// on wgmma, whose register A operand is mma.sync m16n8k16's A fragment):
// that fragment's loads from shared memory, the rounding to bf16, 16-byte
// cp.async, and the split of an fp32 operand into two bf16 halves.
//
// Fragments of mma.sync.m16n8k16 with bf16 operands, for lane = 4*g + q
// (g = lane >> 2, q = lane & 3), two bf16 to a register (the lower k
// first):
//   A (16x16, row-major)    a0 (g, 2q..2q+1)  a1 (g+8, 2q..2q+1)
//                           a2 (g, 2q+8..2q+9)  a3 (g+8, 2q+8..2q+9)
//   B (16x8, "col": B[k][n]) b0 (k=2q..2q+1, n=g)  b1 (k=2q+8..2q+9, n=g)
//   C (16x8)                c0 (g, 2q)  c1 (g, 2q+1)  c2 (g+8, 2q)
//                           c3 (g+8, 2q+1)
// So two C tiles side by side (columns 0-7 and 8-15), rounded to bf16 in
// pairs, are the A fragment of a product over those 16 columns, with no
// shuffle (pack_a).
//
// The products of two bf16 are exact in fp32, so a product whose operands
// are bf16 values costs one mma and keeps fp32 accuracy up to the sums. An
// fp32 operand x goes in as hi = bf16(x) and lo = bf16(x - hi) (two mma):
// hi + lo holds x to about 2^-17 of |x|, far below bf16's 2^-9.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bfm {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two adjacent bf16 (4-byte aligned) as one register
__device__ __forceinline__ uint32_t ld2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Wait until at most n of this thread's cp.async groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// The A fragment of rows g, g + 8 and k 0..15 of a row-major tile at p
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* p,
                                       int ld, int g, int q4) {
  const bf16* r0 = p + g * ld + 2 * q4;
  const bf16* r1 = r0 + 8 * ld;
  a[0] = ld2(r0);
  a[1] = ld2(r1);
  a[2] = ld2(r0 + 8);
  a[3] = ld2(r1 + 8);
}

// The A fragment of the 16 columns held by two C tiles, rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// x0, x1 as the bf16 pairs hi = bf16(x) and lo = bf16(x - hi)
__device__ __forceinline__ void split2(uint32_t& hi, uint32_t& lo, float x0,
                                       float x1) {
  hi = pack(x0, x1);  // bf16(x0) in the low half, bf16(x1) in the high
  lo = pack(x0 - __uint_as_float(hi << 16),
            x1 - __uint_as_float(hi & 0xffff0000u));
}

// pack_a of fp32 values as the two halves
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float (&c0)[4],
                                        const float (&c1)[4]) {
  split2(hi[0], lo[0], c0[0], c0[1]);
  split2(hi[1], lo[1], c0[2], c0[3]);
  split2(hi[2], lo[2], c1[0], c1[1]);
  split2(hi[3], lo[3], c1[2], c1[3]);
}

__device__ __forceinline__ void cp16(bf16* dst, const bf16* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

}  // namespace bfm
