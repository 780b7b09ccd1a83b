// K1: circulant-G diffusion stencil, float32.
//
//   out[b, i] = c * ( sb[b]*y[b, i+1] * w[b, i]  -  (sb[b]*y[b, i-1]) * w[b, i-1] )
//
// with wrap-around neighbours (i +- 1) mod d and c = sqrt(2)/2.
//
// Replaces: the Pallas kernel _circ_kernel / _circ_pallas in
// sdeflow_tpu/ops/pallas/circulant.py:35-64 (entry circulant_apply :67-75),
// which tiles 256 rows into VMEM and builds the neighbours with pltpu.roll.
//
// Bound on the H100: bytes. Per element it reads y and w and writes out
// (12 bytes; the neighbours come from L1/L2) for 6 flops, far below the
// card's ~20 flops/byte fp32 balance point. At the serve path's shape
// (B=1024, d=256) it moves ~3.1 MB, ~0.9 us at 3.35 TB/s, so the launch
// itself dominates.
//
// Design: one thread per element, consecutive threads on consecutive
// columns, so the loads of y, w and the neighbours are coalesced. Each
// product is rounded separately (__fmul_rn / __fsub_rn, no FMA
// contraction) in the same order as the plain PyTorch version, so the two
// agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr float kCoef = 0.70710678118654752440f;

__global__ void circulant_apply_kernel(const float* __restrict__ sb,
                                       const float* __restrict__ y,
                                       const float* __restrict__ w,
                                       float* __restrict__ out,
                                       long long rows, long long d) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * d) return;
  long long row = idx / d;
  long long col = idx - row * d;
  long long base = row * d;
  long long nxt = base + (col + 1 == d ? 0 : col + 1);
  long long prv = base + (col == 0 ? d - 1 : col - 1);
  float s = sb[row];
  float yb_next = __fmul_rn(s, y[nxt]);
  float ybw_prev = __fmul_rn(__fmul_rn(s, y[prv]), w[prv]);
  out[idx] = __fmul_rn(kCoef, __fsub_rn(__fmul_rn(yb_next, w[idx]), ybw_prev));
}

}  // namespace

extern "C" int circulant_apply_f32(const float* sb, const float* y,
                                   const float* w, float* out, long long rows,
                                   long long d, void* stream) {
  long long n = rows * d;
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  circulant_apply_kernel<<<(unsigned int)blocks, threads, 0,
                           (cudaStream_t)stream>>>(sb, y, w, out, rows, d);
  return (int)cudaGetLastError();
}
