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
// (12 bytes) for 6 flops, far below the card's ~20 flops/byte fp32 balance
// point. At the serve path's shape (B=1024, d=256) it moves ~3.1 MB, ~0.9 us
// at 3.35 TB/s, so the launch itself weighs as much as the bytes.
//
// Design, two plans that the host picks from the shape (choose below,
// mirrored by ops/kernels/circulant.py circulant_plan):
//  - warp plan, d % 32 == 0 and d <= 1,024 (the serve path's d = 256): one
//    warp per row, each lane holding d/32 consecutive floats of y and w in
//    registers (a template parameter), loaded once, as float4 where
//    d % 128 == 0 and the rows are 16-byte aligned; the neighbours across
//    lanes come by one shuffle each way (circ_row.cuh), sqrt(beta) is read
//    once per row. Eight rows per block, so the serve shape's 1,024 rows are
//    128 blocks: one wave on 132 SMs.
//  - general plan, any other d: one thread per element, consecutive threads
//    on consecutive columns, the neighbours read again through L1.
// Each product is rounded separately (__fmul_rn / __fsub_rn, no FMA
// contraction) in the same order as the plain PyTorch version, so both
// plans agree with it bit for bit.

#include "circ_row.cuh"

namespace {

constexpr int kThreads = 256;  // general plan: threads (elements) per block
constexpr int kRows = 8;       // warp plan: rows (warps) per block

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
  out[idx] =
      __fmul_rn(circ::kCoef, __fsub_rn(__fmul_rn(yb_next, w[idx]), ybw_prev));
}

template <int V, bool VEC>
__global__ void __launch_bounds__(kRows * 32)
    circulant_apply_warp_kernel(const float* __restrict__ sb,
                                const float* __restrict__ y,
                                const float* __restrict__ w,
                                float* __restrict__ out, long long rows) {
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp: its shuffles stay full
  const int lane = threadIdx.x & 31;
  const long long off = row * (32 * V);
  float yv[V], wv[V], k[V];
  circ::load_row<V, VEC>(y + off, lane, yv);
  circ::load_row<V, VEC>(w + off, lane, wv);
  circ::stencil<V>(sb[row], yv, wv, k, lane);
  circ::store_row<V, VEC>(out + off, lane, k);
}

using WarpKernel = void (*)(const float*, const float*, const float*, float*,
                            long long);

// the warp kernel for V floats per lane (vec: float4 loads)
template <int V>
WarpKernel warp_kernel(int v, bool vec) {
  if constexpr (V == 0) {
    return nullptr;
  } else {
    if (v == V)
      return vec ? circulant_apply_warp_kernel<V, V % 4 == 0>
                 : circulant_apply_warp_kernel<V, false>;
    return warp_kernel<V - 1>(v, vec);
  }
}

// ops/kernels/circulant.py circulant_plan is this function in Python
circ::Plan choose(long long rows, long long d, bool aligned) {
  const int v = circ::per_lane(d);
  if (v)
    return {circ::kWarp, v, (v % 4 == 0 && aligned) ? 4 : 1, kRows,
            circ::cdiv(rows, kRows), 0};
  return {circ::kGeneral, 0, 1, 0, circ::cdiv(rows * d, kThreads), 0};
}

}  // namespace

extern "C" int circulant_apply_f32(const float* sb, const float* y,
                                   const float* w, float* out, long long rows,
                                   long long d, void* stream) {
  if (rows == 0 || d == 0) return 0;
  const circ::Plan p = choose(
      rows, d,
      circ::aligned16(y) && circ::aligned16(w) && circ::aligned16(out));
  cudaStream_t st = (cudaStream_t)stream;
  if (p.kind == circ::kWarp) {
    const WarpKernel k =
        warp_kernel<circ::kMaxPerLane>((int)p.per_lane, p.vec == 4);
    k<<<(unsigned int)p.blocks, kRows * 32, 0, st>>>(sb, y, w, out, rows);
  } else {
    circulant_apply_kernel<<<(unsigned int)p.blocks, kThreads, 0, st>>>(
        sb, y, w, out, rows, d);
  }
  return (int)cudaGetLastError();
}

// The plan for rows of d floats (kind, per_lane, vec, rows per block,
// blocks, in_smem), for the card tests to hold the Python mirror to.
extern "C" int circulant_plan(long long rows, long long d, int aligned,
                              long long* plan) {
  circ::write_plan(choose(rows, d, aligned != 0), plan);
  return 0;
}
