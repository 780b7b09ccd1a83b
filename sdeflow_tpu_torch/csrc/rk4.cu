// K2: one fused RK4 step of the zero-drift circulant flow, float32.
//
//   k_s   = c * ( roll(sb_s*x_s, -1)*w  -  roll(sb_s*x_s*w, +1) )
//   x_1 = x,  x_2 = x + 0.5*k1,  x_3 = x + 0.5*k2,  x_4 = x + k3
//   sb_1 = sb3[b,0],  sb_2 = sb_3 = sb3[b,1],  sb_4 = sb3[b,2]
//   out = x + (k1 + 2*k2 + 2*k3 + k4) * (1/6)
//
// with wrap-around neighbours within each row and c = sqrt(2)/2.
//
// Replaces: the Pallas kernel _rk4_kernel / _rk4_pallas in
// sdeflow_tpu/ops/pallas/circulant.py:98-133 (entry circulant_rk4_step
// :136-146), which holds a 256-row tile in VMEM and builds the neighbours
// of each stage with pltpu.roll.
//
// Bound on the H100: bytes. It reads sb3, x and w once and writes out
// (about 12 bytes per element) for 36 flops per element; at the training
// shape (B=128, d=256) that is ~0.39 MB, ~0.12 us at 3.35 TB/s, so the
// launch itself dominates. What the fusion saves is launches: the plain
// composition takes about 20 elementwise kernels per step.
//
// Design: stage s needs neighbours of the stage state x_s, which other
// threads compute, so a row cannot be split across independent blocks.
// One block owns `rows` whole rows (several when d < 256 threads, one
// otherwise, its threads then looping over the columns). The stage state
// and the stage values k_s live in two buffers of rows*d floats: in dynamic
// shared memory when they fit (16 KB at d=1024), else in a global scratch
// slice of the block. __syncthreads() separates the reads of a stage's
// neighbours from the writes of the next stage state. The running sum
// k1 + 2k2 + 2k3 + k4 is kept in `out`, each element touched only by its
// own thread. Every product and sum is rounded separately (__fmul_rn /
// __fadd_rn, no FMA contraction) in the plain PyTorch version's order, and
// the division by 6 is a product with the float 1/6 as PyTorch's CUDA
// division by a number is, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr float kCoef = 0.70710678118654752440f;
constexpr int kThreads = 256;  // must match _THREADS in circulant.py

__global__ void rk4_step_kernel(const float* __restrict__ sb3,
                                const float* __restrict__ x,
                                const float* __restrict__ w,
                                float* __restrict__ out,
                                float* __restrict__ scratch,
                                long long batch, long long d, long long rows,
                                int in_smem) {
  extern __shared__ float smem[];
  const long long row0 = (long long)blockIdx.x * rows;
  const long long n = rows * d;  // elements this block owns (some masked)
  float* stage = in_smem ? smem : scratch + (long long)blockIdx.x * 2 * n;
  float* kbuf = stage + n;
  const float* xb = x + row0 * d;
  const float* wb = w + row0 * d;
  float* ob = out + row0 * d;

  // k_s at element e of the block from the stage state in `stage`
  auto stage_value = [&](long long e, float s) {
    long long r = e / d, col = e - r * d, base = r * d;
    long long nxt = base + (col + 1 == d ? 0 : col + 1);
    long long prv = base + (col == 0 ? d - 1 : col - 1);
    float yb_next = __fmul_rn(s, stage[nxt]);
    float ybw_prev = __fmul_rn(__fmul_rn(s, stage[prv]), wb[prv]);
    return __fmul_rn(kCoef, __fsub_rn(__fmul_rn(yb_next, wb[e]), ybw_prev));
  };
  auto valid = [&](long long e) { return row0 + e / d < batch; };

  for (long long e = threadIdx.x; e < n; e += blockDim.x)
    if (valid(e)) stage[e] = xb[e];
  __syncthreads();

  // stages 1-3: k_s, the running sum, then the next stage state
  const float half[3] = {0.5f, 0.5f, 1.0f};   // x + half*k_s
  const float weight[3] = {1.0f, 2.0f, 2.0f};  // sum += weight*k_s
  for (int s = 0; s < 3; ++s) {
    for (long long e = threadIdx.x; e < n; e += blockDim.x) {
      if (!valid(e)) continue;
      float sb = sb3[(row0 + e / d) * 3 + (s == 0 ? 0 : 1)];
      float k = stage_value(e, sb);
      kbuf[e] = k;
      ob[e] = s == 0 ? k : __fadd_rn(ob[e], __fmul_rn(weight[s], k));
    }
    __syncthreads();
    for (long long e = threadIdx.x; e < n; e += blockDim.x)
      if (valid(e)) stage[e] = __fadd_rn(xb[e], __fmul_rn(half[s], kbuf[e]));
    __syncthreads();
  }
  // stage 4 and the combine
  for (long long e = threadIdx.x; e < n; e += blockDim.x) {
    if (!valid(e)) continue;
    float k4 = stage_value(e, sb3[(row0 + e / d) * 3 + 2]);
    float sum = __fadd_rn(ob[e], k4);
    ob[e] = __fadd_rn(xb[e], __fmul_rn(sum, 1.0f / 6.0f));
  }
}

}  // namespace

extern "C" int circulant_rk4_step_f32(const float* sb3, const float* x,
                                      const float* w, float* out,
                                      float* scratch, long long batch,
                                      long long d, long long rows,
                                      int in_smem, void* stream) {
  if (batch == 0 || d == 0) return 0;
  long long blocks = (batch + rows - 1) / rows;
  size_t smem = in_smem ? (size_t)(2 * rows * d) * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rk4_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rk4_step_kernel<<<(unsigned int)blocks, kThreads, smem,
                    (cudaStream_t)stream>>>(sb3, x, w, out, scratch, batch, d,
                                            rows, in_smem);
  return (int)cudaGetLastError();
}
