// K5: GroupNorm (+SiLU), float32, channels-first.
//
//   h[b, c, s] = (x[b, c, s] - mean[b, g]) * rstd[b, g] * gamma[c] + beta[c]
//   out        = silu ? h / (1 + exp(-h)) : h,        g = c / (C/G)
//
// mean and the variance of each (sample, group) slab in fp32, the variance
// in two passes (the one-pass E[x^2] - E[x]^2 form loses about three digits),
// rstd = rsqrt(var + 1e-5).
//
// Replaces: the Pallas kernel _gn_kernel / _gn_pallas in
// sdeflow_tpu/ops/pallas/groupnorm.py:78-136 (entry group_norm_silu
// :139-144). The TPU kernel takes channels-last (B, S, C) tiles and moves
// statistics between channels and groups with one-hot matmuls, because
// Mosaic will not split the lane dimension. Here the layout is
// channels-first (B, C, S): one (sample, group) is one contiguous slab of
// (C/G)*S floats, and no matmul or transpose is needed.
//
// Bound on the H100: bytes. Per element it reads x and writes out (8 bytes)
// for ~10 flops, below the card's ~20 flops/byte fp32 balance point. At the
// grf16 U-Net's shapes a slab holds 64 to 768 floats.
//
// Design: one warp per slab, 8 slabs per block of 256 threads, so the small
// slabs keep every lane busy where one block per slab would idle most
// threads. A slab of up to 32*kRegs floats is held in registers (lane i
// takes elements i, i+32, ...: coalesced loads), so x is read once; the two
// statistics are warp-shuffle sums. A larger slab takes three coalesced
// passes over device memory (sum, squared deviations, apply), so any
// (B, C, S) runs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRegs = 32;  // floats of a slab each lane holds: slabs <= 1024
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float normalize(float v, float mean, float rstd,
                                           float gamma, float beta,
                                           bool silu) {
  const float h = (v - mean) * rstd * gamma + beta;
  return silu ? h / (1.f + expf(-h)) : h;
}

__global__ void __launch_bounds__(kThreads)
gn_silu_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, float* __restrict__ out,
               long long slabs, int G, int cg, int S, int silu) {
  const int lane = threadIdx.x & 31;
  const long long slab = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (slab >= slabs) return;  // the whole warp leaves together
  const int n = cg * S;
  const int c0 = (int)(slab % G) * cg;
  const float* xs = x + slab * n;
  float* os = out + slab * n;
  const bool act = silu != 0;

  if (n <= 32 * kRegs) {
    float v[kRegs];
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int i = lane + 32 * r;
      v[r] = i < n ? xs[i] : 0.f;
      s += v[r];
    }
    const float mean = warp_sum(s) / (float)n;
    float q = 0.f;
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const float d = v[r] - mean;
      if (lane + 32 * r < n) q = fmaf(d, d, q);
    }
    const float rstd = rsqrtf(warp_sum(q) / (float)n + kEps);
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int i = lane + 32 * r;
      if (i < n) {
        const int c = c0 + i / S;
        os[i] = normalize(v[r], mean, rstd, __ldg(gamma + c), __ldg(beta + c),
                          act);
      }
    }
    return;
  }

  float s = 0.f;
  for (int i = lane; i < n; i += 32) s += xs[i];
  const float mean = warp_sum(s) / (float)n;
  float q = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float d = xs[i] - mean;
    q = fmaf(d, d, q);
  }
  const float rstd = rsqrtf(warp_sum(q) / (float)n + kEps);
  for (int i = lane; i < n; i += 32) {
    const int c = c0 + i / S;
    os[i] = normalize(xs[i], mean, rstd, __ldg(gamma + c), __ldg(beta + c),
                      act);
  }
}

}  // namespace

extern "C" int group_norm_silu_f32(const float* x, const float* gamma,
                                   const float* beta, float* out, long long B,
                                   int C, int G, int S, int silu,
                                   void* stream) {
  const long long slabs = B * G;
  if (slabs == 0 || S == 0) return 0;
  const long long blocks = (slabs + kWarps - 1) / kWarps;
  gn_silu_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, gamma, beta, out, slabs, G, C / G, S, silu);
  return (int)cudaGetLastError();
}
