// K3: the whole U-Net AttentionBlock in one kernel, float32.
//
//   h   = GroupNorm(x)                     (fp32 two-pass statistics, eps 1e-5)
//   qkv = h @ Wqkv + bqkv                  (C -> 3C; head hh owns the
//                                           interleaved slice [q_h k_h v_h])
//   o_h = softmax((q_h s)(k_h s)^T) v_h    (s = ch^-1/4, per head)
//   out = x + o @ Wproj + bproj
//
// Replaces: the Pallas kernel _attn_block_kernel / _attn_block_pallas in
// sdeflow_tpu/ops/pallas/attnblock.py:75-250 (entry fused_attention_block
// :256-265). The TPU kernel packs several samples into one block-diagonal
// attention and broadcasts group statistics through one-hot matmuls; both
// work around the TPU's 128-wide matrix unit and Mosaic's reshape limits and
// have no reason to exist here.
//
// Bound on the H100: operations. At the serve path's shapes, (B, 64, 64)
// and (B, 16, 128), a sample costs ~3.2 and ~2.2 MFLOP against 32 KB and
// 16 KB of x in and out, 100-140 flops per byte, above the fp32 balance
// point (67 TFLOP/s over 3.35 TB/s = 20 flops/byte).
//
// Design: one thread block per sample, everything between the read of x
// and the write of the output stays in shared memory: h (then the attention
// output O), the scaled K (rows padded to C+1 so the score loop is free of
// bank conflicts), V, a chunk of tq scaled Q rows, one score row per warp and
// the group statistics. tq = T unless the working set would exceed the
// block's 227 KB (T = 256 at C = 64 takes tq = 64). The three projections
// are one routine: each thread owns 8 rows x 1 output column, reads the
// weight column through L1/L2 (coalesced across the warp) and the 8 input
// rows from shared memory (a broadcast). Attention is one warp per
// (head, query row): lanes split the keys for the scores and softmax, then
// the channels for P·V. All arithmetic is fp32 on the CUDA cores; wgmma/TMA
// and tensor cores are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // rows per thread in the projections
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// value(r, n) = sum_k in[r*ldin + k] * W[k*ldw + col(n)] + bias[col(n)] for
// r < rows, n < ncols, handed to store(r, n, value).
template <class Col, class Store>
__device__ __forceinline__ void project(const float* in, int ldin, int rows,
                                        int K, const float* __restrict__ W,
                                        int ldw,
                                        const float* __restrict__ bias,
                                        int ncols, Col col, Store store) {
  const int nrc = (rows + kRows - 1) / kRows;
  for (int item = threadIdx.x; item < nrc * ncols; item += kThreads) {
    const int n = item % ncols;
    const int r0 = (item / ncols) * kRows;
    const int j = col(n);
    const float* rowp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) rowp[r] = in + min(r0 + r, rows - 1) * ldin;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    const float* wj = W + j;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float wv = __ldg(wj + (size_t)k * ldw);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(rowp[r][k], wv, acc[r]);
    }
    const float bj = __ldg(bias + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r0 + r < rows) store(r0 + r, n, acc[r] + bj);
  }
}

__global__ void __launch_bounds__(kThreads)
attn_block_kernel(const float* __restrict__ x,
                  const float* __restrict__ gn_scale,
                  const float* __restrict__ gn_bias,
                  const float* __restrict__ wqkv,
                  const float* __restrict__ bqkv,
                  const float* __restrict__ wproj,
                  const float* __restrict__ bproj, float* __restrict__ out,
                  int T, int C, int G, int heads, int tq, float scale) {
  extern __shared__ float smem[];
  const int ldk = C + 1;
  float* hs = smem;             // T*C: x, then h = GN(x), then O
  float* ks = hs + T * C;       // T*(C+1): scaled K
  float* vs = ks + T * ldk;     // T*C: V
  float* qs = vs + T * C;       // tq*C: scaled Q chunk
  float* ss = qs + tq * C;      // kWarps*T: one score row per warp
  float* csum = ss + kWarps * T;  // C: per-channel sums
  float* mean = csum + C;       // G
  float* rstd = mean + G;       // G

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int TC = T * C;
  const float* xb = x + (size_t)blockIdx.x * TC;
  float* ob = out + (size_t)blockIdx.x * TC;

  for (int i = tid; i < TC; i += kThreads) hs[i] = xb[i];
  __syncthreads();

  // GroupNorm statistics: channel sums (conflict-free), then group sums
  const int cg = C / G;
  const float n_inv = 1.f / (float)(T * cg);
  for (int c = tid; c < C; c += kThreads) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += hs[t * C + c];
    csum[c] = s;
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float s = 0.f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) s += csum[c];
    mean[g] = s * n_inv;
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    const float m = mean[c / cg];
    float s = 0.f;
    for (int t = 0; t < T; ++t) {
      const float d = hs[t * C + c] - m;
      s = fmaf(d, d, s);
    }
    csum[c] = s;
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float s = 0.f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) s += csum[c];
    rstd[g] = rsqrtf(s * n_inv + kEps);
  }
  __syncthreads();
  for (int i = tid; i < TC; i += kThreads) {
    const int c = i % C, g = c / cg;
    hs[i] = (hs[i] - mean[g]) * rstd[g] * __ldg(gn_scale + c) + __ldg(gn_bias + c);
  }
  __syncthreads();

  // K (scaled) and V for every row; n runs over [k_h v_h] of each head
  const int ch = C / heads;
  project(hs, C, T, C, wqkv, 3 * C, bqkv, 2 * C,
          [=](int n) { return (n / (2 * ch)) * 3 * ch + ch + n % (2 * ch); },
          [=](int t, int n, float v) {
            const int hh = n / (2 * ch), r = n % (2 * ch);
            if (r < ch)
              ks[t * ldk + hh * ch + r] = v * scale;
            else
              vs[t * C + hh * ch + r - ch] = v;
          });

  for (int t0 = 0; t0 < T; t0 += tq) {
    const int rows = min(tq, T - t0);
    __syncthreads();  // K/V written; previous chunk's Q and O consumed
    project(hs + t0 * C, C, rows, C, wqkv, 3 * C, bqkv, C,
            [=](int n) { return (n / ch) * 3 * ch + n % ch; },
            [=](int t, int n, float v) { qs[t * C + n] = v * scale; });
    __syncthreads();

    // attention, one warp per (head, query row); O overwrites this chunk's h
    for (int item = warp; item < heads * rows; item += kWarps) {
      const int hh = item / rows, tl = item % rows;
      const float* q = qs + tl * C + hh * ch;
      float* s = ss + warp * T;
      float mx = -INFINITY;
      for (int j = lane; j < T; j += 32) {
        const float* kr = ks + j * ldk + hh * ch;
        float acc = 0.f;
        for (int c = 0; c < ch; ++c) acc = fmaf(q[c], kr[c], acc);
        s[j] = acc;
        mx = fmaxf(mx, acc);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < T; j += 32) {
        const float e = expf(s[j] - mx);
        s[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < T; j += 32) s[j] = s[j] / sum;
      __syncwarp();
      float* o = hs + (t0 + tl) * C + hh * ch;
      for (int c = lane; c < ch; c += 32) {
        float acc = 0.f;
        for (int j = 0; j < T; ++j) acc = fmaf(s[j], vs[j * C + hh * ch + c], acc);
        o[c] = acc;
      }
      __syncwarp();
    }
    __syncthreads();

    // output projection + residual, straight to device memory
    project(hs + t0 * C, C, rows, C, wproj, C, bproj, C,
            [](int n) { return n; },
            [=](int t, int n, float v) {
              const int i = (t0 + t) * C + n;
              ob[i] = xb[i] + v;
            });
  }
}

}  // namespace

extern "C" int attn_block_f32(const float* x, const float* gn_scale,
                              const float* gn_bias, const float* wqkv,
                              const float* bqkv, const float* wproj,
                              const float* bproj, float* out, int B, int T,
                              int C, int G, int heads, int tq, int smem,
                              float scale, void* stream) {
  if (B == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      attn_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attn_block_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      x, gn_scale, gn_bias, wqkv, bqkv, wproj, bproj, out, T, C, G, heads, tq,
      scale);
  return (int)cudaGetLastError();
}
