// K7b: the backward of the attention core from the forward's lse, float32.
//
//   per sample b and head hh, with q_h, k_h, v_h the head's interleaved
//   slices [q_h k_h v_h] of each qkv row (width 3*ch), s = ch^-1/4,
//   dO_h the head's slice of dout and lse, delta (B, heads, T):
//   p   = exp((q_h s)(k_h s)^T - lse)          (the softmax, recomputed)
//   dV  = p^T dO_h
//   dS  = p o (dO_h v_h^T - delta)             delta = rowsum(dO_h o O_h)
//   dK  = dS^T (q_h s) s,    dQ = dS (k_h s) s
//   written as dqkv (B, T, 3C) in the layout of qkv: [dq_h dk_h dv_h].
//
// Replaces: the Pallas kernel _flash_bwd_kernel / _attention_flash_bwd in
// sdeflow_tpu/ops/pallas/attention.py:371-452 (K7b), the backward of the
// reverse-mode pair whose forward is K7a (attention.cu,
// qkv_attention_stats_f32). The TPU runs one grid step per sample, in
// order, keeps the whole sample's q, dO, lse and delta in VMEM and carries
// dQ in VMEM across its 128-row key tiles while it writes each tile's dK and
// dV. Hopper's blocks run in parallel and carry nothing between them, so
// the one C entry launches two kernels instead, each owning what it writes:
//
//  (a) dK/dV: one block of 256 threads per (sample, head, tile of 32 keys).
//      It keeps the scaled K tile and the V tile in shared memory and
//      loops over the query tiles of 32 rows (scaled Q, dO, lse, delta in
//      shared memory). Warp w owns keys w, w+8, w+16, w+24 of the tile; for
//      the scores lane i owns query i (Q and dO rows padded to ch+1 floats,
//      so the lanes' reads fall in distinct banks; K and V reads are
//      broadcasts) and forms s, p and dS for the warp's four keys; the p
//      and dS rows go to the warp's rows of shared memory, and then the
//      lanes split the head's channels (up to four each, ch <= 128) to
//      accumulate dV += p^T dO and dK += dS^T (q s) in registers.
//  (b) dQ: one block per (sample, head, tile of 32 queries), the same shape
//      with the roles of queries and keys swapped: scaled Q, dO, lse and
//      delta of the tile stay in shared memory, the K and V tiles (padded)
//      stream through it, lane j owns key j for the scores, and the lanes
//      split the channels to accumulate dQ += dS (k s).
//
// No atomics: every output element has one writer, so the result is the
// same on every run. The two passes recompute s and dO v^T, which the TPU's
// one pass forms once: 14 T^2 ch flops per head and sample against 10 of
// the algorithm. Tensor cores and a single pass are later work.
//
// Bound on the H100: operations at the U-Net's T = 4096 (10 T^2 ch flops
// per head and sample, against 4 (7C + 2 heads) bytes per row: ~1,000
// flops/byte at T = 4096, C = 64, far above the fp32 balance point of ~20).
// All arithmetic is fp32 on the CUDA cores.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kTile = kWarps * kRowsPerWarp;  // 32: rows of a tile
constexpr int kChPerLane = 4;                 // head width <= 32 * kChPerLane

struct Head {
  const float* qkv;   // row t of the head at qkv + t * C3
  const float* dout;  // row t of the head at dout + t * C
  const float* lse;   // (T,) of the head
  const float* delta;
  float* dqkv;        // row t of the head at dqkv + t * C3
  int t0;             // first row of this block's tile
};

__device__ __forceinline__ Head head_of(const float* qkv, const float* dout,
                                        const float* lse, const float* delta,
                                        float* dqkv, int T, int heads,
                                        int ch) {
  const int ntiles = (T + kTile - 1) / kTile;
  const int tile = (int)(blockIdx.x % ntiles);
  const int hh = (int)((blockIdx.x / ntiles) % heads);
  const long long b = (long long)blockIdx.x / ((long long)ntiles * heads);
  const long long C = (long long)heads * ch, C3 = 3 * C;
  const long long stat = (b * heads + hh) * T;
  return {qkv + b * T * C3 + hh * 3 * ch, dout + b * T * C + hh * ch,
          lse + stat, delta + stat, dqkv + b * T * C3 + hh * 3 * ch,
          tile * kTile};
}

// Rows [r0, r0 + kTile) of a head's slice at `src` + offset `off` (row
// stride `stride`), times `mul`, into `dst` with row stride `ld`; zeros
// past T.
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, long long stride,
                                          int off, int r0, int T, int ch,
                                          float mul) {
  for (int i = threadIdx.x; i < kTile * ch; i += kThreads) {
    const int r = i / ch, c = i - r * ch;
    const int t = r0 + r;
    dst[r * ld + c] = t < T ? src[(long long)t * stride + off + c] * mul : 0.f;
  }
}

__device__ __forceinline__ void load_stats(float* ls, float* ds,
                                           const Head& h, int r0, int T) {
  if (threadIdx.x < kTile) {
    const int t = r0 + threadIdx.x;
    ls[threadIdx.x] = t < T ? h.lse[t] : 0.f;
    ds[threadIdx.x] = t < T ? h.delta[t] : 0.f;
  }
}

// (a) dK and dV of one tile of 32 keys.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ qkv,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dqkv, int T, int heads, int ch,
                      float scale) {
  extern __shared__ float smem[];
  const int ld = ch + 1;
  const long long C = (long long)heads * ch, C3 = 3 * C;
  float* ks = smem;                          // kTile * ch: scaled K tile
  float* vs = ks + kTile * ch;               // kTile * ch: V tile
  float* qs = vs + kTile * ch;               // kTile * ld: scaled Q rows
  float* dos = qs + kTile * ld;              // kTile * ld: dO rows
  float* ls = dos + kTile * ld;              // kTile: lse of the Q rows
  float* dls = ls + kTile;                   // kTile: delta of the Q rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* p = dls + kTile + warp * 2 * kRowsPerWarp * kTile;  // p rows
  float* dsw = p + kRowsPerWarp * kTile;                     // dS rows

  const Head h = head_of(qkv, dout, lse, delta, dqkv, T, heads, ch);
  const int j0 = h.t0;
  load_tile(ks, ch, h.qkv, C3, ch, j0, T, ch, scale);
  load_tile(vs, ch, h.qkv, C3, 2 * ch, j0, T, ch, 1.f);

  float dk[kRowsPerWarp][kChPerLane], dv[kRowsPerWarp][kChPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int k = 0; k < kChPerLane; ++k) dk[r][k] = dv[r][k] = 0.f;

  for (int i0 = 0; i0 < T; i0 += kTile) {
    __syncthreads();  // K, V written; the previous tile's Q, dO, p consumed
    load_tile(qs, ld, h.qkv, C3, 0, i0, T, ch, scale);
    load_tile(dos, ld, h.dout, C, 0, i0, T, ch, 1.f);
    load_stats(ls, dls, h, i0, T);
    __syncthreads();

    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
    const float* qr = qs + lane * ld;
    const float* dor = dos + lane * ld;
    for (int c = 0; c < ch; ++c) {
      const float qv = qr[c], dov = dor[c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int key = warp + kWarps * r;
        s[r] = fmaf(qv, ks[key * ch + c], s[r]);
        dp[r] = fmaf(dov, vs[key * ch + c], dp[r]);
      }
    }
    const bool valid = i0 + lane < T;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float pr = valid ? expf(s[r] - ls[lane]) : 0.f;
      p[r * kTile + lane] = pr;
      dsw[r * kTile + lane] = pr * (dp[r] - dls[lane]);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kChPerLane; ++k) {
      const int c = lane + 32 * k;
      if (c < ch) {
        for (int i = 0; i < kTile; ++i) {
          const float qv = qs[i * ld + c], dov = dos[i * ld + c];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            dv[r][k] = fmaf(p[r * kTile + i], dov, dv[r][k]);
            dk[r][k] = fmaf(dsw[r * kTile + i], qv, dk[r][k]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = j0 + warp + kWarps * r;
    if (t >= T) continue;
    float* row = h.dqkv + (long long)t * C3;
#pragma unroll
    for (int k = 0; k < kChPerLane; ++k) {
      const int c = lane + 32 * k;
      if (c < ch) {
        row[ch + c] = dk[r][k] * scale;
        row[2 * ch + c] = dv[r][k];
      }
    }
  }
}

// (b) dQ of one tile of 32 queries.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ qkv,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    float* __restrict__ dqkv, int T, int heads, int ch,
                    float scale) {
  extern __shared__ float smem[];
  const int ld = ch + 1;
  const long long C = (long long)heads * ch, C3 = 3 * C;
  float* qs = smem;                          // kTile * ch: scaled Q rows
  float* dos = qs + kTile * ch;              // kTile * ch: dO rows
  float* ks = dos + kTile * ch;              // kTile * ld: scaled K tile
  float* vs = ks + kTile * ld;               // kTile * ld: V tile
  float* ls = vs + kTile * ld;               // kTile: lse of the Q rows
  float* dls = ls + kTile;                   // kTile: delta of the Q rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* dsw = dls + kTile + warp * kRowsPerWarp * kTile;  // dS rows

  const Head h = head_of(qkv, dout, lse, delta, dqkv, T, heads, ch);
  const int t0 = h.t0;
  load_tile(qs, ch, h.qkv, C3, 0, t0, T, ch, scale);
  load_tile(dos, ch, h.dout, C, 0, t0, T, ch, 1.f);
  load_stats(ls, dls, h, t0, T);

  float dq[kRowsPerWarp][kChPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int k = 0; k < kChPerLane; ++k) dq[r][k] = 0.f;

  for (int j0 = 0; j0 < T; j0 += kTile) {
    __syncthreads();  // Q, dO written; the previous tile's K, V, dS consumed
    load_tile(ks, ld, h.qkv, C3, ch, j0, T, ch, scale);
    load_tile(vs, ld, h.qkv, C3, 2 * ch, j0, T, ch, 1.f);
    __syncthreads();

    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
    const float* kr = ks + lane * ld;
    const float* vr = vs + lane * ld;
    for (int c = 0; c < ch; ++c) {
      const float kv = kr[c], vv = vr[c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = warp + kWarps * r;
        s[r] = fmaf(qs[row * ch + c], kv, s[r]);
        dp[r] = fmaf(dos[row * ch + c], vv, dp[r]);
      }
    }
    const bool valid = j0 + lane < T;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp + kWarps * r;
      const float pr = valid ? expf(s[r] - ls[row]) : 0.f;
      dsw[r * kTile + lane] = pr * (dp[r] - dls[row]);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kChPerLane; ++k) {
      const int c = lane + 32 * k;
      if (c < ch) {
        for (int j = 0; j < kTile; ++j) {
          const float kv = ks[j * ld + c];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            dq[r][k] = fmaf(dsw[r * kTile + j], kv, dq[r][k]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = t0 + warp + kWarps * r;
    if (t >= T) continue;
    float* row = h.dqkv + (long long)t * C3;
#pragma unroll
    for (int k = 0; k < kChPerLane; ++k) {
      const int c = lane + 32 * k;
      if (c < ch) row[c] = dq[r][k] * scale;
    }
  }
}

}  // namespace

// smem: the dK/dV kernel's dynamic shared memory (attention.py
// bwd_smem_bytes); the dQ kernel needs one warp buffer less of it.
extern "C" int qkv_attention_bwd_f32(const float* qkv, const float* dout,
                                     const float* lse, const float* delta,
                                     float* dqkv, long long B, int T,
                                     int heads, int ch, int smem,
                                     float scale, void* stream) {
  if (B == 0 || T == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = B * heads * ((T + kTile - 1) / kTile);
  cudaStream_t s = (cudaStream_t)stream;
  flash_bwd_dkdv_kernel<<<(unsigned int)blocks, kThreads, smem, s>>>(
      qkv, dout, lse, delta, dqkv, T, heads, ch, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<<<(unsigned int)blocks, kThreads, smem, s>>>(
      qkv, dout, lse, delta, dqkv, T, heads, ch, scale);
  return (int)cudaGetLastError();
}
