// K6 / K4 and K7a: the attention core, float32.
//
//   for each sample b and head hh, with the head's interleaved channel slice
//   [q_h k_h v_h] (width 3*ch) of each qkv row:
//   o_h = softmax((q_h s)(k_h s)^T) v_h,    s = ch^-1/4
//
// qkv is (B, T, 3C), the output (B, T, C) with head hh in channels
// [hh*ch, (hh+1)*ch).
//
// Replaces: the Pallas kernels _attn_kernel / _attention_pallas (T <= 1024,
// K6) and _flash_kernel / _attention_flash (T > 1024, K4) in
// sdeflow_tpu/ops/pallas/attention.py:115-142, 152-255 (entry qkv_attention
// :258-276), through the C entry qkv_attention_f32; and, through the entry
// qkv_attention_stats_f32, _flash_fwd_stats_kernel / _attention_flash_stats
// (:299-368, K7a), the forward of the reverse-mode pair, which also writes
// lse = m + log l of the scaled scores per (sample, head, row) into
// lse (B, heads, T) for the backward (attention_bwd.cu). The TPU keeps the
// whole (T, T) score tile in VMEM below T = 1024 and streams 512-row KV
// tiles above it; one kernel serves every T here, since a block's 227 KB of
// shared memory holds neither a (T, T) tile nor 512-row tiles. K7a is the
// same kernel body with the lse store switched on (its own symbol,
// qkv_attention_stats_kernel, so that traces tell it from K6/K4).
//
// Bound on the H100: bytes at the U-Net's shapes (B, 64, 64) and
// (B, 16, 128) (qkv read and o written, 16 bytes per channel and row, against
// 4*T flops per channel and row: 16 flops/byte at T = 64, below the fp32
// balance point of ~20); operations at T >= 1024 (K4, and K7a, whose lse
// adds 4 bytes per head and row).
//
// Design: one block of 256 threads per (sample, head, tile of 32 query
// rows). The block's scaled Q rows sit in shared memory; keys and values
// stream through it in tiles of 32 rows with the online softmax of the TPU's
// flash kernel (running max m, normaliser l, fp32 accumulator), so no
// (T, T) score matrix exists at any T. Warp w owns query rows w, w+8, w+16,
// w+24 of the tile. In a key tile, lane j owns key j: it forms its key's
// scaled dot products with the warp's four rows (K rows padded to ch+1
// floats, so the lanes' reads fall in distinct banks; Q reads are
// broadcasts), the warp takes max and sum by shuffles, and the
// probabilities go to the warp's row of shared memory; then the lanes split
// the head's channels (up to four each, ch <= 128) for P*V. All arithmetic
// is fp32 on the CUDA cores; tensor cores are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kTq = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTk = 32;                     // key rows per tile, one per lane
constexpr int kChPerLane = 4;               // head width <= 32 * kChPerLane

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool kStats>
__device__ __forceinline__ void attention_body(
    const float* __restrict__ qkv, float* __restrict__ out,
    float* __restrict__ lse, int T, int heads, int ch, float scale) {
  extern __shared__ float smem[];
  const int ldk = ch + 1;
  float* qs = smem;              // kTq * ch: scaled Q rows of this tile
  float* ks = qs + kTq * ch;     // kTk * (ch + 1): scaled K tile
  float* vs = ks + kTk * ldk;    // kTk * ch: V tile
  float* ps = vs + kTk * ch;     // kWarps * kRowsPerWarp * kTk: probabilities

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (T + kTq - 1) / kTq;
  const int qt = (int)(blockIdx.x % ntiles);
  const int hh = (int)((blockIdx.x / ntiles) % heads);
  const long long b = (long long)blockIdx.x / ((long long)ntiles * heads);
  const int C = heads * ch, C3 = 3 * C;
  const float* base = qkv + b * T * C3 + hh * 3 * ch;  // row t at base + t*C3
  const int t0 = qt * kTq;

  for (int i = tid; i < kTq * ch; i += kThreads) {
    const int r = i / ch, c = i - (i / ch) * ch;
    const int t = t0 + r;
    qs[i] = t < T ? base[(long long)t * C3 + c] * scale : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kChPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int k = 0; k < kChPerLane; ++k) acc[r][k] = 0.f;
  }
  float* p = ps + warp * kRowsPerWarp * kTk;

  for (int j0 = 0; j0 < T; j0 += kTk) {
    __syncthreads();  // Q written; the previous tile's K, V and p consumed
    for (int i = tid; i < kTk * ch; i += kThreads) {
      const int r = i / ch, c = i - (i / ch) * ch;
      const int t = j0 + r;
      const float* row = base + (long long)t * C3;
      ks[r * ldk + c] = t < T ? row[ch + c] * scale : 0.f;
      vs[r * ch + c] = t < T ? row[2 * ch + c] : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* kr = ks + lane * ldk;
    for (int c = 0; c < ch; ++c) {
      const float kv = kr[c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] = fmaf(qs[(warp + kWarps * r) * ch + c], kv, s[r]);
    }
    const bool valid = j0 + lane < T;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sr = valid ? s[r] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sr));  // finite: key j0 < T
      const float corr = expf(m[r] - m_new);          // 0 on the first tile
      const float e = expf(sr - m_new);               // 0 past the last key
      l[r] = l[r] * corr + warp_sum(e);
      m[r] = m_new;
      p[r * kTk + lane] = e;
#pragma unroll
      for (int k = 0; k < kChPerLane; ++k) acc[r][k] *= corr;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kChPerLane; ++k) {
      const int c = lane + 32 * k;
      if (c < ch) {
        for (int j = 0; j < kTk; ++j) {
          const float vv = vs[j * ch + c];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            acc[r][k] = fmaf(p[r * kTk + j], vv, acc[r][k]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = t0 + warp + kWarps * r;
    if (t >= T) continue;
    float* o = out + (b * T + t) * C + hh * ch;
#pragma unroll
    for (int k = 0; k < kChPerLane; ++k) {
      const int c = lane + 32 * k;
      if (c < ch) o[c] = acc[r][k] / l[r];
    }
    if (kStats && lane == 0) lse[(b * heads + hh) * T + t] = m[r] + logf(l[r]);
  }
}

__global__ void __launch_bounds__(kThreads)
qkv_attention_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                     int T, int heads, int ch, float scale) {
  attention_body<false>(qkv, out, nullptr, T, heads, ch, scale);
}

__global__ void __launch_bounds__(kThreads)
qkv_attention_stats_kernel(const float* __restrict__ qkv,
                           float* __restrict__ out, float* __restrict__ lse,
                           int T, int heads, int ch, float scale) {
  attention_body<true>(qkv, out, lse, T, heads, ch, scale);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, long long B, int T, int heads, int smem,
           void* stream, Args... args) {
  if (B == 0 || T == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = B * heads * ((T + kTq - 1) / kTq);
  kernel<<<(unsigned int)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qkv_attention_f32(const float* qkv, float* out, long long B,
                                 int T, int heads, int ch, int smem,
                                 float scale, void* stream) {
  return launch(qkv_attention_kernel, B, T, heads, smem, stream, qkv, out, T,
                heads, ch, scale);
}

extern "C" int qkv_attention_stats_f32(const float* qkv, float* out,
                                       float* lse, long long B, int T,
                                       int heads, int ch, int smem,
                                       float scale, void* stream) {
  return launch(qkv_attention_stats_kernel, B, T, heads, smem, stream, qkv,
                out, lse, T, heads, ch, scale);
}
