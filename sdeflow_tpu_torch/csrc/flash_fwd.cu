// K4 and K7a: the long-sequence attention forward on the tensor cores,
// float32 in and out.
//
//   for each sample b and head hh, with the head's interleaved channel slice
//   [q_h k_h v_h] (width 3*ch) of each qkv row (B, T, 3C):
//   o_h = softmax((q_h s)(k_h s)^T) v_h,    s = ch^-1/4
//   written to out (B, T, C) at channels [hh*ch, (hh+1)*ch); the second
//   entry also writes lse = m + log l of the scaled scores to lse
//   (B, heads, T) for the backward (attention_bwd.cu).
//
// Replaces: _flash_kernel / _attention_flash (K4, T > 1024, no-grad) in
// sdeflow_tpu/ops/pallas/attention.py:152-222 (its pallas_call :211),
// through qkv_attention_flash_f32; and _flash_fwd_stats_kernel /
// _attention_flash_stats (K7a, :299-368, pallas_call :349), the forward of
// the reverse-mode pair, through qkv_attention_stats_f32. The two entries
// are one kernel body, compiled as two symbols (flash_fwd_kernel,
// flash_fwd_stats_kernel) so that traces tell them apart.
//
// Bound on the H100: operations. At (B, T, C) = (4, 4096, 64), one head,
// the products are 4 T^2 ch flops per sample, 3x that in TF32 for the
// split: 0.104 ms at 494.7 TFLOP/s dense TF32, against 0.004 ms for the
// 38 MB of qkv, out and lse at 3.35 TB/s.
//
// Design: flash_fwd.cuh.

#include "flash_fwd.cuh"

namespace {

using namespace flash;

template <int W>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                 int T, int heads, int ch, float scale2, bool vec) {
  flash_fwd_body<W, false>(qkv, out, nullptr, T, heads, ch, scale2, vec);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
flash_fwd_stats_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                       float* __restrict__ lse, int T, int heads, int ch,
                       float scale2, bool vec) {
  flash_fwd_body<W, true>(qkv, out, lse, T, heads, ch, scale2, vec);
}

}  // namespace

// smem: the block's dynamic shared memory as attention.py
// flash_fwd_smem_bytes computes it; refused (cudaErrorInvalidValue) if it
// is not this file's Layout<W>::bytes. scale is s = ch^-1/4.
extern "C" int qkv_attention_flash_f32(const float* qkv, float* out,
                                       long long B, int T, int heads, int ch,
                                       int smem, float scale, void* stream) {
  if (B == 0 || T == 0) return 0;
  const bool vec = ch % 4 == 0 && aligned16(qkv);
  const float s2 = scale * scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (ch <= 32)
    return launch_w<32>(flash_fwd_kernel<32>, B, T, heads, smem, st, qkv,
                        out, T, heads, ch, s2, vec);
  if (ch <= 64)
    return launch_w<64>(flash_fwd_kernel<64>, B, T, heads, smem, st, qkv,
                        out, T, heads, ch, s2, vec);
  return launch_w<128>(flash_fwd_kernel<128>, B, T, heads, smem, st, qkv,
                       out, T, heads, ch, s2, vec);
}

extern "C" int qkv_attention_stats_f32(const float* qkv, float* out,
                                       float* lse, long long B, int T,
                                       int heads, int ch, int smem,
                                       float scale, void* stream) {
  if (B == 0 || T == 0) return 0;
  const bool vec = ch % 4 == 0 && aligned16(qkv);
  const float s2 = scale * scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (ch <= 32)
    return launch_w<32>(flash_fwd_stats_kernel<32>, B, T, heads, smem, st,
                        qkv, out, lse, T, heads, ch, s2, vec);
  if (ch <= 64)
    return launch_w<64>(flash_fwd_stats_kernel<64>, B, T, heads, smem, st,
                        qkv, out, lse, T, heads, ch, s2, vec);
  return launch_w<128>(flash_fwd_stats_kernel<128>, B, T, heads, smem, st,
                       qkv, out, lse, T, heads, ch, s2, vec);
}
