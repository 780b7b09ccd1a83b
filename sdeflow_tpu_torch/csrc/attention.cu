// K6: the attention core at T <= 1024 on the tensor cores, float32 in and
// out.
//
//   for each sample b and head hh, with the head's interleaved channel slice
//   [q_h k_h v_h] (width 3*ch) of each qkv row:
//   o_h = softmax((q_h s)(k_h s)^T) v_h,    s = ch^-1/4
//
// qkv is (B, T, 3C), the output (B, T, C) with head hh in channels
// [hh*ch, (hh+1)*ch).
//
// Replaces: the Pallas kernel _attn_kernel / _attention_pallas (T <= 1024,
// K6) in sdeflow_tpu/ops/pallas/attention.py:115-142, 225-255 (pallas_call
// :244, entry qkv_attention :258-276), through the C entry
// qkv_attention_f32. The TPU keeps the whole (T, T) score tile in VMEM;
// here no score matrix leaves the registers. Above T = 1024 (K4) and for
// the forward with lse (K7a) flash_fwd.cu takes over.
//
// Bound on the H100 (chip_smoke.py k6_cost): bytes at the U-Net's short
// sequences: at (B, T, C) = (1024, 64, 64) and (1024, 16, 128) qkv read
// once and o written once are 67 and 34 MB, 0.020 and 0.010 ms at
// 3.35 TB/s, against 0.0065 and 0.0016 ms for the products in 3xTF32 at
// 494.7 TFLOP/s. Operations at T = 1024: at (128, 1024, 128) the products
// take 0.42 ms, the 268 MB of qkv and o 0.08 ms.
//
// Design, T <= 64 (kShortT): each unit (sample, head) is held whole in
// shared memory, Q and K rows of w + 4 floats and V rows of w + 8 (w the
// head width rounded up to 8, zeros past ch; the pads put the fragment
// loads in distinct banks, flash_fwd.cuh), loaded once by 16-byte cp.async
// in the order of the qkv rows, so a block reads whole rows of qkv at one
// head and every byte of qkv once. A block of 4 warps packs 4 units at
// T <= 16, 2 at T <= 32 and 1 above, and each warp takes 16 query rows of
// one unit, so no warp idles at T = 16. The scores, the softmax (one key
// tile: no online rescaling) and P V run in registers on mma.sync m16n8k8
// in 3xTF32 (attn_tile.cuh), P re-laid into the A layout by quad shuffles;
// each lane writes its output pairs as 8-byte stores. The point of the
// design is the bound: qkv is read and o written once, at full width.
// Above T = 64 up to 1024: flash_fwd.cuh's scheme (64-row query blocks,
// key tiles through a two-stage cp.async ring, the online softmax, a
// fresh P V accumulator per tile), since there the bound is operations,
// compiled here as K6's own symbol (qkv_attention_kernel_tiled) in its
// K6 variant (kK6): raw Q rows and 32-key tiles, so two blocks share an
// SM at head width 128, and each k-step's score products in a fresh
// accumulator (one chain of 16 k-steps puts the output about 1e-5 from
// float64 there).

#include <math.h>

#include "attn_tile.cuh"
#include "flash_fwd.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kShortT = 64;  // T <= kShortT: a unit whole in shared memory
constexpr int kPadQK = 4;    // Q and K rows: w + 4 floats
constexpr int kPadV = 8;     // V rows: w + 8 floats

__host__ __device__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// units (sample, head) per block: 4 warps of 16 query rows
__host__ __device__ int units_per_block(int T) {
  const int mtiles = round_up(T, 16) / 16;
  return mtiles > kWarps ? 0 : kWarps / mtiles;
}

int short_smem_bytes(int T, int w) {
  return 4 * units_per_block(T) * round_up(T, 16) *
         (2 * (w + kPadQK) + w + kPadV);
}

template <int NT, int NO>
__global__ void __launch_bounds__(kThreads, 3)
qkv_attention_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                     long long units, int T, int heads, int ch, int w,
                     float scale2, bool vec, bool pairs) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int ldq = w + kPadQK, ldv = w + kPadV, tp = round_up(T, 16);
  const int upb = units_per_block(T), mtiles = tp / 16;
  const int unit_floats = tp * (2 * ldq + ldv);
  const long long u0 = (long long)blockIdx.x * upb;
  const int nu = (int)min((long long)upb, units - u0);
  const long long C = (long long)heads * ch, C3 = 3 * C;

  // every unit's Q, K, V rows (zero past T and past ch), whole qkv rows in
  // order: consecutive threads take consecutive 16 bytes of a row's slice.
  // Chunk i = tid + j*kThreads is (unit lu, row lr, chunk lx of the row),
  // advanced without divisions.
  const int chunks = vec ? w / 4 : w, per_row = 3 * chunks;
  const int dr = kThreads / per_row, dx = kThreads - dr * per_row;
  auto unit_rows = [&](int uu) {  // row 0 of unit uu's slice of qkv
    const long long unit = u0 + uu, b = unit / heads;
    return qkv + b * T * C3 + (unit - b * heads) * 3 * ch;
  };
  int lu = 0, lr = tid / per_row, lx = tid - lr * per_row;
  while (lr >= tp) lr -= tp, ++lu;
  const float* src_u = unit_rows(min(lu, nu - 1));
  while (lu < nu) {
    const int part = lx >= 2 * chunks ? 2 : lx >= chunks ? 1 : 0;
    const int c = (lx - part * chunks) * (vec ? 4 : 1);
    float* dst = smem + lu * unit_floats + part * tp * ldq +
                 lr * (part == 2 ? ldv : ldq) + c;
    const bool ok = lr < T && c < ch;
    const float* src = ok ? src_u + lr * C3 + part * ch + c : qkv;
    if (vec)
      tc::cp_async16(dst, src, ok);
    else
      tc::cp_async4(dst, src, ok);
    lx += dx, lr += dr;
    if (lx >= per_row) lx -= per_row, ++lr;
    if (lr >= tp) {
      while (lr >= tp) lr -= tp, ++lu;
      src_u = unit_rows(min(lu, nu - 1));
    }
  }
  tc::cp_async_commit();
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int u = warp / mtiles;
  if (u >= nu) return;
  const float* qs = smem + u * unit_floats;
  const float* ks = qs + tp * ldq;
  const float* vs = ks + tp * ldq;
  const long long unit = u0 + u, b = unit / heads;
  float* ob = out + b * T * C + (unit - b * heads) * ch;  // row t at + t*C
  tc::attend16<NT, NO>(
      qs, ldq, ks, ldq, vs, ldv, T, tp, w, scale2, (warp % mtiles) * 16, 0,
      round_up(w, 8 * NO),
      [&](int r, int c, float v0, float v1) {
        if (r >= T || c >= ch) return;
        float* o = ob + (long long)r * C + c;
        if (pairs) {  // c + 1 < ch, 8-byte aligned
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (c + 1 < ch) o[1] = v1;
        }
      });
}

template <int W>
__global__ void __launch_bounds__(flash::kThreads)
qkv_attention_kernel_tiled(const float* __restrict__ qkv,
                           float* __restrict__ out, int T, int heads, int ch,
                           float scale2, bool vec) {
  flash::flash_fwd_body<W, false, true>(qkv, out, nullptr, T, heads, ch,
                                        scale2, vec);
}

template <int NT, int NO>
int launch_short(const float* qkv, float* out, long long B, int T, int heads,
                 int ch, int w, int smem, float s2, bool vec,
                 cudaStream_t stream) {
  auto kernel = qkv_attention_kernel<NT, NO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long units = B * heads, upb = units_per_block(T);
  const bool pairs = ch % 2 == 0 && ((uintptr_t)out & 7) == 0;
  kernel<<<(unsigned int)((units + upb - 1) / upb), kThreads, smem, stream>>>(
      qkv, out, units, T, heads, ch, w, s2, vec, pairs);
  return (int)cudaGetLastError();
}

}  // namespace

// smem: the block's dynamic shared memory as attention.py smem_bytes
// computes it; refused (cudaErrorInvalidValue) if this file computes
// another. scale is s = ch^-1/4.
extern "C" int qkv_attention_f32(const float* qkv, float* out, long long B,
                                 int T, int heads, int ch, int smem,
                                 float scale, void* stream) {
  if (B == 0 || T == 0) return 0;
  const bool vec = ch % 4 == 0 && flash::aligned16(qkv);
  const float s2 = scale * scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (T > kShortT) {
    if (ch <= 32)
      return flash::launch_w<32, true>(qkv_attention_kernel_tiled<32>, B, T,
                                       heads, smem, st, qkv, out, T, heads,
                                       ch, s2, vec);
    if (ch <= 64)
      return flash::launch_w<64, true>(qkv_attention_kernel_tiled<64>, B, T,
                                       heads, smem, st, qkv, out, T, heads,
                                       ch, s2, vec);
    return flash::launch_w<128, true>(qkv_attention_kernel_tiled<128>, B, T,
                                      heads, smem, st, qkv, out, T, heads, ch,
                                      s2, vec);
  }
  const int w = round_up(ch, 8);
  if (smem != short_smem_bytes(T, w)) return (int)cudaErrorInvalidValue;
  if (T <= 16)
    return w <= 16
               ? launch_short<2, 2>(qkv, out, B, T, heads, ch, w, smem, s2,
                                    vec, st)
               : launch_short<2, 8>(qkv, out, B, T, heads, ch, w, smem, s2,
                                    vec, st);
  return w <= 16 ? launch_short<8, 2>(qkv, out, B, T, heads, ch, w, smem, s2,
                                      vec, st)
                 : launch_short<8, 8>(qkv, out, B, T, heads, ch, w, smem, s2,
                                      vec, st);
}
