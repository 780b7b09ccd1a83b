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
//
// bfloat16 (qkv_attention_flash_bf16, qkv_attention_stats_bf16; the score
// net's bf16 compute on the unfused route): qkv and out bf16, lse fp32, on
// Hopper's wgmma (the bf16 body below). Bound: the products once over 989
// TFLOP/s dense bf16, 0.017 ms at (4, 4096, 64) and 0.556 ms at (128,
// 4096, 64), against 0.003 ms for the former's 8.4 MB.

#include <cuda.h>

#include <type_traits>

#include "flash_fwd.cuh"
#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

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


// ---- bfloat16 -------------------------------------------------------------
//
// The bf16 body (K4 through qkv_attention_flash_bf16, K7a through
// qkv_attention_stats_bf16: two symbols, flash_fwd_bf16_kernel and
// flash_fwd_stats_bf16_kernel, of one body, whose outputs agree bit for
// bit). It keeps the rounding points of the JAX kernel bodies on bf16 qkv
// (sdeflow_tpu/ops/pallas/attention.py:161-198, 305-341), whose scale is a
// float32 scalar, so that q*s and k*s are float32: the scores are the fp32
// sums of the exact products of the raw bf16 q and k, times s^2; one-pass
// online softmax in fp32; l sums the unrounded p = exp(s - m); P V takes p
// unnormalised and rounded to bf16 (the bodies' p.astype(v.dtype)); O is
// accumulated in fp32, O <- O corr + P V, and rounded to bf16 once as
// O / l; lse = m + log l in fp32, natural units.
//
// Design, for Hopper: one block per (sample, head, query tile) of G
// consumer warpgroups, warpgroup i owning query rows 64i..64i+63 (G = 2,
// 128 rows, where the grid of such blocks fills the card at least
// kBfWideFrom / 132 times over, so that each K and V tile serves two
// warpgroups; else G = 1, so that the small grids still spread over the
// 132 SMs; bf_groups, mirrored by attention.py flash_fwd_bf16_rows). Q is
// loaded once into a 128-byte-swizzled tile (wgmma_bf16.cuh; W = 64 or
// 128; cp.async copies, zero past ch), the K-major A operand of the
// scores. K and V tiles of kBfKeys rows stream through a kBfStages-deep
// ring in the same swizzle (K as the K-major B of S = Q K^T, V as the
// MN-major B of P V): where a head's K and V rows are whole 64-channel
// boxes starting 16-byte aligned (ch 64 or 128, qkv aligned), one thread
// asks the TMA for each tile, in boxes of qkv's tensor map (zeros past
// T), whose bytes complete on the stage's mbarrier; else every thread
// copies its share by cp.async, zero past ch (element copies where a row
// is not aligned). The
// copies by the TMA are what make the body fast: every thread's cp.async
// held the products back. Where the TMA takes the inputs, a failure to map
// qkv is the launch's error. Per tile j, in each warpgroup:
//   - S_{j+1} = Q K_{j+1}^T is issued (wgmma m64n64k16, both operands in
//     shared memory), then O += P_j V_j (wgmma with P_j from registers:
//     bfm::pack_a of two score n-tiles, V from shared memory), then the
//     copy of tile j + kBfStages - 1 into tile j - 1's stage;
//   - once S_{j+1} has retired, its softmax runs in registers under P_j V_j
//     (FA3's overlap within a warpgroup): the row max of the raw sums
//     across the quad by shuffles, the scale folded into one FMA before the
//     SFU's ex2 (p = 2^(s c - M) with c = s^2 log2 e and M the row max
//     times c), keys past T masked in the ragged last tile only; P_{j+1}
//     is packed to bf16 into a second register buffer, and the scores are
//     only read (ptxas serialises the products, C7515, where another
//     instruction writes an accumulator inside their pipeline stage);
//   - once P_j V_j has retired, P_{j+1} takes P_j's registers; O is
//     rescaled by corr = 2^(M_old - M) (l at once) while S_{j+2} runs,
//     before P_{j+1} V_{j+1} is issued. wg::pin keeps the compiler from
//     moving those writes past the wgmma.fence.
// One barrier per tile frees the stage of tile j-1 (whose last reader,
// P_{j-1} V_{j-1}, retired before it) and, for the cp.async copies,
// publishes tile j+1's. lse = M ln 2 + log l.
constexpr int kBfKeys = 64;     // key rows per tile
constexpr int kBfStages = 4;    // depth of the K/V ring
constexpr int kBfGroupRows = 64;  // query rows per consumer warpgroup
constexpr int kBfWideFrom = 264;  // 128-row blocks from this grid size up
static_assert(kBfStages >= 3, "tiles j and j + 1 in use, j - 1 refilled");

// W: 64 or 128 (head widths up to 64 take 64, the swizzle's column block);
// G consumer warpgroups. Every tile starts on a 1,024-byte boundary (the
// first 1,024 bytes align the base).
template <int W, int G>
struct LayoutBf {
  static constexpr int rows = kBfGroupRows * G;  // query rows per block
  static constexpr int q_bytes = 2 * rows * W;
  static constexpr int stage_bytes = 2 * 2 * kBfKeys * W;  // K, V
  static constexpr int bytes = 1024 + q_bytes + kBfStages * stage_bytes;
};

// consumer warpgroups per block for a grid of B * heads * T query rows
inline int bf_groups(long long B, int T, int heads) {
  const int rows = 2 * kBfGroupRows;
  return B * heads * ((T + rows - 1) / rows) >= kBfWideFrom ? 2 : 1;
}

// the mbarriers of the TMA's copies, and the copy of one box
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

template <int W, int G, bool kStats, bool kTma>
__device__ __forceinline__ void flash_fwd_bf16_body(
    const bfm::bf16* __restrict__ qkv, bfm::bf16* __restrict__ out,
    float* __restrict__ lse, int T, int heads, int ch, float scale2,
    bool vec, const CUtensorMap* tmap) {
  using bfm::bf16;
  using L = LayoutBf<W, G>;
  constexpr int R = L::rows, kT = 128 * G;
  constexpr int NT = kBfKeys / 8;  // n-tiles of the score tile
  constexpr int NO = W / 8;        // n-tiles of the output
  extern __shared__ __align__(16) float smem[];
  char* raw = wg::align1024(smem);
  bf16* qs = reinterpret_cast<bf16*>(raw);
  char* ring = raw + L::q_bytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3;
  const int grp = tid >> 7;
  const int g = lane >> 2, q4 = lane & 3;
  const int nq = (T + R - 1) / R;
  const int qt = (int)(blockIdx.x % nq);
  const int hh = (int)((blockIdx.x / nq) % heads);
  const long long b = (long long)blockIdx.x / ((long long)nq * heads);
  const long long C = (long long)heads * ch, C3 = 3 * C;
  const bf16* base = qkv + b * T * C3 + hh * 3 * ch;  // row t at + t*C3
  const int q0 = qt * R;
  const int ntiles = (T + kBfKeys - 1) / kBfKeys;

  auto stage = [&](int j) {
    return reinterpret_cast<bf16*>(ring + (j % kBfStages) * L::stage_bytes);
  };
  __shared__ __align__(8) uint64_t full[kBfStages];  // a stage's TMA bytes
  auto load_tile = [&](int j) {  // K and V rows of key tile j
    bf16* ks = stage(j);
    if constexpr (kTma) {
      if (tid == 0) {
        uint64_t* bar = &full[j % kBfStages];
        mbar_expect(bar, 2 * 2 * kBfKeys * W);
        const int kc = hh * 3 * ch + ch;
#pragma unroll
        for (int cb = 0; cb < W / 64; ++cb) {
          tma_load(ks + cb * kBfKeys * 64, tmap, kc + 64 * cb, j * kBfKeys,
                   (int)b, bar);
          tma_load(ks + kBfKeys * W + cb * kBfKeys * 64, tmap,
                   kc + ch + 64 * cb, j * kBfKeys, (int)b, bar);
        }
      }
    } else {
      wg::load_tile<kBfKeys, W, kT>(ks, base + ch, C3, j * kBfKeys, T, ch,
                                    vec);
      wg::load_tile<kBfKeys, W, kT>(ks + kBfKeys * W, base + 2 * ch, C3,
                                    j * kBfKeys, T, ch, vec);
    }
  };
  if constexpr (kTma) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < kBfStages; ++i) mbar_init(&full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  wg::load_tile<R, W, kT>(qs, base, C3, q0, T, ch, vec);
  load_tile(0);
  tc::cp_async_commit();  // Q and tile 0
#pragma unroll
  for (int j = 1; j < kBfStages - 1; ++j) {
    if (j < ntiles) load_tile(j);
    tc::cp_async_commit();
  }
  bfm::cp_async_wait<kTma ? 0 : kBfStages - 2>();
  wg::fence_smem();
  __syncthreads();  // every thread's copies of Q and tile 0
  if constexpr (kTma) mbar_wait(&full[0], 0);

  float s[NT][4], o[NO][4];
  wg::zero(o);
  // P of tile j, the A operand of P_j V_j, and of tile j + 1, packed while
  // P_j V_j runs
  uint32_t p[NT / 2][4], pn[NT / 2][4];
  // per row (g, g + 8): M = the max of the raw score sums times c, and l
  float mc[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  const float sc = scale2 * 1.4426950408889634f;  // c = s^2 log2(e)
  const uint64_t dq = wg::desc_k(qs + grp * kBfGroupRows * 64);

  // S = Q K_j^T, the fp32 sums of the exact bf16 products, issued and
  // committed (k-step 0 overwrites: no earlier value of s enters it)
  auto scores = [&](int j) {
    const uint64_t dk = wg::desc_k(stage(j));
    wg::fence();
    wg::mma_ss_first<kBfKeys>(wg::flat<kBfKeys>(s), dq, dk);
#pragma unroll
    for (int kk = 1; kk < W / 16; ++kk)
      wg::mma_ss<kBfKeys>(wg::flat<kBfKeys>(s), dq + wg::k_step(R, kk),
                          dk + wg::k_step(kBfKeys, kk), 1);
    wg::commit();
  };
  // the online softmax of tile j's scores (s only read: a write into an
  // accumulator inside the products' pipeline stage serialises them):
  // p = 2^(s c - M) rounded to bf16 into pn, l and M updated, corr =
  // 2^(M_old - M) for O (0 on the first tile)
  auto softmax_tile = [&](int j, auto ragged_tile) {
    const int k0 = j * kBfKeys;
    auto score = [&](int n, int e) {  // keys past T count -inf
      if constexpr (decltype(ragged_tile)::value)
        return k0 + n * 8 + 2 * q4 + (e & 1) >= T ? -INFINITY : s[n][e];
      else
        return s[n][e];
    };
    float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // row g (c0, c1), row g + 8 (c2, c3)
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(score(n, 2 * h), score(n, 2 * h + 1)));
      m_new[h] = fmaxf(mc[h], tc::quad_max(mx) * sc);  // key k0 < T
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {  // keys 16kk..16kk+15
      float x[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 2 * kk + i;
          x[i][2 * h] = wg::ex2(fmaf(score(n, 2 * h), sc, -m_new[h]));
          x[i][2 * h + 1] =
              wg::ex2(fmaf(score(n, 2 * h + 1), sc, -m_new[h]));
          sum[h] += x[i][2 * h] + x[i][2 * h + 1];
        }
      bfm::pack_a(pn[kk], x[0], x[1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      corr[h] = wg::ex2(mc[h] - m_new[h]);
      l[h] = fmaf(l[h], corr[h], tc::quad_sum(sum[h]));
      mc[h] = m_new[h];
    }
  };
  auto softmax = [&](int j) {  // masks only in the ragged last tile
    if ((j + 1) * kBfKeys > T)
      softmax_tile(j, std::true_type());
    else
      softmax_tile(j, std::false_type());
  };
  auto take = [&] {  // P_{j+1} in place of P_j
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[kk][i] = pn[kk][i];
  };

  scores(0);
  wg::wait<0>();
  wg::pin(wg::flat<kBfKeys>(s));
  softmax(0);
  take();
  for (int j = 0; j < ntiles; ++j) {
    const bool next = j + 1 < ntiles;
    if (next) {
      if constexpr (!kTma) {
        bfm::cp_async_wait<kBfStages - 3>();  // tile j + 1 has landed
        wg::fence_smem();
      }
      __syncthreads();  // for every thread's copies; stage j - 1 is free
      if constexpr (kTma)
        mbar_wait(&full[(j + 1) % kBfStages], ((j + 1) / kBfStages) & 1);
      scores(j + 1);
    }
    // O rescaled to tile j's max (0 times 0 on the first tile) while
    // S_{j+1} runs, then O += P_j V_j
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0], o[n][1] *= corr[0];
      o[n][2] *= corr[1], o[n][3] *= corr[1];
    }
    const uint64_t dv = wg::desc_mn(stage(j) + kBfKeys * W, kBfKeys);
    wg::pin(wg::flat<W>(o));
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) wg::pin(p[kk]);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      wg::mma_rs<W>(wg::flat<W>(o), p[kk], dv + wg::mn_step(kk), 1);
    wg::commit();
    if (next) {
      // the copy of tile j + kBfStages - 1 (into tile j - 1's stage) runs
      // under the products
      if (j + kBfStages - 1 < ntiles) load_tile(j + kBfStages - 1);
      tc::cp_async_commit();
      wg::wait<1>();  // S_{j+1} has retired, P_j V_j may run on
      wg::pin(wg::flat<kBfKeys>(s));
      softmax(j + 1);
      wg::wait<0>();  // P_j V_j has retired: O and P are free
      wg::pin(wg::flat<W>(o));
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) wg::pin(p[kk]);
      take();
    } else {
      wg::wait<0>();
      wg::pin(wg::flat<W>(o));
    }
  }

  const bool pairs = (ch & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = q0 + grp * kBfGroupRows + warp * 16 + g + 8 * h;
    if (t >= T) continue;
    const float inv = 1.f / l[h];
    bf16* orow = out + (b * T + t) * C + hh * ch;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * q4;
      const float v0 = o[n][2 * h] * inv, v1 = o[n][2 * h + 1] * inv;
      if (pairs && c < ch) {  // c + 1 < ch, 4-byte aligned
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < ch) orow[c] = __float2bfloat16_rn(v0);
        if (c + 1 < ch) orow[c + 1] = __float2bfloat16_rn(v1);
      }
    }
    if (kStats && q4 == 0)  // M ln 2 + log l, natural units
      lse[(b * heads + hh) * T + t] =
          fmaf(mc[h], 0.6931471805599453f, logf(l[h]));
  }
}

// at least two blocks an SM at W = 64 (as many as shared memory holds)
template <int W, int G, bool kTma>
__global__ void __launch_bounds__(128 * G, W == 64 ? 2 : 1)
flash_fwd_bf16_kernel(const bfm::bf16* __restrict__ qkv,
                      bfm::bf16* __restrict__ out, float* __restrict__ lse,
                      int T, int heads, int ch, float scale2, bool vec,
                      const __grid_constant__ CUtensorMap tmap) {
  flash_fwd_bf16_body<W, G, false, kTma>(qkv, out, lse, T, heads, ch, scale2,
                                         vec, &tmap);
}

template <int W, int G, bool kTma>
__global__ void __launch_bounds__(128 * G, W == 64 ? 2 : 1)
flash_fwd_stats_bf16_kernel(const bfm::bf16* __restrict__ qkv,
                            bfm::bf16* __restrict__ out,
                            float* __restrict__ lse, int T, int heads,
                            int ch, float scale2, bool vec,
                            const __grid_constant__ CUtensorMap tmap) {
  flash_fwd_bf16_body<W, G, true, kTma>(qkv, out, lse, T, heads, ch, scale2,
                                        vec, &tmap);
}

template <int W, int G, bool kStats, bool kTma>
int launch_bf(const bfm::bf16* qkv, bfm::bf16* out, float* lse, long long B,
              int T, int heads, int ch, int smem, float s2, bool vec,
              const CUtensorMap& tmap, cudaStream_t stream) {
  if (smem != LayoutBf<W, G>::bytes) return (int)cudaErrorInvalidValue;
  auto kernel = kStats ? &flash_fwd_stats_bf16_kernel<W, G, kTma>
                       : &flash_fwd_bf16_kernel<W, G, kTma>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = B * heads * ((T + LayoutBf<W, G>::rows - 1) /
                                        LayoutBf<W, G>::rows);
  kernel<<<(unsigned int)blocks, 128 * G, smem, stream>>>(
      qkv, out, lse, T, heads, ch, s2, vec, tmap);
  return (int)cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the TMA takes a head's K and V where they are whole 64-channel boxes (ch
// 64 or 128; the channels past ch must be zeros) starting 16-byte aligned
inline bool tma_takes(int ch, bool vec) { return vec && ch % 64 == 0; }

// the tensor map of qkv (B, T, 3C) for TMA boxes of 64 channels x kBfKeys
// rows; cudaErrorNotSupported where the driver has no encoder,
// cudaErrorInvalidValue where it refuses the map
int qkv_map(CUtensorMap& map, const bfm::bf16* qkv, long long B, int T,
            long long C3) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      encode = nullptr;
  }
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)C3, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C3 * 2,
                                 (cuuint64_t)C3 * 2 * T};
  const cuuint32_t box[3] = {64, kBfKeys, 1}, one[3] = {1, 1, 1};
  return encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<bfm::bf16*>(qkv), dims, strides, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

// the TMA's copies wherever it takes the inputs (a failure to map qkv is
// the launch's error, never a switch to cp.async), cp.async elsewhere
template <int W, int G, bool kStats>
int launch_map(const bfm::bf16* qkv, bfm::bf16* out, float* lse,
               long long B, int T, int heads, int ch, int smem, float s2,
               bool vec, cudaStream_t st) {
  CUtensorMap map{};
  if (!tma_takes(ch, vec))
    return launch_bf<W, G, kStats, false>(qkv, out, lse, B, T, heads, ch,
                                          smem, s2, vec, map, st);
  if (const int err = qkv_map(map, qkv, B, T, 3LL * heads * ch)) return err;
  return launch_bf<W, G, kStats, true>(qkv, out, lse, B, T, heads, ch, smem,
                                       s2, vec, map, st);
}

template <bool kStats>
int launch_bf16(const bfm::bf16* qkv, bfm::bf16* out, float* lse,
                long long B, int T, int heads, int ch, int smem, float scale,
                void* stream) {
  if (B == 0 || T == 0) return 0;
  const bool vec = ch % 8 == 0 && aligned16(qkv);
  const float s2 = scale * scale;
  cudaStream_t st = (cudaStream_t)stream;
  const bool wide = bf_groups(B, T, heads) == 2;
  if (ch <= 64)
    return wide ? launch_map<64, 2, kStats>(qkv, out, lse, B, T, heads, ch,
                                            smem, s2, vec, st)
                : launch_map<64, 1, kStats>(qkv, out, lse, B, T, heads, ch,
                                            smem, s2, vec, st);
  return wide ? launch_map<128, 2, kStats>(qkv, out, lse, B, T, heads, ch,
                                           smem, s2, vec, st)
              : launch_map<128, 1, kStats>(qkv, out, lse, B, T, heads, ch,
                                           smem, s2, vec, st);
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


// The bf16 entries: qkv and out bf16, lse fp32; smem as attention.py
// flash_fwd_smem_bytes(ch, torch.bfloat16, flash_fwd_bf16_rows(B, T,
// heads)) computes it, refused if it is not LayoutBf<W, G>::bytes of the
// block that bf_groups picks.
extern "C" int qkv_attention_flash_bf16(const bfm::bf16* qkv, bfm::bf16* out,
                                        long long B, int T, int heads,
                                        int ch, int smem, float scale,
                                        void* stream) {
  return launch_bf16<false>(qkv, out, nullptr, B, T, heads, ch, smem, scale,
                            stream);
}

extern "C" int qkv_attention_stats_bf16(const bfm::bf16* qkv, bfm::bf16* out,
                                        float* lse, long long B, int T,
                                        int heads, int ch, int smem,
                                        float scale, void* stream) {
  return launch_bf16<true>(qkv, out, lse, B, T, heads, ch, smem, scale,
                           stream);
}
