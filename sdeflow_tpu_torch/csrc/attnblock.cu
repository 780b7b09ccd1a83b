// K3: the whole U-Net AttentionBlock in one kernel, on the tensor cores,
// float32 in and out.
//
//   h   = GroupNorm(x)                     (fp32 two-pass statistics, eps 1e-5)
//   qkv = h @ Wqkv + bqkv                  (C -> 3C; head hh owns the
//                                           interleaved slice [q_h k_h v_h])
//   o_h = softmax((q_h s)(k_h s)^T) v_h    (s = ch^-1/4, per head)
//   out = x + o @ Wproj + bproj
//
// Replaces: the Pallas kernel _attn_block_kernel / _attn_block_pallas in
// sdeflow_tpu/ops/pallas/attnblock.py:75-250 (pallas_call :230; entry
// fused_attention_block :257-266). The TPU kernel packs several samples into
// one block-diagonal attention and broadcasts group statistics through
// one-hot matmuls; both work around the TPU's 128-wide matrix unit and
// Mosaic's reshape limits and have no reason to exist here.
//
// Bound on the H100 (chip_smoke.py k3_cost): operations. At the serve
// path's shapes, (B, T, C) = (1024, 64, 64) and (1024, 16, 128), a sample's
// four products are 3.1 and 2.2 MFLOP, 3x that in TF32 for the split
// (0.0195 and 0.0138 ms at 494.7 TFLOP/s for B = 1024), against 32 and
// 16 KB of x in and out (0.010 and 0.005 ms at 3.35 TB/s).
//
// Design: one block of 8 warps (two blocks to an SM where the plan allows,
// attnblock.py block_plan) per S samples (at most 64 rows: 2 at T = 16, 1 at
// T = 64), so each weight tile serves S samples. Everything between the read
// of x and the write of the output stays on chip: x, then h = GroupNorm(x)
// (two-pass statistics per (sample, group) from per-channel sums, fp32 on the
// CUDA cores), then the attention output O, in one buffer of rows of Cp + 4
// floats (C rounded up to 8, zeros past C); q and k in rows of heads*2*w + 4
// floats and v in rows of heads*w rounded up to 16, + 8 (each head's q, k and
// v padded to w, the head width rounded up to 8, with zeros: 8 heads at C =
// 64 give ch = 8; the pads put every fragment load of the attention in
// distinct banks). The two projections are one routine (project below): Wqkv
// (196 KB at C = 128, too large to sit beside the rest) and Wproj stream
// through a two-stage cp.async ring of 64-row x 64-column tiles, zero past
// the real rows and columns; a warp takes 16 rows x 32 columns of a 64-row
// pass, and every product is mma.sync m16n8k8 in 3xTF32 (mma_tf32.cuh), each
// ring tile's eight k-steps in fresh accumulators added in fp32 (so no chain
// runs longer than 8 k-steps at the full magnitude; C = 128 would be 16). The
// attention is attn_tile.cuh per (sample, head, 16 query rows, 32 output
// columns), one warp each, keys in tiles of 16 at T <= 16 and of 64 above
// with the online softmax (a warp per 32 columns recomputes the scores, so
// that all 8 warps have work where T = 64 gives 4 row tiles). The GroupNorm's
// scale and bias and the two projections' biases are staged in shared memory,
// and each projection starts its accumulators from its bias (the output
// projection also from the residual x, read again from device memory, where
// the first read left it in L2), so those loads hide under the first ring
// tile's products.
//
// The shapes the CUDA-core kernel took (T <= 256, up to 8 heads, every
// (T, C, groups) whose working set fitted one block) all run: where qkv
// does not fit beside h (T = 256 at C = 64), it goes to a scratch buffer in
// device memory that the wrapper allocates (mode 1), and where h does not
// fit either (a very wide C at T <= 4) h goes there too (mode 2); the
// attention and the projections then read their operands from there (L2)
// through the same code.
//
// bfloat16 (attn_block_bf16, the score net's bf16 compute; the `native`
// path of ops/pallas/attnblock.py:88-185): x and the output bf16; the
// GroupNorm's scale and bias, both weight matrices and both biases fp32 as
// the model holds them, the weights rounded to bf16 by the kernel (round
// to nearest even). The roundings follow the kernel body: h = bf16(bf16(
// x*bf16(rstd*gamma)) + bf16(beta - mean*rstd*gamma)) with fp32 two-pass
// statistics; qkv = bf16(fp32 sum + bias); q and k times the bf16 scale,
// rounded; the scores in fp32, p = bf16(exp(s - max) / sum) (normalised
// before rounding) for P V; the output rounded to bf16 before Wproj; the
// residual added in bf16, out = bf16(x + bf16(O Wproj + bproj)).
//
// Bound: the bytes of x in and out and of the fp32 weights (chip_smoke.py
// k3_bf16_cost), against the four products on the bf16 tensor cores.
//
// Design, for Hopper (the bf namespace below): a persistent grid of at most
// one block an SM, each of one or two warpgroups that share the weights
// (two where shared memory holds two, at 64 keys or 128). A block
// reads both weight matrices once, as fp32, rounds them and stores them as
// W^T (K-major, 128-byte-swizzled, wgmma_bf16.cuh) in shared memory, with
// each head's q, k and v rows padded to w (the head width rounded up to 16
// or 64); where they do not fit beside the rest (C above ~140), a
// warpgroup copies the 64 x 64 piece that each product needs into a slot
// instead. The first unit's x is copied while the weights load. A
// warpgroup then loops over units: S samples packed row after
// row into one 64-row tile at T <= 64 (4 at T = 16, as the TPU kernel packs
// 128 // T samples into one block-diagonal attention, :120-150), a select
// mask keeping each query to its own sample's keys; one sample in 64-row
// tiles above. The next unit's x arrives by cp.async while this one
// computes (where two x tiles fit). GroupNorm statistics by warp
// reductions, a few lanes per (sample, group), then the bf16 scale and
// shift per (sample, channel); h in shared memory, read into registers as
// the A operand of every projection. Per head, k and v of every row go to
// shared memory (K K-major; V MN-major where the chunk of a head's width is
// 64, else V^T K-major, so that narrow heads are padded to 16 only), then
// per 64 query rows: q formed in registers a chunk at a time and used as
// the A operand of S = Q K^T
// (wgmma m64nNk16, N the keys: 16 to 256), so a score row lives in the
// accumulator and the softmax takes its max and sum in one pass; P from
// registers times V; O rounded into shared memory; out = O Wproj + bproj
// in 64-column products, added to the x tile in place and stored 16 bytes
// at a time. block_plan(..., torch.bfloat16) picks the samples a unit, the
// chunk, the warpgroups, whether the weights stay resident and the x
// buffers (attnblock.py mirrors the budget below); the wide-C shapes that
// fp32 reaches only in mode 2 stay beyond it. Where the plan's samples a
// unit would leave SMs without a unit (the SSM step's B = 128 at T = 16),
// the launch takes fewer, down to one. A first k-step writes its
// accumulator (outputs only), so that no accumulator holds registers
// before its product: with that, two warpgroups a block run without
// spills at 255 registers a thread (four, at 128, spilled).

#include <cuda_bf16.h>
#include <math.h>

#include <type_traits>

#include "attn_tile.cuh"
#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPassRows = 64;  // rows of one projection pass (4 m-tiles)
// (m-tile, 32 columns) items of a pass per warp
constexpr int kItems = 2 * (kPassRows / 16) / kWarps;
constexpr int kKc = 64;        // weight rows per ring stage (8 k-steps)
constexpr int kNc = 64;        // weight columns per ring stage
constexpr int kStages = 2;
constexpr int kPadA = 4;  // rows of h/O and of q, k: width + 4 floats
constexpr int kPadV = 8;  // rows of v: width rounded up to 16, + 8
constexpr int kPadW = 8;  // ring rows: kNc + 8 floats
constexpr float kEps = 1e-5f;

__host__ __device__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Dims {
  int T, C, G, heads, ch;
  int w;    // head width rounded up to 8
  int cp;   // C rounded up to 8
  int nq;   // heads * 3 * w: the padded qkv width
  int tp;   // T rounded up to 16: rows per sample
  int S;    // samples per block
  int mode;  // 0: all on chip; 1: qkv in scratch; 2: h and qkv in scratch
  __host__ __device__ int rows() const { return S * tp; }
  __host__ __device__ int lda() const { return cp + kPadA; }
  // q and k of every head in rows of heads*2*w + 4 floats, v in rows of
  // heads*w rounded up to 16, + 8 (the fragment loads in distinct banks)
  __host__ __device__ int ldqk() const { return 2 * heads * w + kPadA; }
  __host__ __device__ int ldv() const {
    return round_up(heads * w, 16) + kPadV;
  }
  __host__ __device__ int qkv_row() const { return ldqk() + ldv(); }
};

Dims make_dims(int T, int C, int G, int heads, int S, int mode) {
  Dims d;
  d.T = T, d.C = C, d.G = G, d.heads = heads, d.ch = C / heads;
  d.w = round_up(d.ch, 8), d.cp = round_up(C, 8), d.nq = heads * 3 * d.w;
  d.tp = round_up(T, 16), d.S = S, d.mode = mode;
  return d;
}

constexpr int kRingFloats = kStages * kKc * (kNc + kPadW);

// GroupNorm scale and bias (C each), the padded qkv bias (nq) and the
// output bias (C), staged in shared memory unless mode 2
__host__ __device__ int vector_floats(const Dims& d) {
  return d.mode < 2 ? 3 * d.C + d.nq : 0;
}

// attnblock.py smem_bytes
int smem_bytes(const Dims& d) {
  const int m = d.rows();
  return 4 * ((d.mode < 2 ? m * d.lda() : 0) +
              (d.mode < 1 ? m * d.qkv_row() : 0) +
              kRingFloats + 2 * d.S * d.G + vector_floats(d));
}

// scratch floats per block in device memory (attnblock.py scratch_floats):
// qkv from mode 1; h/O and the GroupNorm's channel sums in mode 2 (else
// the sums go to the ring, which holds S*C floats in modes 0 and 1)
__host__ __device__ long long scratch_floats(const Dims& d) {
  const long long m = d.rows();
  return (d.mode >= 1 ? m * d.qkv_row() : 0) +
         (d.mode >= 2 ? m * d.lda() + d.C : 0);
}

// A 4-float (vec) or 1-float copy into shared memory by cp.async, or into
// device memory by a plain load and store; zeros where !ok.
__device__ __forceinline__ void copy_in(float* dst, const float* src, bool ok,
                                        bool vec, bool to_smem) {
  if (to_smem) {
    if (vec)
      tc::cp_async16(dst, src, ok);
    else
      tc::cp_async4(dst, src, ok);
  } else if (vec) {
    *reinterpret_cast<float4*>(dst) =
        ok ? *reinterpret_cast<const float4*>(src) : make_float4(0, 0, 0, 0);
  } else {
    *dst = ok ? *src : 0.f;
  }
}

// init(row, n) + the product A W for rows [0, M) of A (row r at
// A + r*lda, columns [0, Kp) with zeros from K on; M a multiple of 16) and
// the columns n < N of W (N a multiple of 8): W(k, n) = Wg[k*ldw + col(n)]
// where k < K and col(n) >= 0, else 0, through the ring (16-byte copies
// where vec: col maps 4 aligned columns to 4 contiguous ones). init(row, n)
// (bias, residual) of the pairs n < N is read as the first ring tile's
// products start, so its latency hides under them; calls epi(row, n, v0,
// v1) for the pairs (n, n + 1), n even, n < N, of every row.
template <class Col, class Init, class Epi>
__device__ __forceinline__ void project(const float* A, int lda, int M, int K,
                                        const float* __restrict__ Wg, int ldw,
                                        int N, Col col, bool vec, float* ring,
                                        Init init, Epi epi) {
  constexpr int ldr = kNc + kPadW, stage = kKc * ldr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int kp = round_up(K, 8);
  const int nk = (K + kKc - 1) / kKc, steps = nk * ((N + kNc - 1) / kNc);

  // a thread copies one 4-column (vec) or 1-column chunk of every
  // (kThreads / chunks)-th row of a ring tile
  const int per = vec ? 4 : 1, chunks = kNc / per;
  const int cc = (tid % chunks) * per, r0 = tid / chunks;
  auto load = [&](int p) {
    const int k0 = (p % nk) * kKc, n = (p / nk) * kNc + cc;
    float* st = ring + (p % kStages) * stage + cc;
    const int j = n < N ? col(n) : -1;
    for (int r = r0; r < kKc; r += kThreads / chunks) {
      const bool ok = j >= 0 && k0 + r < K;
      copy_in(st + r * ldr, ok ? Wg + (long long)(k0 + r) * ldw + j : Wg, ok,
              vec, true);
    }
  };

  for (int m0 = 0; m0 < M; m0 += kPassRows) {
    const int mtiles = min(kPassRows, M - m0) / 16, items = 2 * mtiles;
    float acc[kItems][4][4];
    load(0);
    tc::cp_async_commit();
    for (int p = 0; p < steps; ++p) {
      if (p + 1 < steps) load(p + 1);
      tc::cp_async_commit();
      tc::cp_async_wait_one();  // step p has landed
      __syncthreads();
      const float* st = ring + (p % kStages) * stage;
      const int kc = p % nk, ksteps = min(kKc, kp - kc * kKc) / 8;
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int item = warp + it * kWarps;
        if (item >= items) continue;
        const int mt = item % mtiles, half = item / mtiles;
        if (kc == 0) {
          const int row = m0 + mt * 16 + g;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int col0 = (p / nk) * kNc + half * 32 + n * 8 + 2 * q4;
            const float2 z = make_float2(0.f, 0.f);
            const float2 lo = col0 < N ? init(row, col0) : z;
            const float2 hi = col0 < N ? init(row + 8, col0) : z;
            acc[it][n][0] = lo.x, acc[it][n][1] = lo.y;
            acc[it][n][2] = hi.x, acc[it][n][3] = hi.y;
          }
        }
        const float* ar = A + (m0 + mt * 16 + g) * lda + kc * kKc + q4;
        float big[4][4], small[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) big[n][e] = small[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kKc / 8; ++kk) {
          if (kk < ksteps) {
            const float* a = ar + kk * 8;
            const tc::A af =
                tc::split_a(a[0], a[8 * lda], a[4], a[8 * lda + 4]);
            const float* br = st + (kk * 8 + q4) * ldr + half * 32 + g;
#pragma unroll
            for (int n = 0; n < 4; ++n)
              tc::mma3_split(big[n], small[n], af,
                             tc::split_b(br[n * 8], br[4 * ldr + n * 8]));
          }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[it][n][e] += big[n][e] + small[n][e];
        if (kc == nk - 1) {
          const int row = m0 + mt * 16 + g;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int col0 = (p / nk) * kNc + half * 32 + n * 8 + 2 * q4;
            if (col0 < N) {
              epi(row, col0, acc[it][n][0], acc[it][n][1]);
              epi(row + 8, col0, acc[it][n][2], acc[it][n][3]);
            }
          }
        }
      }
      __syncthreads();  // the stage is free for the copy two steps on
    }
  }
}

// NT, NO: key and output n-tiles per attention tile (attn_tile.cuh): 2
// where T <= 16 (w <= 16), else 8 (4)
template <int NT, int NO>
__global__ void __launch_bounds__(kThreads, 2)
attn_block_kernel(const float* __restrict__ x,
                  const float* __restrict__ gn_scale,
                  const float* __restrict__ gn_bias,
                  const float* __restrict__ wqkv,
                  const float* __restrict__ bqkv,
                  const float* __restrict__ wproj,
                  const float* __restrict__ bproj, float* __restrict__ out,
                  float* scratch, int B, Dims d, float scale2, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int T = d.T, C = d.C, tp = d.tp, M = d.rows(), lda = d.lda(),
            ldqk = d.ldqk(), ldv = d.ldv();
  const int b0 = blockIdx.x * d.S, ns = min(d.S, B - b0);
  float* sp = smem;
  float* scr = scratch + (long long)blockIdx.x * scratch_floats(d);
  float* hs = d.mode < 2 ? sp : scr;  // x, then h, then O
  if (d.mode < 2) sp += M * lda; else scr += M * lda;
  float* qk = d.mode < 1 ? sp : scr;  // q, k of each head; then v
  float* vv = qk + M * ldqk;
  if (d.mode < 1) sp += M * d.qkv_row(); else scr += M * d.qkv_row();
  float* ring = sp;
  float* stats = ring + kRingFloats;  // (mean, rstd) per (sample, group)
  float* vecs = stats + 2 * d.S * d.G;
  const int ch = d.ch, w = d.w;
  auto qkv_col = [=](int c) {  // padded column -> column of Wqkv, or -1
    const int hh = c / (3 * w), r = c - hh * 3 * w, part = r / w,
              cc = r - part * w;
    return cc < ch ? hh * 3 * ch + part * ch + cc : -1;
  };
  // the vectors, from shared memory unless mode 2
  const float* gsc = gn_scale;
  const float* gbi = gn_bias;
  const float* bq = nullptr;  // padded qkv bias
  const float* bp = bproj;
  if (d.mode < 2) {
    for (int i = tid; i < C; i += kThreads) {
      vecs[i] = __ldg(gn_scale + i);
      vecs[C + i] = __ldg(gn_bias + i);
      vecs[2 * C + i] = __ldg(bproj + i);
    }
    for (int i = tid; i < d.nq; i += kThreads) {
      const int j = qkv_col(i);
      vecs[3 * C + i] = j >= 0 ? __ldg(bqkv + j) : 0.f;
    }
    gsc = vecs, gbi = vecs + C, bp = vecs + 2 * C, bq = vecs + 3 * C;
  }
  auto qkv_bias = [=](int c) {
    if (bq) return bq[c];
    const int j = qkv_col(c);
    return j >= 0 ? __ldg(bqkv + j) : 0.f;
  };

  // x (zeros past T, past C and past the last sample)
  {
    const bool v4 = vec && C % 4 == 0;
    const int per = v4 ? 4 : 1, chunks = d.cp / per;
    for (int i = tid; i < M * chunks; i += kThreads) {
      const int r = i / chunks, c = (i - r * chunks) * per;
      const int s = r / tp, t = r - s * tp;
      const bool ok = s < ns && t < T && c < C;
      copy_in(hs + r * lda + c,
              ok ? x + ((long long)(b0 + s) * T + t) * C + c : x, ok, v4,
              d.mode < 2);
    }
    tc::cp_async_commit();
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }

  // GroupNorm statistics per (sample, group), two-pass: per-channel sums
  // over the T rows (a thread per channel: consecutive addresses), then
  // per-group sums, into the ring (free until the projections)
  const int cg = C / d.G;
  const float n_inv = 1.f / (float)(T * cg);
  float* csum = d.mode < 2 ? ring : scr;  // ns * C floats
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = tid; i < ns * C; i += kThreads) {
      const int s = i / C, c = i - s * C;
      const float* xc = hs + s * tp * lda + c;
      const float m = pass ? stats[2 * (s * d.G + c / cg)] : 0.f;
      float a = 0.f;
      for (int t = 0; t < T; ++t) {
        const float dv = xc[t * lda] - m;
        a = pass ? fmaf(dv, dv, a) : a + dv;
      }
      csum[i] = a;
    }
    __syncthreads();
    for (int pair = tid; pair < ns * d.G; pair += kThreads) {
      const int s = pair / d.G, grp = pair - s * d.G;
      float a = 0.f;
      for (int c = grp * cg; c < (grp + 1) * cg; ++c) a += csum[s * C + c];
      if (pass)
        stats[2 * pair + 1] = rsqrtf(a * n_inv + kEps);
      else
        stats[2 * pair] = a * n_inv;
    }
    __syncthreads();
  }
  for (int i = tid; i < ns * tp * C; i += kThreads) {
    const int r = i / C, c = i - r * C, s = r / tp;
    if (r - s * tp >= T) continue;
    const int pair = s * d.G + c / cg;
    float* hp = hs + r * lda + c;  // (x - mean) * rstd * scale + bias
    *hp = (*hp - stats[2 * pair]) * stats[2 * pair + 1] * gsc[c] + gbi[c];
  }
  __syncthreads();

  // qkv = h Wqkv + bqkv, each head's q, k, v padded to w with zeros
  const bool vq = vec && ch % 4 == 0;
  project(hs, lda, M, C, wqkv, 3 * C, d.nq, qkv_col, vq, ring,
          [&](int, int c) {
            return make_float2(qkv_bias(c), qkv_bias(c + 1));
          },
          [&](int row, int c, float v0, float v1) {
            const int hh = c / (3 * w), r = c - hh * 3 * w, part = r / w;
            float* dst = part < 2 ? qk + row * ldqk + hh * 2 * w + r
                                  : vv + row * ldv + hh * w + r - 2 * w;
            dst[0] = v0;
            dst[1] = v1;
          });

  // attention per (sample, head, 16 query rows, 8*NO output columns); O
  // overwrites h
  const int mtiles = tp / 16, parts = (w + 8 * NO - 1) / (8 * NO);
  const int per_sample = d.heads * mtiles * parts;
  for (int item = warp; item < ns * per_sample; item += kWarps) {
    const int s = item / per_sample, rem = item - s * per_sample;
    const int hh = rem / (mtiles * parts), rem2 = rem - hh * mtiles * parts;
    const int mt = rem2 / parts, part = rem2 - mt * parts;
    const float* qb = qk + s * tp * ldqk + hh * 2 * w;
    float* ob = hs + s * tp * lda + hh * ch;
    tc::attend16<NT, NO>(qb, ldqk, qb + w, ldqk, vv + s * tp * ldv + hh * w,
                         ldv, T, tp, w, scale2, mt * 16, part * 8 * NO,
                         (part + 1) * 8 * NO,
                         [&](int r, int c, float v0, float v1) {
                         if (r >= T || c >= ch) return;
                         ob[r * lda + c] = v0;
                         if (c + 1 < ch) ob[r * lda + c + 1] = v1;
                       });
  }
  __syncthreads();

  // out = x + bproj + O Wproj for the real rows and columns
  project(hs, lda, M, C, wproj, C, d.cp, [=](int c) { return c < C ? c : -1; },
          vec && C % 4 == 0, ring,
          [&](int row, int c) {
            const int s = row / tp, t = row - s * tp;
            if (s >= ns || t >= T) return make_float2(0.f, 0.f);
            const float* xr = x + ((long long)(b0 + s) * T + t) * C + c;
            return make_float2(c < C ? xr[0] + bp[c] : 0.f,
                               c + 1 < C ? xr[1] + bp[c + 1] : 0.f);
          },
          [&](int row, int c, float v0, float v1) {
            const int s = row / tp, t = row - s * tp;
            if (s >= ns || t >= T) return;
            float* o = out + ((long long)(b0 + s) * T + t) * C + c;
            if (c < C) o[0] = v0;
            if (c + 1 < C) o[1] = v1;
          });
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// ---- bfloat16 (attn_block_bf16) ---------------------------------------------

namespace bf {

using bf16 = __nv_bfloat16;
using bfm::pack;
using bfm::rnd;

constexpr int kGroupThreads = 128;  // a warpgroup
constexpr int kTileRows = 64;       // rows of one wgmma product (m64)
constexpr int kPadX = 8;    // rows of x, h and O: C rounded up to 16, + 8
constexpr int kSlotRows = 64;  // rows of a streamed weight piece (64 k's)
constexpr int kProjN = 64;     // output columns of one product with Wproj
constexpr float kLog2e = 1.4426950408889634f;

// warpgroups a block may hold, by the keys of the score product (its
// accumulator's registers: 32 a thread at 64 keys, 128 at 256): two give
// a thread 255 registers, which the score, q and product fragments need
// (128, under four, spilled them)
__host__ __device__ constexpr int max_groups(int nk) {
  return nk <= 128 ? 2 : 1;
}

struct Dims {
  int T, C, G, heads, ch;
  int wc;  // chunk of a head's width: 16 or 64 (the N of its products)
  int w;   // head width rounded up to wc
  int S;   // samples per unit, packed row after row (T <= 64); 1 above
  int resident;  // 1: the weights stay in shared memory for the whole block
  int nx;        // x buffers a warpgroup: 2 where the next unit's x
                 // arrives while this one computes
  __host__ __device__ int U() const { return T <= 64 ? 1 : (T + 63) / 64; }
  // rows (and keys) of a unit: S T or T, rounded up to 16
  __host__ __device__ int rows() const {
    return round_up(T <= 64 ? S * T : T, 16);
  }
  // keys of the score product (its N): 16, 32 or 64 (64 where V is
  // stored transposed, wc = 16) up to T = 64, else 64 U. It reads K's rows
  // past rows() from the memory after them, keys that the mask drops.
  __host__ __device__ int nk() const {
    const int r = rows();
    return T > 64 ? kTileRows * U()
                  : (wc == 16 || r > 32) ? 64 : r > 16 ? 32 : 16;
  }
  __host__ __device__ int cp() const { return round_up(C, 16); }
  __host__ __device__ int ldx() const { return cp() + kPadX; }
  __host__ __device__ int kb() const { return (C + 63) / 64; }
  __host__ __device__ int nq() const { return heads * 3 * w; }  // Wqkv^T
  __host__ __device__ int np() const { return round_up(C, kProjN); }
  // K: rows() keys of w channels in 64-column blocks; V (wc = 64: rows()
  // keys of w channels) or V^T (wc = 16: w channels of the keys in blocks
  // of 64)
  __host__ __device__ int k_bytes() const {
    return 128 * rows() * ((w + 63) / 64);
  }
  __host__ __device__ int v_bytes() const {
    return wc == 64 ? 2 * rows() * w : 128 * w * ((rows() + 63) / 64);
  }
  __host__ __device__ int row_bytes() const { return 2 * rows() * ldx(); }
  // a warpgroup's shared memory: K, V, the streamed weight piece (unless
  // resident), nx x buffers, h, O (own buffer where heads > 1, else h's),
  // the GroupNorm's bf16 scale and shift per (sample, channel) in fp32
  __host__ __device__ int arena() const {
    return round_up(k_bytes() + v_bytes() + (resident ? 0 : kSlotRows * 128) +
                        (nx + 1 + (heads > 1)) * row_bytes() + 8 * S * cp(),
                    1024);
  }
  __host__ __device__ int weight_bytes() const {
    return resident ? 128 * kb() * (nq() + np()) : 0;
  }
  // fp32: the GroupNorm's scale and bias, the padded output and qkv biases
  __host__ __device__ int vector_bytes() const {
    return round_up(4 * (2 * C + np() + nq()), 1024);
  }
  // attnblock.py _smem_bytes_bf16 (1,024 bytes to align the base)
  __host__ __device__ int smem(int groups) const {
    return 1024 + weight_bytes() + vector_bytes() + groups * arena();
  }
};

Dims make_dims(int T, int C, int G, int heads, int S, int wc, int resident,
               int nx) {
  Dims d;
  d.T = T, d.C = C, d.G = G, d.heads = heads, d.ch = C / heads, d.wc = wc;
  d.w = round_up(d.ch, wc), d.S = S, d.resident = resident, d.nx = nx;
  return d;
}

// a plan that the kernels take (attnblock.py block_plan gives no other)
bool valid(const Dims& d, int groups) {
  return d.T >= 1 && d.T <= 256 && d.heads >= 1 && d.heads <= 8 &&
         d.C % d.heads == 0 && d.G >= 1 && d.C % d.G == 0 &&
         (d.wc == 16 || d.wc == 64) &&
         (d.T <= 64 ? d.S >= 1 && d.S * d.T <= 64 : d.S == 1) &&
         (d.resident == 0 || d.resident == 1) && (d.nx == 1 || d.nx == 2) &&
         groups >= 1 && groups <= max_groups(d.nk()) &&
         d.smem(groups) <= 232448;
}

// row n of the padded Wqkv^T (head hh, part q/k/v, channel cc < w) -> the
// column of wqkv, or -1 past the head width
__device__ __forceinline__ int qkv_col(const Dims& d, int n) {
  const int hp = n / d.w, cc = n - hp * d.w, hh = hp / 3, part = hp - 3 * hh;
  return cc < d.ch ? hh * 3 * d.ch + part * d.ch + cc : -1;
}

// byte offset of element (r, c) of a 128-byte-swizzled tile of `rows` rows
// (wgmma_bf16.cuh: 64-column blocks, the 16-byte chunks of row r XOR r % 8)
__device__ __forceinline__ int sw(int r, int c, int rows) {
  return (c >> 6) * rows * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

__device__ __forceinline__ const bf16* as_bf(const char* p) {
  return reinterpret_cast<const bf16*>(p);
}

__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [n0, n0 + nr) of W^T, k in column blocks [0, nkb), from the
// fp32 (in, out) matrix W (row k at W + k ldw; row n of W^T is column
// col(n), zero where col(n) < 0 or k >= K), rounded to bf16 (round to
// nearest even, as .to(torch.bfloat16)) into dst, K-major: a tile of
// `rows` rows (row n - n0) in 64-column blocks. An item: 8 consecutive k of
// PER rows whose columns are PER consecutive ones of W (PER = 4: 16-byte
// loads, nr % 4 == 0, every col(n0 + 4m) a multiple of 4 or -1 for the
// four, W and ldw aligned); neighbouring threads on neighbouring items, so
// on neighbouring columns of W; two items a thread in flight.
template <int PER, class Col>
__device__ __forceinline__ void load_weights(char* dst, int rows,
                                             const float* __restrict__ W,
                                             int ldw, int K, Col col, int n0,
                                             int nr, int nkb, int t,
                                             int nthr) {
  const int nm = nr / PER, items = nm * nkb * 8;
  auto fetch = [&](int i, float (&v)[8][PER], int& r, int& blk, int& c8) {
    const int m = i % nm, rest = i / nm;
    c8 = rest & 7, blk = (rest >> 3) * rows * 128, r = m * PER;
    const int k0 = (rest >> 3) * 64 + c8 * 8, j = col(n0 + r);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool ok = j >= 0 && k0 + e < K;
      const float* src = W + (long long)(k0 + e) * ldw + j;
      if constexpr (PER == 4) {
        const float4 f = ok ? __ldg(reinterpret_cast<const float4*>(src))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        v[e][0] = f.x, v[e][1] = f.y, v[e][2] = f.z, v[e][3] = f.w;
      } else {
        v[e][0] = ok ? __ldg(src) : 0.f;
      }
    }
  };
  auto store = [&](const float (&v)[8][PER], int r, int blk, int c8) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      uint4 p;
      p.x = pack(v[0][q], v[1][q]), p.y = pack(v[2][q], v[3][q]);
      p.z = pack(v[4][q], v[5][q]), p.w = pack(v[6][q], v[7][q]);
      const int row = r + q;
      *reinterpret_cast<uint4*>(dst + blk + row * 128 +
                                ((c8 ^ (row & 7)) << 4)) = p;
    }
  };
  for (int i = t; i < items; i += 2 * nthr) {
    float v0[8][PER], v1[8][PER];
    int r0, b0, c0, r1 = 0, b1 = 0, c1 = 0;
    fetch(i, v0, r0, b0, c0);
    const bool two = i + nthr < items;
    if (two) fetch(i + nthr, v1, r1, b1, c1);
    store(v0, r0, b0, c0);
    if (two) store(v1, r1, b1, c1);
  }
}

// The same, one row and one item at a time (a streamed piece: few
// registers, as it runs inside the products' loops)
template <class Col>
__device__ __forceinline__ void load_piece(char* dst,
                                           const float* __restrict__ W,
                                           int ldw, int K, Col col, int n0,
                                           int nr, int kb, int t) {
  for (int i = t; i < nr * 8; i += kGroupThreads) {
    const int r = i % nr, c8 = i / nr, k0 = kb * 64 + c8 * 8, j = col(n0 + r);
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = j >= 0 && k0 + e < K ? __ldg(W + (long long)(k0 + e) * ldw + j)
                                  : 0.f;
    uint4 p;
    p.x = pack(v[0], v[1]), p.y = pack(v[2], v[3]);
    p.z = pack(v[4], v[5]), p.w = pack(v[6], v[7]);
    *reinterpret_cast<uint4*>(dst + r * 128 + ((c8 ^ (r & 7)) << 4)) = p;
  }
}

// acc = A B over ks k-steps: A the 64 rows of a row-major bf16 buffer at a
// (row stride ld; the warps past row rv give zeros) from registers, B the
// K-major weight rows that piece(kb) returns for k-steps 4 kb..4 kb + 3.
// The first k-step writes acc (outputs only), so that acc holds no
// registers before the product.
template <int N, class Piece>
__device__ __forceinline__ void product(float (&acc)[N / 2], const bf16* a,
                                        int ld, int rv, int ks, Piece piece) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, q4 = lane & 3;
  const bf16* ar = a + 16 * warp * ld;
  const bool live = 16 * warp < rv;
  auto step = [&](int kb, auto first) {
    const uint64_t db = wg::desc_k(as_bf(piece(kb)));
    uint32_t f[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (live && 4 * kb + i < ks)
        bfm::load_a(f[i], ar + 16 * (4 * kb + i), ld, g, q4);
      else
        f[i][0] = f[i][1] = f[i][2] = f[i][3] = 0u;
      wg::pin(f[i]);
    }
    if constexpr (!decltype(first)::value) wg::pin(acc);
    wg::fence();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (decltype(first)::value) {
        if (i == 0) {
          wg::mma_rs_k_first<N>(acc, f[0], db);
          continue;
        }
      }
      if (4 * kb + i < ks) wg::mma_rs_k<N>(acc, f[i], db + 2 * i, 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::pin(acc);
  };
  step(0, std::true_type());
  for (int kb = 1; 4 * kb < ks; ++kb) step(kb, std::false_type());
}

// NK: keys of the score product (Dims::nk); WC: Dims::wc
template <int NK, int WC>
__global__ void __launch_bounds__(kGroupThreads * max_groups(NK), 1)
attn_block_bf16_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ gn_scale,
                       const float* __restrict__ gn_bias,
                       const float* __restrict__ wqkv,
                       const float* __restrict__ bqkv,
                       const float* __restrict__ wproj,
                       const float* __restrict__ bproj,
                       bf16* __restrict__ out, int B, Dims d, float qk_scale,
                       bool vec, bool vec4) {
  extern __shared__ __align__(16) float smem_f[];
  char* base = wg::align1024(smem_f);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int groups = nthr / kGroupThreads, grp = tid / kGroupThreads;
  const int lt = tid % kGroupThreads, bar = 1 + grp;
  const int warp = lt >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int T = d.T, C = d.C, ch = d.ch, w = d.w, ldx = d.ldx();
  const int RA = d.rows(), U = d.U(), nq = d.nq(), np = d.np();
  const int cp = d.cp(), kbn = d.kb();

  char* wq_s = base;                      // Wqkv^T, resident
  char* wp_s = base + 128 * kbn * nq;     // Wproj^T, resident
  float* gsc = reinterpret_cast<float*>(base + d.weight_bytes());
  float* gbi = gsc + C;
  float* bp = gbi + C;                    // np: zero past C
  float* bq = bp + np;                    // nq: the padded Wqkv^T's rows
  char* ks = base + d.weight_bytes() + d.vector_bytes() + grp * d.arena();
  char* vs = ks + d.k_bytes();
  char* slot = vs + d.v_bytes();
  bf16* xb = reinterpret_cast<bf16*>(slot + (d.resident ? 0 : kSlotRows * 128));
  bf16* hs = xb + d.nx * RA * ldx;        // h; O too where heads == 1
  bf16* os = d.heads > 1 ? hs + RA * ldx : hs;
  float* ss = reinterpret_cast<float*>(os + RA * ldx);  // (scale, shift)

  auto wcol = [&](int n) { return qkv_col(d, n); };
  auto pcol = [&](int n) { return n < C ? n : -1; };
  for (int i = tid; i < C; i += nthr) {
    gsc[i] = __ldg(gn_scale + i);
    gbi[i] = __ldg(gn_bias + i);
  }
  for (int i = tid; i < np; i += nthr) bp[i] = i < C ? __ldg(bproj + i) : 0.f;
  for (int i = tid; i < nq; i += nthr) {
    const int j = wcol(i);
    bq[i] = j >= 0 ? __ldg(bqkv + j) : 0.f;
  }
  if (d.heads > 1)  // O's columns past C, never written, read as zeros
    for (int i = lt; i < RA * (cp - C); i += kGroupThreads)
      os[i / (cp - C) * ldx + C + i % (cp - C)] = __float2bfloat16(0.f);

  // the weight rows [n0, n0 + N) for k-steps 4 kb..: in place where
  // resident, else copied into the slot (after every warp's last product
  // from it, and published before the product)
  auto piece = [&](const char* res, int rows, const float* W, int ldw,
                   auto col, int n0, int N) {
    return [=, &d](int kb) -> const char* {
      if (d.resident) return res + kb * rows * 128 + n0 * 128;
      group_sync(bar);
      load_piece(slot, W, ldw, C, col, n0, N, kb, lt);
      wg::fence_smem();
      group_sync(bar);
      return slot;
    };
  };

  const int S = d.S, units = (B + S - 1) / S;
  const int stride = gridDim.x * groups;
  const long long unit_elems = (long long)S * T * C;
  // the unit's rows (S samples one after the other, or one sample), zero
  // past its real rows and past C
  auto load_x = [&](bf16* dst, int u) {
    const int nr = min(S, B - u * S) * T;
    const bf16* src = x + u * unit_elems;
    if (vec) {
      const int chunks = cp / 8;
      for (int i = lt; i < RA * chunks; i += kGroupThreads) {
        const int r = i / chunks, c = (i - r * chunks) * 8;
        const bool ok = r < nr && c < C;
        bfm::cp16(dst + r * ldx + c, ok ? src + (long long)r * C + c : src,
                  ok);
      }
    } else {
      for (int i = lt; i < RA * cp; i += kGroupThreads) {
        const int r = i / cp, c = i - r * cp;
        dst[r * ldx + c] = r < nr && c < C ? src[(long long)r * C + c]
                                           : __float2bfloat16(0.f);
      }
    }
  };

  const int cg = C / d.G, kc = cp / 16, kq = (ch + 15) / 16;
  const float n_inv = 1.f / (float)(T * cg);
  int u = blockIdx.x * groups + grp;
  if (u < units) load_x(xb, u);  // the first unit's x under the weights'
  tc::cp_async_commit();
  if (d.resident) {  // every weight once, for every unit of the block
    if (vec4) {
      load_weights<4>(wq_s, nq, wqkv, 3 * C, C, wcol, 0, nq, kbn, tid, nthr);
      load_weights<4>(wp_s, np, wproj, C, C, pcol, 0, np, kbn, tid, nthr);
    } else {
      load_weights<1>(wq_s, nq, wqkv, 3 * C, C, wcol, 0, nq, kbn, tid, nthr);
      load_weights<1>(wp_s, np, wproj, C, C, pcol, 0, np, kbn, tid, nthr);
    }
  }
  wg::fence_smem();
  __syncthreads();
  for (int it = 0; u < units; ++it, u += stride) {
    bf16* xs = xb + (d.nx == 2 ? it & 1 : 0) * RA * ldx;
    if (d.nx == 2) {  // the next unit's x arrives under this one
      if (u + stride < units)
        load_x(xb + ((it + 1) & 1) * RA * ldx, u + stride);
      tc::cp_async_commit();
      bfm::cp_async_wait<1>();
    } else {
      if (it > 0) load_x(xs, u);
      tc::cp_async_commit();
      bfm::cp_async_wait<0>();
    }
    group_sync(bar);
    const int ns = min(S, B - u * S);
    const int rr = ns * T;  // real rows (and keys) of this unit

    // GroupNorm statistics in fp32, two-pass, per (sample, group): k
    // neighbouring lanes (a power of two up to 32) split its rows and add
    // their sums by shuffles; then its channels' scale bf16(rstd*gamma) and
    // shift bf16(beta - mean*rstd*gamma), per (sample, channel)
    {
      const int pairs = ns * d.G;
      int k = 1;
      while (k < 32 && 2 * k * pairs <= kGroupThreads) k *= 2;
      for (int p0 = 0; p0 < pairs; p0 += kGroupThreads / k) {
        const int p = p0 + lt / k, sub = lt % k;
        const bool on = p < pairs;
        const int s = on ? p / d.G : 0, c0 = (on ? p - s * d.G : 0) * cg;
        const bf16* xp = xs + s * T * ldx + c0;
        // two bf16 a load where the group's channels pair up (cg even:
        // c0 even too), two sums in flight
        float a0 = 0.f, a1 = 0.f;
        if (on && cg % 2 == 0) {
          for (int t = sub; t < T; t += k)
            for (int c = 0; c < cg; c += 2) {
              const float2 v = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(xp + t * ldx + c));
              a0 += v.x, a1 += v.y;
            }
        } else if (on) {
          for (int t = sub; t < T; t += k)
            for (int c = 0; c < cg; ++c)
              a0 += __bfloat162float(xp[t * ldx + c]);
        }
        float a = a0 + a1;
        for (int o = k / 2; o; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        const float mean = a * n_inv;
        a0 = a1 = 0.f;
        if (on && cg % 2 == 0) {
          for (int t = sub; t < T; t += k)
            for (int c = 0; c < cg; c += 2) {
              const float2 v = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(xp + t * ldx + c));
              a0 = fmaf(v.x - mean, v.x - mean, a0);
              a1 = fmaf(v.y - mean, v.y - mean, a1);
            }
        } else if (on) {
          for (int t = sub; t < T; t += k)
            for (int c = 0; c < cg; ++c) {
              const float dv = __bfloat162float(xp[t * ldx + c]) - mean;
              a0 = fmaf(dv, dv, a0);
            }
        }
        a = a0 + a1;
        for (int o = k / 2; o; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        const float rstd = rsqrtf(a * n_inv + kEps);
        if (on)
          for (int c = c0 + sub; c < c0 + cg; c += k) {
            const float av = rstd * gsc[c];
            ss[2 * (s * cp + c)] = rnd(av);
            ss[2 * (s * cp + c) + 1] = rnd(gbi[c] - mean * av);
          }
      }
    }
    group_sync(bar);
    // h = bf16(bf16(x * scale) + shift), zero past the real rows and past C
    for (int i = lt; i < RA * (cp / 8); i += kGroupThreads) {
      const int r = i / (cp / 8), c0 = (i - r * (cp / 8)) * 8;
      uint4 hp = make_uint4(0u, 0u, 0u, 0u);
      if (r < rr) {
        const uint4 xv = *reinterpret_cast<const uint4*>(xs + r * ldx + c0);
        const bf16* xe = reinterpret_cast<const bf16*>(&xv);
        const float4* sp =
            reinterpret_cast<const float4*>(ss + 2 * (r / T * cp + c0));
        float hv[8];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 f = sp[q];
          hv[2 * q] = rnd(__bfloat162float(xe[2 * q]) * f.x) + f.y;
          hv[2 * q + 1] = rnd(__bfloat162float(xe[2 * q + 1]) * f.z) + f.w;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (c0 + e >= C) hv[e] = 0.f;
        hp.x = pack(hv[0], hv[1]), hp.y = pack(hv[2], hv[3]);
        hp.z = pack(hv[4], hv[5]), hp.w = pack(hv[6], hv[7]);
      }
      *reinterpret_cast<uint4*>(hs + r * ldx + c0) = hp;
    }
    group_sync(bar);

    for (int hh = 0; hh < d.heads; ++hh) {
      // this head's k and v of every row of the unit: bf16(h Wqkv + b), k
      // times the bf16 scale, rounded; into K (K-major) and V (MN-major
      // where wc = 64, else V^T K-major)
      for (int r = 0; r < U; ++r) {
        for (int j = 0; j < w / WC; ++j) {
#pragma unroll 1
          for (int part = 1; part < 3; ++part) {
            const int n0 = (hh * 3 + part) * w + j * WC;
            float acc[WC / 2];
            product<WC>(acc, hs + r * kTileRows * ldx, ldx,
                        RA - r * kTileRows, kc,
                        piece(wq_s, nq, wqkv, 3 * C, wcol, n0, WC));
#pragma unroll
            for (int nt = 0; nt < WC / 8; ++nt) {
              const int cc = j * WC + nt * 8 + 2 * q4;  // channel of w
              const float b0 = bq[n0 + nt * 8 + 2 * q4];
              const float b1 = bq[n0 + nt * 8 + 2 * q4 + 1];
#pragma unroll
              for (int h2 = 0; h2 < 2; ++h2) {
                const int row = r * kTileRows + 16 * warp + g + 8 * h2;
                if (row >= RA) continue;
                const float v0 = rnd(acc[4 * nt + 2 * h2] + b0);
                const float v1 = rnd(acc[4 * nt + 2 * h2 + 1] + b1);
                if (part == 1) {
                  *reinterpret_cast<uint32_t*>(ks + sw(row, cc, RA)) =
                      pack(v0 * qk_scale, v1 * qk_scale);
                } else if (WC == 64) {
                  *reinterpret_cast<uint32_t*>(vs + sw(row, cc, RA)) =
                      pack(v0, v1);
                } else {
                  *reinterpret_cast<bf16*>(vs + sw(cc, row, w)) =
                      __float2bfloat16_rn(v0);
                  *reinterpret_cast<bf16*>(vs + sw(cc + 1, row, w)) =
                      __float2bfloat16_rn(v1);
                }
              }
            }
          }
        }
      }
      wg::fence_smem();
      group_sync(bar);

      // per 64 query rows: S = q K^T over the head's k-steps, q = bf16(
      // bf16(h Wq + b) times the bf16 scale) formed a chunk at a time in
      // registers as the A operand; the softmax in registers in one pass;
      // p = bf16(exp(s - max) / sum); O = P V, rounded to bf16 into O
      const int keys = rr, kv = (keys + 15) / 16;
      for (int r = 0; r < U; ++r) {
        // q of chunk j in registers, then S (+)= Q_j K_j^T; chunk 0's first
        // k-step writes S
        float s[NK / 2];
        auto score_chunk = [&](int j, auto first) {
          const int n0 = hh * 3 * w + j * WC;
          float qa[WC / 2];
          product<WC>(qa, hs + r * kTileRows * ldx, ldx, RA - r * kTileRows,
                      kc, piece(wq_s, nq, wqkv, 3 * C, wcol, n0, WC));
          uint32_t qf[WC / 16][4];
#pragma unroll
          for (int kk = 0; kk < WC / 16; ++kk) {
            float c0[4], c1[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = n0 + 16 * kk + 2 * q4 + (e & 1);
              c0[e] = rnd(qa[8 * kk + e] + bq[col]) * qk_scale;
              c1[e] = rnd(qa[8 * kk + 4 + e] + bq[col + 8]) * qk_scale;
            }
            bfm::pack_a(qf[kk], c0, c1);
            wg::pin(qf[kk]);
          }
          if constexpr (!decltype(first)::value) wg::pin(s);
          wg::fence();
#pragma unroll
          for (int kk = 0; kk < WC / 16; ++kk) {
            const int k = j * (WC / 16) + kk;
            const uint64_t dk =
                wg::desc_k(as_bf(ks)) + wg::k_step(RA, k);
            if constexpr (decltype(first)::value) {
              if (kk == 0) {
                wg::mma_rs_k_first<NK>(s, qf[0], dk);
                continue;
              }
            }
            if (k < kq) wg::mma_rs_k<NK>(s, qf[kk], dk, 1);
          }
          wg::commit();
          wg::wait<0>();
          wg::pin(s);
        };
        score_chunk(0, std::true_type());
        for (int j = 1; j < w / WC; ++j) score_chunk(j, std::false_type());
        // the keys of row i: its own sample's, [lo, hi)
        int lo[2], hi[2];
        float mc[2], inv[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int i = r * kTileRows + 16 * warp + g + 8 * h2;
          lo[h2] = T <= 64 ? i / T * T : 0;
          hi[h2] = min(lo[h2] + T, keys);
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < NK / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int jk = nt * 8 + 2 * q4 + e;
              if (jk >= lo[h2] && jk < hi[h2])
                mx = fmaxf(mx, s[4 * nt + 2 * h2 + e]);
            }
          mx = tc::quad_max(mx);
          mc[h2] = mx == -INFINITY ? 0.f : mx * kLog2e;  // no key: p = 0
        }
        float l[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < NK / 8; ++nt)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int jk = nt * 8 + 2 * q4 + e;
              float& v = s[4 * nt + 2 * h2 + e];
              v = jk >= lo[h2] && jk < hi[h2]
                      ? wg::ex2(fmaf(v, kLog2e, -mc[h2]))
                      : 0.f;
              l[h2] += v;
            }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          l[h2] = tc::quad_sum(l[h2]);
          inv[h2] = l[h2] > 0.f ? 1.f / l[h2] : 0.f;
        }
        uint32_t pf[NK / 16][4];
#pragma unroll
        for (int kk = 0; kk < NK / 16; ++kk) {
          float c0[4], c1[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            c0[e] = s[8 * kk + e] * inv[e >> 1];
            c1[e] = s[8 * kk + 4 + e] * inv[e >> 1];
          }
          bfm::pack_a(pf[kk], c0, c1);
          wg::pin(pf[kk]);
        }
        for (int j = 0; j < w / WC; ++j) {
          float o[WC / 2];  // its first k-step writes it
          wg::fence();
#pragma unroll
          for (int kk = 0; kk < NK / 16; ++kk) {
            if (kk >= kv) continue;
            if constexpr (WC == 64) {
              const uint64_t dv = wg::desc_mn(as_bf(vs + j * RA * 128), RA) +
                                  wg::mn_step(kk);
              if (kk == 0)
                wg::mma_rs_first<64>(o, pf[0], dv);
              else
                wg::mma_rs<64>(o, pf[kk], dv, 1);
            } else {
              const uint64_t dv =
                  wg::desc_k(as_bf(vs + j * WC * 128)) + wg::k_step(w, kk);
              if (kk == 0)
                wg::mma_rs_k_first<WC>(o, pf[0], dv);
              else
                wg::mma_rs_k<WC>(o, pf[kk], dv, 1);
            }
          }
          wg::commit();
          wg::wait<0>();
          wg::pin(o);
#pragma unroll
          for (int nt = 0; nt < WC / 8; ++nt)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int row = r * kTileRows + 16 * warp + g + 8 * h2;
              const int cc = j * WC + nt * 8 + 2 * q4;
              if (row >= RA || cc >= ch) continue;
              bf16* op = os + row * ldx + hh * ch + cc;
              const float v0 = o[4 * nt + 2 * h2], v1 = o[4 * nt + 2 * h2 + 1];
              if (cc + 1 < ch && ((hh * ch + cc) & 1) == 0) {
                *reinterpret_cast<uint32_t*>(op) = pack(v0, v1);
              } else {
                op[0] = __float2bfloat16_rn(v0);
                if (cc + 1 < ch) op[1] = __float2bfloat16_rn(v1);
              }
            }
        }
      }
      group_sync(bar);  // O of this head written; K and V free
    }

    // out = bf16(x + bf16(O Wproj + bproj)), into the x tile in place, then
    // stored 16 bytes at a time
    for (int r = 0; r < U; ++r)
      for (int nc = 0; nc < np / kProjN; ++nc) {
        float acc[kProjN / 2];
        product<kProjN>(acc, os + r * kTileRows * ldx, ldx,
                        RA - r * kTileRows, kc,
                        piece(wp_s, np, wproj, C, pcol, nc * kProjN, kProjN));
#pragma unroll
        for (int nt = 0; nt < kProjN / 8; ++nt)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int row = r * kTileRows + 16 * warp + g + 8 * h2;
            const int c = nc * kProjN + nt * 8 + 2 * q4;
            if (row >= rr || c >= C) continue;
            bf16* xp = xs + row * ldx + c;
            const float y0 =
                __bfloat162float(xp[0]) + rnd(acc[4 * nt + 2 * h2] + bp[c]);
            if (c + 1 < C) {
              const float y1 = __bfloat162float(xp[1]) +
                               rnd(acc[4 * nt + 2 * h2 + 1] + bp[c + 1]);
              *reinterpret_cast<__nv_bfloat162*>(xp) =
                  __floats2bfloat162_rn(y0, y1);
            } else {
              xp[0] = __float2bfloat16_rn(y0);
            }
          }
      }
    group_sync(bar);
    bf16* dst = out + u * unit_elems;
    if (vec) {
      const int chunks = C / 8;
      for (int i = lt; i < rr * chunks; i += kGroupThreads) {
        const int r = i / chunks, c = (i - r * chunks) * 8;
        *reinterpret_cast<uint4*>(dst + (long long)r * C + c) =
            *reinterpret_cast<const uint4*>(xs + r * ldx + c);
      }
    } else {
      for (int i = lt; i < rr * C; i += kGroupThreads) {
        const int r = i / C;
        dst[i] = xs[r * ldx + i - r * C];
      }
    }
    group_sync(bar);  // the x tile is free for the copy a unit on
  }
}

}  // namespace bf

}  // namespace

// S samples per block and the mode as attnblock.py block_plan chose them;
// smem as its smem_bytes computes it, refused (cudaErrorInvalidValue) if
// this file computes another; scratch: scratch_floats per block, or null in
// mode 0. scale is s = ch^-1/4.
extern "C" int attn_block_f32(const float* x, const float* gn_scale,
                              const float* gn_bias, const float* wqkv,
                              const float* bqkv, const float* wproj,
                              const float* bproj, float* out, float* scratch,
                              int B, int T, int C, int G, int heads, int S,
                              int mode, int smem, float scale, void* stream) {
  if (B == 0) return 0;
  const Dims d = make_dims(T, C, G, heads, S, mode);
  if (smem != smem_bytes(d) || (mode > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(x) && aligned16(wqkv) && aligned16(wproj) &&
                   aligned16(scratch);
  auto kernel = d.tp == 16 ? (d.w <= 16 ? attn_block_kernel<2, 2>
                                         : attn_block_kernel<2, 4>)
                            : (d.w <= 16 ? attn_block_kernel<8, 2>
                                         : attn_block_kernel<8, 4>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + S - 1) / S, kThreads, smem, (cudaStream_t)stream>>>(
      x, gn_scale, gn_bias, wqkv, bqkv, wproj, bproj, out, scratch, B, d,
      scale * scale, vec);
  return (int)cudaGetLastError();
}

// K3 in bf16: x and out (B, T, C) bf16; the GroupNorm's scale and bias,
// wqkv (C, 3C) and wproj (C, C) as (in, out), bqkv and bproj fp32, as the
// model holds them (the kernel rounds the weights to bf16). S, wc, groups
// (warpgroups a block), resident and nx as attnblock.py block_plan chose
// them for bf16; smem as its _smem_bytes_bf16 computes it, refused
// (cudaErrorInvalidValue) if this file computes another or the kernels do
// not take the plan. A launch takes fewer warpgroups a block where the
// units would not fill every SM, and at most one block an SM. scale: the
// qk scale ch^-1/4 already rounded to bf16.
extern "C" int attn_block_bf16(const __nv_bfloat16* x, const float* gn_scale,
                               const float* gn_bias, const float* wqkv,
                               const float* bqkv, const float* wproj,
                               const float* bproj, __nv_bfloat16* out, int B,
                               int T, int C, int G, int heads, int S, int wc,
                               int groups, int resident, int nx, int smem,
                               float scale, void* stream) {
  if (B == 0) return 0;
  const bf::Dims plan = bf::make_dims(T, C, G, heads, S, wc, resident, nx);
  if (!bf::valid(plan, groups) || smem != plan.smem(groups))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // fewer samples a unit where the plan's would leave SMs without one
  // (the SSM step's B = 128 at T = 16: 128 units of one sample, not 32 of
  // four); every size below the plan's fits
  const int s_used = B / sms < S ? (B / sms > 0 ? B / sms : 1) : S;
  const bf::Dims d = bf::make_dims(T, C, G, heads, s_used, wc, resident, nx);
  S = s_used;
  const int units = (B + S - 1) / S;
  int used = (units + sms - 1) / sms;
  used = used < groups ? used : groups;
  const int blocks = (units + used - 1) / used < sms ? (units + used - 1) / used
                                                     : sms;
  const int bytes = d.smem(used);
  const bool vec = C % 8 == 0 && aligned16(x) && aligned16(out);
  // 16-byte weight loads: 4 columns of one head part at a time
  const bool vec4 = (C / heads) % 4 == 0 && aligned16(wqkv) &&
                    aligned16(wproj);
  using Fn = decltype(&bf::attn_block_bf16_kernel<64, 64>);
  Fn kernel = nullptr;
  switch (d.nk() * 100 + wc) {
    case 1664: kernel = bf::attn_block_bf16_kernel<16, 64>; break;
    case 3264: kernel = bf::attn_block_bf16_kernel<32, 64>; break;
    case 6416: kernel = bf::attn_block_bf16_kernel<64, 16>; break;
    case 6464: kernel = bf::attn_block_bf16_kernel<64, 64>; break;
    case 12816: kernel = bf::attn_block_bf16_kernel<128, 16>; break;
    case 12864: kernel = bf::attn_block_bf16_kernel<128, 64>; break;
    case 19216: kernel = bf::attn_block_bf16_kernel<192, 16>; break;
    case 19264: kernel = bf::attn_block_bf16_kernel<192, 64>; break;
    case 25616: kernel = bf::attn_block_bf16_kernel<256, 16>; break;
    case 25664: kernel = bf::attn_block_bf16_kernel<256, 64>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, bf::kGroupThreads * used, bytes, (cudaStream_t)stream>>>(
      x, gn_scale, gn_bias, wqkv, bqkv, wproj, bproj, out, B, d, scale, vec,
      vec4);
  return (int)cudaGetLastError();
}
