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
// path of ops/pallas/attnblock.py:88-185): x and the output bf16, the
// GroupNorm's scale and bias and both biases fp32, the two weight matrices
// cast to bf16 and transposed by the wrapper (one copy each per call, so
// that a B fragment's two k's are adjacent). The four products run on
// mma.sync m16n8k16 with bf16 operands and fp32 accumulation, one product
// per tile (no split). The roundings follow the kernel body: h = bf16(bf16(
// x*bf16(rstd*gamma)) + bf16(beta - mean*rstd*gamma)) with fp32 statistics;
// qkv accumulated in fp32 plus the bias, then cast to bf16; q and k scaled
// by the bf16 scale in bf16; the scores in fp32, the softmax in fp32 (a
// first pass over the key tiles for the row max and sum, a second that
// recomputes the scores where there is more than one tile) and p =
// bf16(exp(s - max) / sum) for P V; the output cast to bf16 before Wproj;
// the residual added in bf16, out = bf16(x + bf16(O Wproj + bproj)).
// Shared memory holds everything in bf16 (halving the fp32 plan: 56 KB at
// (T, C) = (64, 64), 98 KB at (16, 128) with 4 samples) and only mode 0:
// block_plan gives no bf16 plan where that does not fit, and the wrapper
// raises. Bound: bf16 tensor cores (989 TFLOP/s) or the bytes of x in and
// out, whichever is larger.

#include <cuda_bf16.h>
#include <math.h>

#include "attn_tile.cuh"
#include "mma_bf16.cuh"

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
using bfm::cp16;
using bfm::ld2;
using bfm::load_a;
using bfm::mma;
using bfm::pack;
using bfm::rnd;

constexpr int kPadR = 8;  // ring rows (an output column's k's): kKc + 8
constexpr int kRing = kStages * kNc * (kKc + kPadR);  // bf16 elements

struct Dims {
  int T, C, G, heads, ch;
  int w;   // head width rounded up to 16 (the k-steps of Q K^T)
  int cp;  // C rounded up to 16
  int nq;  // heads * 3 * w: the padded qkv width
  int tp;  // T rounded up to 16: rows (and keys) per sample
  int S;   // samples per block
  __host__ __device__ int rows() const { return S * tp; }
  __host__ __device__ int lda() const { return cp + 8; }  // x, h, O
  __host__ __device__ int ldqk() const { return 2 * heads * w + 8; }
  __host__ __device__ int ldvt() const { return tp + 8; }  // V^T rows
  // fp32: (mean, rstd) per (sample, group), the channel sums, the
  // GroupNorm's scale and bias, the output bias and the padded qkv bias,
  // rounded up to 16 bytes
  __host__ __device__ int floats() const {
    return round_up(2 * S * G + S * C + 3 * C + nq, 4);
  }
};

Dims make_dims(int T, int C, int G, int heads, int S) {
  Dims d;
  d.T = T, d.C = C, d.G = G, d.heads = heads, d.ch = C / heads;
  d.w = round_up(d.ch, 16), d.cp = round_up(C, 16), d.nq = heads * 3 * d.w;
  d.tp = round_up(T, 16), d.S = S;
  return d;
}

// attnblock.py smem_bytes for bf16
int smem_bytes(const Dims& d) {
  const int m = d.rows();
  return 4 * d.floats() + 2 * (kRing + m * d.lda() + m * d.ldqk() +
                               d.S * d.heads * d.w * d.ldvt());
}

// init(row, n) + A W for rows [0, M) of A (bf16, row r at A + r*lda,
// columns [0, round_up(K, 16)) with zeros from K on) and the columns n < N
// of W, stored transposed: W(k, n) = Wt[col(n)*ldw + k] where col(n) >= 0
// and k < K, else 0. Wt's rows stream through the ring in tiles of kNc
// columns x kKc k's (16-byte copies where vec: K % 8 == 0 and Wt aligned,
// else element by element); a warp takes 16 rows x 32 columns of a 64-row
// pass, fp32 accumulators from init(row, n) (the bias); epi(row, n, v0, v1)
// for the pairs (n, n + 1), n even, n < N, of every row.
template <class Col, class Init, class Epi>
__device__ __forceinline__ void project(const bf16* A, int lda, int M, int K,
                                        const bf16* __restrict__ Wt, int ldw,
                                        int N, Col col, bool vec, bf16* ring,
                                        Init init, Epi epi) {
  constexpr int ldr = kKc + kPadR, stage = kNc * ldr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int kp = round_up(K, 16);
  const int nk = (K + kKc - 1) / kKc, steps = nk * ((N + kNc - 1) / kNc);

  auto load = [&](int p) {
    const int k0 = (p % nk) * kKc, n0 = (p / nk) * kNc;
    bf16* st = ring + (p % kStages) * stage;
    if (vec) {
      constexpr int chunks = kKc / 8;
      for (int i = tid; i < kNc * chunks; i += kThreads) {
        const int r = i / chunks, kc = (i - r * chunks) * 8;
        const int j = n0 + r < N ? col(n0 + r) : -1;
        const bool ok = j >= 0 && k0 + kc < K;
        cp16(st + r * ldr + kc, ok ? Wt + (long long)j * ldw + k0 + kc : Wt,
             ok);
      }
    } else {
      for (int i = tid; i < kNc * kKc; i += kThreads) {
        const int r = i / kKc, kc = i - r * kKc;
        const int j = n0 + r < N ? col(n0 + r) : -1;
        const bool ok = j >= 0 && k0 + kc < K;
        st[r * ldr + kc] =
            ok ? Wt[(long long)j * ldw + k0 + kc] : __float2bfloat16(0.f);
      }
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
      const bf16* st = ring + (p % kStages) * stage;
      const int kc = p % nk, ksteps = min(kKc, kp - kc * kKc) / 16;
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int item = warp + it * kWarps;
        if (item >= items) continue;
        const int mt = item % mtiles, half = item / mtiles;
        const int row = m0 + mt * 16 + g;
        if (kc == 0) {
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
        const bf16* ar = A + (m0 + mt * 16) * lda + kc * kKc;
#pragma unroll
        for (int kk = 0; kk < kKc / 16; ++kk) {
          if (kk < ksteps) {
            uint32_t a[4];
            load_a(a, ar + kk * 16, lda, g, q4);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const bf16* br =
                  st + (half * 32 + n * 8 + g) * ldr + kk * 16 + 2 * q4;
              mma(acc[it][n], a, ld2(br), ld2(br + 8));
            }
          }
        }
        if (kc == nk - 1) {
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

// NT, NO: key and output n-tiles per attention tile: 2 where T <= 16
// (w <= 16), else 8 (4)
template <int NT, int NO>
__global__ void __launch_bounds__(kThreads, 2)
attn_block_bf16_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ gn_scale,
                       const float* __restrict__ gn_bias,
                       const bf16* __restrict__ wqkv_t,
                       const float* __restrict__ bqkv,
                       const bf16* __restrict__ wproj_t,
                       const float* __restrict__ bproj,
                       bf16* __restrict__ out, int B, Dims d, float qk_scale,
                       bool vec) {
  extern __shared__ __align__(16) float smem_f[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int T = d.T, C = d.C, tp = d.tp, M = d.rows(), lda = d.lda(),
            ldqk = d.ldqk(), ldvt = d.ldvt(), ch = d.ch, w = d.w;
  const int b0 = blockIdx.x * d.S, ns = min(d.S, B - b0);
  float* stats = smem_f;              // (mean, rstd) per (sample, group)
  float* csum = stats + 2 * d.S * d.G;  // per (sample, channel)
  float* gsc = csum + d.S * C;
  float* gbi = gsc + C;
  float* bp = gbi + C;
  float* bq = bp + C;                 // padded qkv bias
  bf16* ring = reinterpret_cast<bf16*>(smem_f + d.floats());
  bf16* hs = ring + kRing;            // x, then h, then O
  bf16* qk = hs + M * lda;            // q, k of each head
  bf16* vt = qk + M * ldqk;           // v^T per (sample, head, channel)
  auto qkv_col = [=](int c) {  // padded column -> row of Wqkv^T, or -1
    const int hh = c / (3 * w), r = c - hh * 3 * w, part = r / w,
              cc = r - part * w;
    return cc < ch ? hh * 3 * ch + part * ch + cc : -1;
  };
  for (int i = tid; i < C; i += kThreads) {
    gsc[i] = __ldg(gn_scale + i);
    gbi[i] = __ldg(gn_bias + i);
    bp[i] = __ldg(bproj + i);
  }
  for (int i = tid; i < d.nq; i += kThreads) {
    const int j = qkv_col(i);
    bq[i] = j >= 0 ? __ldg(bqkv + j) : 0.f;
  }

  // x (zeros past T, past C and past the last sample)
  if (vec) {
    const int chunks = d.cp / 8;
    for (int i = tid; i < M * chunks; i += kThreads) {
      const int r = i / chunks, c = (i - r * chunks) * 8;
      const int s = r / tp, t = r - s * tp;
      const bool ok = s < ns && t < T && c < C;
      cp16(hs + r * lda + c, ok ? x + ((long long)(b0 + s) * T + t) * C + c
                                : x, ok);
    }
  } else {
    for (int i = tid; i < M * d.cp; i += kThreads) {
      const int r = i / d.cp, c = i - r * d.cp;
      const int s = r / tp, t = r - s * tp;
      const bool ok = s < ns && t < T && c < C;
      hs[r * lda + c] = ok ? x[((long long)(b0 + s) * T + t) * C + c]
                           : __float2bfloat16(0.f);
    }
  }
  tc::cp_async_commit();
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // GroupNorm statistics per (sample, group) in fp32, two-pass, from
  // per-channel sums over the T rows
  const int cg = C / d.G;
  const float n_inv = 1.f / (float)(T * cg);
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = tid; i < ns * C; i += kThreads) {
      const int s = i / C, c = i - s * C;
      const bf16* xc = hs + s * tp * lda + c;
      const float m = pass ? stats[2 * (s * d.G + c / cg)] : 0.f;
      float a = 0.f;
      for (int t = 0; t < T; ++t) {
        const float dv = __bfloat162float(xc[t * lda]) - m;
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
  // h = bf16(bf16(x * bf16(rstd*gamma)) + bf16(beta - mean*rstd*gamma))
  for (int i = tid; i < ns * tp * C; i += kThreads) {
    const int r = i / C, c = i - r * C, s = r / tp;
    if (r - s * tp >= T) continue;
    const int pair = s * d.G + c / cg;
    const float a = stats[2 * pair + 1] * gsc[c];
    const float sc = rnd(a), sh = rnd(gbi[c] - stats[2 * pair] * a);
    bf16* hp = hs + r * lda + c;
    *hp = __float2bfloat16_rn(rnd(__bfloat162float(*hp) * sc) + sh);
  }
  __syncthreads();

  // qkv = bf16(h Wqkv + bqkv); q and k times the bf16 scale, rounded; v
  // transposed
  project(hs, lda, M, C, wqkv_t, C, d.nq, qkv_col, vec, ring,
          [&](int, int c) { return make_float2(bq[c], bq[c + 1]); },
          [&](int row, int c, float v0, float v1) {
            const int hh = c / (3 * w), r = c - hh * 3 * w, part = r / w;
            const float a0 = rnd(v0), a1 = rnd(v1);
            if (part < 2) {
              *reinterpret_cast<uint32_t*>(qk + row * ldqk + hh * 2 * w + r) =
                  pack(a0 * qk_scale, a1 * qk_scale);
            } else {
              const int s = row / tp, t = row - s * tp;
              bf16* dst = vt + ((s * d.heads + hh) * w + r - 2 * w) * ldvt + t;
              dst[0] = __float2bfloat16_rn(a0);
              dst[ldvt] = __float2bfloat16_rn(a1);
            }
          });

  // attention per (sample, head, 16 query rows, 8*NO output columns); O
  // (bf16) overwrites h
  const int mtiles = tp / 16, parts = (w + 8 * NO - 1) / (8 * NO);
  const int per_sample = d.heads * mtiles * parts;
  for (int item = warp; item < ns * per_sample; item += kWarps) {
    const int s = item / per_sample, rem = item - s * per_sample;
    const int hh = rem / (mtiles * parts), rem2 = rem - hh * mtiles * parts;
    const int mt = rem2 / parts, part = rem2 - mt * parts;
    const bf16* qb = qk + s * tp * ldqk + hh * 2 * w;
    bf16* ob = hs + s * tp * lda + hh * ch;
    // the scores are those of the scaled q and k: times 1
    bfm::attend16<NT, NO>(qb, qb + w, ldqk,
                          vt + (s * d.heads + hh) * w * ldvt, ldvt, T, tp,
                          w, 1.f, mt * 16, part * 8 * NO,
                          (part + 1) * 8 * NO,
                     [&](int r, int c, float v0, float v1) {
                       if (r >= T || c >= ch) return;
                       ob[r * lda + c] = __float2bfloat16_rn(v0);
                       if (c + 1 < ch)
                         ob[r * lda + c + 1] = __float2bfloat16_rn(v1);
                     });
  }
  __syncthreads();

  // out = bf16(x + bf16(O Wproj + bproj)) for the real rows and columns
  project(hs, lda, M, C, wproj_t, C, d.cp,
          [=](int c) { return c < C ? c : -1; }, vec, ring,
          [&](int, int c) {
            return make_float2(c < C ? bp[c] : 0.f,
                               c + 1 < C ? bp[c + 1] : 0.f);
          },
          [&](int row, int c, float v0, float v1) {
            const int s = row / tp, t = row - s * tp;
            if (s >= ns || t >= T) return;
            const long long o = ((long long)(b0 + s) * T + t) * C + c;
            if (c < C)
              out[o] = __float2bfloat16_rn(__bfloat162float(x[o]) + rnd(v0));
            if (c + 1 < C)
              out[o + 1] =
                  __float2bfloat16_rn(__bfloat162float(x[o + 1]) + rnd(v1));
          });
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

// K3 in bf16: x and out (B, T, C) bf16; wqkv_t (3C, C) and wproj_t (C, C)
// the weights transposed (row n: output column n) in bf16; gn_scale,
// gn_bias, bqkv, bproj fp32. S samples per block as attnblock.py
// block_plan chose them for bf16 (all in shared memory); smem as its
// smem_bytes computes it, refused if this file computes another. scale:
// the qk scale ch^-1/4 already rounded to bf16.
extern "C" int attn_block_bf16(const __nv_bfloat16* x, const float* gn_scale,
                               const float* gn_bias,
                               const __nv_bfloat16* wqkv_t, const float* bqkv,
                               const __nv_bfloat16* wproj_t,
                               const float* bproj, __nv_bfloat16* out, int B,
                               int T, int C, int G, int heads, int S,
                               int smem, float scale, void* stream) {
  if (B == 0) return 0;
  const bf::Dims d = bf::make_dims(T, C, G, heads, S);
  if (smem != bf::smem_bytes(d)) return (int)cudaErrorInvalidValue;
  const bool vec = C % 8 == 0 && aligned16(x) && aligned16(wqkv_t) &&
                   aligned16(wproj_t);
  auto kernel = d.tp == 16 ? (d.w <= 16 ? bf::attn_block_bf16_kernel<2, 2>
                                         : bf::attn_block_bf16_kernel<2, 4>)
                            : (d.w <= 16 ? bf::attn_block_bf16_kernel<8, 2>
                                         : bf::attn_block_bf16_kernel<8, 4>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + S - 1) / S, kThreads, smem, (cudaStream_t)stream>>>(
      x, gn_scale, gn_bias, wqkv_t, bqkv, wproj_t, bproj, out, B, d, scale,
      vec);
  return (int)cudaGetLastError();
}
