// K7b: the backward of the attention core from the forward's lse, on the
// tensor cores, float32 in and out.
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
// sdeflow_tpu/ops/pallas/attention.py:371-452 (pallas_call :445), the
// backward of the reverse-mode pair whose forward is K7a (flash_fwd.cu,
// qkv_attention_stats_f32). The TPU runs one grid step per sample, in
// order, and carries dQ in VMEM across its key tiles. Hopper's blocks run
// in parallel and carry nothing between them, so each block owns the dK and
// dV of its keys and adds its share of dQ into dqkv with atomics.
//
// Bound on the H100: operations. The five products are 10 T^2 ch flops per
// head and sample, 3x that in TF32 for the split: 0.26 ms at (4, 4096, 64)
// at 494.7 TFLOP/s dense TF32, against 0.012 ms for its 40 MB at
// 3.35 TB/s.
//
// Design, one pass: one block of 4 warps per (sample, head, 64 keys); warp
// w owns keys 16w..16w+15. The block keeps its K rows (times s) and V rows
// in shared memory and splits their fragments as it loads them. Query
// tiles of Q rows (64, or 32 at the padded width W = 128, where 64 would
// spill registers), with their dO rows, lse and delta, stream through a
// two-stage cp.async ring (16-byte copies where ch and C are multiples of 4
// and the tensors 16-byte aligned, 4-byte copies otherwise; zeros past T
// and past ch). Per query tile a warp forms on mma.sync m16n8k8 in 3xTF32
// (mma_tf32.cuh):
//   S^T = K Q^T (times s), P^T = exp(S^T - lse), dP^T = V dO^T,
//   dS^T = P^T o (dP^T - delta), all in registers (S^T's k-steps each in a
//   fresh accumulator, tc::mma3_add, as K7a forms the scores behind lse,
//   so that both sides of S^T - lse carry the same rounding); then
//   dV += P^T dO and dK += dS^T Q, accumulated in registers across the
//   tiles, with P^T and dS^T turned into A operands by quad shuffles.
// dS^T then goes to a 64 x (rows + 8) tile over the stage's Q and dO rows,
// which the tile no longer needs; after a barrier each warp forms a 16-row
// slab (or half of one) of the tile's dQ = dS (K s) from it and the
// resident K, and adds dQ*s into dqkv's q slots with
// atomicAdd. The wrapper zeroes dqkv first. Rows past T and keys past T are
// masked out of P. dK*s and dV have one writer, the keys' owner, which adds
// its register accumulators into them every kFlush query tiles and restarts
// them, so that no tensor-core accumulation chain spans more than kFlush
// tiles (mma_tf32.cuh says why).
//
// So the sum behind each dQ element is taken in an order that changes from
// run to run (the atomics from the T/64 key blocks arrive in any order): two
// runs on the same inputs agree to rounding, not bit for bit. dK and dV have
// one writer each and are the same on every run.
//
// Shared memory: 105,472 bytes at W = 64, so two blocks (8 warps) share an
// SM; 135,680 at W = 128 (one block).
//
// What it does about the limits of the two-pass CUDA-core kernel it
// replaces: (1) all five products run on the tensor cores; (2) a
// shared-memory load feeds a whole 16x8x8 product instead of about one FMA
// (K and V fragments are loaded once per k-step and reused for every
// query n-tile; rows padded to W+4 floats, the dS^T tile to rows+8, so most
// fragment loads fall in distinct banks and the rest in two); (3) one pass:
// s and dO v^T are formed once, 10 T^2 ch flops instead of 14, and key and
// query tiles are 64 rows, so each Q/dO row is fetched T/64 times; (4) the
// copy of the next query tile runs under the current tile's products.
//
// bfloat16 (qkv_attention_bwd_bf16; the score net's bf16 compute on the
// unfused route): qkv and dout bf16, lse and delta fp32, dqkv bf16. The JAX
// kernel body computes in fp32 throughout on the widened inputs (q*s and
// k*s fp32, dO and v cast to fp32; :383-420) and rounds dqkv to bf16 once
// (:421-433). Three places where that is easy to lose, and what this
// design does:
//   (a) every sum is rounded to bf16 once: dK and dV stay in one block's
//       registers over all queries, dQ in another block's over all keys
//       (two kernels, below), and each writes its part of dqkv once. No
//       atomics, no scratch: two runs agree bit for bit.
//   (b) p = exp(S - lse) drifts above 1 unless S here is K7a's S: the
//       scores are formed as flash_fwd.cu's bf16 body forms them behind
//       lse, the fp32 sum of the exact products of the raw bf16 q and k
//       over the same k-steps in one chain on wgmma, the scale s^2 folded
//       into the exponent's FMA (S^T = K Q^T and S = Q K^T take the same
//       products).
//   (c) dP = dO V^T has bf16 operands, so a bf16 product is exact up to
//       its fp32 sums. P^T dO, dS^T Q and dS K take fp32 P and dS: each
//       goes in as two bf16 halves, hi = bf16(x) and lo = bf16(x - hi)
//       (mma_bf16.cuh), against the bf16 dO, q or k, two bf16 products
//       where 3xTF32 takes three TF32 ones: hi + lo holds x to about
//       2^-17 of |x|, far below the bf16 rounding of dqkv, so the split
//       loses nothing that the output keeps.
// The sums run in the tensor cores' fp32 accumulators over whole key or
// query loops (mma_tf32.cuh: a 4096-key chain lies ~3e-5 of the max from
// fp32), two orders of magnitude below dqkv's bf16 rounding. The products
// run on wgmma (wgmma_bf16.cuh), whose 64-row tiles read their second
// factor from shared memory once per warpgroup, where mma.sync's 16-row
// tiles read it once per warp.
// Bound: the five products once over 989 TFLOP/s dense bf16, 0.043 ms at
// (4, 4096, 64) and 1.39 ms at (128, 4096, 64), against 0.004 ms for the
// former's 15 MB (the split's second products and the dQ kernel's
// recomputed S and dP are the design's choice, not counted: with them the
// products take 10/5 of the bound).

#include <math.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 16 * kWarps;  // keys per block
constexpr int kQRows = 64;          // query rows per tile
constexpr int kQRowsWide = 32;      // ... at the padded width kWideFrom
constexpr int kWideFrom = 128;
constexpr int kStages = 2;
constexpr int kPadQK = 4;  // K, V, Q and dO rows: W + 4 floats
constexpr int kPadDS = 8;  // dS^T rows: query rows + 8 floats
constexpr int kFlush = 4;  // query tiles between moves of dK, dV to memory

template <int W>
struct Layout {
  static constexpr int rows = W >= kWideFrom ? kQRowsWide : kQRows;
  static constexpr int ld = W + kPadQK, lds = rows + kPadDS;
  static constexpr int kv = 2 * kKeys * ld;               // K (scaled), V
  static constexpr int stage = 2 * rows * ld + 2 * rows;  // Q, dO, lse, delta
  static constexpr int floats = kv + kStages * stage;
  static constexpr int bytes = 4 * floats;
  // dS^T (kKeys x lds) reuses the Q and dO rows of its stage
  static_assert(kKeys * lds <= 2 * rows * ld, "dS^T must fit its stage");
};

template <int W>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dqkv,
                 int T, int heads, int ch, float scale, bool vec) {
  using L = Layout<W>;
  constexpr int R = L::rows;
  constexpr int NQ = R / 8;  // query n-tiles of S^T; k-steps of dV, dK
  constexpr int NO = W / 8;  // channel n-tiles of dK, dV
  // dQ: R/16 row slabs of 16, each split over kWarps/(R/16) warps by
  // channel n-tiles
  constexpr int kSlabWarps = kWarps / (R / 16);
  constexpr int NQO = NO / kSlabWarps;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;  // the block's keys times s
  float* vs = ks + kKeys * L::ld;
  float* ring = vs + kKeys * L::ld;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int nk = (T + kKeys - 1) / kKeys;
  const int kt = (int)(blockIdx.x % nk);
  const int hh = (int)((blockIdx.x / nk) % heads);
  const long long b = (long long)blockIdx.x / ((long long)nk * heads);
  const long long C = (long long)heads * ch, C3 = 3 * C;
  const long long stat = (b * heads + hh) * T;
  const float* head = qkv + b * T * C3 + hh * 3 * ch;  // row t at + t*C3
  const float* dohead = dout + b * T * C + hh * ch;    // row t at + t*C
  float* dhead = dqkv + b * T * C3 + hh * 3 * ch;
  const int j0 = kt * kKeys;
  const int nq = (T + R - 1) / R;

  auto load_tile = [&](int i) {
    float* st = ring + (i & 1) * L::stage;
    tc::load_rows<R, W, kThreads>(st, L::ld, head, C3, i * R, T, ch, vec);
    tc::load_rows<R, W, kThreads>(st + R * L::ld, L::ld, dohead, C, i * R, T,
                                  ch, vec);
    float* ls = st + 2 * R * L::ld;
    for (int r = tid; r < R; r += kThreads) {
      const int t = i * R + r;
      tc::cp_async4(ls + r, lse + stat + (t < T ? t : 0), t < T);
      tc::cp_async4(ls + R + r, delta + stat + (t < T ? t : 0), t < T);
    }
  };
  load_tile(0);
  tc::cp_async_commit();

  for (int i = tid; i < kKeys * W; i += kThreads) {
    const int r = i / W, c = i - r * W, t = j0 + r;
    const bool ok = t < T && c < ch;
    const float* row = head + (long long)t * C3;
    ks[r * L::ld + c] = ok ? row[ch + c] * scale : 0.f;
    vs[r * L::ld + c] = ok ? row[2 * ch + c] : 0.f;
  }

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int kr0 = warp * 16 + g;  // this lane's keys kr0 and kr0 + 8
  const bool key_ok[2] = {j0 + kr0 < T, j0 + kr0 + 8 < T};

  for (int it = 0; it < nq; ++it) {
    if (it + 1 < nq) load_tile(it + 1);
    tc::cp_async_commit();
    tc::cp_async_wait_one();  // tile it has landed
    __syncthreads();          // for every thread's copies (and K, V)
    float* qs = ring + (it & 1) * L::stage;
    const float* dos = qs + R * L::ld;
    const float* ls = dos + R * L::ld;
    const float* ds = ls + R;
    float* dst = qs;  // dS^T, once Q and dO are consumed
    const int i0 = it * R;

    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < W / 8; ++kk) {
      const int c = kk * 8 + q4;
      const int o0 = kr0 * L::ld + c, o1 = o0 + 8 * L::ld;
      const tc::A ka = tc::split_a(ks[o0], ks[o1], ks[o0 + 4], ks[o1 + 4]);
      const tc::A va = tc::split_a(vs[o0], vs[o1], vs[o0 + 4], vs[o1 + 4]);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int qo = (n * 8 + g) * L::ld + c;
        tc::mma3_add(s[n], ka, tc::split_b(qs[qo], qs[qo + 4]));
        tc::mma3(dp[n], va, tc::split_b(dos[qo], dos[qo + 4]));
      }
    }
    // P^T and dS^T; element e of n-tile n: key kr0 + 8(e >> 1), query
    // n*8 + 2*q4 + (e & 1) of the tile
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + 2 * q4 + (e & 1);
        const bool ok = key_ok[e >> 1] && i0 + qi < T;
        const float p = ok ? expf(s[n][e] * scale - ls[qi]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - ds[qi]);
      }
    // dV += P^T dO and dK += dS^T Q over the tile's queries
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
      const tc::A pa = tc::relayout(s[kk], lane);
      const tc::A da = tc::relayout(dp[kk], lane);
      const int ro = (kk * 8 + q4) * L::ld + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int o = ro + n * 8;
        tc::mma3(dv[n], pa, tc::split_b(dos[o], dos[o + 4 * L::ld]));
        tc::mma3(dk[n], da, tc::split_b(qs[o], qs[o + 4 * L::ld]));
      }
    }
    __syncthreads();  // every warp is done with Q and dO
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[(kr0 + 8 * (e >> 1)) * L::lds + n * 8 + 2 * q4 + (e & 1)] =
            dp[n][e];
    __syncthreads();  // dS^T complete
    {
      // dQ of the tile: rows 16*slab.., channel n-tiles n0.. of this warp
      const int slab = warp / kSlabWarps, n0 = (warp % kSlabWarps) * NQO;
      const int qr = slab * 16 + g;
      float dq[NQO][4];
#pragma unroll
      for (int n = 0; n < NQO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeys / 8; ++kk) {
        const int key = kk * 8 + q4;
        const float* d0 = dst + key * L::lds + qr;
        const float* d1 = d0 + 4 * L::lds;
        const tc::A a = tc::split_a(d0[0], d0[8], d1[0], d1[8]);
        const int ko = key * L::ld + n0 * 8 + g;
#pragma unroll
        for (int n = 0; n < NQO; ++n) {
          const int o = ko + n * 8;
          tc::mma3(dq[n], a, tc::split_b(ks[o], ks[o + 4 * L::ld]));
        }
      }
#pragma unroll
      for (int n = 0; n < NQO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = i0 + qr + 8 * (e >> 1);
          const int c = (n0 + n) * 8 + 2 * q4 + (e & 1);
          if (t < T && c < ch)
            atomicAdd(dhead + (long long)t * C3 + c, dq[n][e] * scale);
        }
    }
    if ((it + 1) % kFlush == 0 || it + 1 == nq) {
      // add the accumulators into this block's own dK (times s^2) and dV
      // rows of dqkv (zero on entry) and restart them: no mma chain runs
      // longer than kFlush tiles (mma_tf32.cuh says why)
      const float s2 = scale * scale;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = j0 + kr0 + 8 * h;
        float* row = dhead + (long long)t * C3;
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n * 8 + 2 * q4 + e;
            if (t < T && c < ch) {
              row[ch + c] += dk[n][2 * h + e] * s2;
              row[2 * ch + c] += dv[n][2 * h + e];
            }
            dk[n][2 * h + e] = dv[n][2 * h + e] = 0.f;
          }
      }
    }
    __syncthreads();  // the stage and dS^T are free again
  }
}

template <int W>
int launch_w(long long B, int T, int heads, int smem, cudaStream_t stream,
             const float* qkv, const float* dout, const float* lse,
             const float* delta, float* dqkv, int ch, float scale, bool vec) {
  if (smem != Layout<W>::bytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = B * heads * ((T + kKeys - 1) / kKeys);
  flash_bwd_kernel<W><<<(unsigned int)blocks, kThreads, smem, stream>>>(
      qkv, dout, lse, delta, dqkv, T, heads, ch, scale, vec);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// ---- bfloat16 -------------------------------------------------------------
//
// Two kernels, launched one after the other by the bf16 entry, each the
// single writer of its part of dqkv, so that every sum stays in registers
// until it is rounded to bf16 once and two runs agree bit for bit; one
// warpgroup a block, every product on wgmma (wgmma_bf16.cuh), every tile
// in its swizzled layout:
//   flash_bwd_dkdv_bf16_kernel: one block per (sample, head, 64 keys), the
//     keys' K and V rows resident; query tiles (Q and dO rows, lse, delta)
//     stream through a kBfStages-deep cp.async ring. Per tile
//     S^T = K Q^T and dP^T = V dO^T (both operands from shared memory),
//     P^T and dS^T in registers, dV += P^T dO and dK += dS^T Q (A from
//     registers, dO and Q MN-major) into accumulators that live across
//     the whole query loop.
//   flash_bwd_dq_bf16_kernel: one block per (sample, head, 64 queries),
//     the queries' Q and dO rows resident and lse, delta in registers; key
//     tiles (K and V rows) stream through the ring. Per tile S = Q K^T and
//     dP = dO V^T again, P and dS in registers, dQ += dS K (K MN-major).
// The dQ kernel recomputes S and dP: ten products' worth of work where the
// one-pass design took eight, in place of T/64 atomic adds into every dQ
// element and a read-modify-write of an fp32 scratch every few tiles.
// Registers decide the speed: the dK/dV kernel holds dK, dV, S^T, dP^T
// and the split P^T, dS^T at once (~250 a thread, two blocks an SM), the
// dQ kernel ~170 (three). Beside the products, the per-element work is
// what costs: p = 2^(s c - lse log2 e) takes one FMA and the SFU's ex2
// (c = s^2 log2 e), lse and delta are read once per query column, and the
// first k-step of a score product overwrites its accumulator (no
// zeroing).
constexpr int kBfQueries = 16 * kWarps;  // queries per block of the dQ kernel
constexpr int kBfStages = 3;             // ring depth of both kernels

// rows: query rows per tile of the dK/dV kernel and key rows per tile of
// the dQ kernel (Layout<W>::rows: 64, or 32 at W = 128); W: 64 or 128
// (head widths up to 64 take 64, the swizzle's column block). Every tile
// starts on a 1,024-byte boundary (the first 1,024 bytes align the base).
template <int W>
struct LayoutBf {
  static constexpr int rows = Layout<W>::rows;
  static constexpr int tile = 2 * rows * W;  // bytes of one streamed tile
  // dK/dV: the block's K and V rows, stages of Q and dO rows, then each
  // stage's lse and delta
  static constexpr int kv_bytes = 2 * 2 * kKeys * W;
  static constexpr int stage_bytes = 2 * tile;
  static constexpr int bytes =
      1024 + kv_bytes + kBfStages * (stage_bytes + 2 * 4 * rows);
  // dQ: the block's Q and dO rows, then stages of K and V rows
  static constexpr int qo_bytes = 2 * 2 * kBfQueries * W;
  static constexpr int dq_bytes = 1024 + qo_bytes + kBfStages * 2 * tile;
};

// p = exp(s s^2 - lse) = 2^(s c - lse log2 e) of the raw score sum s (the
// scores as K7a forms them behind lse), c = s^2 log2(e), b = lse log2(e);
// then ds = p (dp - delta)
__device__ __forceinline__ void softmax_grad(float& s, float& dp, float c,
                                             float b, float d) {
  const float p = wg::ex2(fmaf(s, c, -b));
  s = p;
  dp = p * (dp - d);
}

// rows [t0, t0 + 16) of a warp's accumulator tiles acc[NO][4] (C layout)
// times mul, rounded to bf16, into the rows of out (row t at out + t*stride)
template <int NO>
__device__ __forceinline__ void store_rows(bfm::bf16* out, long long stride,
                                           const float (&acc)[NO][4],
                                           float mul, int t0, int T, int ch,
                                           int g, int q4) {
  const bool pairs = (ch & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + g + 8 * h;
    if (t >= T) continue;
    bfm::bf16* row = out + (long long)t * stride;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * q4;
      const float v0 = acc[n][2 * h] * mul, v1 = acc[n][2 * h + 1] * mul;
      if (pairs && c < ch) {
        *reinterpret_cast<__nv_bfloat162*>(row + c) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < ch) row[c] = __float2bfloat16_rn(v0);
        if (c + 1 < ch) row[c + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// Both kernels run one loop over the streamed tiles. Per tile i: the
// softmax of its scores (in registers since the last wait) into the split
// A operands; the products that take them (dV, dK or dQ) issued; then,
// past the barrier that publishes tile i + 1, its score products issued
// into the same score registers; one wait for both. So the tensor cores
// take each tile's two groups of products back to back, and there is one
// wait and one barrier per tile. At that barrier the stage of tile i - 1
// is free (its last reader waited before it), and the copy of tile i + 2
// goes there: a three-stage ring.
template <int W>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkdv_bf16_kernel(const bfm::bf16* __restrict__ qkv,
                           const bfm::bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bfm::bf16* __restrict__ dqkv, int T, int heads,
                           int ch, float scale2, bool vec) {
  using bfm::bf16;
  using L = LayoutBf<W>;
  constexpr int R = L::rows;
  constexpr int NQ = R / 8;  // query n-tiles of S^T
  constexpr int NO = W / 8;  // channel n-tiles of dK, dV
  extern __shared__ __align__(16) float smem[];
  char* raw = wg::align1024(smem);
  bf16* ks = reinterpret_cast<bf16*>(raw);  // the block's raw K rows
  bf16* vs = ks + kKeys * W;
  char* ring = raw + L::kv_bytes;
  float* stats = reinterpret_cast<float*>(ring + kBfStages * L::stage_bytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int nk = (T + kKeys - 1) / kKeys;
  const int kt = (int)(blockIdx.x % nk);
  const int hh = (int)((blockIdx.x / nk) % heads);
  const long long b = (long long)blockIdx.x / ((long long)nk * heads);
  const long long C = (long long)heads * ch, C3 = 3 * C;
  const long long stat = (b * heads + hh) * T;
  const bf16* head = qkv + b * T * C3 + hh * 3 * ch;  // row t at + t*C3
  const bf16* dohead = dout + b * T * C + hh * ch;    // row t at + t*C
  const int j0 = kt * kKeys;
  const int nq = (T + R - 1) / R;
  const float sc = scale2 * 1.4426950408889634f, log2e = 1.4426950408889634f;

  auto qtile = [&](int i) {
    return reinterpret_cast<bf16*>(ring + (i % kBfStages) * L::stage_bytes);
  };
  auto load_tile = [&](int i) {
    bf16* st = qtile(i);
    wg::load_tile<R, W, kThreads>(st, head, C3, i * R, T, ch, vec);
    wg::load_tile<R, W, kThreads>(st + R * W, dohead, C, i * R, T, ch, vec);
    float* ls = stats + (i % kBfStages) * 2 * R;
    for (int r = tid; r < R; r += kThreads) {
      const int t = i * R + r;
      tc::cp_async4(ls + r, lse + stat + (t < T ? t : 0), t < T);
      tc::cp_async4(ls + R + r, delta + stat + (t < T ? t : 0), t < T);
    }
  };
  float s[NQ][4], dp[NQ][4];
  // S^T = K Q^T and dP^T = V dO^T of tile i, exact products of bf16
  // operands, issued and committed
  const uint64_t dks = wg::desc_k(ks), dvs = wg::desc_k(vs);
  auto scores = [&](int i) {
    const bf16* qs = qtile(i);
    const uint64_t dqs = wg::desc_k(qs), dos = wg::desc_k(qs + R * W);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {  // k-step 0 overwrites
      wg::mma_ss<R>(wg::flat<R>(s), dks + wg::k_step(kKeys, kk),
                    dqs + wg::k_step(R, kk), kk > 0);
      wg::mma_ss<R>(wg::flat<R>(dp), dvs + wg::k_step(kKeys, kk),
                    dos + wg::k_step(R, kk), kk > 0);
    }
    wg::commit();
  };

  wg::load_tile<kKeys, W, kThreads>(ks, head + ch, C3, j0, T, ch, vec);
  wg::load_tile<kKeys, W, kThreads>(vs, head + 2 * ch, C3, j0, T, ch, vec);
  load_tile(0);
  tc::cp_async_commit();
  if (nq > 1) load_tile(1);
  tc::cp_async_commit();
  bfm::cp_async_wait<1>();  // K, V and tile 0 have landed
  wg::fence_smem();
  __syncthreads();
  scores(0);
  wg::wait<0>();

  float dk[NO][4], dv[NO][4];
  wg::zero(dk);
  wg::zero(dv);
  const int kr0 = warp * 16 + g;  // this lane's keys kr0 and kr0 + 8
  const bool key_ok[2] = {j0 + kr0 < T, j0 + kr0 + 8 < T};

  for (int it = 0; it < nq; ++it) {
    const bf16* qs = qtile(it);
    const float* ls = stats + (it % kBfStages) * 2 * R;
    const float* dls = ls + R;
    const int i0 = it * R;
    // P^T and dS^T; element e of n-tile n: key kr0 + 8(e >> 1), query
    // n*8 + 2*q4 + (e & 1) of the tile; masked keys and queries get 0
    const bool edge = !key_ok[1] || i0 + R > T;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // query column n*8 + 2*q4 + c
        const int qi = n * 8 + 2 * q4 + c;
        const float bq = ls[qi] * log2e, dd = dls[qi];
#pragma unroll
        for (int e = c; e < 4; e += 2) {
          softmax_grad(s[n][e], dp[n][e], sc, bq, dd);
          if (edge && !(key_ok[e >> 1] && i0 + qi < T))
            s[n][e] = dp[n][e] = 0.f;
        }
      }
    // dV += P^T dO and dK += dS^T Q over the tile's queries, P^T and dS^T
    // in two bf16 halves each
    uint32_t ph[NQ / 2][4], pl[NQ / 2][4], dh[NQ / 2][4], dl[NQ / 2][4];
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {  // queries 16kk..16kk+15
      bfm::split_a(ph[kk], pl[kk], s[2 * kk], s[2 * kk + 1]);
      bfm::split_a(dh[kk], dl[kk], dp[2 * kk], dp[2 * kk + 1]);
    }
    const uint64_t dqs = wg::desc_mn(qs, R), dos = wg::desc_mn(qs + R * W, R);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {
      const uint64_t o = dos + wg::mn_step(kk), q = dqs + wg::mn_step(kk);
      wg::mma_rs<W>(wg::flat<W>(dv), pl[kk], o, 1);
      wg::mma_rs<W>(wg::flat<W>(dv), ph[kk], o, 1);
      wg::mma_rs<W>(wg::flat<W>(dk), dl[kk], q, 1);
      wg::mma_rs<W>(wg::flat<W>(dk), dh[kk], q, 1);
    }
    wg::commit();
    if (it + 1 < nq) {
      bfm::cp_async_wait<0>();  // tile it + 1 has landed
      wg::fence_smem();
      __syncthreads();  // for every thread's copies; stage it - 1 is free
      if (it + 2 < nq) load_tile(it + 2);
      tc::cp_async_commit();
      scores(it + 1);
    }
    wg::wait<0>();
  }
  // dK = dS^T (q s) s and dV, each written once, rounded to bf16
  bf16* dhead = dqkv + b * T * C3 + hh * 3 * ch;
  store_rows<NO>(dhead + ch, C3, dk, scale2, j0 + warp * 16, T, ch, g, q4);
  store_rows<NO>(dhead + 2 * ch, C3, dv, 1.f, j0 + warp * 16, T, ch, g, q4);
}

template <int W>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_bf16_kernel(const bfm::bf16* __restrict__ qkv,
                         const bfm::bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bfm::bf16* __restrict__ dqkv, int T, int heads,
                         int ch, float scale2, bool vec) {
  using bfm::bf16;
  using L = LayoutBf<W>;
  constexpr int R = L::rows;
  constexpr int NK = R / 8;  // key n-tiles of S
  constexpr int NO = W / 8;  // channel n-tiles of dQ
  extern __shared__ __align__(16) float smem[];
  char* raw = wg::align1024(smem);
  bf16* qs = reinterpret_cast<bf16*>(raw);  // the block's raw Q rows
  bf16* dos = qs + kBfQueries * W;
  char* ring = raw + L::qo_bytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int nqb = (T + kBfQueries - 1) / kBfQueries;
  const int qt = (int)(blockIdx.x % nqb);
  const int hh = (int)((blockIdx.x / nqb) % heads);
  const long long b = (long long)blockIdx.x / ((long long)nqb * heads);
  const long long C = (long long)heads * ch, C3 = 3 * C;
  const long long stat = (b * heads + hh) * T;
  const bf16* head = qkv + b * T * C3 + hh * 3 * ch;  // row t at + t*C3
  const int i0 = qt * kBfQueries;
  const int nk = (T + R - 1) / R;
  const float sc = scale2 * 1.4426950408889634f;

  auto ktile = [&](int j) {
    return reinterpret_cast<bf16*>(ring + (j % kBfStages) * 2 * L::tile);
  };
  auto load_tile = [&](int j) {
    bf16* st = ktile(j);
    wg::load_tile<R, W, kThreads>(st, head + ch, C3, j * R, T, ch, vec);
    wg::load_tile<R, W, kThreads>(st + R * W, head + 2 * ch, C3, j * R, T,
                                  ch, vec);
  };
  // S = Q K^T and dP = dO V^T of tile j into s, dp, over the same k-steps
  // as S^T above; issued and committed
  const uint64_t dqs = wg::desc_k(qs), dos_ = wg::desc_k(dos);
  auto scores = [&](float (&s)[NK][4], float (&dp)[NK][4], int j) {
    const bf16* ks = ktile(j);
    const uint64_t dks = wg::desc_k(ks), dvs = wg::desc_k(ks + R * W);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {  // k-step 0 overwrites
      wg::mma_ss<R>(wg::flat<R>(s), dqs + wg::k_step(kBfQueries, kk),
                    dks + wg::k_step(R, kk), kk > 0);
      wg::mma_ss<R>(wg::flat<R>(dp), dos_ + wg::k_step(kBfQueries, kk),
                    dvs + wg::k_step(R, kk), kk > 0);
    }
    wg::commit();
  };

  // this lane's queries r0 and r0 + 8 of the block: lse log2(e) and delta
  const int r0 = i0 + warp * 16 + g;
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = r0 + 8 * h;
    lr[h] = t < T ? lse[stat + t] * 1.4426950408889634f : 0.f;
    dr[h] = t < T ? delta[stat + t] : 0.f;
  }
  float dq[NO][4];
  wg::zero(dq);

  wg::load_tile<kBfQueries, W, kThreads>(qs, head, C3, i0, T, ch, vec);
  wg::load_tile<kBfQueries, W, kThreads>(dos, dout + b * T * C + hh * ch, C,
                                         i0, T, ch, vec);
  load_tile(0);
  tc::cp_async_commit();
  if (nk > 1) load_tile(1);
  tc::cp_async_commit();
  bfm::cp_async_wait<1>();  // Q, dO and tile 0 have landed
  wg::fence_smem();
  __syncthreads();
  float s[NK][4], dp[NK][4];
  scores(s, dp, 0);
  wg::wait<0>();

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * R;
    // P and dS; element e of n-tile n: query r0 + 8(e >> 1), key
    // k0 + n*8 + 2*q4 + (e & 1); keys past T get 0
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        softmax_grad(s[n][e], dp[n][e], sc, lr[e >> 1], dr[e >> 1]);
        if (k0 + R > T && k0 + n * 8 + 2 * q4 + (e & 1) >= T)
          dp[n][e] = 0.f;
      }
    // dQ += dS K over the tile's keys, dS in two bf16 halves
    uint32_t dh[NK / 2][4], dl[NK / 2][4];
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk)  // keys 16kk..16kk+15
      bfm::split_a(dh[kk], dl[kk], dp[2 * kk], dp[2 * kk + 1]);
    const uint64_t dkm = wg::desc_mn(ktile(j), R);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      const uint64_t k = dkm + wg::mn_step(kk);
      wg::mma_rs<W>(wg::flat<W>(dq), dl[kk], k, 1);
      wg::mma_rs<W>(wg::flat<W>(dq), dh[kk], k, 1);
    }
    wg::commit();
    if (j + 1 < nk) {
      bfm::cp_async_wait<0>();  // tile j + 1 has landed
      wg::fence_smem();
      __syncthreads();  // for every thread's copies; stage j - 1 is free
      if (j + 2 < nk) load_tile(j + 2);
      tc::cp_async_commit();
      scores(s, dp, j + 1);
    }
    wg::wait<0>();
  }
  // dQ = dS (k s) s, written once, rounded to bf16
  store_rows<NO>(dqkv + b * T * C3 + hh * 3 * ch, C3, dq, scale2,
                 i0 + warp * 16, T, ch, g, q4);
}

template <int W>
int launch_bf(long long B, int T, int heads, int smem, int smem_dq,
              cudaStream_t stream, const bfm::bf16* qkv,
              const bfm::bf16* dout, const float* lse, const float* delta,
              bfm::bf16* dqkv, int ch, float scale2, bool vec) {
  using L = LayoutBf<W>;
  if (smem != L::bytes || smem_dq != L::dq_bytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_bf16_kernel<W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dq);
  if (err != cudaSuccess) return (int)err;
  const long long units = B * heads;
  flash_bwd_dkdv_bf16_kernel<W>
      <<<(unsigned int)(units * ((T + kKeys - 1) / kKeys)), kThreads, smem,
         stream>>>(qkv, dout, lse, delta, dqkv, T, heads, ch, scale2, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_bf16_kernel<W>
      <<<(unsigned int)(units * ((T + kBfQueries - 1) / kBfQueries)),
         kThreads, smem_dq, stream>>>(qkv, dout, lse, delta, dqkv, T, heads,
                                      ch, scale2, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dqkv must be zero on entry (the q slots take atomic sums). smem: the
// block's dynamic shared memory as attention.py bwd_smem_bytes computes it;
// refused (cudaErrorInvalidValue) if it is not this file's Layout<W>::bytes.
extern "C" int qkv_attention_bwd_f32(const float* qkv, const float* dout,
                                     const float* lse, const float* delta,
                                     float* dqkv, long long B, int T,
                                     int heads, int ch, int smem,
                                     float scale, void* stream) {
  if (B == 0 || T == 0) return 0;
  const bool vec = ch % 4 == 0 && aligned16(qkv) && aligned16(dout);
  cudaStream_t st = (cudaStream_t)stream;
  if (ch <= 32)
    return launch_w<32>(B, T, heads, smem, st, qkv, dout, lse, delta, dqkv,
                        ch, scale, vec);
  if (ch <= 64)
    return launch_w<64>(B, T, heads, smem, st, qkv, dout, lse, delta, dqkv,
                        ch, scale, vec);
  return launch_w<128>(B, T, heads, smem, st, qkv, dout, lse, delta, dqkv, ch,
                       scale, vec);
}

// The bf16 entry: qkv, dout and dqkv bf16, lse and delta fp32; every
// element of dqkv is written (no zeroing). smem and smem_dq: the two
// kernels' dynamic shared memory as attention.py bwd_smem_bytes(ch,
// torch.bfloat16) and bwd_dq_smem_bytes(ch) compute it, refused if they are
// not this file's LayoutBf<W>::bytes and ::dq_bytes.
extern "C" int qkv_attention_bwd_bf16(const bfm::bf16* qkv,
                                      const bfm::bf16* dout, const float* lse,
                                      const float* delta, bfm::bf16* dqkv,
                                      long long B, int T, int heads, int ch,
                                      int smem, int smem_dq, float scale,
                                      void* stream) {
  if (B == 0 || T == 0) return 0;
  const bool vec = ch % 8 == 0 && aligned16(qkv) && aligned16(dout);
  const float s2 = scale * scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (ch <= 64)
    return launch_bf<64>(B, T, heads, smem, smem_dq, st, qkv, dout, lse,
                         delta, dqkv, ch, s2, vec);
  return launch_bf<128>(B, T, heads, smem, smem_dq, st, qkv, dout, lse,
                        delta, dqkv, ch, s2, vec);
}
