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
// kernel does:
//   (a) dQ arrives by atomics and dK, dV by a flush every kFlush tiles:
//       into a bf16 dqkv every one of those adds would round. The kernel
//       adds into a zeroed fp32 scratch of (B, T, 3C) instead, and the
//       entry rounds the scratch into dqkv once (dqkv_round_bf16_kernel).
//   (b) p = exp(S - lse) drifts above 1 unless S here is K7a's S: the
//       scores are formed exactly as flash_fwd.cuh's bf16 body forms them
//       behind lse, the fp32 sum of the exact products of the raw bf16 q
//       and k over the same k-steps in one chain, times s^2 rounded once
//       (S^T = K Q^T takes the same products as Q K^T).
//   (c) dP^T = V dO^T has bf16 operands, so bf16 mma.sync is exact up to
//       its fp32 sums. P^T dO, dS^T Q and dS K take fp32 P and dS: each
//       goes in as two bf16 halves, hi = bf16(x) and lo = bf16(x - hi)
//       (mma_bf16.cuh), against the bf16 dO, q or k, two mma.sync
//       m16n8k16 per 16-deep step where 3xTF32 takes six m16n8k8: hi + lo
//       holds x to about 2^-17 of |x|, far below the bf16 rounding of
//       dqkv, so the split loses nothing that the output keeps.
// The tiles are as above, in bf16: K and V rows (raw, W + 8 bf16) resident,
// the query tiles' Q and dO rows (W + 8 bf16) with lse and delta through
// the two-stage ring, and the dS^T tile (fp32, 64 x rows + 8) in a buffer
// of its own. Bound: the five products once over 989 TFLOP/s dense bf16,
// 0.043 ms at (4, 4096, 64), against 0.004 ms for its 15 MB (the split's
// second products and the scratch are the kernel's choice, not counted).

#include <math.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

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

template <int W>
struct LayoutBf {
  static constexpr int rows = Layout<W>::rows;
  static constexpr int ld = W + bfm::kPadBf;  // K, V, Q and dO rows (bf16)
  static constexpr int lds = rows + kPadDS;   // dS^T rows (fp32)
  static constexpr int kv_bytes = 2 * 2 * kKeys * ld;
  // Q and dO rows, then lse and delta
  static constexpr int stage_bytes = 2 * 2 * rows * ld + 2 * 4 * rows;
  static constexpr int ds_bytes = 4 * kKeys * lds;
  static constexpr int bytes = kv_bytes + kStages * stage_bytes + ds_bytes;
};

template <int W>
__global__ void __launch_bounds__(kThreads)
flash_bwd_bf16_kernel(const bfm::bf16* __restrict__ qkv,
                      const bfm::bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dqkv, int T, int heads, int ch,
                      float scale2, bool vec) {
  using bfm::bf16;
  using L = LayoutBf<W>;
  constexpr int R = L::rows, ld = L::ld, lds = L::lds;
  constexpr int NQ = R / 8;  // query n-tiles of S^T
  constexpr int NO = W / 8;  // channel n-tiles of dK, dV
  constexpr int kSlabWarps = kWarps / (R / 16);
  constexpr int NQO = NO / kSlabWarps;
  extern __shared__ __align__(16) float smem[];
  char* raw = reinterpret_cast<char*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(raw);  // the block's raw K rows
  bf16* vs = ks + kKeys * ld;
  char* ring = raw + L::kv_bytes;
  float* dst = reinterpret_cast<float*>(ring + kStages * L::stage_bytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int nk = (T + kKeys - 1) / kKeys;
  const int kt = (int)(blockIdx.x % nk);
  const int hh = (int)((blockIdx.x / nk) % heads);
  const long long b = (long long)blockIdx.x / ((long long)nk * heads);
  const long long C = (long long)heads * ch, C3 = 3 * C;
  const long long stat = (b * heads + hh) * T;
  const bf16* head = qkv + b * T * C3 + hh * 3 * ch;   // row t at + t*C3
  const bf16* dohead = dout + b * T * C + hh * ch;     // row t at + t*C
  float* dhead = dqkv + b * T * C3 + hh * 3 * ch;
  const int j0 = kt * kKeys;
  const int nq = (T + R - 1) / R;

  auto stage = [&](int i) {
    return reinterpret_cast<bf16*>(ring + (i & 1) * L::stage_bytes);
  };
  auto load_tile = [&](int i) {
    bf16* st = stage(i);
    bfm::load_rows<R, W, kThreads>(st, ld, head, C3, i * R, T, ch, vec);
    bfm::load_rows<R, W, kThreads>(st + R * ld, ld, dohead, C, i * R, T, ch,
                                   vec);
    float* ls = reinterpret_cast<float*>(st + 2 * R * ld);
    for (int r = tid; r < R; r += kThreads) {
      const int t = i * R + r;
      tc::cp_async4(ls + r, lse + stat + (t < T ? t : 0), t < T);
      tc::cp_async4(ls + R + r, delta + stat + (t < T ? t : 0), t < T);
    }
  };
  bfm::load_rows<kKeys, W, kThreads>(ks, ld, head + ch, C3, j0, T, ch, vec);
  bfm::load_rows<kKeys, W, kThreads>(vs, ld, head + 2 * ch, C3, j0, T, ch,
                                     vec);
  load_tile(0);
  tc::cp_async_commit();

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
    tc::cp_async_wait_one();  // tile it (and K, V) has landed
    __syncthreads();          // for every thread's copies
    const bf16* qs = stage(it);
    const bf16* dos = qs + R * ld;
    const float* ls = reinterpret_cast<const float*>(dos + R * ld);
    const float* dls = ls + R;
    const int i0 = it * R;

    // S^T = K Q^T and dP^T = V dO^T, exact products of bf16 operands
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      uint32_t ka[4], va[4];
      bfm::load_a(ka, ks + warp * 16 * ld + kk * 16, ld, g, q4);
      bfm::load_a(va, vs + warp * 16 * ld + kk * 16, ld, g, q4);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int qo = (n * 8 + g) * ld + kk * 16 + 2 * q4;
        bfm::mma(s[n], ka, bfm::ld2(qs + qo), bfm::ld2(qs + qo + 8));
        bfm::mma(dp[n], va, bfm::ld2(dos + qo), bfm::ld2(dos + qo + 8));
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
        const float p = ok ? expf(__fmul_rn(s[n][e], scale2) - ls[qi]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dls[qi]);
      }
    // dV += P^T dO and dK += dS^T Q over the tile's queries, P^T and dS^T
    // in two bf16 halves each
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {  // queries 16kk..16kk+15
      uint32_t ph[4], pl[4], dh[4], dl[4];
      bfm::split_a(ph, pl, s[2 * kk], s[2 * kk + 1]);
      bfm::split_a(dh, dl, dp[2 * kk], dp[2 * kk + 1]);
      const int ro = (kk * 16 + 2 * q4) * ld + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int o = ro + n * 8;
        const uint32_t d0 = bfm::ld2t(dos + o, ld);
        const uint32_t d1 = bfm::ld2t(dos + o + 8 * ld, ld);
        bfm::mma(dv[n], pl, d0, d1);
        bfm::mma(dv[n], ph, d0, d1);
        const uint32_t q0 = bfm::ld2t(qs + o, ld);
        const uint32_t q1 = bfm::ld2t(qs + o + 8 * ld, ld);
        bfm::mma(dk[n], dl, q0, q1);
        bfm::mma(dk[n], dh, q0, q1);
      }
    }
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[(kr0 + 8 * (e >> 1)) * lds + n * 8 + 2 * q4 + (e & 1)] = dp[n][e];
    __syncthreads();  // dS^T complete
    {
      // dQ of the tile: rows 16*slab.., channel n-tiles n0.. of this warp;
      // A = dS (queries x keys) from dS^T in two bf16 halves
      const int slab = warp / kSlabWarps, n0 = (warp % kSlabWarps) * NQO;
      const int qr = slab * 16 + g;
      float dq[NQO][4];
#pragma unroll
      for (int n = 0; n < NQO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {  // keys 16kk..16kk+15
        const float* d0 = dst + (kk * 16 + 2 * q4) * lds + qr;  // key 2q4
        const float* d8 = d0 + 8 * lds;                         // key 2q4+8
        uint32_t ah[4], al[4];
        bfm::split2(ah[0], al[0], d0[0], d0[lds]);
        bfm::split2(ah[1], al[1], d0[8], d0[lds + 8]);
        bfm::split2(ah[2], al[2], d8[0], d8[lds]);
        bfm::split2(ah[3], al[3], d8[8], d8[lds + 8]);
        const int ko = (kk * 16 + 2 * q4) * ld + n0 * 8 + g;
#pragma unroll
        for (int n = 0; n < NQO; ++n) {
          const uint32_t k0 = bfm::ld2t(ks + ko + n * 8, ld);
          const uint32_t k1 = bfm::ld2t(ks + ko + 8 * ld + n * 8, ld);
          bfm::mma(dq[n], al, k0, k1);
          bfm::mma(dq[n], ah, k0, k1);
        }
      }
#pragma unroll
      for (int n = 0; n < NQO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = i0 + qr + 8 * (e >> 1);
          const int c = (n0 + n) * 8 + 2 * q4 + (e & 1);
          if (t < T && c < ch)
            atomicAdd(dhead + (long long)t * C3 + c, dq[n][e] * scale2);
        }
    }
    if ((it + 1) % kFlush == 0 || it + 1 == nq) {
      // add the accumulators into this block's own dK (times s^2) and dV
      // rows of the scratch and restart them
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
              row[ch + c] += dk[n][2 * h + e] * scale2;
              row[2 * ch + c] += dv[n][2 * h + e];
            }
            dk[n][2 * h + e] = dv[n][2 * h + e] = 0.f;
          }
      }
    }
    __syncthreads();  // the stage and dS^T are free again
  }
}

// dqkv = bf16(acc), n elements (n % 4 == 0 and both aligned where vec4)
__global__ void dqkv_round_bf16_kernel(const float* __restrict__ acc,
                                       bfm::bf16* __restrict__ dqkv,
                                       long long n, bool vec4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec4) {
    for (; 4 * i < n; i += stride) {
      const float4 v = reinterpret_cast<const float4*>(acc)[i];
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dqkv + 4 * i);
      o[0] = __floats2bfloat162_rn(v.x, v.y);
      o[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  } else {
    for (; i < n; i += stride) dqkv[i] = __float2bfloat16_rn(acc[i]);
  }
}

template <int W>
int launch_bf(long long B, int T, int heads, int smem, cudaStream_t stream,
              const bfm::bf16* qkv, const bfm::bf16* dout, const float* lse,
              const float* delta, float* acc, int ch, float scale2,
              bool vec) {
  if (smem != LayoutBf<W>::bytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_bf16_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = B * heads * ((T + kKeys - 1) / kKeys);
  flash_bwd_bf16_kernel<W><<<(unsigned int)blocks, kThreads, smem, stream>>>(
      qkv, dout, lse, delta, acc, T, heads, ch, scale2, vec);
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

// The bf16 entry: qkv, dout bf16, lse and delta fp32; acc a float32
// scratch of dqkv's shape, zero on entry (the sums land there), then
// rounded into dqkv (bf16) by a second launch on the same stream. smem as
// attention.py bwd_smem_bytes(ch, torch.bfloat16) computes it, refused if
// it is not this file's LayoutBf<W>::bytes.
extern "C" int qkv_attention_bwd_bf16(const bfm::bf16* qkv,
                                      const bfm::bf16* dout, const float* lse,
                                      const float* delta, float* acc,
                                      bfm::bf16* dqkv, long long B, int T,
                                      int heads, int ch, int smem,
                                      float scale, void* stream) {
  if (B == 0 || T == 0) return 0;
  const bool vec = ch % 8 == 0 && aligned16(qkv) && aligned16(dout);
  const float s2 = scale * scale;
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (ch <= 32)
    err = launch_bf<32>(B, T, heads, smem, st, qkv, dout, lse, delta, acc, ch,
                        s2, vec);
  else if (ch <= 64)
    err = launch_bf<64>(B, T, heads, smem, st, qkv, dout, lse, delta, acc, ch,
                        s2, vec);
  else
    err = launch_bf<128>(B, T, heads, smem, st, qkv, dout, lse, delta, acc,
                         ch, s2, vec);
  if (err != 0) return err;
  const long long n = B * T * 3LL * heads * ch;
  const bool vec4 = n % 4 == 0 && aligned16(acc) && ((uintptr_t)dqkv & 7) == 0;
  const long long items = vec4 ? n / 4 : n;
  const long long blocks = (items + 255) / 256;
  dqkv_round_bf16_kernel<<<(unsigned int)(blocks < 4096 ? blocks : 4096), 256,
                           0, st>>>(acc, dqkv, n, vec4);
  return (int)cudaGetLastError();
}
