// The body of the long-sequence attention forward on the tensor cores,
// float32 in and out, shared by K4/K7a (flash_fwd.cu) and by K6 above
// T = 64 (attention.cu); each file compiles it under its own kernel
// symbol.
//
// Design: one block of 4 warps per (sample, head, 64 query rows); warp w
// owns rows 16w..16w+15. The block scales its Q rows by s^2 and splits them
// once into big and small halves in shared memory. Keys and values stream
// through a two-stage cp.async ring of 64-row tiles (16-byte copies where
// ch and C are multiples of 4 and qkv is 16-byte aligned, 4-byte copies
// otherwise, in the same code), zero past T and past ch up to the padded
// width W (32, 64 or 128). Per tile a warp forms its 16x64 score tile
// S = Q K^T on mma.sync m16n8k8 in 3xTF32 (mma_tf32.cuh; big products and
// small terms in two accumulators), masks keys past T, runs the online
// softmax in registers (row max and sum across the quad by shuffles) and
// forms the tile's P V in a fresh accumulator, with P turned from the
// accumulator layout into the A layout by quad shuffles (8 per 8 keys)
// rather than through shared memory; O = O * corr + P V in fp32 on the
// CUDA cores, so no mma chain runs longer than one tile (mma_tf32.cuh says
// why).
//
// What it does about the limits of the fp32 CUDA-core kernel that K4 first
// was: (1) every product runs on
// the tensor cores; (2) one shared-memory load of Q serves a k-step of
// eight n-tiles, and one of K or V a whole 16x8x8 product, where the old
// loops loaded about one float per FMA; K rows are padded to W+4 floats
// and V rows to W+8, so the B-fragment loads (lanes 4g+q read row q or g,
// column g or q) fall in 32 distinct banks; (3) tiles are 64 rows, twice
// as many as before; (4) the copy of the next tile runs under the current
// tile's products.

#pragma once

#include <math.h>

#include "mma_tf32.cuh"

namespace flash {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kKeys = 64;           // key rows per tile
constexpr int kKeysK6 = 32;         // key rows per tile of K6's variant
constexpr int kStages = 2;
constexpr int kPadQK = 4;  // Q and K rows: W + 4 floats
constexpr int kPadV = 8;   // V rows: W + 8 floats

// kK6: K6's variant of the body. Its Q rows stay raw in shared memory and
// are split per use, and its key tiles are 32 rows: at W = 128 that is
// 102 KB, two blocks per SM, where K4's layout (205 KB) holds one. Each
// k-step's score products go through a fresh accumulator (tc::mma3_add)
// for K6's 1e-5 at head width 128, where one chain of 16 k-steps drifts
// past it. K7a (kStats) takes its scores the same way: its lse at W = 128
// lay up to 9.85e-6 from float64 with the two-accumulator chain
// (mma3_split), twice the fp32 plain version's own distance. K4 keeps the
// layout and chains above.
template <int W, bool kK6 = false>
struct Layout {
  static constexpr int keys = kK6 ? kKeysK6 : kKeys;
  static constexpr int ldq = W + kPadQK, ldk = W + kPadQK, ldv = W + kPadV;
  static constexpr int stage = keys * (ldk + ldv);
  static constexpr int floats = (kK6 ? 1 : 2) * kRows * ldq + kStages * stage;
  static constexpr int bytes = 4 * floats;
};

template <int W, bool kStats, bool kK6 = false>
__device__ __forceinline__ void flash_fwd_body(
    const float* __restrict__ qkv, float* __restrict__ out,
    float* __restrict__ lse, int T, int heads, int ch, float scale2,
    bool vec) {
  using L = Layout<W, kK6>;
  constexpr int kTile = L::keys;
  constexpr int NT = kTile / 8;  // n-tiles of the score tile
  constexpr int NO = W / 8;      // n-tiles of the output
  extern __shared__ __align__(16) float smem[];
  float* q_big = smem;  // raw Q in K6's variant
  float* q_small = q_big + kRows * L::ldq;
  float* ring = kK6 ? q_small : q_small + kRows * L::ldq;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int nq = (T + kRows - 1) / kRows;
  const int qt = (int)(blockIdx.x % nq);
  const int hh = (int)((blockIdx.x / nq) % heads);
  const long long b = (long long)blockIdx.x / ((long long)nq * heads);
  const long long C = (long long)heads * ch, C3 = 3 * C;
  const float* base = qkv + b * T * C3 + hh * 3 * ch;  // row t at + t*C3
  const int q0 = qt * kRows;
  const int ntiles = (T + kTile - 1) / kTile;

  auto load_tile = [&](int j) {
    float* ks = ring + (j & 1) * L::stage;
    tc::load_rows<kTile, W, kThreads>(ks, L::ldk, base + ch, C3, j * kTile,
                                      T, ch, vec);
    tc::load_rows<kTile, W, kThreads>(ks + kTile * L::ldk, L::ldv,
                                      base + 2 * ch, C3, j * kTile, T, ch,
                                      vec);
  };
  load_tile(0);
  tc::cp_async_commit();

  for (int i = tid; i < kRows * W; i += kThreads) {
    const int r = i / W, c = i - r * W, t = q0 + r;
    const float x =
        (t < T && c < ch) ? base[(long long)t * C3 + c] * scale2 : 0.f;
    if constexpr (kK6) {
      q_big[r * L::ldq + c] = x;
    } else {
      uint32_t hi, lo;
      tc::split(x, hi, lo);
      q_big[r * L::ldq + c] = __uint_as_float(hi);
      q_small[r * L::ldq + c] = __uint_as_float(lo);
    }
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int r0 = warp * 16 + g;  // this lane's rows r0 and r0 + 8

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) load_tile(j + 1);
    tc::cp_async_commit();
    tc::cp_async_wait_one();  // tile j has landed
    __syncthreads();          // for every thread's copies (and Q)
    const float* ks = ring + (j & 1) * L::stage;
    const float* vs = ks + kTile * L::ldk;

    float s[NT][4], s_small[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s_small[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < W / 8; ++kk) {
      const int c = kk * 8 + q4;
      tc::A a;
      if constexpr (kK6) {
        a = tc::split_a(q_big[r0 * L::ldq + c], q_big[(r0 + 8) * L::ldq + c],
                        q_big[r0 * L::ldq + c + 4],
                        q_big[(r0 + 8) * L::ldq + c + 4]);
      } else {
        a.big[0] = __float_as_uint(q_big[r0 * L::ldq + c]);
        a.big[1] = __float_as_uint(q_big[(r0 + 8) * L::ldq + c]);
        a.big[2] = __float_as_uint(q_big[r0 * L::ldq + c + 4]);
        a.big[3] = __float_as_uint(q_big[(r0 + 8) * L::ldq + c + 4]);
        a.small[0] = __float_as_uint(q_small[r0 * L::ldq + c]);
        a.small[1] = __float_as_uint(q_small[(r0 + 8) * L::ldq + c]);
        a.small[2] = __float_as_uint(q_small[r0 * L::ldq + c + 4]);
        a.small[3] = __float_as_uint(q_small[(r0 + 8) * L::ldq + c + 4]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* kr = ks + (n * 8 + g) * L::ldk + c;
        if constexpr (kK6 || kStats)
          tc::mma3_add(s[n], a, tc::split_b(kr[0], kr[4]));
        else
          tc::mma3_split(s[n], s_small[n], a, tc::split_b(kr[0], kr[4]));
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += s_small[n][e];
    const int k0 = j * kTile;
    if (k0 + kTile > T) {  // the ragged last tile: keys past T get -inf
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + n * 8 + 2 * q4 + (e & 1) >= T) s[n][e] = -INFINITY;
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // row r0 (c0, c1), row r0 + 8 (c2, c3)
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      const float m_new = fmaxf(m[h], tc::quad_max(mx));  // key k0 < T
      corr[h] = expf(m[h] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][2 * h] = expf(s[n][2 * h] - m_new);
        s[n][2 * h + 1] = expf(s[n][2 * h + 1] - m_new);
        sum += s[n][2 * h] + s[n][2 * h + 1];
      }
      l[h] = l[h] * corr[h] + tc::quad_sum(sum);
      m[h] = m_new;
    }
    float pv[NO][4];  // this tile's P V, a short mma chain
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {  // keys 8kk..8kk+7 of the tile
      const tc::A p = tc::relayout(s[kk], lane);
      const float* vr = vs + (kk * 8 + q4) * L::ldv + g;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        tc::mma3(pv[n], p, tc::split_b(vr[n * 8], vr[4 * L::ldv + n * 8]));
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = fmaf(o[n][e], corr[e >> 1], pv[n][e]);
    __syncthreads();  // the stage is free for the copy two tiles on
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = q0 + r0 + 8 * h;
    if (t >= T) continue;
    float* orow = out + (b * T + t) * C + hh * ch;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * q4;
      if (c < ch) orow[c] = o[n][2 * h] / l[h];
      if (c + 1 < ch) orow[c + 1] = o[n][2 * h + 1] / l[h];
    }
    if (kStats && q4 == 0)
      lse[(b * heads + hh) * T + t] = m[h] + logf(l[h]);
  }
}

// The padded width W for head width ch: 32, 64 or 128 (attention.py
// _padded_width).
template <int W, bool kK6 = false, typename Kernel, typename... Args>
int launch_w(Kernel kernel, long long B, int T, int heads, int smem,
             cudaStream_t stream, Args... args) {
  if (smem != Layout<W, kK6>::bytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = B * heads * ((T + kRows - 1) / kRows);
  kernel<<<(unsigned int)blocks, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace flash
