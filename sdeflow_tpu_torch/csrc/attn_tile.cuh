// Softmax attention of 16 query rows on the tensor cores in 3xTF32, with
// the keys and values already in memory that the block reads at will:
// shared by K6 at short sequences (attention.cu) and by K3 (attnblock.cu).
//
//   o = softmax((q s^2) k^T) v     for the rows r0..r0+15 of one (sample,
//                                  head), keys 0..T-1
//
// Row t of the head's Q, K, V is at q + t*ldq, k + t*ldk, v + t*ldv (shared
// or, for K3's spilled buffers, device memory), columns [0, w), w a multiple
// of 8 with zeros past the head width; rows [0, rows) are readable and
// finite, rows >= T among them. The keys go by in tiles of 8*NT with the
// online softmax of flash_fwd.cuh (one tile, and so no rescaling, where T <=
// 8*NT); the output in column chunks of 8*NO, each with its own pass over the
// keys (the scores are recomputed per chunk, which only head widths above
// 8*NO pay); the call computes the output columns [oc0, oc1), a multiple of
// 8*NO apart. No loop has a bound known only at run time inside a k-step, so
// the independent products of the n-tiles interleave: key rows past `rows`
// and columns past w are clamped to the last ones (the keys past T get -inf,
// the columns are not stored), which costs work only where T or w falls short
// of a whole tile. Each k-step's three products, of the scores and of P V, go
// to a fresh accumulator added in fp32 (tc::mma3_add), so no mma chain runs
// longer than one k-step (mma_tf32.cuh says why).
//
// store(row, col, v0, v1) receives the output at (row, col) and
// (row, col + 1), col even, for the 16 rows and the columns below w; it
// decides what lies past T or past the head width.

#pragma once

#include <math.h>

#include "mma_tf32.cuh"

namespace tc {

template <int NT, int NO, class Store>
__device__ __forceinline__ void attend16(const float* q, int ldq,
                                         const float* k, int ldk,
                                         const float* v, int ldv, int T,
                                         int rows, int w, float scale2,
                                         int r0, int oc0, int oc1,
                                         Store store) {
  constexpr int kTile = 8 * NT;
  const int lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3;
  const int ntiles = (T + kTile - 1) / kTile;
  const float* qr = q + (r0 + g) * ldq + q4;  // rows r0+g, r0+g+8
  for (int oc = oc0; oc < oc1; oc += 8 * NO) {
    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int j = 0; j < ntiles; ++j) {
      const int k0 = j * kTile;
      int krow[NT];  // this lane's key row of each n-tile, as an offset
#pragma unroll
      for (int n = 0; n < NT; ++n)
        krow[n] = min(k0 + n * 8 + g, rows - 1) * ldk + q4;
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      for (int c = 0; c < w; c += 8) {
        const tc::A a = tc::split_a(qr[c] * scale2, qr[8 * ldq + c] * scale2,
                                    qr[c + 4] * scale2,
                                    qr[8 * ldq + c + 4] * scale2);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          tc::mma3_add(s[n], a,
                       tc::split_b(k[krow[n] + c], k[krow[n] + c + 4]));
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // row r0+g (c0, c1), r0+g+8 (c2, c3)
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e)
            if (k0 + n * 8 + 2 * q4 + (e & 1) >= T) s[n][e] = -INFINITY;
          mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
        }
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
      float pv[NO][4];  // this tile's P V
#pragma unroll
      for (int n = 0; n < NO; ++n)
        pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
      int vcol[NO];  // this lane's value column of each n-tile
#pragma unroll
      for (int n = 0; n < NO; ++n) vcol[n] = min(oc + n * 8 + g, w - 1);
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {  // keys k0+8kk..k0+8kk+7 (p = 0
        const tc::A p = tc::relayout(s[kk], lane);  // past T)
        const float* v0 = v + min(k0 + kk * 8 + q4, rows - 1) * ldv;
        const float* v1 = v + min(k0 + kk * 8 + q4 + 4, rows - 1) * ldv;
#pragma unroll
        for (int n = 0; n < NO; ++n)
          tc::mma3_add(pv[n], p, tc::split_b(v0[vcol[n]], v1[vcol[n]]));
      }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n][e] = fmaf(o[n][e], corr[e >> 1], pv[n][e]);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = oc + n * 8 + 2 * q4;
      if (c < w) {
        store(r0 + g, c, o[n][0] / l[0], o[n][1] / l[0]);
        store(r0 + g + 8, c, o[n][2] / l[1], o[n][3] / l[1]);
      }
    }
  }
}

}  // namespace tc
