// The circulant stencil on one row held by one warp, shared by K1
// (circulant.cu) and K2 (rk4.cu), and the launch plan both pick from.
//
// The warp plan: a row of d = 32·V floats (V ≤ 32) lives in the registers
// of one warp, lane l holding the V consecutive floats [l·V, l·V + V).
// The stencil's two rolls then need one __shfl_sync each way, across the
// lane boundary, and the row wraps from lane 31 to lane 0: the row's end is
// the warp's. Rows of other widths take each kernel's general plan. The host
// picks the plan from the shape and the pointers' alignment, never after a
// failure (ops/kernels/circulant.py mirrors the choosers).

#pragma once

#include <cuda_runtime.h>

namespace circ {

constexpr float kCoef = 0.70710678118654752440f;  // c = sqrt(2)/2
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPerLane = 32;  // rows of up to 32 * 32 = 1,024 floats

enum Kind { kGeneral = 0, kWarp = 1 };

// A launch plan; the card tests read it through each source's *_plan entry.
struct Plan {
  long long kind;      // kGeneral or kWarp
  long long per_lane;  // floats per lane (warp plan), else 0
  long long vec;       // floats per load: 4 (float4) or 1
  long long rows;      // rows per block (0: K1's general plan, by elements)
  long long blocks;
  long long in_smem;   // K2's general plan: its buffers in shared memory
};

inline void write_plan(const Plan& p, long long* out) {
  out[0] = p.kind;
  out[1] = p.per_lane;
  out[2] = p.vec;
  out[3] = p.rows;
  out[4] = p.blocks;
  out[5] = p.in_smem;
}

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// floats per lane of the warp plan for rows of d floats; 0 where the
// general plan takes the row (d not a multiple of 32, or above 1,024)
inline int per_lane(long long d) {
  return d > 0 && d % 32 == 0 && d <= 32 * kMaxPerLane ? (int)(d / 32) : 0;
}

inline bool aligned16(const void* p) {
  return ((unsigned long long)p & 15) == 0;
}

// v = row[lane·V, lane·V + V): float4 loads where VEC (V % 4 == 0 and the
// row 16-byte aligned), else one float at a time
template <int V, bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         int lane, float (&v)[V]) {
  const float* p = row + lane * V;
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = p[j];
  }
}

template <int V, bool VEC>
__device__ __forceinline__ void store_row(float* __restrict__ row, int lane,
                                          const float (&v)[V]) {
  float* p = row + lane * V;
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = v[j];
  }
}

// k = c·(roll(s·y, −1)·w − roll(s·y·w, +1)) of the warp's row:
// k[i] = c·((s·y[i+1])·w[i] − (s·y[i−1])·w[i−1]), indices mod d. The
// neighbour past a lane's last float is the next lane's first, the one
// before its first the previous lane's last. Every product and difference
// is rounded on its own (__fmul_rn / __fsub_rn: no FMA contraction), in the
// plain version's order (circ_math), so the two agree bit for bit.
template <int V>
__device__ __forceinline__ void stencil(float s, const float (&y)[V],
                                        const float (&w)[V], float (&k)[V],
                                        int lane) {
  const float next = __shfl_sync(kFull, __fmul_rn(s, y[0]), (lane + 1) & 31);
  const float prev = __shfl_sync(
      kFull, __fmul_rn(__fmul_rn(s, y[V - 1]), w[V - 1]), (lane + 31) & 31);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int jn = (j + 1) % V, jp = (j + V - 1) % V;
    const float yb_next = j + 1 < V ? __fmul_rn(s, y[jn]) : next;
    const float ybw_prev =
        j > 0 ? __fmul_rn(__fmul_rn(s, y[jp]), w[jp]) : prev;
    k[j] = __fmul_rn(kCoef, __fsub_rn(__fmul_rn(yb_next, w[j]), ybw_prev));
  }
}

}  // namespace circ
