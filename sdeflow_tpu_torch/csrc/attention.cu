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
//
// bfloat16 (qkv_attention_bf16; the score net's bf16 compute on the
// unfused route, T <= 1024): qkv and out bf16, with the rounding points of
// the JAX kernel body _attn_kernel on bf16 qkv (:124-142): the scale a
// float32 scalar, so the scores are the fp32 sums of the exact bf16
// products of the raw q and k times s^2; the softmax in fp32 and the
// normalised weights rounded to bf16 for P V; P V accumulated in fp32 and
// rounded to bf16 once. All products on wgmma (wgmma_bf16.cuh) with bf16
// operands. Up to T = 64, qkv_attention_bf16_kernel_short (below): a
// persistent grid of one warpgroup a block walking tiles of 64 rows, each
// S whole (sample, head) units packed row after row (S = 64 / T, fewer
// where the tiles would leave SMs idle; a select mask keeps each query to
// its own unit's keys), through a two-slot ring in shared memory whose
// next tile's Q, K and V are copied by cp.async while this tile computes;
// the whole key row is one 64-key score tile, so the softmax takes its max
// and sum in registers and the scores are formed once whatever the head
// width; V is read MN-major through its descriptor; O is staged in the
// tile's Q slot and stored 16 bytes at a time. Above T = 64,
// qkv_attention_bf16_kernel_tiled (below): two passes over 64-key tiles,
// the first over K alone for each row's max and sum, the second
// recomputing the scores for P V, 128 query rows a block. Bound: bytes at
// the short sequences (half the float32 bytes: 0.010 and 0.005 ms at
// (1024, 64, 64) and (1024, 16, 128)), the products once over 989 TFLOP/s
// dense bf16 at (128, 1024, 128) (0.069 ms; the second pass's recomputed
// scores make the design's products 1.5x that).

#include <math.h>

#include "attn_tile.cuh"
#include "flash_fwd.cuh"
#include "wgmma_bf16.cuh"

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

// K6 bf16 up to T = 64, for Hopper. A block is one warpgroup; the grid is
// persistent (as many blocks as the SMs hold, qkv_attention_bf16_plan) and
// walks tiles of kShortRows rows: S units (sample, head) packed row after
// row, unit p of the tile in rows pT..pT+T-1 (short_samples). Each tile's
// Q, K and V rows (all 64, zero past the tile's rows and past ch) sit in
// one slot of a kShortStages ring, in wgmma_bf16.cuh's 128-byte-swizzled
// layout at the head width W (64 or 128); the next tile's copy is issued
// (16-byte cp.async where vec, element copies otherwise) before this
// tile's products. Every product runs all its k-steps (a k-step skipped on
// a run-time bound makes ptxas serialise the products, C7520), on zeros
// past ch and past the tile's rows. S = Q K^T is one m64n64 product from
// shared memory, so the softmax runs in registers in one pass over the whole
// key row, keys outside the row's own unit masked; p = bf16(2^(s c - m c)
// / l), c = s^2 log2(e), normalised before it is rounded; O = P V with P
// from registers and V MN-major from shared memory (no transpose); O is
// rounded to bf16 into the tile's Q slot and stored 16 bytes at a time
// where vec_out (ch % 8 == 0 and out aligned), element by element
// otherwise.
constexpr int kShortThreads = 128;  // one warpgroup a block
constexpr int kShortRows = 64;      // rows (and keys) of a tile: m64
constexpr int kShortStages = 2;     // tile slots of the ring
constexpr float kLog2e = 1.4426950408889634f;

// W: 64 or 128; the blocks an SM is asked to hold (registers: 128 or 255
// a thread; shared memory: 4 x 50,176 or 2 x 99,328 bytes)
template <int W>
struct ShortBf {
  static constexpr int tile_bytes = 2 * kShortRows * W;  // Q, K or V
  static constexpr int stage_bytes = 3 * tile_bytes;
  // + 1,024 to align the slots to the swizzle's 1,024-byte atoms
  static constexpr int bytes = 1024 + kShortStages * stage_bytes;
  static constexpr int min_blocks = W == 64 ? 4 : 2;
};

// units (sample, head) packed into one tile: as many as fit 64 rows, fewer
// where that would leave SMs without a tile (the SSM step's B = 128)
__host__ __device__ int short_samples(int T, long long units, int sms) {
  const long long fit = kShortRows / T, spread = units / sms;
  return (int)(spread < 1 ? 1 : fit < spread ? fit : spread);
}

template <int W>
__global__ void __launch_bounds__(kShortThreads, ShortBf<W>::min_blocks)
qkv_attention_bf16_kernel_short(const bfm::bf16* __restrict__ qkv,
                                bfm::bf16* __restrict__ out, long long units,
                                int T, int heads, int ch, int S, float scale2,
                                bool vec, bool vec_out) {
  using bfm::bf16;
  using L = ShortBf<W>;
  extern __shared__ __align__(16) float smem[];
  char* ring = wg::align1024(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const long long C = (long long)heads * ch, C3 = 3 * C;
  const long long tiles = (units + S - 1) / S;
  const float sc = scale2 * kLog2e;

  // real rows of tile tt: whole units
  auto tile_rows = [&](long long tt) {
    return (int)min((long long)S, units - tt * S) * T;
  };
  // row r of tile tt (r < its rows) in qkv and out: (sample row, head)
  auto row_of = [&](long long tt, int r, long long& brow, int& hh) {
    const int p = r / T;
    const long long u = tt * S + p, b = u / heads;
    brow = b * T + (r - p * T);
    hh = (int)(u - b * heads);
  };
  // thread tid takes chunk (tid % kChunks) of rows tid / kChunks,
  // + kRowStep, ...: each row's place in qkv and out found once
  constexpr int kChunks = W / 8, kRowStep = kShortThreads / kChunks;
  const int jc = tid % kChunks;
  auto copy_tile = [&](long long tt, int slot) {
    char* st = ring + slot * L::stage_bytes;
    const int rows = tile_rows(tt);
    for (int r = tid / kChunks; r < kShortRows; r += kRowStep) {
      const bf16* src = qkv;
      if (r < rows) {
        long long brow;
        int hh;
        row_of(tt, r, brow, hh);
        src = qkv + brow * C3 + hh * 3 * ch;
      }
      if (vec) {  // 16-byte chunks, zero past ch and past the tile's rows
        const bool ok = r < rows && 8 * jc < ch;
#pragma unroll
        for (int part = 0; part < 3; ++part)
          bfm::cp16(reinterpret_cast<bf16*>(
                        st + part * L::tile_bytes +
                        wg::chunk_offset(r, jc, kShortRows)),
                    ok ? src + part * ch + 8 * jc : qkv, ok);
      } else {  // element by element
#pragma unroll
        for (int part = 0; part < 3; ++part)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int c = 8 * jc + e;
            *reinterpret_cast<bf16*>(st + part * L::tile_bytes +
                                     wg::chunk_offset(r, jc, kShortRows) +
                                     e * 2) =
                r < rows && c < ch ? src[part * ch + c]
                                   : __float2bfloat16(0.f);
          }
      }
    }
  };

  long long tt = blockIdx.x;
  if (tt < tiles) copy_tile(tt, 0);
  tc::cp_async_commit();
  for (int it = 0; tt < tiles; ++it, tt += gridDim.x) {
    const int slot = it & 1;
    __syncthreads();  // every thread is done with the other slot's tile
    if (tt + gridDim.x < tiles) copy_tile(tt + gridDim.x, slot ^ 1);
    tc::cp_async_commit();
    bfm::cp_async_wait<1>();  // this tile's copies have landed
    wg::fence_smem();
    __syncthreads();  // for every thread's copies
    char* st = ring + slot * L::stage_bytes;
    const bf16* qs = reinterpret_cast<const bf16*>(st);
    const bf16* ks = reinterpret_cast<const bf16*>(st + L::tile_bytes);
    const bf16* vs = reinterpret_cast<const bf16*>(st + 2 * L::tile_bytes);
    const int rows = tile_rows(tt);

    // the raw scores: the fp32 sums of the exact bf16 products q k^T over
    // the whole key row (the scale s^2 goes into the exponent's FMA)
    float s[kShortRows / 2];
    const uint64_t dq = wg::desc_k(qs), dk = wg::desc_k(ks);
    wg::fence();
    wg::mma_ss_first<kShortRows>(s, dq, dk);
#pragma unroll
    for (int kk = 1; kk < W / 16; ++kk)
      wg::mma_ss<kShortRows>(s, dq + wg::k_step(kShortRows, kk),
                             dk + wg::k_step(kShortRows, kk), 1);
    wg::commit();
    wg::wait<0>();
    wg::pin(s);

    // each row's own unit's keys [lo, lo + T) (none past the tile's rows)
    int lo[2];
    float mc[2], inv[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int i = 16 * warp + g + 8 * h2;
      lo[h2] = i < rows ? i / T * T : kShortRows;
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kShortRows / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jk = nt * 8 + 2 * q4 + e;
          if (jk >= lo[h2] && jk < lo[h2] + T)
            mx = fmaxf(mx, s[4 * nt + 2 * h2 + e]);
        }
      mx = tc::quad_max(mx);
      mc[h2] = mx == -INFINITY ? 0.f : mx * sc;  // no key: p = 0
    }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kShortRows / 8; ++nt)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jk = nt * 8 + 2 * q4 + e;
          float& v = s[4 * nt + 2 * h2 + e];
          v = jk >= lo[h2] && jk < lo[h2] + T ? wg::ex2(fmaf(v, sc, -mc[h2]))
                                              : 0.f;
          l[h2] += v;
        }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      l[h2] = tc::quad_sum(l[h2]);
      inv[h2] = l[h2] > 0.f ? 1.f / l[h2] : 0.f;
    }
    uint32_t pf[kShortRows / 16][4];
#pragma unroll
    for (int kk = 0; kk < kShortRows / 16; ++kk) {
      float c0[4], c1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c0[e] = s[8 * kk + e] * inv[e >> 1];
        c1[e] = s[8 * kk + 4 + e] * inv[e >> 1];
      }
      bfm::pack_a(pf[kk], c0, c1);
      wg::pin(pf[kk]);
    }

    // O = P V, V MN-major
    float o[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
    const uint64_t dv = wg::desc_mn(vs, kShortRows);
    wg::pin(o);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kShortRows / 16; ++kk)
      wg::mma_rs<W>(o, pf[kk], dv + wg::mn_step(kk), 1);
    wg::commit();
    wg::wait<0>();
    wg::pin(o);

    // O rounded to bf16 into the Q slot (after every warp's products),
    // then stored row by row
    __syncthreads();
    char* os = st;
#pragma unroll
    for (int nt = 0; nt < W / 8; ++nt)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = 16 * warp + g + 8 * h2, c = nt * 8 + 2 * q4;
        *reinterpret_cast<uint32_t*>(os + wg::chunk_offset(r, nt, kShortRows) +
                                     (c & 7) * 2) =
            bfm::pack(o[4 * nt + 2 * h2], o[4 * nt + 2 * h2 + 1]);
      }
    __syncthreads();
    for (int r = tid / kChunks; r < rows; r += kRowStep) {
      long long brow;
      int hh;
      row_of(tt, r, brow, hh);
      bf16* dst = out + brow * C + hh * ch;
      const char* o = os + wg::chunk_offset(r, jc, kShortRows);
      if (vec_out) {
        if (8 * jc < ch)
          *reinterpret_cast<uint4*>(dst + 8 * jc) =
              *reinterpret_cast<const uint4*>(o);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (8 * jc + e < ch)
            dst[8 * jc + e] = *reinterpret_cast<const bf16*>(o + e * 2);
      }
    }
  }
}

// K6 bf16 above T = 64: one block of kTiledGroups warpgroups per (sample,
// head, kTiledRows query rows), warpgroup i owning rows 64i..64i+63; key
// tiles of kTiledKeys rows through a kTiledStages-deep cp.async ring, all
// tiles in wgmma_bf16.cuh's swizzled layout. Two passes over the key
// tiles: the first loads K only and keeps each row's max m and sum l
// (online), the second forms the scores again, p = exp(s - m) / l rounded
// to bf16, and O += p V; so O needs no rescaling and is rounded to bf16
// once. Both products on wgmma: S = Q K^T with Q and K from shared memory,
// P V with P from registers and V from shared memory (MN-major). With the
// scale folded into one FMA, exp((s - m) s^2) / l is 2^(s c - b) with
// c = s^2 log2(e) and b = m c + log2 l; keys past T are masked in the
// ragged last tile only.
constexpr int kTiledGroups = 2;
constexpr int kTiledRows = 64 * kTiledGroups;
constexpr int kTiledKeys = 64;
constexpr int kTiledStages = 2;

// W: 64 or 128 (head widths up to 64 take 64, the swizzle's column block)
template <int W>
struct TiledBf {
  static constexpr int q_bytes = 2 * kTiledRows * W;
  static constexpr int stage_bytes = 2 * 2 * kTiledKeys * W;  // K, V
  // + 1,024 to align the tiles to the swizzle's 1,024-byte atoms
  static constexpr int bytes = 1024 + q_bytes + kTiledStages * stage_bytes;
};

template <int W>
__global__ void __launch_bounds__(128 * kTiledGroups)
qkv_attention_bf16_kernel_tiled(const bfm::bf16* __restrict__ qkv,
                                bfm::bf16* __restrict__ out, int T, int heads,
                                int ch, float scale2, bool vec) {
  using bfm::bf16;
  using L = TiledBf<W>;
  constexpr int kT = 128 * kTiledGroups;
  constexpr int NT = kTiledKeys / 8;  // n-tiles of the score tile
  constexpr int NO = W / 8;           // n-tiles of the output
  extern __shared__ __align__(16) float smem[];
  char* raw = wg::align1024(smem);
  bf16* qs = reinterpret_cast<bf16*>(raw);
  char* ring = raw + L::q_bytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3;
  const int grp = tid >> 7;
  const int g = lane >> 2, q4 = lane & 3;
  const int nq = (T + kTiledRows - 1) / kTiledRows;
  const int qt = (int)(blockIdx.x % nq);
  const int hh = (int)((blockIdx.x / nq) % heads);
  const long long b = (long long)blockIdx.x / ((long long)nq * heads);
  const long long C = (long long)heads * ch, C3 = 3 * C;
  const bf16* base = qkv + b * T * C3 + hh * 3 * ch;  // row t at + t*C3
  const int q0 = qt * kTiledRows;
  const int ntiles = (T + kTiledKeys - 1) / kTiledKeys;
  const int steps = 2 * ntiles;  // step i: tile i % ntiles, pass i / ntiles

  auto kstage = [&](int step) {
    return reinterpret_cast<bf16*>(ring + (step % kTiledStages) *
                                              L::stage_bytes);
  };
  auto load_tile = [&](int step) {  // K, and in the second pass V
    bf16* ks = kstage(step);
    const int k0 = (step % ntiles) * kTiledKeys;
    wg::load_tile<kTiledKeys, W, kT>(ks, base + ch, C3, k0, T, ch, vec);
    if (step >= ntiles)
      wg::load_tile<kTiledKeys, W, kT>(ks + kTiledKeys * W, base + 2 * ch,
                                       C3, k0, T, ch, vec);
  };
  wg::load_tile<kTiledRows, W, kT>(qs, base, C3, q0, T, ch, vec);
#pragma unroll
  for (int i = 0; i < kTiledStages - 1; ++i) {
    load_tile(i);  // steps >= 2
    tc::cp_async_commit();
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // per row (g, g + 8): the max m of the raw score sums, then l's sum of
  // 2^((s - m) c); from the second pass on, b = m c + log2 l
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sc = scale2 * 1.4426950408889634f;  // c = s^2 log2(e)
  const uint64_t dqa = wg::desc_k(qs + grp * 64 * 64);  // this group's rows

  for (int step = 0; step < steps; ++step) {
    bfm::cp_async_wait<kTiledStages - 2>();  // this step's tile has landed
    wg::fence_smem();
    __syncthreads();  // for every thread's copies; the oldest stage is free
    if (step + kTiledStages - 1 < steps) load_tile(step + kTiledStages - 1);
    tc::cp_async_commit();
    const bf16* ks = kstage(step);
    const bf16* vs = ks + kTiledKeys * W;
    const int k0 = (step % ntiles) * kTiledKeys;

    // the raw scores: the fp32 sums of the exact bf16 products q k^T (the
    // scale s^2 goes into the exponent's FMA)
    float s[NT][4];
    float(&sv)[4 * NT] = *reinterpret_cast<float(*)[4 * NT]>(&s[0][0]);
    const uint64_t dk = wg::desc_k(ks);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)  // k-step 0 overwrites
      wg::mma_ss<kTiledKeys>(sv, dqa + wg::k_step(kTiledRows, kk),
                             dk + wg::k_step(kTiledKeys, kk), kk > 0);
    wg::commit();
    wg::wait<0>();
    if (k0 + kTiledKeys > T) {  // the ragged last tile: keys past T
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + n * 8 + 2 * q4 + (e & 1) >= T) s[n][e] = -INFINITY;
    }

    if (step < ntiles) {  // the row max and sum
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // row g (c0, c1), row g + 8 (c2, c3)
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
        const float m_new = fmaxf(m[h], tc::quad_max(mx));  // key k0 < T
        const float mc = m_new * sc;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          sum += wg::ex2(fmaf(s[n][2 * h], sc, -mc)) +
                 wg::ex2(fmaf(s[n][2 * h + 1], sc, -mc));
        // the rescale 2^((m - m_new) c) is 0 on the first tile
        l[h] = l[h] * wg::ex2((m[h] - m_new) * sc) + tc::quad_sum(sum);
        m[h] = m_new;
      }
      if (step == ntiles - 1)
        for (int h = 0; h < 2; ++h) l[h] = m[h] * sc + __log2f(l[h]);
    } else {  // O += bf16(2^(s c - b)) V, l holding b
      uint32_t a[NT / 2][4];
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {  // keys 16kk..16kk+15
        float p[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[i][e] = wg::ex2(fmaf(s[2 * kk + i][e], sc, -l[e >> 1]));
        bfm::pack_a(a[kk], p[0], p[1]);
      }
      float(&ov)[4 * NO] = *reinterpret_cast<float(*)[4 * NO]>(&o[0][0]);
      const uint64_t dv = wg::desc_mn(vs, kTiledKeys);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
        wg::mma_rs<W>(ov, a[kk], dv + wg::mn_step(kk), 1);
      wg::commit();
      wg::wait<0>();
    }
  }

  const bool pairs = (ch & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = q0 + grp * 64 + warp * 16 + g + 8 * h;
    if (t >= T) continue;
    bf16* orow = out + (b * T + t) * C + hh * ch;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * q4;
      if (pairs && c < ch) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(o[n][2 * h], o[n][2 * h + 1]);
      } else {
        if (c < ch) orow[c] = __float2bfloat16_rn(o[n][2 * h]);
        if (c + 1 < ch) orow[c + 1] = __float2bfloat16_rn(o[n][2 * h + 1]);
      }
    }
  }
}

template <int W>
int launch_tiled_bf16(const bfm::bf16* qkv, bfm::bf16* out, long long B,
                      int T, int heads, int ch, int smem, float s2, bool vec,
                      cudaStream_t stream) {
  if (smem != TiledBf<W>::bytes) return (int)cudaErrorInvalidValue;
  auto kernel = qkv_attention_bf16_kernel_tiled<W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = B * heads * ((T + kTiledRows - 1) / kTiledRows);
  kernel<<<(unsigned int)blocks, 128 * kTiledGroups, smem, stream>>>(
      qkv, out, T, heads, ch, s2, vec);
  return (int)cudaGetLastError();
}

// The short bf16 kernel's launch at W: samples a tile, tiles, the blocks
// an SM holds and the grid (as many blocks as the SMs hold, at most one a
// tile). The SM count and the blocks an SM holds are read once, on the
// device current at the first call: a process drives one card.
struct ShortPlan {
  int S, per_sm;
  long long tiles, grid;
};

template <int W>
cudaError_t short_plan(long long units, int T, ShortPlan& p) {
  static int sms = 0, per_sm = 0;
  if (per_sm == 0) {
    auto kernel = qkv_attention_bf16_kernel_short<W>;
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 ShortBf<W>::bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kShortThreads, ShortBf<W>::bytes);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
  }
  p.S = short_samples(T, units, sms);
  p.per_sm = per_sm;
  p.tiles = (units + p.S - 1) / p.S;
  p.grid = p.tiles < (long long)sms * per_sm ? p.tiles : (long long)sms * per_sm;
  return cudaSuccess;
}

template <int W>
int launch_short_bf16(const bfm::bf16* qkv, bfm::bf16* out, long long B,
                      int T, int heads, int ch, int smem, float s2, bool vec,
                      cudaStream_t stream) {
  if (smem != ShortBf<W>::bytes) return (int)cudaErrorInvalidValue;
  ShortPlan p;
  const long long units = B * heads;
  cudaError_t err = short_plan<W>(units, T, p);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(qkv_attention_bf16_kernel_short<W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec_out = ch % 8 == 0 && flash::aligned16(out);
  qkv_attention_bf16_kernel_short<W>
      <<<(unsigned int)p.grid, kShortThreads, smem, stream>>>(
          qkv, out, units, T, heads, ch, p.S, s2, vec, vec_out);
  return (int)cudaGetLastError();
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

// The bf16 entry: qkv and out bf16; smem as attention.py smem_bytes(T, ch,
// torch.bfloat16) computes it, refused if this file computes another.
extern "C" int qkv_attention_bf16(const bfm::bf16* qkv, bfm::bf16* out,
                                  long long B, int T, int heads, int ch,
                                  int smem, float scale, void* stream) {
  if (B == 0 || T == 0) return 0;
  const bool vec = ch % 8 == 0 && flash::aligned16(qkv);
  const float s2 = scale * scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (T > kShortT) {
    if (ch <= 64)
      return launch_tiled_bf16<64>(qkv, out, B, T, heads, ch, smem, s2, vec,
                                   st);
    return launch_tiled_bf16<128>(qkv, out, B, T, heads, ch, smem, s2, vec,
                                  st);
  }
  if (ch <= 64)
    return launch_short_bf16<64>(qkv, out, B, T, heads, ch, smem, s2, vec,
                                 st);
  return launch_short_bf16<128>(qkv, out, B, T, heads, ch, smem, s2, vec, st);
}

// The plan of the bf16 entry's short path (T <= 64) on this card, for the
// card tests to hold attention.py short_bf16_plan to: plan = (samples a
// tile, tiles, grid, blocks an SM holds, shared memory a block).
extern "C" int qkv_attention_bf16_plan(long long B, int T, int heads, int ch,
                                       long long* plan) {
  ShortPlan p;
  const cudaError_t err = ch <= 64 ? short_plan<64>(B * heads, T, p)
                                   : short_plan<128>(B * heads, T, p);
  if (err != cudaSuccess) return (int)err;
  plan[0] = p.S, plan[1] = p.tiles, plan[2] = p.grid, plan[3] = p.per_sm;
  plan[4] = ch <= 64 ? ShortBf<64>::bytes : ShortBf<128>::bytes;
  return 0;
}
