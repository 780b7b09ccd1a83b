// K5 and K5b: GroupNorm (+SiLU) and its vector-Jacobian product,
// channels-first, on float32 or bfloat16 x (gamma and beta float32).
//
//   K5   h[b, c, s] = (x[b, c, s] - mean[b, g]) * rstd[b, g] * gamma[c] + beta[c]
//        out        = silu ? h / (1 + exp(-h)) : h,        g = c / (C/G)
//   K5b  given dy:  g  = silu ? dy * sig(h) * (1 + h * (1 - sig(h))) : dy
//        dbeta[c]  = sum_{b,s} g,   dgamma[c] = sum_{b,s} g * xhat
//        dx        = rstd * (d - mean_slab(d) - xhat * mean_slab(d * xhat)),
//                    d = g * gamma[c]
//
// mean and the variance of each (sample, group) slab in fp32, the variance
// in two passes (the one-pass E[x^2] - E[x]^2 form loses about three digits),
// rstd = rsqrt(var + 1e-5). K5b recomputes mean and rstd from x.
//
// bfloat16 (the score net's bf16 compute, group_norm_silu_bf16 and
// group_norm_silu_bwd_bf16; ops/pallas/groupnorm.py:64-75, the sub-fp32
// branch): kernels and plans of their own (below, choose_bf16), each
// 16-byte load carrying 8 elements, the statistics in fp32 from the
// widened values; K5's apply rounds where the plain version
// (ops/kernels/groupnorm.py gn_math) rounds: scale = bf16(rstd*gamma),
// shift = bf16(beta - mean*rstd*gamma), h = bf16(bf16(x*scale) + shift),
// and under SiLU out = bf16(h * bf16(sigmoid(h))). K5b widens x and dy and
// runs the fp32 vjp (the plain version's closed form evaluated in fp32),
// rounding dx to bf16 once at its store; dgamma and dbeta stay fp32.
//
// Replaces: the Pallas kernel _gn_kernel / _gn_pallas in
// sdeflow_tpu/ops/pallas/groupnorm.py:78-136 (entry group_norm_silu
// :139-144), and, for K5b, the backward of group_norm_silu, which has no
// Pallas kernel: XLA transposes the custom_jvp rule (:147-151). The TPU
// kernel takes channels-last (B, S, C) tiles and moves statistics between
// channels and groups with one-hot matmuls, because Mosaic will not split
// the lane dimension. Here the layout is channels-first (B, C, S): one
// (sample, group) is one contiguous slab of n = (C/G)*S floats.
//
// Bound on the H100: bytes. K5 reads x and writes out (8 bytes per element
// in fp32, 4 in bf16) for ~12 flops, K5b reads x and dy and writes dx (12
// bytes, 6 in bf16) for ~26, both far below the card's ~20 flops/byte fp32
// balance point. So each element is read once and written once, from
// registers, and loads are 16 bytes (a float4, or 8 bf16) wherever S is a
// multiple of the vector (which then never straddles two channels).
//
// Launch plans, chosen on the host from n and S (mirrored in Python by
// ops/kernels/groupnorm.py launch_plan, which the CPU tests check):
//
// - small (n <= 1024: every slab of grf16): a slab per group of L lanes of
//   one warp, L = 8, 16 or 32 (so 4, 2 or 1 slabs per warp at n <= 32, 64
//   in fp32, 64, 128 in bf16), each lane holding NV vectors in registers
//   (NV a template parameter sized to the slab); the sums are shuffles
//   within the L lanes.
// - cluster (1024 < n <= 65536 with float4s: every slab of the 128x128 DSM
//   step, 2,048 to 49,152 floats): a thread-block cluster of 2, 4 or 8
//   blocks of 256 threads per slab, each block holding its contiguous share
//   in registers (NV <= 8 float4s a thread). A sum is shuffles in each warp,
//   shared memory across the block and distributed shared memory across the
//   cluster (each block reads the others' partials after cluster.sync()), in
//   one fixed order, so every block gets the same bits. A thread holds at
//   most 32 floats (NV * V <= 32). One warp per slab,
//   as before, left 3-4 warps on an SM walking 2K-49K floats one after
//   another, and read x twice; a cluster splits the slab over up to 8 SMs.
// - stream (larger slabs, or S % 4 != 0 beyond 32,768 floats): the same
//   cluster of 8, each block looping over its share, which it reads three
//   times (K5) or four (K5b). No present path takes it; the bf16 plans
//   stream through its bf16 instances.
//
// K5b's dgamma and dbeta in fp32: each part of a slab (a lane group, or one
// block of a cluster) writes its per-channel sums of g and g*xhat into a
// (2, C, B*cluster) scratch, zero for channels it does not hold; a second
// kernel of the same C entry sums each row in a fixed order. No atomics, so
// the gradient is the same from run to run.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmallMax = 1024;     // floats: the small plan's largest slab
constexpr int kBlockFloats = 4096;  // floats a block of a cluster aims at
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

using bf16 = __nv_bfloat16;

// elements of the storage type T in one 16-byte vector
template <class T>
constexpr int kVec = 16 / (int)sizeof(T);

template <class T>
constexpr bool kHalf = std::is_same<T, bf16>::value;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// V elements of T at p, widened to fp32: a 16-byte vector (V = kVec<T>)
// or one element (V = 1)
template <int V, class T>
__device__ __forceinline__ void load(float (&d)[V], const T* p) {
  if constexpr (V == 1) {
    if constexpr (kHalf<T>)
      d[0] = __bfloat162float(p[0]);
    else
      d[0] = __ldg(p);
  } else if constexpr (kHalf<T>) {
    static_assert(V == 8, "8 bf16 per 16-byte vector");
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      d[2 * i] = f.x;
      d[2 * i + 1] = f.y;
    }
  } else {
    static_assert(V == 4, "4 floats per 16-byte vector");
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  }
}

// ... and V fp32 values stored as T (rounded to nearest in bf16)
template <int V, class T>
__device__ __forceinline__ void store(T* p, const float (&d)[V]) {
  if constexpr (V == 1) {
    if constexpr (kHalf<T>)
      p[0] = __float2bfloat16_rn(d[0]);
    else
      p[0] = d[0];
  } else if constexpr (kHalf<T>) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(d[2 * i], d[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  }
}

// The channel (within the slab) of element e0, e0 + step, e0 + 2 step, ...
// without a division per element.
struct ChannelWalk {
  int c, r, dc, dr, S;
  __device__ ChannelWalk(int e0, int step, int S_)
      : c(e0 / S_), r(e0 % S_), dc(step / S_), dr(step % S_), S(S_) {}
  __device__ __forceinline__ void next() {
    c += dc;
    r += dr;
    if (r >= S) { r -= S; ++c; }
  }
};

__device__ __forceinline__ float silu_of(float h) {
  return h / (1.f + expf(-h));
}

// The affine (and SiLU) of one element: in fp32 one fused multiply-add
// x*a + b; in bf16 with the plain version's roundings, scale = bf16(a),
// shift = bf16(b), h = bf16(bf16(x*scale) + shift), then
// h * bf16(sigmoid(h)) (rounded at the store).
template <class T>
struct Affine {
  float a, b;
  __device__ __forceinline__ Affine(float a_, float b_) {
    if constexpr (kHalf<T>) {
      a = round_bf16(a_);
      b = round_bf16(b_);
    } else {
      a = a_;
      b = b_;
    }
  }
  __device__ __forceinline__ float operator()(float x, bool act) const {
    if constexpr (kHalf<T>) {
      const float h = round_bf16(round_bf16(x * a) + b);
      return act ? h * round_bf16(1.f / (1.f + expf(-h))) : h;
    } else {
      const float h = fmaf(x, a, b);
      return act ? silu_of(h) : h;
    }
  }
};

// dL/dh from dL/dout: the SiLU's derivative sig(h) * (1 + h * (1 - sig(h)))
__device__ __forceinline__ float silu_grad(float dy, float h) {
  const float sg = 1.f / (1.f + expf(-h));
  return dy * sg * (1.f + h * (1.f - sg));
}

// ... with a fast sigmoid (__expf, __fdividef: a few ulp of fp32, far below
// the bf16 rounding of the dx it feeds; K5b in bf16)
__device__ __forceinline__ float silu_grad_fast(float dy, float h) {
  const float sg = __fdividef(1.f, 1.f + __expf(-h));
  return dy * sg * (1.f + h * (1.f - sg));
}

// The threads that share one slab, and their sums: L lanes of one warp.
template <int L>
struct LaneGroup {
  int lane;  // within the group
  template <int K>
  __device__ __forceinline__ void all(float (&v)[K], int) const {
#pragma unroll
    for (int k = 0; k < K; ++k)
      for (int o = L / 2; o; o >>= 1)
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
  // this part's sum (the part is the whole slab), on every lane
  template <int K>
  __device__ __forceinline__ void part(float (&v)[K]) const { all(v, 0); }
  __device__ __forceinline__ bool leader() const { return lane == 0; }
  __device__ __forceinline__ void done() const {}
};

// ... or the blocks of one cluster, each block one part of the slab.
struct ClusterGroup {
  cg::cluster_group cluster;
  float* red;    // shared, kWarps * 2 floats
  float* slots;  // shared, one float per cluster-wide sum
  int lane, warp;

  // the block's sum of each v[k], on every thread
  template <int K>
  __device__ __forceinline__ void part(float (&v)[K]) const {
    __syncthreads();  // the previous sum has been read
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = warp_sum(v[k]);
      if (lane == 0) red[k * kWarps + warp] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[k * kWarps + w];
      v[k] = s;
    }
  }
  // the cluster's sum of each v[k], on every thread of every block: each
  // block's sum in its slots[slot + k], then lane r of each warp reads
  // block r's, and a shuffle tree adds them, the same in every warp
  template <int K>
  __device__ __forceinline__ void all(float (&v)[K], int slot) {
    part(v);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) slots[slot + k] = v[k];
    }
    cluster.sync();
    const int blocks = (int)cluster.num_blocks();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float mine = lane < blocks
          ? *cluster.map_shared_rank(slots + slot + k, lane) : 0.f;
      v[k] = warp_sum(mine);
    }
  }
  __device__ __forceinline__ bool leader() const { return threadIdx.x == 0; }
  // no block may leave while another can still read its slots
  __device__ __forceinline__ void done() { cluster.sync(); }
};

// Where one thread works: vectors beg + tid + stride * j of its slab,
// j < NV (or while < beg + cnt, streaming); store: whether it writes (lanes
// past the last slab recompute slab 0, so that every lane of a warp takes
// part in the same shuffles, and write nothing).
struct Part {
  int beg, cnt, tid, stride;
  bool store;
};

template <int V, int NV, class T, class Grp>
__device__ __forceinline__ void fwd_resident(
    Grp& grp, const Part& p, const T* __restrict__ xs,
    const float* __restrict__ gs, const float* __restrict__ bs,
    T* __restrict__ os, int n, int S, bool act) {
  float v[NV][V];
  float s[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = p.tid + p.stride * j;
    if (k < p.cnt) {
      load<V>(v[j], xs + (size_t)(p.beg + k) * V);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[j][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) s[0] += v[j][i];
  }
  grp.all(s, 0);
  const float mean = s[0] / (float)n;
  float q[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (p.tid + p.stride * j < p.cnt) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = v[j][i] - mean;
        q[0] = fmaf(d, d, q[0]);
      }
    }
  }
  grp.all(q, 1);
  const float rstd = rsqrtf(q[0] / (float)n + kEps);
  ChannelWalk ch((p.beg + p.tid) * V, p.stride * V, S);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = p.tid + p.stride * j;
    if (k < p.cnt) {
      const float a = rstd * __ldg(gs + ch.c);
      const Affine<T> f(a, __ldg(bs + ch.c) - mean * a);
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = f(v[j][i], act);
      if (p.store) store<V>(os + (size_t)(p.beg + k) * V, o);
    }
    ch.next();
  }
  grp.done();
}

template <int V, class T>
__device__ __forceinline__ void fwd_stream(
    ClusterGroup& grp, const Part& p, const T* __restrict__ xs,
    const float* __restrict__ gs, const float* __restrict__ bs,
    T* __restrict__ os, int n, int S, bool act) {
  float s[1] = {0.f};
  for (int k = p.tid; k < p.cnt; k += p.stride) {
    float t[V];
    load<V>(t, xs + (size_t)(p.beg + k) * V);
#pragma unroll
    for (int i = 0; i < V; ++i) s[0] += t[i];
  }
  grp.all(s, 0);
  const float mean = s[0] / (float)n;
  float q[1] = {0.f};
  for (int k = p.tid; k < p.cnt; k += p.stride) {
    float t[V];
    load<V>(t, xs + (size_t)(p.beg + k) * V);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = t[i] - mean;
      q[0] = fmaf(d, d, q[0]);
    }
  }
  grp.all(q, 1);
  const float rstd = rsqrtf(q[0] / (float)n + kEps);
  for (int k = p.tid; k < p.cnt; k += p.stride) {
    const int c = (p.beg + k) * V / S;
    const float a = rstd * __ldg(gs + c);
    const Affine<T> f(a, __ldg(bs + c) - mean * a);
    float t[V];
    load<V>(t, xs + (size_t)(p.beg + k) * V);
#pragma unroll
    for (int i = 0; i < V; ++i) t[i] = f(t[i], act);
    store<V>(os + (size_t)(p.beg + k) * V, t);
  }
  grp.done();
}

// K5b's outputs for one part of a slab: its dx, and its per-channel sums
// of g (dbeta) and g * xhat (dgamma) at column `col` of the (2, C, R)
// scratch, channels c0 .. c0 + cg - 1 of the slab.
template <class T>
struct BwdOut {
  T* dxs;
  float* scratch;
  long long col, rows;  // this part's column, and R
  int C, c0, cg;
  __device__ __forceinline__ void param(int c, float dgamma, float dbeta)
      const {
    scratch[(size_t)(c0 + c) * rows + col] = dgamma;
    scratch[((size_t)C + c0 + c) * rows + col] = dbeta;
  }
};

// zero for the slab's channels outside [lo, hi], which this part lacks
template <class T>
__device__ __forceinline__ void zero_params(const BwdOut<T>& out,
                                            const Part& p, int lo, int hi) {
  for (int c = p.tid; c < out.cg; c += p.stride)
    if (c < lo || c > hi) out.param(c, 0.f, 0.f);
}

template <int V, int NV, class T, class Grp>
__device__ __forceinline__ void bwd_resident(
    Grp& grp, const Part& p, const T* __restrict__ xs,
    const T* __restrict__ dys, const float* __restrict__ gs,
    const float* __restrict__ bs, const BwdOut<T>& out, int n, int S,
    bool act) {
  float xv[NV][V], gv[NV][V];  // x, then xhat; dy, then g
  float s[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = p.tid + p.stride * j;
    if (k < p.cnt) {
      load<V>(xv[j], xs + (size_t)(p.beg + k) * V);
      load<V>(gv[j], dys + (size_t)(p.beg + k) * V);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) xv[j][i] = gv[j][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) s[0] += xv[j][i];
  }
  grp.all(s, 0);
  const float mean = s[0] / (float)n;
  float q[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (p.tid + p.stride * j < p.cnt) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = xv[j][i] - mean;
        q[0] = fmaf(d, d, q[0]);
      }
    }
  }
  grp.all(q, 1);
  const float rstd = rsqrtf(q[0] / (float)n + kEps);

  // xhat and g in place; the slab sums of d = g * gamma and d * xhat
  int cj[NV];
  float gam[NV];
  float sd[2] = {0.f, 0.f};
  ChannelWalk ch((p.beg + p.tid) * V, p.stride * V, S);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    cj[j] = ch.c;
    gam[j] = 0.f;
    if (p.tid + p.stride * j < p.cnt) {
      gam[j] = __ldg(gs + ch.c);
      const float bet = __ldg(bs + ch.c);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xh = (xv[j][i] - mean) * rstd;
        xv[j][i] = xh;
        if (act) gv[j][i] = silu_grad(gv[j][i], fmaf(xh, gam[j], bet));
        const float d = gv[j][i] * gam[j];
        sd[0] += d;
        sd[1] = fmaf(d, xh, sd[1]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) xv[j][i] = 0.f;  // no contribution
    }
    ch.next();
  }

  // per-channel sums of g and g * xhat over the channels this part holds
  const int lo = p.cnt > 0 ? p.beg * V / S : 0;
  const int hi = p.cnt > 0 ? ((p.beg + p.cnt) * V - 1) / S : -1;
  for (int c = lo; c <= hi; ++c) {
    float acc[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (cj[j] == c) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          acc[0] += gv[j][i];
          acc[1] = fmaf(gv[j][i], xv[j][i], acc[1]);
        }
      }
    }
    grp.part(acc);
    if (grp.leader() && p.store) out.param(c, acc[1], acc[0]);
  }
  if (p.store) zero_params(out, p, lo, hi);

  grp.all(sd, 2);
  const float md = sd[0] / (float)n, mdx = sd[1] / (float)n;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = p.tid + p.stride * j;
    if (k < p.cnt && p.store) {
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        o[i] = rstd * (gv[j][i] * gam[j] - md - xv[j][i] * mdx);
      store<V>(out.dxs + (size_t)(p.beg + k) * V, o);
    }
  }
  grp.done();
}

template <int V, class T>
__device__ __forceinline__ void bwd_stream(
    ClusterGroup& grp, const Part& p, const T* __restrict__ xs,
    const T* __restrict__ dys, const float* __restrict__ gs,
    const float* __restrict__ bs, const BwdOut<T>& out, int n, int S,
    bool act) {
  float s[1] = {0.f};
  for (int k = p.tid; k < p.cnt; k += p.stride) {
    float t[V];
    load<V>(t, xs + (size_t)(p.beg + k) * V);
#pragma unroll
    for (int i = 0; i < V; ++i) s[0] += t[i];
  }
  grp.all(s, 0);
  const float mean = s[0] / (float)n;
  float q[1] = {0.f};
  for (int k = p.tid; k < p.cnt; k += p.stride) {
    float t[V];
    load<V>(t, xs + (size_t)(p.beg + k) * V);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = t[i] - mean;
      q[0] = fmaf(d, d, q[0]);
    }
  }
  grp.all(q, 1);
  const float rstd = rsqrtf(q[0] / (float)n + kEps);

  // channel by channel (S % V == 0: a channel is whole vectors)
  const int sv = S / V;
  const int lo = p.cnt > 0 ? p.beg / sv : 0;
  const int hi = p.cnt > 0 ? (p.beg + p.cnt - 1) / sv : -1;
  float sd[2] = {0.f, 0.f};
  for (int c = lo; c <= hi; ++c) {
    const float gam = __ldg(gs + c), bet = __ldg(bs + c);
    const int k0 = max(p.beg, c * sv) - p.beg;
    const int k1 = min(p.beg + p.cnt, (c + 1) * sv) - p.beg;
    float acc[2] = {0.f, 0.f};
    for (int k = k0 + p.tid; k < k1; k += p.stride) {
      float t[V], dy[V];
      load<V>(t, xs + (size_t)(p.beg + k) * V);
      load<V>(dy, dys + (size_t)(p.beg + k) * V);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xh = (t[i] - mean) * rstd;
        const float g = act ? silu_grad(dy[i], fmaf(xh, gam, bet)) : dy[i];
        acc[0] += g;
        acc[1] = fmaf(g, xh, acc[1]);
        sd[0] += g * gam;
        sd[1] = fmaf(g * gam, xh, sd[1]);
      }
    }
    grp.part(acc);
    if (grp.leader()) out.param(c, acc[1], acc[0]);
  }
  zero_params(out, p, lo, hi);

  grp.all(sd, 2);
  const float md = sd[0] / (float)n, mdx = sd[1] / (float)n;
  for (int k = p.tid; k < p.cnt; k += p.stride) {
    const int c = (p.beg + k) / sv;
    const float gam = __ldg(gs + c), bet = __ldg(bs + c);
    float t[V], dy[V];
    load<V>(t, xs + (size_t)(p.beg + k) * V);
    load<V>(dy, dys + (size_t)(p.beg + k) * V);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xh = (t[i] - mean) * rstd;
      const float g = act ? silu_grad(dy[i], fmaf(xh, gam, bet)) : dy[i];
      t[i] = rstd * (g * gam - md - xh * mdx);
    }
    store<V>(out.dxs + (size_t)(p.beg + k) * V, t);
  }
  grp.done();
}

// ---- kernels ---------------------------------------------------------------

template <class T>
struct Args {
  const T* x;
  const float* gamma;
  const float* beta;
  const T* dy;        // K5b
  T* out;             // K5: out; K5b: dx
  float* scratch;     // K5b: (2, C, B * cluster)
  long long slabs;
  int G, cg, S, act;
};

template <int L, int V, int NV, bool BWD, class T>
__device__ __forceinline__ void small_body(const Args<T>& a) {
  const long long slab0 = (long long)blockIdx.x * (kThreads / L)
                          + threadIdx.x / L;
  const bool ok = slab0 < a.slabs;
  const long long slab = ok ? slab0 : 0;
  const int n = a.cg * a.S;
  const int c0 = (int)(slab % a.G) * a.cg;
  LaneGroup<L> grp{(int)(threadIdx.x % L)};
  const Part p{0, n / V, grp.lane, L, ok};
  if constexpr (BWD) {
    const BwdOut<T> out{a.out + slab * n, a.scratch, slab / a.G,
                        a.slabs / a.G, a.G * a.cg, c0, a.cg};
    bwd_resident<V, NV>(grp, p, a.x + slab * n, a.dy + slab * n,
                        a.gamma + c0, a.beta + c0, out, n, a.S, a.act);
  } else {
    fwd_resident<V, NV>(grp, p, a.x + slab * n, a.gamma + c0, a.beta + c0,
                        a.out + slab * n, n, a.S, a.act);
  }
}

// NV == 0: the stream plan
template <int V, int NV, bool BWD, class T>
__device__ __forceinline__ void cluster_body(const Args<T>& a) {
  __shared__ float red[2 * kWarps];
  __shared__ float slots[4];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long slab = blockIdx.x / cs;
  const int n = a.cg * a.S;
  const int c0 = (int)(slab % a.G) * a.cg;
  const int nvec = n / V, chunk = (nvec + cs - 1) / cs;
  const int beg = min(rank * chunk, nvec);
  const Part p{beg, min(chunk, nvec - beg), (int)threadIdx.x, kThreads,
               true};
  ClusterGroup grp{cluster, red, slots, (int)(threadIdx.x & 31),
                   (int)(threadIdx.x >> 5)};
  const T* xs = a.x + slab * n;
  if constexpr (BWD) {
    const BwdOut<T> out{a.out + slab * n, a.scratch,
                     slab / a.G * cs + rank, a.slabs / a.G * cs, a.G * a.cg,
                     c0, a.cg};
    if constexpr (NV == 0)
      bwd_stream<V>(grp, p, xs, a.dy + slab * n, a.gamma + c0, a.beta + c0,
                    out, n, a.S, a.act);
    else
      bwd_resident<V, NV>(grp, p, xs, a.dy + slab * n, a.gamma + c0,
                          a.beta + c0, out, n, a.S, a.act);
  } else {
    if constexpr (NV == 0)
      fwd_stream<V>(grp, p, xs, a.gamma + c0, a.beta + c0, a.out + slab * n,
                    n, a.S, a.act);
    else
      fwd_resident<V, NV>(grp, p, xs, a.gamma + c0, a.beta + c0,
                          a.out + slab * n, n, a.S, a.act);
  }
}

// K5 (traces name it gn_silu_kernel_*) and K5b (gn_silu_bwd_kernel_*);
// the bf16 variants carry __nv_bfloat16 among their template arguments
template <int L, int V, int NV, class T>
__global__ void __launch_bounds__(kThreads)
gn_silu_kernel_small(const Args<T> a) { small_body<L, V, NV, false>(a); }

template <int L, int V, int NV, class T>
__global__ void __launch_bounds__(kThreads)
gn_silu_bwd_kernel_small(const Args<T> a) { small_body<L, V, NV, true>(a); }

template <int V, int NV, class T>
__global__ void __launch_bounds__(kThreads)
gn_silu_kernel_cluster(const Args<T> a) { cluster_body<V, NV, false>(a); }

template <int V, int NV, class T>
__global__ void __launch_bounds__(kThreads)
gn_silu_bwd_kernel_cluster(const Args<T> a) {
  cluster_body<V, NV, true>(a);
}

template <class T>
using KernelFn = void (*)(const Args<T>);

template <int L, int V, int NV, bool BWD, class T>
KernelFn<T> small_kernel() {
  if constexpr (BWD) return gn_silu_bwd_kernel_small<L, V, NV, T>;
  else return gn_silu_kernel_small<L, V, NV, T>;
}

template <int V, int NV, bool BWD, class T>
KernelFn<T> cluster_kernel() {
  if constexpr (BWD) return gn_silu_bwd_kernel_cluster<V, NV, T>;
  else return gn_silu_kernel_cluster<V, NV, T>;
}

// The resident kernel of NV vectors of V elements (NV * V <= 32 floats a
// thread), or null for an NV the plan never gives
template <int L, int V, bool BWD, class T>
KernelFn<T> small_nv(int nv) {
  if (nv == 1) return small_kernel<L, V, 1, BWD, T>();
  if constexpr (L == 32) {
    if (nv == 2) return small_kernel<L, V, 2, BWD, T>();
    if (nv == 4) return small_kernel<L, V, 4, BWD, T>();
    if constexpr (8 * V <= 32)
      if (nv == 8) return small_kernel<L, V, 8, BWD, T>();
  }
  return nullptr;
}

template <int V, bool BWD, class T>
KernelFn<T> cluster_nv(int nv) {
  if (nv == 1) return cluster_kernel<V, 1, BWD, T>();
  if (nv == 2) return cluster_kernel<V, 2, BWD, T>();
  if (nv == 4) return cluster_kernel<V, 4, BWD, T>();
  if constexpr (8 * V <= 32)
    if (nv == 8) return cluster_kernel<V, 8, BWD, T>();
  return nullptr;
}

// dgamma[c] and dbeta[c]: each row of the (2, C, R) scratch summed in one
// fixed order (block y = 0: dgamma, 1: dbeta)
__global__ void __launch_bounds__(kThreads)
gn_silu_bwd_params(const float* __restrict__ scratch,
                   float* __restrict__ dgamma, float* __restrict__ dbeta,
                   int C, long long rows) {
  __shared__ float red[kWarps];
  const float* row = scratch + ((size_t)blockIdx.y * C + blockIdx.x) * rows;
  float s = 0.f;
  for (long long i = threadIdx.x; i < rows; i += kThreads) s += row[i];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w];
    (blockIdx.y ? dbeta : dgamma)[blockIdx.x] = t;
  }
}

// ---- the host's plan ---------------------------------------------------------

enum Kind { kSmall = 0, kCluster = 1, kStream = 2 };

struct Plan {
  int kind, lanes, cluster, nv, vec;
};

int pow2_at_least(long long v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// ops/kernels/groupnorm.py launch_plan is this function in Python; width:
// the elements of one 16-byte vector (4 in fp32, 8 in bf16)
Plan choose(long long n, int S, bool aligned, int width) {
  const int vec = (S % width == 0 && aligned) ? width : 1;
  const long long nvec = n / vec;
  if (n <= kSmallMax) {
    if (vec == 1) {  // 32 lanes, 1, 4 or 32 floats each
      const int nv = pow2_at_least(cdiv(n, 32));
      return {kSmall, 32, 1, nv <= 1 ? 1 : nv <= 4 ? 4 : 32, 1};
    }
    const int lanes = nvec <= 8 ? 8 : nvec <= 16 ? 16 : 32;
    return {kSmall, lanes, 1, pow2_at_least(cdiv(nvec, lanes)), vec};
  }
  int cs = pow2_at_least(cdiv(n, kBlockFloats));
  cs = cs < 2 ? 2 : cs > kMaxCluster ? kMaxCluster : cs;
  const int nv = pow2_at_least(cdiv(nvec, (long long)cs * kThreads));
  if (vec > 1 && nv * vec <= 32) return {kCluster, kThreads, cs, nv, vec};
  if (vec == 1 && nv <= 16) return {kCluster, kThreads, cs, 16, 1};
  return {kStream, kThreads, kMaxCluster, 0, vec};
}

template <bool BWD, class T>
cudaError_t launch_small(const Plan& p, const Args<T>& a, cudaStream_t st) {
  constexpr int W = kVec<T>;
  const dim3 grid((unsigned int)cdiv(a.slabs, kThreads / p.lanes));
  KernelFn<T> k;
  if (p.vec == 1) {
    k = p.nv == 1 ? small_kernel<32, 1, 1, BWD, T>()
        : p.nv == 4 ? small_kernel<32, 1, 4, BWD, T>()
        : small_kernel<32, 1, 32, BWD, T>();
  } else if (p.lanes == 8) {
    k = small_nv<8, W, BWD, T>(p.nv);
  } else if (p.lanes == 16) {
    k = small_nv<16, W, BWD, T>(p.nv);
  } else {
    k = small_nv<32, W, BWD, T>(p.nv);
  }
  if (k == nullptr) return cudaErrorInvalidConfiguration;
  k<<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// blocks of k in clusters of `cluster` (1 to 8) on st
template <class A>
cudaError_t launch_clusters(void (*k)(const A), long long blocks, int cluster,
                            const A& a, cudaStream_t st) {
  if (k == nullptr || blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, k, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool BWD, class T>
cudaError_t launch_large(const Plan& p, const Args<T>& a, cudaStream_t st) {
  constexpr int W = kVec<T>;
  KernelFn<T> k;
  if (p.kind == kStream) {
    k = p.vec == 1 ? cluster_kernel<1, 0, BWD, T>()
                   : cluster_kernel<W, 0, BWD, T>();
  } else if (p.vec == 1) {
    k = cluster_kernel<1, 16, BWD, T>();
  } else {
    k = cluster_nv<W, BWD, T>(p.nv);
  }
  return launch_clusters(k, a.slabs * p.cluster, p.cluster, a, st);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <bool BWD, class T>
cudaError_t launch(const Plan& p, const Args<T>& a, cudaStream_t st) {
  return p.kind == kSmall ? launch_small<BWD>(p, a, st)
                          : launch_large<BWD>(p, a, st);
}

template <class T>
int forward(const T* x, const float* gamma, const float* beta, T* out,
            long long B, int C, int G, int S, int silu, void* stream) {
  const long long slabs = B * G;
  if (slabs == 0 || S == 0) return 0;
  if ((long long)(C / G) * S > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Args<T> a{x, gamma, beta, nullptr, out, nullptr, slabs, G, C / G, S,
                  silu};
  const Plan plan = choose((long long)(C / G) * S, S,
                           aligned16(x) && aligned16(out), kVec<T>);
  return (int)launch<false>(plan, a, (cudaStream_t)stream);
}

template <class T>
int backward(const T* x, const float* gamma, const float* beta, const T* dy,
             T* dx, float* dgamma, float* dbeta, float* scratch,
             long long scratch_floats, long long B, int C, int G, int S,
             int silu, void* stream) {
  const long long slabs = B * G;
  if (C == 0) return 0;
  if ((long long)(C / G) * S > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (slabs == 0 || S == 0) {  // no element: the sums are zero
    cudaError_t err = cudaMemsetAsync(dgamma, 0, C * sizeof(float), st);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dbeta, 0, C * sizeof(float), st);
    return (int)err;
  }
  const Args<T> a{x, gamma, beta, dy, dx, scratch, slabs, G, C / G, S, silu};
  const Plan plan = choose((long long)(C / G) * S, S,
                           aligned16(x) && aligned16(dx) && aligned16(dy),
                           kVec<T>);
  const long long rows = B * plan.cluster;
  if (2 * (long long)C * rows > scratch_floats)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch<true>(plan, a, st);
  if (err != cudaSuccess) return (int)err;
  gn_silu_bwd_params<<<dim3(C, 2), kThreads, 0, st>>>(scratch, dgamma, dbeta,
                                                      C, rows);
  return (int)cudaGetLastError();
}

// ---- K5b in bf16: a plan of its own ------------------------------------------
//
// The fp32 plan counted in elements gave a bf16 block half the bytes of an
// fp32 block for the same rounds of cluster-wide sums, and small slabs of
// the 128x128 DSM step clusters of tiny blocks. Here (choose_bwd_bf16,
// mirrored by groupnorm.py bwd_bf16_plan) a block of kThreads holds
// kBfBlockElems elements, 16 KB of x as an fp32 block holds 4,096 floats:
// 4 vectors of 8 a thread, x as loaded (widened where used) and g = dL/dh
// computed once in fp32 (a fast sigmoid); a warp's lanes a slab of up to
// kBfSmallMax; a cluster only past one block (2 blocks at 16,384
// elements, 8 at 49,152). Two rounds of sums a block's slab, each in one
// fixed order (a few lanes' slab takes one more, of shuffles only): (1)
// the count, mean and centred sum of squares of each part, from its
// registers, combined by Chan's rule (no second trip over the values, no
// E[x^2] - E[x]^2); (2) per channel of the slab, sum g and sum
// g*xhat (up to kBfChannels channels a round, as many values as the slab
// has channels), from which dbeta's and dgamma's slab sums come and, times
// gamma, the slab's sums of d and d*xhat that dx needs. Across warps and
// blocks one warp adds the partials in order and shares the result. The
// slab's leader writes its channels' sums into a (2, C, B) scratch (no
// zeros for channels a part lacks), which gn_silu_bwd_params adds over
// the batch in a second launch: a last-block ticket in the same launch was
// slower (one block's walk over 2C rows of B sums, latency-bound, cost
// more than the launch: PERF.md, K5b bf16). dx is rounded to bf16 once, at
// its store. Slabs past a cluster's registers stream through the bf16
// instance of the fp32 plan's stream kernel.

constexpr int kBfSmallMax = 1024;     // elements: the small plan's largest slab
constexpr int kBfBlockElems = 8192;   // elements a block of K5b holds
constexpr int kBfScalarElems = 4096;  // ... without 16-byte loads (16 a thread)
constexpr int kBfChannels = 8;        // channels summed a round
constexpr int kBfFwdBlockElems = 16384;  // elements a block of K5 holds

// count, mean and centred sum of squares of a part of a slab
struct Stats {
  float n, m, q;
};

// Chan's combination of the parts a and b (a before b)
__device__ __forceinline__ Stats chan(Stats a, Stats b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float t = a.n + b.n, d = b.m - a.m, f = b.n / t;
  return {t, fmaf(d, f, a.m), a.q + b.q + d * d * a.n * f};
}

// the parts of a warp's lanes combined by an xor tree; both partners
// combine (lower lane, upper lane), so every lane gets the same bits
__device__ __forceinline__ Stats warp_stats(Stats s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Stats t = {__shfl_xor_sync(0xffffffffu, s.n, o),
                     __shfl_xor_sync(0xffffffffu, s.m, o),
                     __shfl_xor_sync(0xffffffffu, s.q, o)};
    s = (lane & o) ? chan(t, s) : chan(s, t);
  }
  return s;
}

// v[0..kk) summed over L neighbouring lanes (every lane gets the sums)
template <int L, int K>
__device__ __forceinline__ void lanes_sum(float (&v)[K], int kk) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k < kk)
#pragma unroll
      for (int o = L / 2; o; o >>= 1)
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
}

// The threads of one slab: L lanes of a warp, whose statistics take two
// rounds of shuffles (the sum, then the centred sum of squares about the
// mean: cheaper than Chan's rule, a division a level) ...
template <int L>
struct BfLanes {
  static constexpr bool kTwoRounds = true;
  template <int K>
  __device__ __forceinline__ void sums(float (&v)[K], int kk, int) const {
    lanes_sum<L>(v, kk);
  }
  __device__ __forceinline__ bool leader() const {
    return threadIdx.x % L == 0;
  }
  __device__ __forceinline__ void done() const {}
};

// ... or the blocks of a cluster (of 1 to 8), each holding one part: warp
// trees, then the block's warps in order (warp 0 from shared memory), then
// the cluster's blocks in order (warp 0 reading each block's by
// distributed shared memory), the result in shared memory for every
// thread: the same bits in every block
struct BfCluster {
  static constexpr bool kTwoRounds = false;  // Chan's rule, one round
  cg::cluster_group cluster;
  float* red;    // shared: kWarps * 2 * kBfChannels, then 2 * kBfChannels
  float* slots;  // shared: 4 + 2 * kBfChannels
  int blocks;

  __device__ __forceinline__ float* res() const {
    return red + kWarps * 2 * kBfChannels;
  }
  __device__ __forceinline__ Stats stats(Stats s) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    s = warp_stats(s);
    if (lane == 0)
      red[3 * warp] = s.n, red[3 * warp + 1] = s.m, red[3 * warp + 2] = s.q;
    __syncthreads();
    float* out = blocks > 1 ? slots : res();
    if (threadIdx.x == 0) {
      Stats b = {0.f, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        b = chan(b, {red[3 * w], red[3 * w + 1], red[3 * w + 2]});
      out[0] = b.n, out[1] = b.m, out[2] = b.q;
    }
    if (blocks > 1) {
      cluster.sync();
      if (threadIdx.x == 0) {
        Stats b = {0.f, 0.f, 0.f};
        for (int r = 0; r < blocks; ++r) {
          const float* o = cluster.map_shared_rank(slots, r);
          b = chan(b, {o[0], o[1], o[2]});
        }
        res()[0] = b.n, res()[1] = b.m, res()[2] = b.q;
      }
    }
    __syncthreads();
    return {res()[0], res()[1], res()[2]};
  }
  // the sums of v[0..kk); round > 0 reuses the slots once every block has
  // read the last round's
  template <int K>
  __device__ __forceinline__ void sums(float (&v)[K], int kk,
                                       int round) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    lanes_sum<32>(v, kk);
    __syncthreads();  // the last round's red and results have been read
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k < kk) red[k * kWarps + warp] = v[k];
    __syncthreads();
    if (blocks > 1 && round > 0) cluster.sync();
    if (warp == 0 && lane < kk) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red[lane * kWarps + w];
      (blocks > 1 ? slots + 4 : res())[lane] = t;
    }
    if (blocks > 1) {
      cluster.sync();
      if (warp == 0 && lane < kk) {
        float t = 0.f;
        for (int r = 0; r < blocks; ++r)
          t += *cluster.map_shared_rank(slots + 4 + lane, r);
        res()[lane] = t;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < kk) v[k] = res()[k];
  }
  __device__ __forceinline__ bool leader() const {
    return threadIdx.x == 0 && cluster.block_rank() == 0;
  }
  // no block may leave while another can still read its slots
  __device__ __forceinline__ void done() const {
    if (blocks > 1) cluster.sync();
  }
};

// V bf16 as loaded (their bits): a 16-byte vector, or one element
template <int V>
struct BfRaw {
  uint4 u;
};
template <>
struct BfRaw<1> {
  unsigned short u;
};

template <int V>
__device__ __forceinline__ void bf_load(BfRaw<V>& r, const bf16* p) {
  if constexpr (V == 1)
    r.u = __bfloat16_as_ushort(p[0]);
  else
    r.u = __ldg(reinterpret_cast<const uint4*>(p));
}

template <int V>
__device__ __forceinline__ void bf_zero(BfRaw<V>& r) {
  if constexpr (V == 1)
    r.u = 0;
  else
    r.u = make_uint4(0u, 0u, 0u, 0u);
}

// Ties the bits to this point of the program, so that the compiler widens
// them again where they are used next instead of keeping every widened
// value alive across a round of sums: 8 floats a vector where the bits
// take 4 registers (255 registers and spills without)
template <int V>
__device__ __forceinline__ void launder(BfRaw<V>& r) {
  if constexpr (V == 1)
    asm volatile("" : "+h"(r.u));
  else
    asm volatile("" : "+r"(r.u.x), "+r"(r.u.y), "+r"(r.u.z), "+r"(r.u.w));
}

template <int V>
__device__ __forceinline__ void widen(const BfRaw<V>& r, float (&d)[V]) {
  if constexpr (V == 1) {
    d[0] = __bfloat162float(__ushort_as_bfloat16(r.u));
  } else {
    const uint32_t w[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      d[2 * i] = f.x;
      d[2 * i + 1] = f.y;
    }
  }
}

// where one slab's sums of g (dbeta) and g * xhat (dgamma) go: row c0 + c
// (and C + c0 + c) of the (2, C, B) scratch, column b
struct BfParams {
  float* scratch;
  long long b, B;
  int C, c0;
};

template <int V, int NV, class Grp>
__device__ __forceinline__ void bwd_bf16_body(
    Grp& grp, const Part& p, const bf16* __restrict__ xs,
    const bf16* __restrict__ dys, const float* __restrict__ gs,
    const float* __restrict__ bs, bf16* __restrict__ dxs,
    const BfParams& out, int cg, int S, bool act) {
  const int n = cg * S;
  BfRaw<V> xr[NV], dr[NV];
  int cj[NV];  // the channel (of the slab) of vector j
  ChannelWalk walk((p.beg + p.tid) * V, p.stride * V, S);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = p.tid + p.stride * j;
    cj[j] = walk.c;
    walk.next();
    if (k < p.cnt) {
      bf_load<V>(xr[j], xs + (size_t)(p.beg + k) * V);
      bf_load<V>(dr[j], dys + (size_t)(p.beg + k) * V);
    } else {
      bf_zero<V>(xr[j]);
      bf_zero<V>(dr[j]);
    }
  }
  auto valid = [&](int j) { return p.tid + p.stride * j < p.cnt; };
  auto launder_x = [&]() {
#pragma unroll
    for (int j = 0; j < NV; ++j) launder<V>(xr[j]);
  };
  // (1) this thread's count, mean and centred sum of squares, combined
  float sum = 0.f, cnt = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (valid(j)) {
      float x[V];
      widen<V>(xr[j], x);
#pragma unroll
      for (int i = 0; i < V; ++i) sum += x[i];
      cnt += (float)V;
    }
  }
  float mean;
  if constexpr (Grp::kTwoRounds) {
    float t[1] = {sum};
    grp.sums(t, 1, 0);
    mean = t[0] / (float)n;
  } else {
    mean = cnt > 0.f ? sum / cnt : 0.f;  // this part's, until combined
  }
  float q[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (valid(j)) {
      float x[V];
      widen<V>(xr[j], x);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = x[i] - mean;
        q[0] = fmaf(d, d, q[0]);
      }
    }
  }
  if constexpr (Grp::kTwoRounds) {
    grp.sums(q, 1, 0);
  } else {
    const Stats st = grp.stats({cnt, mean, q[0]});
    mean = st.m, q[0] = st.q;
  }
  const float rstd = rsqrtf(q[0] / (float)n + kEps);

  // g = dL/dh, once, kept in registers: the SiLU's derivative at h = xhat
  // gamma + beta (a fast sigmoid), or dy; x stays as its bits
  float g[NV][V];
  launder_x();
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    widen<V>(dr[j], g[j]);
    if (act && valid(j)) {
      float x[V];
      widen<V>(xr[j], x);
      const float gam = __ldg(gs + cj[j]), bet = __ldg(bs + cj[j]);
#pragma unroll
      for (int i = 0; i < V; ++i)
        g[j][i] = silu_grad_fast(g[j][i], fmaf((x[i] - mean) * rstd, gam, bet));
    }
  }

  // (2) per channel, sum g and sum g * xhat, kBfChannels a round; the
  // slab's sums of d = g gamma and d xhat follow from them
  float sd = 0.f, sdx = 0.f;
  for (int c0 = 0, round = 0; c0 < cg; c0 += kBfChannels, ++round) {
    const int kc = min(cg - c0, kBfChannels);  // channels this round
    float acc[2 * kBfChannels];  // (sum g, sum g xhat) per channel
#pragma unroll
    for (int k = 0; k < 2 * kBfChannels; ++k) acc[k] = 0.f;
    launder_x();
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = cj[j] - c0;
      if (valid(j) && c >= 0 && c < kBfChannels) {
        float x[V];
        widen<V>(xr[j], x);
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s0 += g[j][i];
          s1 = fmaf(g[j][i], (x[i] - mean) * rstd, s1);
        }
#pragma unroll
        for (int k = 0; k < kBfChannels; ++k)
          if (c == k) acc[2 * k] += s0, acc[2 * k + 1] += s1;
      }
    }
    grp.sums(acc, 2 * kc, round);
#pragma unroll
    for (int k = 0; k < kBfChannels; ++k) {
      if (k < kc) {
        const int c = c0 + k;
        const float gam = __ldg(gs + c);
        sd = fmaf(gam, acc[2 * k], sd);
        sdx = fmaf(gam, acc[2 * k + 1], sdx);
        if (p.store && grp.leader()) {
          out.scratch[(size_t)(out.c0 + c) * out.B + out.b] = acc[2 * k + 1];
          out.scratch[((size_t)out.C + out.c0 + c) * out.B + out.b] =
              acc[2 * k];
        }
      }
    }
  }
  const float md = sd / (float)n, mdx = sdx / (float)n;
  launder_x();
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (valid(j) && p.store) {
      float x[V];
      widen<V>(xr[j], x);
      const float gam = __ldg(gs + cj[j]);
#pragma unroll
      for (int i = 0; i < V; ++i)
        x[i] = rstd * (g[j][i] * gam - md - (x[i] - mean) * rstd * mdx);
      store<V>(dxs + (size_t)(p.beg + p.tid + p.stride * j) * V, x);
    }
  }
  grp.done();
}

struct BfArgs {
  const bf16* x;
  const float* gamma;
  const float* beta;
  const bf16* dy;  // K5b
  bf16* out;       // K5: out; K5b: dx
  float* scratch;  // K5b: (2, C, B)
  long long slabs, B;
  int G, cg, S, act;
};

template <int L, int V, int NV>
__global__ void __launch_bounds__(kThreads, 3)
gn_silu_bwd_kernel_bf16_small(const BfArgs a) {
  const long long slab0 =
      (long long)blockIdx.x * (kThreads / L) + threadIdx.x / L;
  const bool ok = slab0 < a.slabs;
  const long long slab = ok ? slab0 : 0;
  const int n = a.cg * a.S, c0 = (int)(slab % a.G) * a.cg;
  BfLanes<L> grp;
  const Part p{0, n / V, (int)(threadIdx.x % L), L, ok};
  const BfParams out{a.scratch, slab / a.G, a.B, a.G * a.cg, c0};
  bwd_bf16_body<V, NV>(grp, p, a.x + slab * n, a.dy + slab * n,
                       a.gamma + c0, a.beta + c0, a.out + slab * n, out, a.cg,
                       a.S, a.act);
}

template <int V, int NV>
__global__ void __launch_bounds__(kThreads, 3)
gn_silu_bwd_kernel_bf16_cluster(const BfArgs a) {
  __shared__ float red[(kWarps + 1) * 2 * kBfChannels];
  __shared__ float slots[4 + 2 * kBfChannels];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const long long slab = blockIdx.x / cs;
  const int n = a.cg * a.S, c0 = (int)(slab % a.G) * a.cg;
  const int nvec = n / V, chunk = (nvec + cs - 1) / cs;
  const int beg = min(rank * chunk, nvec);
  const Part p{beg, min(chunk, nvec - beg), (int)threadIdx.x, kThreads, true};
  BfCluster grp{cluster, red, slots, cs};
  const BfParams out{a.scratch, slab / a.G, a.B, a.G * a.cg, c0};
  bwd_bf16_body<V, NV>(grp, p, a.x + slab * n, a.dy + slab * n,
                       a.gamma + c0, a.beta + c0, a.out + slab * n, out, a.cg,
                       a.S, a.act);
}

// ---- K5 in bf16: kernels of its own -----------------------------------------
//
// Bound: bytes (2 read and 2 written an element). On the fp32 plan a bf16
// block held 4,096 elements (8 KB), so every slab of the 128x128 DSM step
// took a cluster of 2-8 blocks and two rounds of cluster-wide sums. Here
// (choose_fwd_bf16, mirrored by groupnorm.py fwd_bf16_plan) a block of
// kThreads holds kBfFwdBlockElems elements, 32 KB of x as its bits (8
// vectors of 8 a thread, 64 registers, four blocks an SM), so a slab of up
// to 16,384 elements takes one block and no cluster barrier, and larger
// ones (24,576 to 49,152 in the DSM step) clusters of 2 or 4; a warp's
// lanes a slab up to kBfSmallMax. The statistics: in a few lanes two
// rounds of shuffles (the sum, then the centred squares); across warps
// and blocks one round, each part's count, mean and centred sum of
// squares combined by Chan's rule in one fixed order (BfCluster: one
// round of distributed shared memory, then the barrier that keeps a block
// until the others have read its slots). The affine and SiLU run on the
// bits in bf16x2 (a product and a sum rounded once each) with a fast
// sigmoid that rounds as the plain version's (sigmoid_bf16), so with the
// same scale and shift every output has the plain version's bits; on the
// small plan the sums keep the fp32 plan's order, so there K5 bf16 gives
// the bits it gave on that plan. Measured against 16 KB blocks (clusters
// from 16,384 elements: slower by the cluster barriers) and against a
// persistent grid that copies each slab into shared memory by the TMA
// while it normalises the one before (slower up to 16,384 elements, where
// its per-slab barriers dominate): PERF.md, K5 bf16. Slabs past 8 blocks
// stream through the fp32 plan's stream kernel in bf16.

// bf16x2 products and sums rounded once to nearest (the explicit .rn keeps
// ptxas from contracting a product and a sum into one rounding)
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// bf16(sigmoid(h)) with the plain version's bits (PyTorch's sigmoid in
// fp32, 1 / (1 + exp(-h)) with the accurate exponential and division, then
// rounded), from the fast exponential and the approximate reciprocal that
// keeps subnormals (__fdividef's gives 0 where 1 + exp(-h) passes 2^126, so
// three bf16 h near -87.5 rounded otherwise): a few fp32 ulps off, which
// no bf16 h carries across a bf16 rounding midpoint.
// test_torch_kernels_cuda_k5_bf16_dsm.py holds K5 bf16's SiLU to PyTorch's
// at every bf16 h of magnitude below 128; beyond, both saturate (to 1, and
// to 0 through an infinite 1 + exp(-h)).
__device__ __forceinline__ float sigmoid_bf16(float h) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(1.f + __expf(-h)));
  return round_bf16(r);
}

// One channel's scale = bf16(rstd gamma) and shift = bf16(beta - mean rstd
// gamma), the shift's fp32 value in one fused multiply-add as the resident
// kernels above form it (the small plan's slabs then get their bits); as
// floats and as bf16x2 pairs
struct BfAffine {
  float sc, sh;
  uint32_t sc2, sh2;
  __device__ __forceinline__ BfAffine(float mean, float rstd, float gam,
                                      float bet) {
    const float a = __fmul_rn(rstd, gam);
    const uint32_t s = __bfloat16_as_ushort(__float2bfloat16_rn(a));
    const uint32_t t =
        __bfloat16_as_ushort(__float2bfloat16_rn(__fmaf_rn(-mean, a, bet)));
    sc = __uint_as_float(s << 16);
    sh = __uint_as_float(t << 16);
    sc2 = s | (s << 16);
    sh2 = t | (t << 16);
  }
  // two elements: h = bf16(bf16(x scale) + shift), then under SiLU
  // bf16(h bf16(sigmoid(h))): a product and a sum of bf16 values are exact
  // in fp32, so rounding them once in bf16x2 gives the plain version's bits
  __device__ __forceinline__ uint32_t pair(uint32_t x, bool act) const {
    uint32_t h = bf2_add(bf2_mul(x, sc2), sh2);
    if (act) {
      const __nv_bfloat162 s = __floats2bfloat162_rn(
          sigmoid_bf16(__uint_as_float(h << 16)),
          sigmoid_bf16(__uint_as_float(h & 0xffff0000u)));
      h = bf2_mul(h, *reinterpret_cast<const uint32_t*>(&s));
    }
    return h;
  }
  // ... one element, the same steps in fp32 rounded to bf16
  __device__ __forceinline__ unsigned short one(unsigned short x,
                                                bool act) const {
    float h = round_bf16(__fadd_rn(
        round_bf16(__fmul_rn(__uint_as_float((uint32_t)x << 16), sc)), sh));
    if (act) h = __fmul_rn(h, sigmoid_bf16(h));
    return __bfloat16_as_ushort(__float2bfloat16_rn(h));
  }
  template <int V>
  __device__ __forceinline__ void apply(BfRaw<V>& r, bool act) const {
    if constexpr (V == 1) {
      r.u = one(r.u, act);
    } else {
      r.u.x = pair(r.u.x, act);
      r.u.y = pair(r.u.y, act);
      r.u.z = pair(r.u.z, act);
      r.u.w = pair(r.u.w, act);
    }
  }
};

template <int V>
__device__ __forceinline__ void bf_store(bf16* p, const BfRaw<V>& r) {
  if constexpr (V == 1)
    p[0] = __ushort_as_bfloat16(r.u);
  else
    *reinterpret_cast<uint4*>(p) = r.u;
}

// K5 bf16 on one part of a slab held in registers: the statistics (two
// rounds of shuffles in a few lanes, else Chan's rule in one round), then
// the affine and SiLU in bf16x2, stored from the same registers
template <int V, int NV, class Grp>
__device__ __forceinline__ void fwd_bf16_body(
    Grp& grp, const Part& p, const bf16* __restrict__ xs,
    const float* __restrict__ gs, const float* __restrict__ bs,
    bf16* __restrict__ os, int n, int S, bool act) {
  BfRaw<V> xr[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = p.tid + p.stride * j;
    if (k < p.cnt)
      bf_load<V>(xr[j], xs + (size_t)(p.beg + k) * V);
    else
      bf_zero<V>(xr[j]);
  }
  auto valid = [&](int j) { return p.tid + p.stride * j < p.cnt; };
  float sum = 0.f, cnt = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (valid(j)) {
      float x[V];
      widen<V>(xr[j], x);
#pragma unroll
      for (int i = 0; i < V; ++i) sum += x[i];
      cnt += (float)V;
    }
  }
  float mean;
  if constexpr (Grp::kTwoRounds) {
    float t[1] = {sum};
    grp.sums(t, 1, 0);
    mean = t[0] / (float)n;
  } else {
    mean = cnt > 0.f ? sum / cnt : 0.f;  // this part's, until combined
  }
  float q[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    launder<V>(xr[j]);
    if (valid(j)) {
      float x[V];
      widen<V>(xr[j], x);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = x[i] - mean;
        q[0] = fmaf(d, d, q[0]);
      }
    }
  }
  if constexpr (Grp::kTwoRounds) {
    grp.sums(q, 1, 0);
  } else {
    const Stats st = grp.stats({cnt, mean, q[0]});
    mean = st.m, q[0] = st.q;
  }
  const float rstd = rsqrtf(q[0] / (float)n + kEps);
  ChannelWalk walk((p.beg + p.tid) * V, p.stride * V, S);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (valid(j) && p.store) {
      const BfAffine f(mean, rstd, __ldg(gs + walk.c), __ldg(bs + walk.c));
      f.apply<V>(xr[j], act);
      bf_store<V>(os + (size_t)(p.beg + p.tid + p.stride * j) * V, xr[j]);
    }
    walk.next();
  }
  grp.done();
}

template <int L, int V, int NV>
__global__ void __launch_bounds__(kThreads)
gn_silu_kernel_bf16_small(const BfArgs a) {
  const long long slab0 =
      (long long)blockIdx.x * (kThreads / L) + threadIdx.x / L;
  const bool ok = slab0 < a.slabs;
  const long long slab = ok ? slab0 : 0;
  const int n = a.cg * a.S, c0 = (int)(slab % a.G) * a.cg;
  BfLanes<L> grp;
  const Part p{0, n / V, (int)(threadIdx.x % L), L, ok};
  fwd_bf16_body<V, NV>(grp, p, a.x + slab * n, a.gamma + c0, a.beta + c0,
                       a.out + slab * n, n, a.S, a.act);
}

template <int V, int NV>
__global__ void __launch_bounds__(kThreads, 4)
gn_silu_kernel_bf16_cluster(const BfArgs a) {
  __shared__ float red[(kWarps + 1) * 2 * kBfChannels];
  __shared__ float slots[4 + 2 * kBfChannels];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const long long slab = blockIdx.x / cs;
  const int n = a.cg * a.S, c0 = (int)(slab % a.G) * a.cg;
  const int nvec = n / V, chunk = (nvec + cs - 1) / cs;
  const int beg = min(rank * chunk, nvec);
  const Part p{beg, min(chunk, nvec - beg), (int)threadIdx.x, kThreads, true};
  BfCluster grp{cluster, red, slots, cs};
  fwd_bf16_body<V, NV>(grp, p, a.x + slab * n, a.gamma + c0, a.beta + c0,
                       a.out + slab * n, n, a.S, a.act);
}

// The bf16 plans (K5b's and K5's, each with its block's elements): 8, 16 or
// 32 lanes of a warp a slab up to kBfSmallMax elements, then one block
// holding block_elems of them (kBfScalarElems without 16-byte loads), a
// cluster only past one block, streaming past kMaxCluster blocks;
// ops/kernels/groupnorm.py bf16_plan is this function in Python
Plan choose_bf16(long long n, int S, bool aligned, int block_elems) {
  const int vec = (S % 8 == 0 && aligned) ? 8 : 1;
  const long long nvec = n / vec;
  if (n <= kBfSmallMax) {
    if (vec == 1) {  // 32 lanes, 1, 4 or 32 elements each
      const int nv = pow2_at_least(cdiv(n, 32));
      return {kSmall, 32, 1, nv <= 1 ? 1 : nv <= 4 ? 4 : 32, 1};
    }
    const int lanes = nvec <= 8 ? 8 : nvec <= 16 ? 16 : 32;
    return {kSmall, lanes, 1, pow2_at_least(cdiv(nvec, lanes)), 8};
  }
  const int cap = vec == 8 ? block_elems / kThreads / 8
                           : kBfScalarElems / kThreads;  // vectors a thread
  int cs = pow2_at_least(cdiv(nvec, (long long)kThreads * cap));
  if (cs > kMaxCluster) cs = kMaxCluster;
  const int nv = pow2_at_least(cdiv(nvec, (long long)cs * kThreads));
  if (nv <= cap) return {kCluster, kThreads, cs, vec == 8 ? nv : cap, vec};
  return {kStream, kThreads, kMaxCluster, 0, vec};
}

Plan choose_bwd_bf16(long long n, int S, bool aligned) {
  return choose_bf16(n, S, aligned, kBfBlockElems);
}

Plan choose_fwd_bf16(long long n, int S, bool aligned) {
  return choose_bf16(n, S, aligned, kBfFwdBlockElems);
}

using BfKernel = void (*)(const BfArgs);

// the bf16 kernels of a plan: K5b's (BWD) or K5's
template <bool BWD, int L, int V, int NV>
BfKernel bf_small() {
  if constexpr (BWD) return gn_silu_bwd_kernel_bf16_small<L, V, NV>;
  else return gn_silu_kernel_bf16_small<L, V, NV>;
}

template <bool BWD, int V, int NV>
BfKernel bf_cluster() {
  if constexpr (BWD) return gn_silu_bwd_kernel_bf16_cluster<V, NV>;
  else return gn_silu_kernel_bf16_cluster<V, NV>;
}

template <bool BWD>
BfKernel bf_small_kernel(const Plan& p) {
  if (p.vec == 1)
    return p.nv == 1   ? bf_small<BWD, 32, 1, 1>()
           : p.nv == 4 ? bf_small<BWD, 32, 1, 4>()
                       : bf_small<BWD, 32, 1, 32>();
  if (p.lanes == 8) return bf_small<BWD, 8, 8, 1>();
  if (p.lanes == 16) return bf_small<BWD, 16, 8, 1>();
  switch (p.nv) {
    case 1: return bf_small<BWD, 32, 8, 1>();
    case 2: return bf_small<BWD, 32, 8, 2>();
    case 4: return bf_small<BWD, 32, 8, 4>();
  }
  return nullptr;
}

template <bool BWD>
BfKernel bf_cluster_kernel(const Plan& p) {
  if (p.vec == 1) return bf_cluster<BWD, 1, 16>();
  switch (p.nv) {
    case 1: return bf_cluster<BWD, 8, 1>();
    case 2: return bf_cluster<BWD, 8, 2>();
    case 4: return bf_cluster<BWD, 8, 4>();
    case 8:  // K5's block alone holds 8 vectors a thread
      if constexpr (!BWD) return bf_cluster<BWD, 8, 8>();
  }
  return nullptr;
}

int backward_bf16(const bf16* x, const float* gamma, const float* beta,
                  const bf16* dy, bf16* dx, float* dgamma, float* dbeta,
                  float* scratch, long long scratch_floats, long long B,
                  int C, int G, int S, int silu, cudaStream_t st) {
  const long long n = (long long)(C / G) * S;
  const Plan plan = choose_bwd_bf16(
      n, S, aligned16(x) && aligned16(dx) && aligned16(dy));
  if (plan.kind == kStream) {  // the fp32 plan's stream kernel, in bf16
    const Args<bf16> a{x, gamma, beta, dy, dx, scratch, B * G, G, C / G, S,
                       silu};
    const long long rows = B * plan.cluster;
    if (2 * (long long)C * rows > scratch_floats)
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = launch_clusters(
        plan.vec == 1 ? cluster_kernel<1, 0, true, bf16>()
                      : cluster_kernel<8, 0, true, bf16>(),
        a.slabs * plan.cluster, plan.cluster, a, st);
    if (err != cudaSuccess) return (int)err;
    gn_silu_bwd_params<<<dim3(C, 2), kThreads, 0, st>>>(scratch, dgamma,
                                                        dbeta, C, rows);
    return (int)cudaGetLastError();
  }
  if (2 * (long long)C * B > scratch_floats) return (int)cudaErrorInvalidValue;
  const BfArgs a{x, gamma, beta, dy, dx, scratch, B * G, B, G, C / G, S,
                 silu};
  cudaError_t err;
  if (plan.kind == kSmall) {
    const BfKernel k = bf_small_kernel<true>(plan);
    if (k == nullptr) return (int)cudaErrorInvalidConfiguration;
    k<<<(unsigned int)cdiv(a.slabs, kThreads / plan.lanes), kThreads, 0,
        st>>>(a);
    err = cudaGetLastError();
  } else {
    err = launch_clusters(bf_cluster_kernel<true>(plan),
                          a.slabs * plan.cluster, plan.cluster, a, st);
  }
  if (err != cudaSuccess) return (int)err;
  gn_silu_bwd_params<<<dim3(C, 2), kThreads, 0, st>>>(scratch, dgamma, dbeta,
                                                      C, B);
  return (int)cudaGetLastError();
}

int forward_bf16(const bf16* x, const float* gamma, const float* beta,
                 bf16* out, long long B, int C, int G, int S, int silu,
                 cudaStream_t st) {
  const long long slabs = B * G;
  if (slabs == 0 || S == 0) return 0;
  const long long n = (long long)(C / G) * S;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Plan plan = choose_fwd_bf16(n, S, aligned16(x) && aligned16(out));
  if (plan.kind == kStream) {  // the fp32 plan's stream kernel, in bf16
    const Args<bf16> a{x, gamma, beta, nullptr, out, nullptr, slabs, G,
                       C / G, S, silu};
    return (int)launch_clusters(plan.vec == 1
                                    ? cluster_kernel<1, 0, false, bf16>()
                                    : cluster_kernel<8, 0, false, bf16>(),
                                slabs * plan.cluster, plan.cluster, a, st);
  }
  const BfArgs a{x, gamma, beta, nullptr, out, nullptr, slabs, B, G, C / G,
                 S, silu};
  if (plan.kind == kSmall) {
    const BfKernel k = bf_small_kernel<false>(plan);
    if (k == nullptr) return (int)cudaErrorInvalidConfiguration;
    k<<<(unsigned int)cdiv(slabs, kThreads / plan.lanes), kThreads, 0, st>>>(
        a);
    return (int)cudaGetLastError();
  }
  return (int)launch_clusters(bf_cluster_kernel<false>(plan),
                              slabs * plan.cluster, plan.cluster, a, st);
}

}  // namespace

extern "C" int group_norm_silu_f32(const float* x, const float* gamma,
                                   const float* beta, float* out, long long B,
                                   int C, int G, int S, int silu,
                                   void* stream) {
  return forward(x, gamma, beta, out, B, C, G, S, silu, stream);
}

// K5 in bf16: x and out bf16, gamma and beta fp32
extern "C" int group_norm_silu_bf16(const bf16* x, const float* gamma,
                                    const float* beta, bf16* out, long long B,
                                    int C, int G, int S, int silu,
                                    void* stream) {
  return forward_bf16(x, gamma, beta, out, B, C, G, S, silu,
                      (cudaStream_t)stream);
}

// K5 bf16's plan for slabs of n elements (as group_norm_silu_plan), for the
// card tests to hold groupnorm.py fwd_bf16_plan to
extern "C" int group_norm_silu_bf16_plan(long long n, int S, int aligned,
                                         int* plan) {
  const Plan p = choose_fwd_bf16(n, S, aligned != 0);
  plan[0] = p.kind;
  plan[1] = p.lanes;
  plan[2] = p.cluster;
  plan[3] = p.nv;
  plan[4] = p.vec;
  return 0;
}

// The plan for slabs of n elements (kind: 0 small, 1 cluster, 2 stream;
// lanes, cluster, nv, vec) with `width` elements per 16-byte vector (4:
// fp32, 8: bf16), for the card tests to hold the Python mirror to.
extern "C" int group_norm_silu_plan(long long n, int S, int aligned,
                                    int width, int* plan) {
  const Plan p = choose(n, S, aligned != 0, width);
  plan[0] = p.kind;
  plan[1] = p.lanes;
  plan[2] = p.cluster;
  plan[3] = p.nv;
  plan[4] = p.vec;
  return 0;
}

// K5b: dx (B, C, S), dgamma (C), dbeta (C) from x, gamma, beta and dy;
// scratch holds scratch_floats floats, at least 2 * C * B * the plan's
// cluster size (1 for slabs of up to 1,024 floats, else at most 8).
extern "C" int group_norm_silu_bwd_f32(
    const float* x, const float* gamma, const float* beta, const float* dy,
    float* dx, float* dgamma, float* dbeta, float* scratch,
    long long scratch_floats, long long B, int C, int G, int S, int silu,
    void* stream) {
  return backward(x, gamma, beta, dy, dx, dgamma, dbeta, scratch,
                  scratch_floats, B, C, G, S, silu, stream);
}

// K5b in bf16: x, dy and dx bf16; gamma, beta, dgamma, dbeta fp32, on the
// plan of choose_bwd_bf16; scratch holds scratch_floats floats, at least
// 2 * C * B (2 * C * B * 8 where the plan streams).
extern "C" int group_norm_silu_bwd_bf16(
    const bf16* x, const float* gamma, const float* beta, const bf16* dy,
    bf16* dx, float* dgamma, float* dbeta, float* scratch,
    long long scratch_floats, long long B, int C, int G, int S, int silu,
    void* stream) {
  if (C == 0) return 0;
  if ((long long)(C / G) * S > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (B * G == 0 || S == 0) {  // no element: the sums are zero
    cudaError_t err = cudaMemsetAsync(dgamma, 0, C * sizeof(float), st);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dbeta, 0, C * sizeof(float), st);
    return (int)err;
  }
  return backward_bf16(x, gamma, beta, dy, dx, dgamma, dbeta, scratch,
                       scratch_floats, B, C, G, S, silu, st);
}

// K5b bf16's plan for slabs of n elements (as group_norm_silu_plan), for the
// card tests to hold groupnorm.py bwd_bf16_plan to
extern "C" int group_norm_silu_bwd_bf16_plan(long long n, int S, int aligned,
                                             int* plan) {
  const Plan p = choose_bwd_bf16(n, S, aligned != 0);
  plan[0] = p.kind;
  plan[1] = p.lanes;
  plan[2] = p.cluster;
  plan[3] = p.nv;
  plan[4] = p.vec;
  return 0;
}
