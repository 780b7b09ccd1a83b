// K2: the fused RK4 step of the zero-drift circulant flow, float32, and the
// whole forward solve with the per-sample select in one launch.
//
// One step, with the noise w = scale * z of the step:
//   k_s   = c * ( roll(sb_s*x_s, -1)*w  -  roll(sb_s*x_s*w, +1) )
//   x_1 = x,  x_2 = x + 0.5*k1,  x_3 = x + 0.5*k2,  x_4 = x + k3
//   sb_1 = sb3[0],  sb_2 = sb_3 = sb3[1],  sb_4 = sb3[2]
//   x <- x + (k1 + 2*k2 + 2*k3 + k4) * (1/6)
// with wrap-around neighbours within each row and c = sqrt(2)/2.
//
// Two C entries run the same kernels:
//  - circulant_rk4_step_f32: one step of every row (scale 1, z = w, sb3
//    per row); it replaces the Pallas kernel _rk4_kernel / _rk4_pallas in
//    sdeflow_tpu/ops/pallas/circulant.py:98-133 (entry circulant_rk4_step
//    :136-146), which holds a 256-row tile in VMEM and builds the neighbours
//    of each stage with pltpu.roll.
//  - circulant_rk4_solve_select_f32: what integrate_select computes with
//    that step (sdeflow_tpu/ops/integrators.py:203-243, there a lax.scan
//    with the Pallas kernel in its body): row b takes steps i < sel[b] with
//    w = scale * z[i, b] and sb3 = sb[i], and writes its state after them
//    (x0 where sel[b] == 0), so a row stops after its own last needed step
//    and never reads the normals of later steps.
//
// Bound on the H100: bytes. A step reads sb3, x and w once and writes out
// (about 12 bytes per element) for 36 flops per element; at the training
// shape (B=128, d=256) that is ~0.39 MB, ~0.12 us at 3.35 TB/s, below the
// cost of a launch. The solve reads x0, the z rows its rows need and writes
// kept; its 4·sel[b] stages per row are dependent, so on 128 rows it is
// bound by the latency of that chain, not by bytes.
//
// Design, two plans that the host picks from the shape (choose below,
// mirrored by ops/kernels/circulant.py rk4_plan):
//  - warp plan, d % 32 == 0 and d <= 1,024 (the training path's d = 256):
//    one warp per row, the state, the noise, the stage state, the stage
//    value and the running sum in registers (d/32 floats each per lane, a
//    template parameter), the rolls by one shuffle each way (circ_row.cuh).
//    No shared memory, no barrier; sb3 read once per row and step. In the
//    solve the state stays in registers across the steps, and the next
//    step's normals and sb3 are loaded while the current step computes. Four
//    rows per block, so 128 rows spread over 32 SMs, one warp per scheduler.
//  - general plan, any other d (e.g. d > 1,024): one block owns `rows` whole
//    rows (several when d < 256 threads, one otherwise, its threads then
//    looping over the columns). The state, the stage state, the stage
//    values and the running sum live in four buffers of rows*d floats: in
//    dynamic shared memory when they fit (16 KB at d=1024), else in a global
//    scratch slice of the block. __syncthreads() separates the reads of a
//    stage's neighbours from the writes of the next stage state; the steps
//    run to the block's longest row, the others idle.
// Every product and sum is rounded separately (__fmul_rn / __fadd_rn, no FMA
// contraction) in the plain PyTorch version's order, and the division by 6
// is a product with the float 1/6 as PyTorch's CUDA division by a number
// is, so both plans agree with the plain version bit for bit; scale is the
// float that PyTorch's CUDA `tensor * python_float` rounds the number to.

#include "circ_row.cuh"

namespace {

constexpr int kThreads = 256;  // general plan (must match _THREADS in circulant.py)
constexpr int kRows = 4;       // warp plan: rows (warps) per block
constexpr long long kSmemLimit = 232448;  // bytes one H100 block may use
constexpr int kBuffers = 4;    // general plan: state, stage, k, sum

struct Args {
  const float* x0;       // (batch, d) initial state
  const float* z;        // (n, batch, d) normals; w = scale * z
  float scale;
  const float* sb;       // sqrt(beta) at the stage times: sb[i*sb_step + b*sb_row + s]
  long long sb_row, sb_step;
  const long long* sel;  // (batch,) steps per row; null: every row takes n
  float* out;            // (batch, d)
  long long batch, d, n;
};

// the steps row takes: sel[row] where it lies in [0, n], else 0 (the plain
// version's masked select keeps x0 for any other value)
__device__ __forceinline__ long long steps_of(const Args& a, long long row) {
  if (a.sel == nullptr) return a.n;
  const long long m = a.sel[row];
  return m < 0 || m > a.n ? 0 : m;
}

// one RK4 step of the warp's row, x updated in place
template <int V>
__device__ __forceinline__ void warp_step(const float (&sb3)[3], float (&x)[V],
                                          const float (&w)[V], int lane) {
  float k[V], xs[V], sum[V];
  circ::stencil<V>(sb3[0], x, w, k, lane);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sum[j] = k[j];
    xs[j] = __fadd_rn(x[j], __fmul_rn(0.5f, k[j]));
  }
  circ::stencil<V>(sb3[1], xs, w, k, lane);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sum[j] = __fadd_rn(sum[j], __fmul_rn(2.0f, k[j]));
    xs[j] = __fadd_rn(x[j], __fmul_rn(0.5f, k[j]));
  }
  circ::stencil<V>(sb3[1], xs, w, k, lane);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sum[j] = __fadd_rn(sum[j], __fmul_rn(2.0f, k[j]));
    xs[j] = __fadd_rn(x[j], k[j]);
  }
  circ::stencil<V>(sb3[2], xs, w, k, lane);
#pragma unroll
  for (int j = 0; j < V; ++j)
    x[j] = __fadd_rn(x[j], __fmul_rn(__fadd_rn(sum[j], k[j]), 1.0f / 6.0f));
}

template <int V, bool VEC>
__global__ void __launch_bounds__(kRows * 32) rk4_warp_kernel(const Args a) {
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x / 32;
  if (row >= a.batch) return;  // the whole warp: its shuffles stay full
  const int lane = threadIdx.x & 31;
  const long long off = row * (32 * V), plane = a.batch * (32 * V);
  const long long m = steps_of(a, row);
  float x[V], z[V], sb3[3];
  circ::load_row<V, VEC>(a.x0 + off, lane, x);
  if (m > 0) {
    circ::load_row<V, VEC>(a.z + off, lane, z);
    const float* s = a.sb + row * a.sb_row;
    sb3[0] = s[0], sb3[1] = s[1], sb3[2] = s[2];
  }
  for (long long i = 0; i < m; ++i) {
    float w[V];
    const float sbi[3] = {sb3[0], sb3[1], sb3[2]};
#pragma unroll
    for (int j = 0; j < V; ++j) w[j] = __fmul_rn(a.scale, z[j]);
    if (i + 1 < m) {  // the next step's inputs, in flight during this step
      circ::load_row<V, VEC>(a.z + (i + 1) * plane + off, lane, z);
      const float* s = a.sb + (i + 1) * a.sb_step + row * a.sb_row;
      sb3[0] = s[0], sb3[1] = s[1], sb3[2] = s[2];
    }
    warp_step<V>(sbi, x, w, lane);
  }
  circ::store_row<V, VEC>(a.out + off, lane, x);
}

__global__ void rk4_block_kernel(const Args a, float* __restrict__ scratch,
                                 long long rows, int in_smem) {
  extern __shared__ float smem[];
  const long long d = a.d, row0 = (long long)blockIdx.x * rows;
  const long long n = rows * d;  // elements this block owns (some masked)
  float* xs = in_smem ? smem : scratch + (long long)blockIdx.x * kBuffers * n;
  float* stage = xs + n;
  float* kbuf = stage + n;
  float* sum = kbuf + n;

  // steps of the row of element e of the block (0 past the batch)
  auto steps = [&](long long e) {
    const long long row = row0 + e / d;
    return row < a.batch ? steps_of(a, row) : 0LL;
  };
  long long most = 0;
  for (long long r = 0; r < rows; ++r) {
    const long long m = steps(r * d);
    most = m > most ? m : most;
  }
  for (long long e = threadIdx.x; e < n; e += blockDim.x)
    if (row0 + e / d < a.batch) xs[e] = a.x0[row0 * d + e];
  __syncthreads();

  for (long long i = 0; i < most; ++i) {
    const float* zi = a.z + i * a.batch * d + row0 * d;
    // k_s at element e from the stage state y
    auto stage_value = [&](long long e, const float* y, int s) {
      const long long r = e / d, c = e - r * d, base = r * d;
      const long long nxt = base + (c + 1 == d ? 0 : c + 1);
      const long long prv = base + (c == 0 ? d - 1 : c - 1);
      const float sb = a.sb[i * a.sb_step + (row0 + r) * a.sb_row + s];
      const float yb_next = __fmul_rn(sb, y[nxt]);
      const float ybw_prev =
          __fmul_rn(__fmul_rn(sb, y[prv]), __fmul_rn(a.scale, zi[prv]));
      return __fmul_rn(circ::kCoef,
                       __fsub_rn(__fmul_rn(yb_next, __fmul_rn(a.scale, zi[e])),
                                 ybw_prev));
    };
    // stages 1-3: k_s, the running sum, then the next stage state
    const int sb_col[3] = {0, 1, 1};
    const float half[3] = {0.5f, 0.5f, 1.0f};   // x + half*k_s
    const float weight[3] = {1.0f, 2.0f, 2.0f};  // sum += weight*k_s
    for (int s = 0; s < 3; ++s) {
      for (long long e = threadIdx.x; e < n; e += blockDim.x) {
        if (i >= steps(e)) continue;
        const float k = stage_value(e, s == 0 ? xs : stage, sb_col[s]);
        kbuf[e] = k;
        sum[e] = s == 0 ? k : __fadd_rn(sum[e], __fmul_rn(weight[s], k));
      }
      __syncthreads();
      for (long long e = threadIdx.x; e < n; e += blockDim.x)
        if (i < steps(e))
          stage[e] = __fadd_rn(xs[e], __fmul_rn(half[s], kbuf[e]));
      __syncthreads();
    }
    // stage 4 and the combine
    for (long long e = threadIdx.x; e < n; e += blockDim.x) {
      if (i >= steps(e)) continue;
      const float k4 = stage_value(e, stage, 2);
      xs[e] = __fadd_rn(xs[e], __fmul_rn(__fadd_rn(sum[e], k4), 1.0f / 6.0f));
    }
    __syncthreads();
  }
  for (long long e = threadIdx.x; e < n; e += blockDim.x)
    if (row0 + e / d < a.batch) a.out[row0 * d + e] = xs[e];
}

using WarpKernel = void (*)(const Args);

// the warp kernel for V floats per lane (vec: float4 loads)
template <int V>
WarpKernel warp_kernel(int v, bool vec) {
  if constexpr (V == 0) {
    return nullptr;
  } else {
    if (v == V)
      return vec ? rk4_warp_kernel<V, V % 4 == 0> : rk4_warp_kernel<V, false>;
    return warp_kernel<V - 1>(v, vec);
  }
}

// ops/kernels/circulant.py rk4_plan is this function in Python
circ::Plan choose(long long batch, long long d, bool aligned) {
  const int v = circ::per_lane(d);
  if (v)
    return {circ::kWarp, v, (v % 4 == 0 && aligned) ? 4 : 1, kRows,
            circ::cdiv(batch, kRows), 0};
  const long long rows = d < kThreads ? kThreads / d : 1;
  const bool in_smem = kBuffers * 4 * rows * d <= kSmemLimit;
  return {circ::kGeneral, 0, 1, rows, circ::cdiv(batch, rows), in_smem};
}

int launch(const Args& a, float* scratch, long long scratch_floats,
           cudaStream_t st) {
  if (a.batch == 0 || a.d == 0) return 0;
  const circ::Plan p =
      choose(a.batch, a.d,
             circ::aligned16(a.x0) && circ::aligned16(a.z) &&
                 circ::aligned16(a.out));
  if (p.kind == circ::kWarp) {
    const WarpKernel k =
        warp_kernel<circ::kMaxPerLane>((int)p.per_lane, p.vec == 4);
    k<<<(unsigned int)p.blocks, kRows * 32, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  const long long floats = kBuffers * p.rows * a.d;
  if (!p.in_smem && scratch_floats < p.blocks * floats)
    return (int)cudaErrorInvalidValue;
  const size_t smem = p.in_smem ? (size_t)floats * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rk4_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rk4_block_kernel<<<(unsigned int)p.blocks, kThreads, smem, st>>>(
      a, scratch, p.rows, (int)p.in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

// One step: sb3 (batch, 3), x and w (batch, d) -> out. scratch holds
// scratch_floats floats: the general plan's buffers where shared memory
// cannot hold them (rk4_plan's blocks * 4 * rows * d), else unused.
extern "C" int circulant_rk4_step_f32(const float* sb3, const float* x,
                                      const float* w, float* out,
                                      float* scratch,
                                      long long scratch_floats,
                                      long long batch, long long d,
                                      void* stream) {
  const Args a{x, w, 1.0f, sb3, 3, 0, nullptr, out, batch, d, 1};
  return launch(a, scratch, scratch_floats, (cudaStream_t)stream);
}

// The solve: x0 (batch, d), z (n, batch, d), sb (n, 3), sel (batch,) int64
// -> kept (batch, d); scratch as for the step.
extern "C" int circulant_rk4_solve_select_f32(
    const float* x0, const float* z, float scale, const float* sb,
    const long long* sel, float* kept, float* scratch,
    long long scratch_floats, long long batch, long long d, long long n,
    void* stream) {
  const Args a{x0, z, scale, sb, 0, 3, sel, kept, batch, d, n};
  return launch(a, scratch, scratch_floats, (cudaStream_t)stream);
}

// The plan for rows of d floats (kind, per_lane, vec, rows per block,
// blocks, in_smem), for the card tests to hold the Python mirror to.
extern "C" int circulant_rk4_plan(long long batch, long long d, int aligned,
                                  long long* plan) {
  circ::write_plan(choose(batch, d, aligned != 0), plan);
  return 0;
}
