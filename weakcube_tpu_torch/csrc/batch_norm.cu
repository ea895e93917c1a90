// BatchNorm's training pass for NVIDIA Hopper (sm_90a): the batch
// statistics and the normalisation forward, the reductions and the input
// gradient backward, two launches each, over NHWC-contiguous activations
// (the trunks' channels_last) in bfloat16 or float32.
//
// Replaces no Pallas kernel. The JAX package's flax BatchNorm is XLA, which
// fuses it. The port's plain chain, models/layers.py::BatchNorm2d, casts the
// bf16 activation to float32, takes x * x and two means, broadcasts
// (x - mean) * mul + bias over a channels_last tensor, casts back and makes
// six small launches for the pending running statistics: ~20 launches
// forward and ~25 in autograd's backward, most over the whole float32
// tensor. These kernels compute the same function in 2 + 2 launches, save
// only x in its own dtype and a few float32 vectors per channel, and keep
// no float32 copy of the activation.
//
// What they compute, per channel c over the R = N * H * W rows of x:
//   m = sum x / R, q = sum x^2 / R, d = q - m^2, v = max(d, 0)
//   (flax's biased variance E[x^2] - E[x]^2, which layers.py keeps; not a
//   two-pass or Welford form), r = rsqrt(v + eps), a = r * w,
//   y = (x - m) * a + b, stored in x's dtype;
//   pending = (keep * running_mean + momentum * m,
//              keep * running_var + momentum * v), keep = 1 - momentum.
// The forward is the plain chain's bit for bit. Its sums are float32 sums
// in the order of PyTorch's own reduction of the chain's float32 tensors x
// and x * x (ATen/native/cuda/Reduce.cuh, whose launch plan
// ops/batch_norm_cuda.py::stats_plan computes: four interleaved
// accumulators a thread, a tree over the block's warps, the blocks of a
// column staged and summed by the last of them), and every later step is
// one float32 rounding as the chain's elementwise kernels round it (x^2 is
// exact for bf16 x; no fma contraction; mean = sum * (C / (C * R)) as
// PyTorch's mean scales; rsqrtf). This matters beyond rounding: a
// rounding-level change of the backbone's activations moves which anchors
// the RPN keeps and which RoIs a step samples, so the training step's loss
// would move by a percent.
// Backward, g = dL/dy:
//   sg = sum g, sgx = sum g (x - m); grad_b = sg, grad_w = sgx * r;
//   dv = [d >= 0] * sgx * w * (-r^3 / 2), the clamp's subgradient as autograd
//   of clamp(min=0) gives it (the gradient passes at d = 0 and not below);
//   dx = g * a + (2 dv / R) * (x - m) - a * sg / R.
// That dx is the chain rule through v = q - m^2: dq = dv,
// dm = -a sg - 2 m dv, dx = g a + (dm + 2 x dq) / R, with its terms in m
// and in x gathered into one in (x - m). Exact arithmetic gives the same
// number; in float32 the gathered form loses nothing to the cancellation of
// 2 x dq against 2 m dq when a channel's mean is large against its spread,
// and sum g (x - m) likewise in place of sum g x - m sum g. The backward's
// sums are its own: float32 in each thread, float64 across threads and
// blocks and in each channel's finish, rounded once to float32.
//
// Determinism: no float atomics. A block writes its partial sums to a
// workspace and takes a ticket from an integer counter of its grid column;
// the block that draws the last ticket sums the partials in block order,
// then sets the counter back to 0 for the next launch. Which block finishes
// decides nothing about the order, so two launches give the same bits. The
// counters are one zeroed buffer per device (the wrapper's); the kernels of
// one device run on one stream at a time.
//
// Bound on the card: bytes. A few flops an element against 2-4 bytes. This
// two-read design reads x twice and writes y once forward (6 B an element in
// bf16) and reads g and x twice and writes dx once backward (10 B); ~675 M
// elements a b25 step of DLA-34 at 512 px (39 layers, 2 of them forward
// only) move ~10.6 GB, 3.2 ms at 3.35 TB/s. The second reads come from L2
// where the tensor fits: the normalisation and dx kernels walk each block's
// rows from its last down, so the rows that the reduction read last, the
// likeliest still in L2, come first.
//
// Design: the statistics launch has PyTorch's reduction's geometry, its
// order being the point; its last block's loads of the staged partials run
// ahead of the adds (the order of the adds unchanged). The other three
// launch blocks of 256 threads over a (row chunk, column chunk) grid. A
// column chunk is 128 channels or fewer (C at most); a thread owns one
// 16-byte vector of them (8 bf16 or 4 float32 channels; one channel on the
// scalar path, which any C takes that the vector does not divide, such as
// ShuffleNetV2's 116), so the block reads `lanes` = 256 / (vectors of the
// chunk) rows at once, 4 such sets a step in flight. A thread's channels
// and their per-channel coefficients stay in its registers for the whole
// launch. About two blocks an SM in all; a row chunk is at least one step's
// rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;          // row sets a thread has in flight
constexpr int kChunkChannels = 128;  // = ops/batch_norm_cuda.py's CHUNK_CHANNELS
constexpr int kMaxStatsThreads = 512;  // PyTorch's reductions' MAX_NUM_THREADS
constexpr int kStage = 8;              // staged partials a thread loads at once

// V channels of T <-> V floats
template <typename T, int V> struct Vec;

template <> struct Vec<float, 4> {
  __device__ static void load(const void* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  __device__ static void store(void* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Vec<__nv_bfloat16, 8> {
  __device__ static void load(const void* p, float* v) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static void store(void* p, const float* v) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <> struct Vec<float, 1> {
  __device__ static void load(const void* p, float* v) { v[0] = *reinterpret_cast<const float*>(p); }
  __device__ static void store(void* p, const float* v) { *reinterpret_cast<float*>(p) = v[0]; }
};

template <> struct Vec<__nv_bfloat16, 1> {
  __device__ static void load(const void* p, float* v) {
    v[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  }
  __device__ static void store(void* p, const float* v) {
    *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16(v[0]);
  }
};

// The launch geometry, the same for the kernels of one call
struct Plan {
  long long rows;            // R = N * H * W
  long long rows_per_block;  // a row chunk
  int C;
  int cols;                  // vectors in a column chunk
  int lanes;                 // rows a block reads at once: kThreads / cols
};

// Where a thread works: its row lane and vector column, its first channel,
// and its block's rows [r0, r1). `on` is false for a thread without a
// column (past the chunk's channels, or past lanes * cols).
template <int V> struct Place {
  int lane, c0;
  bool on;
  long long r0, r1;
};

template <int V>
__device__ __forceinline__ Place<V> place(const Plan& p, int chunk) {
  Place<V> s;
  s.lane = threadIdx.x / p.cols;
  s.c0 = (blockIdx.y * p.cols + threadIdx.x % p.cols) * V;
  s.on = s.lane < p.lanes && s.c0 < p.C;
  s.r0 = (long long)chunk * p.rows_per_block;
  s.r1 = min(p.rows, s.r0 + p.rows_per_block);
  return s;
}

// The block's two per-channel float32 sums a0, a1 (its threads' registers)
// summed over its lanes in float64 by a fixed tree and written to the
// workspace (ws: [2][gridDim.x][C] float64). Returns true in the block of
// the column chunk that drew the last ticket; there, `red[1]` holds the
// chunk's K channels' totals over every block, in block order: [0, K) of
// a0, [K, 2K) of a1.
template <int V>
__device__ bool block_sums(const Plan& p, const Place<V>& s, const float (&a0)[V],
                           const float (&a1)[V], double* __restrict__ ws,
                           unsigned* __restrict__ counters, double (*red)[kThreads * V]) {
  __shared__ unsigned ticket;
  const int t = threadIdx.x;
  if (s.on) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[0][t * V + k] = a0[k];
      red[1][t * V + k] = a1[k];
    }
  }
  __syncthreads();
  for (int n = p.lanes; n > 1;) {
    const int h = (n + 1) >> 1;
    if (s.on && s.lane < n - h) {
      const int o = (t + h * p.cols) * V;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        red[0][t * V + k] += red[0][o + k];
        red[1][t * V + k] += red[1][o + k];
      }
    }
    __syncthreads();
    n = h;
  }
  const int G = gridDim.x;
  if (s.on && s.lane == 0) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      ws[(size_t)blockIdx.x * p.C + s.c0 + k] = red[0][t * V + k];
      ws[((size_t)G + blockIdx.x) * p.C + s.c0 + k] = red[1][t * V + k];
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0) ticket = atomicAdd(counters + blockIdx.y, 1u);
  __syncthreads();
  if (ticket != (unsigned)G - 1) return false;
  __threadfence();
  // the last block: each (channel, sum) pair's partials over the G blocks,
  // L threads a pair, each taking every L-th block in order, then the L
  // pieces in order
  const int cb = blockIdx.y * p.cols * V;
  const int K = min(p.cols * V, p.C - cb);
  const int P = 2 * K, L = max(1, kThreads / P);
  double acc = 0.0;
  if (t < P * L) {
    const int pair = t / L, l = t % L;
    const double* src = ws + (size_t)(pair / K) * G * p.C + cb + pair % K;
#pragma unroll 8
    for (int b = l; b < G; b += L) acc += __ldcg(src + (size_t)b * p.C);
  }
  red[0][t] = acc;
  __syncthreads();
  if (t < P) {
    double sum = 0.0;
    for (int l = 0; l < L; ++l) sum += red[0][t * L + l];
    red[1][t] = sum;
  }
  __syncthreads();
  if (t == 0) counters[blockIdx.y] = 0u;
  return true;
}

// Forward 1's plan: PyTorch's own reduction of a float32 (R, C) tensor over
// R with C contiguous, as ATen/native/cuda/Reduce.cuh's setReduceConfig
// lays it out (ops/batch_norm_cuda.py::stats_plan computes it): `ovs`
// channels a thread, blocks of (bw, bh) threads, grid (grid_x, ctas).
struct StatsPlan {
  long long rows;        // R
  long long step_input;  // rows between a thread's consecutive rows
  int C;
  int bw, bh;            // block (lanes over channel vectors, warps over rows)
  int out_mult1;         // channel vectors a warp index moves (0: none)
  int in_mult1;          // rows a warp index moves (0: no block_y_reduce)
  int in_mult2;          // rows a blockIdx.y moves (0: ctas == 1)
  int step_output;       // channel vectors a blockIdx.x moves
  int ctas;              // blocks over the rows (global reduce when > 1)
  float factor;          // mean's (float)C / (float)(C * R)
};

// OVS channels of T at p <-> OVS floats (p aligned to OVS * sizeof(T))
template <typename T, int OVS> struct Load;
template <> struct Load<__nv_bfloat16, 4> {
  __device__ static void get(const __nv_bfloat16* p, float* v) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(t.x << 16); v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16); v[3] = __uint_as_float(t.y & 0xffff0000u);
  }
};
template <> struct Load<__nv_bfloat16, 2> {
  __device__ static void get(const __nv_bfloat16* p, float* v) {
    const unsigned t = *reinterpret_cast<const unsigned*>(p);
    v[0] = __uint_as_float(t << 16); v[1] = __uint_as_float(t & 0xffff0000u);
  }
};
template <> struct Load<__nv_bfloat16, 1> {
  __device__ static void get(const __nv_bfloat16* p, float* v) { v[0] = __bfloat162float(*p); }
};
template <> struct Load<float, 4> {
  __device__ static void get(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
};
template <> struct Load<float, 2> {
  __device__ static void get(const float* p, float* v) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
};
template <> struct Load<float, 1> {
  __device__ static void get(const float* p, float* v) { v[0] = *p; }
};

// PyTorch's block_y_reduce: a tree over threadIdx.y in shared memory
template <int OVS>
__device__ __forceinline__ void block_y_reduce(float (&s)[OVS], float (&sq)[OVS],
                                               float (*sh)[OVS], int bw) {
  const int me = threadIdx.x + threadIdx.y * bw;
#pragma unroll
  for (int j = 0; j < OVS; ++j) {
    sh[me][j] = s[j];
    sh[kMaxStatsThreads + me][j] = sq[j];
  }
  for (int offset = blockDim.y / 2; offset > 0; offset >>= 1) {
    __syncthreads();
    if (threadIdx.y < offset && threadIdx.y + offset < blockDim.y) {
      const int o = me + offset * bw;
#pragma unroll
      for (int j = 0; j < OVS; ++j) {
        s[j] = __fadd_rn(s[j], sh[o][j]);
        sq[j] = __fadd_rn(sq[j], sh[kMaxStatsThreads + o][j]);
        sh[me][j] = s[j];
        sh[kMaxStatsThreads + me][j] = sq[j];
      }
    }
  }
}

// Forward 1: per-channel sum x and sum x^2 in float32, each summed in the
// order in which PyTorch's reduction sums the float32 tensors x and x * x
// (thread_reduce_impl's four interleaved accumulators, block_y_reduce,
// global_reduce's staging and last block), so that the mean and E[x^2] are
// the plain chain's bit for bit; then, in the threads that hold a total,
// the chain's finish rounded op by op: coef [4][C] (mean, r, a = r * w,
// the clamp's pass flag [d >= 0]) and pending [2][C].
template <typename T, int OVS>
__global__ void __launch_bounds__(kMaxStatsThreads)
bn_train_stats_kernel(const T* __restrict__ x, StatsPlan q, const float* __restrict__ w,
                      const float* __restrict__ rmean, const float* __restrict__ rvar,
                      float keep, float momentum, float eps, float* __restrict__ staging,
                      unsigned* __restrict__ counters, float* __restrict__ coef,
                      float* __restrict__ pending) {
  __shared__ float sh[2 * kMaxStatsThreads][OVS];
  __shared__ bool last;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int out = (tx + ty * q.out_mult1 + blockIdx.x * q.step_output) * OVS;
  const long long in0 = (long long)ty * q.in_mult1 + (long long)blockIdx.y * q.in_mult2;
  float s[OVS], sq[OVS];
#pragma unroll
  for (int j = 0; j < OVS; ++j) s[j] = sq[j] = 0.f;
  if (out < q.C && in0 < q.rows) {
    float a[4][OVS], b[4][OVS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < OVS; ++j) a[i][j] = b[i][j] = 0.f;
    const long long st = q.step_input;
    long long idx = in0;
    while (idx + 3 * st < q.rows) {
      float v[4][OVS];
#pragma unroll
      for (int i = 0; i < 4; ++i) Load<T, OVS>::get(x + (idx + i * st) * q.C + out, v[i]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OVS; ++j) {
          a[i][j] = __fadd_rn(a[i][j], v[i][j]);
          b[i][j] = __fadd_rn(b[i][j], __fmul_rn(v[i][j], v[i][j]));
        }
      idx += 4 * st;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (idx >= q.rows) break;
      float v[OVS];
      Load<T, OVS>::get(x + idx * q.C + out, v);
#pragma unroll
      for (int j = 0; j < OVS; ++j) {
        a[i][j] = __fadd_rn(a[i][j], v[j]);
        b[i][j] = __fadd_rn(b[i][j], __fmul_rn(v[j], v[j]));
      }
      idx += st;
    }
#pragma unroll
    for (int j = 0; j < OVS; ++j) {
      s[j] = __fadd_rn(__fadd_rn(__fadd_rn(a[0][j], a[1][j]), a[2][j]), a[3][j]);
      sq[j] = __fadd_rn(__fadd_rn(__fadd_rn(b[0][j], b[1][j]), b[2][j]), b[3][j]);
    }
  }
  if (q.in_mult1) block_y_reduce<OVS>(s, sq, sh, q.bw);
  if (q.ctas > 1) {
    // global_reduce: each block's totals to staging [grid_x][ctas][bw][2][OVS];
    // the block that finishes last sums them, warp ty taking blocks ty,
    // ty + bh, ... in order, then block_y_reduce
    float* mine = staging + (((size_t)blockIdx.x * q.ctas + blockIdx.y) * q.bw + tx) * 2 * OVS;
    if (out < q.C && ty == 0) {
#pragma unroll
      for (int j = 0; j < OVS; ++j) {
        mine[j] = s[j];
        mine[OVS + j] = sq[j];
      }
    }
    __threadfence();
    __syncthreads();
    if (tx == 0 && ty == 0) last = atomicAdd(counters + blockIdx.x, 1u) == (unsigned)q.ctas - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int j = 0; j < OVS; ++j) s[j] = sq[j] = 0.f;
    // the same sums in the same order, kStage blocks' partials loaded ahead
    // of their adds (a thread sums up to ctas / bh = 400 of them)
    for (int io = ty; io < q.ctas; io += kStage * q.bh) {
      float v[kStage][2 * OVS];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int k = io + u * q.bh;
        if (k < q.ctas) {
          const float* p = staging + (((size_t)blockIdx.x * q.ctas + k) * q.bw + tx) * 2 * OVS;
#pragma unroll
          for (int j = 0; j < 2 * OVS; ++j) v[u][j] = __ldcg(p + j);
        }
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        if (io + u * q.bh < q.ctas) {
#pragma unroll
          for (int j = 0; j < OVS; ++j) {
            s[j] = __fadd_rn(s[j], v[u][j]);
            sq[j] = __fadd_rn(sq[j], v[u][OVS + j]);
          }
        }
      }
    }
    block_y_reduce<OVS>(s, sq, sh, q.bw);
    if (tx == 0 && ty == 0) counters[blockIdx.x] = 0u;
  }
  if (out >= q.C || (q.in_mult1 && ty != 0)) return;
  // the plain chain's finish, one rounding an op: mean = sum * factor,
  // var = max(E[x^2] - mean * mean, 0), r = rsqrt(var + eps), a = r * w
#pragma unroll
  for (int j = 0; j < OVS; ++j) {
    const int c = out + j;
    const float mean = __fmul_rn(s[j], q.factor);
    const float d = __fsub_rn(__fmul_rn(sq[j], q.factor), __fmul_rn(mean, mean));
    const float var = d < 0.f ? 0.f : d;
    const float r = rsqrtf(__fadd_rn(var, eps));
    coef[c] = mean;
    coef[q.C + c] = r;
    coef[2 * q.C + c] = __fmul_rn(r, w[c]);
    coef[3 * q.C + c] = d >= 0.f ? 1.f : 0.f;
    pending[c] = __fadd_rn(__fmul_rn(keep, rmean[c]), __fmul_rn(momentum, mean));
    pending[q.C + c] = __fadd_rn(__fmul_rn(keep, rvar[c]), __fmul_rn(momentum, var));
  }
}

// Forward 2: y = ((x - m) * a) + b, rounded op by op as the plain chain
// rounds it, the block's rows from its last down.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_train_apply_kernel(const T* __restrict__ x, T* __restrict__ y, Plan p,
                      const float* __restrict__ coef, const float* __restrict__ b) {
  const Place<V> s = place<V>(p, gridDim.x - 1 - blockIdx.x);
  if (!s.on) return;
  float m[V], a[V], sh[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    m[k] = coef[s.c0 + k];
    a[k] = coef[2 * p.C + s.c0 + k];
    sh[k] = b[s.c0 + k];
  }
  const long long step = (long long)p.lanes * kUnroll;
  for (long long r = s.r1 - 1 - s.lane; r >= s.r0; r -= step) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = r - (long long)u * p.lanes;
      if (rr >= s.r0) Vec<T, V>::load(x + rr * p.C + s.c0, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = r - (long long)u * p.lanes;
      if (rr >= s.r0) {
#pragma unroll
        for (int k = 0; k < V; ++k)
          v[u][k] = __fadd_rn(__fmul_rn(__fsub_rn(v[u][k], m[k]), a[k]), sh[k]);
        Vec<T, V>::store(y + rr * p.C + s.c0, v[u]);
      }
    }
  }
}

// Backward 1: per-channel sum g and sum g (x - m); the last block writes
// grads [4][C]: grad_w, grad_b, and dx's coefficients k0 = -a sg / R and
// k1 = 2 dv / R.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_train_grad_reduce_kernel(const T* __restrict__ g, const T* __restrict__ x, Plan p,
                            const float* __restrict__ w, const float* __restrict__ coef,
                            double* __restrict__ ws, unsigned* __restrict__ counters,
                            float* __restrict__ grads) {
  __shared__ double red[2][kThreads * V];
  const Place<V> s = place<V>(p, blockIdx.x);
  float a0[V], a1[V];
#pragma unroll
  for (int k = 0; k < V; ++k) a0[k] = a1[k] = 0.f;
  if (s.on) {
    float m[V];
#pragma unroll
    for (int k = 0; k < V; ++k) m[k] = coef[s.c0 + k];
    const long long step = (long long)p.lanes * kUnroll;
    for (long long r = s.r0 + s.lane; r < s.r1; r += step) {
      float gv[kUnroll][V], xv[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long rr = r + (long long)u * p.lanes;
        if (rr < s.r1) {
          Vec<T, V>::load(g + rr * p.C + s.c0, gv[u]);
          Vec<T, V>::load(x + rr * p.C + s.c0, xv[u]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) gv[u][k] = xv[u][k] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long rr = r + (long long)u * p.lanes;
        if (rr < s.r1) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            a0[k] += gv[u][k];
            a1[k] = fmaf(gv[u][k], xv[u][k] - m[k], a1[k]);
          }
        }
      }
    }
  }
  if (!block_sums<V>(p, s, a0, a1, ws, counters, red)) return;
  const int cb = blockIdx.y * p.cols * V;
  const int K = min(p.cols * V, p.C - cb);
  const double n = (double)p.rows;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const int c = cb + i;
    const double sg = red[1][i], sgx = red[1][K + i];
    const double r = coef[p.C + c], a = coef[2 * p.C + c];
    const double dv = coef[3 * p.C + c] != 0.f ? sgx * (double)w[c] * -0.5 * r * r * r : 0.0;
    grads[c] = (float)(sgx * r);
    grads[p.C + c] = (float)sg;
    grads[2 * p.C + c] = (float)(-a * sg / n);
    grads[3 * p.C + c] = (float)(2.0 * dv / n);
  }
}

// Backward 2: dx = fma(g, a, fma(k1, x - m, k0)), the block's rows from its
// last down.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_train_grad_input_kernel(const T* __restrict__ g, const T* __restrict__ x,
                           T* __restrict__ dx, Plan p, const float* __restrict__ coef,
                           const float* __restrict__ grads) {
  const Place<V> s = place<V>(p, gridDim.x - 1 - blockIdx.x);
  if (!s.on) return;
  float m[V], a[V], k0[V], k1[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    m[k] = coef[s.c0 + k];
    a[k] = coef[2 * p.C + s.c0 + k];
    k0[k] = grads[2 * p.C + s.c0 + k];
    k1[k] = grads[3 * p.C + s.c0 + k];
  }
  const long long step = (long long)p.lanes * kUnroll;
  for (long long r = s.r1 - 1 - s.lane; r >= s.r0; r -= step) {
    float gv[kUnroll][V], xv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = r - (long long)u * p.lanes;
      if (rr >= s.r0) {
        Vec<T, V>::load(g + rr * p.C + s.c0, gv[u]);
        Vec<T, V>::load(x + rr * p.C + s.c0, xv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = r - (long long)u * p.lanes;
      if (rr >= s.r0) {
#pragma unroll
        for (int k = 0; k < V; ++k)
          gv[u][k] = fmaf(gv[u][k], a[k], fmaf(k1[k], xv[u][k] - m[k], k0[k]));
        Vec<T, V>::store(dx + rr * p.C + s.c0, gv[u]);
      }
    }
  }
}

bool plan_ok(const Plan& p, int vec, int grid_x, int grid_y) {
  return p.rows > 0 && p.C > 0 && p.C % vec == 0 && p.cols >= 1 &&
         p.cols * vec <= kChunkChannels && p.lanes >= 1 && grid_x >= 1 && grid_y >= 1 &&
         p.rows_per_block >= 1 && (long long)grid_x * p.rows_per_block >= p.rows &&
         (long long)grid_y * p.cols * vec >= p.C;
}

template <typename T, int OVS, int V>
int forward_shape(const void* x, void* y, const Plan& p, dim3 grid, const StatsPlan& q,
                  dim3 sgrid, const float* w, const float* b, const float* rmean,
                  const float* rvar, float keep, float momentum, float eps, float* staging,
                  unsigned* counters, float* coef, float* pending, cudaStream_t s) {
  bn_train_stats_kernel<T, OVS><<<sgrid, dim3(q.bw, q.bh), 0, s>>>(
      static_cast<const T*>(x), q, w, rmean, rvar, keep, momentum, eps, staging, counters, coef,
      pending);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_train_apply_kernel<T, V><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x),
                                                         static_cast<T*>(y), p, coef, b);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int forward_ovs(int ovs, const void* x, void* y, const Plan& p, dim3 grid, const StatsPlan& q,
                dim3 sgrid, const float* w, const float* b, const float* rmean,
                const float* rvar, float keep, float momentum, float eps, float* staging,
                unsigned* counters, float* coef, float* pending, cudaStream_t s) {
  if (ovs == 4)
    return forward_shape<T, 4, V>(x, y, p, grid, q, sgrid, w, b, rmean, rvar, keep, momentum,
                                  eps, staging, counters, coef, pending, s);
  if (ovs == 2)
    return forward_shape<T, 2, V>(x, y, p, grid, q, sgrid, w, b, rmean, rvar, keep, momentum,
                                  eps, staging, counters, coef, pending, s);
  if (ovs == 1)
    return forward_shape<T, 1, V>(x, y, p, grid, q, sgrid, w, b, rmean, rvar, keep, momentum,
                                  eps, staging, counters, coef, pending, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int V>
int backward_shape(const void* g, const void* x, void* dx, const Plan& p, dim3 grid,
                   const float* w, const float* coef, double* ws, unsigned* counters,
                   float* grads, cudaStream_t s) {
  bn_train_grad_reduce_kernel<T, V><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), p, w, coef, ws, counters, grads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dx == nullptr) return 0;
  bn_train_grad_input_kernel<T, V><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<T*>(dx), p, coef, grads);
  return (int)cudaGetLastError();
}

}  // namespace

// Training-mode BatchNorm forward over x (rows, C), NHWC-contiguous on the
// stream's device and aligned to vec and to ovs elements: dtype 0 float32,
// 1 bfloat16.
// The statistics launch follows `sp` (StatsPlan's integers: step_input, bw,
// bh, out_mult1, in_mult1, in_mult2, step_output, grid_x, ctas) with ovs
// channels a thread and `factor`; the normalisation launch the grid
// (grid_x row chunks of rows_per_block rows, grid_y column chunks of `cols`
// vectors) at vec channels a thread (4 or 8 when C % vec == 0, else 1).
// Writes y (as x), coef [4][C] and pending [2][C] float32. w, b, rmean,
// rvar: C float32 each; staging: grid_x * ctas * bw * 2 * ovs floats of
// scratch; counters: zeroed unsigned ints, one a statistics block column,
// left zeroed. Returns the first CUDA error of the launches (0 on success).
extern "C" int bn_train_forward(int dtype, int vec, int ovs, const void* x, void* y,
                                long long rows, int C, int cols, long long rows_per_block,
                                int grid_x, int grid_y, const long long* sp, float factor,
                                const float* w, const float* b, const float* rmean,
                                const float* rvar, float keep, float momentum, float eps,
                                float* staging, unsigned* counters, float* coef, float* pending,
                                void* stream) {
  const Plan p{rows, rows_per_block, C, cols, cols > 0 ? kThreads / cols : 0};
  if (!plan_ok(p, vec, grid_x, grid_y)) return (int)cudaErrorInvalidValue;
  const StatsPlan q{rows, sp[0], C, (int)sp[1], (int)sp[2], (int)sp[3], (int)sp[4],
                    (int)sp[5], (int)sp[6], (int)sp[8], factor};
  if (q.bw < 1 || q.bh < 1 || q.bw * q.bh > kMaxStatsThreads || q.step_input < 1 ||
      sp[7] < 1 || q.ctas < 1 || C % ovs != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y), sgrid((unsigned)sp[7], q.ctas);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return forward_ovs<float, 4>(ovs, x, y, p, grid, q, sgrid, w, b, rmean, rvar, keep,
                                 momentum, eps, staging, counters, coef, pending, s);
  if (dtype == 0 && vec == 1)
    return forward_ovs<float, 1>(ovs, x, y, p, grid, q, sgrid, w, b, rmean, rvar, keep,
                                 momentum, eps, staging, counters, coef, pending, s);
  if (dtype == 1 && vec == 8)
    return forward_ovs<__nv_bfloat16, 8>(ovs, x, y, p, grid, q, sgrid, w, b, rmean, rvar, keep,
                                         momentum, eps, staging, counters, coef, pending, s);
  if (dtype == 1 && vec == 1)
    return forward_ovs<__nv_bfloat16, 1>(ovs, x, y, p, grid, q, sgrid, w, b, rmean, rvar, keep,
                                         momentum, eps, staging, counters, coef, pending, s);
  return (int)cudaErrorInvalidValue;
}

// Its backward: from g (as x), x, w and the forward's coef, writes grads
// [4][C] float32 (grad_w, grad_b, k0, k1) and dx (as x; nullptr: no input
// gradient, one launch). The same plan as the forward's arguments; ws and
// counters as there. Returns the first CUDA error (0 on success).
extern "C" int bn_train_backward(int dtype, int vec, const void* g, const void* x, void* dx,
                                 long long rows, int C, int cols, long long rows_per_block,
                                 int grid_x, int grid_y, const float* w, const float* coef,
                                 double* ws, unsigned* counters, float* grads, void* stream) {
  const Plan p{rows, rows_per_block, C, cols, cols > 0 ? kThreads / cols : 0};
  if (!plan_ok(p, vec, grid_x, grid_y)) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return backward_shape<float, 4>(g, x, dx, p, grid, w, coef, ws, counters, grads, s);
  if (dtype == 0 && vec == 1)
    return backward_shape<float, 1>(g, x, dx, p, grid, w, coef, ws, counters, grads, s);
  if (dtype == 1 && vec == 8)
    return backward_shape<__nv_bfloat16, 8>(g, x, dx, p, grid, w, coef, ws, counters, grads, s);
  if (dtype == 1 && vec == 1)
    return backward_shape<__nv_bfloat16, 1>(g, x, dx, p, grid, w, coef, ws, counters, grads, s);
  return (int)cudaErrorInvalidValue;
}
