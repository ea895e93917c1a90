// Non-causal attention forward, softmax(q k^T * scale) v, for NVIDIA Hopper
// (sm_90a), on (B, H, N, 64) tensors.
//
// Replaces the TPU kernel behind weakcube_tpu/data/pseudo_gt/depth_anything_v2.py:37
// (_fused_sdpa), which calls JAX's pallas.ops.tpu.flash_attention with
// 512/768-wide blocks over a sequence padded to a block multiple and segment
// ids that mask the padded keys. Here there is no padding and there are no
// segment ids: the kernel runs at the real N (1370 tokens at the 518 px
// canon) and masks the ragged last key tile itself.
//
// Bound on the card: operations. Per (b, h) the two products take 4 N^2 d
// FLOPs against 4 N d elements moved (q, k, v read once, o written once), so
// at N = 1370, d = 64 the work is ~685 FLOPs per bf16 byte, above the H100's
// ~295: the tensor cores, not the memory, set the least time (B16 H16:
// 1.23e11 FLOP, 0.124 ms at 989 TFLOP/s). Besides, every score takes one
// exponential on the SFU (B H N^2 = 4.8e8 per call), of the same order as
// the products at d = 64.
//
// Design (FlashAttention-2 forward, kept simple): one block per (query tile
// of 64 rows, b * h), four warps of 16 query rows each. Q is staged once in
// shared memory and held as mma A-fragments; K and V tiles of 64 keys are
// staged in shared memory (rows padded to 72 elements, so the fragment loads
// are free of bank conflicts). S = Q K^T and O += P V run on the tensor
// cores with mma.sync.m16n8k16 (bf16 in, f32 accumulate); the online
// softmax (running max and sum) stays in f32 registers, with exp2f and the
// scale folded into log2(e). P is rounded to bf16 for the second product,
// reusing the S accumulators as A-fragments without a trip through shared
// memory. Keys >= N are masked to -inf before the max; query rows >= N are
// computed on zeros and not stored. The output tile goes back through shared
// memory so that each thread writes 16-byte vectors. The score matrix never
// leaves the chip. wgmma, TMA and warp specialisation are left to a later
// version.
//
// float32 inputs take a plain float32 path in this file (f32 FMA on the CUDA
// cores, no TF32): one thread per query row, keys streamed through shared
// memory, online softmax per key. It serves small float32 models checked
// against the CPU; the main path runs bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define HEAD_DIM 64

namespace {

constexpr int kD = HEAD_DIM;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kLD = kD + 8;    // padded shared-memory row, in elements
constexpr int kThreads = 128;  // four warps
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_raw(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  const uint32_t a = *reinterpret_cast<const unsigned short*>(lo);
  const uint32_t b = *reinterpret_cast<const unsigned short*>(hi);
  return a | (b << 16);
}

// D = A * B + D; A 16x16 row-major (4 regs), B 16x8 column-major (2 regs),
// D 16x8 f32 (4 regs). Lane l holds, with g = l / 4 and t = l % 4:
//   A: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B: b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   D: d0 d1 (g, 2t..2t+1), d2 d3 (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies rows [row0, row0 + 64) of a (N, 64) bf16 matrix into a padded
// shared tile, 16 bytes per thread and step; rows >= N become zeros.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int N) {
  for (int c = threadIdx.x; c < kBQ * kD / 8; c += kThreads) {
    const int r = c >> 3, col = (c & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < N)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * kD + col);
    *reinterpret_cast<uint4*>(dst + r * kLD + col) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int N,
               float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 Qs[kBQ * kLD];
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * kLD];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK * kLD];

  const long long base = (long long)blockIdx.y * N * kD;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // this warp's first row in the tile

  load_tile(Qs, q + base, q0, N);
  __syncthreads();
  uint32_t qa[4][4];  // A-fragments of this warp's 16 x 64 slice of Q
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ld_pair(&Qs[(wr + g) * kLD + c]);
    qa[kk][1] = ld_pair(&Qs[(wr + g + 8) * kLD + c]);
    qa[kk][2] = ld_pair(&Qs[(wr + g) * kLD + c + 8]);
    qa[kk][3] = ld_pair(&Qs[(wr + g + 8) * kLD + c + 8]);
  }

  float acc[8][4];  // O: 8 column tiles of 8 over d, rows g and g + 8
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};  // raw scores, rows g and g + 8
  float row_sum[2] = {0.f, 0.f};              // this thread's share of the sum

  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous K and V tiles
    load_tile(Ks, k + base, k0, N);
    load_tile(Vs, v + base, k0, N);
    __syncthreads();

    float s[8][4];  // S: 8 column tiles of 8 keys
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* kr = &Ks[(j * 8 + g) * kLD + kk * 16 + 2 * t];
        mma_bf16(s[j], qa[kk], ld_pair(kr), ld_pair(kr + 8));
      }
    }
    if (k0 + kBK > N) {  // the ragged last tile: keys >= N take no weight
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + 2 * t + (e & 1) >= N) s[j][e] = -INFINITY;
    }

    float mx[2] = {row_max[0], row_max[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the four lanes of a quad share rows
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // every tile holds a key < N, so mx is finite; the first tile's
    // correction is exp2(-inf) = 0
    float corr[2], mscaled[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      corr[r] = exp2f((row_max[r] - mx[r]) * scale_log2);
      row_max[r] = mx[r];
      mscaled[r] = mx[r] * scale_log2;
    }

    uint32_t pa[4][4];  // P as A-fragments over the tile's 64 keys
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(fmaf(s[j][0], scale_log2, -mscaled[0]));
      const float p1 = exp2f(fmaf(s[j][1], scale_log2, -mscaled[0]));
      const float p2 = exp2f(fmaf(s[j][2], scale_log2, -mscaled[1]));
      const float p3 = exp2f(fmaf(s[j][3], scale_log2, -mscaled[1]));
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    row_sum[0] = row_sum[0] * corr[0] + rs[0];
    row_sum[1] = row_sum[1] * corr[1] + rs[1];

#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* vr = &Vs[(kk * 16 + 2 * t) * kLD + n * 8 + g];
        mma_bf16(acc[n], pa[kk], pack_raw(vr, vr + kLD), pack_raw(vr + 8 * kLD, vr + 9 * kLD));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
    inv[r] = 1.f / row_sum[r];
  }
  // Qs is free: each warp read its fragments before the first K tile's barrier
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(&Qs[(wr + g) * kLD + c]) =
        pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(&Qs[(wr + g + 8) * kLD + c]) =
        pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kBQ * kD / 8; c += kThreads) {
    const int r = c >> 3, col = (c & 7) * 8;
    if (q0 + r < N)
      *reinterpret_cast<uint4*>(o + base + (long long)(q0 + r) * kD + col) =
          *reinterpret_cast<const uint4*>(&Qs[r * kLD + col]);
  }
}

constexpr int kF32Rows = 128;  // query rows (threads) per block
constexpr int kF32Keys = 32;   // keys per shared tile

__global__ void __launch_bounds__(kF32Rows)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int N, float scale_log2) {
  __shared__ __align__(16) float Ks[kF32Keys][kD];
  __shared__ __align__(16) float Vs[kF32Keys][kD];

  const long long base = (long long)blockIdx.y * N * kD;
  const int row = blockIdx.x * kF32Rows + threadIdx.x;
  const bool live = row < N;
  float qr[kD], acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) qr[d] = acc[d] = 0.f;
  if (live) {
#pragma unroll
    for (int d = 0; d < kD; ++d) qr[d] = q[base + (long long)row * kD + d];
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += kF32Keys) {
    const int nk = min(kF32Keys, N - k0);
    __syncthreads();
    for (int c = threadIdx.x; c < nk * kD; c += kF32Rows) {
      Ks[c / kD][c % kD] = k[base + (long long)k0 * kD + c];
      Vs[c / kD][c % kD] = v[base + (long long)k0 * kD + c];
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) s = fmaf(qr[d], Ks[j][d], s);
      const float mn = fmaxf(m, s);
      const float corr = exp2f((m - mn) * scale_log2);
      const float p = exp2f((s - mn) * scale_log2);
      l = l * corr + p;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] = fmaf(p, Vs[j][d], acc[d] * corr);
      m = mn;
    }
  }
  if (live) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < kD; d += 4)
      *reinterpret_cast<float4*>(o + base + (long long)row * kD + d) =
          make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes by ops/flash_attention_cuda.py.
//   dtype: 0 float32, 1 bfloat16. q, k, v, o: contiguous (BH, N, head_dim)
//   with head_dim 64, 16-byte aligned. Launches on `stream` without
//   synchronising; returns the CUDA error code of the launch.
extern "C" int flash_attention_forward(int dtype, const void* q, const void* k, const void* v,
                                       void* o, int BH, int N, int head_dim, float scale,
                                       void* stream) {
  if (head_dim != HEAD_DIM || N < 1 || BH < 1 || BH > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * kLog2e;
  if (dtype == 1) {
    dim3 grid((N + kBQ - 1) / kBQ, BH);
    flash_fwd_bf16<<<grid, kThreads, 0, s>>>(
        reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(k),
        reinterpret_cast<const __nv_bfloat16*>(v), reinterpret_cast<__nv_bfloat16*>(o), N,
        scale_log2);
  } else if (dtype == 0) {
    dim3 grid((N + kF32Rows - 1) / kF32Rows, BH);
    flash_fwd_f32<<<grid, kF32Rows, 0, s>>>(
        reinterpret_cast<const float*>(q), reinterpret_cast<const float*>(k),
        reinterpret_cast<const float*>(v), reinterpret_cast<float*>(o), N, scale_log2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
