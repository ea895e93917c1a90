// Non-causal attention forward, softmax(q k^T * scale) v, for NVIDIA Hopper
// (sm_90a), on (B, H, N, 64) tensors given by their strides.
//
// Replaces the TPU kernel behind weakcube_tpu/data/pseudo_gt/depth_anything_v2.py:37
// (_fused_sdpa), which calls JAX's pallas.ops.tpu.flash_attention with
// 512/768-wide blocks over a sequence padded to a block multiple and segment
// ids that mask the padded keys. Here there is no padding and there are no
// segment ids: the kernel runs at the real N (1370 tokens at the 518 px
// canon) and masks the ragged last key tile itself.
//
// What bounds it on the card. Per (b, h) the two products take 4 N^2 d FLOPs
// against 4 N d elements moved (q, k, v read once, o written once): at
// N = 1370, d = 64 that is ~685 FLOPs per bf16 byte, above the H100's ~295,
// so the tensor cores and not the memory set the least time (B16 H16:
// 1.23e11 FLOP, 0.124 ms at 989 TFLOP/s). Beside them every score takes one
// exponential on the SFU: B H N^2 = 4.8e8 per call at 16 ex2 per clock per
// SM is ~0.11 ms, as long as the products. Run one after the other the two
// can get no closer than ~0.24 ms; the design overlaps them.
//
// Design (bf16), FlashAttention-3's forward in plain CUDA:
// - Persistent blocks, one per SM, each of four warpgroups. Work tiles of
//   192 query rows of one (b, h) are dealt out to the blocks in turn.
//   Warpgroup 0 is the producer: one thread of it issues every load.
//   Warpgroups 1-3 are consumers of 64 query rows each. setmaxnreg moves
//   registers from the producer (32) to the consumers (160). Three
//   consumers, FlashAttention-3's choice at d = 64, ran faster on the card
//   than two (128-row tiles), though at N = 1370 the last 192-row tile
//   holds only 26 queries: a third warpgroup gives the SFU and the tensor
//   cores one more stream of work to interleave.
// - Staging route: TMA (cp.async.bulk.tensor) with mbarrier completion. q,
//   k and v are each described by a 4-D tensor map over (d, N, H, B) built
//   from the caller's strides, so the views that the encoder's fused qkv
//   projection leaves, (B, N, 3, H, 64) memory seen as (B, H, N, 64), are
//   read in place with no copy. The maps use the 128-byte swizzle (one
//   d = 64 bf16 row is exactly 128 bytes), which is the layout the wgmma
//   descriptors below read. Rows past N come in as zeros (TMA's
//   out-of-bounds fill). The tensor-map encoder, cuTensorMapEncodeTiled, is
//   reached through cudaGetDriverEntryPoint, so the library needs no
//   -lcuda.
// - Q is double-buffered and K and V tiles of 128 keys stream through a
//   ring of two stages, each with its own full and empty barriers; the ring
//   runs on from one work tile to the next, so the next tile's loads
//   overlap this tile's last product and its output.
// - S = Q K^T runs on wgmma.m64n128k16 with Q and K from shared memory
//   (both K-major). O += P V runs on wgmma.m64n64k16 with P from registers:
//   the S accumulators of two adjacent 8-key columns are exactly the
//   A-fragment of a 16-key step, so P is rounded to bf16 in place. V is read
//   as it lies, keys x d, which is MN-major for the B operand: the
//   instruction's transpose bit takes it without an explicit transpose.
// - Overlap of exponentials and products, both of FA3's ways: within a
//   warpgroup, key tile j's S product is issued together with tile j-1's
//   P V product, and the softmax of tile j runs while P V computes; between
//   the consumer warpgroups, named barriers hand the tensor cores from one
//   to the next in turn, so one warpgroup's softmax runs under the others'
//   products.
// - The online softmax stays in f32 registers (ex2 with the scale folded
//   into log2(e)); keys >= N score -inf in the last key tile only; O is
//   rescaled only when a row's maximum moved. O is f32 in registers and is
//   written through shared memory (swizzled, 16-byte vectors) with rows
//   >= N left out.
// - What holds it back on the card is the softmax (its exponentials on the
//   SFU and its issue slots), not the loads: in development runs a variant
//   that skipped the loads was no faster, one that skipped the softmax much
//   faster (PERF.md).
//
// float32 inputs take a plain float32 path in this file (f32 FMA on the CUDA
// cores, no TF32): one thread per query row, keys streamed through shared
// memory, online softmax per key. It serves small float32 models checked
// against the CPU; the main path runs bf16.
//
// A decomposed relative-position bias (ViT-det's, SAM's image encoder):
// softmax(q k^T * scale + bias_h[n, j / kw] + bias_w[n, j % kw]) v, with
// float32 bias_h (B, H, N, kh) and bias_w (B, H, N, kw), N = kh * kw. It is
// a compile-time choice: the unbiased launches run the kernels above under
// their own names (flash_fwd_bf16, flash_fwd_f32), the biased ones the same
// bodies instantiated with the bias, flash_fwd_relpos_bf16 and
// flash_fwd_relpos_f32. The bias is added in float32 to the float32 scores
// before the running maximum, and no (N, N) tensor exists anywhere: in the
// bf16 kernel each consumer warp copies the bias rows of its own 16 query
// rows (kh + kw floats each, times log2(e)) into shared memory at the start
// of a work tile, and the softmax reads them there, bias_w as one 8-byte
// pair per two adjacent keys (kw even, so a pair never straddles two rows of
// the key grid). The rows lie RelStride() floats apart, 8 banks mod 32, so
// that the pairs of a half-warp's 16 lanes (4 rows, 4 key pairs) fall in 32
// distinct banks; bias_h starts 4 floats later in rows 4-7 of each 8 for the
// same reason. At kh + kw = 128 (SAM's global blocks at 1024 px) the rows
// take 102 KB beside the 112 KB of tiles and rings.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define HEAD_DIM 64

namespace {

constexpr int kD = HEAD_DIM;
constexpr float kLog2e = 1.4426950408889634f;

// ---- bf16 kernel: tiles, ring, barriers ---------------------------------
constexpr int kConsumers = 3;                   // consumer warpgroups, 64 query rows each
constexpr int kBQ = 64 * kConsumers;            // query rows per block
constexpr int kBK = 128;                        // keys per tile
constexpr int kStages = 2;                      // K/V ring depth
constexpr int kThreads = 128 * (1 + kConsumers);  // the producer warpgroup first
// registers per thread after setmaxnreg: the producer gives up what it can
// (32 x 128 + 160 x 384 = 65,536)
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;
constexpr int kQBytes = kBQ * kD * 2;           // one Q tile
constexpr int kTileBytes = kBK * kD * 2;        // one K or V tile, 16 KB
constexpr int kSmemTiles = 2 * kQBytes + 2 * kStages * kTileBytes;  // 2 Q tiles, K and V rings
constexpr int kNumBars = 4 + 4 * kStages;       // full/empty Q (2 each), full/empty K/V
constexpr int kSmemBytes = kSmemTiles + 8 * kNumBars + 1024;  // + 1024-byte alignment
constexpr int kSchedBar = 1;                    // named barriers 1..: tensor-core turns
constexpr int kEpiBar = 1 + kConsumers;         // then one per warpgroup for its epilogue
constexpr int kMaxRelStride = 136;              // floats per bias row in shared memory, at most
constexpr int kRelRows = 16 * 4 * kConsumers;   // bias rows staged: 16 per consumer warp

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// One box (a Q, K or V tile) of a 4-D (d, N, H, B) tensor map into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(h),
         "r"(b) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// wgmma shared-memory descriptor for a tile of 128-byte rows in the 128-byte
// swizzle (layout type 1): start address, leading and stride byte offsets in
// 16-byte units. Every use here has 8-row groups 1024 bytes apart (SBO). The
// leading offset is not used by these shapes (a K-major k16 step lies within
// one 128-byte row; the MN-major V tile is one 64-element swizzle atom wide),
// so it is set to 1024 bytes, the value either reading of it would need.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence/wait instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// d (64 x 128, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 128, smem,
// K-major). d[4j .. 4j+3] hold columns 8j + 2t, 8j + 2t + 1 of rows g and
// g + 8 of this warp's 16 rows (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major:
// transpose bit set). A's four registers per thread are the mma.m16n8k16
// A-fragment: (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..).
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the SFU, subnormal results flushed to zero (a probability below
// 2^-126 is zero after the bf16 rounding of P anyway; exp2f would add a
// subnormal fix-up around each one).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&h);
}

// S = Q K^T for one key tile: four k16 steps over d, the first one
// overwriting S.
__device__ __forceinline__ void qk_tile(float* s, uint32_t q_addr, uint32_t k_addr) {
  fence_regs<64>(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_qk(s, smem_desc(q_addr + kk * 32), smem_desc(k_addr + kk * 32), kk > 0);
  wgmma_commit();
}

// O += P V for one key tile: eight k16 steps over the keys, V's rows 16 at a
// time (16 x 128 bytes).
__device__ __forceinline__ void pv_tile(float* acc, uint32_t* pa, uint32_t v_addr) {
  fence_regs<32>(acc);
  fence_regs<32>(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_pv(acc, pa + 4 * kk, smem_desc(v_addr + kk * 16 * 128));
  wgmma_commit();
}

// Hands a stage back to the producer: one arrival per warp.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// O *= corr, row by row; skipped while no row of the warp has a new maximum
// (corr is then exactly 1), which after the first few tiles is most tiles.
__device__ __forceinline__ void rescale(float* acc, const float* corr) {
  if (__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[4 * j] *= corr[0];
    acc[4 * j + 1] *= corr[0];
    acc[4 * j + 2] *= corr[1];
    acc[4 * j + 3] *= corr[1];
  }
}

// This thread's bias rows in shared memory, for the softmax of a biased
// launch: bias_w of row g at w[0 .. kw), of row g + 8 at w[off8 ..); bias_h
// of row g at h[0 .. kh), of row g + 8 at h[off8 ..). Scaled by log2(e).
struct RelRows {
  const float* w;
  const float* h;
  int off8, kh, kw;
};

// Online softmax of the key tile at k0 (rows g and g + 8 of the warp's 16),
// in place: S becomes
// exp2(S * scale_log2 - running max), the running max and this thread's
// share of the row sums move on, and corr is the factor that carries the
// earlier tiles' O over to the new max. With the bias, S first becomes
// S * scale_log2 + (bias_h + bias_w) * log2(e), and the rest runs on that
// at scale 1.
template <bool kBias>
__device__ __forceinline__ void online_softmax(float* s, float* row_max, float* row_sum,
                                               float* corr, int k0, int N, int t,
                                               float scale_log2, const RelRows& rel) {
  if constexpr (kBias) {
    // key c = k0 + 8 j + 2 t (+ 1) lies at (c / kw, c % kw) of the key grid
    int c = k0 + 2 * t;
    int ih = c / rel.kw, iw = c - ih * rel.kw;
    const bool ragged = k0 + kBK > N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int ihc = min(ih, rel.kh - 1);  // keys >= N are masked below
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 bw = *reinterpret_cast<const float2*>(rel.w + r * rel.off8 + iw);
        const float bh = rel.h[r * rel.off8 + ihc];
        s[4 * j + 2 * r] = fmaf(s[4 * j + 2 * r], scale_log2, bh + bw.x);
        s[4 * j + 2 * r + 1] = fmaf(s[4 * j + 2 * r + 1], scale_log2, bh + bw.y);
      }
      if (ragged) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + (e & 1) >= N) s[4 * j + e] = -INFINITY;
      }
      c += 8;
      iw += 8;
      while (iw >= rel.kw) {
        iw -= rel.kw;
        ++ih;
      }
    }
  } else if (k0 + kBK > N) {  // the ragged last tile: keys >= N take no weight
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + j * 8 + 2 * t + (e & 1) >= N) s[4 * j + e] = -INFINITY;
  }
  const float sl = kBias ? 1.f : scale_log2;
  // four independent chains per row keep the dependent steps short
  float m4[2][4] = {{row_max[0], -INFINITY, -INFINITY, -INFINITY},
                    {row_max[1], -INFINITY, -INFINITY, -INFINITY}};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    m4[0][j & 3] = fmaxf(m4[0][j & 3], fmaxf(s[4 * j], s[4 * j + 1]));
    m4[1][j & 3] = fmaxf(m4[1][j & 3], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the four lanes of a quad share rows
    mx[r] = fmaxf(fmaxf(m4[r][0], m4[r][1]), fmaxf(m4[r][2], m4[r][3]));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  // every tile holds a key < N, so mx is finite; the first tile's
  // correction is exp2(-inf) = 0
  float msc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    corr[r] = ex2((row_max[r] - mx[r]) * sl);
    row_max[r] = mx[r];
    msc[r] = mx[r] * sl;
  }
  float rs[2][4] = {};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = ex2(fmaf(s[i], sl, -msc[(i >> 1) & 1]));
    rs[(i >> 1) & 1][(i >> 2) & 3] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    row_sum[r] = row_sum[r] * corr[r] + ((rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]));
}

// The P accumulators of key columns 16kk .. 16kk + 15 as the A-fragment of
// the kk-th k16 step of P V.
__device__ __forceinline__ void pack_p(uint32_t* pa, const float* s) {
#pragma unroll
  for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

struct OutLayout {
  long long sb, sh, sn;  // strides in elements; the last dimension is contiguous
};

// A launch's relative-position bias: bias_h (B, H, N, kh) and bias_w (B, H,
// N, kw) float32 by their (B, H, N) strides in elements, the last dimension
// contiguous; `stride` floats per row staged in shared memory.
struct RelPos {
  const float* h;
  const float* w;
  long long hb, hh, hn, wb, wh, wn;
  int kh, kw, stride;
};

template <bool kBias>
__device__ __forceinline__ void flash_fwd_bf16_body(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    __nv_bfloat16* __restrict__ o, const OutLayout& ol, int H, int N, int n_work,
    float scale_log2, const RelPos& rp) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t sq = raw + pad;                      // 2 Q tiles of kBQ rows
  const uint32_t sk = sq + 2 * kQBytes;               // K ring
  const uint32_t sv = sk + kStages * kTileBytes;      // V ring
  const uint32_t bars = sq + kSmemTiles;
  auto full_q = [&](int i) { return bars + 8u * i; };
  auto empty_q = [&](int i) { return bars + 8u * (2 + i); };
  auto full_k = [&](int s) { return bars + 8u * (4 + s); };
  auto full_v = [&](int s) { return bars + 8u * (4 + kStages + s); };
  auto empty_k = [&](int s) { return bars + 8u * (4 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8u * (4 + 3 * kStages + s); };

  const int n_qt = (N + kBQ - 1) / kBQ;    // query tiles per (b, h)
  const int n_tiles = (N + kBK - 1) / kBK;  // key tiles
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(full_q(i), 1);
      mbar_init(empty_q(i), 4 * kConsumers);  // one arrival from each consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 4 * kConsumers);
      mbar_init(empty_v(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Work tiles (kBQ query rows of one (b, h)) are dealt out in turn to the
  // resident blocks; the i-th tile of a block uses Q buffer i % 2, and the
  // K/V ring runs on across tiles, so the next tile's loads overlap this
  // tile's last product and its output.
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int kv = 0;
      for (int w = blockIdx.x, i = 0; w < n_work; w += gridDim.x, ++i) {
        const int bh = w / n_qt, b = bh / H, h = bh % H;
        const int qb = i & 1;
        mbar_wait(empty_q(qb), ((i >> 1) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full_q(qb), kQBytes);
        tma_load(sq + qb * kQBytes, &tq, full_q(qb), (w % n_qt) * kBQ, h, b);
        for (int it = 0; it < n_tiles; ++it, ++kv) {
          const int s = kv % kStages;
          const uint32_t parity = ((kv / kStages) & 1) ^ 1;
          mbar_wait(empty_k(s), parity);
          mbar_expect_tx(full_k(s), kTileBytes);
          tma_load(sk + s * kTileBytes, &tk, full_k(s), it * kBK, h, b);
          mbar_wait(empty_v(s), parity);
          mbar_expect_tx(full_v(s), kTileBytes);
          tma_load(sv + s * kTileBytes, &tv, full_v(s), it * kBK, h, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int cw = wg - 1;
    const int wtid = threadIdx.x & 127;
    const int warp = wtid >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;

    float s[64];      // S, then P in f32: 16 column tiles of 8 keys
    float acc[32];    // O: 8 column tiles of 8 over d
    uint32_t pa[32];  // P in bf16 as 8 A-fragments of 16 keys
    float row_max[2], row_sum[2], corr[2];  // rows g and g + 8; sums are this thread's share
    // with the bias: this warp's 16 rows of it in shared memory, and this
    // thread's two (struct RelRows)
    float* rel_warp = reinterpret_cast<float*>(smem + kSmemTiles + 8 * kNumBars) +
                      (cw * 4 + warp) * 16 * rp.stride;
    const RelRows rel = {rel_warp + g * rp.stride,
                         rel_warp + g * rp.stride + rp.kw + ((g >> 2) & 1) * 4, 8 * rp.stride,
                         rp.kh, rp.kw};

    const int next = cw + 1 < kConsumers ? cw + 1 : 0;  // who takes the tensor cores after us
    if (cw == 0) named_arrive(kSchedBar, 256);  // the first turn is warpgroup 1's
    int kv = 0;
    for (int w = blockIdx.x, i = 0; w < n_work; w += gridDim.x, ++i) {
      const int bh = w / n_qt, b = bh / H, h = bh % H;
      const int q0 = (w % n_qt) * kBQ;
      const int qb = i & 1;
      const uint32_t my_q = sq + qb * kQBytes + cw * (kQBytes / kConsumers);
      // the next warpgroup's turn after each tile's products (the last
      // warpgroup's very last hand-over would have no taker: skipping it
      // leaves every barrier balanced at exit)
      const bool last_work = w + (int)gridDim.x >= n_work;
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0.f;
      row_max[0] = row_max[1] = -INFINITY;
      row_sum[0] = row_sum[1] = 0.f;
      if constexpr (kBias) {
        // the bias rows of this warp's 16 query rows (rows >= N repeat row
        // N - 1; their outputs are not written), times log2(e)
        const int row0 = q0 + cw * 64 + warp * 16;
        const float* gh = rp.h + b * rp.hb + h * rp.hh;
        const float* gw = rp.w + b * rp.wb + h * rp.wh;
        __syncwarp();  // every lane is done with the last work tile's rows
        for (int idx = lane; idx < 16 * rp.kw; idx += 32) {
          const int r = idx / rp.kw, col = idx - r * rp.kw;
          rel_warp[r * rp.stride + col] = gw[min(row0 + r, N - 1) * rp.wn + col] * kLog2e;
        }
        for (int idx = lane; idx < 16 * rp.kh; idx += 32) {
          const int r = idx / rp.kh, col = idx - r * rp.kh;
          rel_warp[r * rp.stride + rp.kw + ((r >> 2) & 1) * 4 + col] =
              gh[min(row0 + r, N - 1) * rp.hn + col] * kLog2e;
        }
        __syncwarp();
      }
      mbar_wait(full_q(qb), (i >> 1) & 1);

      // key tile 0: S alone
      {
        const int sc = kv % kStages;
        mbar_wait(full_k(sc), (kv / kStages) & 1);
        named_sync(kSchedBar + cw, 256);
        qk_tile(s, my_q, sk + sc * kTileBytes);
        if (next || n_tiles > 1 || !last_work) named_arrive(kSchedBar + next, 256);
        wgmma_wait<0>();
        fence_regs<64>(s);
        release(empty_k(sc), lane);
        online_softmax<kBias>(s, row_max, row_sum, corr, 0, N, t, scale_log2, rel);
        pack_p(pa, s);
      }
      // key tile it's S is issued together with tile it - 1's P V, and its
      // softmax runs while P V computes
      for (int it = 1; it < n_tiles; ++it) {
        const int sc = (kv + it) % kStages, sp = (kv + it - 1) % kStages;
        mbar_wait(full_k(sc), ((kv + it) / kStages) & 1);
        named_sync(kSchedBar + cw, 256);
        qk_tile(s, my_q, sk + sc * kTileBytes);
        rescale(acc, corr);
        mbar_wait(full_v(sp), ((kv + it - 1) / kStages) & 1);
        pv_tile(acc, pa, sv + sp * kTileBytes);
        if (next || it + 1 < n_tiles || !last_work) named_arrive(kSchedBar + next, 256);
        wgmma_wait<1>();
        fence_regs<64>(s);
        release(empty_k(sc), lane);
        online_softmax<kBias>(s, row_max, row_sum, corr, it * kBK, N, t, scale_log2, rel);
        wgmma_wait<0>();
        fence_regs<32>(acc);
        release(empty_v(sp), lane);
        pack_p(pa, s);
      }
      // the last key tile's P V
      kv += n_tiles;
      const int sl = (kv - 1) % kStages;
      rescale(acc, corr);
      mbar_wait(full_v(sl), ((kv - 1) / kStages) & 1);
      pv_tile(acc, pa, sv + sl * kTileBytes);
      wgmma_wait<0>();
      fence_regs<32>(acc);
      release(empty_v(sl), lane);

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
        row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
        inv[r] = 1.f / row_sum[r];
      }
      // This warpgroup's 64 rows of the Q tile are free (its last S product
      // has completed): O goes there in the 128-byte swizzle, 16-byte chunk c of
      // row r at chunk c ^ (r % 8), so neither the stores nor the loads
      // below conflict on banks.
      unsigned char* stage = smem + qb * kQBytes + cw * (kQBytes / kConsumers);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r0 = warp * 16 + g, r1 = r0 + 8;
        *reinterpret_cast<uint32_t*>(stage + r0 * 128 + ((j ^ (r0 & 7)) << 4) + t * 4) =
            pack_bf16(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
        *reinterpret_cast<uint32_t*>(stage + r1 * 128 + ((j ^ (r1 & 7)) << 4) + t * 4) =
            pack_bf16(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
      }
      named_sync(kEpiBar + cw, 128);
      __nv_bfloat16* ob = o + b * ol.sb + h * ol.sh;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = wtid + 128 * j;
        const int r = idx >> 3, c = idx & 7;
        const int row = q0 + cw * 64 + r;
        if (row < N)
          *reinterpret_cast<uint4*>(ob + row * ol.sn + c * 8) =
              *reinterpret_cast<const uint4*>(stage + r * 128 + ((c ^ (r & 7)) << 4));
      }
      // the buffer goes back to TMA (the async proxy) for a later Q tile
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      release(empty_q(qb), lane);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
               OutLayout ol, int H, int N, int n_work, float scale_log2) {
  flash_fwd_bf16_body<false>(tq, tk, tv, o, ol, H, N, n_work, scale_log2, RelPos{});
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_relpos_bf16(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                      OutLayout ol, int H, int N, int n_work, float scale_log2,
                      const __grid_constant__ RelPos rp) {
  flash_fwd_bf16_body<true>(tq, tk, tv, o, ol, H, N, n_work, scale_log2, rp);
}

// ---- float32 path -----------------------------------------------------------
constexpr int kF32Rows = 128;  // query rows (threads) per block
constexpr int kF32Keys = 32;   // keys per shared tile

struct F32Layout {
  long long sb[4], sh[4], sn[4];  // q, k, v, o strides in elements
};

// With the bias the row's score of key j is s * scale_log2 + (bias_h[j /
// kw] + bias_w[j % kw]) * log2(e), and the softmax runs at scale 1.
template <bool kBias>
__device__ __forceinline__ void flash_fwd_f32_body(const float* __restrict__ q,
                                                   const float* __restrict__ k,
                                                   const float* __restrict__ v,
                                                   float* __restrict__ o, const F32Layout& L,
                                                   int H, int N, float scale_log2,
                                                   const RelPos& rp) {
  __shared__ __align__(16) float Ks[kF32Keys][kD];
  __shared__ __align__(16) float Vs[kF32Keys][kD];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const float* qb = q + b * L.sb[0] + h * L.sh[0];
  const float* kb = k + b * L.sb[1] + h * L.sh[1];
  const float* vb = v + b * L.sb[2] + h * L.sh[2];
  const int row = blockIdx.x * kF32Rows + threadIdx.x;
  const bool live = row < N;
  float qr[kD], acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) qr[d] = acc[d] = 0.f;
  if (live) {
#pragma unroll
    for (int d = 0; d < kD; ++d) qr[d] = qb[row * L.sn[0] + d];
  }
  float m = -INFINITY, l = 0.f;
  const float sl = kBias ? 1.f : scale_log2;
  const float* bh = nullptr;
  const float* bw = nullptr;
  int ih = 0, iw = 0;  // key j's place in the key grid
  if constexpr (kBias) {
    const int r = min(row, N - 1);
    bh = rp.h + b * rp.hb + h * rp.hh + r * rp.hn;
    bw = rp.w + b * rp.wb + h * rp.wh + r * rp.wn;
  }

  for (int k0 = 0; k0 < N; k0 += kF32Keys) {
    const int nk = min(kF32Keys, N - k0);
    __syncthreads();
    for (int c = threadIdx.x; c < nk * kD; c += kF32Rows) {
      const int r = c / kD, d = c % kD;
      Ks[r][d] = kb[(k0 + r) * L.sn[1] + d];
      Vs[r][d] = vb[(k0 + r) * L.sn[2] + d];
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) s = fmaf(qr[d], Ks[j][d], s);
      if constexpr (kBias) {
        s = fmaf(s, scale_log2, (bh[ih] + bw[iw]) * kLog2e);
        if (++iw == rp.kw) {
          iw = 0;
          ++ih;
        }
      }
      const float mn = fmaxf(m, s);
      const float corr = exp2f((m - mn) * sl);
      const float p = exp2f((s - mn) * sl);
      l = l * corr + p;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] = fmaf(p, Vs[j][d], acc[d] * corr);
      m = mn;
    }
  }
  if (live) {
    const float inv = 1.f / l;
    float* orow = o + b * L.sb[3] + h * L.sh[3] + row * L.sn[3];
#pragma unroll
    for (int d = 0; d < kD; d += 4)
      *reinterpret_cast<float4*>(orow + d) =
          make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
  }
}

__global__ void __launch_bounds__(kF32Rows)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, F32Layout L, int H, int N,
              float scale_log2) {
  flash_fwd_f32_body<false>(q, k, v, o, L, H, N, scale_log2, RelPos{});
}

__global__ void __launch_bounds__(kF32Rows)
flash_fwd_relpos_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, F32Layout L, int H,
                     int N, float scale_log2, RelPos rp) {
  flash_fwd_f32_body<true>(q, k, v, o, L, H, N, scale_log2, rp);
}

// ---- host side -------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D (d, N, H, B) bf16 map with boxes of `rows` rows in the 128-byte
// swizzle; rows past N read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int B, int H, int N, long long sb,
              long long sh, long long sn) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sn * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kD, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The floats per staged bias row: the least S >= kw + kh + 4 with S = 8
// (mod 32) (the header's bank layout).
int rel_stride(int kh, int kw) {
  const int s = kw + kh + 4;
  return s + (8 - s % 32 + 32) % 32;
}

int launch(int dtype, const void* q, const void* k, const void* v, void* o, int B, int H, int N,
           int head_dim, const long long* strides, float scale, const RelPos* rp,
           cudaStream_t st) {
  if (head_dim != HEAD_DIM || N < 1 || B < 1 || H < 1 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  const int elt = dtype == 1 ? 2 : 4;
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return (int)cudaErrorInvalidValue;
    for (int j = 0; j < 3; ++j)
      if ((strides[3 * i + j] * elt) % 16) return (int)cudaErrorInvalidValue;
  }
  const float scale_log2 = scale * kLog2e;
  if (dtype == 1) {
    CUtensorMap maps[3];
    for (int i = 0; i < 3; ++i)
      if (!make_map(&maps[i], ptrs[i], i ? kBK : kBQ, B, H, N, strides[3 * i], strides[3 * i + 1],
                    strides[3 * i + 2]))
        return (int)cudaErrorNotSupported;
    const int smem = kSmemBytes + (rp ? kRelRows * rp->stride * 4 : 0);
    cudaError_t err = rp ? cudaFuncSetAttribute(flash_fwd_relpos_bf16,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
                         : cudaFuncSetAttribute(flash_fwd_bf16,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const OutLayout ol = {strides[9], strides[10], strides[11]};
    int dev = 0, n_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    const int n_work = (N + kBQ - 1) / kBQ * B * H;  // one block per SM walks over these
    const int grid = n_work < n_sm ? n_work : n_sm;
    __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(o);
    if (rp)
      flash_fwd_relpos_bf16<<<grid, kThreads, smem, st>>>(maps[0], maps[1], maps[2], ob, ol, H,
                                                          N, n_work, scale_log2, *rp);
    else
      flash_fwd_bf16<<<grid, kThreads, smem, st>>>(maps[0], maps[1], maps[2], ob, ol, H, N,
                                                   n_work, scale_log2);
  } else if (dtype == 0) {
    F32Layout L;
    for (int i = 0; i < 4; ++i) {
      L.sb[i] = strides[3 * i];
      L.sh[i] = strides[3 * i + 1];
      L.sn[i] = strides[3 * i + 2];
    }
    dim3 grid((N + kF32Rows - 1) / kF32Rows, B * H);
    const float* qf = reinterpret_cast<const float*>(q);
    const float* kf = reinterpret_cast<const float*>(k);
    const float* vf = reinterpret_cast<const float*>(v);
    float* of = reinterpret_cast<float*>(o);
    if (rp)
      flash_fwd_relpos_f32<<<grid, kF32Rows, 0, st>>>(qf, kf, vf, of, L, H, N, scale_log2, *rp);
    else
      flash_fwd_f32<<<grid, kF32Rows, 0, st>>>(qf, kf, vf, of, L, H, N, scale_log2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes by ops/flash_attention_cuda.py.
//   dtype: 0 float32, 1 bfloat16. q, k, v, o: (B, H, N, head_dim) with
//   head_dim 64, each given by its base pointer and its strides in elements,
//   strides[3 * i + 0, 1, 2] = (B, H, N) strides of q, k, v, o (i = 0..3).
//   The last dimension is contiguous; base pointers and strides are 16-byte
//   aligned. Launches on `stream` without synchronising; returns the CUDA
//   error code of the launch.
extern "C" int flash_attention_forward(int dtype, const void* q, const void* k, const void* v,
                                       void* o, int B, int H, int N, int head_dim,
                                       const long long* strides, float scale, void* stream) {
  return launch(dtype, q, k, v, o, B, H, N, head_dim, strides, scale, nullptr,
                reinterpret_cast<cudaStream_t>(stream));
}

// The same with the decomposed relative-position bias: bias_h (B, H, N, kh)
// and bias_w (B, H, N, kw) float32, N = kh * kw, kw even, kh + kw <= 132,
// their last dimension contiguous; bias_strides[0..2] the (B, H, N) strides
// of bias_h, [3..5] those of bias_w, in elements.
extern "C" int flash_attention_relpos_forward(int dtype, const void* q, const void* k,
                                              const void* v, void* o, int B, int H, int N,
                                              int head_dim, const long long* strides,
                                              float scale, const void* bias_h,
                                              const void* bias_w, int kh, int kw,
                                              const long long* bias_strides, void* stream) {
  if (kh < 1 || kw < 2 || kw % 2 || (long long)kh * kw != N ||
      rel_stride(kh, kw) > kMaxRelStride || bias_h == nullptr || bias_w == nullptr)
    return (int)cudaErrorInvalidValue;
  const RelPos rp = {reinterpret_cast<const float*>(bias_h),
                     reinterpret_cast<const float*>(bias_w),
                     bias_strides[0], bias_strides[1], bias_strides[2],
                     bias_strides[3], bias_strides[4], bias_strides[5],
                     kh, kw, rel_stride(kh, kw)};
  return launch(dtype, q, k, v, o, B, H, N, head_dim, strides, scale, &rp,
                reinterpret_cast<cudaStream_t>(stream));
}
