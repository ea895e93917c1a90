// Greedy non-maximum suppression for NVIDIA Hopper (sm_90a): one block per
// problem, a keep mask out.
//
// Replaces no Pallas kernel. The JAX package computes NMS with XLA: the
// whole (n, n) IoU matrix, then a while_loop of masked passes to a fixed
// point (weakcube_tpu/ops/nms.py::nms_mask). Its plain PyTorch twin,
// weakcube_tpu_torch/ops/nms.py::nms_mask_plain, builds the (M, n, n)
// matrix of a batch of M problems and checks convergence on the host after
// every pass: one stream drain per pass. This kernel computes the same
// mask in one launch and no host sync, and never holds an IoU in device
// memory.
//
// What it computes: exactly greedy NMS over each problem's boxes in the
// rank order `order` (the stable descending score sort, made by the
// wrapper). A box is kept iff it is valid and no kept, higher-ranked box
// has IoU > thr with it; invalid boxes are never kept and suppress nothing.
// This is the fixed point the plain version converges to, and its only
// one. Write S(j, i) for "j ranks above i and IoU(j, i) > thr" and V for
// validity. A fixed point F satisfies F(i) = V(i) and not (some j with
// F(j) and S(j, i)). F(0) = V(0), as nothing ranks above rank 0; if F
// equals the greedy mask G on ranks below i, F(i) is computed from those
// ranks alone by the rule that defines G(i), so F(i) = G(i). By induction
// on rank, F = G. The plain version's t-th pass is right on ranks < t
// (the same induction), so it reaches G within n passes.
//
// Arithmetic, pair by pair, as ops/boxes.py::pairwise_iou and area round it
// in float32: w = max(x2 - x1, 0) and h alike, area = w * h; inter from
// the clamped min(x2) - max(x1) and min(y2) - max(y1); union = (area_a +
// area_b) - inter; iou = union > 0 ? inter / max(union, 1e-12) : 0, then
// iou > (float)thr. Each step is rounded on its own (__fsub_rn, __fmul_rn,
// __fadd_rn, __fdiv_rn): the shared nvcc flags leave FMA contraction on,
// and a fused w * h + area_b rounds once where PyTorch rounds twice.
// fmaxf and fminf equal torch.maximum, torch.minimum and clamp on numbers
// (up to the sign of a zero, which no comparison here sees) but drop a NaN
// where PyTorch keeps it. A NaN reaches a max, min or clamp only from a
// non-finite coordinate (a difference of finite numbers overflows to inf at
// worst; a later inf * 0 is NaN in both alike), and PyTorch gives such a
// box IoU 0 with every box: a NaN coordinate makes inter NaN; an x1 = x2 =
// +-inf makes its area NaN; a width of +inf makes its area inf or NaN, so
// that the union is inf (IoU 0) or NaN; a width of -inf clamps to 0 and so
// does its overlap with any box. So the kernel stores such a box's area as
// NaN: every pair with it gets union NaN (or inter 0) and IoU 0, as
// `where(union > 0, ...)` gives it. Two shortcuts give the same answer
// without the division: inter == 0 gives IoU 0 whatever the union; and
// inter - thr * union rounded once (fmaf) keeps the exact value's sign, so
// below 0 the quotient is below thr and so is its rounding (rounding is
// monotone and thr is a float32).
//
// Bound on the card: latency, not bytes. The kernel reads each problem's
// boxes (16 B), rank (8 B) and valid flag (1 B) once and writes the mask
// (1 B) once: 6.5 MB for M x n = 125 x 2000, 2 us at 3.35 TB/s. What sets
// its time is the greedy chain: n decisions, each depending on all before
// it. The design cuts the chain into n / 64 chunk steps of two block-wide
// barriers each and spends the parallel work between them.
//
// Design: a block of 512 threads per problem (M = 125, 40 or 8 blocks on
// the cells' calls: one wave on 132 SMs). The problem's boxes, gathered in
// rank order, and their areas sit in shared memory (20 B a box), beside a
// removed bitmask of one 64-bit word per chunk of 64 ranks (set at the
// start for invalid boxes and the ragged tail), the kept bits per chunk
// and one chunk's 64 x 64 suppression rows. For chunk c:
//   1. thread 0 scans the chunk in rank order: the lowest rank neither
//      removed nor decided is kept, and its row (the later boxes of the
//      chunk it suppresses) is or-ed into the chunk's removed word; only
//      kept boxes cost a step (__ffsll over what is left); it copies the
//      kept boxes into a list;
//   2. every thread takes later boxes (ranks from 64(c + 1) on, 32
//      consecutive ones a warp) that are still there and tests them
//      against the list, read as shared-memory broadcasts, stopping at the
//      first that suppresses; each warp ors its ballot into its own 32-bit
//      half-word of the removed mask (one writer per word: no atomics). In
//      the same stretch the threads compute chunk c + 1's 64 x 64 rows, 8
//      pairs a thread, one byte of a row each.
// With one block of 16 warps an SM, the tests' instruction count sets the
// pace of step 2 (on an H100, four tests in flight at once were no faster
// than one): a pair that does not overlap costs ~11 instructions, hence the
// plain fminf / fmaxf and the shortcuts above.
// IoU is computed only for (kept, later and still there) pairs and within
// chunks; nothing of size n^2 exists anywhere. Last, the block writes
// keep[order[r]] for every rank r, so the mask comes out in the original
// order and no scatter is needed.
//
// Limit: n <= kMaxN = 10240, whose 20 B a box (plus the masks and the
// list) fit the 227 KB of shared memory a block may take; above 48 KB the
// launch opts in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = 64;
constexpr int kMaxN = 10240;  // = ops/nms.py's MAX_N

// area = max(x2 - x1, 0) * max(y2 - y1, 0); NaN for a box with a
// non-finite coordinate (see the note: its IoU with any box is 0)
__device__ __forceinline__ float box_area(float4 b) {
  if (!(isfinite(b.x) && isfinite(b.y) && isfinite(b.z) && isfinite(b.w)))
    return __int_as_float(0x7fffffff);
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// IoU(a, b) > thr, rounded op for op as ops/boxes.py::pairwise_iou.
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b, float area_b,
                                           float thr) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  if (inter == 0.f) return 0.f > thr;
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  if (!(uni > 0.f)) return 0.f > thr;
  const float u = fmaxf(uni, 1e-12f);
  // inter - thr * u rounded once keeps its sign: below 0, inter / u < thr,
  // so its rounding is <= thr too and the division can be skipped
  if (fmaf(-thr, u, inter) < 0.f) return false;
  return __fdiv_rn(inter, u) > thr;
}

__host__ __device__ constexpr size_t smem_bytes(int n) {
  // boxes (16 n), the chunk's kept boxes (64 x 16), removed and kept words
  // (8 each per chunk), the chunk's rows (64 x 8), areas (4 n), the kept
  // boxes' areas (64 x 4), in that order (wider types first)
  return size_t(n) * 16 + kChunk * 16 + size_t((n + kChunk - 1) / kChunk) * 16 + kChunk * 8 +
         size_t(n) * 4 + kChunk * 4;
}

// The 64 x 64 rows of chunk c: byte `part` of row `row` holds whether box
// 64c + row suppresses boxes 64c + 8 part .. + 7 (later ranks only).
__device__ __forceinline__ void chunk_rows(const float4* sbox, const float* sarea,
                                           uint64_t* rows, int c, int n, float thr) {
  const int row = threadIdx.x >> 3, part = threadIdx.x & 7;
  const int a = c * kChunk + row;
  uint32_t byte = 0;
  if (a < n) {
    const float4 ba = sbox[a];
    const float aa = sarea[a];
    for (int k = 0; k < 8; ++k) {
      const int col = part * 8 + k, b = c * kChunk + col;
      if (col > row && b < n && suppresses(ba, aa, sbox[b], sarea[b], thr)) byte |= 1u << k;
    }
  }
  reinterpret_cast<uint8_t*>(rows)[row * 8 + part] = static_cast<uint8_t>(byte);
}

__global__ void __launch_bounds__(kThreads, 1)
nms_kernel(const float4* __restrict__ boxes, const long long* __restrict__ order,
           const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep, int n, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nchunks = (n + kChunk - 1) / kChunk;
  float4* sbox = reinterpret_cast<float4*>(smem);
  float4* kbox = sbox + n;  // the current chunk's kept boxes, in rank order
  uint64_t* removed = reinterpret_cast<uint64_t*>(kbox + kChunk);
  uint64_t* kept_bits = removed + nchunks;
  uint64_t* rows = kept_bits + nchunks;
  float* sarea = reinterpret_cast<float*>(rows + kChunk);
  float* karea = sarea + n;
  uint32_t* removed32 = reinterpret_cast<uint32_t*>(removed);
  __shared__ int n_kept;

  const long long base = static_cast<long long>(blockIdx.x) * n;
  boxes += base;
  order += base;
  valid += base;
  keep += base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // gather the boxes in rank order; invalid ranks and the tail past n
  // start removed
  for (int c = tid; c < nchunks; c += kThreads) removed[c] = ~0ull;
  __syncthreads();
  for (int w0 = warp * 32; w0 < n; w0 += kThreads) {
    const int r = w0 + lane;
    bool ok = false;
    if (r < n) {
      const long long o = order[r];
      const float4 b = boxes[o];
      sbox[r] = b;
      sarea[r] = box_area(b);
      ok = valid[o] != 0;
    }
    const uint32_t ballot = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) removed32[w0 >> 5] = ~ballot;
  }
  __syncthreads();
  chunk_rows(sbox, sarea, rows, 0, n, thr);
  __syncthreads();

  for (int c = 0; c < nchunks; ++c) {
    if (tid == 0) {  // 1. the chunk's own greedy scan
      uint64_t rem = removed[c], kept = 0, left = ~rem;
      int k = 0;
      while (left) {
        const int i = __ffsll(static_cast<long long>(left)) - 1;
        kept |= 1ull << i;
        rem |= rows[i];
        kbox[k] = sbox[c * kChunk + i];
        karea[k++] = sarea[c * kChunk + i];
        left = i == kChunk - 1 ? 0 : ~rem & (~0ull << (i + 1));
      }
      kept_bits[c] = kept;
      n_kept = k;
    }
    __syncthreads();
    // 2. the chunk's kept boxes remove later ones; chunk c + 1's rows
    const int nk = n_kept;
    if (c + 1 < nchunks) chunk_rows(sbox, sarea, rows, c + 1, n, thr);
    if (nk) {
      for (int w0 = (c + 1) * kChunk + warp * 32; w0 < n; w0 += kThreads) {
        const uint32_t word = removed32[w0 >> 5];
        if (word == 0xffffffffu) continue;  // warp-uniform
        bool hit = false;
        if (!((word >> lane) & 1u)) {  // lanes past n are marked removed
          const int j = w0 + lane;
          const float4 bj = sbox[j];
          const float aj = sarea[j];
          for (int k = 0; k < nk; ++k) {
            if (suppresses(kbox[k], karea[k], bj, aj, thr)) {
              hit = true;
              break;
            }
          }
        }
        const uint32_t ballot = __ballot_sync(0xffffffffu, hit);
        if (lane == 0 && ballot) removed32[w0 >> 5] = word | ballot;
      }
    }
    __syncthreads();
  }

  for (int r = tid; r < n; r += kThreads)
    keep[order[r]] = static_cast<uint8_t>((kept_bits[r / kChunk] >> (r % kChunk)) & 1ull);
}

}  // namespace

// keep (M, n) bool from boxes (M, n, 4) float32 (16-byte aligned), order
// (M, n) int64 (each row a permutation of 0..n-1, highest rank first) and
// valid (M, n) bool, all contiguous on the stream's device. Returns the
// launch's CUDA error (0 on success); nothing is launched for M * n == 0.
extern "C" int nms_forward(const void* boxes, const void* order, const void* valid, void* keep,
                           int M, int n, float thr, void* stream) {
  if (M < 0 || n < 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (M == 0 || n == 0) return 0;
  const size_t smem = smem_bytes(n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_kernel<<<M, kThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const long long*>(order),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), n, thr);
  return (int)cudaGetLastError();
}
