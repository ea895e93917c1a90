// Bilinear resize with align_corners=True on channels_last tensors, for
// NVIDIA Hopper (sm_90a): the DPT head's only resize mode.
//
// Replaces no TPU kernel. The JAX package's `_resize`
// (weakcube_tpu/data/pseudo_gt/depth_anything_v2.py:235-260) is two XLA
// matrix products with static align_corners interpolation matrices; no
// Pallas. The port's head called F.interpolate(x, size, mode="bilinear",
// align_corners=True), which on a channels_last CUDA tensor runs ATen's
// upsample_bilinear2d_nhwc_out_frame: one thread per output element, four
// integer divisions and modulos to recover (n, h, w, c), both source indices
// and all four weights computed again for every channel, four 2-byte loads
// and one 2-byte store. At the head's shapes (ViT-L, 518 px, b16: 1.03 G
// output elements a forward) that is ~9.7 ms on an H100, bound by
// instructions, not by bytes.
//
// What it computes: ATen's value of every output element, bit for bit. With
// rh = (float)(H_in - 1) / (H_out - 1) (0 where H_out = 1; the wrapper's, in
// float32), output row h2 reads source rows h1 = (int)(rh * h2) and h1 + h1p,
// h1p = h1 < H_in - 1, with weights l1 = rh * h2 - h1 and l0 = 1 - l1; the
// same for columns. Then, in float32,
//   out = lh0 * (lw0 * a + lw1 * b) + lh1 * (lw0 * c + lw1 * d)
// rounded once to the output's dtype (bf16: to nearest even). ATen's source
// writes that expression and nvcc contracts each sum of two products into
// one FMA, the other product rounded first; which product it fuses differs
// between ATen's instantiations. Their sm_90 code in torch 2.11 (cuobjdump
// -sass of libtorch_cuda.so; the card tests hold it): bf16 fuses the first
// product of both rows and of the outer sum; float32 the second of the top
// row (lw1 * b) and the first of the bottom row and of the outer sum. The
// weights are not contracted there: src = rh * h2 is rounded (it goes
// through a select between the two align_corners branches), l1 = src - h1
// is then exact. The shared nvcc flags leave contraction on, so every step
// here is written out (__fmul_rn, __fsub_rn, __fmaf_rn) in that order, per
// dtype (`blend`). Another torch build may contract otherwise:
// tests/test_torch_cuda.py -k resize and chip_smoke phase 34 would show it.
//
// Bound on the card: bytes. Each input element read once and each output
// element written once: 2.65 GB a b16 forward at the head's five shapes
// (19^2 -> 37^2, 37 -> 74, 74 -> 148, 148 -> 296 at C = 256 and 296 -> 518
// at C = 128, bf16), 0.79 ms at 3.35 TB/s; the writes are 2.05 GB of it.
//
// Design: consecutive threads own one output pixel's channel run, each one
// 16-byte vector (8 bf16 or 4 float32 channels; narrower where C, the input's
// pointer or its pixel strides allow no more: the wrapper's `vec_width`), so
// a warp moves 512 contiguous bytes (C = 256 bf16 is one warp a pixel) and
// loads and stores coalesce. A thread computes its column's two source
// columns and weights once and its row's once, not once per channel. A
// block covers a run of one output row; blocks in launch order walk the
// output row by row, so neighbouring output rows, which read the same one or
// two input rows, run close together and find those rows in L2. The
// output is written once and never read here; the input's four taps per
// pixel are L1 and L2 hits after their first read.
//
// Takes any (N, C, H, W) whose channels are contiguous (stride 1), with any
// pixel strides, in bf16 or float32, into a dense channels_last output; the
// wrapper keeps N * H_out, W_out * C and every dimension within int.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

// a dtype's storage, its conversions to and from float32, and ATen's
// rounding of lh0 * (lw0 * a + lw1 * b) + lh1 * (lw0 * c + lw1 * d) in it
struct Bf16 {
  using S = unsigned short;
  __device__ __forceinline__ static float in(S s) { return __uint_as_float((unsigned)s << 16); }
  __device__ __forceinline__ static S out(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
  __device__ __forceinline__ static float blend(float lh0, float lh1, float lw0, float lw1,
                                                float a, float b, float c, float d) {
    const float top = __fmaf_rn(lw0, a, __fmul_rn(lw1, b));
    const float bot = __fmaf_rn(lw0, c, __fmul_rn(lw1, d));
    return __fmaf_rn(lh0, top, __fmul_rn(lh1, bot));
  }
};
struct F32 {
  using S = float;
  __device__ __forceinline__ static float in(S s) { return s; }
  __device__ __forceinline__ static S out(float f) { return f; }
  __device__ __forceinline__ static float blend(float lh0, float lh1, float lw0, float lw1,
                                                float a, float b, float c, float d) {
    const float top = __fmaf_rn(lw1, b, __fmul_rn(lw0, a));
    const float bot = __fmaf_rn(lw0, c, __fmul_rn(lw1, d));
    return __fmaf_rn(lh0, top, __fmul_rn(lh1, bot));
  }
};

template <int Bytes> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<2> { using type = unsigned short; };

// V values as one access of V * sizeof(S) bytes
template <typename S, int V>
union Vec {
  typename Word<sizeof(S) * V>::type word;
  S v[V];
};

template <typename S, int V>
__device__ __forceinline__ Vec<S, V> load(const S* p) {
  Vec<S, V> r;
  r.word = *reinterpret_cast<const typename Word<sizeof(S) * V>::type*>(p);
  return r;
}

// a destination index's two source indices and weights, as ATen rounds
// them: src = r * dst, i0 = (int)src, l1 = src - i0, l0 = 1 - l1
struct Tap {
  int i0, i1;
  float l0, l1;
};

__device__ __forceinline__ Tap tap(float r, int dst, int n_in) {
  const float src = __fmul_rn(r, (float)dst);
  Tap t;
  t.i0 = (int)src;
  t.i1 = t.i0 + (t.i0 < n_in - 1 ? 1 : 0);
  t.l1 = __fsub_rn(src, (float)t.i0);
  t.l0 = __fsub_rn(1.f, t.l1);
  return t;
}

// grid (ceil(W_out * C / V / kThreads), min(N * H_out, kMaxGridY)): block
// (x, y) takes a run of output row y (n * H_out + h2), then row y +
// gridDim.y, ...; thread j of the run takes pixel w2 = j / (C / V),
// channels c .. c + V - 1
template <typename D, int V>
__global__ void __launch_bounds__(kThreads) bilinear_resize_kernel(
    const typename D::S* __restrict__ x, typename D::S* __restrict__ y, int C, int Hi, int Wi,
    int Ho, int Wo, long long sn, long long sh, long long sw, float rh, float rw, int rows) {
  using S = typename D::S;
  const int cv = C / V;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= Wo * cv) return;
  const int w2 = j / cv;
  const int c = (j - w2 * cv) * V;
  const Tap tw = tap(rw, w2, Wi);
  const long long col0 = tw.i0 * sw + c, col1 = tw.i1 * sw + c;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int n = row / Ho;
    const int h2 = row - n * Ho;
    const Tap th = tap(rh, h2, Hi);
    const S* r0 = x + n * sn + th.i0 * sh;
    const S* r1 = x + n * sn + th.i1 * sh;
    const Vec<S, V> a = load<S, V>(r0 + col0), b = load<S, V>(r0 + col1);
    const Vec<S, V> cc = load<S, V>(r1 + col0), d = load<S, V>(r1 + col1);
    Vec<S, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k)
      o.v[k] = D::out(D::blend(th.l0, th.l1, tw.l0, tw.l1, D::in(a.v[k]), D::in(b.v[k]),
                               D::in(cc.v[k]), D::in(d.v[k])));
    *reinterpret_cast<typename Word<sizeof(S) * V>::type*>(
        y + ((long long)row * Wo + w2) * C + c) = o.word;
  }
}

template <typename D, int V>
cudaError_t launch(const void* x, void* y, int B, int C, int Hi, int Wi, int Ho, int Wo,
                   long long sn, long long sh, long long sw, float rh, float rw,
                   cudaStream_t stream) {
  using S = typename D::S;
  const int rows = B * Ho;
  const long long per_row = (long long)Wo * (C / V);
  const dim3 grid((unsigned)((per_row + kThreads - 1) / kThreads),
                  rows < kMaxGridY ? rows : kMaxGridY);
  bilinear_resize_kernel<D, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const S*>(x), static_cast<S*>(y), C, Hi, Wi, Ho, Wo, sn, sh, sw, rh, rw, rows);
  return cudaGetLastError();
}

}  // namespace

// One launch on `stream`: x (B, C, Hi, Wi) with channel stride 1 and pixel
// strides (sn, sh, sw) in elements, into the dense channels_last y (B, C, Ho,
// Wo); bf16 (bf16 = 1) or float32 (0), `vec` channels a thread (bf16: 8, 4, 2
// or 1; float32: 4, 2 or 1), which divides C, sn, sh and sw, x aligned to
// vec elements. B, C >= 1; every size >= 1. Returns the launch's CUDA error
// (0 on success).
extern "C" int bilinear_resize_forward(int bf16, int vec, const void* x, void* y, int B, int C,
                                       int Hi, int Wi, int Ho, int Wo, long long sn,
                                       long long sh, long long sw, float rh, float rw,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    switch (vec) {
      case 8: return launch<Bf16, 8>(x, y, B, C, Hi, Wi, Ho, Wo, sn, sh, sw, rh, rw, s);
      case 4: return launch<Bf16, 4>(x, y, B, C, Hi, Wi, Ho, Wo, sn, sh, sw, rh, rw, s);
      case 2: return launch<Bf16, 2>(x, y, B, C, Hi, Wi, Ho, Wo, sn, sh, sw, rh, rw, s);
      case 1: return launch<Bf16, 1>(x, y, B, C, Hi, Wi, Ho, Wo, sn, sh, sw, rh, rw, s);
    }
  } else {
    switch (vec) {
      case 4: return launch<F32, 4>(x, y, B, C, Hi, Wi, Ho, Wo, sn, sh, sw, rh, rw, s);
      case 2: return launch<F32, 2>(x, y, B, C, Hi, Wi, Ho, Wo, sn, sh, sw, rh, rw, s);
      case 1: return launch<F32, 1>(x, y, B, C, Hi, Wi, Ho, Wo, sn, sh, sw, rh, rw, s);
    }
  }
  return cudaErrorInvalidValue;
}
