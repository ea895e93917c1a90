// Multi-level ROIAlignV2 forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel weakcube_tpu/ops/roi_align_pallas.py
// (_roi_align_kernel, launched by roi_align_pallas_single and batched by
// multilevel_roi_align_pallas). It computes what the exact gather version
// weakcube_tpu/ops/roi_align.py::multilevel_roi_align computes, not the
// Pallas kernel's approximation: there is no fixed window, no 8-row snapping
// and no bf16 staging of float32 input.
//
// Semantics, per RoI:
//   * level = floor(4 + log2(sqrt(w * h) / 224 + 1e-8)), clamped to the
//     pyramid's levels;
//   * an aligned (-0.5) grid of sampling_ratio x sampling_ratio samples per
//     bin, roi_w and roi_h at least 1e-6;
//   * sample coordinates clamp to [0, size - 1] (not torchvision's zero
//     beyond [-1, size]); bilinear interpolation; each bin is the mean of
//     its samples.
//
// Bound on the card: bytes. The work is ~10-20 float32 FMAs per output
// value, far below the H100's ~295 operations per byte. At b8, R=1000,
// C=256 in bf16 the least DRAM traffic is the pixels the RoIs touch (their
// union, at most the 89 MB pyramid) read once plus the 201 MB output
// written once: 87 us for the whole pyramid at 3.35 TB/s, 82 us for the
// touched pixels of the detection forward's proposals. Beside it, the
// staging below moves each RoI's window from L2 into shared memory once:
// the sum over RoIs of ny * nx * C * 2 bytes, 0.28 GB for those proposals
// against the 3.2 GB of corner reads that a per-sample gather makes
// (ops/roi_align_cuda.py::footprint counts both from the boxes;
// chip_smoke.py prints them).
//
// Diagnosis of the previous design (one block per RoI, threads over
// channels, each output value gathered from 16 bilinear corners straight
// from global memory; chip_smoke.py's K1 timings on an H100, see PERF.md):
// its time fell only 3% when every corner read was a cache hit (sub-pixel
// RoIs at one spot), so instruction issue and load latency set it, not L2
// bytes: 16 dependent 4-byte gathers per 2 channels, with per-lane weights
// and 64-bit addresses.
//
// Design:
//   * Plan once per RoI. Threads 0..2P-1 (P = out_size * sampling_ratio)
//     place the samples of both axes with the reference's rounding
//     (__fmul_rn / __fsub_rn / __fdiv_rn / __fadd_rn, no FMA contraction,
//     which keeps float32 within ~1e-6 of the plain version). Per axis the
//     block stages the compact run of lines from the lowest to the highest
//     touched line when it holds at most 2P lines (and no bin spans more
//     than 2 * sr of them), else the 2P touched lines themselves: an
//     elongated RoI costs no more than 2P x 2P pixels. Either way a bin's
//     lines are one run of at most 2 * sr staged lines; the plan holds their
//     offset and their summed weights (the 1/sr of the bin mean folded in,
//     as the TPU kernel folds it into its weight rows), and 32-bit element
//     offsets of the staged lines.
//   * Stage by cp.async. A pixel's channels are contiguous in NHWC, so a
//     channel chunk of the window is a set of 16-byte copies (cp.async.cg,
//     L1 bypassed) into a pixel-major tile. Channels are cut into even
//     chunks so that one stage (24 KB, more for large out_size * sr) holds
//     the whole window. A window that would keep fewer than 4 vectors per
//     pixel in one stage (above 384 pixels; real-size RoIs on p3-p5 hold
//     225-784) takes both stages as one chunk, so that it needs a third as
//     many chunks and its contraction keeps the threads busy; its copies
//     are not staged ahead, and the SM's other blocks cover them (p3-p5
//     squares on an H100: 0.60 -> 0.49 ms per launch). cp.async rather
//     than TMA: the window's size and its lines change per RoI and a
//     tensor map fixes its box; cp.async.bulk would need a copy per pixel
//     and chunk, as small as 16 bytes.
//   * Persistent and pipelined. The grid is what fits on the card (4 blocks
//     of 128 threads per SM); a block walks RoIs b * R + r with a stride of
//     the grid, one chunk after another, and issues the copies of the next
//     chunk (of this RoI or, after its plan is built into the second table
//     set, of the next RoI, whose box was loaded a RoI ahead) before it
//     contracts the current one from the other stage, unless either chunk
//     takes both stages.
//   * Contract separably from shared memory. A thread owns one bin and two
//     vectors of 8 bf16 (or 4 float32) channels: for each of the bin's
//     staged rows it sums the bin's staged columns with the x weights, then
//     adds the row with its y weight; float32 FMA on the CUDA cores (bf16
//     weights would break the float32 tolerance). Every shared-memory read
//     and every output write is a 16-byte vector, and a warp's stores cover
//     whole runs of a bin's channels. For these RoIs a bin spans 2-3 lines
//     per axis, so a bin reads ~6 staged vectors per 8 channels, not 16.
//   * out_size and sampling_ratio are compile-time for the main path's
//     (7, 2) (constant bin and sample divisions; the generic instantiation
//     took 7-8% longer on the box pooler on an H100); one generic
//     instantiation serves the others. A scalar-width instantiation of the
//     same kernel serves C that is not a multiple of the vector width, or
//     misaligned pointers (its staging is plain loads and stores).
//   * Tried on the card and not kept (see PERF.md): band loops unrolled
//     to 2 * sr with guards or switched on the band's length, one block per
//     RoI, 64-, 256- and 512-thread blocks, smaller and larger stages, one
//     vector or four per thread, and one thread per row or column of bins
//     (fewer loads, where a row's x pass serves two bins, but too few
//     threads per chunk). Time without the arithmetic, without the copies
//     and without the stores showed the contraction's instruction issue as
//     the largest part, the staging next; the stores hide under both.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define MAX_LEVELS 8
#define MAX_SAMPLES 40  // out_size * sampling_ratio
#define MAX_LINES (2 * MAX_SAMPLES)
#define THREADS 128
#define BLOCKS_PER_SM 4
#define MIN_STAGE_BYTES (24 * 1024)
#define MAX_STAGE_BYTES (112 * 1024)

struct Pyramid {
  const void* ptr[MAX_LEVELS];
  long long batch_stride[MAX_LEVELS];  // elements between images
  int height[MAX_LEVELS];
  int width[MAX_LEVELS];
  float scale[MAX_LEVELS];             // 1 / stride
  int n_levels;
  int min_level;
};

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// q / d for 0 <= q < 2^24 and d >= 1: a float-reciprocal estimate, off by
// at most one, corrected once (cheaper than an integer division by a
// runtime divisor).
__device__ __forceinline__ int div_small(int q, int d, float rcp_d) {
  int r = (int)((float)q * rcp_d);
  const int rem = q - r * d;
  r += (rem >= d) - (rem < 0);
  return r;
}

// One RoI's plan: block-uniform scalars in registers, per-line and per-bin
// tables in shared memory. A block holds two table sets, so that the next
// RoI's plan is built while the last chunk of this one is in flight.
template <typename T>
struct Plan {
  const T* base;  // the RoI's image at its level
  int ny, nx;     // staged lines per axis
  int cv;         // channel vectors per pixel in a chunk
  int n_chunks;
  bool whole;     // a chunk takes both stages (and is not staged ahead)
};

struct PlanTables {
  int line[2][MAX_LINES];     // element offset of each staged line (0: rows, 1: columns)
  int2 band[2][MAX_SAMPLES];  // per bin: byte offset in the tile of its first staged
                              // line, and the number of its lines
  float wband[2][MAX_LINES];  // per bin: the 2 * sr weights of those lines
};

struct PlanScratch {
  int lo[2][MAX_SAMPLES], hi[2][MAX_SAMPLES];
  float frac[2][MAX_SAMPLES];
};

__device__ __forceinline__ float4 load_box(const float* boxes, int roi) {
  const float* p = boxes + (long long)roi * 4;
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// All threads of the block call it (it synchronises).
template <typename T, int V>
__device__ Plan<T> make_plan(const Pyramid& pyr, float4 box, int b, int out_size, int nsr,
                             int C, int stage_bytes, PlanScratch& sc, PlanTables& tb) {
  constexpr int VB = V * sizeof(T);  // bytes per channel vector
  const int P = out_size * nsr;

  // level assignment, as ops/roi_align.py::assign_fpn_levels
  const float w = fmaxf(box.z - box.x, 0.f);
  const float h = fmaxf(box.w - box.y, 0.f);
  const float lvlf = floorf(4.f + log2f(sqrtf(w * h) / 224.f + 1e-8f));
  const int lo_lvl = pyr.min_level, hi_lvl = pyr.min_level + pyr.n_levels - 1;
  const int lvl = (int)fminf(fmaxf(lvlf, (float)lo_lvl), (float)hi_lvl) - lo_lvl;
  const int H = pyr.height[lvl], W = pyr.width[lvl];

  // The sample lines of both axes. A bin's lines form one run of staged
  // lines either way (below); in the compact layout it must hold at most
  // 2 * sr lines, which the first sample of each bin checks against its
  // bin's last sample.
  bool wide = false;
  const int axis_t = threadIdx.x < P ? 0 : 1;  // 0: rows (y), 1: columns (x)
  if (threadIdx.x < 2 * P) {
    const int axis = axis_t, p = threadIdx.x - axis * P;
    const float scale = pyr.scale[lvl];
    // round each step as the reference does (no fused multiply-add)
    const float a1 = __fsub_rn(__fmul_rn(axis ? box.x : box.y, scale), 0.5f);
    const float a2 = __fsub_rn(__fmul_rn(axis ? box.z : box.w, scale), 0.5f);
    const float len = fmaxf(a2 - a1, 1e-6f);
    const int size = axis ? W : H;
    const float c = fminf(fmaxf(__fadd_rn(a1, __fmul_rn(len, __fdiv_rn((float)p + 0.5f, (float)P))),
                                0.f), (float)(size - 1));
    const float lo = floorf(c);
    sc.lo[axis][p] = (int)lo;
    sc.hi[axis][p] = min((int)lo + 1, size - 1);
    sc.frac[axis][p] = c - lo;
    if (p % nsr == 0) {
      const float last = fminf(fmaxf(__fadd_rn(a1, __fmul_rn(len, __fdiv_rn(
          (float)(p + nsr - 1) + 0.5f, (float)P))), 0.f), (float)(size - 1));
      wide = min((int)floorf(last) + 1, size - 1) - (int)lo + 1 > 2 * nsr;
    }
  }
  const bool wide_y = __syncthreads_or(wide && axis_t == 0);
  const bool wide_x = __syncthreads_or(wide && axis_t == 1);

  // Per axis: the compact run from the lowest to the highest touched line
  // (lines are non-decreasing in p, so lo[0] and hi[P - 1] bound it) if it
  // holds at most 2P lines and no bin spans more than 2 * sr of them; else
  // the 2P touched lines, lo and hi of each sample in turn.
  const int run_y = sc.hi[0][P - 1] - sc.lo[0][0] + 1, run_x = sc.hi[1][P - 1] - sc.lo[1][0] + 1;
  const bool rect_y = run_y <= 2 * P && !wide_y, rect_x = run_x <= 2 * P && !wide_x;
  Plan<T> pl;
  pl.base = reinterpret_cast<const T*>(pyr.ptr[lvl]) + (long long)b * pyr.batch_stride[lvl];
  pl.ny = rect_y ? run_y : 2 * P;
  pl.nx = rect_x ? run_x : 2 * P;
  const int nvec = C / V;
  pl.cv = min(nvec, stage_bytes / (pl.ny * pl.nx * VB));
  pl.whole = pl.cv < min(nvec, 4);
  if (pl.whole) pl.cv = min(nvec, 2 * stage_bytes / (pl.ny * pl.nx * VB));
  pl.n_chunks = (nvec + pl.cv - 1) / pl.cv;
  pl.cv = (nvec + pl.n_chunks - 1) / pl.n_chunks;  // even chunks
  const int pitch = pl.cv * VB;
  if (threadIdx.x < 2 * out_size) {
    // bin j of an axis: its run of staged lines and their summed weights,
    // the 1 / sr of the bin mean folded in
    const int axis = threadIdx.x < out_size ? 0 : 1;
    const int j = threadIdx.x - axis * out_size, p0 = j * nsr;
    const bool rect = axis ? rect_x : rect_y;
    const int base = sc.lo[axis][0];
    const int first = rect ? sc.lo[axis][p0] - base : 2 * p0;
    const int last = rect ? sc.hi[axis][p0 + nsr - 1] - base : 2 * p0 + 2 * nsr - 1;
    float* wb = tb.wband[axis] + 2 * p0;
    for (int k = 0; k < 2 * nsr; ++k) wb[k] = 0.f;
    for (int s = 0; s < nsr; ++s) {
      const int p = p0 + s;
      const float f = sc.frac[axis][p];
      wb[(rect ? sc.lo[axis][p] - base : 2 * p) - first] += (1.f - f) / (float)nsr;
      wb[(rect ? sc.hi[axis][p] - base : 2 * p + 1) - first] += f / (float)nsr;
    }
    tb.band[axis][j] = make_int2(first * (axis ? pitch : pl.nx * pitch), last - first + 1);
  }
  for (int t = threadIdx.x; t < pl.ny + pl.nx; t += THREADS) {
    const int axis = t < pl.ny ? 0 : 1;
    const int k = t - axis * pl.ny;
    const bool rect = axis ? rect_x : rect_y;
    const int line = rect ? sc.lo[axis][0] + k : ((k & 1) ? sc.hi[axis][k >> 1] : sc.lo[axis][k >> 1]);
    tb.line[axis][k] = line * (axis ? C : W * C);
  }
  __syncthreads();
  return pl;
}

// Issue the copies of chunk `ch` (its channel vectors of every staged
// pixel) into `stage`, pixel-major, cv vectors per pixel; one commit group.
template <typename T, int V>
__device__ __forceinline__ void stage_chunk(char* stage, const Plan<T>& pl, const PlanTables& tb,
                                            int ch, int nvec) {
  const int v0 = ch * pl.cv, cw = min(pl.cv, nvec - v0);
  const int total = pl.ny * pl.nx * cw;
  const float rcp_cw = 1.f / (float)cw, rcp_nx = 1.f / (float)pl.nx;
  for (int q = threadIdx.x; q < total; q += THREADS) {
    const int pix = div_small(q, cw, rcp_cw);
    const int v = q - pix * cw;
    const int k = div_small(pix, pl.nx, rcp_nx);
    const int m = pix - k * pl.nx;
    const T* src = pl.base + (tb.line[0][k] + tb.line[1][m] + (v0 + v) * V);
    char* dst = stage + (pix * pl.cv + v) * (int)(V * sizeof(T));
    if constexpr (V * sizeof(T) == 16) {
      cp_async16(dst, src);
    } else {
      *reinterpret_cast<T*>(dst) = *src;
    }
  }
  cp_async_commit();
}

// Contract chunk `ch` from `stage` into the RoI's output `obase`. A thread
// takes one bin and two channel vectors h apart (h = half the chunk's
// vectors; the second is dropped where the chunk has an odd count): two
// independent sums per load of the band's weights. For each of the bin's
// staged rows it sums the bin's staged columns with the x weights, then
// adds the row with its y weight.
template <typename T, int V>
__device__ __forceinline__ void contract(const char* stage, const Plan<T>& pl,
                                         const PlanTables& tb, T* obase, int ch, int nvec,
                                         int out_size, int nsr, int C) {
  constexpr int VB = V * sizeof(T);
  const int v0 = ch * pl.cv, cw = min(pl.cv, nvec - v0);
  const int pitch = pl.cv * VB, row_pitch = pl.nx * pitch;
  const int h = (cw + 1) >> 1;
  const float rcp_h = 1.f / (float)h;
  for (int t = threadIdx.x; t < out_size * out_size * h; t += THREADS) {
    const int bin = div_small(t, h, rcp_h);
    const int v = t - bin * h;
    const bool two = v + h < cw;
    const int off2 = two ? h * VB : 0;  // without a second vector, read the first twice
    const int i = bin / out_size, j = bin - (bin / out_size) * out_size;
    const int2 band_y = tb.band[0][i], band_x = tb.band[1][j];
    const float* wy = tb.wband[0] + 2 * nsr * i;
    const float* wx = tb.wband[1] + 2 * nsr * j;
    const char* tile = stage + v * VB + band_y.x + band_x.x;
    float acc0[V], acc1[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc0[e] = acc1[e] = 0.f;
    // runtime trip counts (a band is 1..2 * sr lines): loops unrolled to
    // 2 * sr with guards, or switched on the count, measured slower
#pragma unroll 1
    for (int ky = 0; ky < band_y.y; ++ky) {
      const char* row = tile + ky * row_pitch;
      float g0[V], g1[V];
#pragma unroll
      for (int e = 0; e < V; ++e) g0[e] = g1[e] = 0.f;
#pragma unroll 1
      for (int kx = 0; kx < band_x.y; ++kx) {
        float a[V], c[V];
        Vec<T, V>::load(row + kx * pitch, a);
        Vec<T, V>::load(row + kx * pitch + off2, c);
        const float wgt = wx[kx];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          g0[e] = fmaf(wgt, a[e], g0[e]);
          g1[e] = fmaf(wgt, c[e], g1[e]);
        }
      }
      const float wgt = wy[ky];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc0[e] = fmaf(wgt, g0[e], acc0[e]);
        acc1[e] = fmaf(wgt, g1[e], acc1[e]);
      }
    }
    T* o = obase + (long long)bin * C + (v0 + v) * V;
    Vec<T, V>::store(o, acc0);
    if (two) Vec<T, V>::store(o + h * V, acc1);
  }
}

// Persistent: block k takes RoIs k, k + gridDim.x, ... (RoI = b * R + r),
// one channel chunk after another, and stages the next chunk (of this RoI
// or the next) while it contracts the current one when both fit in one
// stage each.
// OUT, SR: out_size and sampling_ratio when known at compile time, else 0.
template <typename T, int V, int OUT, int SR>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
roi_align_kernel(Pyramid pyr, const float* __restrict__ boxes, T* __restrict__ out,
                 int n_rois, int R, int C, int out_size_rt, int sr_rt, int stage_bytes) {
  extern __shared__ __align__(128) char smem[];  // two stages of stage_bytes
  __shared__ PlanScratch sc;
  __shared__ PlanTables tb[2];
  const int out_size = OUT ? OUT : out_size_rt;
  const int nsr = SR ? SR : sr_rt;  // compile-time on the main path
  const int nvec = C / V;
  const long long roi_elems = (long long)out_size * out_size * C;

  int roi = blockIdx.x, ch = 0, buf = 0;
  char* stage = smem;
  Plan<T> cur = make_plan<T, V>(pyr, load_box(boxes, roi), roi / R, out_size, nsr, C,
                                stage_bytes, sc, tb[0]);
  int roi_next = roi + gridDim.x;
  float4 box_next = load_box(boxes, min(roi_next, n_rois - 1));  // arrives meanwhile
  stage_chunk<T, V>(stage, cur, tb[0], 0, nvec);
  while (true) {
    Plan<T> nxt = cur;
    int nroi = roi, nch = ch + 1, nbuf = buf;
    const bool new_roi = nch == cur.n_chunks;
    const bool has_next = !new_roi || roi_next < n_rois;
    if (new_roi && has_next) {
      nroi = roi_next;
      nch = 0;
      nbuf = buf ^ 1;
      nxt = make_plan<T, V>(pyr, box_next, nroi / R, out_size, nsr, C, stage_bytes, sc, tb[nbuf]);
      roi_next += gridDim.x;
      box_next = load_box(boxes, min(roi_next, n_rois - 1));
    }
    // the next chunk's copies run under this one's contraction when each
    // fits in one stage; a whole-arena chunk is staged after it
    const bool ahead = has_next && !cur.whole && !nxt.whole;
    char* nstage = ahead && stage == smem ? smem + stage_bytes : smem;
    if (ahead) {
      stage_chunk<T, V>(nstage, nxt, tb[nbuf], nch, nvec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    contract<T, V>(stage, cur, tb[buf], out + roi * roi_elems, ch, nvec, out_size, nsr, C);
    __syncthreads();  // the stage and the tables are refilled next
    if (!has_next) break;
    if (!ahead) stage_chunk<T, V>(nstage, nxt, tb[nbuf], nch, nvec);
    cur = nxt;
    roi = nroi;
    ch = nch;
    buf = nbuf;
    stage = nstage;
  }
}

template <typename T, int V, int OUT, int SR>
static int launch(const Pyramid& pyr, const float* boxes, void* out, int B, int R, int C,
                  int out_size, int sr, cudaStream_t stream) {
  const int P = out_size * sr;
  const int worst = 4 * P * P * V * (int)sizeof(T);  // 2P x 2P pixels, one vector each
  int stage = worst > MIN_STAGE_BYTES ? worst : MIN_STAGE_BYTES;
  stage = (stage + 127) / 128 * 128;
  if (stage > MAX_STAGE_BYTES) return (int)cudaErrorInvalidValue;
  auto kernel = roi_align_kernel<T, V, OUT, SR>;
  // the shared-memory opt-in and the grid, once per device and stage size
  static int cached_dev = -1, cached_stage = 0, cached_grid = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev != cached_dev || stage != cached_stage)) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * stage);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 2 * stage);
    if (e == cudaSuccess) {
      cached_dev = dev;
      cached_stage = stage;
      cached_grid = sms * per_sm;
    }
  }
  if (e != cudaSuccess) return (int)e;
  const long long n_rois = (long long)B * R;
  const int grid = (int)(n_rois < cached_grid ? n_rois : cached_grid);
  kernel<<<grid, THREADS, 2 * stage, stream>>>(pyr, boxes, reinterpret_cast<T*>(out), (int)n_rois,
                                               R, C, out_size, sr, stage);
  return (int)cudaGetLastError();
}

template <typename T, int V>
static int launch_shape(const Pyramid& pyr, const float* boxes, void* out, int B, int R, int C,
                        int out_size, int sr, cudaStream_t stream) {
  if (out_size == 7 && sr == 2)
    return launch<T, V, 7, 2>(pyr, boxes, out, B, R, C, out_size, sr, stream);
  return launch<T, V, 0, 0>(pyr, boxes, out, B, R, C, out_size, sr, stream);
}

// Plain C interface, loaded with ctypes by ops/roi_align_cuda.py.
//   dtype: 0 float32, 1 bfloat16; vec: channels per 16-byte vector (float32
//   4, bfloat16 8) when C % vec == 0 and the pointers are 16-byte aligned,
//   else 1.
// Levels are NHWC-contiguous (B, H_l, W_l, C) with H_l * W_l * C < 2^31;
// boxes (B, R, 4) float32; out (B, R, out_size, out_size, C) of the level
// dtype. Launches on `stream` without synchronising; returns the CUDA error
// code of the launch.
extern "C" int roi_align_forward(int dtype, int vec, const void* const* level_ptrs,
                                 const long long* batch_strides, const int* heights,
                                 const int* widths, const float* scales, int n_levels,
                                 int min_level, const float* boxes, void* out, int B,
                                 int R, int C, int out_size, int sampling_ratio,
                                 void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || out_size < 1 || sampling_ratio < 1 ||
      out_size * sampling_ratio > MAX_SAMPLES || C < 1 || C % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (B * R == 0) return 0;
  Pyramid pyr;
  for (int l = 0; l < n_levels; ++l) {
    if ((long long)heights[l] * widths[l] * C >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    pyr.ptr[l] = level_ptrs[l];
    pyr.batch_stride[l] = batch_strides[l];
    pyr.height[l] = heights[l];
    pyr.width[l] = widths[l];
    pyr.scale[l] = scales[l];
  }
  pyr.n_levels = n_levels;
  pyr.min_level = min_level;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return launch_shape<float, 4>(pyr, boxes, out, B, R, C, out_size, sampling_ratio, s);
  if (dtype == 0 && vec == 1)
    return launch_shape<float, 1>(pyr, boxes, out, B, R, C, out_size, sampling_ratio, s);
  if (dtype == 1 && vec == 8)
    return launch_shape<__nv_bfloat16, 8>(pyr, boxes, out, B, R, C, out_size, sampling_ratio, s);
  if (dtype == 1 && vec == 1)
    return launch_shape<__nv_bfloat16, 1>(pyr, boxes, out, B, R, C, out_size, sampling_ratio, s);
  return (int)cudaErrorInvalidValue;
}
