// Multi-level ROIAlignV2 forward (K1) and its feature gradient (K1-bwd,
// after the forward, from "Backward" on) for NVIDIA Hopper (sm_90a).
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
// (both counted from the boxes; PERF.md).
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

// The RoI's level (0-based), as ops/roi_align.py::assign_fpn_levels. The
// forward and the backward both place RoIs with this and sample_coord.
__device__ __forceinline__ int roi_level(float4 box, int min_level, int n_levels) {
  const float w = fmaxf(box.z - box.x, 0.f);
  const float h = fmaxf(box.w - box.y, 0.f);
  const float lvlf = floorf(4.f + log2f(sqrtf(w * h) / 224.f + 1e-8f));
  const int hi_lvl = min_level + n_levels - 1;
  return (int)fminf(fmaxf(lvlf, (float)min_level), (float)hi_lvl) - min_level;
}

// Coordinate of a sample along one axis of a RoI whose edges on that axis
// are e1, e2 (image units), at fraction t of the RoI (sample p of P:
// t = (p + 0.5) / P, correctly rounded), on a level of `size` lines and
// 1 / stride `scale`: aligned (-0.5), clamped to [0, size - 1], each step
// rounded as the reference rounds it (no fused multiply-add).
__device__ __forceinline__ float sample_coord(float e1, float e2, float scale, float t, int size) {
  const float a1 = __fsub_rn(__fmul_rn(e1, scale), 0.5f);
  const float a2 = __fsub_rn(__fmul_rn(e2, scale), 0.5f);
  const float len = fmaxf(a2 - a1, 1e-6f);
  return fminf(fmaxf(__fadd_rn(a1, __fmul_rn(len, t)), 0.f), (float)(size - 1));
}

__device__ __forceinline__ float sample_t(int p, int P) {
  return __fdiv_rn((float)p + 0.5f, (float)P);
}

// All threads of the block call it (it synchronises).
template <typename T, int V>
__device__ Plan<T> make_plan(const Pyramid& pyr, float4 box, int b, int out_size, int nsr,
                             int C, int stage_bytes, PlanScratch& sc, PlanTables& tb) {
  constexpr int VB = V * sizeof(T);  // bytes per channel vector
  const int P = out_size * nsr;

  const int lvl = roi_level(box, pyr.min_level, pyr.n_levels);
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
    const float e1 = axis ? box.x : box.y, e2 = axis ? box.z : box.w;
    const int size = axis ? W : H;
    const float c = sample_coord(e1, e2, scale, sample_t(p, P), size);
    const float lo = floorf(c);
    sc.lo[axis][p] = (int)lo;
    sc.hi[axis][p] = min((int)lo + 1, size - 1);
    sc.frac[axis][p] = c - lo;
    if (p % nsr == 0) {
      const float last = sample_coord(e1, e2, scale, sample_t(p + nsr - 1, P), size);
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

// ---------------------------------------------------------------------------
// Backward: the feature gradient of the forward above (K1-bwd).
//
// Replaces the XLA backward the JAX package trains with,
// weakcube_tpu/ops/roi_align.py:403 matmul_bwd (two dense contractions per
// level against hat-function matrices, under the custom_vjp of
// multilevel_roi_align_trainable, :495-568). ROIAlign is linear in the
// features, so the gradient is the forward's transpose: every level pixel
// gathers g (B, R, P, P, C) through the bilinear weights of the samples
// that touch it, with the forward's level assignment and sample coordinates
// (roi_level, sample_coord), the same clamp to [0, size - 1] and the same
// sr x sr mean.
//
// Bound on the card: bytes. g is read once and every level's gradient is
// written once in the level dtype (bf16 at b25, R = 512, C = 256: 321 MB +
// 279 MB for the box pooler, 0.179 ms at 3.35 TB/s); the work is a few
// float32 FMAs per byte, far below the H100's ~295 operations per byte.
//
// Diagnosis of the previous design (one block per RoI adding into zeroed
// float32 level buffers with float4 atomics, then a cast to bf16; on an
// H100 at the training step's inputs, each pass timed alone, PERF.md):
// per box-pooler call the zero fill took 0.181 ms, the kernel 0.569 and the
// cast 0.287; per cube-pooler call 0.196, 0.172 and 0.286. The two passes
// over the whole float32 levels cost ~0.47 ms per call whatever the RoIs,
// and the atomics made two launches differ in rounding.
//
// Design: a tile-owned gather. Every pixel of every level is written
// exactly once, in the level dtype, by the one thread that owns it; its
// sum runs over the same RoIs in the same order on every launch, so two
// launches give the same bits. No zero pass, no cast pass, no atomics.
//   * One block per (image, channel chunk, level, 8 x 8 pixel tile),
//     image-major, so that the blocks in flight read the g of one or two
//     images (12.8 MB each in the box pooler), which the 50 MB L2 holds
//     while the image's tiles re-read it. A chunk is 512 bytes of channels
//     (256 bf16, 128 float32; 16 channels at the scalar width). A warp owns
//     one tile column: its 32 lanes are the chunk's 32 16-byte channel
//     vectors, each with the column's 8 pixels (64 float32 sums in
//     registers), so all lanes of a warp share every loop bound. Ragged
//     tiles and channels are masked.
//   * The block finds its own RoIs: it reads the image's boxes blockDim at
//     a time, keeps those on its level whose line range [lo[0], hi[P - 1]]
//     meets the tile on both axes, and compacts them by a block-wide
//     prefix count into a list in ascending RoI index, with their boxes.
//     R is unbounded.
//   * Per batch of up to 4 kept RoIs (98 KB): cp.async stages each RoI's g
//     chunk in shared memory while one warp per RoI, a lane per (axis,
//     tile line), places the line's samples as the forward does, sums the
//     weight of each bin on the line over the bin's samples in ascending
//     order ((1 - f) / sr on lo, f / sr on hi, both where lo == hi, as the
//     scatter did) and records the bins touching the line (one range: the
//     sample lines are non-decreasing). One rule for compact and elongated
//     RoIs alike.
//   * Each thread adds, per RoI in list order and per own row, for each
//     bin i on the row: wy * sum_j wx * g[roi, i, j] over the bins j on its
//     column (float32 FMA). A generic out_size * sr reads g through L1
//     instead of staging it.
//   * It rounds each sum once to the level dtype and stores 16-byte
//     vectors (a warp: one pixel's 512 bytes per row); pixels no RoI
//     touches get zeros.
//   * On an H100 at the training step's inputs, 16 x 16 tiles of 64
//     channels (a warp of 4 columns x 8 vectors, whose lanes' column loops
//     diverge), batches of 3 RoIs and the column loop unrolled were each
//     slower (each timed against this source on the same inputs;
//     PERF.md). Slower in development and not kept: g read
//     straight from L2 instead of staged, a thread per pixel with all of a
//     chunk's channels (its unseparated sum also left the float32
//     tolerance on p6), 32-channel chunks, 512-thread blocks, more blocks
//     per SM (register spills), the bin loop outermost with a row mask.
//     The accumulation's loop control and idle lanes set the time more
//     than its shared-memory loads of g.

#define BWD_TILE_W 8                 // tile columns: one warp each
#define BWD_TILE_H 8                 // tile rows: a thread's ROWS pixels
#define BWD_CHUNK_BYTES 512          // channels per chunk: 32 vectors of 16 bytes, a warp's lanes
#define BWD_LINES 16                 // table lines per axis (a lane per line and axis)
#define BWD_THREADS 256
#define BWD_STAGE_BYTES (98 * 1024)  // 4 RoIs' g chunks of 7 x 7 bins x 512 bytes
#define BWD_MAX_BATCH 16

struct GradPyramid {
  void* ptr[MAX_LEVELS];              // (B, H, W, C) gradient of each level, of g's dtype
  int height[MAX_LEVELS];
  int width[MAX_LEVELS];
  float scale[MAX_LEVELS];            // 1 / stride
  int tiles_x[MAX_LEVELS];            // tile columns of each level
  int tile0[MAX_LEVELS + 1];          // first tile of each level; tile0[n_levels]: all tiles
  int n_levels;
  int min_level;
};

// A block's shape: a chunk of NV channel vectors of V channels (the lanes
// of a warp, for 16-byte vectors); a thread's ROWS pixels, every SEGS-th
// row of one tile column; KB RoIs per batch, whose g chunks (OUT x OUT
// bins) are staged in shared memory when OUT is known at compile time
// (else read through L1).
template <typename T, int V, int OUT> struct BwdShape {
  static constexpr int NV = V == 1 ? 16 : BWD_CHUNK_BYTES / 16;
  static constexpr int CHUNK = NV * V;
  static constexpr int ROWS = BWD_TILE_W * BWD_TILE_H * NV / BWD_THREADS;
  static constexpr int SEGS = BWD_TILE_H / ROWS;
  static_assert(SEGS * ROWS == BWD_TILE_H, "a column's rows split into whole segments");
  static_assert(BWD_TILE_W <= BWD_LINES && BWD_TILE_H <= BWD_LINES && 2 * BWD_LINES == 32,
                "a lane per table line");
  static constexpr int ROI_BYTES = OUT * OUT * CHUNK * (int)sizeof(T);
  static constexpr int KB = !OUT ? 4
                            : BWD_STAGE_BYTES / ROI_BYTES < BWD_MAX_BATCH ? BWD_STAGE_BYTES / ROI_BYTES
                                                                          : BWD_MAX_BATCH;
  static constexpr int SMEM_BYTES = OUT ? KB * ROI_BYTES : 0;
};

// OUT, SR: out_size and sampling_ratio when known at compile time, else 0.
template <typename T, int V, int OUT, int SR>
__global__ void __launch_bounds__(BWD_THREADS, 2)
roi_align_bwd_kernel(GradPyramid pyr, const float* __restrict__ boxes, const T* __restrict__ g,
                     int R, int C, int out_size_rt, int sr_rt, int n_chunks) {
  using Shape = BwdShape<T, V, OUT>;
  constexpr int NV = Shape::NV, CHUNK = Shape::CHUNK, ROWS = Shape::ROWS, SEGS = Shape::SEGS;
  constexpr int KB = Shape::KB;
  constexpr int MAXB = OUT ? OUT : MAX_SAMPLES;       // bins per axis
  constexpr int MAXP = OUT ? OUT * SR : MAX_SAMPLES;  // samples per axis
  extern __shared__ __align__(16) char g_stage[];     // KB RoIs' g chunks, when staged
  __shared__ int list[BWD_THREADS];                   // kept RoIs of a chunk of boxes ...
  __shared__ float4 list_box[BWD_THREADS];            // ... and their boxes
  __shared__ int warp_kept[BWD_THREADS / 32];
  __shared__ float t_of[MAXP];                        // (p + 0.5) / P
  __shared__ float wt[KB][2][MAXB][BWD_LINES];        // [RoI][axis][bin][tile line]
  __shared__ int2 bins[KB][2][BWD_LINES];             // bins touching each tile line
  const int out_size = OUT ? OUT : out_size_rt;
  const int nsr = SR ? SR : sr_rt;
  const int P = out_size * nsr;

  // block -> (image, chunk, level, tile)
  const int tiles = pyr.tile0[pyr.n_levels];
  const int tile = blockIdx.x % tiles;
  const int chunk = (blockIdx.x / tiles) % n_chunks;
  const int b = blockIdx.x / tiles / n_chunks;
  int lvl = 0;
  while (tile >= pyr.tile0[lvl + 1]) ++lvl;
  const int H = pyr.height[lvl], W = pyr.width[lvl];
  const float scale = pyr.scale[lvl];
  const int t_in = tile - pyr.tile0[lvl];
  const int ty0 = t_in / pyr.tiles_x[lvl] * BWD_TILE_H, tx0 = t_in % pyr.tiles_x[lvl] * BWD_TILE_W;
  for (int p = threadIdx.x; p < P; p += BWD_THREADS) t_of[p] = sample_t(p, P);
  const float t_first = sample_t(0, P), t_last = sample_t(P - 1, P);

  // this thread: channel vector v of tile column x, rows seg, seg + SEGS, ...
  // (16-byte vectors: a warp is one column's 32 vectors, so that its lanes
  // share every loop bound)
  const int v = threadIdx.x % NV;
  const int x = threadIdx.x / NV % BWD_TILE_W;
  const int seg = threadIdx.x / (NV * BWD_TILE_W);
  const int c = chunk * CHUNK + v * V;  // C % V == 0, so c < C holds the whole vector
  const bool live = c < C;
  const int n_bins = out_size * out_size;
  const long long roi_elems = (long long)n_bins * C;
  const float* img_boxes = boxes + (long long)b * R * 4;
  const T* img_g = g + (long long)b * R * roi_elems + chunk * CHUNK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[ROWS][V];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[r][e] = 0.f;

  for (int r0 = 0; r0 < R; r0 += BWD_THREADS) {
    // 1. this chunk's RoIs on the block's level whose line range meets the
    //    tile on both axes, compacted in ascending index with their boxes
    const int roi = r0 + threadIdx.x;
    bool keep = false;
    float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
    if (roi < R) {
      box = load_box(img_boxes, roi);
      if (roi_level(box, pyr.min_level, pyr.n_levels) == lvl) {
        const int y_lo = (int)floorf(sample_coord(box.y, box.w, scale, t_first, H));
        const int y_hi = min((int)floorf(sample_coord(box.y, box.w, scale, t_last, H)) + 1, H - 1);
        const int x_lo = (int)floorf(sample_coord(box.x, box.z, scale, t_first, W));
        const int x_hi = min((int)floorf(sample_coord(box.x, box.z, scale, t_last, W)) + 1, W - 1);
        keep = y_lo < ty0 + BWD_TILE_H && y_hi >= ty0 && x_lo < tx0 + BWD_TILE_W && x_hi >= tx0;
      }
    }
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_kept[warp] = __popc(kept);
    __syncthreads();
    int before = 0, n_kept = 0;
#pragma unroll
    for (int w = 0; w < BWD_THREADS / 32; ++w) {
      before += w < warp ? warp_kept[w] : 0;
      n_kept += warp_kept[w];
    }
    if (keep) {
      const int at = before + __popc(kept & ((1u << lane) - 1u));
      list[at] = roi;
      list_box[at] = box;
    }
    __syncthreads();

    for (int k0 = 0; k0 < n_kept; k0 += KB) {
      const int nb = min(KB, n_kept - k0);
      // 2. stage the batch's g chunks (16-byte cp.async, in flight during
      //    step 3)
      if constexpr (OUT != 0) {
        for (int q = threadIdx.x; q < nb * n_bins * NV; q += BWD_THREADS) {
          const int k = q / (n_bins * NV), bin = q / NV % n_bins, u = q % NV;
          if (chunk * CHUNK + u * V >= C) continue;
          const T* src = img_g + list[k0 + k] * roi_elems + bin * C + u * V;
          T* dst = reinterpret_cast<T*>(g_stage) + (k * n_bins + bin) * CHUNK + u * V;
          if constexpr (V * sizeof(T) == 16) {
            cp_async16(dst, src);
          } else {
            *dst = *src;
          }
        }
        cp_async_commit();
      }
      // 3. a warp per RoI, a lane per (axis, tile line): the line's samples
      //    placed as the forward places them, the summed weight of each bin
      //    on the line (the 1 / sr of the bin mean folded in) and the range
      //    of bins touching it
      for (int k = warp; k < nb; k += BWD_THREADS / 32) {
        const int axis = lane / BWD_LINES, l = lane % BWD_LINES;
        const int line = (axis ? tx0 : ty0) + l, size = axis ? W : H;
        const float4 bx = list_box[k0 + k];
        const float e1 = axis ? bx.x : bx.y, e2 = axis ? bx.z : bx.w;
        float* w = &wt[k][axis][0][l];
        for (int i = 0; i < out_size; ++i) w[i * BWD_LINES] = 0.f;
        int b_lo = out_size, b_hi = -1;
        for (int p = 0; p < P; ++p) {
          const float cc = sample_coord(e1, e2, scale, t_of[p], size);
          const float lo = floorf(cc);
          const bool at_lo = (int)lo == line, at_hi = min((int)lo + 1, size - 1) == line;
          if (at_lo || at_hi) {
            const int i = p / nsr;
            const float f = cc - lo;
            if (at_lo) w[i * BWD_LINES] += (1.f - f) / (float)nsr;
            if (at_hi) w[i * BWD_LINES] += f / (float)nsr;
            b_lo = min(b_lo, i);
            b_hi = max(b_hi, i);
          }
        }
        bins[k][axis][l] = make_int2(b_lo, b_hi);
      }
      cp_async_wait<0>();
      __syncthreads();
      // 4. accumulate, RoI by RoI in list order: per own row, for each bin
      //    i on the row, wy * sum_j wx * g[i, j] over the bins j on the column
      if (live) {
        for (int k = 0; k < nb; ++k) {
          const int2 bx = bins[k][1][x];
          if (bx.x > bx.y) continue;
          // the RoI's g chunk: staged (bins CHUNK apart) or in global memory
          const T* gr = OUT ? reinterpret_cast<const T*>(g_stage) + k * n_bins * CHUNK + v * V
                            : img_g + list[k0 + k] * roi_elems + v * V;
          const int bin_stride = OUT ? CHUNK : C;
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const int2 by = bins[k][0][r * SEGS + seg];
            for (int i = by.x; i <= by.y; ++i) {
              const T* gi = gr + (long long)i * out_size * bin_stride;
              float s[V];
#pragma unroll
              for (int e = 0; e < V; ++e) s[e] = 0.f;
#pragma unroll 1  // 1-2 trips, mostly: unrolled, the code outgrew the instruction cache
              for (int j = bx.x; j <= bx.y; ++j) {
                float gv[V];
                Vec<T, V>::load(gi + j * bin_stride, gv);
                const float wx = wt[k][1][j][x];
#pragma unroll
                for (int e = 0; e < V; ++e) s[e] = fmaf(wx, gv[e], s[e]);
              }
              const float wy = wt[k][0][i][r * SEGS + seg];
#pragma unroll
              for (int e = 0; e < V; ++e) acc[r][e] = fmaf(wy, s[e], acc[r][e]);
            }
          }
        }
      }
      __syncthreads();  // the stage, the tables and the list are refilled next
    }
  }

  // 5. write every pixel of the tile once; a warp's stores cover one
  //    pixel's chunk of channels per row
  const int xx = tx0 + x;
  if (live && xx < W) {
    T* out = reinterpret_cast<T*>(pyr.ptr[lvl]) + ((long long)b * H * W + xx) * C + c;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int yy = ty0 + r * SEGS + seg;
      if (yy < H) Vec<T, V>::store(out + (long long)yy * W * C, acc[r]);
    }
  }
}

template <typename T, int V, int OUT, int SR>
static int launch_bwd(const GradPyramid& pyr, const float* boxes, const void* g, int B, int R,
                      int C, int out_size, int sr, cudaStream_t stream) {
  using Shape = BwdShape<T, V, OUT>;
  const int n_chunks = (C + Shape::CHUNK - 1) / Shape::CHUNK;
  const long long grid = (long long)B * n_chunks * pyr.tile0[pyr.n_levels];
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = roi_align_bwd_kernel<T, V, OUT, SR>;
  // static and dynamic shared memory pass 48 KB together: opt in once per
  // device (the attribute is per device)
  static bool opted_in = false;
  static int opted_dev = -1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (!opted_in || dev != opted_dev)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Shape::SMEM_BYTES);
    opted_in = e == cudaSuccess;
    opted_dev = dev;
  }
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)grid, BWD_THREADS, Shape::SMEM_BYTES, stream>>>(
      pyr, boxes, reinterpret_cast<const T*>(g), R, C, out_size, sr, n_chunks);
  return (int)cudaGetLastError();
}

template <typename T, int V>
static int launch_bwd_shape(const GradPyramid& pyr, const float* boxes, const void* g, int B,
                            int R, int C, int out_size, int sr, cudaStream_t stream) {
  if (out_size == 7 && sr == 2)
    return launch_bwd<T, V, 7, 2>(pyr, boxes, g, B, R, C, out_size, sr, stream);
  return launch_bwd<T, V, 0, 0>(pyr, boxes, g, B, R, C, out_size, sr, stream);
}

// Plain C interface of the backward, loaded with ctypes by
// ops/roi_align_cuda.py.
//   dtype: 0 float32, 1 bfloat16 (of g and the gradients); vec: channels
//   per 16-byte vector (float32 4, bfloat16 8) when C % vec == 0 and g and
//   every gradient are 16-byte aligned, else 1.
// grad_ptrs: one NHWC-contiguous (B, H_l, W_l, C) buffer per level
// (H_l * W_l * C < 2^31), of g's dtype; every element is written, so it
// needs no initialisation. boxes (B, R, 4) float32; g (B, R, out_size,
// out_size, C) contiguous. Launches on `stream` without synchronising;
// returns the CUDA error code of the launch (nothing is launched, and the
// gradients are not written, when B * R == 0).
extern "C" int roi_align_backward(int dtype, int vec, void* const* grad_ptrs,
                                  const int* heights, const int* widths, const float* scales,
                                  int n_levels, int min_level, const float* boxes,
                                  const void* g, int B, int R, int C, int out_size,
                                  int sampling_ratio, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || out_size < 1 || sampling_ratio < 1 ||
      out_size * sampling_ratio > MAX_SAMPLES || C < 1 || C % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (B * R == 0) return 0;
  GradPyramid pyr;
  pyr.tile0[0] = 0;
  for (int l = 0; l < n_levels; ++l) {
    if ((long long)heights[l] * widths[l] * C >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    pyr.ptr[l] = grad_ptrs[l];
    pyr.height[l] = heights[l];
    pyr.width[l] = widths[l];
    pyr.scale[l] = scales[l];
    pyr.tiles_x[l] = (widths[l] + BWD_TILE_W - 1) / BWD_TILE_W;
    pyr.tile0[l + 1] = pyr.tile0[l] + pyr.tiles_x[l] * ((heights[l] + BWD_TILE_H - 1) / BWD_TILE_H);
  }
  pyr.n_levels = n_levels;
  pyr.min_level = min_level;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return launch_bwd_shape<float, 4>(pyr, boxes, g, B, R, C, out_size, sampling_ratio, s);
  if (dtype == 0 && vec == 1)
    return launch_bwd_shape<float, 1>(pyr, boxes, g, B, R, C, out_size, sampling_ratio, s);
  if (dtype == 1 && vec == 8)
    return launch_bwd_shape<__nv_bfloat16, 8>(pyr, boxes, g, B, R, C, out_size, sampling_ratio, s);
  if (dtype == 1 && vec == 1)
    return launch_bwd_shape<__nv_bfloat16, 1>(pyr, boxes, g, B, R, C, out_size, sampling_ratio, s);
  return (int)cudaErrorInvalidValue;
}
