"""Multi-level ROIAlignV2 and its feature gradient through the CUDA kernels
of csrc/roi_align.cu (K1 and K1-bwd).

`multilevel_roi_align` is the pooler the model calls, in training and in
inference: a `RoIAlignFunction`, whose forward is K1 and whose backward is
`roi_align_backward` (K1-bwd) for CUDA tensors, and the plain PyTorch
versions (ops/roi_align.py, re-exported here as `plain` and
`plain_backward`) for CPU tensors. A CUDA tensor launches the kernel or
raises; there is no fallback from the card to the plain versions. The boxes
get no gradient.

The kernels are built at first use with nvcc for sm_90a into `build/` at the
repository root (ops/cuda_build.py) and loaded with ctypes.
`multilevel_roi_align.launches` and `roi_align_backward.launches` count
kernel launches. `footprint` counts the bytes K1's staging plan moves and
the pixels the boxes touch.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .cuda_build import CSRC_DIR, build_library
from .roi_align import multilevel_roi_align as plain
from .roi_align import multilevel_roi_align_backward as plain_backward

SOURCE = os.path.join(CSRC_DIR, "roi_align.cu")
MAX_LEVELS = 8
MAX_SAMPLES = 40  # out_size * sampling_ratio: the kernel's staged window is (2P)^2 pixels

_lib: Optional[ctypes.CDLL] = None
build_log = ""


def build() -> str:
    """Compile csrc/roi_align.cu into build/ unless this source's library is
    there already; returns the library's path. The compiler's report
    (registers, spills) is kept in `build_log`."""
    global build_log
    lib_path, log = build_library(SOURCE)
    build_log = log or build_log
    return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        P = ctypes.POINTER
        lib.roi_align_forward.argtypes = [
            ctypes.c_int, ctypes.c_int, P(ctypes.c_void_p), P(ctypes.c_longlong),
            P(ctypes.c_int), P(ctypes.c_int), P(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.roi_align_forward.restype = ctypes.c_int
        lib.roi_align_backward.argtypes = [
            ctypes.c_int, ctypes.c_int, P(ctypes.c_void_p), P(ctypes.c_int),
            P(ctypes.c_int), P(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.roi_align_backward.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(features: Sequence[torch.Tensor], boxes: torch.Tensor, strides,
           output_size: int, sampling_ratio: int):
    """Refuse what the kernels do not take: levels must be contiguous NHWC
    tensors of one dtype on the boxes' device."""
    dev, dt = boxes.device, features[0].dtype
    for f in features:
        if f.device != dev or f.dtype != dt:
            raise ValueError("levels and boxes must share one CUDA device and "
                             "the levels one dtype")
        if not f.is_contiguous():
            raise ValueError("levels must be NHWC-contiguous (a channels_last "
                             "NCHW tensor permuted to NHWC is)")
    _check_shapes([tuple(f.shape) for f in features], dt, boxes, strides, output_size,
                  sampling_ratio)


def _check_shapes(shapes, dt, boxes: torch.Tensor, strides, output_size: int,
                  sampling_ratio: int):
    L = len(shapes)
    if not 1 <= L <= MAX_LEVELS or len(strides) != L:
        raise ValueError(f"need 1..{MAX_LEVELS} levels with one stride each, got "
                         f"{L} levels and {len(strides)} strides")
    if output_size < 1 or sampling_ratio < 1 or output_size * sampling_ratio > MAX_SAMPLES:
        raise ValueError(f"output_size * sampling_ratio must be in 1..{MAX_SAMPLES}")
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"levels must be float32 or bfloat16, got {dt}")
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or not boxes.is_contiguous():
        raise ValueError("boxes must be a contiguous float32 (B, R, 4) tensor")
    B, C = boxes.shape[0], shapes[0][-1]
    for s in shapes:
        if len(s) != 4 or s[0] != B or s[-1] != C:
            raise ValueError(f"level of shape {s} is not (B={B}, H, W, C={C})")
        if s[1] * s[2] * C >= 2 ** 31:
            raise ValueError(f"level of shape {s} is too large for the "
                             "kernel's 32-bit offsets (H * W * C < 2^31)")


def _on_cpu(features, boxes) -> bool:
    if boxes.device.type == "cpu" and all(f.device.type == "cpu" for f in features):
        return True
    if boxes.device.type != "cuda":
        raise ValueError(f"boxes on {boxes.device}: expected CPU or CUDA tensors")
    return False


def _forward(features: Sequence[torch.Tensor], boxes: torch.Tensor, strides,
             output_size: int, sampling_ratio: int, min_level: int) -> torch.Tensor:
    """K1 for CUDA tensors, the plain version for CPU tensors."""
    if _on_cpu(features, boxes):
        return plain(features, boxes, strides, output_size, sampling_ratio, min_level)
    _check(features, boxes, strides, output_size, sampling_ratio)
    B, R = boxes.shape[:2]
    C = features[0].shape[-1]
    dt = features[0].dtype
    out = torch.empty((B, R, output_size, output_size, C), dtype=dt, device=boxes.device)
    if B * R == 0:
        return out
    # 16-byte vectors where C and every pointer allow, else the scalar width
    vec = 4 if dt == torch.float32 else 8
    if C % vec or any(t.data_ptr() % 16 for t in (*features, out)):
        vec = 1
    L = len(features)
    lib = _load()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.roi_align_forward(
            0 if dt == torch.float32 else 1, vec,
            (ctypes.c_void_p * L)(*[f.data_ptr() for f in features]),
            (ctypes.c_longlong * L)(*[f.stride(0) for f in features]),
            (ctypes.c_int * L)(*[f.shape[1] for f in features]),
            (ctypes.c_int * L)(*[f.shape[2] for f in features]),
            (ctypes.c_float * L)(*[1.0 / s for s in strides]),
            L, min_level, boxes.data_ptr(), out.data_ptr(), B, R, C,
            output_size, sampling_ratio, stream)
    if err != 0:
        raise RuntimeError(f"roi_align_forward failed with CUDA error {err}")
    multilevel_roi_align.launches += 1
    return out


def roi_align_backward(g: torch.Tensor, boxes: torch.Tensor, level_shapes,
                       dtype: torch.dtype, strides: Sequence[int], output_size: int = 7,
                       sampling_ratio: int = 2, min_level: int = 2):
    """The feature gradient of the pooler: g (B, R, P, P, C) -> one
    NHWC-contiguous (B, H_l, W_l, C) gradient per level of `level_shapes`,
    in the levels' `dtype`, on the boxes' device. CUDA tensors launch K1-bwd
    into zeroed float32 buffers (cast once at the end for bf16 levels); CPU
    tensors take the plain version."""
    shapes = [tuple(s) for s in level_shapes]
    if _on_cpu([g], boxes):
        return plain_backward(g, boxes, shapes, [dtype] * len(shapes), strides,
                              output_size, sampling_ratio, min_level)
    _check_shapes(shapes, dtype, boxes, strides, output_size, sampling_ratio)
    B, R = boxes.shape[:2]
    C = shapes[0][-1]
    dt = dtype
    if g.shape != (B, R, output_size, output_size, C) or g.device != boxes.device:
        raise ValueError(f"gradient of shape {tuple(g.shape)} on {g.device} does not fit "
                         f"the pooler's output {(B, R, output_size, output_size, C)}")
    g = g.to(dt).contiguous()
    bufs = [torch.zeros(s, dtype=torch.float32, device=boxes.device) for s in shapes]
    if B * R:
        vec = 4 if dt == torch.float32 else 8
        if C % vec or g.data_ptr() % 16:
            vec = 1
        L = len(shapes)
        lib = _load()
        with torch.cuda.device(boxes.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.roi_align_backward(
                0 if dt == torch.float32 else 1, vec,
                (ctypes.c_void_p * L)(*[b.data_ptr() for b in bufs]),
                (ctypes.c_int * L)(*[s[1] for s in shapes]),
                (ctypes.c_int * L)(*[s[2] for s in shapes]),
                (ctypes.c_float * L)(*[1.0 / s for s in strides]),
                L, min_level, boxes.data_ptr(), g.data_ptr(), B, R, C,
                output_size, sampling_ratio, stream)
        if err != 0:
            raise RuntimeError(f"roi_align_backward failed with CUDA error {err}")
        roi_align_backward.launches += 1
    return bufs if dt == torch.float32 else [b.to(dt) for b in bufs]


roi_align_backward.launches = 0


class RoIAlignFunction(torch.autograd.Function):
    """Multi-level ROIAlignV2 with its feature gradient: forward K1 (or the
    plain version on the CPU), backward K1-bwd (or the plain scatter). The
    boxes get no gradient."""

    @staticmethod
    def forward(ctx, boxes, strides, output_size, sampling_ratio, min_level, *features):
        ctx.save_for_backward(boxes)
        ctx.args = ([tuple(f.shape) for f in features], features[0].dtype, tuple(strides),
                    output_size, sampling_ratio, min_level)
        return _forward(features, boxes, strides, output_size, sampling_ratio, min_level)

    @staticmethod
    def backward(ctx, g):
        (boxes,) = ctx.saved_tensors
        grads = roi_align_backward(g, boxes, *ctx.args)
        return (None, None, None, None, None, *grads)


def multilevel_roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                         strides: Sequence[int], output_size: int = 7,
                         sampling_ratio: int = 2, min_level: int = 2) -> torch.Tensor:
    """ROIAlignV2 over NHWC levels (B, H_l, W_l, C) and boxes (B, R, 4) ->
    (B, R, output_size, output_size, C) in the levels' dtype, differentiable
    in the levels. CPU tensors take the plain versions; CUDA tensors the
    kernels."""
    return RoIAlignFunction.apply(boxes, tuple(strides), output_size, sampling_ratio,
                                  min_level, *features)


multilevel_roi_align.launches = 0


def footprint(levels, boxes, strides, out_size: int, sr: int, min_level: int = 2):
    """The kernel's shared-memory staging plan, counted on the boxes' device
    (for the bounds that chip_smoke.py prints; nothing here launches the
    kernel). Per RoI and axis the kernel stages the compact run of lines
    between the lowest and highest touched line when it holds at most 2P
    lines (P = out_size * sr) and no bin spans more than 2 * sr of them, else
    the 2P touched lines themselves.
    Returns a dict of tensors and totals: `levels` and `ny`, `nx` (B, R)
    staged lines, `staged_bytes` (sum of ny * nx * C * itemsize: what the
    staging moves from L2 to the SMs), `touched_bytes` (the union over RoIs
    of the pixels whose values are read, per image and level, times
    C * itemsize), `out_bytes`, and `gather_bytes` (sr^2 * 4 corner reads per
    output value, what a per-sample gather loads)."""
    dev = boxes.device
    B, R = boxes.shape[:2]
    C, elt = levels[0].shape[-1], levels[0].element_size()
    P = out_size * sr
    hs = torch.tensor([f.shape[1] for f in levels], device=dev)
    ws = torch.tensor([f.shape[2] for f in levels], device=dev)
    offs = torch.tensor(np.cumsum([0] + [f.shape[1] * f.shape[2] for f in levels])[:-1],
                        device=dev)
    inv = torch.tensor([1.0 / s for s in strides], device=dev)
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(w * h) / 224.0 + 1e-8))
    lvl = lvl.clamp(min_level, min_level + len(levels) - 1).long() - min_level
    scale, H, W = inv[lvl], hs[lvl], ws[lvl]
    grid = torch.from_numpy((np.arange(P, dtype=np.float32) + np.float32(0.5))
                            / np.float32(P)).to(dev)

    def lines(a0, a1, size):
        c0 = a0 * scale - 0.5
        ln = (a1 * scale - 0.5 - c0).clamp(min=1e-6)
        c = torch.minimum((c0[..., None] + ln[..., None] * grid).clamp(min=0.0),
                          (size[..., None] - 1).float())
        lo = torch.floor(c).long()
        hi = torch.minimum(lo + 1, size[..., None] - 1)
        run = hi[..., -1] - lo[..., 0] + 1
        band = hi[..., sr - 1::sr] - lo[..., ::sr] + 1      # lines per bin
        rect = (run <= 2 * P) & (band <= 2 * sr).all(-1)
        return torch.where(rect, run, torch.full_like(run, 2 * P)), torch.cat([lo, hi], -1)

    ny, rows = lines(boxes[..., 1], boxes[..., 3], H)
    nx, cols = lines(boxes[..., 0], boxes[..., 2], W)
    pix = offs[lvl][..., None, None] + rows[..., :, None] * W[..., None, None] + cols[..., None, :]
    mask = torch.zeros((B, int(offs[-1]) + levels[-1].shape[1] * levels[-1].shape[2]),
                       dtype=torch.bool, device=dev)
    mask.scatter_(1, pix.reshape(B, -1), True)
    n_out = B * R * out_size * out_size * C
    return {"ny": ny, "nx": nx, "levels": lvl + min_level,
            "staged_bytes": int((ny * nx).sum()) * C * elt,
            "touched_bytes": int(mask.sum()) * C * elt,
            "out_bytes": n_out * elt, "gather_bytes": n_out * sr * sr * 4 * elt}
