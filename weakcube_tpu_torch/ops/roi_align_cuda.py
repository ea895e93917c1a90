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
kernel launches.
"""
from __future__ import annotations

import ctypes
import os
from typing import Sequence

import torch

from .cuda_build import CSRC_DIR, KernelLibrary
from .roi_align import multilevel_roi_align as plain
from .roi_align import multilevel_roi_align_backward as plain_backward

SOURCE = os.path.join(CSRC_DIR, "roi_align.cu")
MAX_LEVELS = 8
MAX_SAMPLES = 40  # out_size * sampling_ratio: the kernel's staged window is (2P)^2 pixels

_P = ctypes.POINTER
_library = KernelLibrary(SOURCE, {
    "roi_align_forward": (
        [ctypes.c_int, ctypes.c_int, _P(ctypes.c_void_p), _P(ctypes.c_longlong),
         _P(ctypes.c_int), _P(ctypes.c_int), _P(ctypes.c_float), ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "roi_align_backward": (
        [ctypes.c_int, ctypes.c_int, _P(ctypes.c_void_p), _P(ctypes.c_int), _P(ctypes.c_int),
         _P(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p], ctypes.c_int)})
build = _library.build
__getattr__ = _library.module_attr  # build_log: the compiler's report


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
    lib = _library.load()
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
    once, which writes every element of the uninitialised gradients (no
    RoIs: zeros, no launch); CPU tensors take the plain version."""
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
    if B * R == 0:
        return [torch.zeros(s, dtype=dt, device=boxes.device) for s in shapes]
    g = g.to(dt).contiguous()
    grads = [torch.empty(s, dtype=dt, device=boxes.device) for s in shapes]
    vec = 4 if dt == torch.float32 else 8
    if C % vec or any(t.data_ptr() % 16 for t in (g, *grads)):
        vec = 1
    L = len(shapes)
    lib = _library.load()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.roi_align_backward(
            0 if dt == torch.float32 else 1, vec,
            (ctypes.c_void_p * L)(*[t.data_ptr() for t in grads]),
            (ctypes.c_int * L)(*[s[1] for s in shapes]),
            (ctypes.c_int * L)(*[s[2] for s in shapes]),
            (ctypes.c_float * L)(*[1.0 / s for s in strides]),
            L, min_level, boxes.data_ptr(), g.data_ptr(), B, R, C,
            output_size, sampling_ratio, stream)
    if err != 0:
        raise RuntimeError(f"roi_align_backward failed with CUDA error {err}")
    roi_align_backward.launches += 1
    return grads


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
