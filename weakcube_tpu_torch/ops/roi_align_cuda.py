"""Multi-level ROIAlignV2 through the CUDA kernel csrc/roi_align.cu.

`multilevel_roi_align` is the pooler the model calls. For CUDA tensors it
launches the kernel, and raises if it cannot; for CPU tensors it runs the
plain PyTorch version (ops/roi_align.py, re-exported here as `plain`). There
is no fallback from the card to the plain version.

The kernel is built at first use with nvcc for sm_90a into `build/` at the
repository root (ops/cuda_build.py) and loaded with ctypes.
`multilevel_roi_align.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import torch

from .cuda_build import CSRC_DIR, build_library
from .roi_align import multilevel_roi_align as plain

SOURCE = os.path.join(CSRC_DIR, "roi_align.cu")
MAX_LEVELS = 8
MAX_SAMPLES = 128

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
        _lib = lib
    return _lib


def _check(features: Sequence[torch.Tensor], boxes: torch.Tensor, strides,
           output_size: int, sampling_ratio: int):
    L = len(features)
    if not 1 <= L <= MAX_LEVELS or len(strides) != L:
        raise ValueError(f"need 1..{MAX_LEVELS} levels with one stride each, got "
                         f"{L} levels and {len(strides)} strides")
    if output_size < 1 or sampling_ratio < 1 or output_size * sampling_ratio > MAX_SAMPLES:
        raise ValueError(f"output_size * sampling_ratio must be in 1..{MAX_SAMPLES}")
    dev, dt = boxes.device, features[0].dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"levels must be float32 or bfloat16, got {dt}")
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or not boxes.is_contiguous():
        raise ValueError("boxes must be a contiguous float32 (B, R, 4) tensor")
    B, C = boxes.shape[0], features[0].shape[-1]
    for f in features:
        if f.device != dev or f.dtype != dt:
            raise ValueError("levels and boxes must share one CUDA device and "
                             "the levels one dtype")
        if f.dim() != 4 or f.shape[0] != B or f.shape[-1] != C:
            raise ValueError(f"level of shape {tuple(f.shape)} is not (B={B}, H, W, C={C})")
        if not f.is_contiguous():
            raise ValueError("levels must be NHWC-contiguous (a channels_last "
                             "NCHW tensor permuted to NHWC is)")


def multilevel_roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                         strides: Sequence[int], output_size: int = 7,
                         sampling_ratio: int = 2, min_level: int = 2) -> torch.Tensor:
    """ROIAlignV2 over NHWC levels (B, H_l, W_l, C) and boxes (B, R, 4) ->
    (B, R, output_size, output_size, C) in the levels' dtype. CPU tensors take
    the plain version; CUDA tensors the kernel."""
    if boxes.device.type == "cpu" and all(f.device.type == "cpu" for f in features):
        return plain(features, boxes, strides, output_size, sampling_ratio, min_level)
    if boxes.device.type != "cuda":
        raise ValueError(f"boxes on {boxes.device}: expected CPU or CUDA tensors")
    _check(features, boxes, strides, output_size, sampling_ratio)
    B, R = boxes.shape[:2]
    C = features[0].shape[-1]
    dt = features[0].dtype
    out = torch.empty((B, R, output_size, output_size, C), dtype=dt, device=boxes.device)
    if B * R == 0:
        return out
    vec = 4 if dt == torch.float32 else 2
    if C % vec or any(t.data_ptr() % (vec * t.element_size())
                      for t in (*features, out)):
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


multilevel_roi_align.launches = 0
