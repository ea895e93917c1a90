"""align_corners bilinear resize, the DPT head's, through the CUDA kernel of
csrc/bilinear_resize.cu.

`bilinear_resize(x, size)` is `F.interpolate(x, size, mode="bilinear",
align_corners=True)` of an (N, C, H, W) tensor. CPU tensors take that call
as it is (`plain`). CUDA tensors launch the kernel or raise ValueError;
there is no fallback from the card to ATen. The kernel takes a 4-d tensor
whose channels are contiguous (channels_last; any N, C, H and W, any pixel
strides and alignment) in bfloat16 or float32, and writes a new
channels_last tensor equal to ATen's CUDA result bit for bit: the same
source indices and float32 weights (`taps` computes them as the kernel
does), the same float32 arithmetic, one rounding to the output's dtype.
It computes no gradient, and refuses an input that asks for one.

One launch a call on the current stream, counted in
`bilinear_resize.launches`; each thread takes `vec_width` channels of one
output pixel (a 16-byte vector where C, the pointer and the strides allow
it). The kernel is built at first use with nvcc for sm_90a into `build/`
at the repository root (ops/cuda_build.py) and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import os
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .cuda_build import CSRC_DIR, KernelLibrary

SOURCE = os.path.join(CSRC_DIR, "bilinear_resize.cu")
# the kernel indexes rows, a row's threads (one block of 256 past the last)
# and every dimension in int
INT_LIMIT = 2 ** 31 - 256

_i, _ll, _f, _p = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p
_library = KernelLibrary(SOURCE, {"bilinear_resize_forward": (
    [_i, _i, _p, _p] + [_i] * 6 + [_ll] * 3 + [_f, _f, _p], _i)})
build = _library.build
__getattr__ = _library.module_attr  # build_log: the compiler's report


def plain(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """The function, as PyTorch computes it on any device."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


def scale(n_in: int, n_out: int) -> np.float32:
    """ATen's align_corners scale: (float)(n_in - 1) / (n_out - 1), 0 where
    n_out is 1."""
    return np.float32(n_in - 1) / np.float32(n_out - 1) if n_out > 1 else np.float32(0)


def taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Each destination index's source indices and weights along one axis,
    in float32 as the kernel computes them: src = scale * dst, i0 =
    (int)src, i1 = i0 + (i0 < n_in - 1), l1 = src - i0, l0 = 1 - l1.
    Returns (i0, i1, l0, l1), each of n_out."""
    src = scale(n_in, n_out) * np.arange(n_out, dtype=np.float32)
    i0 = src.astype(np.int64)
    l1 = src - i0.astype(np.float32)
    return i0, i0 + (i0 < n_in - 1), np.float32(1) - l1, l1


def vec_width(x: torch.Tensor) -> int:
    """Channels a thread takes: the widest of 16, 8, 4 and 2 bytes (bf16:
    8, 4, 2, 1 channels; float32: 4, 2, 1) whose channel count divides C,
    x's pixel strides (of the dimensions longer than 1) and x's pointer
    offset in elements."""
    es = x.element_size()
    N, C, H, W = x.shape
    for v in (16 // es, 8 // es, 4 // es, 2 // es):
        if v >= 1 and C % v == 0 and x.data_ptr() % (v * es) == 0 \
                and all(x.stride(d) % v == 0 for d in (0, 2, 3) if x.shape[d] > 1):
            return v
    return 1


def bilinear_resize(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """align_corners bilinear resize of x (N, C, H, W) to size (H_out,
    W_out): `plain` for a CPU tensor; for a CUDA tensor one kernel launch
    into a new channels_last tensor of x's dtype, or ValueError for a
    tensor the kernel does not take."""
    if x.device.type == "cpu":
        return plain(x, size)
    if x.device.type != "cuda" or x.dim() != 4:
        raise ValueError(f"bilinear_resize takes a 4-d CPU or CUDA tensor, got "
                         f"{tuple(x.shape)} on {x.device}")
    Ho, Wo = (int(s) for s in size)
    out = torch.empty((x.shape[0], x.shape[1], max(Ho, 0), max(Wo, 0)), dtype=x.dtype,
                      device=x.device, memory_format=torch.channels_last)
    launch(x, out)
    return out


def launch(x: torch.Tensor, out: torch.Tensor) -> None:
    """One bilinear_resize_forward launch on the current stream: x (N, C,
    H, W) with contiguous channels into out (N, C, H_out, W_out), dense
    channels_last, of x's dtype (bfloat16 or float32), both on one CUDA
    device. Nothing is launched for an empty batch or no channels. Raises
    ValueError for what the kernel does not take. Counted in
    `bilinear_resize.launches`."""
    if x.device.type != "cuda" or out.device != x.device:
        raise ValueError(f"x on {x.device} and out on {out.device}: the kernel takes both on "
                         "one CUDA device")
    if x.dim() != 4 or out.dim() != 4 or out.shape[:2] != x.shape[:2]:
        raise ValueError(f"x {tuple(x.shape)} and out {tuple(out.shape)} are not (N, C, H, W) "
                         "of the same N and C")
    if x.dtype not in (torch.bfloat16, torch.float32) or out.dtype != x.dtype:
        raise ValueError(f"the kernel takes bfloat16 or float32, x {x.dtype} into out "
                         f"{out.dtype}")
    N, C, Hi, Wi = x.shape
    Ho, Wo = out.shape[2:]
    if x.stride(1) != 1 and C > 1:
        raise ValueError(f"x {tuple(x.shape)} strides {x.stride()}: the kernel takes "
                         "channels_last tensors (channel stride 1), not NCHW")
    if not out.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"out strides {out.stride()}: not dense channels_last")
    if min(Hi, Wi, Ho, Wo) < 1:
        raise ValueError(f"resize of {Hi}x{Wi} to {Ho}x{Wo}: sizes must be at least 1")
    if max(N * Ho, Wo * C, Hi, Wi) >= INT_LIMIT:
        raise ValueError(f"resize of {tuple(x.shape)} to {Ho}x{Wo}: past the kernel's int "
                         "indexing")
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("the kernel computes no gradient: call it under no_grad or "
                         "inference_mode")
    if N == 0 or C == 0:
        return
    vec = vec_width(x)
    with torch.cuda.device(x.device):
        err = _library.load().bilinear_resize_forward(
            int(x.dtype == torch.bfloat16), vec, x.data_ptr(), out.data_ptr(), N, C, Hi, Wi,
            Ho, Wo, x.stride(0), x.stride(2), x.stride(3), float(scale(Hi, Ho)),
            float(scale(Wi, Wo)), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bilinear_resize_forward failed with CUDA error {err}")
    bilinear_resize.launches += 1


bilinear_resize.launches = 0
