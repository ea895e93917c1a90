"""Non-causal attention through the CUDA kernel csrc/flash_attention.cu.

`flash_attention(q, k, v, scale)` is the attention the Depth Anything V2
encoder calls, on (B, H, N, 64) tensors given by their strides (the
encoder passes views of its qkv projection, no copies);
`flash_attention(q, k, v, scale, rel_pos=(bias_h, bias_w))` adds SAM's
decomposed relative-position bias (data/pseudo_gt/sam.py), launched as the
kernel's biased instantiation (flash_fwd_relpos_*). For CUDA tensors it
launches the kernel (bfloat16 on the tensor cores, float32 on a plain f32
path) and raises if it cannot; for CPU tensors it runs the plain PyTorch
version (ops/attention.py, re-exported here as `plain`). There is no
fallback from the card to the plain version.

The kernel is built at first use with nvcc for sm_90a into `build/` at the
repository root (ops/cuda_build.py) and loaded with ctypes.
`flash_attention.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from .attention import attention as plain
from .cuda_build import CSRC_DIR, KernelLibrary

SOURCE = os.path.join(CSRC_DIR, "flash_attention.cu")
HEAD_DIM = 64
MAX_BATCH_HEADS = 65535  # the grid's y extent
MAX_REL_SUM = 132        # kh + kw: the bias rows' room in shared memory

_p = ctypes.c_void_p
_int, _ll = ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
_library = KernelLibrary(SOURCE, {
    "flash_attention_forward": (
        [_int, _p, _p, _p, _p, _int, _int, _int, _int, _ll, ctypes.c_float, _p], _int),
    "flash_attention_relpos_forward": (
        [_int, _p, _p, _p, _p, _int, _int, _int, _int, _ll, ctypes.c_float, _p, _p, _int, _int,
         _ll, _p], _int)})
build = _library.build
__getattr__ = _library.module_attr  # build_log: the compiler's report


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """The (B, H, N) strides of a (B, H, N, 64) tensor in elements. A
    dimension of size 1 is never stepped over, so its stride is set to 64,
    a value the kernel takes whatever the view reported."""
    return tuple(s if n > 1 else HEAD_DIM for s, n in zip(t.stride()[:3], t.shape[:3]))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raises on what the kernel does not take. It takes any view whose last
    dimension is contiguous and whose base pointer and other strides are
    16-byte aligned, such as the q, k, v views of a fused qkv projection's
    (B, N, 3, H, 64) output."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM or q.shape[2] < 1:
        raise ValueError(f"q of shape {tuple(q.shape)} is not (B, H, N >= 1, {HEAD_DIM})")
    if q.shape[0] * q.shape[1] > MAX_BATCH_HEADS:
        raise ValueError(f"B * H = {q.shape[0] * q.shape[1]} exceeds {MAX_BATCH_HEADS}")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError("q, k and v must share one device, dtype and shape")
        if t.stride(-1) != 1:
            raise ValueError("the last dimension of q, k and v must be contiguous")
        if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in _strides(t)):
            raise ValueError("q, k and v need 16-byte aligned base pointers and strides")


def _check_rel_pos(q: torch.Tensor, bias_h: torch.Tensor, bias_w: torch.Tensor) -> None:
    """Raises on a bias the kernel does not take: float32 (B, H, N, kh) and
    (B, H, N, kw) on q's device with N = kh * kw, kw even, kh + kw at most
    MAX_REL_SUM, the last dimension contiguous."""
    B, H, N, _ = q.shape
    for t in (bias_h, bias_w):
        if t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"the bias must be float32 on {q.device}, got {t.dtype} on {t.device}")
        if t.dim() != 4 or tuple(t.shape[:3]) != (B, H, N) or t.stride(-1) != 1:
            raise ValueError(f"bias of shape {tuple(t.shape)}, strides {t.stride()}: expected "
                             f"({B}, {H}, {N}, k) with its last dimension contiguous")
    kh, kw = bias_h.shape[-1], bias_w.shape[-1]
    if kh * kw != N or kw % 2 or kh + kw > MAX_REL_SUM:
        raise ValueError(f"a {kh} x {kw} key grid for N = {N}: the kernel takes kh * kw = N, "
                         f"kw even, kh + kw <= {MAX_REL_SUM}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    rel_pos: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v over (B, H, N, 64) tensors, in their
    dtype; without rel_pos the bias is 0, with rel_pos = (bias_h (B, H, N,
    kh), bias_w (B, H, N, kw)), N = kh * kw, key j takes bias_h[..., j //
    kw] + bias_w[..., j % kw], added in float32 to the float32 scores.
    CPU tensors take the plain version; CUDA tensors the kernel, which reads
    q, k, v (and the bias) through their strides and returns a (B, H, N, 64)
    view of a (B, N, H, 64) tensor, so that `out.transpose(1, 2)` is
    contiguous."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return plain(q, k, v, scale, rel_pos)
    if any(t.device.type != "cuda" for t in (q, k, v)):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}: expected all "
                         "on the CPU or all on one CUDA device")
    _check(q, k, v)
    if rel_pos is not None:
        _check_rel_pos(q, *rel_pos)
    B, H, N, d = q.shape
    out = torch.empty((B, N, H, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in _strides(t)))
    lib = _library.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (0 if q.dtype == torch.float32 else 1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), B, H, N, d, strides, float(scale))
        if rel_pos is None:
            err = lib.flash_attention_forward(*args, stream)
        else:
            bh, bw = rel_pos
            bias_strides = (ctypes.c_longlong * 6)(*bh.stride()[:3], *bw.stride()[:3])
            err = lib.flash_attention_relpos_forward(*args, bh.data_ptr(), bw.data_ptr(),
                                                     bh.shape[-1], bw.shape[-1], bias_strides,
                                                     stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_forward failed with CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
