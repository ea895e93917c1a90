"""Static-shape NMS (weakcube_tpu/ops/nms.py), batched.

`nms_mask` gives greedy NMS keep masks for a batch of problems: the leading
dimensions are written out, so one call runs every (image, level) problem
of a step. CPU tensors take `nms_mask_plain`, the JAX package's fixed point
carried over (weakcube_tpu/ops/nms.py:21-68): the (M, N, N) IoU matrix
computed once, then masked passes until nothing changes, the host checking
convergence once per pass. CUDA tensors launch the kernel of csrc/nms.cu
(one block per problem, no host sync, no IoU matrix in device memory) or
raise; there is no fallback from the card to the plain version. The two give
the same mask bit for bit: greedy NMS is the fixed point's only solution
(the kernel's source note proves it). `nms_mask.launches` counts kernel
launches. The kernel is built at first use with nvcc for sm_90a into
`build/` at the repository root (ops/cuda_build.py) and loaded with ctypes.

Outputs are keep masks; callers take a fixed top-k afterwards. Under a
profiler a call records an `nms` span (utils/trace.py). On the CPU it holds
a `sync` span per convergence check: a fixed point of k passes reads k + 1
checks, the last finding no change. On a card it holds none.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ..utils.trace import span
from .boxes import pairwise_iou
from .cuda_build import CSRC_DIR, KernelLibrary

NEG_INF = -1e10
SOURCE = os.path.join(CSRC_DIR, "nms.cu")
MAX_N = 10240  # = csrc/nms.cu's kMaxN: one problem's boxes in a block's shared memory


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis with ties in index order (as XLA's TopK
    orders them): a stable descending sort, cut at k."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


_library = KernelLibrary(SOURCE, {"nms_forward": (
    [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    ctypes.c_int)})
build = _library.build
__getattr__ = _library.module_attr  # build_log: the compiler's report


def _rank_order(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(M, n) box indices by rank: highest score first, ties in index order,
    invalid boxes scored NEG_INF."""
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    return torch.argsort(-scores, dim=-1, stable=True)


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy NMS keep-mask over the last box axis.

    Args:
      boxes: (..., N, 4) XYXY.
      scores: (..., N).
      iou_threshold: suppress boxes with IoU > threshold against a kept box.
      valid: optional (..., N) bool; invalid boxes are never kept and
        suppress nothing (padding of a ragged batch).
    Returns:
      keep: (..., N) bool mask in the ORIGINAL box order.

    CPU tensors run `nms_mask_plain`; CUDA tensors the kernel (float32 boxes,
    N <= MAX_N), or raise.
    """
    with span("nms"):
        if boxes.device.type == "cpu":
            return nms_mask_plain(boxes, scores, iou_threshold, valid)
        return _kernel(boxes, scores, iou_threshold, valid)


nms_mask.launches = 0


def _kernel(boxes, scores, iou_threshold, valid):
    """csrc/nms.cu on CUDA tensors: one launch, no host sync."""
    if boxes.device.type != "cuda":
        raise ValueError(f"boxes on {boxes.device}: expected CPU or CUDA tensors")
    lead, n = scores.shape[:-1], scores.shape[-1]
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    if boxes.shape != lead + (n, 4) or valid.shape != scores.shape:
        raise ValueError(f"boxes {tuple(boxes.shape)}, scores {tuple(scores.shape)} and "
                         f"valid {tuple(valid.shape)} do not agree on (..., N)")
    if scores.device != boxes.device or valid.device != boxes.device:
        raise ValueError("boxes, scores and valid must lie on one CUDA device")
    if boxes.dtype != torch.float32:
        raise TypeError(f"the NMS kernel takes float32 boxes, got {boxes.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if n > MAX_N:
        raise ValueError(f"the NMS kernel takes at most {MAX_N} boxes per problem, got {n}")
    if n == 0:
        return valid.clone()
    boxes = boxes.reshape(-1, n, 4).contiguous()
    if boxes.data_ptr() % 16:  # the kernel reads a box as one 16-byte vector
        boxes = boxes.clone()
    valid = valid.reshape(-1, n).contiguous()
    order = _rank_order(scores.reshape(-1, n), valid).contiguous()
    keep = torch.empty_like(valid)
    if keep.shape[0]:
        launch(boxes, order, valid, keep, iou_threshold)
    return keep.reshape(lead + (n,))


def launch(boxes, order, valid, keep, iou_threshold: float) -> None:
    """One nms_forward launch on the current stream: (M, n, 4) float32 boxes
    (16-byte aligned), (M, n) int64 rank order, (M, n) bool valid, into
    (M, n) bool keep, all contiguous on one card, M >= 1. Counted in
    `nms_mask.launches`."""
    M, n = keep.shape
    with torch.cuda.device(boxes.device):
        err = _library.load().nms_forward(boxes.data_ptr(), order.data_ptr(), valid.data_ptr(),
                                          keep.data_ptr(), M, n, iou_threshold,
                                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms_forward failed with CUDA error {err}")
    nms_mask.launches += 1


def nms_mask_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`nms_mask` as the JAX package computes it, on tensors of any device:
    the (M, N, N) suppress matrix, then passes to the fixed point, one host
    sync (a `sync` span) per pass and one more. The CPU path of `nms_mask`,
    and the reference the kernel is held to on the card."""
    lead = scores.shape[:-1]
    n = scores.shape[-1]
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    if n == 0:
        return valid.clone()
    boxes = boxes.reshape(-1, n, 4)
    valid = valid.reshape(-1, n)
    order = _rank_order(scores.reshape(-1, n), valid)
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    svalid = torch.gather(valid, 1, order)

    iou = pairwise_iou(sboxes, sboxes)                         # (M, n, n)
    # row j suppresses column i only if j ranks higher (j < i)
    earlier = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    suppress = (iou > iou_threshold) & earlier

    # fixed point: every valid box starts kept; each pass kills the boxes
    # dominated by a currently-kept higher-ranked box. Converges in
    # max-chain-depth passes; each pass is one masked reduction.
    kept, prev, i = svalid, ~svalid, 0
    while i < n:
        changed = (kept != prev).any()
        with span("sync"):  # the host waits for the pass to decide on the next
            changed = bool(changed)
        if not changed:
            break
        killed = (suppress & kept[:, :, None]).any(dim=1)
        prev, kept = kept, svalid & ~killed
        i += 1
    keep = torch.zeros_like(kept).scatter(1, order, kept)
    return keep.reshape(lead + (n,))


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                     idxs: torch.Tensor, iou_threshold: float,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Category-aware NMS: boxes with different `idxs` never suppress each
    other (coordinate-offset trick, one IoU matrix). The offset span is taken
    per problem over the last two axes."""
    if boxes.shape[-2] == 0:
        return torch.zeros(boxes.shape[:-1], dtype=torch.bool,
                           device=boxes.device)
    span = boxes.amax(dim=(-2, -1)) - boxes.amin(dim=(-2, -1)) + 1.0
    offsets = idxs.to(boxes.dtype) * (span[..., None] + 1.0)
    return nms_mask(boxes + offsets[..., None], scores, iou_threshold, valid)


def topk_after_nms(boxes: torch.Tensor, scores: torch.Tensor,
                   keep: torch.Tensor, k: int):
    """Select the top-k kept boxes along the last box axis into fixed (k,)
    slots. Returns (boxes_k, scores_k, valid_k, idx_k); slots beyond the
    number of kept boxes are invalid with score NEG_INF and zero boxes."""
    n = scores.shape[-1]
    if k > n:  # pad so a fixed k works with fewer candidates
        pad = k - n
        lead = scores.shape[:-1]
        boxes = torch.cat([boxes, boxes.new_zeros(lead + (pad, 4))], -2)
        scores = torch.cat([scores, scores.new_full(lead + (pad,), NEG_INF)], -1)
        keep = torch.cat([keep, keep.new_zeros(lead + (pad,))], -1)
    masked = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    top, idx = topk_stable(masked, k)
    valid_k = top > NEG_INF / 2
    picked = torch.gather(boxes, -2, idx[..., None].expand(idx.shape + (4,)))
    boxes_k = torch.where(valid_k[..., None], picked, torch.zeros_like(picked))
    scores_k = torch.where(valid_k, top, torch.full_like(top, NEG_INF))
    return boxes_k, scores_k, valid_k, idx
