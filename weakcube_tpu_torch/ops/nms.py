"""Static-shape NMS (weakcube_tpu/ops/nms.py), batched.

All boxes are kept; the (N, N) IoU matrix is computed once and greedy NMS is
the fixed point of masked matrix passes (weakcube_tpu/ops/nms.py:21-68).
Here the leading dimensions are a batch written out: one call runs every
(image, level) problem of a step as one padded (M, N, N) suppress matrix, so
the host syncs once per pass and not once per problem. Outputs are keep
masks; callers take a fixed top-k afterwards. Under a profiler a call
records an `nms` span holding a `sync` span per convergence check
(utils/trace.py): a fixed point of k passes reads k + 1 checks, the last
finding no change.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.trace import span
from .boxes import pairwise_iou

NEG_INF = -1e10


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis with ties in index order (as XLA's TopK
    orders them): a stable descending sort, cut at k."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
    """
    with span("nms"):
        lead = scores.shape[:-1]
        n = scores.shape[-1]
        if valid is None:
            valid = torch.ones_like(scores, dtype=torch.bool)
        if n == 0:
            return valid.clone()
        boxes = boxes.reshape(-1, n, 4)
        valid = valid.reshape(-1, n)
        scores = torch.where(valid, scores.reshape(-1, n),
                             torch.full_like(scores.reshape(-1, n), NEG_INF))
        order = torch.argsort(-scores, dim=-1, stable=True)       # descending
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
