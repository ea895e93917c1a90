"""2D box ops (weakcube_tpu/ops/boxes.py): area, clipping, pairwise IoU and
IoA, matched IoU and GIoU, the detectron2 Box2BoxTransform encode and
decode, and smooth-L1.

Boxes are XYXY float tensors of shape (..., 4). Degenerate boxes give 0 area,
not NaN.
"""
from __future__ import annotations

import math

import torch

_SCALE_CLAMP = math.log(1000.0 / 16.0)  # d2 default delta clamp


def area(boxes: torch.Tensor) -> torch.Tensor:
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    return w * h


def clip_boxes(boxes: torch.Tensor, im_wh: torch.Tensor) -> torch.Tensor:
    """Clip XYXY boxes into [0, W] x [0, H]. im_wh: (..., 2), broadcast
    against boxes' leading dimensions."""
    w, h = im_wh[..., 0:1], im_wh[..., 1:2]
    zero = torch.zeros_like(w)
    x1 = torch.minimum(torch.maximum(boxes[..., 0:1], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1:2], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2:3], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3:4], zero), h)
    return torch.cat([x1, y1, x2, y2], dim=-1)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU; 0 where either box is
    empty. Leading dimensions broadcast (a batch of IoU matrices)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12),
                       torch.zeros_like(inter))


def pairwise_ioa(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) intersection over the area
    of b (ignore-region matching); 0 where b is empty."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    ab = area(b)[..., None, :]
    return torch.where(ab > 0, inter / ab.clamp(min=1e-12), torch.zeros_like(inter))


def _intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # max(., 0) with JAX's subgradient at the tie (1/2 to each side)
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.maximum(rb - lt, torch.zeros_like(rb))
    return wh[..., 0] * wh[..., 1]


def elementwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matched IoU of aligned (..., 4) boxes."""
    inter = _intersection(a, b)
    union = area(a) + area(b) - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12), torch.zeros_like(inter))


def giou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise generalised IoU of aligned (..., 4) boxes."""
    inter = _intersection(a, b)
    union = area(a) + area(b) - inter
    iou = inter / torch.maximum(union, torch.full_like(union, eps))
    lt_c = torch.minimum(a[..., :2], b[..., :2])
    rb_c = torch.maximum(a[..., 2:], b[..., 2:])
    wh_c = torch.maximum(rb_c - lt_c, torch.zeros_like(rb_c))
    area_c = wh_c[..., 0] * wh_c[..., 1]
    return iou - (area_c - union) / torch.maximum(area_c, torch.full_like(area_c, eps))


def giou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - GIoU, torchvision's `generalized_box_iou_loss` unreduced."""
    return 1.0 - giou(pred, target)


def get_deltas(src: torch.Tensor, target: torch.Tensor,
               weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Regression targets (dx, dy, dw, dh) from src to target boxes."""
    sw = src[..., 2] - src[..., 0]
    sh = src[..., 3] - src[..., 1]
    scx = src[..., 0] + 0.5 * sw
    scy = src[..., 1] + 0.5 * sh
    tw = target[..., 2] - target[..., 0]
    th = target[..., 3] - target[..., 1]
    tcx = target[..., 0] + 0.5 * tw
    tcy = target[..., 1] + 0.5 * th
    wx, wy, ww, wh = weights
    sw = sw.clamp(min=1e-6)
    sh = sh.clamp(min=1e-6)
    return torch.stack([wx * (tcx - scx) / sw, wy * (tcy - scy) / sh,
                        ww * torch.log(tw.clamp(min=1e-6) / sw),
                        wh * torch.log(th.clamp(min=1e-6) / sh)], dim=-1)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 0.0) -> torch.Tensor:
    """Elementwise smooth-L1 (fvcore; beta = 0 is L1)."""
    diff = torch.abs(pred - target)
    if beta <= 0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas to boxes; dw/dh clamped as in d2."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=_SCALE_CLAMP)
    dh = (deltas[..., 3] / wh).clamp(max=_SCALE_CLAMP)
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack(
        [pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)
