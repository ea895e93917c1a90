"""2D box head, predictor, training losses and static-shape inference
(weakcube_tpu/models/fast_rcnn.py)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..ops import boxes as box_ops
from ..ops import losses as loss_ops
from ..ops import nms as nms_ops
from ..structures import Detections, Proposals, SampledRois
from .layers import Linear


class FastRCNNConvFCHead(nn.Module):
    """Flattened pooled features (..., 7, 7, C), in H, W, C order -> fc1..fcN
    with ReLU."""

    def __init__(self, in_dim: int, num_fc: int = 2, fc_dim: int = 1024):
        super().__init__()
        self.num_fc = num_fc
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", Linear(in_dim if i == 0 else fc_dim, fc_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[:-3] + (-1,))
        for i in range(self.num_fc):
            x = torch.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_dim: int, num_classes: int):
        super().__init__()
        self.cls_score = Linear(in_dim, num_classes + 1)
        self.bbox_pred = Linear(in_dim, num_classes * 4)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls_score(x), self.bbox_pred(x)


def fast_rcnn_losses(scores: torch.Tensor, deltas: torch.Tensor, rois: SampledRois,
                     gt_boxes_matched: torch.Tensor, num_classes: int,
                     box_reg_weights=(10.0, 10.0, 5.0, 5.0), smooth_l1_beta: float = 0.0):
    """Masked Fast R-CNN losses over (B, S) sampled RoIs: cross entropy
    averaged over the valid RoIs, and class-specific smooth-L1 summed over
    the fg RoIs over the valid count. gt_boxes_matched: (B, S, 4)."""
    valid = rois.valid
    fg = rois.fg & valid
    labels = torch.where(fg, rois.classes, torch.full_like(rois.classes, num_classes))
    loss_cls = loss_ops.masked_mean(loss_ops.softmax_cross_entropy(scores, labels), valid)
    B, S = labels.shape
    d = deltas.reshape(B, S, num_classes, 4)
    cls = rois.classes.long().clamp(0, num_classes - 1)
    d_fg = torch.gather(d, 2, cls[..., None, None].expand(B, S, 1, 4))[:, :, 0]
    gt_d = box_ops.get_deltas(rois.boxes, gt_boxes_matched, box_reg_weights)
    reg = box_ops.smooth_l1(d_fg, gt_d, smooth_l1_beta).sum(-1)
    loss_reg = torch.where(fg, reg, torch.zeros_like(reg)).sum() / valid.sum().clamp(min=1)
    return {"BoxHead/loss_cls": loss_cls, "BoxHead/loss_box_reg": loss_reg}


def predict_boxes(deltas: torch.Tensor, proposal_boxes: torch.Tensor,
                  num_classes: int, box_reg_weights=(10.0, 10.0, 5.0, 5.0)):
    """Apply per-class deltas: (B, P, 4C) + (B, P, 4) -> (B, P, C, 4)."""
    B, P = proposal_boxes.shape[:2]
    d = deltas.reshape(B, P, num_classes, 4)
    return box_ops.apply_deltas(d, proposal_boxes[:, :, None, :], box_reg_weights)


def fast_rcnn_inference(scores: torch.Tensor, boxes_per_class: torch.Tensor,
                        proposals: Proposals, image_wh: torch.Tensor,
                        score_thresh: float, nms_thresh: float,
                        topk_per_image: int, candidate_topk: int = 1024):
    """Static-shape per-class NMS inference.

    scores: (B, P, C+1) logits, whose dtype the probabilities and detection
    scores keep; boxes_per_class: (B, P, C, 4). Candidates
    are the top `candidate_topk` (roi, class) pairs of each image; those
    above the score threshold enter a class-aware NMS, and the top
    `topk_per_image` survivors become the detections.
    Returns (Detections, roi_sel (B, D)).
    """
    B, P, C1 = scores.shape
    C = C1 - 1
    # jax.nn.softmax step by step, each step rounded to the logits' dtype
    # (a fused softmax rounds once and breaks bf16 ties differently)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    cls_probs = torch.where(proposals.valid[..., None], probs[..., :C],
                            torch.zeros_like(probs[..., :C]))
    flat = cls_probs.reshape(B, P * C)
    k = min(candidate_topk, P * C)
    top_p, flat_idx = nms_ops.topk_stable(flat, k)
    roi_idx = flat_idx // C
    cls_idx = flat_idx % C
    bidx = torch.arange(B, device=scores.device)[:, None]
    wh = image_wh.float().expand(B, 2)[:, None, :]
    cand_boxes = box_ops.clip_boxes(boxes_per_class[bidx, roi_idx, cls_idx], wh)
    # drop non-finite candidates
    finite = torch.isfinite(cand_boxes).all(-1) & torch.isfinite(top_p)
    cand_valid = (top_p > score_thresh) & finite
    keep = nms_ops.batched_nms_mask(cand_boxes, top_p, cls_idx, nms_thresh,
                                    valid=cand_valid)
    bk, sk, vk, sel = nms_ops.topk_after_nms(cand_boxes, top_p, keep, topk_per_image)
    sel = sel.clamp(max=k - 1)  # padded slots (k < topk_per_image) are invalid
    ck = torch.where(vk, torch.gather(cls_idx, 1, sel), torch.full_like(sel, -1))
    roi_sel = torch.gather(roi_idx, 1, sel)
    full = probs[..., :C][bidx, roi_sel]                 # (B, D, C) softmax rows
    det = Detections(boxes=bk, scores=torch.where(vk, sk, torch.zeros_like(sk)),
                     classes=ck, valid=vk, scores_full=full)
    return det, roi_sel
