"""RPN head, training labels and losses, and proposal selection
(weakcube_tpu/models/rpn.py).

Training: `label_and_sample_anchors` matches anchors to GT, forces each
GT's best anchor positive, subsamples positives and negatives by IoU-
weighted Gumbel top-k and marks anchors under ignore regions;
`rpn_losses` is the IoUness objectness (BCE toward the matched IoU) and
IoU-weighted L1 box regression, both over BATCH_SIZE_PER_IMAGE * B (B of
the global batch in a data-parallel run).

Proposal selection is detectron2's find_top_rpn_proposals with static
shapes: per level, exact top-k by objectness -> decode -> clip -> NMS within
the level; then a global post-NMS top-k into a fixed-size `Proposals`. The
levels of every image run as one padded NMS problem (ops/nms.py).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import torch
import torch.nn as nn

from ..ops import boxes as box_ops
from ..ops import losses as loss_ops
from ..ops import nms as nms_ops
from ..ops import sampling
from ..parallel.mesh import global_rows
from ..structures import GroundTruth, Proposals, match_boxes
from .layers import Conv2d


class RPNHead(nn.Module):
    """Shared 3x3 conv -> 1x1 objectness + 1x1 deltas, on NHWC levels.
    Outputs are (B, H*W*A) logits and (B, H*W*A, 4) deltas per level, ordered
    (y, x, anchor) like models/anchors.py::grid_anchors."""

    def __init__(self, num_anchors: int, in_channels: int = 256, conv_dim: int = 256):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv = Conv2d(in_channels, conv_dim, 3, 1, 1)
        self.objectness_logits = Conv2d(conv_dim, num_anchors, 1)
        self.anchor_deltas = Conv2d(conv_dim, num_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        logits, regs = [], []
        for f in feats:
            B, H, W, _ = f.shape
            t = torch.relu(self.conv(f.permute(0, 3, 1, 2)))
            logits.append(self.objectness_logits(t).permute(0, 2, 3, 1)
                          .reshape(B, H * W * self.num_anchors))
            regs.append(self.anchor_deltas(t).permute(0, 2, 3, 1)
                        .reshape(B, H * W * self.num_anchors, 4))
        return logits, regs


class RPN(nn.Module):
    """Holds the head under detectron2's `proposal_generator.rpn_head` name."""

    def __init__(self, num_anchors: int, in_channels: int = 256):
        super().__init__()
        self.rpn_head = RPNHead(num_anchors, in_channels)


def select_proposals(anchors_per_level: List[torch.Tensor],
                     logits_per_level: List[torch.Tensor],
                     deltas_per_level: List[torch.Tensor],
                     image_wh: torch.Tensor,
                     pre_nms_topk: int, post_nms_topk: int,
                     nms_thresh: float,
                     box_reg_weights=(1.0, 1.0, 1.0, 1.0)) -> Proposals:
    """anchors (R_l, 4); logits (B, R_l); deltas (B, R_l, 4); image_wh (B, 2)
    or (2,). Scores stay in the logits' dtype; boxes are float32 (the float32
    anchors promote the decode), as in the JAX package."""
    B = logits_per_level[0].shape[0]
    wh = image_wh.float().expand(B, 2)[:, None, :]
    ks = [min(pre_nms_topk, l.shape[1]) for l in logits_per_level]
    L, K = len(ks), max(ks)
    dev = logits_per_level[0].device
    boxes = torch.zeros((B, L, K, 4), device=dev)
    scores = torch.full((B, L, K), nms_ops.NEG_INF, dtype=logits_per_level[0].dtype,
                        device=dev)
    valid = torch.zeros((B, L, K), dtype=torch.bool, device=dev)
    for l, (anchors, logit, delta, k) in enumerate(
            zip(anchors_per_level, logits_per_level, deltas_per_level, ks)):
        top_scores, idx = nms_ops.topk_stable(logit, k)
        d = torch.gather(delta, 1, idx[..., None].expand(B, k, 4))
        b = box_ops.apply_deltas(d, anchors[idx], box_reg_weights)
        boxes[:, l, :k] = box_ops.clip_boxes(b, wh)
        scores[:, l, :k] = top_scores
        valid[:, l, :k] = True
    keep = nms_ops.nms_mask(boxes, scores, nms_thresh, valid)      # (B, L, K)
    scores = torch.where(keep, scores, torch.full_like(scores, nms_ops.NEG_INF))
    # back to the levels-concatenated layout
    cat_boxes = torch.cat([boxes[:, l, :k] for l, k in enumerate(ks)], 1)
    cat_scores = torch.cat([scores[:, l, :k] for l, k in enumerate(ks)], 1)
    cat_keep = torch.cat([keep[:, l, :k] for l, k in enumerate(ks)], 1)
    b, s, v, _ = nms_ops.topk_after_nms(cat_boxes, cat_scores, cat_keep, post_nms_topk)
    return Proposals(boxes=b, scores=s, valid=v)


class RPNLabels(NamedTuple):
    labels: torch.Tensor         # (B, R) in {-1 ignore, 0 bg, 1 fg}
    matched_boxes: torch.Tensor  # (B, R, 4) matched GT box per anchor
    matched_ious: torch.Tensor   # (B, R) IoU with the matched GT


def label_and_sample_anchors(generator: torch.Generator, anchors: torch.Tensor,
                             gt: GroundTruth, batch_size_per_image: int,
                             positive_fraction: float, iou_thresholds: Sequence[float],
                             iou_labels: Sequence[int], ignore_threshold: float) -> RPNLabels:
    """Anchor labels for every image: anchors (R, 4), gt (B, G, ...)."""
    fg_gt = gt.valid & (gt.classes >= 0)                      # (B, G)
    ign_gt = gt.valid & (gt.classes < 0)
    iou = box_ops.pairwise_iou(gt.boxes, anchors[None])      # (B, G, R)
    matched_idx, matched_vals, labels = match_boxes(iou, fg_gt, list(iou_thresholds),
                                                    list(iou_labels))
    # each fg GT's best anchor is kept positive when it clears the fg
    # threshold. An OR over the GTs: the JAX package's duplicate-index .set
    # lets the last writer win, so an invalid GT whose argmax lands on
    # anchor 0 could clear a forced positive there.
    best = torch.argmax(torch.where(fg_gt[..., None], iou, torch.full_like(iou, -1.0)), -1)
    keep = fg_gt & (torch.gather(labels, 1, best) == 1)
    forced = torch.zeros(labels.shape, dtype=torch.uint8, device=labels.device)
    forced = forced.scatter_reduce(1, best, keep.to(torch.uint8), reduce="amax").bool()

    is_pos, is_neg = labels == 1, labels == 0
    log_w = torch.log(matched_vals + 1e-4)
    pos = sampling.gumbel_topk_mask(generator, log_w, is_pos,
                                    int(batch_size_per_image * positive_fraction))
    g = sampling.gumbel(is_neg.shape, generator, is_neg.device) + log_w
    neg_budget = (batch_size_per_image - pos.sum(-1)).clamp(min=0)
    neg = sampling.rank_budget_mask(g, is_neg, neg_budget, batch_size_per_image)

    final = torch.full(labels.shape, -1, dtype=torch.int32, device=labels.device)
    final = torch.where(neg, torch.zeros_like(final), final)
    final = torch.where(pos | forced, torch.ones_like(final), final)
    ioa = torch.where(ign_gt[..., None], box_ops.pairwise_ioa(gt.boxes, anchors[None]),
                      torch.zeros_like(iou))
    in_ignore = torch.amax(ioa, dim=1) >= ignore_threshold
    final = torch.where((final == 0) & in_ignore, torch.full_like(final, -1), final)
    matched = torch.gather(gt.boxes, 1, matched_idx[..., None].expand(*matched_idx.shape, 4))
    return RPNLabels(final, matched, matched_vals)


def rpn_losses(anchors: torch.Tensor, logits: torch.Tensor, deltas: torch.Tensor,
               lab: RPNLabels, batch_size_per_image: int,
               box_reg_weights=(1.0, 1.0, 1.0, 1.0),
               smooth_l1_beta: float = 0.0) -> Dict[str, torch.Tensor]:
    """IoUness RPN losses over all anchors: logits (B, R), deltas (B, R, 4)."""
    B = logits.shape[0]
    fg = lab.labels == 1
    a = anchors.expand_as(lab.matched_boxes)
    iou_t = box_ops.elementwise_iou(a, lab.matched_boxes).detach()
    conf = loss_ops.bce_with_logits(logits, iou_t)
    loss_conf = torch.where(fg, conf * iou_t, torch.zeros_like(iou_t)).sum()
    gt_deltas = box_ops.get_deltas(a, lab.matched_boxes, box_reg_weights)
    reg = box_ops.smooth_l1(deltas, gt_deltas, smooth_l1_beta).sum(-1)
    loss_reg = torch.where(fg, reg * iou_t, torch.zeros_like(iou_t)).sum()
    normalizer = batch_size_per_image * global_rows((B,))[0]
    return {"rpn/cls": loss_conf / normalizer, "rpn/loc": loss_reg / normalizer}
