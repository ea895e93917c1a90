"""RPN head and inference proposal selection (weakcube_tpu/models/rpn.py).

Proposal selection is detectron2's find_top_rpn_proposals with static
shapes: per level, exact top-k by objectness -> decode -> clip -> NMS within
the level; then a global post-NMS top-k into a fixed-size `Proposals`. The
levels of every image run as one padded NMS problem (ops/nms.py).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from ..ops import boxes as box_ops
from ..ops import nms as nms_ops
from ..structures import Proposals
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
