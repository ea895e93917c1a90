"""Dense, static-shape batch structures (weakcube_tpu/structures.py).

Every collection is a fixed-capacity struct of tensors with a validity mask,
batched over images:

  GroundTruth   (B, G, ...)  padded GT annotations from the data layer
  Proposals     (B, P, ...)  RPN outputs (P = POST_NMS_TOPK)
  SampledRois   (B, S, ...)  matched and subsampled RoIs for the heads
  Detections    (B, D, ...)  final per-image detections

`match_boxes` is detectron2's `Matcher` on a dense quality matrix.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class GroundTruth(NamedTuple):
    """Padded ground truth. classes >= 0 is a category, -1 an ignore region;
    `valid` marks live rows. boxes3D: [proj_cx, proj_cy, z, w, h, l, cx3d,
    cy3d, cz3d]."""

    boxes: torch.Tensor          # (B, G, 4) XYXY at network resolution
    classes: torch.Tensor        # (B, G) int
    valid: torch.Tensor          # (B, G) bool
    boxes3D: Optional[torch.Tensor] = None   # (B, G, 9)
    poses: Optional[torch.Tensor] = None     # (B, G, 3, 3)

    @property
    def is_fg(self):
        return self.valid & (self.classes >= 0)

    @property
    def is_ignore(self):
        return self.valid & (self.classes < 0)


class Proposals(NamedTuple):
    boxes: torch.Tensor          # (B, P, 4)
    scores: torch.Tensor         # (B, P) objectness logits
    valid: torch.Tensor          # (B, P) bool


class SampledRois(NamedTuple):
    """RoIs after matching and subsampling; gt_idx points into the
    GroundTruth rows of the same image, fg marks foreground samples and
    valid the sampled rows."""

    boxes: torch.Tensor          # (B, S, 4)
    classes: torch.Tensor        # (B, S) matched class (num_classes = BG)
    gt_idx: torch.Tensor         # (B, S) int64
    fg: torch.Tensor             # (B, S) bool
    valid: torch.Tensor          # (B, S) bool


class Detections(NamedTuple):
    boxes: torch.Tensor          # (B, D, 4)
    scores: torch.Tensor         # (B, D)
    classes: torch.Tensor        # (B, D)
    valid: torch.Tensor          # (B, D)
    scores_full: Optional[torch.Tensor] = None  # (B, D, C) softmax rows
    # 3D outputs (inference): filled by the cube head
    centers3D: Optional[torch.Tensor] = None    # (B, D, 3)
    dims3D: Optional[torch.Tensor] = None       # (B, D, 3)
    poses3D: Optional[torch.Tensor] = None      # (B, D, 3, 3)
    scores3D: Optional[torch.Tensor] = None     # (B, D) 3D confidence


def match_boxes(iou_matrix: torch.Tensor, gt_valid: torch.Tensor,
                thresholds, labels):
    """detectron2 `Matcher` on a (..., G, R) quality matrix: each column is
    matched to its best valid GT (the first on ties, as jnp.argmax) and
    labelled by the interval of `thresholds` (ascending) its quality falls
    in; `labels` has one value per interval. With no valid GT every column
    is labels[0] with quality 0.
    Returns (matched_idx (..., R), matched_vals (..., R), labels (..., R))."""
    q = torch.where(gt_valid[..., :, None], iou_matrix,
                    torch.full_like(iou_matrix, -1.0))
    matched_idx = torch.argmax(q, dim=-2)
    matched_vals = torch.amax(q, dim=-2)
    match_labels = torch.full(matched_vals.shape, labels[0], dtype=torch.int32,
                              device=q.device)
    for lo, lab in zip(thresholds, labels[1:]):
        match_labels = torch.where(matched_vals >= lo,
                                   torch.full_like(match_labels, lab), match_labels)
    any_gt = gt_valid.any(-1, keepdim=True)
    match_labels = torch.where(any_gt, match_labels, torch.full_like(match_labels, labels[0]))
    matched_vals = torch.where(any_gt, matched_vals.clamp(min=0.0),
                               torch.zeros_like(matched_vals))
    return matched_idx, matched_vals, match_labels
