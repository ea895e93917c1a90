"""3D ROI heads (weakcube_tpu/models/roi_heads.py).

Inference: the box branch pools each proposal (multi-level ROIAlignV2, the
CUDA kernel on the card), runs the FC box head and `fast_rcnn_inference`;
the cube branch pools each detection again and decodes the cube head's
per-class outputs into metric cubes (`decode_cube_predictions`). The
supervised (`ROIHeads3D`) and weak (`ROIHeads3DScore`) heads share it.

Training (`ROIHeads3DScore.forward_train`, the weak recipe): proposals and
GT boxes are matched and subsampled to S slots per image
(`label_and_sample_proposals`, fg first); the box branch takes the Fast
R-CNN losses; the cube branch runs on the fg-capable prefix of the slots
and takes the weak losses of cfg.loss_functions, uncertainty-weighted.
The pooler is differentiable in the features (K1 forward, K1-bwd backward
on the card). Losses not ported yet ('z', 'z_pseudo_gt_patch', 'depth',
'segmentation'), the in-graph RANSAC ground plane and supervised
`ROIHeads3D` training raise NotImplementedError (see ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops import boxes as box_ops
from ..ops import cuboids
from ..ops import losses as loss_ops
from ..ops import roi_align_cuda
from ..ops import rotations
from ..ops import sampling
from ..structures import Detections, GroundTruth, Proposals, SampledRois, match_boxes
from .cube_head import CubeHead
from .fast_rcnn import (FastRCNNConvFCHead, FastRCNNPredictor, fast_rcnn_inference,
                        fast_rcnn_losses, predict_boxes)

SQRT2 = math.sqrt(2.0)
FPN_STRIDES = (4, 8, 16, 32, 64)
# weak losses not ported yet; when they are, 'z' stops the gradient of the
# searched depth and 'depth' that of the GT depth range, as the JAX package
# does (roi_heads.py:454, 508)
NOT_PORTED = ("z", "z_pseudo_gt_patch", "depth", "segmentation")


# ---------------------------------------------------------------- sampling
def label_and_sample_proposals(generator: torch.Generator, proposals: Proposals,
                               gt: GroundTruth, num_classes: int,
                               batch_size_per_image: int, positive_fraction: float,
                               iou_thresholds: Sequence[float],
                               ignore_threshold: float = 0.5,
                               append_gt: bool = True) -> SampledRois:
    """Match RoIs (the proposals, and the GT boxes when append_gt) to GT,
    turn background under ignore regions into ignore, subsample fg and bg
    and pack the chosen RoIs into S = batch_size_per_image slots, fg first
    (by IoU), then bg."""
    if append_gt:
        boxes = torch.cat([proposals.boxes, gt.boxes], 1)
        valid = torch.cat([proposals.valid, gt.is_fg], 1)
    else:
        boxes, valid = proposals.boxes, proposals.valid
    fg_gt = gt.valid & (gt.classes >= 0)
    ign_gt = gt.valid & (gt.classes < 0)
    iou = box_ops.pairwise_iou(gt.boxes, boxes)                    # (B, G, N)
    matched_idx, matched_vals, labels = match_boxes(iou, fg_gt, list(iou_thresholds), [0, 1])
    ioa = torch.where(ign_gt[..., None], box_ops.pairwise_ioa(gt.boxes, boxes),
                      torch.zeros_like(iou))
    in_ignore = torch.amax(ioa, dim=1) >= ignore_threshold
    labels = torch.where((labels == 0) & in_ignore, torch.full_like(labels, -1), labels)
    labels = torch.where(valid, labels, torch.full_like(labels, -1))
    fg_mask, bg_mask = sampling.sample_fg_bg(
        generator, labels == 1, labels == 0, batch_size_per_image, positive_fraction,
        fg_log_weights=torch.log(matched_vals + 1e-4))
    chosen = fg_mask | bg_mask
    # fg first, by IoU; then bg; then the rest (a stable sort of the same
    # float32 key as the JAX package's)
    order_key = torch.where(fg_mask, 0.0, torch.where(bg_mask, 1.0, 2.0)) - 1e-6 * matched_vals
    sel = torch.argsort(order_key, dim=1, stable=True)[:, :batch_size_per_image]
    roi_gt_idx = torch.gather(matched_idx, 1, sel)
    roi_fg = torch.gather(fg_mask, 1, sel)
    classes = torch.where(roi_fg, torch.gather(gt.classes, 1, roi_gt_idx),
                          torch.full_like(roi_gt_idx, num_classes, dtype=gt.classes.dtype))
    return SampledRois(gather_gt(boxes, sel), classes, roi_gt_idx, roi_fg,
                       torch.gather(chosen, 1, sel))


def gather_gt(field: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-RoI rows of a per-image field: (B, G, ...) x (B, S) -> (B, S, ...)."""
    return field[torch.arange(field.shape[0], device=field.device)[:, None], idx]


def fg_prefix_rois(rois: SampledRois, positive_fraction: float) -> SampledRois:
    """The leading int(S * positive_fraction) slots, which hold every fg RoI
    (the sampler caps fg at that count and packs it first): the cube branch
    runs on foreground only."""
    S = rois.boxes.shape[1]
    cap = max(int(S * positive_fraction), 1)
    if cap >= S:
        return rois
    return SampledRois(*(x[:, :cap] for x in rois))


class CubeDecode(NamedTuple):
    x: torch.Tensor            # (B, S) projected 2D centre x (network px)
    y: torch.Tensor
    z: torch.Tensor            # (B, S) metric depth (real space)
    z_norm: torch.Tensor       # pre-transform z
    dims: torch.Tensor         # (B, S, 3) metric w,h,l
    dims_norm: torch.Tensor    # raw head output
    pose: torch.Tensor         # (B, S, 3, 3) egocentric
    pose_allo: torch.Tensor    # (B, S, 3, 3) allocentric (pre-conversion)
    uncert: torch.Tensor       # (B, S)
    cubes: cuboids.Cubes       # (B, S) full cubes (camera space)
    virtual_to_real: torch.Tensor  # (B, S)
    z_cluster_stats: Optional[torch.Tensor] = None  # (B, S, 2) [mean, std]


def decode_cube_predictions(deltas_2d, z_raw, dims_raw, pose_raw, uncert,
                            classes, roi_boxes, K, cfg_head,
                            dims_priors: Optional[torch.Tensor],
                            z_scales: Optional[torch.Tensor] = None,
                            z_stats: Optional[torch.Tensor] = None) -> CubeDecode:
    """Per-class selection + decode to metric cubes.

    Head outputs are (B, S, C, ...); classes (B, S) selects the per-class
    slice. K: (B, 3, 3) at network resolution. z_scales / z_stats:
    (C, bins) / (C, bins, 2) cluster priors when CLUSTER_BINS > 1.
    """
    B, S = classes.shape
    cls = classes.long().clamp(0, deltas_2d.shape[2] - 1)

    def sel(x):
        idx = cls.reshape(B, S, 1, *([1] * (x.dim() - 3)))
        return torch.gather(x, 2, idx.expand(B, S, 1, *x.shape[3:])).squeeze(2)

    d2d = sel(deltas_2d)                    # (B, S, 2)
    dims_norm = sel(dims_raw)               # (B, S, 3)
    pose_allo = sel(pose_raw)               # (B, S, 3, 3)

    assignments = None
    if cfg_head.CLUSTER_BINS > 1 and z_scales is not None:
        # each RoI goes to the closest 2D-scale cluster of its class
        w = roi_boxes[..., 2] - roi_boxes[..., 0]
        h = roi_boxes[..., 3] - roi_boxes[..., 1]
        src_scales = torch.sqrt(w * w + h * h)          # (B, S)
        zs = z_scales[cls]                              # (B, S, bins)
        assignments = torch.argmin(torch.abs(zs - src_scales[..., None]), -1)
        # z_raw is (B, S, bins, C): pick (bin, class)
        bins = z_raw.shape[2]
        z_bc = torch.gather(z_raw, 3, cls[..., None, None].expand(B, S, bins, 1))[..., 0]
        z = torch.gather(z_bc, -1, assignments[..., None])[..., 0]
    elif z_raw.dim() == 3:
        z = sel(z_raw[..., None])[..., 0]
    else:
        z = sel(z_raw)
    unc = (sel(uncert[..., None])[..., 0] if uncert is not None
           else torch.zeros((B, S), device=classes.device))

    w = roi_boxes[..., 2] - roi_boxes[..., 0]
    h = roi_boxes[..., 3] - roi_boxes[..., 1]
    cx = roi_boxes[..., 0] + 0.5 * w
    cy = roi_boxes[..., 1] + 0.5 * h
    x = cx + w * d2d[..., 0]
    y = cy + h * d2d[..., 1]

    if cfg_head.DIMS_PRIORS_ENABLED and dims_priors is not None:
        pri = dims_priors[cls]                          # (B, S, 2, 3)
        mean, std = pri[..., 0, :], pri[..., 1, :]
        if cfg_head.DIMS_PRIORS_FUNC == "sigmoid":
            lo = (mean - 3 * std).clamp(min=0.0)
            hi = mean + 3 * std
            dims = cuboids.scaled_sigmoid(dims_norm, lo, hi)
        else:
            dims = torch.exp(dims_norm.clamp(max=5.0)) * mean
    else:
        dims = torch.exp(dims_norm.clamp(max=5.0))

    # allocentric -> egocentric at the predicted centre
    if cfg_head.ALLOCENTRIC_POSE:
        pose = cuboids.R_from_allocentric(K[:, None], pose_allo, x.detach(), y.detach())
    else:
        pose = pose_allo

    z_norm = z
    if cfg_head.Z_TYPE == "sigmoid":
        z = torch.sigmoid(z) * 100.0
        z_norm = torch.sigmoid(z_norm)
    elif cfg_head.Z_TYPE == "log":
        z = torch.exp(z)
    z_cluster_stats = None
    if cfg_head.Z_TYPE == "clusters" and z_stats is not None \
            and assignments is not None:
        # scaled sigmoid into +-3 sigma of the assigned cluster's depth stats
        stats = z_stats[cls]                            # (B, S, bins, 2)
        stats = torch.gather(stats, 2, assignments[..., None, None].expand(B, S, 1, 2))[:, :, 0]
        z_means, z_stds = stats[..., 0].detach(), stats[..., 1].detach()
        lo = (z_means - 3 * z_stds).clamp(min=0.0)
        hi = z_means + 3 * z_stds
        z = cuboids.scaled_sigmoid(z, lo, hi)
        z_cluster_stats = torch.stack([z_means, z_stds], -1)

    fy = K[:, 1, 1]
    if cfg_head.VIRTUAL_DEPTH:
        v2r = (cfg_head.VIRTUAL_FOCAL / fy.clamp(min=1e-6))[:, None].expand(B, S)
        z = z * v2r
    else:
        v2r = torch.ones((B, S), device=classes.device)

    ctr3d = cuboids.backproject(torch.stack([x, y], -1), z, K[:, None])
    cubes = cuboids.Cubes.from_parts(ctr3d, dims, pose)
    return CubeDecode(x, y, z, z_norm, dims, dims_norm, pose, pose_allo,
                      unc, cubes, v2r, z_cluster_stats)


# ------------------------------------------------------------ weak losses
def iou_projection_loss(gt_boxes, proj_boxes):
    """gIoU loss of the projected cube box against the GT 2D box."""
    return box_ops.giou_loss(gt_boxes, proj_boxes)


def pose_alignment_loss(pose, fg):
    """Pose consistency within an image: the mean over fg pairs of
    1 - |cos relative angle|, averaged over the images with a pair.
    Returns (scalar, whether any image has a pair)."""
    vals, pmask = rotations.so3_relative_angle_pairs(pose, fg, cos_angle=True)
    n_pairs = pmask.sum((-1, -2))
    sums = torch.where(pmask, 1.0 - torch.abs(vals), torch.zeros_like(vals)).sum((-1, -2))
    per_image = sums / n_pairs.clamp(min=1)
    has = n_pairs > 0
    n_img = has.sum()
    total = torch.where(has, per_image, torch.zeros_like(per_image)).sum()
    return total / n_img.clamp(min=1), n_img > 0


def pose_ground_loss(pose, normals):
    """1 - |cos| between the predicted up axis (row 1 of R) and the ground
    normal."""
    pred_up = pose[..., 1, :]
    n = normals[:, None, :]
    den = torch.linalg.norm(pred_up, dim=-1) * torch.linalg.norm(n, dim=-1)
    cos = (pred_up * n).sum(-1) / torch.maximum(den, torch.full_like(den, 1e-8))
    return 1.0 - torch.abs(cos)


def normal_to_rotation(normals):
    """Ground normal -> a rotation whose last row is the normal."""
    x1 = normals.new_tensor([1.0, 0.0, 0.0]).expand_as(normals)
    t0 = torch.linalg.cross(normals, x1, dim=-1)
    small = (t0 * t0).sum(-1, keepdim=True) < 1e-3
    t0 = torch.where(small, torch.linalg.cross(
        normals, normals.new_tensor([0.0, 1.0, 0.0]).expand_as(normals), dim=-1), t0)
    n0 = torch.linalg.norm(t0, dim=-1, keepdim=True)
    t0 = t0 / torch.maximum(n0, torch.full_like(n0, 1e-8))
    t1 = torch.linalg.cross(normals, t0, dim=-1)
    n1 = torch.linalg.norm(t1, dim=-1, keepdim=True)
    t1 = t1 / torch.maximum(n1, torch.full_like(n1, 1e-8))
    return torch.stack([t0, t1, normals], dim=-2)


def pose_ground2_loss(pose, normals):
    """The rotation-matrix variant of pose_ground_loss."""
    return 1.0 - rotations.so3_relative_angle(pose, normal_to_rotation(normals)[:, None],
                                              cos_angle=True)


def sample_depth_at(depth_maps, xy, image_wh):
    """Depth at pixel positions clamped to [10, w - 11] x [10, h - 11]:
    (B, H, W) x (B, S, 2) -> (B, S)."""
    B = depth_maps.shape[0]
    wh = image_wh.expand(B, 2)

    def px(v, hi):
        return torch.minimum(torch.maximum(v, torch.full_like(v, 10.0)),
                             (hi - 11).expand_as(v)).long()
    x = px(xy[..., 0], wh[:, 0:1])
    y = px(xy[..., 1], wh[:, 1:2])
    return depth_maps[torch.arange(B, device=depth_maps.device)[:, None], y, x]


def pseudo_gt_z_point_loss(depth_maps, xy, z, image_wh):
    return torch.abs(z - sample_depth_at(depth_maps, xy, image_wh))


def dims_prior_loss(dims, classes, dims_priors):
    """Hinged z-score of the dims against the class priors: (B, S, 3)."""
    pri = dims_priors[classes.long().clamp(0, dims_priors.shape[0] - 1)]
    mean, std = pri[..., 0, :], pri[..., 1, :]
    score = torch.abs(dims - mean) / std.clamp(min=1e-6)
    return torch.maximum(score - 1.0, torch.zeros_like(score))


def uncert_weight_and_reduce(per_box_losses: Dict[str, torch.Tensor],
                             scalar_losses: Dict[str, torch.Tensor],
                             uncert: torch.Tensor, fg: torch.Tensor,
                             use_confidence: float, weights: Dict[str, float],
                             loss_w_3d: float) -> Dict[str, torch.Tensor]:
    """sqrt(2) exp(-u) weighting, the masked mean over fg, the loss weights,
    and the uncertainty regulariser."""
    sf = SQRT2 * torch.exp(-uncert) if use_confidence > 0 else torch.ones_like(uncert)
    out = {name: loss_ops.masked_mean(l * sf, fg) * weights[name] * loss_w_3d
           for name, l in {**per_box_losses, **scalar_losses}.items()}
    if use_confidence > 0:
        out["Cube/uncert"] = use_confidence * loss_ops.masked_mean(uncert, fg)
    return out


def _buffer(module: nn.Module, name: str, value) -> None:
    module.register_buffer(
        name, None if value is None else torch.as_tensor(np.asarray(value, np.float32)),
        persistent=False)


class ROIHeadsCommon(nn.Module):
    """Shared box branch + cube pooling/decoding; inference forward."""

    def __init__(self, cfg, num_classes: int, in_channels: int = 256,
                 dims_priors=None, z_scales=None, z_stats=None):
        super().__init__()
        self.cfg = cfg
        self.num_classes = num_classes
        rb = cfg.MODEL.ROI_BOX_HEAD
        rc = cfg.MODEL.ROI_CUBE_HEAD
        self.box_head = FastRCNNConvFCHead(
            rb.POOLER_RESOLUTION ** 2 * in_channels, rb.NUM_FC, rb.FC_DIM)
        self.box_predictor = FastRCNNPredictor(rb.FC_DIM, num_classes)
        self.cube_head = CubeHead(
            rc.POOLER_RESOLUTION ** 2 * in_channels, num_classes, rc.NUM_FC,
            rc.FC_DIM, rc.SHARED_FC, rc.POSE_TYPE, rc.CLUSTER_BINS,
            rc.USE_CONFIDENCE)
        # (C, 2, 3) [mean, std] dims priors; (C, bins) / (C, bins, 2) z clusters
        _buffer(self, "dims_priors", dims_priors)
        _buffer(self, "z_scales", z_scales)
        _buffer(self, "z_stats", z_stats)

    def _pool(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor,
              resolution: int) -> torch.Tensor:
        feats = [features[f] for f in self.cfg.MODEL.ROI_HEADS.IN_FEATURES]
        # POOLER_SAMPLING_RATIO=0 (adaptive in detectron2) becomes a fixed 2
        # samples per bin edge; values > 0 are honoured
        sr = self.cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO or 2
        boxes = boxes.to(torch.promote_types(boxes.dtype, torch.float32))  # float64 stays
        return roi_align_cuda.multilevel_roi_align(
            feats, boxes.contiguous(), FPN_STRIDES[:len(feats)], resolution,
            sampling_ratio=sr)

    def _scale_boxes(self, boxes):
        s = self.cfg.MODEL.ROI_CUBE_HEAD.SCALE_ROI_BOXES
        if s and s > 0:
            cx = (boxes[..., 0] + boxes[..., 2]) / 2
            cy = (boxes[..., 1] + boxes[..., 3]) / 2
            w = boxes[..., 2] - boxes[..., 0]
            h = boxes[..., 3] - boxes[..., 1]
            return torch.stack([cx - 0.5 * w * s, cy - 0.5 * h * s,
                                cx + 0.5 * w * s, cy + 0.5 * h * s], -1)
        return boxes

    def forward_box_train(self, features, rois: SampledRois, gt: GroundTruth):
        """Box branch losses on the sampled RoIs, and the predicted boxes of
        the matched class (no gradient)."""
        rb = self.cfg.MODEL.ROI_BOX_HEAD
        scores, deltas = self.box_predictor(self.box_head(
            self._pool(features, rois.boxes, rb.POOLER_RESOLUTION)))
        losses = fast_rcnn_losses(scores, deltas, rois, gather_gt(gt.boxes, rois.gt_idx),
                                  self.num_classes, tuple(rb.BBOX_REG_WEIGHTS),
                                  rb.SMOOTH_L1_BETA)
        pb = predict_boxes(deltas, rois.boxes, self.num_classes, tuple(rb.BBOX_REG_WEIGHTS))
        cls = rois.classes.long().clamp(0, self.num_classes - 1)
        pred_boxes = torch.gather(pb, 2, cls[..., None, None].expand(*cls.shape, 1, 4))[:, :, 0]
        return losses, pred_boxes.detach(), scores, deltas

    def forward_box_inference(self, features, proposals: Proposals, image_wh):
        pooled = self._pool(features, proposals.boxes,
                            self.cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION)
        scores, deltas = self.box_predictor(self.box_head(pooled))
        boxes_pc = predict_boxes(deltas, proposals.boxes, self.num_classes,
                                 tuple(self.cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS))
        return fast_rcnn_inference(
            scores, boxes_pc, proposals, image_wh,
            self.cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
            self.cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
            self.cfg.TEST.DETECTIONS_PER_IMAGE,
            candidate_topk=self.cfg.TEST.NMS_CANDIDATE_TOPK)

    def run_cube_head(self, features, boxes, classes, K) -> CubeDecode:
        rc = self.cfg.MODEL.ROI_CUBE_HEAD
        pooled = self._pool(features, self._scale_boxes(boxes), rc.POOLER_RESOLUTION)
        deltas_2d, z_raw, dims_raw, pose_raw, uncert = self.cube_head(pooled)
        return decode_cube_predictions(deltas_2d, z_raw, dims_raw, pose_raw,
                                       uncert, classes, boxes, K, rc,
                                       self.dims_priors, self.z_scales, self.z_stats)

    def cube_inference(self, features, det: Detections, K) -> Detections:
        """Attach 3D fields to 2D detections."""
        dec = self.run_cube_head(features, det.boxes, det.classes, K)
        conf = torch.exp(-dec.uncert)
        score3d = torch.sqrt((det.scores * conf).clamp(min=0.0))
        return det._replace(centers3D=dec.cubes.centers, dims3D=dec.dims,
                            poses3D=dec.pose,
                            scores3D=torch.where(det.valid, score3d,
                                                 torch.zeros_like(score3d)))

    def forward(self, features, proposals: Proposals, K, image_wh) -> Detections:
        det, _ = self.forward_box_inference(features, proposals, image_wh)
        return self.cube_inference(features, det, K.float())


class ROIHeads3D(ROIHeadsCommon):
    """Fully-supervised head; inference only in this package so far."""

    def forward_train(self, *args, **kwargs):
        raise NotImplementedError("supervised ROIHeads3D training is not ported to "
                                  "PyTorch yet (ROADMAP.md)")


class ROIHeads3DScore(ROIHeadsCommon):
    """Weakly-supervised head: the box branch and a cube branch trained from
    projection and pseudo-GT consistency losses (cfg.loss_functions)."""

    def forward_train(self, features, proposals: Proposals, gt: GroundTruth, K, image_wh,
                      generator: torch.Generator, depth_maps=None, ground_masks=None,
                      ground_valid=None, ground_normals=None, ground_normal_valid=None,
                      instance_masks=None):
        """-> (losses, metrics), two dicts of scalar tensors."""
        cfg = self.cfg
        rc = cfg.MODEL.ROI_CUBE_HEAD
        loss_fns = list(cfg.loss_functions)
        for name in NOT_PORTED:
            if name in loss_fns:
                raise NotImplementedError(f"the weak loss {name!r} is not ported to PyTorch "
                                          "yet (ROADMAP.md)")
        rois = label_and_sample_proposals(
            generator, proposals, gt, self.num_classes,
            cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE, cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION,
            cfg.MODEL.ROI_HEADS.IOU_THRESHOLDS, cfg.MODEL.RPN.IGNORE_THRESHOLD,
            cfg.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT)
        losses, _, _, _ = self.forward_box_train(features, rois, gt)
        all_fg = rois.fg & rois.valid
        B = all_fg.shape[0]
        if rc.LOSS_W_3D == 0:  # 2D-only training: no cube branch
            return losses, {"roi_head/num_fg_samples": all_fg.sum() / B}
        num_bg = (rois.valid & ~rois.fg).sum() / B
        rois = fg_prefix_rois(rois, cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION)
        fg = rois.fg & rois.valid
        dec = self.run_cube_head(features, rois.boxes, rois.classes, K)
        gt_boxes_m = gather_gt(gt.boxes, rois.gt_idx)
        proj_boxes = dec.cubes.to_boxes(K[:, None], image_wh.expand(B, 2)[:, None])

        per_box: Dict[str, torch.Tensor] = {}
        scalar: Dict[str, torch.Tensor] = {}
        weights: Dict[str, float] = {}
        if "iou" in loss_fns:
            per_box["Cube/loss_iou"] = iou_projection_loss(gt_boxes_m, proj_boxes)
            weights["Cube/loss_iou"] = rc.LOSS_W_IOU
        if "pose_alignment" in loss_fns:
            pl, has = pose_alignment_loss(dec.pose, fg)
            scalar["Cube/loss_pose"] = torch.where(has, pl, torch.zeros_like(pl)) \
                * torch.ones_like(dec.z)
            weights["Cube/loss_pose"] = rc.LOSS_W_POSE
        if ("pose_ground" in loss_fns or "pose_ground2" in loss_fns) \
                and (depth_maps is not None or ground_normals is not None):
            if ground_normals is None:
                raise NotImplementedError(
                    "pose_ground without batch['ground_normal'] fits the ground plane by "
                    "RANSAC (ops/plane.py), which is not ported to PyTorch yet (ROADMAP.md)")
            normals = ground_normals.detach()
            gv = ground_normal_valid if ground_normal_valid is not None else \
                torch.ones(normals.shape[0], dtype=torch.bool, device=normals.device)
            conf = torch.where(gv, 1.0, 0.1)[:, None]
            if "pose_ground" in loss_fns:
                per_box["Cube/loss_normal_vec"] = pose_ground_loss(dec.pose, normals) * conf
            else:
                per_box["Cube/loss_normal_vec"] = pose_ground2_loss(dec.pose, normals) * conf
            weights["Cube/loss_normal_vec"] = rc.LOSS_W_NORMAL_VEC
        if depth_maps is not None and "z_pseudo_gt_center" in loss_fns:
            per_box["Cube/loss_pseudo_gt_z"] = pseudo_gt_z_point_loss(
                depth_maps, torch.stack([dec.x, dec.y], -1), dec.z, image_wh)
            weights["Cube/loss_pseudo_gt_z"] = rc.LOSS_W_Z
        if "dims" in loss_fns and self.dims_priors is not None:
            ds = dims_prior_loss(dec.dims, rois.classes, self.dims_priors)
            for i, ax in enumerate("whl"):
                per_box[f"Cube/loss_dims_{ax}"] = ds[..., i]
                weights[f"Cube/loss_dims_{ax}"] = rc.LOSS_W_DIMS
        losses.update(uncert_weight_and_reduce(per_box, scalar, dec.uncert, fg,
                                               rc.USE_CONFIDENCE, weights, rc.LOSS_W_3D))
        # Cube/IoU3D (exact 3D IoU, ops/iou3d.py) is not ported: left out
        metrics = {
            "Cube/2D_IoU": loss_ops.masked_mean(
                box_ops.elementwise_iou(gt_boxes_m, proj_boxes), fg),
            "roi_head/num_fg_samples": all_fg.sum() / B,
            "roi_head/num_bg_samples": num_bg,
        }
        return losses, metrics
