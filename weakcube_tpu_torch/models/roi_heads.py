"""3D ROI heads, inference (weakcube_tpu/models/roi_heads.py).

The box branch pools each proposal (multi-level ROIAlignV2, the CUDA kernel
on the card), runs the FC box head and `fast_rcnn_inference`; the cube
branch pools each detection again and decodes the cube head's per-class
outputs into metric cubes (`decode_cube_predictions`). The supervised
(`ROIHeads3D`) and weak (`ROIHeads3DScore`) heads share this inference path;
their training losses are not ported yet.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn

from ..ops import cuboids
from ..ops import roi_align_cuda
from ..structures import Detections, Proposals
from .cube_head import CubeHead
from .fast_rcnn import (FastRCNNConvFCHead, FastRCNNPredictor, fast_rcnn_inference,
                        predict_boxes)

FPN_STRIDES = (4, 8, 16, 32, 64)


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
        pose = cuboids.R_from_allocentric(K[:, None], pose_allo, x, y)
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
        z_means, z_stds = stats[..., 0], stats[..., 1]
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
        return roi_align_cuda.multilevel_roi_align(
            feats, boxes.float().contiguous(), FPN_STRIDES[:len(feats)], resolution,
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


class ROIHeads3DScore(ROIHeadsCommon):
    """Weakly-supervised head; inference only in this package so far."""
