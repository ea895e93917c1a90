"""3D ROI heads (weakcube_tpu/models/roi_heads.py).

Inference: the box branch pools each proposal (multi-level ROIAlignV2, the
CUDA kernel on the card), runs the FC box head and `fast_rcnn_inference`;
the cube branch pools each detection again and decodes the cube head's
per-class outputs into metric cubes (`decode_cube_predictions`). The
supervised (`ROIHeads3D`) and weak (`ROIHeads3DScore`) heads share it.

Training. Proposals and GT boxes are matched and subsampled to S slots per
image (`label_and_sample_proposals`, fg first); the box branch takes the
Fast R-CNN losses; with LOSS_W_3D 0 (the recipe's 2D-only pretrain) that is
all. Otherwise the cube branch runs on the fg-capable prefix of the slots.
The weak head (`ROIHeads3DScore`) takes the losses of cfg.loss_functions
(iou, pose_alignment, pose_ground(2), z, z_pseudo_gt_patch or
z_pseudo_gt_center, dims, depth, segmentation), each skipped quietly when
the batch lacks its data, as the JAX package does. The supervised head
(`ROIHeads3D`) takes Cube R-CNN's losses against the GT cubes: the
disentangled corner losses (chamfer or L1 pose) or the normalised-space
ones for each Z_TYPE, the joint corner loss, and INVERSE_Z_WEIGHT. Both
weight them by the predicted uncertainty. The pooler is differentiable in
the features (K1 forward, K1-bwd backward on the card). Without cached
ground normals, pose_ground fits each image's ground plane by RANSAC on the
batch's depth and ground maps (`ground_normals_from_maps`). `Cube/IoU3D` is
the exact matched 3D IoU of the fg RoIs' cubes, computed on metric ticks
only.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops import boxes as box_ops
from ..ops import cuboids
from ..ops import hull as hull_ops
from ..ops import iou3d
from ..ops import losses as loss_ops
from ..ops import plane as plane_ops
from ..ops import roi_align_cuda
from ..ops import rotations
from ..ops import sampling
from ..parallel.mesh import global_rows, global_sum
from ..structures import Detections, GroundTruth, Proposals, SampledRois, match_boxes
from .cube_head import CubeHead
from .fast_rcnn import (FastRCNNConvFCHead, FastRCNNPredictor, fast_rcnn_inference,
                        fast_rcnn_losses, predict_boxes)

SQRT2 = math.sqrt(2.0)
FPN_STRIDES = (4, 8, 16, 32, 64)
# elements of one (RoIs, 64 pairs, MH, MW) soft-hull pass of segment_loss
SEGMENT_CHUNK_ELEMENTS = 1 << 25


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


@torch.no_grad()
def iou3d_train_metric(dec: "CubeDecode", gt: GroundTruth, rois: SampledRois, K, fg,
                       tick: Optional[bool] = None) -> torch.Tensor:
    """The exact matched IoU3D between the GT cubes and the decoded cubes at
    the sampled fg RoIs, averaged over fg (no gradient). `tick` False skips
    the computation and the metric reads NaN (the train step ticks every
    200 steps); None computes it."""
    if tick is not None and not tick:
        return torch.full((), float("nan"), device=fg.device)
    g3d = gather_gt(gt.boxes3D, rois.gt_idx)
    gposes = gather_gt(gt.poses, rois.gt_idx)
    gt_ctr = cuboids.backproject(g3d[..., 0:2], g3d[..., 2], K[:, None])
    gt_corners = cuboids.get_cuboid_verts_3d(torch.cat([gt_ctr, g3d[..., 3:6]], -1), gposes)
    pred_corners = dec.cubes.corners()
    dt = torch.promote_types(pred_corners.dtype, torch.float32)  # float64 stays
    B, S = fg.shape
    iou = iou3d.matched_iou3d(gt_corners.reshape(B * S, 8, 3).to(dt),
                              pred_corners.reshape(B * S, 8, 3).to(dt)).reshape(B, S)
    return loss_ops.masked_mean(iou, fg)


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
    Returns (scalar, whether any image has a pair), both of the global
    batch in a data-parallel run: the loss multiplies a per-RoI weight
    before its mean, so each rank needs the whole value, not a share."""
    vals, pmask = rotations.so3_relative_angle_pairs(pose, fg, cos_angle=True)
    n_pairs = pmask.sum((-1, -2))
    sums = torch.where(pmask, 1.0 - torch.abs(vals), torch.zeros_like(vals)).sum((-1, -2))
    per_image = sums / n_pairs.clamp(min=1)
    has = n_pairs > 0
    n_img = global_sum(has.sum().detach())
    total = global_sum(torch.where(has, per_image, torch.zeros_like(per_image)).sum())
    return total / n_img.clamp(min=1), n_img > 0


def pose_ground_loss(pose, normals):
    """1 - |cos| between the predicted up axis (row 1 of R) and the ground
    normal."""
    pred_up = pose[..., 1, :]
    n = normals[:, None, :]
    den = torch.linalg.norm(pred_up, dim=-1) * torch.linalg.norm(n, dim=-1)
    cos = (pred_up * n).sum(-1) / torch.maximum(den, torch.full_like(den, 1e-8))
    return 1.0 - torch.abs(cos)


def ground_normals_from_maps(generator: Optional[torch.Generator], depth_maps, ground_masks,
                             ground_valid=None, use_nth: int = 5, K=None,
                             num_hypotheses: int = 1000, draws=None) -> torch.Tensor:
    """Per-image up vectors from the depth point clouds by RANSAC, all images
    in one pass: (B, H, W) depth and bool ground masks (all True where an
    image has no ground map), K (B, 3, 3) -> (B, 3) unit normals with the
    wall-flip fixes. The point cloud is rebuilt on the map subsampled by
    `use_nth`, with the focal lengths floor-divided by it and the principal
    point at the subsampled centre. draws (B, H, 3): injected hypothesis
    draws (default: drawn from `generator`). ground_valid is the caller's
    (it weights the loss)."""
    B = depth_maps.shape[0]
    z = depth_maps[:, ::use_nth, ::use_nth]
    m = ground_masks[:, ::use_nth, ::use_nth]
    h, w = z.shape[1], z.shape[2]
    u = torch.arange(w, dtype=z.dtype, device=z.device)[None, None, :]
    v = torch.arange(h, dtype=z.dtype, device=z.device)[None, :, None]
    fx = torch.floor_divide(K[:, 0, 0], use_nth).to(z.dtype)[:, None, None]
    fy = torch.floor_divide(K[:, 1, 1], use_nth).to(z.dtype)[:, None, None]
    x = (u - w / 2.0) * z / fx.clamp(min=1e-6)
    y = (v - h / 2.0) * z / fy.clamp(min=1e-6)
    pts = torch.stack([x, y, z], -1).reshape(B, h * w, 3)
    eq, _ = plane_ops.ransac_plane(pts, m.reshape(B, h * w), 0.05, num_hypotheses,
                                   generator, draws)
    return plane_ops.wall_flip(eq[..., :3])


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
    return loss_ops.absolute(z - sample_depth_at(depth_maps, xy, image_wh))


def dims_prior_loss(dims, classes, dims_priors):
    """Hinged z-score of the dims against the class priors: (B, S, 3)."""
    pri = dims_priors[classes.long().clamp(0, dims_priors.shape[0] - 1)]
    mean, std = pri[..., 0, :], pri[..., 1, :]
    score = loss_ops.absolute(dims - mean) / std.clamp(min=1e-6)
    return torch.maximum(score - 1.0, torch.zeros_like(score))


def box_lattice(boxes, image_wh, grid: int = 32):
    """A grid x grid lattice of cell centres inside each box clipped to the
    image: (B, S, 4) -> x and y (B, S, grid) in pixels."""
    B = boxes.shape[0]
    b = box_ops.clip_boxes(boxes, image_wh.expand(B, 2)[:, None, :])
    gs = (torch.arange(grid, dtype=torch.float32, device=boxes.device) + 0.5) / grid
    xs = b[..., 0:1] + (b[..., 2:3] - b[..., 0:1]) * gs
    ys = b[..., 1:2] + (b[..., 3:4] - b[..., 1:2]) * gs
    return xs, ys, b


def lattice_depth(depth_maps, xs, ys):
    """Depth at the lattice (B, S, g) x (B, S, g) -> (B, S, g * g), y
    major, at the pixels the lattice points fall in."""
    B, H, W = depth_maps.shape
    xi = xs.clamp(0, W - 1).long()
    yi = ys.clamp(0, H - 1).long()
    bi = torch.arange(B, device=depth_maps.device)[:, None, None, None]
    return depth_maps[bi, yi[..., :, None], xi[..., None, :]].flatten(-2)


def masked_median_depth_in_boxes(depth_maps, boxes, image_wh, grid: int = 32):
    """Median depth inside each box over a fixed grid x grid lattice: the
    mean of the middle two of the 1024 samples, as jnp.median takes it
    (torch.median would take the lower one). Zero-area boxes take the depth
    at their centre. No gradient."""
    xs, ys, b = box_lattice(boxes, image_wh, grid)
    med = torch.quantile(lattice_depth(depth_maps, xs, ys), 0.5, dim=-1)
    ctr = torch.stack([(b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3]) / 2], -1)
    return torch.where(box_ops.area(b) > 0, med, sample_depth_at(depth_maps, ctr, image_wh))


def pseudo_gt_z_box_loss(depth_maps, proj_boxes, z, image_wh):
    return loss_ops.absolute(z - masked_median_depth_in_boxes(depth_maps, proj_boxes, image_wh))


def z_area_search_loss(gt_boxes, cubes: cuboids.Cubes, K, image_wh, max_count: int = 50):
    """Area-matched depth search: slide each cube along z in 0.1 m steps
    (towards the camera where its projected box is smaller than the GT
    box, away where larger), take the first step whose projected-box area
    is closest to the GT box's, and penalise |z - z_best| / 2 with z_best's
    gradient stopped; a centre left of or above the GT box by more than
    max_count px costs a flat 0.1 max_count. image_wh (B, 2)."""
    gt_area = box_ops.area(gt_boxes)                                    # (B, S)
    proj = cubes.to_boxes(K[:, None], image_wh[:, None])
    z0 = cubes.centers[..., 2]
    # jnp.linspace(0, (max_count - 1) / 10, max_count): stop * (i / (n - 1))
    dt = torch.promote_types(z0.dtype, torch.float32)
    stop = torch.tensor((max_count - 1) / 10.0, dtype=dt, device=z0.device)
    frac = torch.arange(max_count - 1, dtype=dt, device=z0.device) / (max_count - 1)
    steps = torch.cat([stop * frac, stop[None]])
    sign = torch.where(gt_area < box_ops.area(proj), 1.0, -1.0).to(dt)
    cand_z = z0[..., None] + sign[..., None] * steps                    # (B, S, T)
    ctr = cubes.centers[..., None, :].expand(*cand_z.shape, 3)
    ctr = torch.cat([ctr[..., :2], cand_z[..., None].to(ctr.dtype)], -1)
    cand = cuboids.Cubes.from_parts(
        ctr, cubes.dims[..., None, :].expand(*cand_z.shape, 3),
        cubes.rotations[..., None, :, :].expand(*cand_z.shape, 3, 3))
    cand_area = box_ops.area(cand.to_boxes(K[:, None, None], image_wh[:, None, None]))
    cand_area = torch.where(cand_area == 0, torch.full_like(cand_area, 1e7), cand_area)
    best = torch.argmin(torch.abs(cand_area - gt_area[..., None]), -1)  # the first on ties
    z_best = torch.gather(cand_z, -1, best[..., None])[..., 0]
    loss = loss_ops.absolute(z0 - z_best.detach())
    ctr2d = (proj[..., :2] + proj[..., 2:]) / 2.0
    inside = (ctr2d[..., 0] >= gt_boxes[..., 0] - max_count) & \
             (ctr2d[..., 1] >= gt_boxes[..., 1] - max_count)
    return torch.where(inside, loss, torch.full_like(loss, 0.1 * max_count)) / 2.0


def depth_range_loss(depth_maps, masks, gt_idx, gt_boxes, cubes: cuboids.Cubes, image_wh):
    """|(q90 - q10 of the depth) - the cube's corner-depth extent|: the
    quantiles (linear, as jnp.nanquantile's; gradient stopped) over a 32 x 32 lattice
    in the GT box, at the lattice points inside the RoI's GT instance mask
    (masks (B, G, MH, MW) bool over the image frame, gathered by gt_idx),
    or at every point where masks is None or the mask meets none."""
    corner_z = cubes.corners()[..., 2]
    pred_range = torch.amax(corner_z, -1) - torch.amin(corner_z, -1)   # (B, S)
    xs, ys, _ = box_lattice(gt_boxes, image_wh)
    vals = lattice_depth(depth_maps, xs, ys)                           # (B, S, 1024)
    if masks is not None:
        B, MH, MW = masks.shape[0], masks.shape[-2], masks.shape[-1]
        wh = image_wh.expand(B, 2)
        mx = (xs / wh[:, 0, None, None].clamp(min=1.0) * MW).clamp(0, MW - 1).long()
        my = (ys / wh[:, 1, None, None].clamp(min=1.0) * MH).clamp(0, MH - 1).long()
        bi = torch.arange(B, device=masks.device)[:, None, None, None]
        sel = masks[bi, gt_idx[..., None, None], my[..., :, None], mx[..., None, :]].flatten(-2)
        use_mask = sel.any(-1, keepdim=True)
        vals = torch.where(sel | ~use_mask, vals, torch.full_like(vals, float("nan")))
    gt_range = torch.nanquantile(vals, 0.9, dim=-1) - torch.nanquantile(vals, 0.1, dim=-1)
    return loss_ops.absolute(gt_range.detach() - pred_range)


def segment_loss(masks, gt_idx, bube_corners, image_wh):
    """Per RoI, the mean focal loss of its cube's soft hull (the bube
    corners rescaled into the mask grid) against its GT instance mask
    (masks (B, G, MH, MW) bool over the image frame, gathered by gt_idx):
    sigmoid_focal_loss(8 hull - 4, mask), the original repo's argument swap
    undone (PARITY.md). The RoIs go through the hull in chunks of
    SEGMENT_CHUNK_ELEMENTS, each recomputed in the backward (activation
    checkpointing): all RoIs' (64, MH, MW) pair values at once would take
    3.4 GB in float32 at B 25, S 128, 64 x 64. -> (B, S)."""
    B, S = bube_corners.shape[:2]
    MH, MW = masks.shape[-2:]
    wh = image_wh.expand(B, 2)
    sx = (MW / wh[:, 0].clamp(min=1.0))[:, None, None]
    sy = (MH / wh[:, 1].clamp(min=1.0))[:, None, None]
    corners = torch.stack([bube_corners[..., 0] * sx, bube_corners[..., 1] * sy], -1)
    roi_masks = gather_gt(masks, gt_idx).flatten(0, 1)                 # (B S, MH, MW)
    n = corners.shape[-2]

    def chunk_loss(c, m):
        soft = hull_ops.soft_hull_mask(c, MH, MW)
        return loss_ops.sigmoid_focal_loss(soft * 8.0 - 4.0, m.float()).mean((-2, -1))

    size = max(1, SEGMENT_CHUNK_ELEMENTS // (n * n * MH * MW))
    out = [checkpoint(chunk_loss, c, m, use_reentrant=False)
           for c, m in zip(corners.flatten(0, 1).split(size), roi_masks.split(size))]
    return torch.cat(out).reshape(B, S)


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

    def sample_rois(self, generator, proposals: Proposals, gt: GroundTruth) -> SampledRois:
        rh = self.cfg.MODEL.ROI_HEADS
        return label_and_sample_proposals(
            generator, proposals, gt, self.num_classes, rh.BATCH_SIZE_PER_IMAGE,
            rh.POSITIVE_FRACTION, rh.IOU_THRESHOLDS, self.cfg.MODEL.RPN.IGNORE_THRESHOLD,
            rh.PROPOSAL_APPEND_GT)

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


def chamfer_corner_loss(c, gt_corners):
    """Symmetric chamfer distance between two corner sets (..., 8, 3): the
    mean L1 distance from each corner to the other set's nearest, both
    ways. amin splits a tie between nearest corners evenly, as jnp.min
    does."""
    d = loss_ops.absolute(c[..., :, None, :] - gt_corners[..., None, :, :]).sum(-1)
    return torch.amin(d, -2).mean(-1) + torch.amin(d, -1).mean(-1)


def l1_corner_loss(c, gt_corners):
    return loss_ops.absolute(c - gt_corners).mean((-1, -2))


class ROIHeads3D(ROIHeadsCommon):
    """Fully supervised Cube R-CNN head: the box branch, and a cube branch
    trained against the GT cubes."""

    def forward_train(self, features, proposals: Proposals, gt: GroundTruth, K, image_wh,
                      generator: torch.Generator, metrics_tick=None):
        """-> (losses, metrics), two dicts of scalar tensors."""
        cfg = self.cfg
        rc = cfg.MODEL.ROI_CUBE_HEAD
        rois = self.sample_rois(generator, proposals, gt)
        losses, _, _, _ = self.forward_box_train(features, rois, gt)
        all_fg = rois.fg & rois.valid
        B = global_rows(all_fg.shape)[0]  # the per-image counts are over the global batch
        if rc.LOSS_W_3D == 0:  # 2D-only training: no cube branch
            return losses, {"roi_head/num_fg_samples": all_fg.sum() / B}
        rois = fg_prefix_rois(rois, cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION)
        fg = rois.fg & rois.valid
        dec = self.run_cube_head(features, rois.boxes, rois.classes, K)

        # GT boxes3D: [proj_cx, proj_cy, z, w, h, l, 3D centre]
        g3d = gather_gt(gt.boxes3D, rois.gt_idx)
        gposes = gather_gt(gt.poses, rois.gt_idx)
        gt_2d, gt_z, gt_dims = g3d[..., 0:2], g3d[..., 2], g3d[..., 3:6]
        Kr = K[:, None]
        gt_ctr3d = cuboids.backproject(gt_2d, gt_z, Kr)
        gt_corners = cuboids.get_cuboid_verts_3d(torch.cat([gt_ctr3d, gt_dims], -1), gposes)
        pred_xy = torch.stack([dec.x, dec.y], -1)

        def corners(ctr, dims, pose):
            return cuboids.get_cuboid_verts_3d(torch.cat([ctr, dims], -1), pose)

        per_box: Dict[str, torch.Tensor] = {}
        if rc.DISENTANGLED_LOSS:
            # each loss varies one part of the prediction, GT for the rest
            per_box["Cube/loss_z"] = l1_corner_loss(
                corners(cuboids.backproject(gt_2d, dec.z, Kr), gt_dims, gposes), gt_corners)
            per_box["Cube/loss_xy"] = l1_corner_loss(
                corners(cuboids.backproject(pred_xy, gt_z, Kr), gt_dims, gposes), gt_corners)
            per_box["Cube/loss_dims"] = l1_corner_loss(corners(gt_ctr3d, dec.dims, gposes),
                                                       gt_corners)
            pose_corners = corners(gt_ctr3d, gt_dims, dec.pose)
            per_box["Cube/loss_pose"] = chamfer_corner_loss(pose_corners, gt_corners) \
                if rc.CHAMFER_POSE else l1_corner_loss(pose_corners, gt_corners)
        else:
            # normalised-space losses
            w = rois.boxes[..., 2] - rois.boxes[..., 0]
            h = rois.boxes[..., 3] - rois.boxes[..., 1]
            cxy = torch.stack([rois.boxes[..., 0] + 0.5 * w, rois.boxes[..., 1] + 0.5 * h], -1)
            wh = torch.stack([w.clamp(min=1e-6), h.clamp(min=1e-6)], -1)
            per_box["Cube/loss_xy"] = loss_ops.absolute(
                (pred_xy - cxy) / wh - (gt_2d - cxy) / wh).mean(-1)
            tgt = torch.log(gt_dims.clamp(min=1e-6))
            if rc.DIMS_PRIORS_ENABLED and self.dims_priors is not None:
                # classes clipped by num_classes here, as the JAX package does
                pri = self.dims_priors[rois.classes.long().clamp(0, self.num_classes - 1)]
                tgt = torch.log(gt_dims.clamp(min=1e-6) / pri[..., 0, :].clamp(min=1e-6))
            per_box["Cube/loss_dims"] = loss_ops.absolute(dec.dims_norm - tgt).mean(-1)
            per_box["Cube/loss_pose"] = 1.0 - rotations.so3_relative_angle(dec.pose, gposes,
                                                                           cos_angle=True)
            r2v = 1.0 / dec.virtual_to_real.clamp(min=1e-6)
            if rc.Z_TYPE == "sigmoid":
                tz = (gt_z * r2v / 100.0).clamp(0.0, 1.0)
                per_box["Cube/loss_z"] = loss_ops.absolute(dec.z_norm - tz)
            elif rc.Z_TYPE == "log":
                per_box["Cube/loss_z"] = loss_ops.absolute(
                    dec.z_norm - torch.log((gt_z * r2v).clamp(min=0.01)))
            elif rc.Z_TYPE == "clusters" and dec.z_cluster_stats is not None:
                mu = dec.z_cluster_stats[..., 0]
                sig = dec.z_cluster_stats[..., 1].clamp(min=1e-6)
                per_box["Cube/loss_z"] = loss_ops.absolute(dec.z_norm - (gt_z * r2v - mu) / sig)
            else:  # direct
                per_box["Cube/loss_z"] = loss_ops.absolute(dec.z - gt_z)
        weights = {"Cube/loss_z": rc.LOSS_W_Z, "Cube/loss_xy": rc.LOSS_W_XY,
                   "Cube/loss_dims": rc.LOSS_W_DIMS, "Cube/loss_pose": rc.LOSS_W_POSE}
        if rc.LOSS_W_JOINT > 0:
            joint = corners(cuboids.backproject(pred_xy, dec.z, Kr), dec.dims, dec.pose)
            per_box["Cube/loss_joint"] = chamfer_corner_loss(joint, gt_corners) \
                if rc.CHAMFER_POSE and rc.DISENTANGLED_LOSS else l1_corner_loss(joint, gt_corners)
            weights["Cube/loss_joint"] = rc.LOSS_W_JOINT
        if rc.INVERSE_Z_WEIGHT:
            inv_w = 1.0 / torch.log(gt_z.clamp(min=math.e))
            per_box = {k: v * inv_w for k, v in per_box.items()}
        losses.update(uncert_weight_and_reduce(per_box, {}, dec.uncert, fg, rc.USE_CONFIDENCE,
                                               weights, rc.LOSS_W_3D))
        metrics = {
            "Cube/z_error": loss_ops.masked_mean((dec.z - gt_z).abs().detach(), fg),
            "Cube/dims_error": loss_ops.masked_mean((dec.dims - gt_dims).abs().mean(-1).detach(),
                                                    fg),
            "Cube/IoU3D": iou3d_train_metric(dec, gt, rois, K, fg, tick=metrics_tick),
            "roi_head/num_fg_samples": fg.sum() / B,
        }
        return losses, metrics


class ROIHeads3DScore(ROIHeadsCommon):
    """Weakly-supervised head: the box branch and a cube branch trained from
    projection and pseudo-GT consistency losses (cfg.loss_functions)."""

    def forward_train(self, features, proposals: Proposals, gt: GroundTruth, K, image_wh,
                      generator: torch.Generator, depth_maps=None, ground_masks=None,
                      ground_valid=None, ground_normals=None, ground_normal_valid=None,
                      instance_masks=None, metrics_tick=None):
        """-> (losses, metrics), two dicts of scalar tensors. A loss whose
        data the batch lacks is left out (z_pseudo_gt_patch, z_pseudo_gt_center
        and depth need depth maps, pose_ground depth maps or ground normals,
        segmentation instance masks (B, G, MH, MW)). The RANSAC of
        pose_ground (without ground_normals) draws from `generator` after
        the RoI sampler."""
        cfg = self.cfg
        rc = cfg.MODEL.ROI_CUBE_HEAD
        loss_fns = list(cfg.loss_functions)
        rois = self.sample_rois(generator, proposals, gt)
        losses, _, _, _ = self.forward_box_train(features, rois, gt)
        all_fg = rois.fg & rois.valid
        B = global_rows(all_fg.shape)[0]  # the per-image counts are over the global batch
        if rc.LOSS_W_3D == 0:  # 2D-only training: no cube branch
            return losses, {"roi_head/num_fg_samples": all_fg.sum() / B}
        num_bg = (rois.valid & ~rois.fg).sum() / B
        rois = fg_prefix_rois(rois, cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION)
        fg = rois.fg & rois.valid
        dec = self.run_cube_head(features, rois.boxes, rois.classes, K)
        gt_boxes_m = gather_gt(gt.boxes, rois.gt_idx)
        wh = image_wh.expand(fg.shape[0], 2)
        bube = dec.cubes.bube_corners(K[:, None], wh[:, None])
        proj_boxes = torch.cat([torch.amin(bube, -2), torch.amax(bube, -2)], -1)

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
            if ground_normals is not None:
                # the data pipeline's per-image fit (TPU.CACHE_GROUND_NORMALS)
                normals = ground_normals
                gv = ground_normal_valid if ground_normal_valid is not None else \
                    torch.ones(normals.shape[0], dtype=torch.bool, device=normals.device)
            else:
                gm = ground_masks if ground_masks is not None else \
                    torch.ones(depth_maps.shape, dtype=torch.bool, device=depth_maps.device)
                gv = ground_valid if ground_valid is not None else \
                    torch.ones(depth_maps.shape[0], dtype=torch.bool, device=depth_maps.device)
                normals = ground_normals_from_maps(
                    generator, depth_maps, gm, gv, use_nth=cfg.TPU.RANSAC_USE_NTH, K=K,
                    num_hypotheses=cfg.TPU.RANSAC_HYPOTHESES)
            normals = normals.detach()
            conf = torch.full(gv.shape, 0.1, dtype=torch.promote_types(dec.pose.dtype, torch.float32),
                              device=gv.device).masked_fill(gv, 1.0)[:, None]
            if "pose_ground" in loss_fns:
                per_box["Cube/loss_normal_vec"] = pose_ground_loss(dec.pose, normals) * conf
            else:
                per_box["Cube/loss_normal_vec"] = pose_ground2_loss(dec.pose, normals) * conf
            weights["Cube/loss_normal_vec"] = rc.LOSS_W_NORMAL_VEC
        if "z" in loss_fns:
            per_box["Cube/loss_z"] = z_area_search_loss(gt_boxes_m, dec.cubes, K, wh)
            weights["Cube/loss_z"] = rc.LOSS_W_Z
        if depth_maps is not None and "z_pseudo_gt_patch" in loss_fns:
            per_box["Cube/loss_pseudo_gt_z"] = pseudo_gt_z_box_loss(depth_maps, proj_boxes,
                                                                    dec.z, image_wh)
            weights["Cube/loss_pseudo_gt_z"] = rc.LOSS_W_Z
        elif depth_maps is not None and "z_pseudo_gt_center" in loss_fns:
            per_box["Cube/loss_pseudo_gt_z"] = pseudo_gt_z_point_loss(
                depth_maps, torch.stack([dec.x, dec.y], -1), dec.z, image_wh)
            weights["Cube/loss_pseudo_gt_z"] = rc.LOSS_W_Z
        if "dims" in loss_fns and self.dims_priors is not None:
            ds = dims_prior_loss(dec.dims, rois.classes, self.dims_priors)
            for i, ax in enumerate("whl"):
                per_box[f"Cube/loss_dims_{ax}"] = ds[..., i]
                weights[f"Cube/loss_dims_{ax}"] = rc.LOSS_W_DIMS
        if "depth" in loss_fns and depth_maps is not None:
            per_box["Cube/loss_depth"] = depth_range_loss(depth_maps, instance_masks,
                                                          rois.gt_idx, gt_boxes_m, dec.cubes,
                                                          image_wh)
            weights["Cube/loss_depth"] = rc.LOSS_W_DEPTH
        if "segmentation" in loss_fns and instance_masks is not None:
            per_box["Cube/loss_seg"] = segment_loss(instance_masks, rois.gt_idx, bube, image_wh)
            weights["Cube/loss_seg"] = rc.LOSS_W_SEG
        losses.update(uncert_weight_and_reduce(per_box, scalar, dec.uncert, fg,
                                               rc.USE_CONFIDENCE, weights, rc.LOSS_W_3D))
        metrics = {
            "Cube/2D_IoU": loss_ops.masked_mean(
                box_ops.elementwise_iou(gt_boxes_m, proj_boxes), fg),
            "Cube/IoU3D": iou3d_train_metric(dec, gt, rois, K, fg, tick=metrics_tick),
            "roi_head/num_fg_samples": all_fg.sum() / B,
            "roi_head/num_bg_samples": num_bg,
        }
        return losses, metrics
