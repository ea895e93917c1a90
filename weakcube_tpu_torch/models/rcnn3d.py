"""Meta-architectures RCNN3D (supervised) and RCNN3D_combined_features
(weak), their inference and training forwards, and the registry-driven
`build_model` (weakcube_tpu/models/rcnn3d.py).

The model is a function of a padded batch dict: "image" (B, H, W, 3) uint8
(normalised here) or float32 (already normalised), "image_wh" (B, 2) and "K"
(B, 3, 3). In training mode (`model.train()`) it also takes "gt" (a
GroundTruth), optionally "rpn_labels" (precomputed RPNLabels), and for the
weak heads "depth_map" (B, H, W) float16 or float32, "ground_mask" (B, H, W)
bool, "ground_valid" (B,), "ground_normal" (B, 3) and "ground_normal_valid"
(B,), and "metrics_tick" (a bool: whether to compute the costly metrics;
absent, they are computed); it returns (losses, metrics). Module names follow the reference's
detectron2 state dict (backbone.*, proposal_generator.rpn_head.*,
roi_heads.*).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..structures import Detections, Proposals
from . import anchors as anchor_lib
from . import rpn as rpn_lib
from .backbone.build import build_backbone
from .layers import Conv2d, Linear
from .roi_heads import ROIHeads3D, ROIHeads3DScore

META_ARCH_REGISTRY: Dict[str, Callable] = {}


def register_meta_arch(name):
    def deco(cls):
        META_ARCH_REGISTRY[name] = cls
        return cls
    return deco


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for the CPU: with no device given
    this is the current card (a data-parallel rank's own), and it raises
    where there is no GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run "
                           "on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@register_meta_arch("RCNN3D")
class RCNN3D(nn.Module):
    """Backbone + RPN + 3D ROI heads over a static padded batch."""

    roi_heads_cls = ROIHeads3D

    def __init__(self, cfg, dims_priors=None, z_scales=None, z_stats=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = build_backbone(cfg, dtype)
        fpn_ch = cfg.MODEL.FPN.OUT_CHANNELS
        self.proposal_generator = rpn_lib.RPN(
            len(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]), fpn_ch)
        self.roi_heads = self.roi_heads_cls(
            cfg, cfg.MODEL.ROI_HEADS.NUM_CLASSES, fpn_ch, dims_priors, z_scales, z_stats)
        self.register_buffer("pixel_mean", torch.tensor(cfg.MODEL.PIXEL_MEAN), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.MODEL.PIXEL_STD), persistent=False)
        self._anchors: Dict[tuple, list] = {}

    def _prep_image(self, image: torch.Tensor) -> torch.Tensor:
        """(x - PIXEL_MEAN) / PIXEL_STD (BGR order) for uint8 pixels; float
        input is taken as already normalised."""
        if image.dtype == torch.uint8:
            image = (image.float() - self.pixel_mean) / self.pixel_std
        return image

    def _level_anchors(self, feats):
        cfg = self.cfg
        shapes = tuple(tuple(f.shape[1:3]) for f in feats)
        key = (shapes, feats[0].device)
        if key not in self._anchors:
            strides = [self.backbone.STRIDES[f] for f in cfg.MODEL.RPN.IN_FEATURES]
            self._anchors[key] = anchor_lib.pyramid_anchors(
                shapes, strides, cfg.MODEL.ANCHOR_GENERATOR.SIZES,
                cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS,
                cfg.MODEL.ANCHOR_GENERATOR.OFFSET, device=feats[0].device)
        return self._anchors[key]

    def _proposals_from_feats(self, feats_dict, batch) -> Proposals:
        cfg = self.cfg
        feats = [feats_dict[f] for f in cfg.MODEL.RPN.IN_FEATURES]
        logits, deltas = self.proposal_generator.rpn_head(feats)
        return rpn_lib.select_proposals(
            self._level_anchors(feats), logits, deltas, batch["image_wh"],
            cfg.MODEL.RPN.PRE_NMS_TOPK_TEST, cfg.MODEL.RPN.POST_NMS_TOPK_TEST,
            cfg.MODEL.RPN.NMS_THRESH, tuple(cfg.MODEL.RPN.BBOX_REG_WEIGHTS))

    def _rpn_train(self, feats_dict, batch, generator):
        """RPN losses (scaled by RPN.LOSS_WEIGHT) and the training
        proposals, selected from logits and deltas without gradient."""
        rc = self.cfg.MODEL.RPN
        feats = [feats_dict[f] for f in rc.IN_FEATURES]
        logits, deltas = self.proposal_generator.rpn_head(feats)
        anchors_lvl = self._level_anchors(feats)
        anchors = torch.cat(anchors_lvl, 0)
        lab = batch.get("rpn_labels")
        if lab is None:
            lab = rpn_lib.label_and_sample_anchors(
                generator, anchors, batch["gt"], rc.BATCH_SIZE_PER_IMAGE,
                rc.POSITIVE_FRACTION, rc.IOU_THRESHOLDS, [0, -1, 1], rc.IGNORE_THRESHOLD)
        losses = rpn_lib.rpn_losses(anchors, torch.cat(logits, 1), torch.cat(deltas, 1), lab,
                                    rc.BATCH_SIZE_PER_IMAGE, tuple(rc.BBOX_REG_WEIGHTS),
                                    rc.SMOOTH_L1_BETA)
        proposals = rpn_lib.select_proposals(
            anchors_lvl, [l.detach() for l in logits], [d.detach() for d in deltas],
            batch["image_wh"], rc.PRE_NMS_TOPK_TRAIN, rc.POST_NMS_TOPK_TRAIN,
            rc.NMS_THRESH, tuple(rc.BBOX_REG_WEIGHTS))
        return {k: v * rc.LOSS_WEIGHT for k, v in losses.items()}, proposals

    def _roi_extra(self, batch) -> dict:
        return {}

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Union[Detections, Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]:
        """Eval mode: Detections. Training mode: (losses, metrics), with the
        anchor and RoI samples drawn from `generator` (on the batch's
        device)."""
        feats = self.backbone(self._prep_image(batch["image"]))
        if not self.training:
            proposals = self._proposals_from_feats(feats, batch)
            return self.roi_heads(feats, proposals, batch["K"], batch["image_wh"])
        rpn_losses, proposals = self._rpn_train(feats, batch, generator)
        losses, metrics = self.roi_heads.forward_train(
            feats, proposals, batch["gt"], batch["K"], batch["image_wh"], generator,
            metrics_tick=batch.get("metrics_tick"), **self._roi_extra(batch))
        losses.update(rpn_losses)
        return losses, metrics


@register_meta_arch("RCNN3D_combined_features")
class RCNN3DCombinedFeatures(RCNN3D):
    """Weak meta-arch. At inference it is RCNN3D with the weak heads; the
    depth / ground-map inputs only feed the training losses."""

    roi_heads_cls = ROIHeads3DScore

    def _roi_extra(self, batch) -> dict:
        dm = batch.get("depth_map")
        return dict(depth_maps=None if dm is None else dm.float(),
                    ground_masks=batch.get("ground_mask"),
                    ground_valid=batch.get("ground_valid"),
                    ground_normals=batch.get("ground_normal"),
                    ground_normal_valid=batch.get("ground_normal_valid"),
                    instance_masks=batch.get("instance_masks"))


# initial weights that differ from the fan-in normal (the JAX modules'
# kernel_init / bias_init): name suffix -> (weight std, bias value)
_HEAD_INIT = {
    "box_predictor.cls_score": (0.01, 0.0),
    "box_predictor.bbox_pred": (0.001, 0.0),
    "cube_head.bbox_3D_center_deltas": (0.001, 0.0),
    "cube_head.bbox_3D_dims": (0.001, 0.0),
    "cube_head.bbox_3D_pose": (0.001, 0.0),
    "cube_head.bbox_3D_center_depth": (0.001, 1.0),
    "cube_head.bbox_3D_uncertainty": (0.001, 5.0),
}


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from `generator`: conv and linear weights normal with
    std 1/sqrt(fan_in) (the head outputs as in _HEAD_INIT), biases 0,
    BatchNorm at identity statistics."""
    for name, m in model.named_modules():
        if not isinstance(m, (Conv2d, Linear)):
            continue
        std, bias = next((v for k, v in _HEAD_INIT.items() if name.endswith(k)),
                         (1.0 / np.sqrt(m.weight[0].numel()), 0.0))
        m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
        if m.bias is not None:
            m.bias.fill_(bias)


def build_model(cfg, priors: Optional[dict] = None, device=None, seed: int = 0,
                dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Build the configured meta-arch with random weights from `seed`, in
    eval mode on `device` (the card unless device='cpu').

    priors: dict with 'priors_dims_per_cat' (C, 2, 3), and 'priors_z_scales'
    / 'priors_z_stats' when CLUSTER_BINS > 1 (or None to disable priors).
    dtype: compute dtype; default cfg.TPU.COMPUTE_DTYPE. Parameters stay
    float32.
    """
    dev = resolve_device(device)
    name = cfg.MODEL.META_ARCHITECTURE
    if name not in META_ARCH_REGISTRY:
        raise KeyError(f"Unknown meta arch {name}; known: {sorted(META_ARCH_REGISTRY)}")
    if dtype is None:
        dtype = torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32
    dims_priors = z_scales = z_stats = None
    if priors is not None and cfg.MODEL.ROI_CUBE_HEAD.DIMS_PRIORS_ENABLED:
        dims_priors = priors["priors_dims_per_cat"]
    if priors is not None and cfg.MODEL.ROI_CUBE_HEAD.CLUSTER_BINS > 1:
        z_scales = priors["priors_z_scales"]
        z_stats = priors["priors_z_stats"]
    model = META_ARCH_REGISTRY[name](cfg, dims_priors, z_scales, z_stats, dtype)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval().requires_grad_(False)
