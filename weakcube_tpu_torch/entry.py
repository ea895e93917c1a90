"""Entry points of the PyTorch package.

entry()           -> (fn, (model, batch)): the flagship model (Weak Cube
                     R-CNN, DLA34-FPN) at the small size of the JAX package's
                     __graft_entry__.entry(), and its inference forward.
flagship_cfg()    -> the full-width flagship configuration
                     (configs/Omni_combined.yaml: DLA-34, FPN 256, 38 classes,
                     bf16 compute), for inference and training alike (its
                     solver: SGD, BASE_LR 0.015, IMS_PER_BATCH 25; the four
                     weak losses).
make_batch()      -> an inference batch made from a numpy seed.
tiny_batch()      -> a training batch (GT boxes, depth and ground maps, ground
                     normals) made from a numpy seed, key for key the JAX
                     package's __graft_entry__._tiny_batch.

Everything runs on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .config import get_cfg
from .models.rcnn3d import build_model, resolve_device
from .structures import GroundTruth

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs")


def tiny_cfg(image_size=128, num_classes=5, dla=False):
    """The JAX package's __graft_entry__._tiny_cfg, key for key."""
    cfg = get_cfg()
    cfg.MODEL.META_ARCHITECTURE = "RCNN3D_combined_features"
    cfg.MODEL.ROI_HEADS.NAME = "ROIHeads3DScore"
    if dla:
        cfg.MODEL.BACKBONE.NAME = "build_dla_from_vision_fpn_backbone"
        cfg.MODEL.DLA.TYPE = "dla34"
    else:
        cfg.MODEL.BACKBONE.NAME = "build_resnet_from_vision_fpn_backbone"
        cfg.MODEL.RESNETS.DEPTH = 18
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = num_classes
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 32
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 128
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 64
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 128
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 64
    cfg.TEST.DETECTIONS_PER_IMAGE = 8
    cfg.TPU.IMAGE_SIZE = image_size
    cfg.TPU.MAX_GT_PER_IMAGE = 8
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.loss_functions = ["iou", "z_pseudo_gt_center", "pose_alignment",
                          "pose_ground", "dims"]
    cfg.freeze()
    return cfg


def flagship_cfg(image_size: int = 512):
    """configs/Omni_combined.yaml (over Base_Omni3D.yaml and Base.yaml) at
    a square `image_size` canvas."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(CONFIG_DIR, "Omni_combined.yaml"))
    cfg.TPU.IMAGE_SIZE = image_size
    cfg.freeze()
    return cfg


def dims_priors(num_classes: int) -> dict:
    """The per-class dims priors of __graft_entry__.entry(): mean 0.8 m and
    std 0.3 m for every class."""
    return {"priors_dims_per_cat": np.tile(
        np.array([[[0.8, 0.8, 0.8], [0.3, 0.3, 0.3]]], np.float32),
        (num_classes, 1, 1))}


def make_batch(B: int, H: int, W: int, seed: int = 0, device=None) -> dict:
    """uint8 images (B, H, W, 3), image_wh (B, 2) and pinhole K (B, 3, 3)
    with f = 100 px at the canvas centre, from a numpy seed."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    K = np.tile(np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]],
                         np.float32), (B, 1, 1))
    return {
        "image": torch.from_numpy(rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)).to(dev),
        "image_wh": torch.tensor([[W, H]] * B, dtype=torch.float32, device=dev),
        "K": torch.from_numpy(K).to(dev),
    }


def tiny_batch(B: int, H: int, W: int, G: int = 8, seed: int = 0, device=None) -> dict:
    """A training batch from a numpy seed, key for key the JAX package's
    __graft_entry__._tiny_batch (the same draws in the same order):
    float32 normalised images, image_wh, K (f = 100 px at the centre), a
    GroundTruth of G rows (the first 4 valid, classes 0..4, identity
    poses), float16 depth maps, a bool ground mask, ground_valid, and unit
    ground normals with ground_normal_valid."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    K = np.tile(np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]],
                         np.float32), (B, 1, 1))
    x1 = rng.uniform(5, W - 40, (B, G))
    y1 = rng.uniform(5, H - 40, (B, G))
    w = rng.uniform(16, 40, (B, G))
    h = rng.uniform(16, 40, (B, G))
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    z = rng.uniform(2, 8, (B, G))
    dims = rng.uniform(0.3, 1.5, (B, G, 3))
    cx, cy = x1 + w / 2, y1 + h / 2
    boxes3D = np.concatenate([np.stack([cx, cy, z], -1), dims,
                              np.stack([z * (cx - W / 2) / 100.0, z * (cy - H / 2) / 100.0, z],
                                       -1)], -1).astype(np.float32)
    classes = rng.integers(0, 5, (B, G)).astype(np.int32)
    image = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    depth = rng.uniform(1, 10, (B, H, W)).astype(np.float16)
    n = rng.normal(size=(B, 3)).astype(np.float32)
    n[:, 1] = np.abs(n[:, 1]) + 1.0
    n = n / np.linalg.norm(n, axis=1, keepdims=True)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    gt = GroundTruth(boxes=t(boxes), classes=t(classes).long(),
                     valid=t(np.tile(np.arange(G) < 4, (B, 1))), boxes3D=t(boxes3D),
                     poses=t(np.tile(np.eye(3, dtype=np.float32), (B, G, 1, 1))))
    return {"image": t(image), "image_wh": t(np.tile([[W, H]], (B, 1)).astype(np.float32)),
            "K": t(K), "gt": gt, "depth_map": t(depth),
            "ground_mask": torch.ones((B, H, W), dtype=torch.bool, device=dev),
            "ground_valid": torch.ones((B,), dtype=torch.bool, device=dev),
            "ground_normal": t(n),
            "ground_normal_valid": torch.ones((B,), dtype=torch.bool, device=dev)}


def entry(device=None):
    """Inference forward of the flagship model at the small size of the JAX
    package's __graft_entry__.entry()."""
    cfg = tiny_cfg(image_size=256, dla=True)
    model = build_model(cfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), device)
    batch = make_batch(1, 256, 256, device=device)

    def fn(model, batch):
        with torch.inference_mode():
            det = model(batch)
        return det.boxes, det.scores3D, det.centers3D

    return fn, (model, batch)
