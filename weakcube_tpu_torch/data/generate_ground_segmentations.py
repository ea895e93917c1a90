#!/usr/bin/env python
"""Generate the ground-segmentation pseudo-GT artefacts on the GPU
(weakcube_tpu/data/generate_ground_segmentations.py): datasets/ground_maps/
{image_id}.npz (bool `ground`, the image's height x width) and the ids
without a ground map appended to datasets/no_ground_idx.csv, which the
dataset loader and the mapper's cached ground normals read.

Methods:
  * depth-ransac (the default): the inliers of the best up-facing RANSAC
    plane of the depth map's point cloud (ops/plane.py::ransac_plane on the
    card), from the depth maps that generate_depth_maps.py writes;
  * foundation: GroundingDINO ("ground." prompt) -> the box with the largest
    logit -> SAM-HQ on that box, from the released checkpoints
    (--gdino-ckpt groundingdino_swint_ogc.pth, --sam-ckpt sam_hq_vit_*.pth).
    `sam_masks` is the SAM half for one batch of images and their boxes:
    uint8 host images in, bool host masks of each image's size out.

  python -m weakcube_tpu_torch.data.generate_ground_segmentations --synthetic 8 \\
      --out /tmp/ground_maps --artifacts-root /tmp
  python -m weakcube_tpu_torch.data.generate_ground_segmentations \\
      --config-file configs/Omni_combined.yaml --depth-dir datasets/depth_maps
  python -m weakcube_tpu_torch.data.generate_ground_segmentations --method foundation \\
      --gdino-ckpt groundingdino_swint_ogc.pth --sam-ckpt sam_hq_vit_l.pth

Everything runs on the card unless `--device cpu` (or device="cpu") is
given. The RANSAC draws of image i come from a CPU generator seeded with
i (or from `draws`), so the card and the CPU draw the same.
"""
from __future__ import annotations

import argparse
import csv
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.rcnn3d import resolve_device
from ..ops.plane import ransac_plane
from ..utils.trace import span
from .datasets import read_image
from .pseudo_gt import sam as sam_mod
from .pseudo_gt.grounding_dino import GroundingDINO, predict_ground_boxes

MIN_MASK_PX = 1000        # the reference's threshold (:193-199)
NUM_HYPOTHESES = 1000
# bert-base-uncased wordpiece ids of the reference's prompt "ground."
GROUND_PROMPT_TOKENS = [101, 2598, 1012, 102]  # [CLS] ground . [SEP]
PROMPT_LEN = 16
BOX_THRESHOLD = 0.35      # the reference's thresholds (:157-164)
TEXT_THRESHOLD = 0.25
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


def ransac_points(depth: np.ndarray, K: np.ndarray, use_nth: int = 4):
    """The stride-`use_nth` point cloud of a depth map with the principal
    point at the image centre, as the JAX package builds it (numpy, float64,
    then float32): (points (N, 3) float32, lower band (N,) bool, (h, w))."""
    z = depth[::use_nth, ::use_nth]
    h, w = z.shape
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    fx, fy = K[0, 0] / use_nth, K[1, 1] / use_nth
    x = (u - w / 2) * z / max(fx, 1e-6)
    y = (v - h / 2) * z / max(fy, 1e-6)
    pts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    # sampling biased toward the lower part of the image, where ground lives
    return pts, (v >= h * 0.4).ravel(), (h, w)


def ground_from_depth_ransac(depth: np.ndarray, K: np.ndarray, draws=None,
                             generator: Optional[torch.Generator] = None, device=None,
                             use_nth: int = 4, thresh: float = 0.08) -> np.ndarray:
    """Ground mask (H, W) bool = the inliers of the best up-facing RANSAC
    plane, upsampled by repetition (np.kron). draws: (1000, 3) indices into
    the stride-4 points (else drawn from `generator`, on the CPU)."""
    dev = resolve_device(device)
    H, W = depth.shape
    pts, lower, (h, w) = ransac_points(depth, K, use_nth)
    if draws is None:
        draws = torch.randint(0, len(pts), (NUM_HYPOTHESES, 3), generator=generator)
    eq, inl = ransac_plane(torch.from_numpy(pts).to(dev), torch.from_numpy(lower).to(dev),
                           thresh, NUM_HYPOTHESES, draws=torch.tensor(np.asarray(draws)).to(dev))
    n = eq[:3].cpu().numpy()
    if abs(n[1]) < max(abs(n[0]), abs(n[2])):  # accept only roughly up-facing planes
        return np.zeros((H, W), bool)
    mask_small = inl.cpu().numpy().reshape(h, w)
    return np.kron(mask_small, np.ones((use_nth, use_nth), bool))[:H, :W]


def _default_image_loader(record):
    return read_image(record["file_name"], record=record)


def prompt_tokens(device) -> tuple:
    """The 'ground.' prompt, padded to PROMPT_LEN: (token ids, token mask)."""
    tokens = torch.tensor([GROUND_PROMPT_TOKENS + [0] * (PROMPT_LEN - len(GROUND_PROMPT_TOKENS))],
                          device=device)
    return tokens, tokens > 0


def sam_masks(sam: sam_mod.Sam, images: Sequence[np.ndarray],
              boxes_xyxy: Sequence[np.ndarray]) -> List[np.ndarray]:
    """One batch of the SAM half of the foundation method: (H, W, 3) uint8
    host images (numpy arrays or tensors) and one XYXY box per image, in
    that image's pixels -> each image's (H, W) bool mask on the host.

    preprocess_sam on the host (PIL's BILINEAR resize of the longest side
    to the model's img_size, padding, SAM's pixel statistics) and the copy
    to the model's device; Sam.forward under inference_mode, each box scaled
    to the resized image (SAM's IMG_SIZE space); the low-resolution mask
    logits thresholded at 0 on the device and copied to the host; each
    (S/4, S/4) mask resized to its image by PIL's NEAREST, as the JAX
    package does. Its spans (utils/trace.py): sam.batch around the whole,
    holding sam.preprocess, sam.encoder and sam.decoder (the forward) and
    sam.masks_out in order."""
    from PIL import Image
    dev = next(sam.parameters()).device
    images = [np.asarray(img) for img in images]
    scale = np.array([sam_mod.IMG_SIZE / max(img.shape[:2]) for img in images], np.float32)
    boxes = np.asarray(boxes_xyxy, np.float32).reshape(len(images), 4) * scale[:, None]
    with span("sam.batch"):
        with span("sam.preprocess"):
            x = torch.from_numpy(sam_mod.preprocess_sam(images, sam.img_size)).to(dev)
        with torch.inference_mode():
            logits = sam(x, torch.from_numpy(boxes).to(dev)[:, None])
        with span("sam.masks_out"):
            low = (logits[:, 0] > 0).cpu().numpy()
            return [np.asarray(Image.fromarray(m.astype(np.uint8) * 255).resize(
                (img.shape[1], img.shape[0]), Image.NEAREST)) > 127
                for m, img in zip(low, images)]


def foundation_ground_mask(gdino: GroundingDINO, sam: sam_mod.Sam, image: np.ndarray,
                           box_threshold: float = BOX_THRESHOLD, gdino_side: int = 768,
                           stats: Optional[Dict[str, list]] = None) -> np.ndarray:
    """One image through GroundingDINO('ground.') -> the box with the
    largest logit -> SAM-HQ -> a NEAREST resize of the mask to the image
    (an empty mask when no box clears box_threshold). The resizes run on the
    host with PIL, as the JAX package's. stats: lists of gdino_ms / sam_ms
    per image, appended to when given."""
    from PIL import Image
    dev = next(gdino.parameters()).device
    H, W = image.shape[:2]
    side = gdino_side
    g_in = np.asarray(Image.fromarray(image.astype(np.uint8)).resize((side, side), Image.BILINEAR),
                      np.float32) / 255.0
    g_in = torch.from_numpy(((g_in - _MEAN) / _STD)[None]).to(dev)
    tokens, tmask = prompt_tokens(dev)
    t0 = time.perf_counter()
    boxes, scores = predict_ground_boxes(gdino, g_in, tokens, tmask)
    best = int(torch.argmax(scores[0]))
    score, box = float(scores[0, best]), boxes[0, best].float().cpu().numpy()
    if stats is not None:
        stats.setdefault("gdino_ms", []).append((time.perf_counter() - t0) * 1e3)
    if score < box_threshold:
        return np.zeros((H, W), bool)
    cx, cy, bw, bh = box
    # cxcywh normalised -> XYXY in the image's pixels
    box_xyxy = np.array([(cx - bw / 2) * W, (cy - bh / 2) * H,
                         (cx + bw / 2) * W, (cy + bh / 2) * H], np.float32)
    t0 = time.perf_counter()
    mask = sam_masks(sam, [image], [box_xyxy])[0]
    if stats is not None:
        stats.setdefault("sam_ms", []).append((time.perf_counter() - t0) * 1e3)
    return mask


def generate(records: Sequence[Dict], out_dir: str, depth_dir: str,
             method: str = "depth-ransac", artifacts_root: str = "datasets",
             depth_loader=None, foundation_models=None, image_loader=None,
             box_threshold: Optional[float] = None, gdino_side: int = 768, device=None,
             draws: Optional[Callable[[int, int], np.ndarray]] = None) -> Dict:
    """Write out_dir/{image_id}.npz for every record with a ground mask of
    at least MIN_MASK_PX pixels and append the others' ids to
    artifacts_root/no_ground_idx.csv. foundation_models: (gdino, sam), on
    their device (load_foundation_models), required by method
    "foundation". draws(i, n): record i's (1000, 3) RANSAC draws over n
    points, replacing a CPU generator seeded with i. Returns counts and
    timings."""
    os.makedirs(out_dir, exist_ok=True)
    no_ground = []
    stats: Dict[str, list] = {"image_ms": []}
    if method == "foundation":
        if foundation_models is None:
            raise ValueError(
                "foundation method needs GroundingDINO/SAM checkpoints: pass "
                "--gdino-ckpt/--sam-ckpt (reference generate_ground_segmentations.py:137-191)")
        gdino, sam = foundation_models
        image_loader = image_loader or _default_image_loader
        dev = next(gdino.parameters()).device
    else:
        dev = resolve_device(device)
    for i, r in enumerate(records):
        t0 = time.perf_counter()
        if method == "foundation":
            mask = foundation_ground_mask(
                gdino, sam, image_loader(r),
                box_threshold=BOX_THRESHOLD if box_threshold is None else box_threshold,
                gdino_side=gdino_side, stats=stats)
        else:
            if depth_loader is not None:
                depth = depth_loader(r)
            else:
                dp = os.path.join(depth_dir, f"{r['image_id']}.npz")
                if not os.path.exists(dp):
                    no_ground.append(r["image_id"])
                    continue
                with np.load(dp) as zf:
                    depth = zf[list(zf.keys())[0]].astype(np.float32)
            K = np.asarray(r["K"], np.float32)
            d = None
            if draws is not None:
                d = draws(i, len(depth[::4, ::4].reshape(-1)))
            mask = ground_from_depth_ransac(depth, K, draws=d, device=dev,
                                            generator=torch.Generator().manual_seed(i))
        stats["image_ms"].append((time.perf_counter() - t0) * 1e3)
        if mask.sum() < MIN_MASK_PX:
            no_ground.append(r["image_id"])
            continue
        np.savez_compressed(os.path.join(out_dir, f"{r['image_id']}.npz"), ground=mask)
    os.makedirs(artifacts_root, exist_ok=True)
    with open(os.path.join(artifacts_root, "no_ground_idx.csv"), "a") as f:
        w = csv.writer(f)
        for iid in no_ground:
            w.writerow([iid])
    print(f"wrote {len(records) - len(no_ground)} ground maps, {len(no_ground)} no-ground ids")
    return dict(stats, written=len(records) - len(no_ground), no_ground=no_ground)


def load_foundation_models(gdino_ckpt: str, sam_ckpt: str, sam_variant: str = "vit_l",
                           device=None, dtype: torch.dtype = torch.bfloat16):
    """The released checkpoints -> (GroundingDINO, Sam-HQ), on `device` (the
    card unless "cpu") in `dtype`, in eval mode. Each state dict loads
    strictly after the JAX converter's changes (convert_released_checkpoint)."""
    from .pseudo_gt import grounding_dino as gd
    dev = resolve_device(device)
    gdino = GroundingDINO()
    gdino.load_state_dict(gd.load_checkpoint(gdino_ckpt))
    sam = sam_mod.Sam(sam_variant)
    sam.load_state_dict(sam_mod.load_checkpoint(sam_ckpt))
    return (gdino.to(device=dev, dtype=dtype).eval(), sam.to(device=dev, dtype=dtype).eval())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-file", default="configs/Omni_combined.yaml")
    p.add_argument("--method", default="depth-ransac", choices=["depth-ransac", "foundation"])
    p.add_argument("--depth-dir", default="datasets/depth_maps")
    p.add_argument("--out", default="datasets/ground_maps")
    p.add_argument("--artifacts-root", default="datasets",
                   help="where no_ground_idx.csv is appended to")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--gdino-ckpt", default=None,
                   help="groundingdino_swint_ogc.pth (foundation method)")
    p.add_argument("--sam-ckpt", default=None, help="sam_hq_vit_*.pth (foundation method)")
    p.add_argument("--sam-variant", default="vit_l", choices=sorted(sam_mod.SAM_SPECS))
    p.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    args = p.parse_args(argv)

    foundation_models = None
    if args.method == "foundation":
        if not (args.gdino_ckpt and args.sam_ckpt):
            p.error("--method foundation requires --gdino-ckpt and --sam-ckpt")
        dtype = torch.float32 if args.device == "cpu" else torch.bfloat16
        foundation_models = load_foundation_models(args.gdino_ckpt, args.sam_ckpt,
                                                   args.sam_variant, args.device, dtype)

    if args.synthetic:
        from . import synthetic
        records = synthetic.make_dataset(args.synthetic)
        return generate(records, args.out, args.depth_dir, args.method, args.artifacts_root,
                        depth_loader=lambda r: synthetic.render_depth(r["_scene"]),
                        foundation_models=foundation_models,
                        image_loader=lambda r: synthetic.render_image(r["_scene"]),
                        device=args.device)
    from ..config import get_cfg
    from . import datasets as ds
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    fs = ds.get_filter_settings_from_cfg(cfg)
    records = []
    for name in list(cfg.DATASETS.TRAIN) + list(cfg.DATASETS.TEST):
        if name not in ds.DATASET_CATALOG:
            ds.simple_register(name, fs)
        records.extend(ds.DATASET_CATALOG[name]())
    return generate(records, args.out, args.depth_dir, args.method, args.artifacts_root,
                    foundation_models=foundation_models, device=args.device)


if __name__ == "__main__":
    main()
