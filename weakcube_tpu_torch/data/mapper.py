"""DatasetMapper3D (weakcube_tpu/data/mapper.py): per-image dict -> dense
padded training example with 3D-aware augmentation.

Mirrors cubercnn/data/dataset_mapper.py:
  * resize + horizontal flip with the pose mirror `_M1 @ R @ _M2`
    (dataset_mapper.py:180-247);
  * gt_boxes3D = [proj_cx, proj_cy, z, w, h, l, cx3d, cy3d, cz3d]
    (dataset_mapper.py:250-272);
  * NEAREST-resized depth/ground maps (dataset_mapper.py:124-147).

Instead of d2's fully-variable shapes, every image is scaled to fit a
static canvas and bottom/right padded; the true content size travels as
`image_wh` and the intrinsics are pre-scaled to network resolution. The
canvas is either one square (cfg.TPU.IMAGE_SIZE) or, with
cfg.TPU.ASPECT_BUCKETS set, the bucket shape that preserves the most content
resolution for the image's aspect (d2's AspectRatioGroupedDataset,
reference data/build.py:76-155). All outputs are numpy (host-side);
batching (grouped per bucket) happens in build.py. The ground mask is a
bool map, and the per-image ground normal is cached
(cfg.TPU.CACHE_GROUND_NORMALS, on by default).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

_M1 = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
_M2 = np.array([[-1, 0, 0], [0, -1, 0], [0, 0, 1]], np.float32)


def _resize_bilinear(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Host-side bilinear resize via PIL (no cv2 in this environment)."""
    from PIL import Image
    if img.ndim == 2:
        mode_img = Image.fromarray(img.astype(np.float32), mode="F")
        return np.asarray(mode_img.resize((out_hw[1], out_hw[0]), Image.BILINEAR))
    pil = Image.fromarray(img.astype(np.uint8))
    return np.asarray(pil.resize((out_hw[1], out_hw[0]), Image.BILINEAR))


def _resize_nearest(arr: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    ys = (np.arange(out_hw[0]) * arr.shape[0] / out_hw[0]).astype(np.int64)
    xs = (np.arange(out_hw[1]) * arr.shape[1] / out_hw[1]).astype(np.int64)
    return arr[ys[:, None], xs[None, :]]


class DatasetMapper3D:
    """Callable per-image mapper: dict -> dict of numpy arrays."""

    def __init__(self, cfg, is_train: bool = True, max_gt: Optional[int] = None):
        self.is_train = is_train
        self.image_size = cfg.TPU.IMAGE_SIZE
        buckets = list(getattr(cfg.TPU, "ASPECT_BUCKETS", []) or [])
        self.buckets = [tuple(int(v) for v in b) for b in buckets] or \
            [(self.image_size, self.image_size)]
        self.max_gt = max_gt or cfg.TPU.MAX_GT_PER_IMAGE
        self.pixel_mean = np.asarray(cfg.MODEL.PIXEL_MEAN, np.float32)
        self.pixel_std = np.asarray(cfg.MODEL.PIXEL_STD, np.float32)
        # uint8 pixels, normalised on the device (models/rcnn3d.py
        # _prep_image): a quarter of a float32 canvas's bytes. Rounding the
        # bilinear resize back to uint8 moves pixels by <= 0.5 / 255.
        self.transfer_uint8 = bool(getattr(cfg.TPU, "TRANSFER_UINT8", True))
        self.random_flip = cfg.INPUT.RANDOM_FLIP == "horizontal" and is_train
        self.fmt = cfg.INPUT.FORMAT
        # multi-scale training (reference INPUT.MIN_SIZE_TRAIN sweep): the
        # canvas stays fixed; the content scale is jittered inside it,
        # clamped so the content always fits
        sizes = cfg.INPUT.MIN_SIZE_TRAIN if is_train else (cfg.INPUT.MIN_SIZE_TEST,)
        if isinstance(sizes, (int, float)):
            sizes = (sizes,)
        self.min_sizes = tuple(sizes)
        self.transfer_depth_f16 = bool(
            getattr(cfg.TPU, "TRANSFER_DEPTH_F16", True))
        self.cache_ground_normals = bool(
            getattr(cfg.TPU, "CACHE_GROUND_NORMALS", True))
        self._normal_cache: Dict = {}

    def bucket(self, record: Dict) -> Tuple[Tuple[int, int], float]:
        """The record's canvas (H, W) and the scale that fits it there: the
        canvas whose fit-scale preserves the most content resolution (ties
        break toward the smaller canvas area). It depends on the record's
        width and height alone."""
        W0, H0 = record["width"], record["height"]
        fit = [min(bh / H0, bw / W0) for bh, bw in self.buckets]
        bi = int(np.argmax([min(f, 1.0) - 1e-9 * (bh * bw)
                            for f, (bh, bw) in zip(fit, self.buckets)]))
        return self.buckets[bi], fit[bi]

    def __call__(self, record: Dict, rng: Optional[np.random.Generator] = None,
                 image: Optional[np.ndarray] = None,
                 depth_map: Optional[np.ndarray] = None,
                 ground_map: Optional[np.ndarray] = None) -> Dict:
        rng = rng or np.random.default_rng(0)
        W0, H0 = record["width"], record["height"]
        (SH, SW), scale = self.bucket(record)
        if self.is_train and len(self.min_sizes) > 1:
            # scale jitter: target a random min-side, clamped into the canvas
            target_min = float(self.min_sizes[rng.integers(len(self.min_sizes))])
            jitter = (target_min / min(W0, H0))
            scale = min(jitter, scale)
        net_w, net_h = int(round(W0 * scale)), int(round(H0 * scale))
        net_w, net_h = min(net_w, SW), min(net_h, SH)

        if image is None:
            from .datasets import read_image
            image = read_image(record["file_name"], record=record)
        if self.fmt == "BGR":
            image = image[..., ::-1]
        img = _resize_bilinear(image, (net_h, net_w)).astype(np.float32)
        if self.transfer_uint8:
            # padding carries the per-channel mean pixel so the on-device
            # normalise maps it to ~0, matching the f32 canvas' zero pad
            canvas = np.empty((SH, SW, 3), np.uint8)
            canvas[:] = np.clip(self.pixel_mean + 0.5, 0, 255).astype(np.uint8)
            canvas[:net_h, :net_w] = np.clip(img + 0.5, 0, 255)
        else:
            # normalise with reference pixel stats, pad to the square canvas
            img = (img - self.pixel_mean) / self.pixel_std
            canvas = np.zeros((SH, SW, 3), np.float32)
            canvas[:net_h, :net_w] = img

        K = np.asarray(record["K"], np.float32).copy()
        K[:2] *= scale

        flip = bool(self.random_flip and rng.random() < 0.5)
        if flip:
            canvas[:net_h, :net_w] = canvas[:net_h, :net_w][:, ::-1]

        G = self.max_gt
        gt_boxes = np.zeros((G, 4), np.float32)
        gt_classes = np.full((G,), -1, np.int32)
        gt_valid = np.zeros((G,), bool)
        gt_boxes3D = np.zeros((G, 9), np.float32)
        gt_poses = np.tile(np.eye(3, dtype=np.float32), (G, 1, 1))

        annos = record.get("annotations", [])[:G]
        for i, a in enumerate(annos):
            b = np.asarray(a["bbox"], np.float32) * scale
            ctr = np.asarray(a["center_cam"], np.float32)
            pose = np.asarray(a["pose"], np.float32)
            dims = np.asarray(a["dimensions"], np.float32)
            proj = K @ ctr
            if abs(proj[2]) > 1e-6:
                proj[:2] /= proj[2]
            if flip:
                b = np.array([net_w - b[2], b[1], net_w - b[0], b[3]], np.float32)
                proj[0] = net_w - proj[0]
                pose = _M1 @ pose @ _M2
                ctr = ctr * np.array([-1, 1, 1], np.float32)
            gt_boxes[i] = b
            gt_classes[i] = -1 if a.get("ignore", False) else int(a["category_id"])
            gt_valid[i] = True
            gt_boxes3D[i] = np.concatenate([proj[:2], [ctr[2]], dims, ctr])
            gt_poses[i] = pose

        out = {
            "image": canvas,
            "image_wh": np.array([net_w, net_h], np.float32),
            "K": K,
            "gt_boxes": gt_boxes,
            "gt_classes": gt_classes,
            "gt_valid": gt_valid,
            "gt_boxes3D": gt_boxes3D,
            "gt_poses": gt_poses,
            "image_id": record.get("image_id", 0),
            "scale": scale,
            "flip": flip,
            "bucket": (SH, SW),
        }

        if depth_map is not None:
            d = _resize_nearest(depth_map, (net_h, net_w)).astype(np.float32)
            dm = np.zeros((SH, SW), np.float32)
            dm[:net_h, :net_w] = d[:, ::-1] if flip else d
            # float16 (cfg.TPU.TRANSFER_DEPTH_F16) halves the copy to the
            # device; its ulp at 10 m is 8 mm, far under the 50 mm RANSAC
            # inlier threshold. The model decodes it to float32
            # (rcnn3d._roi_extra).
            out["depth_map"] = dm.astype(np.float16) \
                if self.transfer_depth_f16 else dm
        if ground_map is not None:
            g = _resize_nearest(ground_map.astype(np.float32), (net_h, net_w)) > 0.5
            gm = np.zeros((SH, SW), bool)
            gm[:net_h, :net_w] = g[:, ::-1] if flip else g
            out["ground_mask"] = gm
            out["ground_valid"] = bool(g.sum() > 0)
        if depth_map is not None and self.cache_ground_normals:
            # the ground-plane normal, fit once per image: the pseudo-GT
            # depth and ground maps are static, so this replaces the
            # per-step RANSAC (roi_heads.ground_normals_from_maps). A
            # horizontal flip mirrors camera x: n_x is negated.
            iid = record.get("image_id", 0)
            hit = self._normal_cache.get(iid)
            if hit is None:
                from ..ops.plane import ground_normal_np
                hit = ground_normal_np(depth_map, record["K"], ground_map)
                self._normal_cache[iid] = hit
            n, ok = hit
            out["ground_normal"] = (n * np.array([-1.0, 1.0, 1.0], np.float32)
                                    if flip else n.copy())
            out["ground_normal_valid"] = bool(
                ok and (ground_map is None or out.get("ground_valid", True)))
        return out
