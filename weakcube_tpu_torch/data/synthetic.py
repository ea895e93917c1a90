"""Procedural synthetic Omni3D-style dataset (a copy of
weakcube_tpu/data/synthetic.py, numpy only).

The reference's de-facto integration harness is a minified real dataset
(datasetminify.py -> SUNRGBD_*_mini); we additionally provide a fully
procedural generator: random cuboid scenes with exact intrinsics, exact
projected 2D boxes, and analytically consistent depth maps. This gives the
test pyramid deterministic end-to-end train/eval fixtures with zero data
downloads (SURVEY §4 test-strategy plan).

Scenes: a ground plane at y = GROUND_Y, N cuboids resting on it with random
dimensions/yaw, camera looking +z. Emits Omni3D-format dicts (the same keys
load_omni3d_json produces) plus synthetic depth/ground maps.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


CATEGORIES = ["chair", "table", "sofa", "bed", "cabinet"]
GROUND_Y = 1.2  # metres below camera (y down)


def _yaw_matrix(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def make_scene(rng: np.random.Generator, width: int = 640, height: int = 480,
               max_objects: int = 6) -> Dict:
    f = rng.uniform(400, 600)
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    n = int(rng.integers(2, max_objects + 1))
    objs = []
    for _ in range(n):
        cat = int(rng.integers(0, len(CATEGORIES)))
        dims = rng.uniform(0.4, 1.4, 3).astype(np.float32)  # w, h, l
        z = rng.uniform(2.5, 9.0)
        x = rng.uniform(-0.35, 0.35) * z * width / (2 * f)
        y = GROUND_Y - dims[1] / 2.0  # resting on ground
        R = _yaw_matrix(rng.uniform(0, 2 * np.pi))
        ctr = np.array([x, y, z], np.float32)
        # pure-numpy projection (host-side data generation must not touch
        # the accelerator: every tiny jax op is a device roundtrip here)
        signs = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                          [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                         np.float32)
        half = 0.5 * np.array([dims[2], dims[1], dims[0]], np.float32)
        corners = (signs * half) @ R.T + ctr
        proj = corners @ K.T
        behind_pts = proj[:, 2] <= 0.2
        uv = proj[:, :2] / np.maximum(proj[:, 2:3], 1e-6)
        b = np.array([uv[:, 0].min(), uv[:, 1].min(),
                      uv[:, 0].max(), uv[:, 1].max()], np.float32)
        behind = bool(behind_pts.any())
        fully = bool(behind_pts.all())
        b[[0, 2]] = b[[0, 2]].clip(0, width - 1)
        b[[1, 3]] = b[[1, 3]].clip(0, height - 1)
        if fully or (b[2] - b[0]) < 8 or (b[3] - b[1]) < 8:
            continue
        objs.append({
            "category_id": cat,
            "bbox2D_tight": [float(b[0]), float(b[1]), float(b[2]), float(b[3])],
            "bbox2D_proj": [float(b[0]), float(b[1]), float(b[2]), float(b[3])],
            "bbox2D_trunc": [float(b[0]), float(b[1]), float(b[2]), float(b[3])],
            "center_cam": ctr.tolist(),
            "dimensions": dims.tolist(),
            "R_cam": R.tolist(),
            "behind_camera": bool(behind),
            "visibility": 1.0,
            "truncation": 0.0,
            "segmentation_pts": -1,
            "lidar_pts": -1,
            "depth_error": 0.0,
            "valid3D": True,
        })
    return {"K": K, "width": width, "height": height, "objects": objs}


def render_depth(scene: Dict, stride: int = 1) -> np.ndarray:
    """Analytic depth map: ground plane + cuboid front-face billboards.

    Cheap painter's approximation (adequate for pseudo-GT plumbing tests):
    each object writes its centre depth into its projected 2D box region,
    nearer objects painted last; ground fills the rest via the plane
    y = GROUND_Y (depth = f * GROUND_Y / (v - cy) for v below the horizon).
    """
    H, W = scene["height"] // stride, scene["width"] // stride
    K = scene["K"] / stride
    fy, cy = K[1, 1], K[1, 2]
    v = np.arange(H, dtype=np.float32)[:, None] + 0.5
    denom = v - cy
    ground_z = np.where(denom > 1e-3, fy * GROUND_Y / np.maximum(denom, 1e-3), 50.0)
    depth = np.tile(ground_z, (1, W)).astype(np.float32)
    order = sorted(scene["objects"], key=lambda o: -o["center_cam"][2])
    for o in order:
        x1, y1, x2, y2 = [int(c / stride) for c in o["bbox2D_tight"]]
        depth[max(y1, 0):min(y2, H), max(x1, 0):min(x2, W)] = o["center_cam"][2]
    return depth


def ground_mask(scene: Dict, stride: int = 1) -> np.ndarray:
    """True where the analytic ground plane is visible."""
    H, W = scene["height"] // stride, scene["width"] // stride
    K = scene["K"] / stride
    cy = K[1, 2]
    mask = np.zeros((H, W), bool)
    mask[int(cy) + 1:, :] = True
    for o in scene["objects"]:
        x1, y1, x2, y2 = [int(c / stride) for c in o["bbox2D_tight"]]
        mask[max(y1, 0):min(y2, H), max(x1, 0):min(x2, W)] = False
    return mask


def render_image(scene: Dict, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Simple shaded RGB rendering: depth-coded boxes over a gradient floor.

    Enough visual structure for a detector to learn box locations in
    smoke-training; (H, W, 3) uint8.
    """
    rng = rng or np.random.default_rng(0)
    H, W = scene["height"], scene["width"]
    img = np.full((H, W, 3), 40, np.uint8)
    depth = render_depth(scene)
    # shade by inverse depth
    shade = np.clip(255.0 / np.maximum(depth, 1.0), 0, 255).astype(np.uint8)
    img[..., 0] = shade
    img[..., 1] = (shade * 0.7).astype(np.uint8)
    order = sorted(scene["objects"], key=lambda o: -o["center_cam"][2])
    for o in order:
        x1, y1, x2, y2 = [int(c) for c in o["bbox2D_tight"]]
        col = np.array([60 + 39 * o["category_id"], 200 - 30 * o["category_id"],
                        80 + 25 * o["category_id"]], np.uint8)
        img[max(y1, 0):min(y2, H), max(x1, 0):min(x2, W)] = col
    return img


def make_dataset(num_images: int, seed: int = 0, width: int = 640,
                 height: int = 480) -> List[Dict]:
    """List of Omni3D-style per-image dicts (the format DatasetMapper3D
    consumes), with deterministic scenes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num_images):
        scene = make_scene(rng, width, height)
        annos = []
        for o in scene["objects"]:
            annos.append({
                "category_id": o["category_id"],
                "bbox": o["bbox2D_tight"],  # XYXY
                "bbox_mode": "XYXY_ABS",
                "center_cam": o["center_cam"],
                "dimensions": o["dimensions"],
                "pose": o["R_cam"],
                "iscrowd": 0,
                "ignore": False,
            })
        out.append({
            "image_id": i,
            "dataset_id": 0,
            "K": scene["K"].tolist(),
            "width": width,
            "height": height,
            "file_name": f"synthetic://{i}",
            "annotations": annos,
            "_scene": scene,  # kept for depth/ground rendering
        })
    return out
