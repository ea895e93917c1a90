"""Drawings: 2D boxes, 3D wireframes and a top-down view, on the host with
PIL (weakcube_tpu/vis/vis.py).

Replaces the pytorch3d renderer of the reference's vis (cubercnn/vis/vis.py
draw_scene_view :210-546, box wireframes :578-654) with a painter's line
rasteriser. Corners and projections come from ops/cuboids.py on CPU tensors
in float32.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import cuboids as cub
from ..utils.util import imwrite

# cuboid wireframe edges over the v0..v7 corner numbering (math_util diagram)
_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
          (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def _color(i: int) -> Tuple[int, int, int]:
    rng = np.random.default_rng(i * 7 + 1)
    c = rng.integers(64, 255, 3)
    return int(c[0]), int(c[1]), int(c[2])


def _corners(centers, dims, poses) -> np.ndarray:
    """Corners (n, 8, 3) float32 of cuboids given as numpy arrays."""
    box3d = torch.from_numpy(np.concatenate([centers, dims], -1).astype(np.float32))
    return cub.get_cuboid_verts_3d(box3d, torch.from_numpy(np.asarray(poses, np.float32))).numpy()


def draw_boxes_2d(image: np.ndarray, boxes: np.ndarray,
                  labels: Optional[Sequence[str]] = None) -> np.ndarray:
    from PIL import Image, ImageDraw
    im = Image.fromarray(image.astype(np.uint8))
    d = ImageDraw.Draw(im)
    for i, b in enumerate(np.asarray(boxes)):
        col = _color(i)
        d.rectangle([float(b[0]), float(b[1]), float(b[2]), float(b[3])], outline=col, width=2)
        if labels is not None and i < len(labels):
            d.text((float(b[0]) + 2, float(b[1]) + 2), str(labels[i]), fill=col)
    return np.asarray(im)


def draw_cube_wireframe(draw, corners2d: np.ndarray, z: np.ndarray, color,
                        min_z: float = 0.1) -> None:
    """Draw the 12 edges, skipping edges with a vertex behind the camera
    (the reference clips at the z-plane, vis.py:578-654)."""
    for a, b in _EDGES:
        if z[a] <= min_z or z[b] <= min_z:
            continue
        draw.line([tuple(corners2d[a]), tuple(corners2d[b])], fill=color, width=2)


def draw_scene_view(image: np.ndarray, K: np.ndarray,
                    centers: np.ndarray, dims: np.ndarray, poses: np.ndarray,
                    labels: Optional[Sequence[str]] = None,
                    topdown_extent: float = 12.0):
    """Front view with cuboid wireframes, and a top-down (bird's eye) canvas.
    Returns (front_image, topdown_image) uint8 arrays: the reference's
    two-panel draw_scene_view (vis.py:210-546) without pytorch3d."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(image.astype(np.uint8))
    d = ImageDraw.Draw(im)
    n = len(centers)
    corners = _corners(centers, dims, poses) if n else np.zeros((0, 8, 3), np.float32)
    if n:
        proj = cub.project_points(torch.from_numpy(np.asarray(K, np.float32)),
                                  torch.from_numpy(corners.reshape(-1, 3))).numpy()
        proj = proj.reshape(n, 8, 3)
        order = np.argsort(-centers[:, 2])  # far first
        for i in order:
            draw_cube_wireframe(d, proj[i, :, :2], proj[i, :, 2], _color(int(i)))
            if labels is not None and i < len(labels):
                u, v = proj[i, :, 0].min(), proj[i, :, 1].min()
                d.text((float(u), float(v) - 10), str(labels[i]), fill=_color(int(i)))

    # top-down canvas: x right, z up
    T = 512
    top = Image.new("RGB", (T, T), (30, 30, 30))
    td = ImageDraw.Draw(top)
    scale = T / (2 * topdown_extent)

    def to_px(x, z):
        return (T / 2 + x * scale, T - z * scale)

    td.line([to_px(0, 0), to_px(-topdown_extent, topdown_extent)], fill=(80, 80, 80))
    td.line([to_px(0, 0), to_px(topdown_extent, topdown_extent)], fill=(80, 80, 80))
    for i in range(n):
        # footprint: x and z of the corners 0, 1, 5, 4
        foot = corners[i][[0, 1, 5, 4], :][:, [0, 2]]
        td.polygon([to_px(x, z) for x, z in foot], outline=_color(int(i)))
    return np.asarray(im), np.asarray(top)


def visualize_from_instances(image: np.ndarray, K: np.ndarray, det, index: int,
                             out_path: str,
                             class_names: Optional[Sequence[str]] = None) -> None:
    """Save a side-by-side front + top-down JPEG of batch element `index`
    (reference visualize_from_instances, vis.py:76-198). `det` has the
    Detections fields as numpy arrays (B, D, ...)."""
    valid = np.asarray(det.valid[index])
    centers = np.asarray(det.centers3D[index])[valid]
    dims = np.asarray(det.dims3D[index])[valid]
    poses = np.asarray(det.poses3D[index])[valid]
    classes = np.asarray(det.classes[index])[valid]
    labels = [class_names[c] if class_names else str(c) for c in classes]
    front, top = draw_scene_view(image, K, centers, dims, poses, labels)
    h = max(front.shape[0], top.shape[0])
    canvas = np.zeros((h, front.shape[1] + top.shape[1], 3), np.uint8)
    canvas[:front.shape[0], :front.shape[1]] = front
    canvas[:top.shape[0], front.shape[1]:] = top
    imwrite(out_path, canvas, quality=90)


def image_to_pixels(img, cfg) -> np.ndarray:
    """Network-input image (HWC) -> display pixels (RGB, 0-255 float): uint8
    canvases are raw pixels; float canvases are normalised with the
    reference's pixel statistics."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32)
    else:
        img = img * np.asarray(cfg.MODEL.PIXEL_STD) + np.asarray(cfg.MODEL.PIXEL_MEAN)
    if cfg.INPUT.FORMAT == "BGR":
        img = img[..., ::-1]
    return np.clip(img, 0, 255)
