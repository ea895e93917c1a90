"""Export predictions to KITTI txt format (weakcube_tpu/data/kitti_export.py,
after the reference's cubercnn/data/Omni_to_kitti.py). numpy only.

KITTI label line: type trunc occl alpha x1 y1 x2 y2 h w l x y z ry score.
Omni3D poses are full rotation matrices; KITTI wants the yaw about the
camera y-axis (rotation_y) and the observation angle alpha = ry -
arctan2(x, z) (Omni_to_kitti.py:20-47).
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np


def rotation_y_from_pose(R: np.ndarray) -> float:
    """Yaw about camera y: direction of the object's x-axis in the xz plane."""
    fwd = R[:, 0]  # object x-axis (length direction) in camera coords
    return float(np.arctan2(-fwd[2], fwd[0]))


def calculate_alpha(ry: float, x: float, z: float) -> float:
    """Observation angle; wrapped to [-pi, pi] (Omni_to_kitti.py:20-47)."""
    alpha = ry - np.arctan2(x, z)
    while alpha > np.pi:
        alpha -= 2 * np.pi
    while alpha < -np.pi:
        alpha += 2 * np.pi
    return float(alpha)


def check_calculate_alpha():
    """Inline self-check, mirroring the reference's runtime test
    (Omni_to_kitti.py:49)."""
    assert abs(calculate_alpha(0.0, 0.0, 10.0)) < 1e-6
    assert abs(calculate_alpha(np.pi / 2, 0.0, 10.0) - np.pi / 2) < 1e-6
    a = calculate_alpha(np.pi, 10.0, 10.0)
    assert -np.pi <= a <= np.pi


def prediction_to_kitti_lines(boxes2d: np.ndarray, classes: Sequence[int],
                              scores: np.ndarray, centers: np.ndarray,
                              dims: np.ndarray, poses: np.ndarray,
                              class_names: Sequence[str]) -> List[str]:
    lines = []
    for i in range(len(boxes2d)):
        name = class_names[int(classes[i])]
        x, y, z = centers[i]
        w, h, l = dims[i]
        ry = rotation_y_from_pose(np.asarray(poses[i]))
        alpha = calculate_alpha(ry, float(x), float(z))
        b = boxes2d[i]
        # KITTI location is the bottom-face centre
        lines.append(
            f"{name.capitalize()} 0.00 0 {alpha:.2f} "
            f"{b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[3]:.2f} "
            f"{h:.2f} {w:.2f} {l:.2f} "
            f"{x:.2f} {y + h / 2:.2f} {z:.2f} {ry:.2f} {scores[i]:.4f}")
    return lines


def export_predictions_to_kitti(records: Sequence[Dict], out_dir: str,
                                class_names: Sequence[str]) -> None:
    """records: evaluator-style dt records with 3D fields + poses3D."""
    check_calculate_alpha()
    os.makedirs(out_dir, exist_ok=True)
    for rec in records:
        lines = prediction_to_kitti_lines(
            rec["boxes"], rec["classes"], rec["scores"], rec["centers3D"],
            rec["dims3D"], rec["poses3D"], class_names)
        with open(os.path.join(out_dir, f"{rec['image_id']:06d}.txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
