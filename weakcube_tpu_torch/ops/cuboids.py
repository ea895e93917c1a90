"""Cuboid geometry for the inference decode (weakcube_tpu/ops/cuboids.py):
allocentric -> egocentric pose, back-projection, scaled sigmoid and the
`Cubes` struct.

Conventions as in the JAX package: a cube is the 15-vector
[center(3), dims whl(3), R row-major (9)]; K is a 3x3 pinhole intrinsics
matrix and the camera looks down +z.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import rotations


def _allocentric_correction(K: torch.Tensor, u: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """Rotation M aligning the optical axis with the viewing ray through
    pixel (u, v)."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    sx, sy = K[..., 0, 2], K[..., 1, 2]
    oray = torch.stack([(u - sx) / fx, (v - sy) / fy, torch.ones_like(u)], dim=-1)
    oray = oray / torch.linalg.norm(oray, dim=-1, keepdim=True).clamp(min=1e-12)
    angle = torch.arccos(oray[..., 2].clamp(-1.0, 1.0))
    axis = torch.stack([-oray[..., 1], oray[..., 0], torch.zeros_like(u)], dim=-1)
    norm = torch.linalg.norm(axis, dim=-1, keepdim=True)
    axis_unit = axis / norm.clamp(min=1e-12)
    return rotations.axis_angle_to_matrix(angle[..., None] * axis_unit)


def R_from_allocentric(K: torch.Tensor, R_view: torch.Tensor,
                       u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Allocentric -> egocentric pose at pixel (u, v): R = M @ R_view, in
    the promoted dtype of M (float32 K and pixels) and R_view."""
    M = _allocentric_correction(K, u, v)
    dt = torch.promote_types(M.dtype, R_view.dtype)
    return M.to(dt) @ R_view.to(dt)


def scaled_sigmoid(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """sigmoid(x) rescaled into [lo, hi]."""
    return lo + torch.sigmoid(x) * (hi - lo)


def backproject(uv: torch.Tensor, z: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel (u, v) at depth z -> camera-space (x, y, z). uv: [..., 2]."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    sx, sy = K[..., 0, 2], K[..., 1, 2]
    x = z * (uv[..., 0] - sx) / fx
    y = z * (uv[..., 1] - sy) / fy
    return torch.stack([x, y, z], dim=-1)


class Cubes(NamedTuple):
    """Dense batch of 3D cuboids; tensor (..., 15) =
    [center(3), dims whl(3), R row-major (9)]."""

    tensor: torch.Tensor

    @property
    def centers(self) -> torch.Tensor:
        return self.tensor[..., 0:3]

    @property
    def dims(self) -> torch.Tensor:
        return self.tensor[..., 3:6]

    @property
    def rotations(self) -> torch.Tensor:
        return self.tensor[..., 6:15].reshape(self.tensor.shape[:-1] + (3, 3))

    @classmethod
    def from_parts(cls, centers, dims, R) -> "Cubes":
        flat_R = R.reshape(R.shape[:-2] + (9,))
        return cls(torch.cat([centers, dims, flat_R], dim=-1))
