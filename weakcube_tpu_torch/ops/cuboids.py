"""Cuboid geometry (weakcube_tpu/ops/cuboids.py): corners, projection, a
cube's enclosing 2D box with behind-camera clipping, the virtual depth
scale, egocentric <-> allocentric pose, back-projection, scaled sigmoid and
the `Cubes` struct with its projected ("bube") corners and enclosing boxes.

Conventions as in the JAX package: a cube is the 15-vector
[center(3), dims whl(3), R row-major (9)]; K is a 3x3 pinhole intrinsics
matrix and the camera looks down +z.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.trace import span
from . import rotations

# corner v0..v7 as the sign pattern of the local (x = l, y = h, z = w) half
# dimensions (the reference's math_util.py vertex numbering)
_CORNER_SIGNS = torch.tensor(
    [[-1, -1, -1], [+1, -1, -1], [+1, +1, -1], [-1, +1, -1],
     [-1, -1, +1], [+1, -1, +1], [+1, +1, +1], [-1, +1, +1]], dtype=torch.float32)


def _corner_signs(like: torch.Tensor) -> torch.Tensor:
    """_CORNER_SIGNS on like's device in its dtype. On a card the copy from
    pageable host memory blocks: the host waits for the device's queue."""
    if like.device.type != "cuda":
        return _CORNER_SIGNS.to(like.device, like.dtype)
    with span("sync"):
        return _CORNER_SIGNS.to(like.device, like.dtype)


def get_cuboid_verts_3d(box3d: torch.Tensor, R: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., 6) [x, y, z, w, h, l] and optional (..., 3, 3) R -> corners
    (..., 8, 3)."""
    ctr = box3d[..., 0:3]
    half = 0.5 * torch.stack([box3d[..., 5], box3d[..., 4], box3d[..., 3]], dim=-1)
    local = _corner_signs(box3d) * half[..., None, :]
    if R is not None:
        dt = torch.promote_types(R.dtype, local.dtype)  # einsum does not promote
        local = torch.einsum("...ij,...kj->...ki", R.to(dt), local.to(dt))
    return local + ctr[..., None, :]


def get_cuboid_verts_3d_np(box3d, R=None) -> np.ndarray:
    """numpy twin of get_cuboid_verts_3d in float32, for building
    evaluation records on the host."""
    box3d = np.asarray(box3d, np.float32)
    ctr = box3d[..., 0:3]
    half = 0.5 * np.stack([box3d[..., 5], box3d[..., 4], box3d[..., 3]], -1)
    local = _CORNER_SIGNS.numpy() * half[..., None, :]
    if R is not None:
        local = np.einsum("...ij,...kj->...ki", np.asarray(R, np.float32), local)
    return local + ctr[..., None, :]


def project_points(K: torch.Tensor, pts3d: torch.Tensor, min_z: float = 1e-6) -> torch.Tensor:
    """Camera-space points (..., N, 3) through K (..., 3, 3) -> (u, v, z)
    (..., N, 3); |z| below min_z divides by +-min_z, keeping z's sign."""
    dt = torch.promote_types(K.dtype, pts3d.dtype)  # einsum does not promote
    proj = torch.einsum("...ij,...nj->...ni", K.to(dt), pts3d.to(dt))
    z = proj[..., 2:3]
    safe_z = torch.where(torch.abs(z) < min_z,
                         torch.where(z < 0, torch.full_like(z, -min_z), torch.full_like(z, min_z)),
                         z)
    return torch.cat([proj[..., :2] / safe_z, z], dim=-1)


def get_cuboid_verts(K: torch.Tensor, box3d: torch.Tensor, R: Optional[torch.Tensor] = None):
    """Projected cuboid corners: (verts2d (..., 8, 3) = (u, v, z), verts3d
    (..., 8, 3))."""
    verts3d = get_cuboid_verts_3d(box3d, R)
    return project_points(K, verts3d), verts3d


def convert_3d_box_to_2d(K: torch.Tensor, box3d: torch.Tensor, R: Optional[torch.Tensor] = None,
                         clipw=0.0, cliph=0.0, XYWH: bool = True, min_z: float = 0.20):
    """The 2D box enclosing a cube's projected corners. A corner at
    z <= min_z (behind the camera) counts as the image corner of its 3D
    (x, y) sign quadrant: x clipw - 1 where x > 0, else 0; y likewise with
    cliph (floats, or tensors broadcasting against the cubes).
    Returns (box2d (..., 4), XYWH or XYXY; behind_camera (...), any corner
    behind; fully_behind (...), every corner behind)."""
    verts2d, verts3d = get_cuboid_verts(K, box3d, R)
    behind = verts2d[..., 2] <= min_z
    u, v = verts2d[..., 0], verts2d[..., 1]
    zero = torch.zeros_like(u)
    bound_x = torch.where(verts3d[..., 0] > 0, torch.as_tensor(clipw - 1.0, dtype=u.dtype,
                                                               device=u.device), zero)
    bound_y = torch.where(verts3d[..., 1] > 0, torch.as_tensor(cliph - 1.0, dtype=v.dtype,
                                                               device=v.device), zero)
    u = torch.where(behind, bound_x, u)
    v = torch.where(behind, bound_y, v)
    x1, y1 = torch.amin(u, dim=-1), torch.amin(v, dim=-1)
    x2, y2 = torch.amax(u, dim=-1), torch.amax(v, dim=-1)
    box2d = torch.stack([x1, y1, x2 - x1, y2 - y1] if XYWH else [x1, y1, x2, y2], dim=-1)
    return box2d, behind.any(-1), behind.all(-1)


def compute_virtual_scale_from_focal_spaces(f, H, f0, H0):
    """Depth scale from the real focal space (f0, H0) to the virtual one
    (f, H)."""
    return (H0 * f) / (f0 * H)


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


def R_to_allocentric(K: torch.Tensor, R: torch.Tensor,
                     u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Egocentric -> allocentric pose at pixel (u, v): R_view = M^T @ R, in
    the promoted dtype of M and R; R_from_allocentric is its inverse."""
    M = _allocentric_correction(K, u, v)
    dt = torch.promote_types(M.dtype, R.dtype)
    return M.transpose(-1, -2).to(dt) @ R.to(dt)


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

    def corners(self) -> torch.Tensor:
        """All 8 corners in camera space, (..., 8, 3)."""
        return get_cuboid_verts_3d(self.tensor[..., :6], self.rotations)

    def bube_corners(self, K: torch.Tensor, im_wh: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Projected corners (..., 8, 2), clamped into the extended frame
        [-W/2 + 1, 2W - 1] x [-H/2 + 1, 2H - 1] when im_wh is given; the
        clamp has jnp.clip's subgradient (1/2 at a bound)."""
        uv = project_points(K, self.corners())[..., :2]
        if im_wh is not None:
            W, H = im_wh[..., 0:1], im_wh[..., 1:2]
            x = torch.minimum(torch.maximum(uv[..., 0], (-W / 2 + 1).expand_as(uv[..., 0])),
                              (2 * W - 1).expand_as(uv[..., 0]))
            y = torch.minimum(torch.maximum(uv[..., 1], (-H / 2 + 1).expand_as(uv[..., 1])),
                              (2 * H - 1).expand_as(uv[..., 1]))
            uv = torch.stack([x, y], dim=-1)
        return uv

    def to_boxes(self, K: torch.Tensor, im_wh: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Enclosing XYXY boxes (..., 4) of the projected corners; amin/amax
        split a tie between corners evenly, as jnp.min/max do."""
        uv = self.bube_corners(K, im_wh)
        return torch.cat([torch.amin(uv, dim=-2), torch.amax(uv, dim=-2)], dim=-1)
