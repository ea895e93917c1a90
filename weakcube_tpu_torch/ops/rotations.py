"""Rotation representation conversions (weakcube_tpu/ops/rotations.py): the
6d, quaternion and euler parameterisations the cube head can select, the
axis-angle map the allocentric pose correction uses, and the rotation
angles the weak pose losses compare.

All functions broadcast over leading batch dimensions. Matrices act on
column vectors: ``x_rotated = R @ x``.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _normalize(v: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=eps)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al. continuous 6D rotation representation -> (..., 3, 3).
    The 6 numbers are the first two rows before Gram-Schmidt (pytorch3d)."""
    a1, a2 = d6[..., 0:3], d6[..., 3:6]
    b1 = _normalize(a1)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = _normalize(b2)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-2)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z), normalised here -> rotation (..., 3, 3)."""
    q = _normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two = 2.0
    R = torch.stack(
        [
            1 - two * (y * y + z * z), two * (x * y - z * w), two * (x * z + y * w),
            two * (x * y + z * w), 1 - two * (x * x + z * z), two * (y * z - x * w),
            two * (x * z - y * w), two * (y * z + x * w), 1 - two * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def _axis_rotation(angle: torch.Tensor, axis: str) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        rows = (one, zero, zero, zero, c, -s, zero, s, c)
    elif axis == "Y":
        rows = (c, zero, s, zero, one, zero, -s, zero, c)
    elif axis == "Z":
        rows = (c, -s, zero, s, c, zero, zero, zero, one)
    else:
        raise ValueError(f"bad axis {axis}")
    return torch.stack(rows, dim=-1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix(angles: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """Euler angles (..., 3) -> R = R_c0 @ R_c1 @ R_c2 (pytorch3d)."""
    if len(convention) != 3:
        raise ValueError("convention must have 3 letters")
    Rs = [_axis_rotation(angles[..., i], ax) for i, ax in enumerate(convention)]
    return Rs[0] @ Rs[1] @ Rs[2]


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle vector (angle = |v|) -> rotation matrix; the
    identity at angle 0."""
    sq = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    angle = torch.sqrt(sq.clamp(min=_EPS * _EPS))
    axis = axis_angle / angle  # exactly 0 at v=0 -> K=0 -> R=I
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    K = K.reshape(axis.shape[:-1] + (3, 3))
    a = angle[..., None]
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device).expand(K.shape)
    return eye + torch.sin(a) * K + (1.0 - torch.cos(a)) * (K @ K)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    # jnp.clip's subgradient at the bounds (1/2), which torch.clamp does not share
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


def so3_rotation_angle(R: torch.Tensor, cos_angle: bool = False,
                       eps: float = 1e-4) -> torch.Tensor:
    """Rotation angle of R by the trace formula (or its cosine)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = _clip((trace - 1.0) * 0.5, -1.0 + eps, 1.0 - eps)
    return cos if cos_angle else torch.arccos(cos)


def so3_relative_angle(R1: torch.Tensor, R2: torch.Tensor,
                       cos_angle: bool = False) -> torch.Tensor:
    """Angle of the relative rotation R1 @ R2^T."""
    return so3_rotation_angle(R1 @ R2.transpose(-1, -2), cos_angle=cos_angle)


def so3_relative_angle_pairs(R: torch.Tensor, mask=None, cos_angle: bool = True):
    """Relative angles of all pairs within each set of rotations R
    (..., N, 3, 3), from one Gram product. Returns (vals (..., N, N),
    pair_mask): the mask is True on the strict lower triangle, where both
    rotations are valid under `mask` (..., N)."""
    n = R.shape[-3]
    traces = torch.einsum("...ikl,...jkl->...ij", R, R)
    cos = _clip((traces - 1.0) * 0.5, -1.0 + 1e-4, 1.0 - 1e-4)
    vals = cos if cos_angle else torch.arccos(cos)
    tri = torch.tril(torch.ones((n, n), dtype=torch.bool, device=R.device), diagonal=-1)
    if mask is not None:
        tri = tri & mask[..., :, None] & mask[..., None, :]
    return vals, tri
