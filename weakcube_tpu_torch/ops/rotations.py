"""Rotation representation conversions (weakcube_tpu/ops/rotations.py): the
6d, quaternion and euler parameterisations the cube head can select and
the inverses of the first two, the axis-angle map the allocentric pose
correction uses, and the rotation angles the weak pose losses compare.

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


def matrix_to_rotation_6d(R: torch.Tensor) -> torch.Tensor:
    """Inverse of rotation_6d_to_matrix: the first two rows, flattened."""
    return torch.cat((R[..., 0, :], R[..., 1, :]), dim=-1)


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


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Flip the sign so that w >= 0 (the double cover)."""
    return torch.where(q[..., 0:1] < 0, -q, q)


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0, without a
    branch: all four scaled candidates are built and the one keyed by the
    largest diagonal combination is taken (the first of tied keys, as
    jnp.argmax)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    # 4 x each component's square, clipped at 0
    qw2 = (1 + m00 + m11 + m22).clamp(min=0.0)
    qx2 = (1 + m00 - m11 - m22).clamp(min=0.0)
    qy2 = (1 - m00 + m11 - m22).clamp(min=0.0)
    qz2 = (1 - m00 - m11 + m22).clamp(min=0.0)
    # candidate quaternions, each stable where its key component dominates
    cands = torch.stack([
        torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)], dim=-2)
    keys = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    cands = cands / (2.0 * torch.sqrt(keys.clamp(min=_EPS)))[..., None]
    best = torch.argmax(keys, dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))
    return standardize_quaternion(_normalize(q[..., 0, :]))


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
