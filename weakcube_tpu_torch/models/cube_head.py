"""3D cuboid prediction head (weakcube_tpu/models/cube_head.py).

Shared or per-branch fc1..fcN feature generator over the flattened 7x7
pooled features, then per-class linear outputs: 2D centre deltas (C, 2),
dimensions (C, 3), pose (C, 3, 3) from 6d / quaternion / euler parameters,
depth (C, bins) and uncertainty (C,), clipped at 0.01. Module names are the
reference's (feature_generator, bbox_3D_*). Outputs stay in the compute
dtype, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import rotations
from .layers import Linear

_POSE_DIM = {"6d": 6, "quaternion": 4, "euler": 3}
# branch -> the reference's per-branch feature generator name
_BRANCHES = {"xy": "XY", "dims": "dims", "pose": "pose", "z": "Z", "conf": "conf"}


class _FeatureGenerator(nn.Module):
    def __init__(self, in_dim: int, num_fc: int, fc_dim: int):
        super().__init__()
        self.num_fc = num_fc
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", Linear(in_dim if i == 0 else fc_dim, fc_dim))

    def forward(self, x):
        for i in range(self.num_fc):
            x = torch.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class CubeHead(nn.Module):
    def __init__(self, in_dim: int, num_classes: int, num_fc: int = 2,
                 fc_dim: int = 1024, shared_fc: bool = True, pose_type: str = "6d",
                 cluster_bins: int = 1, use_confidence: float = 1.0):
        super().__init__()
        C = num_classes
        self.num_classes = C
        self.shared_fc = shared_fc
        self.pose_type = pose_type
        self.cluster_bins = cluster_bins
        self.use_confidence = use_confidence
        if shared_fc:
            self.feature_generator = _FeatureGenerator(in_dim, num_fc, fc_dim)
        else:
            for branch, name in _BRANCHES.items():
                if branch != "conf" or use_confidence:
                    self.add_module(f"feature_generator_{name}",
                                    _FeatureGenerator(in_dim, num_fc, fc_dim))
        self.bbox_3D_center_deltas = Linear(fc_dim, C * 2)
        self.bbox_3D_dims = Linear(fc_dim, C * 3)
        self.bbox_3D_pose = Linear(fc_dim, C * _POSE_DIM[pose_type])
        self.bbox_3D_center_depth = Linear(fc_dim, C * max(cluster_bins, 1))
        if use_confidence:
            self.bbox_3D_uncertainty = Linear(fc_dim, C)

    def forward(self, x: torch.Tensor):
        """x: (..., 7, 7, C) pooled features -> per-class 3D outputs."""
        x = x.reshape(x.shape[:-3] + (-1,))
        lead = x.shape[:-1]
        C = self.num_classes
        if self.shared_fc:
            f = self.feature_generator(x)
            f_xy = f_dims = f_pose = f_z = f_conf = f
        else:
            f_xy, f_dims, f_pose, f_z = (
                getattr(self, f"feature_generator_{_BRANCHES[b]}")(x)
                for b in ("xy", "dims", "pose", "z"))
            f_conf = self.feature_generator_conf(x) if self.use_confidence else None

        deltas_2d = self.bbox_3D_center_deltas(f_xy).reshape(lead + (C, 2))
        dims = self.bbox_3D_dims(f_dims).reshape(lead + (C, 3))
        pose_raw = self.bbox_3D_pose(f_pose).reshape(
            lead + (C, _POSE_DIM[self.pose_type]))
        if self.pose_type == "6d":
            pose = rotations.rotation_6d_to_matrix(pose_raw)
        elif self.pose_type == "quaternion":
            # sign-normalise by w (pytorch3d _copysign)
            q0 = pose_raw[..., 0:1]
            pose = rotations.quaternion_to_matrix(
                pose_raw * torch.sign(torch.where(q0 == 0, torch.ones_like(q0), q0)))
        else:
            pose = rotations.euler_angles_to_matrix(pose_raw, "XYZ")

        z = self.bbox_3D_center_depth(f_z)
        if self.cluster_bins > 1:
            z = z.reshape(lead + (self.cluster_bins, C))
        else:
            z = z.reshape(lead + (C,))

        uncert = None
        if self.use_confidence:
            uncert = self.bbox_3D_uncertainty(f_conf).clamp(min=0.01)
        return deltas_2d, z, dims, pose, uncert
