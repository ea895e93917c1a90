"""Per-category priors from training annotations (a copy of
weakcube_tpu/models/priors.py).

Equivalent of cubercnn/util/math_util.py:318-524 `compute_priors`: per
category dimension mean/std, depth stats, and (for CLUSTER_BINS > 1)
K-means-style 2D-scale cluster bins with per-cluster z statistics.
Host-side numpy (runs once at setup).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def compute_priors(cfg, records: Sequence[Dict],
                   num_classes: int | None = None) -> Dict[str, np.ndarray]:
    C = num_classes or cfg.MODEL.ROI_HEADS.NUM_CLASSES
    bins = cfg.MODEL.ROI_CUBE_HEAD.CLUSTER_BINS
    virtual_depth = cfg.MODEL.ROI_CUBE_HEAD.VIRTUAL_DEPTH
    virtual_focal = cfg.MODEL.ROI_CUBE_HEAD.VIRTUAL_FOCAL

    dims_per_cat: List[List[np.ndarray]] = [[] for _ in range(C)]
    z_per_cat: List[List[float]] = [[] for _ in range(C)]
    scale_per_cat: List[List[float]] = [[] for _ in range(C)]

    for rec in records:
        K = np.asarray(rec["K"], np.float32)
        f = K[1, 1]
        H = rec["height"]
        for a in rec.get("annotations", []):
            if a.get("ignore", False):
                continue
            cid = a["category_id"]
            if not (0 <= cid < C):
                continue
            dims_per_cat[cid].append(np.asarray(a["dimensions"], np.float32))
            z = float(a["center_cam"][2])
            if virtual_depth:
                # scale z into virtual focal space (math_util.py:417-424)
                z = z * (H * virtual_focal) / (f * H)
            z_per_cat[cid].append(z)
            b = a["bbox"]
            scale_per_cat[cid].append(
                float(np.hypot(b[2] - b[0], b[3] - b[1])))

    priors_dims = np.zeros((C, 2, 3), np.float32)
    priors_z3d = np.zeros((C, 2), np.float32)
    priors_y3d = np.zeros((C, 2), np.float32)
    for c in range(C):
        if dims_per_cat[c]:
            d = np.stack(dims_per_cat[c])
            priors_dims[c, 0] = d.mean(0)
            priors_dims[c, 1] = np.maximum(d.std(0), 1e-3)
            z = np.asarray(z_per_cat[c])
            priors_z3d[c] = [z.mean(), max(z.std(), 1e-3)]
        else:
            priors_dims[c, 0] = 1.0
            priors_dims[c, 1] = 0.5
            priors_z3d[c] = [5.0, 3.0]

    out = {
        "priors_dims_per_cat": priors_dims,
        "priors_z3d_per_cat": priors_z3d,
        "priors_y3d_per_cat": priors_y3d,
    }

    if bins > 1:
        # K-means over log 2D scale, shared binning per category
        z_scales = np.zeros((C, bins), np.float32)
        z_stats = np.zeros((C, bins, 2), np.float32)
        for c in range(C):
            if not scale_per_cat[c]:
                z_scales[c] = np.linspace(64, 512, bins)
                z_stats[c, :, 0] = 5.0
                z_stats[c, :, 1] = 3.0
                continue
            s = np.asarray(scale_per_cat[c])
            zs = np.asarray(z_per_cat[c])
            qs = np.quantile(s, np.linspace(0, 1, bins + 1))
            for b in range(bins):
                m = (s >= qs[b]) & (s <= qs[b + 1])
                z_scales[c, b] = s[m].mean() if m.any() else s.mean()
                if m.any():
                    z_stats[c, b] = [zs[m].mean(), max(zs[m].std(), 1e-3)]
                else:
                    z_stats[c, b] = [zs.mean(), max(zs.std(), 1e-3)]
        out["priors_z_scales"] = z_scales
        out["priors_z_stats"] = z_stats
    return out
