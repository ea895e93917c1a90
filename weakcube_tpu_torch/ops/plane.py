"""Ground-plane fits (weakcube_tpu/ops/plane.py).

`ransac_plane` fits a plane to masked point clouds by RANSAC, a batch of
clouds in one pass: every hypothesis of every cloud is drawn, built from its
point triple and scored against every point at once, and the first
hypothesis with the most inliers wins. Draws come from an explicit
`torch.Generator`, or are injected (`draws`) so that a test can hand it the
JAX package's.

`ground_normal_np` is the data pipeline's deterministic fit (numpy): an SVD
least-squares plane with a few rounds of inlier re-selection, computed once
per image and cached by the mapper.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import global_rows, local_rows


def ransac_plane(pts: torch.Tensor, valid: Optional[torch.Tensor] = None,
                 thresh: float = 0.05, num_hypotheses: int = 1000,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit a plane to each masked point cloud of a batch by RANSAC.

    pts: (..., N, 3), in a data-parallel run (B, N, 3) with this rank's B
    images; valid: (..., N) bool (default all valid): invalid
    points are never drawn and never count as inliers. Each hypothesis draws
    3 indices in [0, N) with replacement (`draws`, (..., H, 3) or (H, 3),
    replaces the draw), taken modulo the valid count into the valid points
    compacted to the front (a stable sort). A degenerate triple (normal
    norm < 1e-9) scores -1; the first hypothesis with the most inliers
    (distance <= thresh) wins.
    Returns (equation (..., 4) [A, B, C, D] with a unit normal, negated as
    the reference returns it; inliers (..., N) bool of the winner).
    """
    n = pts.shape[-2]
    batch = pts.shape[:-2]
    if valid is None:
        valid = torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    if draws is None:
        # the global batch's draws, this rank's rows (ops/sampling.py::gumbel)
        draws = local_rows(torch.randint(0, n, global_rows((*batch, num_hypotheses, 3)),
                                         generator=generator, device=pts.device))
    draws = draws.to(pts.device).expand(*batch, *draws.shape[-2:])
    H = draws.shape[-2]
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)  # valid first
    V = valid.sum(-1).clamp(min=1)
    slot = draws.long() % V[..., None, None]
    idx = torch.gather(order, -1, slot.reshape(*batch, H * 3))
    tri = torch.gather(pts, -2, idx[..., None].expand(*batch, H * 3, 3)).reshape(*batch, H, 3, 3)
    normal = torch.linalg.cross(tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 0, :],
                                dim=-1)
    norm = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    normal = normal / norm.clamp(min=1e-12)
    k = -(normal * tri[..., 1, :]).sum(-1)                          # (..., H)
    degenerate = norm[..., 0] < 1e-9
    dist = torch.abs(pts @ normal.transpose(-1, -2) + k[..., None, :])   # (..., N, H)
    inl = (dist <= thresh) & valid[..., None]
    counts = torch.where(degenerate, torch.full_like(k, -1, dtype=torch.long), inl.sum(-2))
    best = torch.argmax(counts, dim=-1)                             # the first maximum
    sel = best[..., None, None].expand(*batch, 1, 3)
    eq = torch.cat([torch.gather(normal, -2, sel)[..., 0, :],
                    torch.gather(k, -1, best[..., None])], -1)
    inliers = torch.gather(inl, -1, best[..., None, None].expand(*batch, n, 1))[..., 0]
    return -eq, inliers


def up_vector_from_plane(equation: torch.Tensor) -> torch.Tensor:
    """The plane's unit normal, oriented as an up vector in camera space (y
    points down, so a normal with positive y is flipped)."""
    n = equation[..., :3]
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.where(n[..., 1:2] > 0, -n, n)


def wall_flip(n: torch.Tensor) -> torch.Tensor:
    """The reference's orientation fixes of a fitted ground normal (..., 3),
    in their order: a normal closer to z than to y is rotated into y, one
    closer to x than to y is rotated again, and the result points +y."""
    a = n.abs()
    n = torch.where((a[..., 2] > a[..., 1])[..., None],
                    torch.stack([n[..., 0], n[..., 2], -n[..., 1]], -1), n)
    a = n.abs()
    n = torch.where((a[..., 0] > a[..., 1])[..., None],
                    torch.stack([-n[..., 2], n[..., 0], n[..., 1]], -1), n)
    return torch.where(n[..., 1:2] < 0, -n, n)


def ground_normal_np(depth, K, mask=None, use_nth: int = 5,
                     thresh: float = 0.05, iters: int = 3):
    """Host-side (numpy) ground normal from a depth map: backproject the
    masked points of the map subsampled by `use_nth`, fit a plane by SVD
    least squares with `iters` rounds of inlier re-selection at the RANSAC
    threshold, then apply the wall-flip orientation fixes.

    Returns (normal (3,) float32, ok bool). `ok` is False when fewer than
    16 masked points exist.
    """
    depth = np.asarray(depth, np.float32)
    z = depth[::use_nth, ::use_nth]
    h, w = z.shape
    m = np.ones_like(z, bool) if mask is None else \
        np.asarray(mask)[::use_nth, ::use_nth] > 0
    m = m & (z > 1e-6)
    if m.sum() < 16:
        return np.array([0.0, 1.0, 0.0], np.float32), False
    K = np.asarray(K, np.float32)
    u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    fx = max(K[0, 0] / use_nth, 1e-6)
    fy = max(K[1, 1] / use_nth, 1e-6)
    x = (u - w / 2.0) * z / fx
    y = (v - h / 2.0) * z / fy
    pts = np.stack([x[m], y[m], z[m]], -1)
    if len(pts) > 10000:   # SVD cost cap; the stride keeps spatial coverage
        pts = pts[:: len(pts) // 10000 + 1]

    sel = np.ones(len(pts), bool)
    n = np.array([0.0, 1.0, 0.0], np.float32)
    d0 = 0.0
    for _ in range(iters):
        p = pts[sel]
        if len(p) < 3:
            break
        c = p.mean(0)
        _, _, vt = np.linalg.svd(p - c, full_matrices=False)
        n = vt[-1]
        n = n / max(np.linalg.norm(n), 1e-12)
        d0 = -float(n @ c)
        dist = np.abs(pts @ n + d0)
        new_sel = dist <= thresh
        if new_sel.sum() < 16 or np.array_equal(new_sel, sel):
            break
        sel = new_sel

    # the wall-flip orientation fixes, as wall_flip applies them
    ax, ay, az = np.abs(n)
    if az > ay:
        n = np.array([n[0], n[2], -n[1]], np.float32)
    ax, ay = np.abs(n[0]), np.abs(n[1])
    if ax > ay:
        n = np.array([-n[2], n[0], n[1]], np.float32)
    if n[1] < 0:
        n = -n
    return n.astype(np.float32), True
