"""Exact 3D cuboid intersection-over-union (weakcube_tpu/ops/iou3d.py).

Each box contributes 12 boundary triangles and 6 outward half-planes. Every
triangle of A is clipped against the 6 half-planes of B (Sutherland-Hodgman:
a convex polygon stays one convex polygon of at most 3 + 6 vertices, held
in buffers of 10) and vice versa; the surviving polygons bound the
intersection, whose volume is the divergence-theorem sum (1/6) sum
det(v0, vi, vi+1) over their fans.

Plain PyTorch, batched over (pairs, 24 triangles) with a loop over the 6
planes only. A face of A that lies on a plane of B is kept in A's pass
(inclusive +_EPS) and cut in B's (strict -_EPS), so a shared boundary
counts once. The corner order is ops/cuboids.py's.
"""
from __future__ import annotations

from typing import Tuple

import torch

_MAXV = 10          # 3 initial + 6 clips + 1 slack
_EPS = 1e-6

# 12 boundary triangles, outward-consistent (weakcube_tpu/ops/cuboids.py)
CUBE_FACES = (
    (0, 1, 2), (2, 3, 0),   # front  (z-)
    (1, 5, 6), (6, 2, 1),   # right  (x+)
    (4, 0, 3), (3, 7, 4),   # left   (x-)
    (5, 4, 7), (7, 6, 5),   # back   (z+)
    (4, 5, 1), (1, 0, 4),   # top    (y-)
    (3, 2, 6), (6, 7, 3),   # bottom (y+)
)
_QUADS = ((0, 1, 2, 3), (1, 5, 6, 2), (4, 0, 3, 7), (5, 4, 7, 6), (4, 5, 1, 0), (3, 2, 6, 7))


def box_planes(corners: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 6 outward half-planes of cuboids (..., 8, 3): (points (..., 6, 3),
    unit outward normals (..., 6, 3))."""
    pts = corners[..., torch.tensor(_QUADS, device=corners.device), :]   # (..., 6, 4, 3)
    centers = pts.mean(-2)
    n = torch.linalg.cross(pts[..., 1, :] - pts[..., 0, :], pts[..., 2, :] - pts[..., 0, :],
                           dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp(min=1e-12)
    box_center = corners.mean(-2, keepdim=True)
    outward = (n * (centers - box_center)).sum(-1, keepdim=True)
    return centers, n * torch.sign(torch.where(outward.abs() < 1e-12,
                                               torch.ones_like(outward), outward))


def _clip_halfplane(verts, count, plane_pt, plane_n, eps):
    """Clip convex polygons verts (M, _MAXV, 3) with `count` (M,) live
    vertices to {x : (x - p) . n <= eps} (eps (M,): > 0 keeps points on the
    plane, < 0 cuts them). Inside vertices and crossing points are emitted
    interleaved, in order, and compacted to the front; dead slots repeat the
    first vertex."""
    idx = torch.arange(_MAXV, device=verts.device)
    active = idx < count[:, None]
    nxt_idx = torch.where(idx + 1 < count[:, None], idx + 1, torch.zeros_like(idx))
    nxt = torch.gather(verts, 1, nxt_idx[..., None].expand(-1, -1, 3))
    d_cur = ((verts - plane_pt[:, None]) * plane_n[:, None]).sum(-1)
    d_nxt = ((nxt - plane_pt[:, None]) * plane_n[:, None]).sum(-1)
    in_cur = d_cur <= eps[:, None]
    in_nxt = d_nxt <= eps[:, None]
    denom = d_cur - d_nxt
    t = d_cur / torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    inter = verts + t.clamp(0.0, 1.0)[..., None] * (nxt - verts)
    emit_cur = active & in_cur
    emit_inter = active & (in_cur != in_nxt)
    M = verts.shape[0]
    cand = torch.stack([verts, inter], 2).reshape(M, 2 * _MAXV, 3)
    flags = torch.stack([emit_cur, emit_inter], 2).reshape(M, 2 * _MAXV)
    keys = torch.where(flags, torch.arange(2 * _MAXV, device=verts.device),
                       torch.full_like(flags, 2 * _MAXV + 1, dtype=torch.long))
    order = torch.argsort(keys, dim=1, stable=True)[:, :_MAXV]
    new_verts = torch.gather(cand, 1, order[..., None].expand(-1, -1, 3))
    new_count = flags.sum(1).clamp(max=_MAXV)
    live = idx < new_count[:, None]
    return torch.where(live[..., None], new_verts, new_verts[:, :1]), new_count


def _intersection_volume(corners1: torch.Tensor, corners2: torch.Tensor) -> torch.Tensor:
    """Intersection volumes of aligned cuboid pairs (P, 8, 3) x (P, 8, 3) -> (P,)."""
    P = corners1.shape[0]
    faces = torch.tensor(CUBE_FACES, device=corners1.device)
    p1, n1 = box_planes(corners1)
    p2, n2 = box_planes(corners2)
    # A's triangles against B's planes (inclusive), B's against A's (strict)
    tris = torch.cat([corners1[:, faces], corners2[:, faces]], 1)      # (P, 24, 3, 3)
    plane_pt = torch.cat([p2[:, None].expand(P, 12, 6, 3), p1[:, None].expand(P, 12, 6, 3)], 1)
    plane_n = torch.cat([n2[:, None].expand(P, 12, 6, 3), n1[:, None].expand(P, 12, 6, 3)], 1)
    eps = torch.cat([torch.full((P, 12), _EPS), torch.full((P, 12), -_EPS)], 1)
    M = P * 24
    verts = torch.cat([tris, tris[:, :, :1].expand(P, 24, _MAXV - 3, 3)], 2).reshape(M, _MAXV, 3)
    count = torch.full((M,), 3, dtype=torch.long, device=corners1.device)
    plane_pt, plane_n = plane_pt.reshape(M, 6, 3), plane_n.reshape(M, 6, 3)
    eps = eps.to(device=corners1.device, dtype=corners1.dtype).reshape(M)
    for i in range(6):
        verts, count = _clip_halfplane(verts, count, plane_pt[:, i], plane_n[:, i], eps)
    fan = torch.arange(1, _MAXV - 1, device=verts.device)
    det = (verts[:, :1] * torch.linalg.cross(verts[:, fan], verts[:, fan + 1], dim=-1)).sum(-1)
    vol = torch.where(fan + 1 < count[:, None], det, torch.zeros_like(det)).sum(-1) / 6.0
    return vol.reshape(P, 24).sum(-1).abs()


def box_volume(corners: torch.Tensor) -> torch.Tensor:
    """Volume of cuboids from their (..., 8, 3) corners (|det| of the edge
    frame)."""
    e1 = corners[..., 1, :] - corners[..., 0, :]
    e2 = corners[..., 3, :] - corners[..., 0, :]
    e3 = corners[..., 4, :] - corners[..., 0, :]
    return torch.abs((e1 * torch.linalg.cross(e2, e3, dim=-1)).sum(-1))


def pairwise_iou3d(corners1: torch.Tensor, corners2: torch.Tensor):
    """Exact IoU3D between all pairs: (N, 8, 3) x (M, 8, 3) -> (intersection
    volume, iou), both (N, M). Degenerate (near-zero-volume) boxes give IoU 0."""
    N, M = corners1.shape[0], corners2.shape[0]
    inter = _intersection_volume(
        corners1[:, None].expand(N, M, 8, 3).reshape(N * M, 8, 3),
        corners2[None].expand(N, M, 8, 3).reshape(N * M, 8, 3)).reshape(N, M)
    v1, v2 = box_volume(corners1)[:, None], box_volume(corners2)[None, :]
    union = v1 + v2 - inter
    good = (v1 > 1e-8) & (v2 > 1e-8) & (union > 1e-12)
    iou = torch.where(good, inter / union.clamp(min=1e-12), torch.zeros_like(inter))
    return inter, iou.clamp(0.0, 1.0)


def matched_iou3d(corners1: torch.Tensor, corners2: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU3D of aligned (N, 8, 3) arrays -> (N,)."""
    inter = _intersection_volume(corners1, corners2)
    v1, v2 = box_volume(corners1), box_volume(corners2)
    union = v1 + v2 - inter
    good = (v1 > 1e-8) & (v2 > 1e-8) & (union > 1e-12)
    return torch.where(good, (inter / union.clamp(min=1e-12)).clamp(0.0, 1.0),
                       torch.zeros_like(inter))
