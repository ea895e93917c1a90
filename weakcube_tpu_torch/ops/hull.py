"""Differentiable convex-hull rasterisation (weakcube_tpu/ops/hull.py).

The reference fills the hull of the 8 projected cube corners by a Jarvis
march and a soft polygon fill. For a fixed small point set the hull has a
closed form: the ordered pair (i, j) is a hull edge when every other point
lies on one side of the line i -> j. All 8 x 8 pairs are evaluated at once;
each edge contributes the soft half-plane clip(signed value, 0, 1), every
other pair 1, and the product over pairs is the filled mask.

Batched over leading dimensions: points (..., N, 2). The clip is written
as minimum(maximum(.)) so that its gradient at exactly 0 and 1 is 1/2, as
jnp.clip's is (torch.clamp gives 1): pixel centres on a hull edge, which
corners on integer pixel coordinates produce, meet it.
"""
from __future__ import annotations

import torch


def hull_edges(points: torch.Tensor, eps: float = 1e-6):
    """Convex-hull edges among the ordered point pairs.

    points: (..., N, 2). Returns (is_edge, sign), both (..., N, N): pair
    (i, j) is a hull edge with the interior on the positive side of
    sign * cross(p_j - p_i, p - p_i)."""
    n = points.shape[-2]
    d = points[..., None, :, :] - points[..., :, None, :]          # (..., i, j, 2): p_j - p_i
    # cross(p_j - p_i, p_k - p_i) at (..., i, j, k)
    cross = d[..., :, :, None, 0] * d[..., :, None, :, 1] \
        - d[..., :, :, None, 1] * d[..., :, None, :, 0]
    eye = torch.eye(n, dtype=torch.bool, device=points.device)
    other = ~(eye[:, :, None] | eye[:, None, :] | eye[None, :, :])  # k differs from i and j
    all_pos = ((cross >= -eps) | ~other).all(-1)
    all_neg = ((cross <= eps) | ~other).all(-1)
    nondegenerate = (d * d).sum(-1) > eps
    is_edge = (all_pos | all_neg) & nondegenerate & ~eye
    one = torch.ones((), dtype=points.dtype, device=points.device)
    return is_edge, torch.where(all_pos, one, -one)


def soft_hull_mask(points: torch.Tensor, height: int, width: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """Soft-rasterise the convex hull of points (..., N, 2) into
    (..., height, width): pixel (x, y) gets the product over hull edges of
    clip(signed value, 0, 1), so corners whose edge passes within 1 px of
    a pixel centre get a gradient."""
    is_edge, sign = hull_edges(points, eps)
    ys = torch.arange(height, dtype=points.dtype, device=points.device)
    xs = torch.arange(width, dtype=points.dtype, device=points.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")                 # (H, W)
    d = points[..., None, :, :] - points[..., :, None, :]          # (..., i, j, 2)
    # signed value of pixel p against the line i -> j:
    # cross(p_j - p_i, p - p_i) = d_x (p_y - p_i,y) - d_y (p_x - p_i,x)
    px = gx - points[..., :, None, 0, None, None]                  # (..., i, 1, H, W)
    py = gy - points[..., :, None, 1, None, None]
    val = (d[..., 0, None, None] * py - d[..., 1, None, None] * px) * sign[..., None, None]
    zero, one = val.new_zeros(()), val.new_ones(())
    soft = torch.minimum(torch.maximum(val, zero), one)
    soft = torch.where(is_edge[..., None, None], soft, one)        # non-edges are neutral
    return soft.flatten(-4, -3).prod(-3)
