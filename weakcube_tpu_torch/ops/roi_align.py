"""ROIAlignV2 over an FPN pyramid: the plain PyTorch version.

The gather formulation of weakcube_tpu/ops/roi_align.py:31-151. Each RoI is
assigned a pyramid level by the detectron2 heuristic, its 2x2-per-bin sample
grid is laid with the aligned (-0.5) offset, samples clamp to the level's
border and are interpolated bilinearly, and each bin averages its samples.

`multilevel_roi_align_backward` is its transpose, the feature gradient: an
explicit scatter (`index_add_`) of the four corner weights of every sample.

These are the versions the CPU tests run and the ones the CUDA kernels
(ops/roi_align_cuda.py, csrc/roi_align.cu) are held against on the card.
They compute in float32 (float64 for float64 input) and return the feature
dtype, as the kernels do (in float32).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def assign_fpn_levels(boxes: torch.Tensor, min_level: int, max_level: int,
                      canonical_level: int = 4,
                      canonical_size: float = 224.0) -> torch.Tensor:
    """detectron2 `assign_boxes_to_levels`: (..., 4) XYXY -> level index
    (int64 in [min_level, max_level])."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    scale = torch.sqrt(w * h)
    lvl = torch.floor(canonical_level + torch.log2(scale / canonical_size + 1e-8))
    return lvl.clamp(min_level, max_level).long()


def multilevel_roi_align(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    strides: Sequence[int],
    output_size: int = 7,
    sampling_ratio: int = 2,
    min_level: int = 2,
) -> torch.Tensor:
    """ROIAlignV2 over a feature pyramid.

    Args:
      features: NHWC maps, finest first, (B, H_l, W_l, C) each.
      boxes: (B, R, 4) XYXY in input-image coordinates.
      strides: stride of each level w.r.t. the input image.
      output_size: pooled spatial size (7 -> 7x7).
      sampling_ratio: samples per bin edge (2 -> 2x2 averaged per bin).
      min_level: pyramid level index of features[0].
    Returns:
      (B, R, output_size, output_size, C) in the features' dtype.
    """
    B, R, _ = boxes.shape
    C = features[0].shape[-1]
    acc = torch.promote_types(features[0].dtype, torch.float32)  # float64 stays
    flat = torch.cat([f.reshape(B, -1, C) for f in features], 1).to(acc)
    S = sampling_ratio
    P = output_size * S
    bidx = torch.arange(B, device=boxes.device)[:, None]
    samples = torch.zeros((B, R, P, P, C), dtype=acc, device=boxes.device)
    for idx, w in _corners(boxes, [f.shape[1:3] for f in features], strides,
                           output_size, S, min_level):
        g = flat[bidx, idx].reshape(B, R, P, P, C)
        samples += g * w[..., None].to(acc)

    pooled = samples.reshape(B, R, output_size, S, output_size, S, C)
    return pooled.mean(dim=(3, 5)).to(features[0].dtype)


def multilevel_roi_align_backward(g: torch.Tensor, boxes: torch.Tensor,
                                  level_shapes: Sequence[Sequence[int]],
                                  level_dtypes: Sequence[torch.dtype],
                                  strides: Sequence[int], output_size: int = 7,
                                  sampling_ratio: int = 2, min_level: int = 2):
    """The feature gradient of `multilevel_roi_align`: g (B, R, P, P, C) ->
    one (B, H_l, W_l, C) gradient per level (NHWC-contiguous, in
    level_dtypes), accumulated in float32. Each sample spreads g / sr^2 over
    its four bilinear corners by `index_add_`."""
    B, R = boxes.shape[:2]
    C = g.shape[-1]
    S = sampling_ratio
    P = output_size * S
    hw = [tuple(s[1:3]) for s in level_shapes]
    n_pix = sum(h * w for h, w in hw)
    acc = torch.promote_types(g.dtype, torch.float32)  # float64 stays
    gs = g.to(acc).repeat_interleave(S, 2).repeat_interleave(S, 3) / (S * S)
    buf = torch.zeros((B * n_pix, C), dtype=acc, device=g.device)
    base = (torch.arange(B, device=g.device) * n_pix)[:, None]
    for idx, w in _corners(boxes, hw, strides, output_size, S, min_level):
        buf.index_add_(0, (idx + base).reshape(-1),
                       (gs * w[..., None]).to(acc).reshape(B * R * P * P, C))
    buf = buf.reshape(B, n_pix, C)
    grads, off = [], 0
    for (h, w), dt in zip(hw, level_dtypes):
        grads.append(buf[:, off:off + h * w].reshape(B, h, w, C).to(dt).contiguous())
        off += h * w
    return grads


def _corners(boxes: torch.Tensor, level_hw, strides: Sequence[int],
             output_size: int, S: int, min_level: int):
    """The sampling plan of every RoI on its level: four (flat pixel index
    (B, R*P*P) into the levels concatenated per image, weight (B, R, P, P))
    pairs, one per bilinear corner."""
    B, R, _ = boxes.shape
    dev = boxes.device
    max_level = min_level + len(level_hw) - 1

    offsets, heights, widths = [], [], []
    off = 0
    for H, W in level_hw:
        offsets.append(off)
        heights.append(H)
        widths.append(W)
        off += H * W
    offsets = torch.tensor(offsets, device=dev)
    heights = torch.tensor(heights, device=dev)
    widths = torch.tensor(widths, device=dev)
    inv_strides = torch.tensor([1.0 / s for s in strides], device=dev)

    levels = assign_fpn_levels(boxes, min_level, max_level) - min_level  # (B, R)
    lvl_off = offsets[levels]
    lvl_h = heights[levels]
    lvl_w = widths[levels]
    lvl_scale = inv_strides[levels]

    # sample coordinates (V2: aligned, -0.5 offset)
    x1 = boxes[..., 0] * lvl_scale - 0.5
    y1 = boxes[..., 1] * lvl_scale - 0.5
    x2 = boxes[..., 2] * lvl_scale - 0.5
    y2 = boxes[..., 3] * lvl_scale - 0.5
    roi_w = (x2 - x1).clamp(min=1e-6)
    roi_h = (y2 - y1).clamp(min=1e-6)

    P = output_size * S
    # (p + 0.5) / P correctly rounded, as the kernel computes it (PyTorch's
    # CUDA division by a scalar multiplies by the reciprocal instead)
    grid = torch.from_numpy((np.arange(P, dtype=np.float32) + np.float32(0.5))
                            / np.float32(P)).to(dev)
    sx = x1[..., None] + roi_w[..., None] * grid          # (B, R, P)
    sy = y1[..., None] + roi_h[..., None] * grid

    def _prep(coord, size):
        # bilinear neighbours, clamped to the level's border
        c = torch.minimum(coord.clamp(min=0.0), (size[..., None] - 1).float())
        lo = torch.floor(c)
        frac = c - lo
        lo = lo.long()
        hi = torch.minimum(lo + 1, size[..., None] - 1)
        return lo, hi, frac

    x_lo, x_hi, fx = _prep(sx, lvl_w)
    y_lo, y_hi, fy = _prep(sy, lvl_h)
    for yy, xx, wy, wx in ((y_lo, x_lo, 1.0 - fy, 1.0 - fx), (y_lo, x_hi, 1.0 - fy, fx),
                           (y_hi, x_lo, fy, 1.0 - fx), (y_hi, x_hi, fy, fx)):
        idx = (lvl_off[..., None, None] + yy[..., :, None] * lvl_w[..., None, None]
               + xx[..., None, :]).reshape(B, R * P * P)
        yield idx, wy[..., :, None] * wx[..., None, :]
