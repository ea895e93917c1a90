"""The comparison that decides `correct` in a depth cell: the float16 maps
the timed path produced against the reference's maps of the same images.

Each gap is a pixel's |program - reference| in metres against the
reference map's own standard deviation over its pixels (at least 1 mm), so
that it reads the same whatever the draw of weights makes the maps' scale.
`depth_max_gap` is the widest gap over every pixel of every compared image:
one region placed wrong shows there. `depth_mean_gap` is the mean gap over
all those pixels: a drift spread over the whole map shows there."""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

STD_FLOOR_M = 1e-3
NUMBERS = ("depth_max_gap", "depth_mean_gap")


def compare_maps(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]) -> Dict[str, float]:
    """Lists of (h, w) maps, image by image; a map missing, misshapen or not
    finite counts as infinitely far."""
    if len(prog) != len(ref) or not ref:
        return dict.fromkeys(NUMBERS, math.inf)
    worst, total, n = 0.0, 0.0, 0
    for p, r in zip(prog, ref):
        p, r = p.double(), r.double()
        if p.shape != r.shape or not torch.isfinite(p).all():
            return dict.fromkeys(NUMBERS, math.inf)
        g = (p - r).abs() / max(float(r.std()), STD_FLOOR_M)
        worst = max(worst, float(g.max()))
        total += float(g.sum())
        n += g.numel()
    return {"depth_max_gap": worst, "depth_mean_gap": total / n}


def map_stats(ref: Sequence[torch.Tensor]) -> str:
    """The reference maps' spread, for the run's notes: each map's standard
    deviation over its pixels (least, greatest) and the range of depths."""
    stds = [float(r.float().std()) for r in ref]
    lo = min(float(r.float().min()) for r in ref)
    hi = max(float(r.float().max()) for r in ref)
    return (f"reference maps: std over pixels {min(stds):.4f}-{max(stds):.4f} m, depth "
            f"{lo:.3f}-{hi:.3f} m over {len(ref)} images")
