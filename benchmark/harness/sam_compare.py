"""The comparison that decides `correct` in a SAM cell: the float32
low-resolution mask logits (1, S/4, S/4) that the timed path's forward
produced against the reference's logits for the same image and box.

Each gap is a pixel's |program - reference| against the reference logits'
own standard deviation over that image's pixels (at least STD_FLOOR), so
that it reads the same whatever the draw of weights makes the logits'
scale. `mask_max_gap` is the widest gap over every pixel of every compared
image: one region placed wrong shows there. `mask_mean_gap` is the mean
gap over all those pixels: a drift spread over the whole mask shows there.
The thresholded masks are not compared (a pixel near 0 flips with any
rounding); the share of pixels whose sign differs is reported beside."""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

STD_FLOOR = 1e-6
NUMBERS = ("mask_max_gap", "mask_mean_gap")


def compare_logits(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]) -> Dict[str, float]:
    """Lists of per-image logits of one shape each; one missing, misshapen
    or not finite counts as infinitely far."""
    if len(prog) != len(ref) or not ref:
        return dict.fromkeys(NUMBERS, math.inf)
    worst, total, n = 0.0, 0.0, 0
    for p, r in zip(prog, ref):
        p, r = p.double().cpu(), r.double().cpu()
        if p.shape != r.shape or not torch.isfinite(p).all():
            return dict.fromkeys(NUMBERS, math.inf)
        g = (p - r).abs() / max(float(r.std()), STD_FLOOR)
        worst = max(worst, float(g.max()))
        total += float(g.sum())
        n += g.numel()
    return {"mask_max_gap": worst, "mask_mean_gap": total / n}


def disagreeing_share(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]) -> float:
    """The share of low-resolution mask pixels (logit > 0) on which the two
    sides differ, over every compared image; not a compared number."""
    diff = sum(int(((p.cpu() > 0) != (r.cpu() > 0)).sum()) for p, r in zip(prog, ref))
    return diff / max(sum(r.numel() for r in ref), 1)


def logit_stats(ref: Sequence[torch.Tensor]) -> str:
    """The reference logits' spread, for the run's notes: each image's
    standard deviation over its pixels (least, greatest), the range of
    means and the share of mask pixels (logit > 0)."""
    stds = [float(r.float().std()) for r in ref]
    means = [float(r.float().mean()) for r in ref]
    pos = sum(int((r > 0).sum()) for r in ref) / max(sum(r.numel() for r in ref), 1)
    return (f"reference logits: std over pixels {min(stds):.4f}-{max(stds):.4f}, mean "
            f"{min(means):.4f}-{max(means):.4f}, mask share {pos:.4f} over {len(ref)} images")
