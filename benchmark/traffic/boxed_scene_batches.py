"""Traffic kind `boxed_scene_batches`: the pool of `scene_batches` (its
parameters as they are there), each image with one box prompt drawn from
the seed.

Extra parameter (the cell's "traffic" object):
  box_band   {"x0", "y0", "x1", "y1"}: for each corner coordinate the
             [low, high] range, as shares of the image's width (x) or
             height (y), that the box's corner is drawn from uniformly

Each batch gains "boxes": (batch, 4) float32 XYXY in the image's pixels.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from harness.common import sub_seed


def generate(params: dict, seed: int) -> List[Dict[str, np.ndarray]]:
    from harness.spec import load_file_module
    pool = load_file_module("traffic", "scene_batches").generate(params, seed)
    band = params["box_band"]
    rng = np.random.default_rng(sub_seed(seed, "boxes"))
    for b in pool:
        wh = np.asarray(b["image_wh"], np.float64)
        u = {k: rng.uniform(band[k][0], band[k][1], len(wh)) for k in ("x0", "y0", "x1", "y1")}
        b["boxes"] = np.stack([u["x0"] * wh[:, 0], u["y0"] * wh[:, 1],
                               u["x1"] * wh[:, 0], u["y1"] * wh[:, 1]], 1).astype(np.float32)
    return pool
