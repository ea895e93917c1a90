"""Faults planted under the depth cell's timed path, for the checks that
`correct` comes out false there: each patches the port's depth model where
the fault would be produced and returns a function that undoes it.

Importing this module adds them to harness/faults.py's FAULTS, under the
names below, so that calibrate.py's --fault finds them once it has loaded
the depth runner (which imports this module)."""
from __future__ import annotations

import torch
import torch.nn as nn

from . import faults


def _model():
    from weakcube_tpu_torch.data.pseudo_gt import depth_anything_v2
    return depth_anything_v2


def half_batch_depth():
    """The forward computes the first half of the batch and hands its maps
    to the second half too."""
    m = _model()
    real = m.DepthAnythingV2.forward

    def half(self, x):
        B = x.shape[0]
        d = real(self, x[: max(B // 2, 1)])
        return torch.cat([d, d])[:B]
    return faults._patch(m.DepthAnythingV2, "forward", half)


def depth_map_altered():
    """The first map of every batch is placed 1 m deeper over its first
    patch (14 x 14 pixels of the model's input)."""
    m = _model()
    real = m.DepthAnythingV2.forward

    def altered(self, x):
        d = real(self, x).clone()
        d[0, :m.PATCH, :m.PATCH] += 1.0
        return d
    return faults._patch(m.DepthAnythingV2, "forward", altered)


def block_skipped():
    """The encoder leaves out its last block. It feeds only the deepest
    tap, so of blocks 0, 12 and 23 its absence moved the maps least (a CPU
    check at ViT-L widths and 98 px): the hardest of them to see."""
    m = _model()
    real = m.DINOv2.forward

    def skipped(self, x):
        blk = self.blocks[-1]
        self.blocks[-1] = nn.Identity()
        try:
            return real(self, x)
        finally:
            self.blocks[-1] = blk
    return faults._patch(m.DINOv2, "forward", skipped)


FAULTS = {"half_batch_depth": half_batch_depth, "depth_map_altered": depth_map_altered,
          "block_skipped": block_skipped}
faults.FAULTS.update(FAULTS)
