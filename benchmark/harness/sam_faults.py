"""Faults planted under the SAM cell's timed path, for the checks that
`correct` comes out false there: each patches the port's SAM-HQ where the
fault would be produced and returns a function that undoes it.

Importing this module adds them to harness/faults.py's FAULTS, under the
names below, so that calibrate.py's --fault finds them once it has loaded
the SAM runner (which imports this module)."""
from __future__ import annotations

import torch
import torch.nn as nn

from . import faults


def _model():
    from weakcube_tpu_torch.data.pseudo_gt import sam
    return sam


def half_batch_sam():
    """The forward computes the first half of the batch and hands its masks
    to the second half too."""
    m = _model()
    real = m.Sam.forward

    def half(self, images, boxes):
        B = images.shape[0]
        n = max(B // 2, 1)
        out = real(self, images[:n], boxes[:n])
        return torch.cat([out, out])[:B]
    return faults._patch(m.Sam, "forward", half)


def rel_pos_left_out():
    """Every attention of the image encoder runs without its decomposed
    relative-position bias."""
    m = _model()
    real = m.flash_attention

    def unbiased(q, k, v, scale, rel_pos=None):
        return real(q, k, v, scale)
    return faults._patch(m, "flash_attention", unbiased)


def global_block_windowed():
    """The encoder's first global block (the one the HQ fusion reads) runs
    windowed attention over 14 x 14 windows, its relative-position tables
    read for the window's offsets."""
    m = _model()
    real = m.SamImageEncoder.forward

    def windowed(self, x):
        blk = self.blocks[self.global_idx[0]]
        blk.window = m.WINDOW
        try:
            return real(self, x)
        finally:
            blk.window = 0
    return faults._patch(m.SamImageEncoder, "forward", windowed)


def last_block_skipped():
    """The encoder leaves out its last block (a global one): the neck reads
    the output of the block before it."""
    m = _model()
    real = m.SamImageEncoder.forward

    def skipped(self, x):
        blk = self.blocks[-1]
        self.blocks[-1] = nn.Identity()
        try:
            return real(self, x)
        finally:
            self.blocks[-1] = blk
    return faults._patch(m.SamImageEncoder, "forward", skipped)


FAULTS = {"half_batch_sam": half_batch_sam, "rel_pos_left_out": rel_pos_left_out,
          "global_block_windowed": global_block_windowed,
          "last_block_skipped": last_block_skipped}
faults.FAULTS.update(FAULTS)
