"""A probe the depth runner puts around K2 during a traced window only.

The port's depth model calls `flash_attention` by the name it imported into
weakcube_tpu_torch/data/pseudo_gt/depth_anything_v2.py, so the probe
replaces that name: it records each call's (B, H, N, d) and element size,
gives the call CUDA events (read only where the trace shows no K2 kernel),
and calls the kernel's own function, whose `launches` counter therefore
counts on. The name is restored on exit."""
from __future__ import annotations

from typing import List

import torch

from .k2_bound import flash_attention_bound_s


class FlashProbe:
    def __init__(self, mod):
        self.mod = mod
        self.calls: List[tuple] = []
        self.events: list = []

    def __enter__(self):
        real = self._orig = self.mod.flash_attention

        def probed(q, k, v, scale):
            self.calls.append((*q.shape, q.element_size()))
            if q.is_cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = real(q, k, v, scale)
            if q.is_cuda:
                ev[1].record()
                self.events.append(ev)
            return out
        self.mod.flash_attention = probed
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self._orig
        return False

    def summary(self) -> dict:
        """The calls recorded, their summed least time (harness/k2_bound.py)
        and their summed CUDA-event time; plain numbers, read after the
        window."""
        return {"calls": len(self.calls),
                "bound_s": sum(flash_attention_bound_s(*c) for c in self.calls),
                "event_s": sum(a.elapsed_time(b) for a, b in self.events) * 1e-3}
