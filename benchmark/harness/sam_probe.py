"""A probe the SAM runner puts around K2 during a traced window only.

The port's SAM image encoder calls `flash_attention` by the name it
imported into weakcube_tpu_torch/data/pseudo_gt/sam.py, so the probe
replaces that name, as harness/k2_probe.py does in the depth module: it
records each call's (B, H, N, d), its key grid (kh, kw) and element size,
gives the call CUDA events, and calls the kernel's own function, whose
`launches` counter therefore counts on. The name is restored on exit."""
from __future__ import annotations

from typing import Dict, List

import torch

from .k2_relpos_bound import flash_attention_relpos_bound_s


class SamFlashProbe:
    def __init__(self, mod):
        self.mod = mod
        self.calls: List[tuple] = []
        self.events: list = []

    def __enter__(self):
        real = self._orig = self.mod.flash_attention

        def probed(q, k, v, scale, rel_pos=None):
            kh, kw = (rel_pos[0].shape[-1], rel_pos[1].shape[-1]) if rel_pos is not None else (0, 0)
            self.calls.append((*q.shape, kh, kw, q.element_size()))
            if q.is_cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = real(q, k, v, scale, rel_pos=rel_pos)
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
        """The calls recorded, their summed least time
        (harness/k2_relpos_bound.py) and CUDA-event time, in all and by
        shape ("B.H.N"), in plain numbers read after the window."""
        by: Dict[str, dict] = {}
        ev_s = [a.elapsed_time(b) * 1e-3 for a, b in self.events]
        for i, c in enumerate(self.calls):
            B, H, N, d, kh, kw, elt = c
            e = by.setdefault(f"{B}.{H}.{N}", {"calls": 0, "bound_s": 0.0, "event_s": 0.0})
            e["calls"] += 1
            e["bound_s"] += flash_attention_relpos_bound_s(B, H, N, d, kh, kw, elt)
            e["event_s"] += ev_s[i] if i < len(ev_s) else 0.0
        return {"calls": len(self.calls), "bound_s": sum(e["bound_s"] for e in by.values()),
                "event_s": sum(ev_s), "by_shape": by}
