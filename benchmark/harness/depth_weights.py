"""Random weights for a Depth Anything V2 configuration, made on the device
in one draw from the configuration's `weights_seed`, under the released
state dict's names that the port and the reference share. The same seed
gives the same weights in every run, so runs differ in their traffic alone.

Every convolution and linear weight is normal with std `gain`/sqrt(fan_in),
its fan-in the inputs that reach one output: in x kh x kw for a
convolution, in for the 4x4 / stride 4 and 2x2 / stride 2 transposed
convolutions of the DPT head (their kernels do not overlap). Biases are
normal with std `bias_std`. LayerNorms start at weight 1 and bias 0, the
LayerScales at `layer_scale` (DINOv2's init_values, 1.0 in Depth Anything
V2), the position embedding normal with std `pos_embed_std` and the cls
token with std `cls_token_std`. The configuration's file gives these under
`init`.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

DEFAULT_INIT = {"gain": 1.0, "bias_std": 0.0, "layer_scale": 1.0, "pos_embed_std": 0.02,
                "cls_token_std": 1e-6}


def _fan_in(m: nn.Module) -> int:
    w = m.weight
    if isinstance(m, nn.ConvTranspose2d):
        return w.shape[0] * (w.shape[2] // m.stride[0]) * (w.shape[3] // m.stride[1])
    return w[0].numel()


@torch.no_grad()
def make_state_dict(model: nn.Module, seed: int, device, init=None) -> Dict[str, torch.Tensor]:
    """float32 weights for every parameter of `model` (which may live on
    the meta device) on `device`, by state-dict name; `init` overrides
    DEFAULT_INIT's keys."""
    ini = dict(DEFAULT_INIT, **(init or {}))
    std: Dict[str, float] = {}
    fill: Dict[str, float] = {}
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            std[pre + "weight"] = ini["gain"] * _fan_in(m) ** -0.5
            if m.bias is not None:
                std[pre + "bias"] = ini["bias_std"]
        elif isinstance(m, nn.LayerNorm):
            fill[pre + "weight"], fill[pre + "bias"] = 1.0, 0.0
    for name, _ in model.named_parameters():
        if name.endswith(".gamma"):
            fill[name] = ini["layer_scale"]
        elif name.endswith("pos_embed"):
            std[name] = ini["pos_embed_std"]
        elif name.endswith("cls_token"):
            std[name] = ini["cls_token_std"]
    shapes = {n: p.shape for n, p in model.named_parameters()}
    missing = sorted(set(shapes) - set(std) - set(fill))
    if missing:
        raise KeyError(f"no rule draws {missing[:5]}")
    drawn = sorted(std)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    draw = torch.randn(sum(shapes[n].numel() for n in drawn), generator=gen, device=device)
    sd, off = {}, 0
    for n in drawn:
        k = shapes[n].numel()
        sd[n] = draw[off:off + k].view(shapes[n]) * std[n]
        off += k
    for n, v in fill.items():
        sd[n] = torch.full(shapes[n], v, device=device)
    return sd
