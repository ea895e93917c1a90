"""Random weights for a SAM-HQ configuration, made on the device in one
draw from the configuration's `weights_seed`, under the names that the
port (weakcube_tpu_torch/data/pseudo_gt/sam.py) and the reference
(benchmark/reference/sam_hq.py) share. The same seed gives the same
weights in every run, so runs differ in their traffic alone.

Every convolution, transposed convolution and linear weight is normal with
std `gain`/sqrt(fan_in), its fan-in the inputs that reach one output: in x
kh x kw for a convolution, in alone for the 2x2 / stride 2 and 4x4 /
stride 4 transposed convolutions (their kernels do not overlap). Biases
are normal with std `bias_std`. LayerNorms start at weight 1 and bias 0.
The relative-position tables are normal with std `rel_pos_std`, the
position embedding with std `pos_embed_std`, the token and corner
embeddings with std `embed_std` (nn.Embedding's N(0, 1)) and the prompt
encoder's Gaussian matrix with std `gaussian_std` (the released
PositionEmbeddingRandom's scale 1). The configuration's file gives these
under `init`.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

DEFAULT_INIT = {"gain": 1.0, "bias_std": 0.0, "rel_pos_std": 0.02, "pos_embed_std": 0.02,
                "embed_std": 1.0, "gaussian_std": 1.0}


def _fan_in(m: nn.Module) -> int:
    w = m.weight
    if isinstance(m, nn.ConvTranspose2d):
        return w.shape[0] * (w.shape[2] // m.stride[0]) * (w.shape[3] // m.stride[1])
    return w[0].numel()


@torch.no_grad()
def make_state_dict(model: nn.Module, seed: int, device, init=None) -> Dict[str, torch.Tensor]:
    """float32 weights for every entry of `model`'s state dict (the model
    may live on the meta device) on `device`; `init` overrides
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
        elif isinstance(m, nn.Embedding):
            std[pre + "weight"] = ini["embed_std"]
    shapes = {n: t.shape for n, t in model.state_dict().items()}
    for name in shapes:
        if name.endswith(("rel_pos_h", "rel_pos_w")):
            std[name] = ini["rel_pos_std"]
        elif name.endswith("pos_embed"):
            std[name] = ini["pos_embed_std"]
        elif name.endswith("positional_encoding_gaussian_matrix"):
            std[name] = ini["gaussian_std"]
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
