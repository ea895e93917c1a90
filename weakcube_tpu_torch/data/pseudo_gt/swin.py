"""Swin Transformer (tiny) in PyTorch: GroundingDINO's vision trunk
(weakcube_tpu/data/pseudo_gt/swin.py).

Patch embed 4x4, window attention (7x7) with a relative position bias,
shifted windows on odd blocks, patch merging between stages; depths
(2, 2, 6, 2), dim 96, heads (3, 6, 12, 24). Returns the stride 8/16/32
stages (GroundingDINO reads the last three), each (B, H, W, C).

Module names are the released checkpoint's (`backbone.0.` in
groundingdino_swint_ogc.pth). The patch merge concatenates the 2 x 2
neighbours in the JAX package's order [h0w0, h0w1, h1w0, h1w1] (the
released model's is [h0w0, h1w0, h0w1, h1w1]); the loader of a released
checkpoint permutes the merge's 4C weights as the JAX converter does
(grounding_dino.py::convert_released_checkpoint). Norms use flax's eps
1e-6. Activations are channels-last throughout; the model computes in the
dtype of its parameters, attention logits and softmax in at least float32.
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-6  # flax's default; PyTorch's is 1e-5


def logits_dtype(dtype: torch.dtype) -> torch.dtype:
    """Attention logits are at least float32 (the JAX package's
    preferred_element_type=float32); float64 stays float64."""
    return torch.promote_types(dtype, torch.float32)


def same_pad_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """flax's padding="SAME" for a strided convolution: the output is
    ceil(in / stride), the padding split low = total // 2."""
    pads = []
    for size, k, s in zip(x.shape[:1:-1], conv.kernel_size[::-1], conv.stride[::-1]):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return conv(F.pad(x, pads) if any(pads) else x)


def init_layers_(model: nn.Module, seed: int) -> torch.Generator:
    """Seeded random weights for every layer: Linear, convolution and
    transposed-convolution weights and biases uniform in +-fan_in^-0.5 (as
    PyTorch's default bound), norms at weight 1 and bias 0, every other
    parameter N(0, 0.02). Returns the generator for a model's own extras."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            own = dict(m.named_parameters(recurse=False))
            if isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
                continue
            for name, p in own.items():
                if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                    w = m.weight
                    fan_in = w.shape[1] * w[0, 0].numel() if w.dim() > 2 else w.shape[1]
                    if isinstance(m, nn.ConvTranspose2d):
                        fan_in = w.shape[0]
                    bound = fan_in ** -0.5
                    p.uniform_(-bound, bound, generator=g)
                elif name.startswith("in_proj"):
                    bound = m.in_proj_weight.shape[1] ** -0.5
                    p.uniform_(-bound, bound, generator=g)
                else:
                    p.normal_(0.0, 0.02, generator=g)
    return g


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, w * w, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, C)


def window_reverse(x: torch.Tensor, w: int, H: int, W: int) -> torch.Tensor:
    B = x.shape[0] // (H // w * W // w)
    x = x.reshape(B, H // w, W // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


def relative_position_index(w: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (w - 1)
    return rel[..., 0] * (2 * w - 1) + rel[..., 1]


@functools.lru_cache(maxsize=32)
def _shift_mask_np(H: int, W: int, w: int, shift: int) -> np.ndarray:
    img = np.zeros((1, H, W, 1))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[:, hs, ws] = cnt
            cnt += 1
    win = img.reshape(1, H // w, w, W // w, w).transpose(0, 1, 3, 2, 4).reshape(-1, w * w)
    diff = win[:, :, None] - win[:, None, :]
    return np.where(diff != 0, -100.0, 0.0)


def _shift_mask(H: int, W: int, w: int, shift: int, dtype, device) -> torch.Tensor:
    """(nW, w*w, w*w): -100 between tokens of different regions of the
    shifted (and padded) map, 0 within one."""
    return torch.as_tensor(_shift_mask_np(H, W, w, shift), dtype=dtype, device=device)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int = 7):
        super().__init__()
        self.heads = heads
        self.window = window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(window)).reshape(-1),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x: (B * nW, w*w, C); mask: (nW, w*w, w*w) or None."""
        Bn, N, C = x.shape
        dh = C // self.heads
        q, k, v = self.qkv(x).reshape(Bn, N, 3, self.heads, dh).permute(2, 0, 3, 1, 4).unbind(0)
        ld = logits_dtype(x.dtype)
        attn = ((q * dh ** -0.5) @ k.transpose(-1, -2)).to(ld)
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(N, N, self.heads).permute(2, 0, 1)[None].to(ld)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(Bn // nW, nW, self.heads, N, N) + mask[None, :, None]
            attn = attn.reshape(Bn, self.heads, N, N)
        out = torch.softmax(attn, -1).to(x.dtype) @ v
        return self.proj(out.transpose(1, 2).reshape(Bn, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))  # exact (erf) GELU, as timm's Swin


class SwinBlock(nn.Module):
    """Pad the map to a multiple of the window FIRST, then cyclic-shift,
    attend, un-shift and crop (the detection Swin's order): the window
    never shrinks, so the bias table's shape does not depend on the input."""

    def __init__(self, dim: int, heads: int, window: int = 7, shift: int = 0):
        super().__init__()
        self.window = window
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        w, shift = self.window, self.shift
        ph, pw = (w - H % w) % w, (w - W % w) % w
        hp = F.pad(self.norm1(x), (0, 0, 0, pw, 0, ph))
        Hp, Wp = H + ph, W + pw
        if shift:
            hp = torch.roll(hp, (-shift, -shift), (1, 2))
        mask = _shift_mask(Hp, Wp, w, shift, logits_dtype(x.dtype), x.device) if shift else None
        h = window_reverse(self.attn(window_partition(hp, w), mask), w, Hp, Wp)
        if shift:
            h = torch.roll(h, (shift, shift), (1, 2))
        x = x + h[:, :H, :W]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2 x 2 neighbours concatenated (odd sizes zero-padded at the end),
    LayerNorm, linear 4C -> 2C."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
        return self.reduction(self.norm(x.reshape(B, H // 2, W // 2, 4 * C)))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(SwinBlock(dim, heads, shift=0 if i % 2 == 0 else 3)
                                    for i in range(depth))
        if downsample:
            self.downsample = PatchMerging(dim)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, 4, 4)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)


class SwinT(nn.Module):
    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 heads: Sequence[int] = (3, 6, 12, 24),
                 out_stages: Tuple[int, ...] = (1, 2, 3)):
        super().__init__()
        self.out_stages = tuple(out_stages)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            BasicLayer(embed_dim * 2 ** i, d, h, i < len(depths) - 1)
            for i, (d, h) in enumerate(zip(depths, heads)))
        for i in self.out_stages:
            self.add_module(f"norm{i}", nn.LayerNorm(embed_dim * 2 ** i, eps=LN_EPS))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (B, H, W, 3) -> the out stages' maps, each (B, h, w, C)."""
        pe = self.patch_embed
        x = x.to(pe.proj.weight.dtype).permute(0, 3, 1, 2)
        y = pe.norm(same_pad_conv(pe.proj, x).permute(0, 2, 3, 1))
        outs = []
        for i, layer in enumerate(self.layers):
            for blk in layer.blocks:
                y = blk(y)
            if i in self.out_stages:
                outs.append(getattr(self, f"norm{i}")(y))
            if hasattr(layer, "downsample"):
                y = layer.downsample(y)
        return outs
