"""Depth Anything V2, metric depth, in plain float32 PyTorch: the reference
the benchmark holds the port's depth pseudo-GT path to.

It follows the released code, github.com/DepthAnything/Depth-Anything-V2,
`metric_depth/depth_anything_v2/`: `dinov2.py` with `dinov2_layers/` (the
DINOv2 ViT: patch 14, a cls token, a learned position embedding, pre-norm
blocks with LayerScale, exact GELU, LayerNorm eps 1e-6, the taps of
`get_intermediate_layers` through the final norm, cls token dropped) and
`dpt.py` with `util/blocks.py` (the DPT head: 1x1 projections, the resize
layers, 3x3 `layer*_rn` convolutions without bias, RefineNet fusion blocks
with pre-activation residual units and align-corners bilinear resizes, the
output convolutions, sigmoid x max_depth). Every parameter has the
released state dict's name, so the released checkpoints and the port's
weights load into it. The modules only hold the parameters; the
arithmetic is written out in DepthAnythingV2's methods, in float32, with
TF32 off while it runs (`strict_float32`).

Departures from the released code, each the port's convention (taken from
the JAX package), which the comparison has to share:
  - input: each image is resized to a 518 x 518 square (PIL's 8-bit
    BICUBIC: antialiased bicubic, the horizontal pass first, each pass
    rounded and clamped to [0, 255]), scaled to [0, 1] and normalised with
    ImageNet's statistics. The released `infer_image` keeps the aspect
    ratio instead (the shorter side 518, both a multiple of 14: 518 x 686 for
    a 640 x 480 image, by cv2's INTER_CUBIC on [0, 1] floats) and
    interpolates the position embedding to that grid. At the square 518
    the grid is the released embedding's own 37 x 37, which is used as it
    is, as the released code does for that grid;
  - output: each map goes back to its image's size by antialiased bilinear
    (align_corners False, PIL's "F"-mode BILINEAR), then to float16 as the
    port stores it; the released code resizes by bilinear with
    align_corners True and no antialias;
  - attention is softmax(q k^T d^-0.5) v by two matrix products (the
    released code takes xformers' memory-efficient kernel where it is
    installed, else the same products with q scaled first);
  - `pretrained.mask_token` (masked image modelling, unused at inference)
    is not held: a released checkpoint loads with that key left out.

`operand_precision="fp8"` makes it the benchmark's control: the operands
of every convolution, transposed convolution and linear layer and of the
attention's two products are rounded to float8 e4m3 (each tensor scaled by
its largest magnitude onto the format's 448), the precision below the
configuration's bf16; the arithmetic stays float32.

It imports no kernel of the port, nothing of the port's depth module and
nothing of JAX.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# the released run.py's model_configs and dpt.py's intermediate_layer_idx:
# embed_dim, depth, heads, features, out_channels, taps
VARIANTS = {
    "vits": (384, 12, 6, 64, (48, 96, 192, 384), (2, 5, 8, 11)),
    "vitb": (768, 12, 12, 128, (96, 192, 384, 768), (2, 5, 8, 11)),
    "vitl": (1024, 24, 16, 256, (256, 512, 1024, 1024), (4, 11, 17, 23)),
}
PATCH = 14
LN_EPS = 1e-6
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def strict_float32():
    """float32 products in float32: TF32 off for matmuls and cuDNN while the
    body runs, the previous settings restored after it."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().float().clamp(min=1e-30) / 448.0
    return (t.float() / scale).to(torch.float8_e4m3fn).float() * scale


# ---------------------------------------------------------------- parameters
# Modules that only hold parameters under the released names; the
# arithmetic is DepthAnythingV2's.

class _Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class _Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)


class _LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class _Block(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = _Attention(dim)
        self.ls1 = _LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _Mlp(dim)
        self.ls2 = _LayerScale(dim)


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, PATCH)


class _DINOv2(nn.Module):
    def __init__(self, dim: int, depth: int, grid: int):
        super().__init__()
        self.patch_embed = _PatchEmbed(dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, dim))
        self.blocks = nn.ModuleList(_Block(dim) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)


class _ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)


class _FusionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = _ResidualConvUnit(features)
        self.resConfUnit2 = _ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)


class _Scratch(nn.Module):
    def __init__(self, out_channels: Sequence[int], features: int):
        super().__init__()
        for i, ch in enumerate(out_channels):
            self.add_module(f"layer{i + 1}_rn", nn.Conv2d(ch, features, 3, padding=1, bias=False))
        for i in range(len(out_channels)):
            self.add_module(f"refinenet{i + 1}", _FusionBlock(features))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
                                          nn.Conv2d(32, 1, 1), nn.Sigmoid())


class _DPTHead(nn.Module):
    def __init__(self, dim: int, features: int, out_channels: Sequence[int]):
        super().__init__()
        self.projects = nn.ModuleList(nn.Conv2d(dim, ch, 1) for ch in out_channels)
        c = out_channels
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(c[0], c[0], 4, stride=4),
            nn.ConvTranspose2d(c[1], c[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(c[3], c[3], 3, stride=2, padding=1)])
        self.scratch = _Scratch(out_channels, features)


# ---------------------------------------------------------------- the model

class DepthAnythingV2(nn.Module):
    """The metric model at `variant`'s widths for a square input of
    `grid` x 14 pixels. forward: (B, 3, H, W) normalised float32 -> (B, H, W)
    metres."""

    def __init__(self, variant: str = "vitl", max_depth: float = 20.0, grid: int = 37,
                 operand_precision: Optional[str] = None):
        super().__init__()
        dim, depth, self.heads, features, out_channels, self.taps = VARIANTS[variant]
        self.max_depth = max_depth
        self.input_size = grid * PATCH
        self.operand_precision = operand_precision
        self.pretrained = _DINOv2(dim, depth, grid)
        self.depth_head = _DPTHead(dim, features, out_channels)

    # -- operations whose operands the control rounds

    def _op(self, t: torch.Tensor) -> torch.Tensor:
        return _fp8(t) if self.operand_precision == "fp8" else t

    def _linear(self, x, m: nn.Linear):
        return F.linear(self._op(x), self._op(m.weight), m.bias)

    def _conv(self, x, m: nn.Conv2d):
        return F.conv2d(self._op(x), self._op(m.weight), m.bias, m.stride, m.padding)

    def _conv_t(self, x, m: nn.ConvTranspose2d):
        return F.conv_transpose2d(self._op(x), self._op(m.weight), m.bias, m.stride)

    # -- the encoder

    def _attention(self, x, m: _Attention):
        B, N, D = x.shape
        H = self.heads
        d = D // H
        q, k, v = self._linear(x, m.qkv).reshape(B, N, 3, H, d).permute(2, 0, 3, 1, 4)
        a = torch.softmax(self._op(q) @ self._op(k).transpose(-2, -1) * d ** -0.5, dim=-1)
        out = self._op(a) @ self._op(v)
        return self._linear(out.transpose(1, 2).reshape(B, N, D), m.proj)

    def _block(self, x, b: _Block):
        x = x + self._attention(F.layer_norm(x, x.shape[-1:], b.norm1.weight, b.norm1.bias,
                                             LN_EPS), b.attn) * b.ls1.gamma
        h = F.layer_norm(x, x.shape[-1:], b.norm2.weight, b.norm2.bias, LN_EPS)
        h = self._linear(F.gelu(self._linear(h, b.mlp.fc1)), b.mlp.fc2)
        return x + h * b.ls2.gamma

    def encoder(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The four taps, each (B, dim, gh, gw): the patch tokens after the
        tapped blocks, through the final norm."""
        p = self.pretrained
        t = self._conv(x, p.patch_embed.proj)
        B, D, gh, gw = t.shape
        t = torch.cat([p.cls_token.expand(B, -1, -1), t.flatten(2).transpose(1, 2)], 1)
        t = t + p.pos_embed
        taps = []
        for i, b in enumerate(p.blocks):
            t = self._block(t, b)
            if i in self.taps:
                n = F.layer_norm(t, (D,), p.norm.weight, p.norm.bias, LN_EPS)
                taps.append(n[:, 1:].transpose(1, 2).reshape(B, D, gh, gw))
        return taps

    # -- the decoder

    def _rcu(self, x, u: _ResidualConvUnit):
        return x + self._conv(F.relu(self._conv(F.relu(x), u.conv1)), u.conv2)

    def _fusion(self, m: _FusionBlock, x, lateral=None, size=None):
        if lateral is not None:
            x = x + self._rcu(lateral, m.resConfUnit1)
        x = self._rcu(x, m.resConfUnit2)
        x = F.interpolate(x, size=size, scale_factor=None if size else 2, mode="bilinear",
                          align_corners=True)
        return self._conv(x, m.out_conv)

    def head(self, taps: Sequence[torch.Tensor], hw: Tuple[int, int]) -> torch.Tensor:
        h = self.depth_head
        sc = h.scratch
        rs = h.resize_layers
        lv = [self._conv(t, h.projects[i]) for i, t in enumerate(taps)]
        lv = [self._conv_t(lv[0], rs[0]), self._conv_t(lv[1], rs[1]), lv[2],
              self._conv(lv[3], rs[3])]
        lv = [self._conv(x, getattr(sc, f"layer{i + 1}_rn")) for i, x in enumerate(lv)]
        path = self._fusion(sc.refinenet4, lv[3], size=lv[2].shape[2:])
        path = self._fusion(sc.refinenet3, path, lv[2], size=lv[1].shape[2:])
        path = self._fusion(sc.refinenet2, path, lv[1], size=lv[0].shape[2:])
        path = self._fusion(sc.refinenet1, path, lv[0])
        out = F.interpolate(self._conv(path, sc.output_conv1), size=tuple(hw), mode="bilinear",
                            align_corners=True)
        c = sc.output_conv2
        out = self._conv(F.relu(self._conv(out, c[0])), c[2])
        return torch.sigmoid(out)[:, 0] * self.max_depth

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.encoder(x), x.shape[2:])


# ---------------------------------------------------------------- the path

def preprocess(image: torch.Tensor, size: int) -> torch.Tensor:
    """(H, W, 3) uint8 RGB on the host or a device -> (1, 3, size, size)
    normalised float32 on its device (module docstring, input)."""
    x = image.permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=(x.shape[2], size), mode="bicubic", align_corners=False,
                      antialias=True).round().clamp(0, 255)
    x = F.interpolate(x, size=(size, size), mode="bicubic", align_corners=False,
                      antialias=True).round().clamp(0, 255)
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    return (x / 255.0 - mean) / std


def resize_out(depth: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(H, W) map -> (h, w) float16 (module docstring, output)."""
    return F.interpolate(depth[None, None], size=tuple(hw), mode="bilinear", align_corners=False,
                         antialias=True)[0, 0].to(torch.float16)


@torch.no_grad()
def depth_maps(model: DepthAnythingV2, images: Sequence[torch.Tensor],
               sizes: Sequence[Tuple[int, int]], device) -> List[torch.Tensor]:
    """Each (H, W, 3) uint8 image, one at a time, through preprocess, the
    model and resize_out on `device`, in float32 with TF32 off -> float16
    host maps of the given (height, width)."""
    out = []
    with strict_float32():
        for img, hw in zip(images, sizes):
            x = preprocess(torch.as_tensor(img).to(device), model.input_size)
            out.append(resize_out(model(x)[0], hw).cpu())
    return out
