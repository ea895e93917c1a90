"""Depth Anything V2 (metric) in PyTorch: DINOv2 ViT encoder + DPT head
(weakcube_tpu/data/pseudo_gt/depth_anything_v2.py).

The architecture of the released model (depth_anything_v2/dpt.py and
dinov2.py): a plain ViT (patch 14, cls token, learned position embedding
with no interpolation, four taps through the final norm) feeding the DPT
decoder (projections, learned resize layers, 4-level refinenet fusion,
sigmoid * max_depth). Module names are the released state dict's, so a
released `.pth` loads with `load_state_dict`; `utils/convert.py::
dav2_flax_to_torch` maps the JAX package's parameter tree onto them.

Public layouts follow the JAX module: images (B, H, W, 3) ImageNet-
normalised, depth (B, H, W). Inside, tensors are NCHW. The encoder's
attention goes through `ops/flash_attention_cuda.py::flash_attention`: the
CUDA kernel on the card, the plain PyTorch version on the CPU. The model
runs in the dtype of its parameters (bfloat16 on the card for pseudo-GT
generation); the metric head's sigmoid runs in float32. The decoder's
align_corners bilinear resizes go through
`ops/bilinear_resize_cuda.py::bilinear_resize`: the CUDA kernel on the card
(channels_last bfloat16 or float32, as `load_model` keeps the model), the
plain F.interpolate on the CPU. The forward marks
the encoder and the decoder with the spans `depth.encoder` and `depth.head`
(utils/trace.py).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...models.rcnn3d import resolve_device
from ...ops.bilinear_resize_cuda import bilinear_resize
from ...ops.flash_attention_cuda import flash_attention
from ...utils.trace import span

VIT_SPECS = {
    # embed_dim, depth, heads, dpt_features, dpt_out_channels
    "vits": (384, 12, 6, 64, (48, 96, 192, 384)),
    "vitb": (768, 12, 12, 128, (96, 192, 384, 768)),
    "vitl": (1024, 24, 16, 256, (256, 512, 1024, 1024)),
}
# intermediate tap layers per variant (reference dpt.py intermediate_layer_idx)
TAP_LAYERS = {"vits": (2, 5, 8, 11), "vitb": (2, 5, 8, 11),
              "vitl": (4, 11, 17, 23)}
PATCH = 14
LN_EPS = 1e-6  # DINOv2's (and flax's default); PyTorch's default is 1e-5
# in a released checkpoint but unused at inference: DINOv2's masked-image-
# modelling token
UNUSED_CHECKPOINT_KEYS = ("pretrained.mask_token",)


class Attention(nn.Module):
    """Fused qkv projection -> (B, H, N, d) q, k, v -> flash attention ->
    output projection. q, k and v are views of the projection's
    (B, N, 3, H, d) output and the kernel's output is a view of (B, N, H, d)
    memory, so no copy is made on either side of the kernel."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        H = self.heads
        d = D // H
        q, k, v = self.qkv(x).reshape(B, N, 3, H, d).permute(2, 0, 3, 1, 4).unbind(0)
        out = flash_attention(q, k, v, d ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(B, N, D))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        # exact (erf) GELU, as the released model's nn.GELU
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, PATCH)


class DINOv2(nn.Module):
    """Plain ViT encoder returning the 4 tapped patch-token maps, each
    (B, dim, gh, gw), through the encoder's final LayerNorm."""

    def __init__(self, variant: str = "vitl", grid: int = 37):
        super().__init__()
        dim, depth, heads, _, _ = VIT_SPECS[variant]
        self.taps = TAP_LAYERS[variant]
        self.patch_embed = PatchEmbed(dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, dim))
        self.blocks = nn.ModuleList(Block(dim, heads) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (B, 3, H, W), H and W multiples of 14."""
        t = self.patch_embed.proj(x)
        B, D, gh, gw = t.shape
        t = torch.cat([self.cls_token.expand(B, -1, -1), t.flatten(2).transpose(1, 2)], 1)
        t = t + self.pos_embed
        outs = []
        for i, blk in enumerate(self.blocks):
            t = blk(t)
            if i in self.taps:
                outs.append(self.norm(t)[:, 1:].transpose(1, 2).reshape(B, D, gh, gw))
        return outs


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


def _resize(x: torch.Tensor, hw: Sequence[int]) -> torch.Tensor:
    """align_corners=True bilinear, the decoder's only resize mode: five
    calls a forward, each one kernel launch on the card."""
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return bilinear_resize(x, hw)


class FeatureFusionBlock(nn.Module):
    """path = out_conv(resize(resConfUnit2(path + resConfUnit1(lateral)))).
    The coarsest block (refinenet4) has no lateral: its resConfUnit1 is in
    the released checkpoints but never computed with."""

    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, lateral=None, size: Sequence[int] = ()):
        if lateral is not None:
            x = x + self.resConfUnit1(lateral)
        return self.out_conv(_resize(self.resConfUnit2(x), size))


class _Scratch(nn.Module):
    def __init__(self, out_ch: Sequence[int], features: int):
        super().__init__()
        for i, ch in enumerate(out_ch):
            self.add_module(f"layer{i + 1}_rn", nn.Conv2d(ch, features, 3, padding=1, bias=False))
            self.add_module(f"refinenet{i + 1}", FeatureFusionBlock(features))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(nn.Conv2d(features // 2, 32, 3, padding=1),
                                          nn.ReLU(), nn.Conv2d(32, 1, 1))


class DPTHead(nn.Module):
    """Reassemble + fusion decoder -> metric depth (B, H, W) in float32."""

    def __init__(self, variant: str = "vitl", max_depth: float = 20.0):
        super().__init__()
        dim, _, _, features, out_ch = VIT_SPECS[variant]
        self.max_depth = max_depth
        self.projects = nn.ModuleList(nn.Conv2d(dim, ch, 1) for ch in out_ch)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(out_ch[0], out_ch[0], 4, stride=4),
            nn.ConvTranspose2d(out_ch[1], out_ch[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(out_ch[3], out_ch[3], 3, stride=2, padding=1)])
        self.scratch = _Scratch(out_ch, features)

    def forward(self, taps: Sequence[torch.Tensor], out_hw: Tuple[int, int]) -> torch.Tensor:
        sc = self.scratch
        lv = [getattr(sc, f"layer{i + 1}_rn")(self.resize_layers[i](self.projects[i](t)))
              for i, t in enumerate(taps)]
        path = sc.refinenet4(lv[3], size=lv[2].shape[2:])
        path = sc.refinenet3(path, lv[2], size=lv[1].shape[2:])
        path = sc.refinenet2(path, lv[1], size=lv[0].shape[2:])
        path = sc.refinenet1(path, lv[0], size=(2 * lv[0].shape[2], 2 * lv[0].shape[3]))
        h = sc.output_conv2(_resize(sc.output_conv1(path), out_hw))
        return torch.sigmoid(h.float())[:, 0] * self.max_depth


class DepthAnythingV2(nn.Module):
    """Metric depth model. Input (B, H, W, 3) ImageNet-normalised with
    H = W = input_size (a multiple of 14; the inference canon is 518), which
    fixes the position embedding's length. Output (B, H, W) metres."""

    def __init__(self, variant: str = "vitl", max_depth: float = 20.0,
                 input_size: int = 518):
        super().__init__()
        if input_size % PATCH:
            raise ValueError(f"input_size {input_size} is not a multiple of {PATCH}")
        self.variant = variant
        self.input_size = input_size
        self.pretrained = DINOv2(variant, input_size // PATCH)
        self.depth_head = DPTHead(variant, max_depth)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.pretrained.patch_embed.proj.weight.dtype).permute(0, 3, 1, 2)
        with span("depth.encoder"):
            taps = self.pretrained(x)
        with span("depth.head"):
            return self.depth_head(taps, x.shape[2:])


def init_random_(model: DepthAnythingV2, seed: int = 0) -> DepthAnythingV2:
    """Seeded random weights: PyTorch's default layer init, the position
    embedding N(0, 0.02), cls token zero and layer scales one (the JAX
    module's init for those three)."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            bound = nn.init._calculate_fan_in_and_fan_out(m.weight)[0] ** -0.5
            with torch.no_grad():
                m.weight.uniform_(-bound, bound, generator=g)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=g)
    with torch.no_grad():
        model.pretrained.pos_embed.normal_(0.0, 0.02, generator=g)
        model.pretrained.cls_token.zero_()
    return model


_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def preprocess_images(images: Sequence, input_size: int = 518,
                      device=None) -> torch.Tensor:
    """(H, W, 3) uint8 images -> (B, input_size, input_size, 3) float32
    ImageNet-normalised, on `device` (the card unless the caller asks for
    the CPU; it raises where there is no GPU). The resize is PIL's 8-bit BICUBIC:
    antialiased bicubic, the horizontal pass first, each pass rounded and
    clamped to [0, 255] (the clamp between the passes matters at sharp
    edges, where bicubic overshoots). Then scaled to [0, 1] and normalised."""
    device = resolve_device(device)
    mean = torch.tensor(_MEAN, device=device)
    std = torch.tensor(_STD, device=device)
    out = torch.empty((len(images), input_size, input_size, 3), device=device)
    for i, img in enumerate(images):
        x = torch.as_tensor(img, device=device).permute(2, 0, 1)[None].float()
        for size in ((x.shape[2], input_size), (input_size, input_size)):
            x = F.interpolate(x, size=size, mode="bicubic", align_corners=False,
                              antialias=True).round_().clamp_(0, 255)
        out[i] = (x[0].permute(1, 2, 0) / 255.0 - mean) / std
    return out
