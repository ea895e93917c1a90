"""Segment Anything with the HQ token (SAM-HQ) in PyTorch: box-prompted
masks for the ground-segmentation pseudo-GT pass
(weakcube_tpu/data/pseudo_gt/sam.py).

  * image encoder: ViT-det (patch 16, windowed attention with global
    blocks, decomposed relative-position bias) -> a (64, 64, 256)
    embedding at 1024 px, and the outputs of the global blocks;
  * prompt encoder: box corners -> 2 tokens (random Fourier features +
    corner-type embeddings);
  * mask decoder: two-way transformer, 4x upscaling, the HQ output token
    and its feature fusion; the returned mask is the HQ token's.

It computes what the JAX module computes, which differs from the released
SAM-HQ in three places that this port keeps for parity (ROADMAP.md, Queue
C): the MLPs' and the upscaling's GELU is the tanh approximation; the HQ
fusion is one 4x4, stride-4 transposed convolution per branch (the
released decoder has two 2x2 stages with a LayerNorm2d and a GELU between
them, and an embedding_maskfeature branch); the first two-way block's self-
attention keeps its residual.

Module names are the released sam_hq_vit_*.pth's; the keys of such a file
that the JAX converter ignores are listed in UNUSED_CHECKPOINT_KEYS.
Transposed convolutions keep torch's own (in, out, kh, kw) layout.
`utils/convert.py::sam_flax_to_torch` maps the JAX package's parameter tree
onto these names.

Layouts follow the JAX module: images (B, S, S, 3) normalised (S = the
model's img_size), boxes (B, N, 4) XYXY in IMG_SIZE space, masks (B, N,
S/4, S/4) float32 logits. The model computes in the dtype of its
parameters; attention logits, the relative-position bias and the softmax
in at least float32.

The image encoder's attention, windowed and global, goes through
`ops/flash_attention_cuda.py::flash_attention` with the relative-position
bias as its two factors (bias_h, bias_w): on the card the kernel K2
(csrc/flash_attention.cu), which adds them to its float32 scores and never
forms the (N, N) logits or bias; on the CPU the plain version
(ops/attention.py), which computes what the JAX module computes. The
forward's spans (utils/trace.py) are `sam.encoder` and `sam.decoder` (the
prompt encoder and the mask decoder).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.flash_attention_cuda import flash_attention
from ...utils.trace import span
from .swin import LN_EPS, init_layers_, logits_dtype, same_pad_conv

SAM_SPECS = {
    # embed_dim, depth, heads, global_attn_indexes
    "vit_b": (768, 12, 12, (2, 5, 8, 11)),
    "vit_l": (1024, 24, 16, (5, 11, 17, 23)),
    "vit_tiny": (192, 12, 3, (2, 5, 8, 11)),
}
IMG_SIZE = 1024  # the prompt's coordinate space; read at call time
PATCH = 16
EMBED = 256      # prompt / mask transformer width
WINDOW = 14


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu default


def _rel_pos_bias(q_hw, k_hw, rel_h, rel_w, q, dim_head):
    """Decomposed relative-position bias (ViT-det): q (B*, qh*qw, dh) ->
    its two factors (bias_h (B*, qh, qw, kh), bias_w (B*, qh, qw, kw)), in at
    least float32; key (i, j) of the kh x kw grid takes bias_h[..., i] +
    bias_w[..., j]. The tables are sized from the block's input (2 * size -
    1 rows), with no interpolation."""
    qh, qw = q_hw
    kh, kw = k_hw
    ld = logits_dtype(q.dtype)

    def get(rel, q_size, k_size):
        idx = (torch.arange(q_size, device=q.device)[:, None]
               - torch.arange(k_size, device=q.device)[None, :] + (k_size - 1))
        return rel[idx].to(ld)                                   # (q, k, dh)
    q_r = q.reshape(-1, qh, qw, dim_head).to(ld)
    bias_h = torch.einsum("bhwc,hkc->bhwk", q_r, get(rel_h, qh, kh))
    bias_w = torch.einsum("bhwc,wkc->bhwk", q_r, get(rel_w, qw, kw))
    return bias_h, bias_w


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, input_hw: Tuple[int, int]):
        super().__init__()
        self.heads = heads
        dh = dim // heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_hw[0] - 1, dh))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_hw[1] - 1, dh))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, D) -> (B, H, W, D)."""
        B, H, W, D = x.shape
        dh = D // self.heads
        # q, k, v: (B, heads, H*W, dh) views of the projection, no copies
        q, k, v = self.qkv(x).reshape(B, H * W, 3, self.heads, dh).permute(2, 0, 3, 1, 4).unbind(0)
        bias_h, bias_w = _rel_pos_bias((H, W), (H, W), self.rel_pos_h, self.rel_pos_w,
                                       q.reshape(B * self.heads, H * W, dh), dh)
        rel_pos = (bias_h.reshape(B, self.heads, H * W, H),
                   bias_w.reshape(B, self.heads, H * W, W))
        out = flash_attention(q, k, v, dh ** -0.5, rel_pos=rel_pos)
        return self.proj(out.transpose(1, 2).reshape(B, H, W, D))


def _window_partition(x: torch.Tensor, w: int):
    B, H, W, C = x.shape
    ph, pw = (w - H % w) % w, (w - W % w) % w
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // w, w, Wp // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w, w, C), (Hp, Wp)


def _window_unpartition(x: torch.Tensor, w: int, hw_pad, hw):
    Hp, Wp = hw_pad
    H, W = hw
    B = x.shape[0] // (Hp // w * Wp // w)
    x = x.reshape(B, Hp // w, Wp // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


class _MlpLin(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)


class ViTDetBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, grid: int):
        """window 0: global attention over the grid x grid map."""
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        size = window if window > 0 else grid
        self.attn = WindowAttention(dim, heads, (size, size))
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _MlpLin(dim, 4 * dim)

    def forward(self, x):
        h = self.norm1(x)
        if self.window > 0:
            win, hw_pad = _window_partition(h, self.window)
            h = _window_unpartition(self.attn(win), self.window, hw_pad, x.shape[1:3])
        else:
            h = self.attn(h)
        x = x + h
        return x + self.mlp.lin2(_gelu(self.mlp.lin1(self.norm2(x))))


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, PATCH)


class SamImageEncoder(nn.Module):
    def __init__(self, variant: str = "vit_b", img_size: int = None):
        super().__init__()
        dim, depth, heads, global_idx = SAM_SPECS[variant]
        grid = (img_size or IMG_SIZE) // PATCH
        self.global_idx = tuple(global_idx)
        self.patch_embed = _PatchEmbed(dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, dim))
        self.blocks = nn.ModuleList(
            ViTDetBlock(dim, heads, 0 if i in global_idx else WINDOW, grid) for i in range(depth))
        self.neck = nn.Sequential(nn.Conv2d(dim, EMBED, 1, bias=False),
                                  nn.LayerNorm(EMBED, eps=LN_EPS),
                                  nn.Conv2d(EMBED, EMBED, 3, padding=1, bias=False),
                                  nn.LayerNorm(EMBED, eps=LN_EPS))

    def forward(self, x: torch.Tensor):
        """x: (B, S, S, 3) normalised -> (neck embedding (B, S/16, S/16, 256),
        [each global block's output (B, S/16, S/16, dim)])."""
        x = x.to(self.pos_embed.dtype).permute(0, 3, 1, 2)
        h = same_pad_conv(self.patch_embed.proj, x).permute(0, 2, 3, 1) + self.pos_embed
        interm = []
        for i, blk in enumerate(self.blocks):
            h = blk(h)
            if i in self.global_idx:
                interm.append(h)
        c1, ln1, c2, ln2 = self.neck
        n = ln1(c1(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        n = ln2(c2(n.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        return n, interm


class _PositionEmbeddingRandom(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, EMBED // 2))

    def encode(self, pts: torch.Tensor) -> torch.Tensor:
        """(..., 2) in [0, 1] -> (..., 256) random Fourier features."""
        proj = (2.0 * pts - 1.0) @ self.positional_encoding_gaussian_matrix.to(pts.dtype) * (2 * np.pi)
        return torch.cat([torch.sin(proj), torch.cos(proj)], -1)


class PromptEncoder(nn.Module):
    """Box prompts only (the pipeline prompts SAM with one box)."""

    def __init__(self):
        super().__init__()
        self.pe_layer = _PositionEmbeddingRandom()
        # the released corner-type embeddings of a box's top-left and
        # bottom-right (0 and 1 are the point labels, unused by boxes)
        self.point_embeddings = nn.ModuleDict({"2": nn.Embedding(1, EMBED),
                                               "3": nn.Embedding(1, EMBED)})

    def forward(self, boxes: torch.Tensor) -> torch.Tensor:
        """(B, N, 4) XYXY in IMG_SIZE space -> (B, N, 2, 256)."""
        corner = torch.cat([self.point_embeddings["2"].weight, self.point_embeddings["3"].weight])
        corners = boxes.reshape(*boxes.shape[:-1], 2, 2) / IMG_SIZE
        return self.pe_layer.encode(corners) + corner


class TwoWayAttention(nn.Module):
    def __init__(self, down: int = 2, heads: int = 8):
        super().__init__()
        self.heads = heads
        d = EMBED // down
        self.q_proj = nn.Linear(EMBED, d)
        self.k_proj = nn.Linear(EMBED, d)
        self.v_proj = nn.Linear(EMBED, d)
        self.out_proj = nn.Linear(d, EMBED)

    def forward(self, q, k, v):
        qp, kp, vp = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        dh = qp.shape[-1] // self.heads

        def split(t):
            return t.reshape(*t.shape[:-1], self.heads, dh).transpose(-3, -2)
        a = ((split(qp) * dh ** -0.5) @ split(kp).transpose(-1, -2)).to(logits_dtype(q.dtype))
        o = (torch.softmax(a, -1).to(q.dtype) @ split(vp)).transpose(-3, -2)
        return self.out_proj(o.reshape(*q.shape[:-1], -1))


class TwoWayBlock(nn.Module):
    def __init__(self, skip_first_pe: bool = False):
        super().__init__()
        self.skip_first_pe = skip_first_pe
        self.self_attn = TwoWayAttention(down=1)
        self.norm1 = nn.LayerNorm(EMBED, eps=LN_EPS)
        self.cross_attn_token_to_image = TwoWayAttention()
        self.norm2 = nn.LayerNorm(EMBED, eps=LN_EPS)
        self.mlp = _MlpLin(EMBED, 2048)
        self.norm3 = nn.LayerNorm(EMBED, eps=LN_EPS)
        self.norm4 = nn.LayerNorm(EMBED, eps=LN_EPS)
        self.cross_attn_image_to_token = TwoWayAttention()

    def forward(self, tokens, image, token_pe, image_pe):
        q = tokens if self.skip_first_pe else tokens + token_pe
        tokens = self.norm1(tokens + self.self_attn(q, q, tokens))
        q, k = tokens + token_pe, image + image_pe
        tokens = self.norm2(tokens + self.cross_attn_token_to_image(q, k, image))
        tokens = self.norm3(tokens + self.mlp.lin2(F.relu(self.mlp.lin1(tokens))))
        q, k = image + image_pe, tokens + token_pe
        image = self.norm4(image + self.cross_attn_image_to_token(q, k, tokens))
        return tokens, image


class _TwoWayTransformer(nn.Module):
    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList([TwoWayBlock(skip_first_pe=True), TwoWayBlock()])
        self.final_attn_token_to_image = TwoWayAttention()
        self.norm_final_attn = nn.LayerNorm(EMBED, eps=LN_EPS)


class _HyperMLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(EMBED, EMBED), nn.Linear(EMBED, EMBED),
                                     nn.Linear(EMBED, EMBED // 8)])

    def forward(self, x):
        return self.layers[2](F.relu(self.layers[1](F.relu(self.layers[0](x)))))


class MaskDecoder(nn.Module):
    """Two-way transformer + hypernetwork over the 4x-upscaled embedding,
    with the SAM-HQ output token: its mask reads the upscaled embedding plus
    the fusion of the encoder's first global block and the neck embedding."""

    num_multimask = 3

    def __init__(self, vit_dim: int):
        super().__init__()
        self.iou_token = nn.Embedding(1, EMBED)
        self.mask_tokens = nn.Embedding(self.num_multimask + 1, EMBED)
        self.hf_token = nn.Embedding(1, EMBED)
        self.transformer = _TwoWayTransformer()
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(EMBED, EMBED // 4, 2, 2), nn.LayerNorm(EMBED // 4, eps=LN_EPS),
            nn.Identity(), nn.ConvTranspose2d(EMBED // 4, EMBED // 8, 2, 2))
        self.hf_mlp = _HyperMLP()
        self.compress_vit_feat = nn.Sequential(nn.ConvTranspose2d(vit_dim, EMBED // 8, 4, 4))
        self.embedding_encoder = nn.Sequential(nn.ConvTranspose2d(EMBED, EMBED // 8, 4, 4))

    def forward(self, image_embed, image_pe, prompt_tokens, early_feat, final_feat):
        """image_embed (B, H, W, 256), image_pe (H, W, 256), prompt_tokens
        (B, N, 2, 256), early_feat (B, H, W, vit_dim), final_feat (B, H, W,
        256) -> (B, N, 4H, 4W) float32 logits of the HQ token's mask."""
        B, H, W, D = image_embed.shape
        N = prompt_tokens.shape[1]
        M = self.num_multimask + 2
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight,
                                self.hf_token.weight])                     # (1 + M, D)
        tokens = torch.cat([out_tokens[None, None].expand(B, N, -1, -1),
                            prompt_tokens.to(out_tokens.dtype)], 2)
        img = image_embed.reshape(B, 1, H * W, D).expand(B, N, H * W, D)
        pe = image_pe.reshape(1, 1, H * W, D).expand(B, N, H * W, D)
        token_pe = tokens  # SAM uses the prompt tokens themselves as their pe

        tr = self.transformer
        t, im = tokens, img
        for blk in tr.layers:
            t, im = blk(t, im, token_pe, pe)
        t = tr.norm_final_attn(t + tr.final_attn_token_to_image(t + token_pe, im + pe, im))
        mask_out = t[:, :, 1:1 + M]                                        # (B, N, M, D)

        up1, ln, _, up2 = self.output_upscaling
        up = up1(im.reshape(B * N, H, W, D).permute(0, 3, 1, 2))
        up = _gelu(ln(up.permute(0, 2, 3, 1))).permute(0, 3, 1, 2)
        up = _gelu(up2(up))                                                # (B*N, D/8, 4H, 4W)
        hq = (self.compress_vit_feat(early_feat.permute(0, 3, 1, 2))
              + self.embedding_encoder(final_feat.permute(0, 3, 1, 2)))    # (B, D/8, 4H, 4W)
        up = up.reshape(B, N, D // 8, 4 * H, 4 * W) + hq[:, None]
        hyper = self.hf_mlp(mask_out[:, :, -1])                           # the HQ token
        return torch.einsum("bnchw,bnc->bnhw", up, hyper).float()


class Sam(nn.Module):
    """Box-prompted SAM-HQ: images (B, S, S, 3) + boxes (B, N, 4) -> mask
    logits (B, N, S/4, S/4); upsampling and cropping to the frame are the
    caller's. img_size S (default IMG_SIZE, 1024 for the released models)
    sizes the position embedding and the global blocks' relative-position
    tables."""

    def __init__(self, variant: str = "vit_l", img_size: int = None):
        super().__init__()
        img_size = img_size or IMG_SIZE
        self.variant = variant
        self.img_size = img_size
        self.image_encoder = SamImageEncoder(variant, img_size)
        self.prompt_encoder = PromptEncoder()
        self.mask_decoder = MaskDecoder(SAM_SPECS[variant][0])

    def dense_pe(self, grid: int, dtype, device) -> torch.Tensor:
        """(grid, grid, 256) positional encoding of the embedding's cells."""
        c = (torch.arange(grid, dtype=torch.float32, device=device) + 0.5) / grid
        gy, gx = torch.meshgrid(c, c, indexing="ij")
        return self.prompt_encoder.pe_layer.encode(torch.stack([gx, gy], -1).to(dtype))

    def forward(self, images, boxes):
        with span("sam.encoder"):
            enc, interm = self.image_encoder(images)
        with span("sam.decoder"):
            dt = enc.dtype
            image_pe = self.dense_pe(enc.shape[1], logits_dtype(dt), enc.device)
            prompts = self.prompt_encoder(boxes.to(logits_dtype(dt)))
            return self.mask_decoder(enc, image_pe.to(dt), prompts.to(dt), interm[0], enc)


def preprocess_sam(images: Sequence[np.ndarray], size: int = None) -> np.ndarray:
    """Resize the longest side to IMG_SIZE (PIL's 8-bit BILINEAR, on the
    host, as the JAX package), pad to a square, SAM's pixel statistics:
    (B, S, S, 3) float32."""
    from PIL import Image
    size = size or IMG_SIZE
    mean = np.array([123.675, 116.28, 103.53], np.float32)
    std = np.array([58.395, 57.12, 57.375], np.float32)
    out = np.zeros((len(images), size, size, 3), np.float32)
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        s = size / max(h, w)
        nh, nw = int(round(h * s)), int(round(w * s))
        r = np.asarray(Image.fromarray(img.astype(np.uint8)).resize((nw, nh), Image.BILINEAR))
        out[i, :nh, :nw] = (r - mean) / std
    return out


def _released_unused_keys() -> Tuple[str, ...]:
    md, pe = "mask_decoder.", "prompt_encoder."
    keys = [pe + "point_embeddings.0.weight", pe + "point_embeddings.1.weight",
            pe + "not_a_point_embed.weight", pe + "no_mask_embed.weight"]
    keys += [f"{pe}mask_downscaling.{i}.{p}" for i in (0, 1, 3, 4, 6) for p in ("weight", "bias")]
    keys += [f"{md}iou_prediction_head.layers.{i}.{p}" for i in range(3)
             for p in ("weight", "bias")]
    keys += [f"{md}output_hypernetworks_mlps.{m}.layers.{i}.{p}" for m in range(4)
             for i in range(3) for p in ("weight", "bias")]
    # the released HQ fusion's second stages, which the JAX fusion lacks
    keys += [f"{md}{branch}.{i}.{p}" for branch in ("compress_vit_feat", "embedding_encoder")
             for i in (1, 3) for p in ("weight", "bias")]
    keys += [f"{md}embedding_maskfeature.{i}.{p}" for i in (0, 1, 3) for p in ("weight", "bias")]
    return tuple(keys)


# in a released sam_hq_vit_* checkpoint but not read by the JAX converter:
# the point / mask prompt parts, the IoU head, the SAM tokens' hypernetwork
# MLPs and the released HQ fusion's later stages
UNUSED_CHECKPOINT_KEYS = _released_unused_keys()


def convert_released_checkpoint(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A released sam_hq_vit_* state dict -> this module's state dict: the
    keys of UNUSED_CHECKPOINT_KEYS dropped, the rest as they are (anything
    unknown, missing or of another shape is load_state_dict(strict=True)'s
    to refuse: the released HQ fusion's first stages have 2x2 kernels where
    this module has the JAX package's 4x4)."""
    unused = set(UNUSED_CHECKPOINT_KEYS)
    return {k: torch.as_tensor(v) for k, v in sd.items() if k not in unused}


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A released .pth (the state dict under 'model', or bare) -> this
    module's state dict (convert_released_checkpoint)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return convert_released_checkpoint(obj.get("model", obj))


def init_random_(model: Sam, seed: int = 0) -> Sam:
    """Seeded random weights: fan-in uniform layers (init_layers_), the
    Gaussian matrix N(0, 1), the relative-position tables and the position
    embedding N(0, 0.02)."""
    g = init_layers_(model, seed)
    with torch.no_grad():
        model.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix.normal_(
            0.0, 1.0, generator=g)
    return model
