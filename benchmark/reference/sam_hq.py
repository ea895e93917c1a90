"""SAM-HQ, box-prompted, in plain float32 PyTorch: the reference the
benchmark holds the port's ground-mask path to.

It follows the released code, github.com/SysCV/sam-hq,
`segment_anything/`: `build_sam_hq.py` (`_build_sam`: patch 16, LayerNorm
eps 1e-6, window 14, `use_rel_pos=True`, the neck to 256, the prompt
encoder and `MaskDecoderHQ` over a `TwoWayTransformer` of depth 2, width
256, 8 heads, MLP 2048), `modeling/image_encoder.py` (the ViT-det blocks:
window partition with zero padding, `get_rel_pos` and
`add_decomposed_rel_pos`, the neck of a 1x1 and a 3x3 convolution, each
followed by LayerNorm2d, and the outputs of the global blocks as the HQ
decoder's interm_embeddings), `modeling/prompt_encoder.py` (a box as its
two corners: random Fourier features plus the corner-type embeddings
point_embeddings[2] and [3]; the dense positional encoding of the
embedding's cell centres), `modeling/transformer.py` and
`modeling/mask_decoder_hq.py` (the output tokens, the two-way blocks with
their final token-to-image attention, the 4x output upscaling, the HQ
token's hypernetwork MLP `hf_mlp`, and its mask read from the upscaled
embedding plus the HQ fusion of the first global block's output and the
neck's embedding). It returns the HQ token's mask alone, the released
predictor's `hq_token_only=True`. Every parameter has the port's name,
which is the released state dict's wherever the port keeps the released
layer, so one state dict loads into both. The modules only hold the
parameters; the arithmetic is written out in SamHQ's methods, in float32,
with TF32 off while it runs (`strict_float32`).

Departures from the released code, each the port's (taken from the JAX
package, weakcube_tpu_torch/data/pseudo_gt/sam.py), which the comparison
has to share:
  - GELU is the tanh approximation, in the image encoder's MLPs and in the
    output upscaling (the released code uses nn.GELU, exact);
  - the HQ fusion is one 4x4, stride-4 transposed convolution per branch,
    compress_vit_feat on the first global block's output and
    embedding_encoder on the neck's embedding, their sum added to the
    upscaled embedding (the released branches are two 2x2 transposed
    convolutions with a LayerNorm2d and a GELU between them, and the sum
    passes the embedding_maskfeature convolutions first);
  - the first two-way block's self-attention keeps its residual (the
    released block with skip_first_layer_pe replaces the tokens by the
    attention's output);
  - the image embedding takes no dense prompt embedding (the released
    decoder adds the prompt encoder's no_mask_embed to every cell when no
    mask is given);
  - a box's corners are encoded as given, without the released
    _embed_boxes' half-pixel shift (+0.5).
The input is the released one (ResizeLongestSide's PIL BILINEAR resize of
the longest side to 1024, SAM's pixel statistics, zero padding at the
bottom and right; the box scaled by the same factor). The comparison reads
the low-resolution mask logits, (1, 256, 256) at 1024 px, before any
thresholding or resize.

`operand_precision="fp8"` makes it the benchmark's control: the operands
of every convolution, transposed convolution and linear layer, of the
relative-position products and of the attentions' two products are
rounded to float8 e4m3 (each tensor scaled by its largest magnitude onto
the format's 448), the precision below the configuration's bf16; the
arithmetic stays float32.

It imports no kernel of the port, nothing of the port's SAM module and
nothing of JAX.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# build_sam_hq.py: encoder_embed_dim, encoder_depth, encoder_num_heads,
# encoder_global_attn_indexes
VARIANTS = {
    "vit_b": (768, 12, 12, (2, 5, 8, 11)),
    "vit_l": (1024, 24, 16, (5, 11, 17, 23)),
    "vit_tiny": (192, 12, 3, (2, 5, 8, 11)),   # the port's small variant, for the CPU tests
}
PATCH = 16
WINDOW = 14
EMBED = 256        # prompt_embed_dim, the transformer's width
NUM_MASK_TOKENS = 4
LN_EPS = 1e-6
MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)


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


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")   # the port's GELU (module docstring)


# ---------------------------------------------------------------- parameters
# Modules that only hold parameters under the port's names; the arithmetic
# is SamHQ's.

class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, size: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        # the relative-position tables: 2 size - 1 rows of head_dim
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, grid: int):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = _Attention(dim, heads, window if window > 0 else grid)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _Mlp(dim, 4 * dim)


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, PATCH)


class _ImageEncoder(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, global_idx, grid: int):
        super().__init__()
        self.patch_embed = _PatchEmbed(dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, dim))
        self.blocks = nn.ModuleList(
            _Block(dim, heads, 0 if i in global_idx else WINDOW, grid) for i in range(depth))
        self.neck = nn.Sequential(nn.Conv2d(dim, EMBED, 1, bias=False),
                                  nn.LayerNorm(EMBED, eps=LN_EPS),
                                  nn.Conv2d(EMBED, EMBED, 3, padding=1, bias=False),
                                  nn.LayerNorm(EMBED, eps=LN_EPS))


class _PositionEmbeddingRandom(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, EMBED // 2))


class _PromptEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.pe_layer = _PositionEmbeddingRandom()
        # point_embeddings[2] and [3]: a box's top-left and bottom-right
        self.point_embeddings = nn.ModuleDict({"2": nn.Embedding(1, EMBED),
                                               "3": nn.Embedding(1, EMBED)})


class _TwoWayAttention(nn.Module):
    def __init__(self, down: int = 2):
        super().__init__()
        d = EMBED // down
        self.q_proj = nn.Linear(EMBED, d)
        self.k_proj = nn.Linear(EMBED, d)
        self.v_proj = nn.Linear(EMBED, d)
        self.out_proj = nn.Linear(d, EMBED)


class _TwoWayBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.self_attn = _TwoWayAttention(down=1)
        self.norm1 = nn.LayerNorm(EMBED, eps=LN_EPS)
        self.cross_attn_token_to_image = _TwoWayAttention()
        self.norm2 = nn.LayerNorm(EMBED, eps=LN_EPS)
        self.mlp = _Mlp(EMBED, 2048)
        self.norm3 = nn.LayerNorm(EMBED, eps=LN_EPS)
        self.norm4 = nn.LayerNorm(EMBED, eps=LN_EPS)
        self.cross_attn_image_to_token = _TwoWayAttention()


class _TwoWayTransformer(nn.Module):
    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList([_TwoWayBlock(), _TwoWayBlock()])
        self.final_attn_token_to_image = _TwoWayAttention()
        self.norm_final_attn = nn.LayerNorm(EMBED, eps=LN_EPS)


class _HyperMLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(EMBED, EMBED), nn.Linear(EMBED, EMBED),
                                     nn.Linear(EMBED, EMBED // 8)])


class _MaskDecoder(nn.Module):
    def __init__(self, vit_dim: int):
        super().__init__()
        self.iou_token = nn.Embedding(1, EMBED)
        self.mask_tokens = nn.Embedding(NUM_MASK_TOKENS, EMBED)
        self.hf_token = nn.Embedding(1, EMBED)
        self.transformer = _TwoWayTransformer()
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(EMBED, EMBED // 4, 2, 2), nn.LayerNorm(EMBED // 4, eps=LN_EPS),
            nn.Identity(), nn.ConvTranspose2d(EMBED // 4, EMBED // 8, 2, 2))
        self.hf_mlp = _HyperMLP()
        self.compress_vit_feat = nn.Sequential(nn.ConvTranspose2d(vit_dim, EMBED // 8, 4, 4))
        self.embedding_encoder = nn.Sequential(nn.ConvTranspose2d(EMBED, EMBED // 8, 4, 4))


# ---------------------------------------------------------------- the model

class SamHQ(nn.Module):
    """Box-prompted SAM-HQ at `variant`'s widths for `img_size` px inputs.
    forward: (B, 3, S, S) normalised float32 and (B, 4) XYXY boxes in the
    input's pixels -> (B, 1, S/4, S/4) float32 logits of the HQ token's
    mask."""

    def __init__(self, variant: str = "vit_l", img_size: int = 1024,
                 operand_precision: Optional[str] = None):
        super().__init__()
        dim, depth, self.heads, self.global_idx = VARIANTS[variant]
        self.img_size = img_size
        self.operand_precision = operand_precision
        grid = img_size // PATCH
        self.image_encoder = _ImageEncoder(dim, depth, self.heads, self.global_idx, grid)
        self.prompt_encoder = _PromptEncoder()
        self.mask_decoder = _MaskDecoder(dim)

    # -- operations whose operands the control rounds

    def _op(self, t: torch.Tensor) -> torch.Tensor:
        return _fp8(t) if self.operand_precision == "fp8" else t

    def _linear(self, x, m: nn.Linear):
        return F.linear(self._op(x), self._op(m.weight), m.bias)

    def _conv(self, x, m: nn.Conv2d):
        return F.conv2d(self._op(x), self._op(m.weight), m.bias, m.stride, m.padding)

    def _conv_t(self, x, m: nn.ConvTranspose2d):
        return F.conv_transpose2d(self._op(x), self._op(m.weight), m.bias, m.stride)

    @staticmethod
    def _ln2d(x, m: nn.LayerNorm):
        """LayerNorm2d over the channels of (B, C, H, W)."""
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + m.eps)
        return m.weight[:, None, None] * x + m.bias[:, None, None]

    # -- the image encoder (image_encoder.py)

    @staticmethod
    def _get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
        """get_rel_pos at q_size == k_size, the table's own 2 size - 1 rows
        (no interpolation)."""
        q = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
        k = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
        rel = (q - k) + (k_size - 1) * max(q_size / k_size, 1.0)
        return rel_pos[rel.long()]

    def _attention(self, x, m: _Attention):
        B, H, W, _ = x.shape
        qkv = self._linear(x, m.qkv).reshape(B, H * W, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * self.heads, H * W, -1).unbind(0)
        dh = q.shape[-1]
        attn = (self._op(q) * dh ** -0.5) @ self._op(k).transpose(-2, -1)
        # add_decomposed_rel_pos
        Rh = self._get_rel_pos(H, H, m.rel_pos_h)
        Rw = self._get_rel_pos(W, W, m.rel_pos_w)
        r_q = self._op(q).reshape(B * self.heads, H, W, dh)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, self._op(Rh))
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, self._op(Rw))
        attn = (attn.view(B * self.heads, H, W, H, W) + rel_h[:, :, :, :, None]
                + rel_w[:, :, :, None, :]).view(B * self.heads, H * W, H * W)
        attn = attn.softmax(dim=-1)
        out = (self._op(attn) @ self._op(v)).view(B, self.heads, H, W, -1)
        out = out.permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
        return self._linear(out, m.proj)

    @staticmethod
    def _window_partition(x, w: int):
        B, H, W, C = x.shape
        ph, pw = (w - H % w) % w, (w - W % w) % w
        if ph > 0 or pw > 0:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        Hp, Wp = H + ph, W + pw
        x = x.view(B, Hp // w, w, Wp // w, w, C)
        return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, w, w, C), (Hp, Wp)

    @staticmethod
    def _window_unpartition(x, w: int, pad_hw, hw):
        Hp, Wp = pad_hw
        H, W = hw
        B = x.shape[0] // (Hp * Wp // w // w)
        x = x.view(B, Hp // w, Wp // w, w, w, -1)
        x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
        return x[:, :H, :W, :].contiguous()

    def _block(self, x, b: _Block):
        shortcut = x
        x = F.layer_norm(x, x.shape[-1:], b.norm1.weight, b.norm1.bias, LN_EPS)
        if b.window > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = self._window_partition(x, b.window)
        x = self._attention(x, b.attn)
        if b.window > 0:
            x = self._window_unpartition(x, b.window, pad_hw, (H, W))
        x = shortcut + x
        h = F.layer_norm(x, x.shape[-1:], b.norm2.weight, b.norm2.bias, LN_EPS)
        return x + self._linear(_gelu(self._linear(h, b.mlp.lin1)), b.mlp.lin2)

    def encoder(self, x: torch.Tensor):
        """(B, 3, S, S) -> (the neck's embedding (B, 256, S/16, S/16), [each
        global block's output (B, S/16, S/16, dim)])."""
        e = self.image_encoder
        x = self._conv(x, e.patch_embed.proj).permute(0, 2, 3, 1) + e.pos_embed
        interm = []
        for b in e.blocks:
            x = self._block(x, b)
            if b.window == 0:
                interm.append(x)
        c1, ln1, c2, ln2 = e.neck
        n = self._ln2d(self._conv(x.permute(0, 3, 1, 2), c1), ln1)
        n = self._ln2d(self._conv(n, c2), ln2)
        return n, interm

    # -- the prompt encoder (prompt_encoder.py)

    def _pe_encoding(self, coords: torch.Tensor) -> torch.Tensor:
        g = self.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix
        coords = 2 * coords - 1
        coords = (coords @ g) * (2 * np.pi)
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def dense_pe(self, h: int, w: int, device) -> torch.Tensor:
        """get_dense_pe: (256, h, w), the encoding of the cells' centres."""
        grid = torch.ones((h, w), device=device, dtype=torch.float32)
        y = (grid.cumsum(dim=0) - 0.5) / h
        x = (grid.cumsum(dim=1) - 0.5) / w
        return self._pe_encoding(torch.stack([x, y], dim=-1)).permute(2, 0, 1)

    def embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """(B, 4) XYXY in the input's pixels -> (B, 2, 256) (module
        docstring: no half-pixel shift)."""
        coords = boxes.reshape(-1, 2, 2) / self.img_size
        emb = self._pe_encoding(coords)
        pe = self.prompt_encoder.point_embeddings
        return emb + torch.cat([pe["2"].weight, pe["3"].weight])[None]

    # -- the mask decoder (transformer.py, mask_decoder_hq.py)

    def _attn2(self, q, k, v, m: _TwoWayAttention, heads: int = 8):
        q, k, v = self._linear(q, m.q_proj), self._linear(k, m.k_proj), self._linear(v, m.v_proj)

        def sep(x):
            b, n, c = x.shape
            return x.reshape(b, n, heads, c // heads).transpose(1, 2)
        q, k, v = sep(q), sep(k), sep(v)
        attn = self._op(q) @ self._op(k).permute(0, 1, 3, 2) / math.sqrt(q.shape[-1])
        out = self._op(torch.softmax(attn, dim=-1)) @ self._op(v)
        b, h, n, c = out.shape
        return self._linear(out.transpose(1, 2).reshape(b, n, h * c), m.out_proj)

    @staticmethod
    def _ln(x, m: nn.LayerNorm):
        return F.layer_norm(x, x.shape[-1:], m.weight, m.bias, LN_EPS)

    def _two_way(self, image, image_pe, tokens):
        """TwoWayTransformer.forward: image (B, 256, h, w) -> (tokens, keys)."""
        tr = self.mask_decoder.transformer
        keys = image.flatten(2).permute(0, 2, 1)
        key_pe = image_pe.flatten(2).permute(0, 2, 1)
        queries, query_pe = tokens, tokens
        for i, blk in enumerate(tr.layers):
            # the first block's self-attention without the pe, its residual
            # kept (module docstring)
            q = queries if i == 0 else queries + query_pe
            queries = self._ln(queries + self._attn2(q, q, queries, blk.self_attn), blk.norm1)
            q, k = queries + query_pe, keys + key_pe
            queries = self._ln(queries + self._attn2(q, k, keys, blk.cross_attn_token_to_image),
                               blk.norm2)
            mlp = self._linear(F.relu(self._linear(queries, blk.mlp.lin1)), blk.mlp.lin2)
            queries = self._ln(queries + mlp, blk.norm3)
            q, k = queries + query_pe, keys + key_pe
            keys = self._ln(keys + self._attn2(k, q, queries, blk.cross_attn_image_to_token),
                            blk.norm4)
        q, k = queries + query_pe, keys + key_pe
        queries = self._ln(queries + self._attn2(q, k, keys, tr.final_attn_token_to_image),
                           tr.norm_final_attn)
        return queries, keys

    def decoder(self, embed, interm, sparse):
        """MaskDecoderHQ.predict_masks for one box per image: embed (B, 256,
        h, w), interm the global blocks' outputs, sparse (B, 2, 256) ->
        (B, 1, 4h, 4w) logits of the HQ token's mask."""
        md = self.mask_decoder
        B, C, h, w = embed.shape
        out_tokens = torch.cat([md.iou_token.weight, md.mask_tokens.weight, md.hf_token.weight])
        tokens = torch.cat([out_tokens[None].expand(B, -1, -1), sparse], dim=1)
        pe = self.dense_pe(h, w, embed.device)[None].expand(B, -1, -1, -1)
        hs, src = self._two_way(embed, pe, tokens)
        mask_tokens_out = hs[:, 1:1 + NUM_MASK_TOKENS + 1]
        src = src.transpose(1, 2).reshape(B, C, h, w)
        up1, ln, _, up2 = md.output_upscaling
        up = _gelu(self._ln2d(self._conv_t(src, up1), ln))
        up = _gelu(self._conv_t(up, up2))
        hq = (self._conv_t(interm[0].permute(0, 3, 1, 2), md.compress_vit_feat[0])
              + self._conv_t(embed, md.embedding_encoder[0]))
        up = up + hq
        hm = md.hf_mlp.layers
        t = mask_tokens_out[:, -1]
        hyper = self._linear(F.relu(self._linear(F.relu(self._linear(t, hm[0])), hm[1])), hm[2])
        b, c, H4, W4 = up.shape
        return (hyper[:, None] @ up.reshape(b, c, H4 * W4)).reshape(b, 1, H4, W4)

    def forward(self, x: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        embed, interm = self.encoder(x)
        return self.decoder(embed, interm, self.embed_boxes(boxes))


# ---------------------------------------------------------------- the path

def preprocess(image: np.ndarray, size: int) -> Tuple[torch.Tensor, float]:
    """(H, W, 3) uint8 RGB -> ((1, 3, size, size) normalised float32, the
    scale of the longest side): ResizeLongestSide (PIL BILINEAR to the
    rounded size), SAM's pixel statistics, zero padding."""
    from PIL import Image
    h, w = image.shape[:2]
    s = size / max(h, w)
    nh, nw = int(h * s + 0.5), int(w * s + 0.5)
    r = np.asarray(Image.fromarray(np.asarray(image, np.uint8)).resize((nw, nh), Image.BILINEAR))
    x = (torch.from_numpy(r.astype(np.float32)) - torch.tensor(MEAN)) / torch.tensor(STD)
    x = F.pad(x.permute(2, 0, 1), (0, size - nw, 0, size - nh))
    return x[None], s


@torch.no_grad()
def mask_logits(model: SamHQ, images: Sequence[np.ndarray], boxes: Sequence[np.ndarray],
                device) -> List[torch.Tensor]:
    """Each (H, W, 3) uint8 image with its XYXY box in the image's pixels,
    one at a time, through preprocess and the model on `device`, in float32
    with TF32 off -> (1, S/4, S/4) float32 host logits per image."""
    out = []
    with strict_float32():
        for img, box in zip(images, boxes):
            x, s = preprocess(np.asarray(img), model.img_size)
            b = torch.as_tensor(np.asarray(box, np.float32) * np.float32(s))[None]
            out.append(model(x.to(device), b.to(device))[0].float().cpu())
    return out
