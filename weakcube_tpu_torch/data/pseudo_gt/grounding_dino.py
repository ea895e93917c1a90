"""GroundingDINO (Swin-T "OGC") in PyTorch: text-prompted boxes for the
ground-segmentation pseudo-GT pass (weakcube_tpu/data/pseudo_gt/
grounding_dino.py).

The released `groundingdino_swint_ogc` architecture, as the JAX package
computes it:

  * Swin-T trunk (swin.py) -> strides 8/16/32 + an extra stride-64 3x3
    convolution, each projected by a 1x1 convolution + GroupNorm(32);
  * BERT-base text encoder with the per-phrase attention mask and position
    ids that restart at each phrase (build_text_masks);
  * sine HW position embedding (temperature 20, normalised) + a learned
    per-level embedding;
  * feature enhancer: N x [bi-directional image/text fusion (one shared
    QK^T softmaxed along each modality, gamma residuals), text self-
    attention (4 heads, ReLU FFN), image deformable self-attention (8 heads,
    4 levels, 4 points)], post-norm;
  * multi-scale deformable attention as an explicit gather of the four
    bilinear corners, border-clamped as the JAX package does (the official
    CUDA op pads with zeros);
  * two-stage query selection over the proposal grid, the decoder's
    iterative refinement through one shared bbox_embed, and contrastive
    logits against the text.

Module names are the released checkpoint's; `convert_released_checkpoint`
applies the JAX converter's changes to a released state dict (BERT's token-
type row folded into the word table, positions cut to MAX_TEXT, the patch
merge's 4C permutation) and drops the keys that converter ignores
(UNUSED_CHECKPOINT_KEYS), so that `load_state_dict(strict=True)` takes it.
`utils/convert.py::gdino_flax_to_torch` maps the JAX package's parameter
tree onto the same names.

Public layouts follow the JAX module: images (B, H, W, 3) normalised,
token ids (B, T). The model computes in the dtype of its parameters;
attention logits, softmaxes, boxes and logits in at least float32.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .swin import LN_EPS, SwinT, init_layers_, logits_dtype

D_MODEL = 256
N_HEADS = 8
N_LEVELS = 4
N_POINTS = 4
N_QUERIES = 900
MAX_TEXT = 64
FFN_DIM = 2048          # encoder/decoder FFN
TEXT_HEADS = 4          # text-enhancer heads (official: nhead // 2)
TEXT_FFN = 1024         # text-enhancer FFN (official: dim_feedforward // 2)
FUSION_DIM = 1024       # BiMultiHeadAttention embed dim
FUSION_HEADS = 4
BERT_VOCAB, BERT_DIM, BERT_LAYERS, BERT_HEADS = 30522, 768, 12, 12
SWIN_DEPTHS = (2, 2, 6, 2)


def _split(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., L, D) -> (..., heads, L, D / heads)."""
    return t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads).transpose(-3, -2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(..., heads, L, dh) -> (..., L, heads * dh)."""
    t = t.transpose(-3, -2)
    return t.reshape(*t.shape[:-2], -1)


def _attend(q, k, v, heads: int, mask=None) -> torch.Tensor:
    """Scaled dot-product attention over `heads` of projected q, k, v
    (..., L, D); mask (B, Lk) or (B, Lq, Lk), True = may attend, else the
    logit is -1e9. Logits and softmax in at least float32."""
    dh = q.shape[-1] // heads
    a = ((_split(q, heads) * dh ** -0.5) @ _split(k, heads).transpose(-1, -2)).to(
        logits_dtype(q.dtype))
    if mask is not None:
        m = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None]
        a = torch.where(m, a, torch.full((), -1e9, dtype=a.dtype, device=a.device))
    return _merge(torch.softmax(a, -1).to(v.dtype) @ _split(v, heads))


class MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters (in_proj_weight / in_proj_bias /
    out_proj), computed as the JAX package's separate q, k, v Denses."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q_in, k_in, v_in, mask=None):
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        out = _attend(F.linear(q_in, wq, bq), F.linear(k_in, wk, bk), F.linear(v_in, wv, bv),
                      self.heads, mask)
        return self.out_proj(out)


# ---------------------------------------------------------------------------
# text encoder (BERT-base, HF names)
# ---------------------------------------------------------------------------

class _BertSelf(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)


class _DenseNorm(nn.Module):
    def __init__(self, din: int, dout: int):
        super().__init__()
        self.dense = nn.Linear(din, dout)
        self.LayerNorm = nn.LayerNorm(dout, eps=LN_EPS)


class _BertAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.self = _BertSelf(dim)
        self.output = _DenseNorm(dim, dim)


class _Dense(nn.Module):
    def __init__(self, din: int, dout: int):
        super().__init__()
        self.dense = nn.Linear(din, dout)


class BertLayer(nn.Module):
    """Post-norm BERT layer with exact (erf) GELU; LayerNorm eps 1e-6 as the
    JAX package (HF BERT's is 1e-12)."""

    def __init__(self, dim: int = BERT_DIM, heads: int = BERT_HEADS):
        super().__init__()
        self.heads = heads
        self.attention = _BertAttention(dim)
        self.intermediate = _Dense(dim, 4 * dim)
        self.output = _DenseNorm(4 * dim, dim)

    def forward(self, x, mask):
        """mask: (B, T) padding mask or (B, T, T) attention mask (True = may
        attend), e.g. the per-phrase mask of build_text_masks."""
        s, o = self.attention.self, self.attention.output
        a = _attend(s.query(x), s.key(x), s.value(x), self.heads, mask)
        x = o.LayerNorm(x + o.dense(a))
        h = self.output.dense(F.gelu(self.intermediate.dense(x)))
        return self.output.LayerNorm(x + h)


class _BertEmbeddings(nn.Module):
    def __init__(self, vocab: int, dim: int):
        super().__init__()
        # the word table holds the single segment's token-type row folded in
        self.word_embeddings = nn.Embedding(vocab, dim)
        self.position_embeddings = nn.Embedding(MAX_TEXT, dim)
        self.LayerNorm = nn.LayerNorm(dim, eps=LN_EPS)


class _BertLayers(nn.Module):
    def __init__(self, dim: int, layers: int):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(dim) for _ in range(layers))


class BertEncoder(nn.Module):
    def __init__(self, vocab: int = BERT_VOCAB, dim: int = BERT_DIM, layers: int = BERT_LAYERS):
        super().__init__()
        self.embeddings = _BertEmbeddings(vocab, dim)
        self.encoder = _BertLayers(dim, layers)

    def forward(self, token_ids, mask, position_ids=None):
        """token_ids (B, T) int; mask (B, T) or (B, T, T); position_ids (B, T)
        int (restarting per phrase, see build_text_masks) or None."""
        e = self.embeddings
        pos = e.position_embeddings.weight
        p = pos[:token_ids.shape[1]][None] if position_ids is None else pos[position_ids.long()]
        x = e.LayerNorm(e.word_embeddings(token_ids.long()) + p)
        for layer in self.encoder.layer:
            x = layer(x, mask)
        return x


def build_text_masks(token_ids: np.ndarray, special_ids=(101, 102, 1012, 1029)):
    """Official generate_masks_with_special_tokens_and_transfer_map, on the
    host: tokens between consecutive special tokens ([CLS]/[SEP]/./?) attend
    within their phrase (specials attend only to themselves), and position
    ids restart at each phrase. Returns (attn_mask (B, T, T) bool,
    position_ids (B, T) int64, token_mask (B, T) bool), numpy."""
    token_ids = np.asarray(token_ids)
    B, T = token_ids.shape
    special = np.isin(token_ids, np.asarray(special_ids))
    attn = np.tile(np.eye(T, dtype=bool)[None], (B, 1, 1))
    pos_ids = np.zeros((B, T), np.int64)
    for b in range(B):
        prev = 0
        for col in np.nonzero(special[b])[0]:
            if col not in (0, T - 1):
                attn[b, prev + 1:col + 1, prev + 1:col + 1] = True
                pos_ids[b, prev + 1:col + 1] = np.arange(col - prev)
            prev = int(col)
    return attn, pos_ids, token_ids != 0


# ---------------------------------------------------------------------------
# position embeddings
# ---------------------------------------------------------------------------

def sine_pos_embed_hw(h: int, w: int, dim: int = D_MODEL,
                      temperature: float = 20.0) -> np.ndarray:
    """PositionEmbeddingSineHW (normalised, scale 2*pi, temperature 20):
    (h*w, dim) float32, y features first, then x."""
    scale = 2 * math.pi
    eps = 1e-6
    half = dim // 2
    y = np.arange(1, h + 1, dtype=np.float32)[:, None] / (h + eps) * scale
    x = np.arange(1, w + 1, dtype=np.float32)[None, :] / (w + eps) * scale
    y = np.broadcast_to(y, (h, w))
    x = np.broadcast_to(x, (h, w))
    dim_t = temperature ** (2 * (np.arange(half, dtype=np.float32) // 2) / half)
    py = y[..., None] / dim_t
    px = x[..., None] / dim_t

    def interleave(p):
        return np.stack([np.sin(p[..., 0::2]), np.cos(p[..., 1::2])], axis=-1).reshape(h, w, half)
    return np.concatenate([interleave(py), interleave(px)], -1).reshape(h * w, dim)


def sine_embed_1d(coords: torch.Tensor, dim: int = 128,
                  temperature: float = 10000.0) -> torch.Tensor:
    """gen_sineembed_position for one coordinate channel: (...,) -> (..., dim)
    float32; coords normalised to [0, 1], scaled by 2*pi."""
    scale = 2 * math.pi
    dim_t = temperature ** (2 * (torch.arange(dim, dtype=torch.float32, device=coords.device)
                                 // 2) / dim)
    p = coords[..., None].float() * scale / dim_t
    return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])], -1).reshape(
        *coords.shape, dim)


def box_sine_embed(ref: torch.Tensor) -> torch.Tensor:
    """(..., 4) cxcywh -> (..., 512) sine embedding in the official order
    [y, x, w, h]."""
    return torch.cat([sine_embed_1d(ref[..., 1]), sine_embed_1d(ref[..., 0]),
                      sine_embed_1d(ref[..., 2]), sine_embed_1d(ref[..., 3])], -1)


# ---------------------------------------------------------------------------
# multi-scale deformable attention (explicit gather)
# ---------------------------------------------------------------------------

def ms_deform_attn(value: torch.Tensor, value_shapes: Sequence[Tuple[int, int]],
                   sampling_locs: torch.Tensor, attn_weights: torch.Tensor) -> torch.Tensor:
    """value: (B, sumHW, heads, Dh); value_shapes: [(h, w)] per level;
    sampling_locs: (B, Q, heads, levels, points, 2) normalised [0, 1] (x, y);
    attn_weights: (B, Q, heads, levels * points), softmaxed.
    Returns (B, Q, heads * Dh).

    Bilinear sampling at (x * w - 0.5, y * h - 0.5) with the four corners
    clamped to the map (a location past the border reads the border, as
    the JAX package; the official CUDA op reads zeros there). The corners
    are gathered by int64 row indices into the level's (B * heads * h * w,
    Dh) values."""
    B, _, H, Dh = value.shape
    Q, L, P = sampling_locs.shape[1], sampling_locs.shape[3], sampling_locs.shape[4]
    attn = attn_weights.reshape(B, Q, H, L, P).permute(0, 2, 1, 3, 4)   # (B, H, Q, L, P)
    locs = sampling_locs.permute(0, 2, 1, 3, 4, 5)                       # (B, H, Q, L, P, 2)
    out = 0.0
    offset = 0
    for li, (h, w) in enumerate(value_shapes):
        rows = value[:, offset:offset + h * w].permute(0, 2, 1, 3).reshape(-1, Dh)
        base = torch.arange(B * H, device=value.device).reshape(B, H, 1, 1) * (h * w)
        offset += h * w
        x = locs[:, :, :, li, :, 0] * w - 0.5                            # (B, H, Q, P)
        y = locs[:, :, :, li, :, 1] * h - 0.5
        x0 = torch.clamp(torch.floor(x), 0, w - 1)
        y0 = torch.clamp(torch.floor(y), 0, h - 1)
        x1 = torch.clamp(x0 + 1, 0, w - 1)
        y1 = torch.clamp(y0 + 1, 0, h - 1)
        fx = torch.clamp(x - x0, 0, 1)[..., None]
        fy = torch.clamp(y - y0, 0, 1)[..., None]

        def gather(yy, xx):
            idx = base + yy.long() * w + xx.long()
            return rows.index_select(0, idx.reshape(-1)).reshape(B, H, Q, P, Dh)

        samp = (gather(y0, x0) * (1 - fx) * (1 - fy) + gather(y0, x1) * fx * (1 - fy)
                + gather(y1, x0) * (1 - fx) * fy + gather(y1, x1) * fx * fy)
        out = out + torch.sum(samp * attn[:, :, :, li, :, None], dim=3)  # (B, H, Q, Dh)
    return out.permute(0, 2, 1, 3).reshape(B, Q, H * Dh)


class MSDeformAttn(nn.Module):
    def __init__(self, dim: int = D_MODEL):
        super().__init__()
        self.sampling_offsets = nn.Linear(dim, N_HEADS * N_LEVELS * N_POINTS * 2)
        self.attention_weights = nn.Linear(dim, N_HEADS * N_LEVELS * N_POINTS)
        self.value_proj = nn.Linear(dim, dim)
        self.output_proj = nn.Linear(dim, dim)

    def forward(self, query, ref_points, value, value_shapes):
        """query: (B, Q, D) with its position embedding added; ref_points:
        (B, Q, 2) centres or (B, Q, 4) boxes, normalised; value: (B, sumHW, D)."""
        B, Q, D = query.shape
        v = self.value_proj(value).reshape(B, -1, N_HEADS, D // N_HEADS)
        off = self.sampling_offsets(query).reshape(B, Q, N_HEADS, N_LEVELS, N_POINTS, 2)
        aw = torch.softmax(self.attention_weights(query).reshape(B, Q, N_HEADS, -1), -1)
        if ref_points.shape[-1] == 4:
            ctr, wh = ref_points[..., :2], ref_points[..., 2:]
            locs = ctr[:, :, None, None, None] + off / N_POINTS * wh[:, :, None, None, None] * 0.5
        else:
            norm = torch.tensor([(w, h) for h, w in value_shapes], dtype=torch.float32,
                                device=query.device)[None, None, None, :, None]
            locs = ref_points[:, :, None, None, None] + off / norm
        return self.output_proj(ms_deform_attn(v, value_shapes, locs, aw).to(query.dtype))


# ---------------------------------------------------------------------------
# fusion / encoder / decoder
# ---------------------------------------------------------------------------

class BiMultiHeadAttention(nn.Module):
    def __init__(self, dim: int = D_MODEL):
        super().__init__()
        self.v_proj = nn.Linear(dim, FUSION_DIM)
        self.l_proj = nn.Linear(dim, FUSION_DIM)
        self.values_v_proj = nn.Linear(dim, FUSION_DIM)
        self.values_l_proj = nn.Linear(dim, FUSION_DIM)
        self.out_v_proj = nn.Linear(FUSION_DIM, dim)
        self.out_l_proj = nn.Linear(FUSION_DIM, dim)


class BiAttentionFusion(nn.Module):
    """GLIP BiAttentionBlock: pre-LN inputs, ONE shared QK^T logit matrix
    (clamped to +-50000) softmaxed along each modality (image -> text with
    the padding at -1e9; text -> image after each text token's own max is
    subtracted), gamma-scaled residuals."""

    def __init__(self, dim: int = D_MODEL):
        super().__init__()
        self.layer_norm_v = nn.LayerNorm(dim, eps=LN_EPS)
        self.layer_norm_l = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = BiMultiHeadAttention(dim)
        self.gamma_v = nn.Parameter(torch.full((dim,), 0.125))
        self.gamma_l = nn.Parameter(torch.full((dim,), 0.125))

    def forward(self, img, txt, txt_mask):
        at = self.attn
        dh = FUSION_DIM // FUSION_HEADS
        vn, ln = self.layer_norm_v(img), self.layer_norm_l(txt)
        q = at.v_proj(vn) * dh ** -0.5
        k = at.l_proj(ln)
        vv = _split(at.values_v_proj(vn), FUSION_HEADS)
        vl = _split(at.values_l_proj(ln), FUSION_HEADS)
        a = (_split(q, FUSION_HEADS) @ _split(k, FUSION_HEADS).transpose(-1, -2)).to(
            logits_dtype(img.dtype))
        a = torch.clamp(a, -50000.0, 50000.0)                          # (B, h, img, txt)
        a_v = torch.where(txt_mask[:, None, None, :], a,
                          torch.full((), -1e9, dtype=a.dtype, device=a.device))
        o_v = at.out_v_proj(_merge(torch.softmax(a_v, -1).to(img.dtype) @ vl))
        a_t = a.transpose(-2, -1)                                      # (B, h, txt, img)
        a_t = a_t - torch.amax(a_t, -1, keepdim=True)
        a_l = torch.softmax(torch.clamp(a_t, -50000.0, 50000.0), -1).to(img.dtype)
        o_l = at.out_l_proj(_merge(a_l @ vv))
        return img + self.gamma_v * o_v, txt + self.gamma_l * o_l


class TextEnhancerLayer(nn.Module):
    """The enhancer's text self-attention: BertLayer(256, 4 heads, ReLU FFN
    1024) with the text position embedding added to q and k."""

    def __init__(self, dim: int = D_MODEL):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, TEXT_HEADS)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.linear1 = nn.Linear(dim, TEXT_FFN)
        self.linear2 = nn.Linear(TEXT_FFN, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, mask, pos):
        qk = x + pos
        x = self.norm1(x + self.self_attn(qk, qk, x, mask))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class DeformableEncoderLayer(nn.Module):
    def __init__(self, dim: int = D_MODEL):
        super().__init__()
        self.self_attn = MSDeformAttn(dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.linear1 = nn.Linear(dim, FFN_DIM)
        self.linear2 = nn.Linear(FFN_DIM, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, img, img_pos, img_ref, shapes):
        img = self.norm1(img + self.self_attn(img + img_pos, img_ref, img, shapes))
        return self.norm2(img + self.linear2(F.relu(self.linear1(img))))


def enhancer_step(fusion, text, image, img, img_pos, img_ref, txt, txt_pos, txt_mask,
                  txt_self_mask, shapes):
    """One feature-enhancer step (the JAX EnhancerLayer): fusion -> text
    self-attention -> image deformable self-attention + FFN. Its three
    modules live in the released checkpoint's three lists
    (transformer.encoder.fusion_layers / text_layers / layers)."""
    img, txt = fusion(img, txt, txt_mask)
    txt = text(txt, txt_self_mask, txt_pos)
    return image(img, img_pos, img_ref, shapes), txt


class DecoderLayer(nn.Module):
    """Official DeformableTransformerDecoderLayer order: self-attention (q
    and k carry the query position) -> text cross-attention -> deformable
    cross-attention -> FFN, each post-normed (norm2 / catext_norm / norm1 /
    norm3)."""

    def __init__(self, dim: int = D_MODEL):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, N_HEADS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ca_text = MultiheadAttention(dim, N_HEADS)
        self.catext_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.cross_attn = MSDeformAttn(dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.linear1 = nn.Linear(dim, FFN_DIM)
        self.linear2 = nn.Linear(FFN_DIM, dim)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, q, q_pos, ref, img, img_shapes, txt, txt_mask):
        qp = q + q_pos
        q = self.norm2(q + self.self_attn(qp, qp, q))
        q = self.catext_norm(q + self.ca_text(q + q_pos, txt, txt, txt_mask))
        q = self.norm1(q + self.cross_attn(q + q_pos, ref, img, img_shapes))
        return self.norm3(q + self.linear2(F.relu(self.linear1(q))))


class MLP(nn.Module):
    """Linear layers with ReLU between them."""

    def __init__(self, din: int, dims: Sequence[int]):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip([din, *dims[:-1]], dims))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def _inverse_sigmoid(x, eps: float = 1e-5):
    x = torch.clamp(x, eps, 1 - eps)
    return torch.log(x / (1 - x))


class _Encoder(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.layers = nn.ModuleList(DeformableEncoderLayer() for _ in range(n))
        self.text_layers = nn.ModuleList(TextEnhancerLayer() for _ in range(n))
        self.fusion_layers = nn.ModuleList(BiAttentionFusion() for _ in range(n))


class _Decoder(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer() for _ in range(n))
        self.norm = nn.LayerNorm(D_MODEL, eps=LN_EPS)
        self.ref_point_head = MLP(2 * D_MODEL, (D_MODEL, D_MODEL))
        # one bbox_embed shared by every layer (dec_pred_bbox_embed_share)
        self.bbox_embed = nn.ModuleList([MLP(D_MODEL, (D_MODEL, D_MODEL, 4))])


class _Transformer(nn.Module):
    def __init__(self, num_enhancer: int, num_decoder: int, num_queries: int):
        super().__init__()
        self.level_embed = nn.Parameter(torch.zeros(N_LEVELS, D_MODEL))
        self.encoder = _Encoder(num_enhancer)
        self.enc_output = nn.Linear(D_MODEL, D_MODEL)
        self.enc_output_norm = nn.LayerNorm(D_MODEL, eps=LN_EPS)
        self.enc_out_bbox_embed = MLP(D_MODEL, (D_MODEL, D_MODEL, 4))
        self.tgt_embed = nn.Embedding(num_queries, D_MODEL)
        self.decoder = _Decoder(num_decoder)


class GroundingDINO(nn.Module):
    """images (B, H, W, 3) + token ids (B, T) -> (boxes (B, Q, 4) cxcywh
    normalised, logits (B, Q, T) per-token grounding scores). Swin-T and
    BERT-base at their full widths; the enhancer, decoder and query counts
    as given (the released model: 6, 6, 900)."""

    def __init__(self, num_enhancer: int = 6, num_decoder: int = 6,
                 num_queries: int = N_QUERIES):
        super().__init__()
        self.num_queries = num_queries
        self.backbone = nn.ModuleList([SwinT()])
        self.bert = BertEncoder()
        self.feat_map = nn.Linear(BERT_DIM, D_MODEL)
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, D_MODEL, k, s, k // 2), nn.GroupNorm(32, D_MODEL, eps=LN_EPS))
            for c, k, s in ((192, 1, 1), (384, 1, 1), (768, 1, 1), (768, 3, 2)))
        self.transformer = _Transformer(num_enhancer, num_decoder, num_queries)

    def forward(self, images, token_ids, token_mask, text_attn_mask=None, position_ids=None):
        """text_attn_mask (B, T, T) / position_ids (B, T): the per-phrase mask
        and restarting position ids of build_text_masks; without them the
        padding mask and absolute positions."""
        dt = self.feat_map.weight.dtype
        ld = logits_dtype(dt)
        dev = images.device
        tr = self.transformer
        feats = self.backbone[0](images)
        srcs = [self.input_proj[i](f.permute(0, 3, 1, 2)) for i, f in enumerate(feats)]
        srcs.append(self.input_proj[3](feats[-1].permute(0, 3, 1, 2)))
        shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
        B = images.shape[0]
        img = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)   # (B, sumHW, D)

        # sine HW position embedding (in the compute dtype) + level embedding
        pos = torch.cat([torch.from_numpy(sine_pos_embed_hw(h, w)).to(dev, dt) + tr.level_embed[li]
                         for li, (h, w) in enumerate(shapes)], 0)[None]
        refs = []
        for h, w in shapes:
            gy, gx = torch.meshgrid((torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h,
                                    (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w,
                                    indexing="ij")
            refs.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        img_ref = torch.cat(refs)[None].expand(B, -1, -1)

        # text
        self_mask = text_attn_mask if text_attn_mask is not None else token_mask
        txt = self.feat_map(self.bert(token_ids, self_mask, position_ids))
        ids = (position_ids if position_ids is not None
               else torch.arange(token_ids.shape[1], device=dev)[None])
        txt_pos = sine_embed_1d(ids.float(), D_MODEL).to(dt)

        # feature enhancer
        enc = tr.encoder
        for fusion, text, image in zip(enc.fusion_layers, enc.text_layers, enc.layers):
            img, txt = enhancer_step(fusion, text, image, img, pos, img_ref, txt, txt_pos,
                                     token_mask, self_mask, shapes)

        ref, top_idx = self.select_queries(img, img_ref, txt, token_mask, shapes)
        q = tr.tgt_embed.weight[None, :top_idx.shape[1]].expand(B, -1, -1)
        neg_inf = torch.full((), -math.inf, dtype=ld, device=dev)

        # decoder with iterative refinement through the shared bbox_embed
        dec = tr.decoder
        bbox_embed = dec.bbox_embed[0]
        normed = q
        for i, layer in enumerate(dec.layers):
            q_pos = dec.ref_point_head(box_sine_embed(ref).to(dt))
            q = layer(q, q_pos, ref, img, shapes, txt, token_mask)
            # the refinement reads the raw output, the reported boxes the normed
            delta = bbox_embed(q)
            normed = dec.norm(q)
            if i < len(dec.layers) - 1:
                ref = torch.sigmoid(delta + _inverse_sigmoid(ref))
        boxes = torch.sigmoid(bbox_embed(normed) + _inverse_sigmoid(ref))
        logits = torch.where(token_mask[:, None, :], (normed @ txt.transpose(1, 2)).to(ld),
                             neg_inf)
        return boxes, logits

    def select_queries(self, img, img_ref, txt, token_mask, shapes):
        """Two-stage query selection over the proposal grid (centres, wh =
        0.05 * 2^level; near-border proposals invalid): the num_queries
        proposals of largest text logit, in jax.lax.top_k's order
        (descending, ties to the lower index). Returns (reference boxes
        (B, Q, 4) cxcywh, proposal indices (B, Q))."""
        tr = self.transformer
        dev = img.device
        B = img.shape[0]
        whs = torch.cat([torch.full((h * w, 2), 0.05 * 2.0 ** li, device=dev)
                         for li, (h, w) in enumerate(shapes)])
        proposals = torch.cat([img_ref, whs[None].expand(B, -1, -1)], -1)
        valid = torch.all((proposals > 0.01) & (proposals < 0.99), -1)
        prop_logit = torch.where(valid[..., None], _inverse_sigmoid(proposals),
                                 torch.full((), math.inf, device=dev))
        mem = torch.where(valid[..., None], img, torch.zeros((), dtype=img.dtype, device=dev))
        mem = tr.enc_output_norm(tr.enc_output(mem))
        ld = logits_dtype(img.dtype)
        neg_inf = torch.full((), -math.inf, dtype=ld, device=dev)
        logits_all = torch.where(token_mask[:, None, :], (mem @ txt.transpose(1, 2)).to(ld),
                                 neg_inf)
        score = torch.where(valid, torch.amax(logits_all, -1), neg_inf)
        top_idx = torch.sort(score, dim=-1, descending=True, stable=True).indices[
            :, :min(self.num_queries, score.shape[1])]
        coord_logit = tr.enc_out_bbox_embed(mem) + prop_logit
        ref = torch.sigmoid(torch.gather(coord_logit, 1, top_idx[..., None].expand(-1, -1, 4)))
        return ref, top_idx


def predict_ground_boxes(model: GroundingDINO, images: torch.Tensor, token_ids: torch.Tensor,
                         token_mask: torch.Tensor):
    """The reference predict() for the 'ground' prompt: boxes (cxcywh) and
    each query's score, the sigmoid of its largest token logit."""
    attn, pos_ids, _ = build_text_masks(token_ids.cpu().numpy())
    dev = images.device
    with torch.inference_mode():
        boxes, logits = model(images, token_ids, token_mask, torch.from_numpy(attn).to(dev),
                              torch.from_numpy(pos_ids).to(dev))
    return boxes, torch.sigmoid(torch.amax(logits, -1))


# ---------------------------------------------------------------------------
# released checkpoint (groundingdino_swint_ogc.pth)
# ---------------------------------------------------------------------------

def _released_unused_keys() -> Tuple[str, ...]:
    keys = [f"backbone.0.layers.{si}.blocks.{bi}.attn.relative_position_index"
            for si, depth in enumerate(SWIN_DEPTHS) for bi in range(depth)]
    keys += ["bert.embeddings.position_ids", "bert.pooler.dense.weight",
             "bert.pooler.dense.bias"]
    # copies of the one shared bbox_embed
    for prefix, first in (("transformer.decoder.bbox_embed", 1), ("bbox_embed", 0)):
        keys += [f"{prefix}.{i}.layers.{j}.{p}" for i in range(first, 6) for j in range(3)
                 for p in ("weight", "bias")]
    return tuple(keys)


# in a released checkpoint but not read by the JAX converter: the Swin
# relative-position index buffers (recomputed here), HF BERT's position-id
# buffer and pooler, and the copies of the shared box MLP
UNUSED_CHECKPOINT_KEYS = _released_unused_keys()


def merge_permutation(C: int) -> np.ndarray:
    """The official patch merge concatenates [h0w0, h1w0, h0w1, h1w1], this
    package [h0w0, h0w1, h1w0, h1w1]: position j of ours is the official's
    perm[j]."""
    return np.concatenate([np.arange(C), 2 * C + np.arange(C), C + np.arange(C),
                           3 * C + np.arange(C)])


def convert_released_checkpoint(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A released groundingdino_swint_ogc state dict (optionally under
    'module.') -> this module's state dict, with the JAX converter's changes:
    the token-type row 0 folded into the word table, the position table cut
    to MAX_TEXT rows, the patch merges' 4C inputs permuted; the keys of
    UNUSED_CHECKPOINT_KEYS dropped. Anything else unknown or missing is left
    for load_state_dict(strict=True) to refuse."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): torch.as_tensor(v)
          for k, v in sd.items()}
    out = {k: v for k, v in sd.items() if k not in UNUSED_CHECKPOINT_KEYS}
    tt = out.pop("bert.embeddings.token_type_embeddings.weight")
    out["bert.embeddings.word_embeddings.weight"] = \
        out["bert.embeddings.word_embeddings.weight"] + tt[0]
    out["bert.embeddings.position_embeddings.weight"] = \
        out["bert.embeddings.position_embeddings.weight"][:MAX_TEXT]
    for si in range(len(SWIN_DEPTHS) - 1):
        perm = torch.from_numpy(merge_permutation(96 * 2 ** si))
        d = f"backbone.0.layers.{si}.downsample."
        out[d + "reduction.weight"] = out[d + "reduction.weight"][:, perm]
        out[d + "norm.weight"] = out[d + "norm.weight"][perm]
        out[d + "norm.bias"] = out[d + "norm.bias"][perm]
    return out


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A released .pth (the state dict under 'model', or bare) -> this
    module's state dict (convert_released_checkpoint)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return convert_released_checkpoint(obj.get("model", obj))


def init_random_(model: GroundingDINO, seed: int = 0) -> GroundingDINO:
    """Seeded random weights: fan-in uniform layers (init_layers_), the
    level and target embeddings N(0, 1) and the text tables N(0, 0.02)."""
    g = init_layers_(model, seed)
    with torch.no_grad():
        tr = model.transformer
        tr.level_embed.normal_(0.0, 1.0, generator=g)
        tr.tgt_embed.weight.normal_(0.0, 1.0, generator=g)
        e = model.bert.embeddings
        e.word_embeddings.weight.normal_(0.0, 0.02, generator=g)
        e.position_embeddings.weight.normal_(0.0, 0.02, generator=g)
    return model
