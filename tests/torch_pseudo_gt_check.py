"""Helpers of the pseudo-GT parity tests (tests/test_torch_pseudo_gt.py,
tests/test_torch_ground_seg.py): numpy draws into a flax parameter tree,
the JAX modules' jitted apply, and a float64 mode for the JAX modules."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from weakcube_tpu.data.pseudo_gt import grounding_dino as j_gd
from weakcube_tpu.data.pseudo_gt import sam as j_sam
from weakcube_tpu.data.pseudo_gt import swin as j_swin

# standard deviations of the non-kernel leaves (by name); norms' scales are
# U(0.5, 1.5), the gammas U(0.05, 0.2), every other leaf U(-0.1, 0.1)
STD = {"embedding": 0.02, "pos": 0.02, "rel_bias_table": 0.5, "pos_embed": 0.02,
       "rel_pos_h": 0.1, "rel_pos_w": 0.1, "level_embed": 1.0, "tgt_embed": 1.0,
       "pe_gaussian": 1.0, "dense_pe": 1.0, "corner_embed": 0.5, "iou_token": 0.5,
       "mask_tokens": 0.5}


def draw_tree(shapes, seed: int, dtype=np.float32):
    """numpy draws into a tree of jax.ShapeDtypeStruct (eval_shape of a
    flax init): fan-in normal kernels, the rest by STD."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            std = 1 / np.sqrt(np.prod(s.shape[:-1]))
        elif name in STD:
            std = STD[name]
        elif name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(dtype)
        elif name in ("gamma_v", "gamma_l"):
            return rng.uniform(0.05, 0.2, s.shape).astype(dtype)
        else:
            return rng.uniform(-0.1, 0.1, s.shape).astype(dtype)
        return (rng.standard_normal(s.shape, dtype=np.float32) * np.float32(std)).astype(dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jitted(fn, **compiler_options):
    """fn (a flax module's apply, or a function) under jax.jit. The
    backend's optimisation level 0 (xla_backend_optimization_level=0)
    compiles a whole GroundingDINO ~2 s faster and changes no rounding, but
    runs the small float64 blocks slower."""
    return jax.jit(getattr(fn, "apply", fn), compiler_options=compiler_options or None)


class _Jnp64:
    """jax.numpy whose einsum drops preferred_element_type: the JAX modules
    compute their attention logits in float32 whatever their dtype; with it
    dropped a float64 module computes them in float64, as the port does."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(*args, preferred_element_type=None, **kw):
        return jnp.einsum(*args, **kw)


@contextlib.contextmanager
def jax_float64():
    """x64 on, and the pseudo-GT modules' jnp replaced by _Jnp64."""
    with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
        for mod in (j_swin, j_gd, j_sam):
            mp.setattr(mod, "jnp", _Jnp64())
        yield


def released_gdino_shapes(enc_layers: int = 6, dec_layers: int = 6,
                          queries: int = 900) -> dict:
    """{key: shape} of a released groundingdino_swint_ogc state dict (the
    IDEA-Research names, HF bert-base-uncased under bert.) at the given
    depths, the keys the JAX converter ignores included."""
    sd = {}

    def lin(name, dout, din, bias=True):
        sd[name + ".weight"] = (dout, din)
        if bias:
            sd[name + ".bias"] = (dout,)

    def norm(name, d=256):
        sd[name + ".weight"] = sd[name + ".bias"] = (d,)

    def mha(name, d=256):
        sd[name + ".in_proj_weight"] = (3 * d, d)
        sd[name + ".in_proj_bias"] = (3 * d,)
        lin(name + ".out_proj", d, d)

    def deform(name):
        lin(name + ".value_proj", 256, 256)
        lin(name + ".sampling_offsets", 8 * 4 * 4 * 2, 256)
        lin(name + ".attention_weights", 8 * 4 * 4, 256)
        lin(name + ".output_proj", 256, 256)

    def mlp(name, dims, din):
        for i, d in enumerate(dims):
            lin(f"{name}.layers.{i}", d, din)
            din = d

    sd["backbone.0.patch_embed.proj.weight"] = (96, 3, 4, 4)
    sd["backbone.0.patch_embed.proj.bias"] = (96,)
    norm("backbone.0.patch_embed.norm", 96)
    for si, (depth, heads) in enumerate(zip((2, 2, 6, 2), (3, 6, 12, 24))):
        dim = 96 * 2 ** si
        for bi in range(depth):
            b = f"backbone.0.layers.{si}.blocks.{bi}."
            norm(b + "norm1", dim)
            norm(b + "norm2", dim)
            lin(b + "attn.qkv", 3 * dim, dim)
            lin(b + "attn.proj", dim, dim)
            sd[b + "attn.relative_position_bias_table"] = (13 * 13, heads)
            sd[b + "attn.relative_position_index"] = (49, 49)
            lin(b + "mlp.fc1", 4 * dim, dim)
            lin(b + "mlp.fc2", dim, 4 * dim)
        if si < 3:
            lin(f"backbone.0.layers.{si}.downsample.reduction", 2 * dim, 4 * dim, bias=False)
            norm(f"backbone.0.layers.{si}.downsample.norm", 4 * dim)
    for si in (1, 2, 3):
        norm(f"backbone.0.norm{si}", 96 * 2 ** si)

    sd["bert.embeddings.word_embeddings.weight"] = (30522, 768)
    sd["bert.embeddings.token_type_embeddings.weight"] = (2, 768)
    sd["bert.embeddings.position_embeddings.weight"] = (512, 768)
    sd["bert.embeddings.position_ids"] = (1, 512)
    norm("bert.embeddings.LayerNorm", 768)
    for i in range(12):
        b = f"bert.encoder.layer.{i}."
        for n in ("attention.self.query", "attention.self.key", "attention.self.value",
                  "attention.output.dense"):
            lin(b + n, 768, 768)
        norm(b + "attention.output.LayerNorm", 768)
        lin(b + "intermediate.dense", 3072, 768)
        lin(b + "output.dense", 768, 3072)
        norm(b + "output.LayerNorm", 768)
    lin("bert.pooler.dense", 768, 768)

    lin("feat_map", 256, 768)
    for i, cin in enumerate((192, 384, 768, 768)):
        k = 1 if i < 3 else 3
        sd[f"input_proj.{i}.0.weight"] = (256, cin, k, k)
        sd[f"input_proj.{i}.0.bias"] = (256,)
        norm(f"input_proj.{i}.1")
    sd["transformer.level_embed"] = (4, 256)
    for i in range(enc_layers):
        e = f"transformer.encoder.layers.{i}."
        deform(e + "self_attn")
        norm(e + "norm1")
        norm(e + "norm2")
        lin(e + "linear1", 2048, 256)
        lin(e + "linear2", 256, 2048)
        f = f"transformer.encoder.fusion_layers.{i}."
        norm(f + "layer_norm_v")
        norm(f + "layer_norm_l")
        for n in ("v_proj", "l_proj", "values_v_proj", "values_l_proj"):
            lin(f + "attn." + n, 1024, 256)
        lin(f + "attn.out_v_proj", 256, 1024)
        lin(f + "attn.out_l_proj", 256, 1024)
        sd[f + "gamma_v"] = sd[f + "gamma_l"] = (256,)
        t = f"transformer.encoder.text_layers.{i}."
        mha(t + "self_attn")
        norm(t + "norm1")
        norm(t + "norm2")
        lin(t + "linear1", 1024, 256)
        lin(t + "linear2", 256, 1024)
    lin("transformer.enc_output", 256, 256)
    norm("transformer.enc_output_norm")
    mlp("transformer.enc_out_bbox_embed", (256, 256, 4), 256)
    sd["transformer.tgt_embed.weight"] = (queries, 256)
    mlp("transformer.decoder.ref_point_head", (256, 256), 512)
    for i in range(dec_layers):  # one shared MLP, listed under every layer
        mlp(f"transformer.decoder.bbox_embed.{i}", (256, 256, 4), 256)
        mlp(f"bbox_embed.{i}", (256, 256, 4), 256)
    norm("transformer.decoder.norm")
    for i in range(dec_layers):
        d = f"transformer.decoder.layers.{i}."
        mha(d + "self_attn")
        mha(d + "ca_text")
        deform(d + "cross_attn")
        for n in ("norm1", "norm2", "norm3", "catext_norm"):
            norm(d + n)
        lin(d + "linear1", 2048, 256)
        lin(d + "linear2", 256, 2048)
    return sd


def released_sam_shapes(img_size: int, dim: int, depth: int, heads: int, global_idx) -> dict:
    """{key: shape} of a released sam_hq_vit_* state dict at img_size, the
    keys the JAX converter ignores included. The HQ fusion's first stages
    (compress_vit_feat.0, embedding_encoder.0) have the JAX package's 4x4,
    stride-4 shapes, which the port keeps; the released model's are 2x2."""
    E, grid, dh = 256, img_size // 16, dim // heads
    sd = {"image_encoder.patch_embed.proj.weight": (dim, 3, 16, 16),
          "image_encoder.patch_embed.proj.bias": (dim,),
          "image_encoder.pos_embed": (1, grid, grid, dim)}
    for i in range(depth):
        p = f"image_encoder.blocks.{i}."
        size = grid if i in global_idx else 14
        for n in ("norm1", "norm2"):
            sd[p + n + ".weight"] = sd[p + n + ".bias"] = (dim,)
        sd[p + "attn.qkv.weight"], sd[p + "attn.qkv.bias"] = (3 * dim, dim), (3 * dim,)
        sd[p + "attn.proj.weight"], sd[p + "attn.proj.bias"] = (dim, dim), (dim,)
        sd[p + "attn.rel_pos_h"] = sd[p + "attn.rel_pos_w"] = (2 * size - 1, dh)
        sd[p + "mlp.lin1.weight"], sd[p + "mlp.lin1.bias"] = (4 * dim, dim), (4 * dim,)
        sd[p + "mlp.lin2.weight"], sd[p + "mlp.lin2.bias"] = (dim, 4 * dim), (dim,)
    sd["image_encoder.neck.0.weight"] = (E, dim, 1, 1)
    sd["image_encoder.neck.2.weight"] = (E, E, 3, 3)
    for n in ("1", "3"):
        sd[f"image_encoder.neck.{n}.weight"] = sd[f"image_encoder.neck.{n}.bias"] = (E,)
    pe = "prompt_encoder."
    sd[pe + "pe_layer.positional_encoding_gaussian_matrix"] = (2, E // 2)
    for i in range(4):
        sd[f"{pe}point_embeddings.{i}.weight"] = (1, E)
    sd[pe + "not_a_point_embed.weight"] = sd[pe + "no_mask_embed.weight"] = (1, E)
    for i, shape in ((0, (4, 1, 2, 2)), (1, (4,)), (3, (16, 4, 2, 2)), (4, (16,)),
                     (6, (E, 16, 1, 1))):
        sd[f"{pe}mask_downscaling.{i}.weight"] = shape
        sd[f"{pe}mask_downscaling.{i}.bias"] = (shape[0],)
    md = "mask_decoder."
    sd[md + "iou_token.weight"] = (1, E)
    sd[md + "mask_tokens.weight"] = (4, E)
    sd[md + "hf_token.weight"] = (1, E)
    for bi in range(2):
        tp = f"{md}transformer.layers.{bi}."
        for an, d in (("self_attn.", E), ("cross_attn_token_to_image.", E // 2),
                      ("cross_attn_image_to_token.", E // 2)):
            for n in ("q_proj", "k_proj", "v_proj"):
                sd[tp + an + n + ".weight"], sd[tp + an + n + ".bias"] = (d, E), (d,)
            sd[tp + an + "out_proj.weight"], sd[tp + an + "out_proj.bias"] = (E, d), (E,)
        for ni in range(1, 5):
            sd[tp + f"norm{ni}.weight"] = sd[tp + f"norm{ni}.bias"] = (E,)
        sd[tp + "mlp.lin1.weight"], sd[tp + "mlp.lin1.bias"] = (2048, E), (2048,)
        sd[tp + "mlp.lin2.weight"], sd[tp + "mlp.lin2.bias"] = (E, 2048), (E,)
    fa = md + "transformer.final_attn_token_to_image."
    for n in ("q_proj", "k_proj", "v_proj"):
        sd[fa + n + ".weight"], sd[fa + n + ".bias"] = (E // 2, E), (E // 2,)
    sd[fa + "out_proj.weight"], sd[fa + "out_proj.bias"] = (E, E // 2), (E,)
    sd[md + "transformer.norm_final_attn.weight"] = (E,)
    sd[md + "transformer.norm_final_attn.bias"] = (E,)
    sd[md + "output_upscaling.0.weight"], sd[md + "output_upscaling.0.bias"] = \
        (E, E // 4, 2, 2), (E // 4,)
    sd[md + "output_upscaling.1.weight"] = sd[md + "output_upscaling.1.bias"] = (E // 4,)
    sd[md + "output_upscaling.3.weight"], sd[md + "output_upscaling.3.bias"] = \
        (E // 4, E // 8, 2, 2), (E // 8,)
    for name in ("iou_prediction_head", "hf_mlp", *(f"output_hypernetworks_mlps.{m}"
                                                     for m in range(4))):
        last = 4 if name == "iou_prediction_head" else E // 8
        for li, (o, i) in enumerate(((E, E), (E, E), (last, E))):
            sd[f"{md}{name}.layers.{li}.weight"], sd[f"{md}{name}.layers.{li}.bias"] = (o, i), (o,)
    sd[md + "compress_vit_feat.0.weight"] = (dim, E // 8, 4, 4)
    sd[md + "embedding_encoder.0.weight"] = (E, E // 8, 4, 4)
    sd[md + "compress_vit_feat.0.bias"] = sd[md + "embedding_encoder.0.bias"] = (E // 8,)
    # the released fusion's later stages and mask-feature branch
    for branch, c in (("compress_vit_feat", E), ("embedding_encoder", E // 4)):
        sd[f"{md}{branch}.1.weight"] = sd[f"{md}{branch}.1.bias"] = (c,)
        sd[f"{md}{branch}.3.weight"], sd[f"{md}{branch}.3.bias"] = (c, E // 8, 2, 2), (E // 8,)
    sd[md + "embedding_maskfeature.0.weight"] = (E // 4, E // 8, 3, 3)
    sd[md + "embedding_maskfeature.0.bias"] = (E // 4,)
    sd[md + "embedding_maskfeature.1.weight"] = sd[md + "embedding_maskfeature.1.bias"] = (E // 4,)
    sd[md + "embedding_maskfeature.3.weight"] = (E // 8, E // 4, 3, 3)
    sd[md + "embedding_maskfeature.3.bias"] = (E // 8,)
    return sd


def fill(shapes: dict, seed=None) -> dict:
    """numpy arrays of the given shapes: uninitialised (seed None: for a
    load of names and shapes alone) or random (1-D: norms' weights
    U(0.5, 1.5), gammas U(0.05, 0.2), the rest U(-0.1, 0.1); matrices and
    kernels at a fan-in deviation; the text tables at 0.02, tokens, position
    tables and bias tables at 0.3; the level and target embeddings and the
    Gaussian matrix at 1; all uniform)."""
    if seed is None:
        return {k: np.empty(s, np.float32) for k, s in shapes.items()}
    rng = np.random.default_rng(seed)

    def normal(s, std):  # uniform of that deviation: a quarter of the draw's time
        return (rng.random(s, dtype=np.float32) - np.float32(0.5)) * np.float32(std * 12 ** 0.5)
    out = {}
    for k, s in shapes.items():
        if k.endswith("position_ids") or k.endswith("relative_position_index"):
            out[k] = np.zeros(s, np.int64)
            continue
        if len(s) == 1:
            normish = any(n in k for n in ("norm", "LayerNorm", "input_proj", "upscaling.1"))
            if "gamma" in k:
                a = rng.uniform(0.05, 0.2, s)
            elif normish and k.endswith("weight"):
                a = rng.uniform(0.5, 1.5, s)
            else:
                a = rng.uniform(-0.1, 0.1, s)
        elif any(n in k for n in ("level_embed", "tgt_embed", "gaussian_matrix")):
            a = normal(s, 1.0)
        elif any(n in k for n in ("embeddings.", "pos_embed", "rel_pos", "bias_table", "token")):
            a = normal(s, 0.02 if "embeddings." in k else 0.3)
        else:
            fan_in = np.prod(s[1:]) if "upscaling" not in k and "compress" not in k and \
                "embedding_encoder" not in k else s[0]
            a = normal(s, 1 / np.sqrt(fan_in))
        out[k] = np.asarray(a, np.float32)
    return out
