"""JAX (flax) model variables -> this package's `state_dict`.

`flax_to_torch(params, batch_stats)` takes the flax RCNN3D variables as
nested dicts of numpy arrays (the JAX package's param tree; nothing of JAX
is imported) and returns a state dict for models/rcnn3d.py:

  * conv kernels (kh, kw, in, out) -> weights (out, in, kh, kw);
  * Dense kernels (in, out) -> Linear weights (out, in);
  * BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
    running_var.

Names become the reference's detectron2 names, which this package's
modules carry: bottom_up/* -> backbone.bottom_up.* (base_conv ->
base_layer.0, levelN_bn -> levelN.1, project_conv -> project.0, ...),
backbone/fpn/lateral_pK -> backbone.fpn_lateralK, rpn_head/objectness ->
proposal_generator.rpn_head.objectness_logits, cube_head/shared_fcN ->
cube_head.feature_generator.fcN. It is the inverse of
weakcube_tpu/utils/zoo_convert.py, extended to every DLA block type and to
unshared cube-head branches.

`flax_params_to_torch(tree)` maps any tree shaped like the flax params (a
gradient, an update, a per-parameter label code) onto the port's parameter
names the same way, without the BatchNorm running statistics.

`dav2_flax_to_torch(params, variant)`, `gdino_flax_to_torch(params)` and
`sam_flax_to_torch(params, variant)` do the same for the pseudo-GT models
(below): Depth Anything V2, GroundingDINO and SAM-HQ. flax's ConvTranspose
kernel (kh, kw, in, out), applied without a spatial flip, becomes torch's
(in, out, kh, kw) flipped in H and W.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping

import numpy as np
import torch

_RPN = {"conv": "conv", "objectness": "objectness_logits", "deltas": "anchor_deltas"}
_CUBE_BRANCH = {"shared": "feature_generator", "xy": "feature_generator_XY",
                "dims": "feature_generator_dims", "pose": "feature_generator_pose",
                "z": "feature_generator_Z", "conf": "feature_generator_conf"}


def _torch_name(path: List[str]) -> str:
    """flax layer path (no leaf) -> torch module name."""
    head, rest = path[0], path[1:]
    if head == "bottom_up":
        out = ["backbone", "bottom_up"]
        for p in rest:
            m = re.fullmatch(r"(base|level\d+|project)_(conv|bn)", p)
            if m:
                out += ["base_layer" if m[1] == "base" else m[1],
                        "0" if m[2] == "conv" else "1"]
            else:
                out.append(p)
        return ".".join(out)
    if head == "backbone" and rest[0] == "fpn":
        kind, lvl = re.fullmatch(r"(lateral|output)_p(\d+)", rest[1]).groups()
        return f"backbone.fpn_{kind}{lvl}"
    if head == "rpn_head":
        return "proposal_generator.rpn_head." + _RPN[rest[0]]
    if head == "roi_heads":
        if rest[0] == "cube_head":
            m = re.fullmatch(r"(shared|xy|dims|pose|z|conf)_fc(\d+)", rest[1])
            if m:
                return f"roi_heads.cube_head.{_CUBE_BRANCH[m[1]]}.fc{m[2]}"
        return ".".join(["roi_heads"] + rest)
    raise KeyError(f"no torch counterpart for flax path {'/'.join(path)}")


def _layers(tree: Mapping, path: List[str]):
    """Yield (path, leaf dict) for every layer (a dict of arrays)."""
    if any(not isinstance(v, Mapping) for v in tree.values()):
        yield path, tree
        return
    for k, v in tree.items():
        yield from _layers(v, path + [k])


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def flax_to_torch(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    stats = {tuple(p): leaf for p, leaf in _layers(batch_stats, [])}
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _layers(params, []):
        name = _torch_name(path)
        if "kernel" in leaf:
            k = np.asarray(leaf["kernel"])
            sd[name + ".weight"] = _t(k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T)
            if "bias" in leaf:
                sd[name + ".bias"] = _t(leaf["bias"])
        elif "scale" in leaf:
            s = stats[tuple(path)]
            sd[name + ".weight"] = _t(leaf["scale"])
            sd[name + ".bias"] = _t(leaf["bias"])
            sd[name + ".running_mean"] = _t(s["mean"])
            sd[name + ".running_var"] = _t(s["var"])
            sd[name + ".num_batches_tracked"] = torch.tensor(0)
        else:
            raise KeyError(f"unknown flax layer at {'/'.join(path)}: {sorted(leaf)}")
    return sd


def flax_params_to_torch(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A tree shaped like the flax params -> {parameter name: tensor}, laid
    out like the port's parameters (conv and dense kernels transposed)."""
    stats = {}
    for path, leaf in _layers(tree, []):
        if "scale" in leaf:
            node = stats
            for k in path[:-1]:
                node = node.setdefault(k, {})
            z = np.zeros(np.shape(leaf["scale"]), np.float32)
            node[path[-1]] = {"mean": z, "var": z}
    sd = flax_to_torch(tree, stats)
    return {k: v for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def _dav2_conv(sd: Dict[str, torch.Tensor], name: str, leaf: Mapping) -> None:
    """flax Conv (kh, kw, in, out) -> torch Conv2d (out, in, kh, kw)."""
    sd[name + ".weight"] = _t(np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in leaf:
        sd[name + ".bias"] = _t(leaf["bias"])


def dav2_flax_to_torch(params: Mapping, variant: str = "vitl") -> Dict[str, torch.Tensor]:
    """The JAX package's DepthAnythingV2 parameter tree (nested dicts of
    numpy arrays, as its .npz checkpoints hold them) -> the state dict of
    data/pseudo_gt/depth_anything_v2.py::DepthAnythingV2, whose names are
    the released checkpoint's. The inverse of weakcube_tpu's
    `convert_torch_checkpoint`. refinenet4's resConfUnit1, which the model
    never computes with and the flax tree does not hold, comes out as
    zeros."""
    from ..data.pseudo_gt.depth_anything_v2 import VIT_SPECS
    _, depth, _, features, _ = VIT_SPECS[variant]
    bb, hd = params["backbone"], params["head"]
    sd: Dict[str, torch.Tensor] = {}
    _dav2_conv(sd, "pretrained.patch_embed.proj", bb["patch_embed"])
    sd["pretrained.cls_token"] = _t(bb["cls_token"])
    sd["pretrained.pos_embed"] = _t(bb["pos_embed"])

    def dense(name, leaf):
        sd[name + ".weight"] = _t(np.asarray(leaf["kernel"]).T)
        sd[name + ".bias"] = _t(leaf["bias"])

    def norm(name, leaf):
        sd[name + ".weight"] = _t(leaf["scale"])
        sd[name + ".bias"] = _t(leaf["bias"])

    for i in range(depth):
        blk, pre = bb[f"block{i}"], f"pretrained.blocks.{i}."
        norm(pre + "norm1", blk["norm1"])
        dense(pre + "attn.qkv", blk["attn"]["qkv"])
        dense(pre + "attn.proj", blk["attn"]["proj"])
        sd[pre + "ls1.gamma"] = _t(blk["ls1_gamma"])
        norm(pre + "norm2", blk["norm2"])
        dense(pre + "mlp.fc1", blk["mlp_fc1"])
        dense(pre + "mlp.fc2", blk["mlp_fc2"])
        sd[pre + "ls2.gamma"] = _t(blk["ls2_gamma"])
    norm("pretrained.norm", bb["norm"])

    for i in range(4):
        _dav2_conv(sd, f"depth_head.projects.{i}", hd[f"project{i}"])
        _dav2_conv(sd, f"depth_head.scratch.layer{i + 1}_rn", hd[f"scratch{i}"])
    for i in (0, 1):  # ConvTranspose2d (in, out, kh, kw) from (kh, kw, in, out)
        sd[f"depth_head.resize_layers.{i}.weight"] = _t(
            np.asarray(hd[f"resize{i}"]["kernel"]).transpose(2, 3, 0, 1))
        sd[f"depth_head.resize_layers.{i}.bias"] = _t(hd[f"resize{i}"]["bias"])
    _dav2_conv(sd, "depth_head.resize_layers.3", hd["resize3"])
    for i in range(4):
        rn = f"depth_head.scratch.refinenet{i + 1}."
        for unit, key in (("resConfUnit1", f"rcu_skip{i}"), ("resConfUnit2", f"rcu_out{i}")):
            for c in ("conv1", "conv2"):
                if key in hd:
                    _dav2_conv(sd, rn + f"{unit}.{c}", hd[key][c])
                else:
                    sd[rn + f"{unit}.{c}.weight"] = torch.zeros(features, features, 3, 3)
                    sd[rn + f"{unit}.{c}.bias"] = torch.zeros(features)
        _dav2_conv(sd, rn + "out_conv", hd[f"fusion_out{i}"])
    _dav2_conv(sd, "depth_head.scratch.output_conv1", hd["out_conv1"])
    _dav2_conv(sd, "depth_head.scratch.output_conv2.0", hd["out_conv2"])
    _dav2_conv(sd, "depth_head.scratch.output_conv2.2", hd["out_conv3"])
    return sd


def _dense(sd: Dict[str, torch.Tensor], name: str, leaf: Mapping) -> None:
    """flax Dense (in, out) -> torch Linear (out, in)."""
    sd[name + ".weight"] = _t(np.asarray(leaf["kernel"]).T)
    if "bias" in leaf:
        sd[name + ".bias"] = _t(leaf["bias"])


def _norm(sd: Dict[str, torch.Tensor], name: str, leaf: Mapping) -> None:
    sd[name + ".weight"] = _t(leaf["scale"])
    sd[name + ".bias"] = _t(leaf["bias"])


def _conv_transpose(sd: Dict[str, torch.Tensor], name: str, leaf: Mapping) -> None:
    """flax ConvTranspose (kh, kw, in, out), not flipped -> torch
    ConvTranspose2d (in, out, kh, kw), flipped in H and W."""
    k = np.asarray(leaf["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    sd[name + ".weight"] = _t(k)
    sd[name + ".bias"] = _t(leaf["bias"])


def _mha(sd: Dict[str, torch.Tensor], name: str, leaves: Mapping, prefix: str = "",
         out: str = "out") -> None:
    """The JAX package's separate q, k, v and output Denses -> nn.MultiheadAttention's
    in_proj_weight / in_proj_bias / out_proj."""
    q, k, v = (leaves[prefix + x] for x in ("q", "k", "v"))
    sd[name + ".in_proj_weight"] = _t(np.concatenate(
        [np.asarray(x["kernel"]).T for x in (q, k, v)]))
    sd[name + ".in_proj_bias"] = _t(np.concatenate([np.asarray(x["bias"]) for x in (q, k, v)]))
    _dense(sd, name + ".out_proj", leaves[prefix + out])


def _mlp(sd: Dict[str, torch.Tensor], name: str, leaf: Mapping) -> None:
    for i in range(len(leaf)):
        _dense(sd, f"{name}.layers.{i}", leaf[f"l{i}"])


def _deform(sd: Dict[str, torch.Tensor], name: str, leaf: Mapping) -> None:
    for ours, theirs in (("value_proj", "value_proj"), ("sampling_offsets", "offsets"),
                         ("attention_weights", "attn_weights"), ("output_proj", "out_proj")):
        _dense(sd, f"{name}.{ours}", leaf[theirs])


def swin_flax_to_torch(p: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The JAX SwinT tree -> data/pseudo_gt/swin.py::SwinT's state dict
    (under `prefix`). Both concatenate the patch merge in one order."""
    sd: Dict[str, torch.Tensor] = {}
    _dav2_conv(sd, prefix + "patch_embed.proj", p["patch_embed"])
    _norm(sd, prefix + "patch_embed.norm", p["patch_norm"])
    blocks = sorted(k for k in p if re.fullmatch(r"stage\d+_block\d+", k))
    for key in blocks:
        si, bi = map(int, re.fullmatch(r"stage(\d+)_block(\d+)", key).groups())
        b, blk = f"{prefix}layers.{si}.blocks.{bi}.", p[key]
        _norm(sd, b + "norm1", blk["norm1"])
        _dense(sd, b + "attn.qkv", blk["attn"]["qkv"])
        _dense(sd, b + "attn.proj", blk["attn"]["proj"])
        sd[b + "attn.relative_position_bias_table"] = _t(blk["attn"]["rel_bias_table"])
        _norm(sd, b + "norm2", blk["norm2"])
        _dense(sd, b + "mlp.fc1", blk["mlp_fc1"])
        _dense(sd, b + "mlp.fc2", blk["mlp_fc2"])
    for key in p:
        m = re.fullmatch(r"(merge_norm|merge_reduce|out_norm)(\d+)", key)
        if m and m[1] == "merge_norm":
            _norm(sd, f"{prefix}layers.{m[2]}.downsample.norm", p[key])
        elif m and m[1] == "merge_reduce":
            _dense(sd, f"{prefix}layers.{m[2]}.downsample.reduction", p[key])
        elif m:
            _norm(sd, f"{prefix}norm{m[2]}", p[key])
    return sd


def bert_layer_flax_to_torch(sd: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    """The JAX BertLayer (q, k, v, attn_out, ln1, ffn1, ffn2, ln2) -> HF names."""
    for ours, theirs in (("attention.self.query", "q"), ("attention.self.key", "k"),
                         ("attention.self.value", "v"), ("attention.output.dense", "attn_out"),
                         ("intermediate.dense", "ffn1"), ("output.dense", "ffn2")):
        _dense(sd, f"{name}.{ours}", p[theirs])
    _norm(sd, f"{name}.attention.output.LayerNorm", p["ln1"])
    _norm(sd, f"{name}.output.LayerNorm", p["ln2"])


def bert_flax_to_torch(p: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    sd[prefix + "embeddings.word_embeddings.weight"] = _t(p["tok"]["embedding"])
    sd[prefix + "embeddings.position_embeddings.weight"] = _t(np.asarray(p["pos"])[0])
    _norm(sd, prefix + "embeddings.LayerNorm", p["emb_ln"])
    for key in p:
        m = re.fullmatch(r"layer(\d+)", key)
        if m:
            bert_layer_flax_to_torch(sd, f"{prefix}encoder.layer.{m[1]}", p[key])
    return sd


def fusion_flax_to_torch(sd: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    _norm(sd, name + ".layer_norm_v", p["ln_v"])
    _norm(sd, name + ".layer_norm_l", p["ln_l"])
    for proj in ("v_proj", "l_proj", "values_v_proj", "values_l_proj", "out_v_proj",
                 "out_l_proj"):
        _dense(sd, f"{name}.attn.{proj}", p[proj])
    sd[name + ".gamma_v"] = _t(p["gamma_v"])
    sd[name + ".gamma_l"] = _t(p["gamma_l"])


def text_layer_flax_to_torch(sd: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    """The enhancer's text BertLayer -> TextEnhancerLayer (released names)."""
    _mha(sd, name + ".self_attn", p, out="attn_out")
    _norm(sd, name + ".norm1", p["ln1"])
    _dense(sd, name + ".linear1", p["ffn1"])
    _dense(sd, name + ".linear2", p["ffn2"])
    _norm(sd, name + ".norm2", p["ln2"])


def image_layer_flax_to_torch(sd: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    """The enhancer's deformable part -> DeformableEncoderLayer."""
    _deform(sd, name + ".self_attn", p["deform"])
    _norm(sd, name + ".norm1", p["ln1"])
    _dense(sd, name + ".linear1", p["ffn1"])
    _dense(sd, name + ".linear2", p["ffn2"])
    _norm(sd, name + ".norm2", p["ln2"])


def decoder_layer_flax_to_torch(sd: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    _mha(sd, name + ".self_attn", p, "self_")
    _mha(sd, name + ".ca_text", p, "txt_cross_")
    _deform(sd, name + ".cross_attn", p["deform"])
    for ours, theirs in (("norm2", "ln_sa"), ("catext_norm", "ln_txt"), ("norm1", "ln_img"),
                         ("norm3", "ln_ffn")):
        _norm(sd, f"{name}.{ours}", p[theirs])
    _dense(sd, name + ".linear1", p["ffn1"])
    _dense(sd, name + ".linear2", p["ffn2"])


def gdino_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's GroundingDINO parameter tree (nested dicts of numpy
    arrays) -> the state dict of data/pseudo_gt/grounding_dino.py::
    GroundingDINO, whose names are the released checkpoint's. Its
    enhancer{i} splits into transformer.encoder.fusion_layers / text_layers /
    layers.{i}."""
    sd = swin_flax_to_torch(params["backbone"], "backbone.0.")
    sd.update(bert_flax_to_torch(params["bert"], "bert."))
    _dense(sd, "feat_map", params["text_proj"])
    for i in range(4):
        _dav2_conv(sd, f"input_proj.{i}.0", params[f"input_proj{i}"])
        _norm(sd, f"input_proj.{i}.1", params[f"input_gn{i}"])
    tr = "transformer."
    sd[tr + "level_embed"] = _t(params["level_embed"])
    for key in params:
        m = re.fullmatch(r"(enhancer|decoder)(\d+)", key)
        if m and m[1] == "enhancer":
            e, i = params[key], m[2]
            fusion_flax_to_torch(sd, f"{tr}encoder.fusion_layers.{i}", e["fusion"])
            text_layer_flax_to_torch(sd, f"{tr}encoder.text_layers.{i}", e["txt_layer"])
            image_layer_flax_to_torch(sd, f"{tr}encoder.layers.{i}", e)
        elif m:
            decoder_layer_flax_to_torch(sd, f"{tr}decoder.layers.{m[2]}", params[key])
    _dense(sd, tr + "enc_output", params["enc_output"])
    _norm(sd, tr + "enc_output_norm", params["enc_output_norm"])
    _mlp(sd, tr + "enc_out_bbox_embed", params["enc_out_bbox_embed"])
    sd[tr + "tgt_embed.weight"] = _t(params["tgt_embed"])
    _mlp(sd, tr + "decoder.ref_point_head", params["ref_point_head"])
    _mlp(sd, tr + "decoder.bbox_embed.0", params["bbox_embed"])
    _norm(sd, tr + "decoder.norm", params["decoder_norm"])
    return sd


def sam_flax_to_torch(params: Mapping, variant: str = "vit_l") -> Dict[str, torch.Tensor]:
    """The JAX package's Sam (hq) parameter tree -> the state dict of
    data/pseudo_gt/sam.py::Sam, whose names are the released sam_hq
    checkpoint's. The released model reads one Gaussian matrix for the
    prompt and the dense positional encodings; the flax tree holds two
    (prompt_encoder/pe_gaussian and dense_pe), which must be equal."""
    from ..data.pseudo_gt.sam import SAM_SPECS
    depth = SAM_SPECS[variant][1]
    pe, dense = np.asarray(params["prompt_encoder"]["pe_gaussian"]), np.asarray(params["dense_pe"])
    if not np.array_equal(pe, dense):
        raise ValueError("the flax tree's dense_pe differs from prompt_encoder/pe_gaussian; "
                         "the released SAM (and this port) hold one Gaussian matrix")
    enc, dec = params["image_encoder"], params["mask_decoder"]
    sd: Dict[str, torch.Tensor] = {}
    ie = "image_encoder."
    _dav2_conv(sd, ie + "patch_embed.proj", enc["patch_embed"])
    sd[ie + "pos_embed"] = _t(enc["pos_embed"])
    for i in range(depth):
        sam_block_flax_to_torch(sd, f"{ie}blocks.{i}", enc[f"block{i}"])
    _dav2_conv(sd, ie + "neck.0", enc["neck_conv1"])
    _norm(sd, ie + "neck.1", enc["neck_ln1"])
    _dav2_conv(sd, ie + "neck.2", enc["neck_conv2"])
    _norm(sd, ie + "neck.3", enc["neck_ln2"])

    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = _t(pe)
    corner = np.asarray(params["prompt_encoder"]["corner_embed"])
    sd["prompt_encoder.point_embeddings.2.weight"] = _t(corner[:1])
    sd["prompt_encoder.point_embeddings.3.weight"] = _t(corner[1:])

    sam_mask_decoder_flax_to_torch(sd, "mask_decoder", dec)
    return sd


def sam_block_flax_to_torch(sd: Dict[str, torch.Tensor], name: str, blk: Mapping) -> None:
    """The JAX ViTDetBlock -> sam.py::ViTDetBlock (released names)."""
    b = name + "."
    _norm(sd, b + "norm1", blk["norm1"])
    _dense(sd, b + "attn.qkv", blk["attn"]["qkv"])
    _dense(sd, b + "attn.proj", blk["attn"]["proj"])
    sd[b + "attn.rel_pos_h"] = _t(blk["attn"]["rel_pos_h"])
    sd[b + "attn.rel_pos_w"] = _t(blk["attn"]["rel_pos_w"])
    _norm(sd, b + "norm2", blk["norm2"])
    _dense(sd, b + "mlp.lin1", blk["mlp_fc1"])
    _dense(sd, b + "mlp.lin2", blk["mlp_fc2"])


def sam_mask_decoder_flax_to_torch(sd: Dict[str, torch.Tensor], name: str, dec: Mapping) -> None:
    """The JAX MaskDecoder (hq) -> sam.py::MaskDecoder (released names)."""
    md = name + "."
    tokens = np.asarray(dec["mask_tokens"])  # the SAM mask tokens, then the HQ token
    sd[md + "iou_token.weight"] = _t(dec["iou_token"])
    sd[md + "mask_tokens.weight"] = _t(tokens[:-1])
    sd[md + "hf_token.weight"] = _t(tokens[-1:])

    def attn(name, leaf):
        for ours, theirs in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                             ("out_proj", "out")):
            _dense(sd, f"{name}.{ours}", leaf[theirs])
    tr = md + "transformer."
    for bi in range(2):
        b, blk = f"{tr}layers.{bi}.", dec[f"block{bi}"]
        attn(b + "self_attn", blk["self_attn"])
        attn(b + "cross_attn_token_to_image", blk["cross_t2i"])
        attn(b + "cross_attn_image_to_token", blk["cross_i2t"])
        for n in range(1, 5):
            _norm(sd, f"{b}norm{n}", blk[f"norm{n}"])
        _dense(sd, b + "mlp.lin1", blk["mlp_fc1"])
        _dense(sd, b + "mlp.lin2", blk["mlp_fc2"])
    attn(tr + "final_attn_token_to_image", dec["final_attn"])
    _norm(sd, tr + "norm_final_attn", dec["final_norm"])
    _conv_transpose(sd, md + "output_upscaling.0", dec["upscale1"])
    _norm(sd, md + "output_upscaling.1", dec["upscale_ln"])
    _conv_transpose(sd, md + "output_upscaling.3", dec["upscale2"])
    for i in range(3):
        _dense(sd, f"{md}hf_mlp.layers.{i}", dec[f"hyper_hq_fc{i + 1}"])
    _conv_transpose(sd, md + "compress_vit_feat.0", dec["hq_compress_early"])
    _conv_transpose(sd, md + "embedding_encoder.0", dec["hq_compress_final"])
