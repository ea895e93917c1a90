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

`dav2_flax_to_torch(params, variant)` does the same for the Depth Anything
V2 pseudo-GT model (below).
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
