"""Backbone registry and build function, keyed by the reference's registry names so
configs carry over (cfg.MODEL.BACKBONE.NAME)."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from .dla import DLABottomUp
from .fpn import FPN
from .resnet import ResNetBottomUp
from .small_nets import DenseNetBottomUp, MNASNetBottomUp, ShuffleNetV2BottomUp

BACKBONE_REGISTRY: Dict[str, Callable] = {}


def register_backbone(name: str):
    def deco(fn):
        BACKBONE_REGISTRY[name] = fn
        return fn
    return deco


def _fpn(cfg, bottom_up, in_channels, dtype) -> FPN:
    return FPN(bottom_up, in_channels, tuple(cfg.MODEL.FPN.IN_FEATURES),
               cfg.MODEL.FPN.OUT_CHANNELS, cfg.MODEL.FPN.FUSE_TYPE, dtype)


@register_backbone("build_dla_from_vision_fpn_backbone")
def _build_dla(cfg, dtype) -> FPN:
    dla_type = cfg.MODEL.DLA.TYPE
    return _fpn(cfg, DLABottomUp(dla_type), DLABottomUp.out_channels(dla_type), dtype)


@register_backbone("build_resnet_from_vision_fpn_backbone")
def _build_resnet(cfg, dtype) -> FPN:
    depth = cfg.MODEL.RESNETS.DEPTH
    return _fpn(cfg, ResNetBottomUp(depth), ResNetBottomUp.out_channels(depth), dtype)


@register_backbone("build_shufflenet_fpn_backbone")
def _build_shufflenet(cfg, dtype) -> FPN:
    return _fpn(cfg, ShuffleNetV2BottomUp(), ShuffleNetV2BottomUp.out_channels(), dtype)


@register_backbone("build_mnasnet_fpn_backbone")
def _build_mnasnet(cfg, dtype) -> FPN:
    return _fpn(cfg, MNASNetBottomUp(), MNASNetBottomUp.out_channels(), dtype)


@register_backbone("build_densenet_fpn_backbone")
def _build_densenet(cfg, dtype) -> FPN:
    return _fpn(cfg, DenseNetBottomUp(), DenseNetBottomUp.out_channels(), dtype)


_TRUNKS = {"build_shufflenet_fpn_backbone": "shufflenet_v2_x1.0",
           "build_mnasnet_fpn_backbone": "mnasnet1.0",
           "build_densenet_fpn_backbone": "densenet121"}


def trunk_name(cfg) -> str:
    """The bottom-up trunk cfg builds: dla34, resnet18, densenet121, ..."""
    name = cfg.MODEL.BACKBONE.NAME
    if name == "build_dla_from_vision_fpn_backbone":
        return cfg.MODEL.DLA.TYPE
    if name == "build_resnet_from_vision_fpn_backbone":
        return f"resnet{cfg.MODEL.RESNETS.DEPTH}"
    return _TRUNKS.get(name, name)


def build_backbone(cfg, dtype: torch.dtype = torch.float32) -> FPN:
    name = cfg.MODEL.BACKBONE.NAME
    if name not in BACKBONE_REGISTRY:
        raise KeyError(f"Unknown backbone {name}; known: {sorted(BACKBONE_REGISTRY)}")
    return BACKBONE_REGISTRY[name](cfg, dtype)
