"""The light backbone sweep: ShuffleNetV2-x1.0, MNASNet-1.0 and DenseNet-121
(weakcube_tpu/models/backbone/small_nets.py), op for op.

Each trunk emits the raw pyramid {p2 ... p6}, p6 a stride-2 subsample of
p5. Modules carry the flax layer names (stage2_0.branch1_dw,
mb3_1.project_bn, dense2_5.conv1, trans1_conv): no released checkpoint
exists for these trunks in the JAX package either. Depthwise convs are
Conv2d with groups = channels (flax's feature_group_count). Inside, tensors
are NCHW in channels_last memory.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import pool as pool_ops
from ..layers import BatchNorm2d, Conv2d


def _p6(p5: torch.Tensor) -> torch.Tensor:
    return pool_ops.subsample2(p5.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _conv_bn(module: nn.Module, name: str, cin: int, cout: int, k: int = 1, stride: int = 1,
             groups: int = 1) -> None:
    """Add conv `name` (padding k // 2, no bias) and its BatchNorm
    `name`_bn to module."""
    module.add_module(name, Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=False))
    module.add_module(name + "_bn", BatchNorm2d(cout))


def _apply(module: nn.Module, name: str, x: torch.Tensor, relu: bool) -> torch.Tensor:
    y = getattr(module, name + "_bn")(getattr(module, name)(x))
    return torch.relu(y) if relu else y


# ---------------------------------------------------------------------------
# ShuffleNet V2
# ---------------------------------------------------------------------------

def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """NHWC's reshape (C -> groups x C/groups) and swap, on NCHW: output
    channel j * groups + i is input channel i * (C / groups) + j."""
    B, C, H, W = x.shape
    return x.reshape(B, groups, C // groups, H, W).transpose(1, 2).reshape(B, C, H, W)


class ShuffleUnit(nn.Module):
    def __init__(self, cin: int, out_ch: int, stride: int = 1):
        super().__init__()
        half = out_ch // 2
        self.stride = stride
        if stride != 1:  # the downsampling unit transforms both paths
            _conv_bn(self, "branch1_dw", cin, cin, 3, 2, groups=cin)
            _conv_bn(self, "branch1_pw", cin, half)
            c2 = cin
        else:
            c2 = cin // 2
        _conv_bn(self, "pw1", c2, half)
        _conv_bn(self, "dw", half, half, 3, stride, groups=half)
        _conv_bn(self, "pw2", half, half)

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
        else:
            x1 = _apply(self, "branch1_pw", _apply(self, "branch1_dw", x, False), True)
            x2 = x
        y = _apply(self, "pw1", x2, True)
        y = _apply(self, "dw", y, False)
        y = _apply(self, "pw2", y, True)
        return channel_shuffle(torch.cat([x1, y], dim=1))


class ShuffleNetV2BottomUp(nn.Module):
    """x1.0: stages (4, 8, 4) of (116, 232, 464) channels, then 1024."""

    REPS, WIDTHS = (4, 8, 4), (116, 232, 464)

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 24, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(24)
        cin = 24
        for si, (reps, ch) in enumerate(zip(self.REPS, self.WIDTHS)):
            for r in range(reps):
                self.add_module(f"stage{si + 2}_{r}", ShuffleUnit(cin, ch, 2 if r == 0 else 1))
                cin = ch
        _conv_bn(self, "conv5", cin, 1024)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, 2, 1)
        outs = {"p2": y}
        for si, reps in enumerate(self.REPS):
            for r in range(reps):
                y = getattr(self, f"stage{si + 2}_{r}")(y)
            outs[f"p{si + 3}"] = y
        y = _apply(self, "conv5", y, True)
        outs["p5"] = y
        outs["p6"] = _p6(y)
        return outs

    @staticmethod
    def out_channels() -> Dict[str, int]:
        return {"p2": 24, "p3": 116, "p4": 232, "p5": 1024, "p6": 1024}


# ---------------------------------------------------------------------------
# MNASNet 1.0
# ---------------------------------------------------------------------------

class InvertedResidual(nn.Module):
    def __init__(self, cin: int, out_ch: int, kernel: int, stride: int, expand: int):
        super().__init__()
        mid = cin * expand
        _conv_bn(self, "expand", cin, mid)
        _conv_bn(self, "dw", mid, mid, kernel, stride, groups=mid)
        _conv_bn(self, "project", mid, out_ch)
        self.residual = stride == 1 and cin == out_ch

    def forward(self, x):
        y = _apply(self, "expand", x, True)
        y = _apply(self, "dw", y, True)
        y = _apply(self, "project", y, False)
        return y + x if self.residual else y


# (name, blocks, out channels, kernel, stride of the first, expansion)
_MNAS_STAGES = (("mb1", 3, 24, 3, 2, 3), ("mb2", 3, 40, 5, 2, 3), ("mb3", 3, 80, 5, 2, 6),
                ("mb4", 2, 96, 3, 1, 6), ("mb5", 4, 192, 5, 2, 6), ("mb6", 1, 320, 3, 1, 6))
# the stage whose output is each level
_MNAS_LEVELS = {"mb1": "p2", "mb2": "p3", "mb4": "p4", "mb6": "p5"}


class MNASNetBottomUp(nn.Module):
    """MNASNet-1.0's feature trunk sliced into a 5-level pyramid."""

    def __init__(self):
        super().__init__()
        self.stem_conv = Conv2d(3, 32, 3, 2, 1, bias=False)
        self.stem_bn = BatchNorm2d(32)
        _conv_bn(self, "sep_dw", 32, 32, 3, groups=32)
        _conv_bn(self, "sep_pw", 32, 16)
        cin = 16
        for name, n, out_ch, k, s, e in _MNAS_STAGES:
            for i in range(n):
                self.add_module(f"{name}_{i}",
                                InvertedResidual(cin, out_ch, k, s if i == 0 else 1, e))
                cin = out_ch

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = torch.relu(self.stem_bn(self.stem_conv(x)))
        y = _apply(self, "sep_dw", y, True)
        y = _apply(self, "sep_pw", y, False)
        outs = {}
        for name, n, *_ in _MNAS_STAGES:
            for i in range(n):
                y = getattr(self, f"{name}_{i}")(y)
            if name in _MNAS_LEVELS:
                outs[_MNAS_LEVELS[name]] = y
        outs["p6"] = _p6(y)
        return outs

    @staticmethod
    def out_channels() -> Dict[str, int]:
        return {"p2": 24, "p3": 40, "p4": 96, "p5": 320, "p6": 320}


# ---------------------------------------------------------------------------
# DenseNet 121
# ---------------------------------------------------------------------------

class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth: int = 32):
        super().__init__()
        self.bn1 = BatchNorm2d(cin)
        self.conv1 = Conv2d(cin, 4 * growth, 1, bias=False)
        self.bn2 = BatchNorm2d(4 * growth)
        self.conv2 = Conv2d(4 * growth, growth, 3, 1, 1, bias=False)

    def forward(self, x):
        y = self.conv1(torch.relu(self.bn1(x)))
        y = self.conv2(torch.relu(self.bn2(y)))
        return torch.cat([x, y], dim=1)


class DenseNetBottomUp(nn.Module):
    """DenseNet-121: blocks (6, 12, 24, 16), growth 32; no norm5."""

    BLOCKS = (6, 12, 24, 16)

    def __init__(self):
        super().__init__()
        self.stem_conv = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.stem_bn = BatchNorm2d(64)
        c = 64
        for bi, n in enumerate(self.BLOCKS):
            for li in range(n):
                self.add_module(f"dense{bi + 1}_{li}", DenseLayer(c, 32))
                c += 32
            if bi < len(self.BLOCKS) - 1:
                # transition: BN, ReLU, 1x1 conv to half the channels, 2x2 mean
                self.add_module(f"trans{bi + 1}_bn", BatchNorm2d(c))
                self.add_module(f"trans{bi + 1}_conv", Conv2d(c, c // 2, 1, bias=False))
                c //= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = torch.relu(self.stem_bn(self.stem_conv(x)))
        y = F.max_pool2d(y, 3, 2, 1)
        outs = {}
        for bi, n in enumerate(self.BLOCKS):
            for li in range(n):
                y = getattr(self, f"dense{bi + 1}_{li}")(y)
            outs[f"p{bi + 2}"] = y
            if bi < len(self.BLOCKS) - 1:
                t = torch.relu(getattr(self, f"trans{bi + 1}_bn")(y))
                y = F.avg_pool2d(getattr(self, f"trans{bi + 1}_conv")(t), 2, 2)
        outs["p6"] = _p6(outs["p5"])
        return outs

    @staticmethod
    def out_channels() -> Dict[str, int]:
        return {"p2": 256, "p3": 512, "p4": 1024, "p5": 1024, "p6": 1024}
