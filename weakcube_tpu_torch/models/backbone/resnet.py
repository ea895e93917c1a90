"""ResNet bottom-up trunk (weakcube_tpu/models/backbone/resnet.py).

resnet18/34/50/101 emitting the raw pyramid {p2: stride 4 ... p6: stride 64},
where p6 is a stride-2 subsample of p5 (ops/pool.py::subsample2), not a
2x2 pool. Modules carry torchvision's names (conv1, bn1,
layer{s}.{b}.conv{i} / bn{i}, layer{s}.{b}.downsample.0 / .1), which are
the names of a released detectron2 checkpoint under backbone.bottom_up.
Inside, tensors are NCHW in channels_last memory.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import pool as pool_ops
from ..layers import BatchNorm2d, Conv2d


def _downsample(cin: int, cout: int, stride: int):
    """The projection of the residual, where the width or the stride
    changes."""
    if cin == cout and stride == 1:
        return None
    return nn.Sequential(Conv2d(cin, cout, 1, stride, bias=False), BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.downsample = _downsample(cin, width, stride)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """Bottleneck of width `width`; its output has 4 * width channels."""

    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        cout = width * self.expansion
        self.conv1 = Conv2d(cin, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = Conv2d(width, cout, 1, bias=False)
        self.bn3 = BatchNorm2d(cout)
        self.downsample = _downsample(cin, cout, stride)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


_SPECS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
}
_WIDTHS = (64, 128, 256, 512)


class ResNetBottomUp(nn.Module):
    """torchvision-layout ResNet trunk -> raw {p2..p6} pyramid, NCHW."""

    def __init__(self, depth: int = 34):
        super().__init__()
        block, counts = _SPECS[depth]
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for stage, (n, width) in enumerate(zip(counts, _WIDTHS)):
            blocks = []
            for b in range(n):
                blocks.append(block(cin, width, (1 if stage == 0 else 2) if b == 0 else 1))
                cin = width * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, 2, 1)  # flax's max_pool pads with -inf, as this does
        outs = {}
        for stage in range(4):
            y = getattr(self, f"layer{stage + 1}")(y)
            outs[f"p{stage + 2}"] = y
        outs["p6"] = pool_ops.subsample2(y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return outs

    @staticmethod
    def out_channels(depth: int) -> Dict[str, int]:
        mult = _SPECS[depth][0].expansion
        return {"p2": 64 * mult, "p3": 128 * mult, "p4": 256 * mult,
                "p5": 512 * mult, "p6": 512 * mult}
