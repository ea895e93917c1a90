"""Deep Layer Aggregation (DLA) trunk (weakcube_tpu/models/backbone/dla.py).

Hierarchical Tree and Root aggregation for the dla34/46_c/46x_c/60/60x/102/169
variants, emitting the raw pyramid {p2: stride 4 ... p6: stride 64}. Modules
carry the detectron2 state-dict names of the reference trunk (base_layer,
level0..5, tree1, tree2, root, project). Inside, tensors are NCHW in
channels_last memory.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ...ops import pool as pool_ops
from ..layers import BatchNorm2d, Conv2d

_DLA_SPECS: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...], str]] = {
    # levels, channels, block
    "dla34": ((1, 1, 1, 2, 2, 1), (16, 32, 64, 128, 256, 512), "basic"),
    "dla46_c": ((1, 1, 1, 2, 2, 1), (16, 32, 64, 64, 128, 256), "bottleneck"),
    "dla46x_c": ((1, 1, 1, 2, 2, 1), (16, 32, 64, 64, 128, 256), "bottleneckx"),
    "dla60x_c": ((1, 1, 1, 2, 3, 1), (16, 32, 64, 64, 128, 256), "bottleneckx"),
    "dla60": ((1, 1, 1, 2, 3, 1), (16, 32, 128, 256, 512, 1024), "bottleneck"),
    "dla60x": ((1, 1, 1, 2, 3, 1), (16, 32, 128, 256, 512, 1024), "bottleneckx"),
    "dla102": ((1, 1, 1, 3, 4, 1), (16, 32, 128, 256, 512, 1024), "bottleneck"),
    "dla102x": ((1, 1, 1, 3, 4, 1), (16, 32, 128, 256, 512, 1024), "bottleneckx"),
    "dla169": ((1, 2, 3, 5, 1, 1), (16, 32, 128, 256, 512, 1024), "bottleneck"),
}


def _max_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """ops/pool.py::max_pool_nonoverlap on an NCHW tensor."""
    return pool_ops.max_pool_nonoverlap(x.permute(0, 2, 3, 1), stride).permute(0, 3, 1, 2)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        d = dilation
        self.conv1 = Conv2d(cin, cout, 3, stride, d, dilation=d, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = Conv2d(cout, cout, 3, 1, d, dilation=d, bias=False)
        self.bn2 = BatchNorm2d(cout)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """Bottleneck block; cardinality > 1 is the grouped bottleneck-X."""

    expansion = 2

    def __init__(self, cin: int, cout: int, stride: int = 1, dilation: int = 1,
                 cardinality: int = 1):
        super().__init__()
        mid = cout // self.expansion
        if cardinality > 1:  # DLA-X: width scaled by cardinality/32
            mid = int(cout * cardinality / 32) // self.expansion * self.expansion
        d = dilation
        self.conv1 = Conv2d(cin, mid, 1, bias=False)
        self.bn1 = BatchNorm2d(mid)
        self.conv2 = Conv2d(mid, mid, 3, stride, d, dilation=d, groups=cardinality,
                            bias=False)
        self.bn2 = BatchNorm2d(mid)
        self.conv3 = Conv2d(mid, cout, 1, bias=False)
        self.bn3 = BatchNorm2d(cout)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + residual)


def _make_block(block: str, cin: int, cout: int, stride: int, dilation: int) -> nn.Module:
    if block == "basic":
        return BasicBlock(cin, cout, stride, dilation)
    if block == "bottleneck":
        return Bottleneck(cin, cout, stride, dilation)
    return Bottleneck(cin, cout, stride, dilation, cardinality=32)


class Root(nn.Module):
    """Aggregation node: 1x1 conv over the concatenated children."""

    def __init__(self, cin: int, cout: int, residual: bool = False):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1, bias=False)
        self.bn = BatchNorm2d(cout)
        self.residual = residual

    def forward(self, children: List[torch.Tensor]):
        y = self.bn(self.conv(torch.cat(children, dim=1)))
        if self.residual:
            y = y + children[0]
        return torch.relu(y)


class Tree(nn.Module):
    """Recursive aggregation tree. root_dim is the channel count the root
    concatenates: 2 * cout, plus cin for a level root, plus cout for every
    enclosing tree2."""

    def __init__(self, levels: int, block: str, cin: int, cout: int, stride: int = 1,
                 level_root: bool = False, root_dim: int = 0,
                 root_residual: bool = False, dilation: int = 1):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * cout
        if level_root:
            root_dim += cin
        if levels == 1:
            self.tree1 = _make_block(block, cin, cout, stride, dilation)
            self.tree2 = _make_block(block, cout, cout, 1, dilation)
            self.root = Root(root_dim, cout, root_residual)
        else:
            self.tree1 = Tree(levels - 1, block, cin, cout, stride,
                              root_residual=root_residual, dilation=dilation)
            self.tree2 = Tree(levels - 1, block, cout, cout, 1,
                              root_dim=root_dim + cout,
                              root_residual=root_residual, dilation=dilation)
        # Present whenever cin != cout (the checkpoints carry it), but only a
        # levels-1 tree uses its own projection as the residual: a levels>1
        # tree's project is dead, since tree1 computes its own.
        self.project = (nn.Sequential(Conv2d(cin, cout, 1, bias=False), BatchNorm2d(cout))
                        if cin != cout else None)
        self.levels = levels
        self.level_root = level_root
        self.stride = stride

    def forward(self, x, children: Optional[List[torch.Tensor]] = None):
        children = list(children) if children else []
        bottom = _max_pool(x, self.stride)
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            residual = self.project(bottom) if self.project is not None else bottom
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        if self.training and self.project is not None:
            # dead for the output, but flax records the batch statistics of
            # this projection in training, so its running statistics move
            with torch.no_grad():
                self.project(bottom)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children)


def _conv_bn_relu(cin: int, cout: int, k: int, stride: int, pad: int) -> nn.Sequential:
    return nn.Sequential(Conv2d(cin, cout, k, stride, pad, bias=False),
                         BatchNorm2d(cout), nn.ReLU())


class DLABottomUp(nn.Module):
    """DLA trunk -> raw {p2..p6} pyramid (strides 4..64), NCHW."""

    def __init__(self, dla_type: str = "dla34"):
        super().__init__()
        levels, ch, block = _DLA_SPECS[dla_type]
        self.base_layer = _conv_bn_relu(3, ch[0], 7, 1, 3)
        self.level0 = _conv_bn_relu(ch[0], ch[0], 3, 1, 1)
        self.level1 = _conv_bn_relu(ch[0], ch[1], 3, 2, 1)
        self.level2 = Tree(levels[2], block, ch[1], ch[2], 2, level_root=False)
        self.level3 = Tree(levels[3], block, ch[2], ch[3], 2, level_root=True)
        self.level4 = Tree(levels[4], block, ch[3], ch[4], 2, level_root=True)
        self.level5 = Tree(levels[5], block, ch[4], ch[5], 2, level_root=True)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = self.level1(self.level0(self.base_layer(x)))
        l2 = self.level2(y)
        l3 = self.level3(l2)
        l4 = self.level4(l3)
        l5 = self.level5(l4)
        p6 = pool_ops.subsample2(l5.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return {"p2": l2, "p3": l3, "p4": l4, "p5": l5, "p6": p6}

    @staticmethod
    def out_channels(dla_type: str) -> Dict[str, int]:
        ch = _DLA_SPECS[dla_type][1]
        return {"p2": ch[2], "p3": ch[3], "p4": ch[4], "p5": ch[5], "p6": ch[5]}
