"""Layers that keep float32 parameters and compute in the input's dtype.

The JAX package holds parameters in float32 and computes in
cfg.TPU.COMPUTE_DTYPE (flax `dtype=`, `param_dtype=float32`). These layers do
the same: each casts its weights to the dtype of the tensor it is given.

BatchNorm normalises in float32, as flax's BatchNorm does, and returns the
input dtype (eps 1e-5). In eval mode it uses the running statistics. In
training mode it normalises with the batch statistics as flax computes them
(mean E[x] and the biased variance E[x^2] - E[x]^2, in float32: with
activations whose mean is large against their spread, this form and
PyTorch's two-pass batch_norm differ by far more than rounding, in the
output and more in the gradient), and computes the running statistics flax
would record, with flax's momentum 0.9 (PyTorch's momentum=0.1) and that
biased variance (PyTorch's own training batch_norm records the unbiased
one), but keeps them aside in `pending`:
`apply_batch_stats(model)` writes them into the running buffers, which the
train step does only when it applies the update (flax's mutable
batch_stats, returned and kept or dropped by the step).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class BatchNorm2d(nn.BatchNorm2d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.pending = None  # (running_mean, running_var) after this batch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))  # float64 stays
        if not self.training:
            y = F.batch_norm(x32, self.running_mean.to(x32.dtype), self.running_var.to(x32.dtype),
                             self.weight.to(x32.dtype), self.bias.to(x32.dtype), False, 0.0,
                             self.eps)
            return y.to(x.dtype)
        mean = x32.mean((0, 2, 3))
        var = ((x32 * x32).mean((0, 2, 3)) - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        with torch.no_grad():
            m = self.momentum
            self.pending = ((1 - m) * self.running_mean + m * mean.float(),
                            (1 - m) * self.running_var + m * var.float())
        return y.to(x.dtype)


def apply_batch_stats(model: nn.Module) -> None:
    """Write every BatchNorm's pending training statistics into its running
    buffers (and clear them)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d) and m.pending is not None:
                m.running_mean.copy_(m.pending[0])
                m.running_var.copy_(m.pending[1])
                m.pending = None
