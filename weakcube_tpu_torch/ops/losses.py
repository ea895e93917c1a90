"""Elementwise losses and the masked reductions (weakcube_tpu/ops/losses.py).

`masked_mean` is the static-shape form of the reference's
`safely_reduce_losses`: non-finite entries are masked out, and an empty
mask gives 0 rather than NaN. In a data-parallel run the mean is over the
global batch: the numerator is this rank's share, the count is every
rank's (parallel/mesh.py::global_sum, detached), so that the ranks' losses sum to
the one-process loss.
"""
from __future__ import annotations

import torch

from ..parallel.mesh import global_sum


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise binary cross entropy on logits."""
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy with integer labels, elementwise over the batch."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                drop_nonfinite: bool = True) -> torch.Tensor:
    """Mean of x over mask (over the global batch), non-finite entries
    dropped; 0 when nothing is left."""
    m = mask
    if drop_nonfinite:
        m = m & torch.isfinite(x)
    x = torch.where(m, x, torch.zeros_like(x))
    return x.sum() / global_sum(m.sum().detach()).clamp(min=1)


def masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask & torch.isfinite(x), x, torch.zeros_like(x)).sum()
