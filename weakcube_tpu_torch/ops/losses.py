"""Elementwise losses and the masked reductions (weakcube_tpu/ops/losses.py).

`absolute` is |x| with jnp.abs's subgradient at 0 (1; torch.abs gives 0):
the weak z search's loss sits exactly there whenever the search keeps the
predicted depth, and the segment loss's focal logits 8 hull - 4 where the
soft hull is 1/2.

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


def absolute(x: torch.Tensor) -> torch.Tensor:
    """|x|, with gradient 1 at x = 0 as jnp.abs has."""
    return torch.where(x >= 0, x, -x)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise binary cross entropy on logits."""
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
            + torch.log1p(torch.exp(-absolute(logits))))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """torchvision-semantics focal loss, elementwise (no reduction)."""
    p = torch.sigmoid(logits)
    ce = bce_with_logits(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def dice_loss(probs: torch.Tensor, targets: torch.Tensor, eps: float = 1.0) -> torch.Tensor:
    """Soft dice over the last axis (a flattened mask)."""
    num = 2.0 * (probs * targets).sum(-1) + eps
    den = probs.sum(-1) + targets.sum(-1) + eps
    return 1.0 - num / den


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
