"""Masked, static-shape subsampling (weakcube_tpu/ops/sampling.py).

Gumbel top-k: adding Gumbel noise to log-weights and taking the top k draws
k items without replacement with probability proportional to the weights.
The noise comes from an explicit `torch.Generator` on the tensors' device;
it does not reproduce JAX's PRNG, so the tests hold these functions to
their invariants (caps, budgets, packing order), not to JAX's draws.
Every function works on a leading batch of rows (..., N).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import global_rows, local_rows

_NEG = -1e10


def gumbel(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in (0, 1), of a
    (B, ...) shape. In a data-parallel run every rank draws the global
    batch's noise from the same generator state and keeps its own rows: the
    ranks' samples are those of one process on the global batch."""
    u = local_rows(torch.rand(global_rows(shape), generator=generator,
                              device=device or generator.device))
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def gumbel_topk_mask(generator: torch.Generator, log_weights: torch.Tensor,
                     valid: torch.Tensor, k: int) -> torch.Tensor:
    """Select up to k valid items of each row with probability proportional
    to exp(log_weights): (..., N) bool with min(k, valid count) per row."""
    n = log_weights.shape[-1]
    g = gumbel(log_weights.shape, generator, log_weights.device)
    scores = torch.where(valid, log_weights + g, torch.full_like(g, _NEG))
    idx = torch.topk(scores, min(k, n), dim=-1).indices
    picked = torch.zeros(valid.shape, dtype=torch.bool, device=valid.device)
    return picked.scatter(-1, idx, True) & valid


def uniform_topk_mask(generator: torch.Generator, valid: torch.Tensor, k: int) -> torch.Tensor:
    """Up to k valid items of each row, uniformly (d2's subsample_labels)."""
    return gumbel_topk_mask(generator, torch.zeros(valid.shape, device=valid.device), valid, k)


def rank_budget_mask(scores: torch.Tensor, valid: torch.Tensor,
                     budget: torch.Tensor, max_budget: int) -> torch.Tensor:
    """valid & (descending rank of the score < budget) for each row, from a
    top-k of max_budget values: the budget-th largest score is the cut.
    budget: (...,) int, at most max_budget."""
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG))
    top = torch.topk(masked, min(max_budget, masked.shape[-1]), dim=-1).values
    at = (budget.long() - 1).clamp(0, top.shape[-1] - 1)
    cut = torch.gather(top, -1, at[..., None])
    return valid & (masked >= cut) & (budget > 0)[..., None]


def sample_fg_bg(generator: torch.Generator, is_fg: torch.Tensor, is_bg: torch.Tensor,
                 num_samples: int, positive_fraction: float,
                 fg_log_weights: Optional[torch.Tensor] = None):
    """detectron2's balanced subsampling per row: up to
    int(num_samples * positive_fraction) foreground items (weighted by
    exp(fg_log_weights)), and background filling the rest of num_samples.
    Returns the (..., N) fg and bg masks."""
    num_fg_budget = int(num_samples * positive_fraction)
    if fg_log_weights is None:
        fg_log_weights = torch.zeros(is_fg.shape, device=is_fg.device)
    fg_mask = gumbel_topk_mask(generator, fg_log_weights, is_fg, num_fg_budget)
    g = gumbel(is_bg.shape, generator, is_bg.device)
    bg_budget = (num_samples - fg_mask.sum(-1)).clamp(min=0)
    bg_mask = rank_budget_mask(g, is_bg, bg_budget, num_samples)
    return fg_mask, bg_mask
