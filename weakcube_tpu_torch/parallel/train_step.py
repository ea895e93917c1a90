"""One training step with the reference's stabilisation
(weakcube_tpu/parallel/train_step.py), on one device.

`train_step(model, optimizer, state, batch, generator)`:
  * forward in training mode, `total` = the sum of the loss dict, backward;
  * divergence: `total` non-finite or above EXPLOSION_FACTOR times the
    rolling mean of the recorded loss (GAMMA smoothing); the recorded loss
    is clipped to [0, 1] when diverging (1 when non-finite);
  * a non-finite gradient anywhere also skips the update;
  * an applied update runs the optimizer (its schedule advances) and keeps
    the BatchNorm statistics of this batch; a skip keeps the parameters,
    the optimizer state, the schedule and the BatchNorm statistics as they
    were.
The JAX package's four-program backbone split, SPLIT_TRAIN_STEP and its
libtpu guard are escapes from TPU compiler faults and have no counterpart.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..models.layers import BatchNorm2d, apply_batch_stats
from ..solver import build_optimizer

GAMMA = 0.02            # rolling-mean smoothing
EXPLOSION_FACTOR = 4.0  # loss > 4x the rolling mean -> diverging


@dataclasses.dataclass
class TrainState:
    step: int = 0
    loss_ema: float = 0.0    # rolling mean of the recorded loss
    ema_init: bool = False   # whether the rolling mean has been seeded
    skipped: int = 0         # skipped (diverging or non-finite) updates
    applied: int = 0         # applied updates


def create_train_state(cfg, model: nn.Module):
    """Put the model in training mode with gradients on and build its
    optimizer. Returns (TrainState(), optimizer)."""
    model.train().requires_grad_(True)
    return TrainState(), build_optimizer(cfg, model)


def train_step(model: nn.Module, optimizer, state: TrainState, batch: dict,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[TrainState, Dict[str, float]]:
    """One step; returns the new state and the logs (every loss and metric,
    total_loss, diverging, grad_finite) as floats."""
    model.train()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        p.grad = None
    losses, metrics = model(batch, generator)
    total = torch.stack([v.float() for v in losses.values()]).sum()
    total.backward()
    grads = [p.grad for p in params if p.grad is not None]
    grad_finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    # the step's one host sync: the skip decision and the logs
    names = [*losses, *metrics]
    vals = torch.stack([total.detach(), grad_finite.float(),
                        *(v.detach().float() for v in losses.values()),
                        *(v.detach().float() for v in metrics.values())]).tolist()
    total_v, finite = vals[0], vals[1] == 1.0
    ema = state.loss_ema if state.ema_init else total_v
    diverging = not math.isfinite(total_v) or total_v > EXPLOSION_FACTOR * max(ema, 1e-8)
    skip = diverging or not finite
    recorded = min(max(total_v, 0.0), 1.0) if diverging else total_v
    if not math.isfinite(recorded):
        recorded = 1.0
    new_ema = ema * (1 - GAMMA) + GAMMA * recorded if state.ema_init else recorded
    if skip:
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.pending = None
    else:
        optimizer.step()
        apply_batch_stats(model)
    logs = dict(zip(names, vals[2:]))
    logs.update(total_loss=total_v, diverging=float(diverging), grad_finite=float(finite))
    return TrainState(step=state.step + 1, loss_ema=new_ema, ema_init=True,
                      skipped=state.skipped + skip, applied=state.applied + (not skip)), logs
