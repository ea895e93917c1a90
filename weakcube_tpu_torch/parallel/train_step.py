"""One training step with the reference's stabilisation
(weakcube_tpu/parallel/train_step.py), on one device or data-parallel.

`train_step(model, optimizer, state, batch, generator)`:
  * forward in training mode, `total` = the sum of the loss dict, backward;
    the costly metrics (Cube/IoU3D) are computed every 200th step and read
    NaN on the others;
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

Data parallel: every rank (parallel/distributed.py, one process per card)
runs this step on its rows of the global batch. Its losses are its share of
the global batch's loss (local sums over global counts: ops/losses.py,
models/), so the ranks' gradients are summed, not averaged: after the
backward the gradients go through one all-reduce per 25 MB bucket of a
flat buffer (`sum_gradients`). That is in place of DistributedDataParallel,
whose averaging hook, `module.` key prefix, buffer broadcasts and refusal
of parameters without a gradient (a levels > 1 DLA tree's dead
projections) would each need undoing; the model keeps one-device code and
state-dict keys. `total`, the finite flag and the logs then take one
all-reduce before the host reads them, so every rank takes the same skip
decision, applies (or drops) the same global BatchNorm statistics and logs
the same global values: those of one process on the global batch.

That read is one of the step's host syncs, not its only one: on a card the
weak heads' corner constant is copied from pageable host memory
(ops/cuboids.py), so a weak step syncs twice there (benchmark/sync_audit.py
lists them). NMS syncs only on the CPU, where proposal selection's fixed
point reads its convergence once per pass and once more (ops/nms.py); on a
card it is one kernel launch.

Under a torch.profiler session the step records the spans of utils/trace.py:
train.step around it, train.backward, train.grad_sum (W > 1),
train.optimizer, and a `sync` around the host's wait for the logs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

import torch.distributed as dist

from ..models.layers import BatchNorm2d, apply_batch_stats
from ..solver import build_optimizer
from ..utils.trace import span
from . import distributed
from .mesh import global_sum

GAMMA = 0.02            # rolling-mean smoothing
EXPLOSION_FACTOR = 4.0  # loss > 4x the rolling mean -> diverging
METRICS_PERIOD = 200    # steps between two computations of the costly metrics
BUCKET_BYTES = 25 << 20  # gradient bytes per all-reduce


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


def sum_gradients(grads) -> None:
    """Sum the gradients over the ranks in place: one all-reduce per
    bucket of at most BUCKET_BYTES of a flat copy, all in flight at once.
    Every rank passes the same parameters' gradients (the model's graph
    does not depend on the data)."""
    if distributed.process_count() == 1:
        return
    with span("train.grad_sum"):
        buckets, cur, size = [], [], 0
        for g in grads:
            if cur and (size + g.numel() * g.element_size() > BUCKET_BYTES
                        or g.dtype != cur[0].dtype):
                buckets.append(cur)
                cur, size = [], 0
            cur.append(g)
            size += g.numel() * g.element_size()
        if cur:
            buckets.append(cur)
        flats = [torch.cat([g.reshape(-1) for g in b]) for b in buckets]
        works = [dist.all_reduce(f, async_op=True) for f in flats]
        for b, f, w in zip(buckets, flats, works):
            w.wait()
            for g, x in zip(b, torch.split(f, [g.numel() for g in b])):
                g.copy_(x.view_as(g))


def train_step(model: nn.Module, optimizer, state: TrainState, batch: dict,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[TrainState, Dict[str, float]]:
    """One step; returns the new state and the logs (every loss and metric,
    total_loss, diverging, grad_finite) as floats."""
    with span("train.step"):
        model.train()
        params = [p for g in optimizer.param_groups for p in g["params"]]
        for p in params:
            p.grad = None
        losses, metrics = model(dict(batch, metrics_tick=state.step % METRICS_PERIOD == 0),
                                generator)
        # the logs in float32 (float64 stays)
        dt = torch.promote_types(next(iter(losses.values())).dtype, torch.float32)
        total = torch.stack([v.to(dt) for v in losses.values()]).sum()
        with span("train.backward"):
            total.backward()
        grads = [p.grad for p in params if p.grad is not None]
        sum_gradients(grads)
        grad_finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        # the skip decision and the logs (each rank's share summed over the
        # ranks; the summed flag is W where all are finite), read by the host
        names = [*losses, *metrics]
        vals = global_sum(torch.stack([total.detach(), grad_finite.to(dt),
                                         *(v.detach().to(dt) for v in losses.values()),
                                         *(v.detach().to(dt) for v in metrics.values())]))
        with span("sync"):
            vals = vals.tolist()
        total_v, finite = vals[0], vals[1] == distributed.process_count()
        ema = state.loss_ema if state.ema_init else total_v
        diverging = not math.isfinite(total_v) or total_v > EXPLOSION_FACTOR * max(ema, 1e-8)
        skip = diverging or not finite
        recorded = min(max(total_v, 0.0), 1.0) if diverging else total_v
        if not math.isfinite(recorded):
            recorded = 1.0
        new_ema = ema * (1 - GAMMA) + GAMMA * recorded if state.ema_init else recorded
        with span("train.optimizer"):
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
