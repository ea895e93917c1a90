"""Optimizer and learning-rate schedule (weakcube_tpu/solver/build.py).

`build_optimizer(cfg, model)` is SGD with momentum (and nesterov), with
detectron2's parameter groups, labelled as the JAX package labels its flax
parameters:
  * "norm": BatchNorm weights and biases (lr 1, WEIGHT_DECAY_NORM);
  * "bias": every other bias (BIAS_LR_FACTOR, WEIGHT_DECAY_BIAS or
    WEIGHT_DECAY);
  * "default": everything else (lr 1, WEIGHT_DECAY);
and, as optax's chain, gradient clipping by value or global norm first
(SOLVER.CLIP_GRADIENTS), then weight decay, momentum and the scheduled
learning rate. Each `step()` advances the WarmupMultiStep schedule by one;
a skipped update calls no `step()`, so the schedule does not advance
either. As optax does, every parameter is decayed and carries momentum
every step: a parameter without a gradient gets a zero one.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import BatchNorm2d

GROUPS = ("default", "bias", "norm")


def build_lr_schedule(cfg) -> Callable[[int], float]:
    """WarmupMultiStepLR: count -> learning rate; a linear warmup from
    BASE_LR * WARMUP_FACTOR over WARMUP_ITERS, then GAMMA at each of STEPS,
    in float32 as the JAX package computes it."""
    base = np.float32(cfg.SOLVER.BASE_LR)
    warmup_iters = max(cfg.SOLVER.WARMUP_ITERS, 1)
    warmup_factor = np.float32(cfg.SOLVER.WARMUP_FACTOR)
    steps = list(cfg.SOLVER.STEPS)
    gamma = np.float32(cfg.SOLVER.GAMMA)

    def schedule(count: int) -> float:
        it = np.float32(count)
        alpha = np.clip(it / np.float32(warmup_iters), np.float32(0), np.float32(1))
        warm = warmup_factor * (np.float32(1) - alpha) + alpha
        decay = np.float32(1)
        for s in steps:
            decay = decay * (gamma if it >= s else np.float32(1))
        return float(base * warm * decay)

    return schedule


def param_label(module: nn.Module, name: str) -> str:
    """"norm", "bias" or "default" for parameter `name` of `module` (its
    owner)."""
    if isinstance(module, BatchNorm2d):
        return "norm"
    return "bias" if name == "bias" else "default"


def param_groups(model: nn.Module) -> Dict[str, List[nn.Parameter]]:
    groups: Dict[str, List[nn.Parameter]] = {g: [] for g in GROUPS}
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            groups[param_label(module, name)].append(p)
    return groups


class SGD(torch.optim.SGD):
    """torch's SGD (the same update as optax's sgd after
    add_decayed_weights) with the schedule and clipping of the config."""

    def __init__(self, cfg, groups: Dict[str, List[nn.Parameter]]):
        s = cfg.SOLVER
        wd_bias = s.WEIGHT_DECAY if s.WEIGHT_DECAY_BIAS is None else s.WEIGHT_DECAY_BIAS
        scale = {"default": (1.0, s.WEIGHT_DECAY), "bias": (s.BIAS_LR_FACTOR, wd_bias),
                 "norm": (1.0, s.WEIGHT_DECAY_NORM)}
        super().__init__([{"params": ps, "name": g, "lr_scale": scale[g][0],
                           "weight_decay": scale[g][1]} for g, ps in groups.items() if ps],
                         lr=s.BASE_LR, momentum=s.MOMENTUM, nesterov=s.NESTEROV)
        self.schedule = build_lr_schedule(cfg)
        self.count = 0
        clip = s.CLIP_GRADIENTS
        self.clip = (clip.CLIP_TYPE, clip.CLIP_VALUE) if clip.ENABLED else None

    def __getstate__(self):
        # torch's Optimizer copies and pickles only its defaults, state and
        # groups; a copy also keeps the schedule, its count and the clipping
        return {**super().__getstate__(), "schedule": self.schedule, "count": self.count,
                "clip": self.clip}

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if self.clip is not None:
            kind, value = self.clip
            if kind == "value":
                for g in grads:
                    g.clamp_(-value, value)
            else:  # optax.clip_by_global_norm
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(g) for g in grads]))
                scale = torch.where(norm < value, torch.ones_like(norm), value / norm)
                torch._foreach_mul_(grads, scale)
        lr = self.schedule(self.count)
        for g in self.param_groups:
            g["lr"] = lr * g["lr_scale"]
        super().step(closure)
        self.count += 1


def build_optimizer(cfg, model: nn.Module) -> SGD:
    if cfg.SOLVER.TYPE != "sgd":
        raise NotImplementedError(f"SOLVER.TYPE {cfg.SOLVER.TYPE!r} is not ported to "
                                  "PyTorch yet (ROADMAP.md); only 'sgd' is")
    return SGD(cfg, param_groups(model))
