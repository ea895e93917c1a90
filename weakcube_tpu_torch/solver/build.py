"""Optimizers and learning-rate schedule (weakcube_tpu/solver/build.py).

`build_optimizer(cfg, model)` builds SOLVER.TYPE with detectron2's
parameter groups, labelled as the JAX package labels its flax parameters:
  * "norm": BatchNorm weights and biases (lr 1, WEIGHT_DECAY_NORM);
  * "bias": every other bias (BIAS_LR_FACTOR, WEIGHT_DECAY_BIAS or
    WEIGHT_DECAY);
  * "default": everything else (lr 1, WEIGHT_DECAY);
and, as optax's chain, gradient clipping by value or global norm first
(SOLVER.CLIP_GRADIENTS), then the update with the scheduled learning rate:
  * "sgd": weight decay (L2 on the gradient), momentum (and nesterov);
  * "adam": L2 weight decay, then optax.adam (b1 0.9, b2 0.999, eps 1e-8
    outside the root);
  * "adam+amsgrad": L2 weight decay, then optax.amsgrad, which keeps the
    maximum of the bias-corrected second moment (torch's amsgrad keeps the
    maximum of the raw one and corrects it afterwards: another update from
    the second step on);
  * "adamw" and "adamw+amsgrad": optax.adamw, decoupled decay
    -lr * (adam + wd * p). The JAX package builds plain AdamW for
    "adamw+amsgrad" too, and so does this one.
Each `step()` advances the WarmupMultiStep schedule by one; a skipped
update calls no `step()`, so neither the schedule nor Adam's bias
correction advances. As optax does, every parameter is decayed and
updated every step: a parameter without a gradient gets a zero one.
`freeze_bn(optimizer)` takes the BatchNorm weights and biases out of the
update (optax's set_to_zero under the JAX package's freeze_bn).
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


def _groups(cfg, groups: Dict[str, List[nn.Parameter]]) -> List[dict]:
    s = cfg.SOLVER
    wd_bias = s.WEIGHT_DECAY if s.WEIGHT_DECAY_BIAS is None else s.WEIGHT_DECAY_BIAS
    scale = {"default": (1.0, s.WEIGHT_DECAY), "bias": (s.BIAS_LR_FACTOR, wd_bias),
             "norm": (1.0, s.WEIGHT_DECAY_NORM)}
    return [{"params": ps, "name": g, "lr_scale": scale[g][0], "weight_decay": scale[g][1]}
            for g, ps in groups.items() if ps]


class _Scheduled:
    """What every optimizer of the config shares: the schedule and its
    count, the clipping ahead of the update, and the zero gradient of a
    parameter that got none. A subclass's `_update()` applies the update at
    each group's "lr"."""

    def _schedule_from(self, cfg) -> None:
        self.schedule = build_lr_schedule(cfg)
        self.count = 0
        clip = cfg.SOLVER.CLIP_GRADIENTS
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
        lr = np.float32(self.schedule(self.count))
        for g in self.param_groups:
            # float32, as optax scales its float32 schedule
            g["lr"] = float(lr * np.float32(g["lr_scale"]))
        self._update()
        self.count += 1


class SGD(_Scheduled, torch.optim.SGD):
    """torch's SGD (the same update as optax's sgd after
    add_decayed_weights)."""

    def __init__(self, cfg, groups: Dict[str, List[nn.Parameter]]):
        s = cfg.SOLVER
        torch.optim.SGD.__init__(self, _groups(cfg, groups), lr=s.BASE_LR, momentum=s.MOMENTUM,
                                 nesterov=s.NESTEROV)
        self._schedule_from(cfg)

    def _update(self):
        torch.optim.SGD.step(self)


class Adam(_Scheduled, torch.optim.Optimizer):
    """optax's adam / amsgrad after add_decayed_weights (decoupled=False),
    or adamw (decoupled=True). Per parameter, the state holds exp_avg and
    exp_avg_sq (optax's mu and nu) and, for amsgrad, max_exp_avg_sq (nu_max,
    the largest bias-corrected nu); the bias correction's step is the
    schedule's count + 1."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, cfg, groups: Dict[str, List[nn.Parameter]], amsgrad: bool = False,
                 decoupled: bool = False):
        torch.optim.Optimizer.__init__(self, _groups(cfg, groups),
                                       {"lr": cfg.SOLVER.BASE_LR, "weight_decay": 0.0})
        self.amsgrad, self.decoupled = amsgrad, decoupled
        self._schedule_from(cfg)

    def __getstate__(self):
        return {**super().__getstate__(), "amsgrad": self.amsgrad, "decoupled": self.decoupled}

    def _update(self):
        b1, b2, t = self.B1, self.B2, self.count + 1
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        keys = ("exp_avg", "exp_avg_sq") + (("max_exp_avg_sq",) if self.amsgrad else ())
        for group in self.param_groups:
            ps, wd = group["params"], group["weight_decay"]
            for p in ps:
                if not self.state[p]:
                    self.state[p].update({k: torch.zeros_like(p) for k in keys})
            gs = [p.grad for p in ps]
            if wd and not self.decoupled:  # add_decayed_weights: g + wd * p
                gs = torch._foreach_add(gs, torch._foreach_mul(ps, wd))
            mu = [self.state[p]["exp_avg"] for p in ps]
            nu = [self.state[p]["exp_avg_sq"] for p in ps]
            # (1 - b) * new + b * old, each product rounded, as optax does
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(gs, 1 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2))
            nu_hat = torch._foreach_div(nu, bc2)
            if self.amsgrad:
                nu_max = [self.state[p]["max_exp_avg_sq"] for p in ps]
                torch._foreach_maximum_(nu_max, nu_hat)
                nu_hat = nu_max
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, self.EPS)
            u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            if wd and self.decoupled:  # adamw: adam + wd * p
                torch._foreach_add_(u, torch._foreach_mul(ps, wd))
            torch._foreach_add_(ps, torch._foreach_mul(u, -group["lr"]))


def freeze_bn(optimizer):
    """Take the BatchNorm weights and biases (the "norm" group) out of the
    optimizer: they get no update, no decay and no moments, and no share of
    the global norm that clipping computes, as under optax's set_to_zero in
    the JAX package's freeze_bn (whose rule, "bn" or "BatchNorm" in the
    path, picks the same parameters). Call it before the first step."""
    optimizer.param_groups = [g for g in optimizer.param_groups if g["name"] != "norm"]
    return optimizer


def build_optimizer(cfg, model: nn.Module):
    kind, groups = cfg.SOLVER.TYPE, param_groups(model)
    if kind == "sgd":
        return SGD(cfg, groups)
    if kind in ("adam", "adam+amsgrad"):
        return Adam(cfg, groups, amsgrad=kind == "adam+amsgrad")
    if kind in ("adamw", "adamw+amsgrad"):
        return Adam(cfg, groups, decoupled=True)
    raise ValueError(f"unknown SOLVER.TYPE {kind}")
