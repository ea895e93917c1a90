"""The port's optimizers (weakcube_tpu_torch/solver/build.py) against the
JAX package's optax chains (weakcube_tpu/solver/build.py).

A small tree of the full model's names (a conv with a bias, a BatchNorm, a
Linear) in float64: each SOLVER.TYPE of the Adam family, with and without
CLIP_GRADIENTS (by value and by global norm) and freeze_bn, takes three
updates with the same handed gradients in both packages, across a warmup
and a schedule step, with weight decay in every group. The parameters after
each update agree to 1e-12 of their scale. No model is compiled.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from weakcube_tpu.config import get_cfg as j_get_cfg
from weakcube_tpu.solver.build import build_optimizer as j_build_optimizer
from weakcube_tpu.solver.build import freeze_bn as j_freeze_bn
from weakcube_tpu_torch.config import get_cfg as t_get_cfg
from weakcube_tpu_torch.models.layers import BatchNorm2d, Conv2d, Linear
from weakcube_tpu_torch.solver import build_optimizer, freeze_bn
from weakcube_tpu_torch.utils import convert

TYPES = ("adam", "adam+amsgrad", "adamw", "adamw+amsgrad")


class Tiny(torch.nn.Module):
    """backbone.bottom_up.{conv1, bn1} and roi_heads.box_head.fc1."""

    def __init__(self):
        super().__init__()
        self.backbone = torch.nn.Module()
        self.backbone.bottom_up = torch.nn.Module()
        self.backbone.bottom_up.conv1 = Conv2d(2, 3, 3, bias=True)
        self.backbone.bottom_up.bn1 = BatchNorm2d(3)
        self.roi_heads = torch.nn.Module()
        self.roi_heads.box_head = torch.nn.Module()
        self.roi_heads.box_head.fc1 = Linear(4, 5)


def flax_tree(rng, scale=1.0):
    return {"bottom_up": {"conv1": {"kernel": scale * rng.normal(size=(3, 3, 2, 3)),
                                    "bias": scale * rng.normal(size=(3,))},
                          "bn1": {"scale": scale * rng.normal(size=(3,)),
                                  "bias": scale * rng.normal(size=(3,))}},
            "roi_heads": {"box_head": {"fc1": {"kernel": scale * rng.normal(size=(4, 5)),
                                               "bias": scale * rng.normal(size=(5,))}}}}


def as_torch(tree):
    """flax_params_to_torch in float64."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convert, "_t", lambda a: torch.from_numpy(np.array(a, np.float64)))
        return convert.flax_params_to_torch(tree)


def solver_cfgs(kind, clip):
    out = []
    for c in (t_get_cfg(), j_get_cfg()):
        s = c.SOLVER
        s.TYPE, s.BASE_LR, s.WARMUP_ITERS, s.WARMUP_FACTOR, s.STEPS = kind, 0.05, 2, 0.25, (2,)
        s.WEIGHT_DECAY, s.WEIGHT_DECAY_NORM, s.WEIGHT_DECAY_BIAS = 0.03, 0.02, 0.01
        s.BIAS_LR_FACTOR, s.GAMMA = 2.0, 0.5
        if clip:
            s.CLIP_GRADIENTS.ENABLED = True
            s.CLIP_GRADIENTS.CLIP_TYPE, s.CLIP_GRADIENTS.CLIP_VALUE = clip
        out.append(c)
    return out


# the gradients of the three updates: the second and third are far smaller
# than the first, so that the bias-corrected and the raw second moments
# reach their maxima at different steps (torch's amsgrad differs there)
GRAD_SCALES = (1.0, 1e-3, 0.3)


def run_both(kind, clip, frozen):
    rng = np.random.default_rng(0)
    params = flax_tree(rng)
    grads = [flax_tree(rng, s) for s in GRAD_SCALES]
    tcfg, jcfg = solver_cfgs(kind, clip)
    with jax.enable_x64():
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        tx = j_build_optimizer(jcfg, jp)
        if frozen:
            tx = j_freeze_bn(tx, jp)
        state = tx.init(jp)
        want = []
        for g in grads:
            upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
            jp = optax.apply_updates(jp, upd)
            want.append(as_torch(jax.device_get(jp)))
    model = Tiny().double()
    model.load_state_dict(as_torch(params), strict=False)
    opt = build_optimizer(tcfg, model)
    if frozen:
        freeze_bn(opt)
    named = dict(model.named_parameters())
    got = []
    for g in grads:
        for name, x in as_torch(g).items():
            named[name].grad = x.clone()
        opt.step()
        got.append({k: p.detach().clone() for k, p in named.items()})
    return want, got, opt


@pytest.mark.parametrize("frozen", [False, True], ids=["", "freeze_bn"])
@pytest.mark.parametrize("clip", [None, ("value", 0.5), ("norm", 0.7)],
                         ids=["no-clip", "clip-value", "clip-norm"])
@pytest.mark.parametrize("kind", TYPES)
def test_adam_family_matches_optax(kind, clip, frozen):
    want, got, opt = run_both(kind, clip, frozen)
    assert opt.count == 3
    for step, (w, g) in enumerate(zip(want, got)):
        assert set(w) == set(g)
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), rtol=0,
                                       atol=1e-12 * float(w[k].abs().max()),
                                       err_msg=f"update {step + 1}: {k}")
    bn = ("backbone.bottom_up.bn1.weight", "backbone.bottom_up.bn1.bias")
    moved = [not torch.equal(got[-1][k], got[0][k]) for k in bn]
    assert moved == [not frozen] * 2


def test_amsgrad_keeps_the_bias_corrected_maximum():
    """On these gradients torch.optim.Adam(amsgrad=True), which keeps the
    maximum of the raw second moment, moves the parameters elsewhere than
    optax's amsgrad, which the port follows."""
    want, got, _ = run_both("adam+amsgrad", None, False)
    rng = np.random.default_rng(0)
    params, grads = flax_tree(rng), [flax_tree(rng, s) for s in GRAD_SCALES]
    tcfg, _ = solver_cfgs("adam+amsgrad", None)
    model = Tiny().double()
    model.load_state_dict(as_torch(params), strict=False)
    ours = build_optimizer(tcfg, model)
    groups = [{"params": g["params"], "lr": g["lr"], "lr_scale": g["lr_scale"],
               "weight_decay": g["weight_decay"]} for g in ours.param_groups]
    theirs = torch.optim.Adam(groups, amsgrad=True)
    named = dict(model.named_parameters())
    for step, g in enumerate(grads):
        for name, x in as_torch(g).items():
            named[name].grad = x.clone()
        lr = ours.schedule(step)
        for group in theirs.param_groups:
            group["lr"] = float(np.float32(lr) * np.float32(group["lr_scale"]))
        theirs.step()
    k = "roi_heads.box_head.fc1.weight"
    assert not torch.allclose(named[k], want[-1][k], rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", TYPES)
def test_adam_copy_keeps_moments_and_count(kind):
    """A deep copy goes on from the same moments and count, as the
    train step's restart relies on."""
    tcfg, _ = solver_cfgs(kind, None)
    model = Tiny().double()
    opt = build_optimizer(tcfg, model)
    for _ in range(2):
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
    m2, o2 = copy.deepcopy((model, opt))
    assert o2.count == 2 and (o2.amsgrad, o2.decoupled) == (opt.amsgrad, opt.decoupled)
    for a, b in ((model, opt), (m2, o2)):
        for p in a.parameters():
            p.grad = torch.full_like(p, 0.5)
        b.step()
    for p, q in zip(model.parameters(), m2.parameters()):
        assert torch.equal(p, q)


def test_unknown_solver_type_raises():
    cfg = t_get_cfg()
    cfg.SOLVER.TYPE = "rmsprop"
    with pytest.raises(ValueError, match="rmsprop"):
        build_optimizer(cfg, Tiny())
