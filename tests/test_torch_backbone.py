"""DLA + FPN of weakcube_tpu_torch against the flax modules, on the same
random weights converted by weakcube_tpu_torch.utils.convert.flax_to_torch.

The flax variables are drawn with numpy from a seed into the shapes flax's
own init gives (jax.eval_shape); the BatchNorm running statistics are far
from identity so that their conversion is exercised.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weakcube_tpu.models.backbone.build import build_backbone as j_build_backbone
from weakcube_tpu.models.backbone.dla import DLABottomUp as JDLABottomUp
from weakcube_tpu_torch.models.backbone.build import build_backbone as t_build_backbone
from weakcube_tpu_torch.models.backbone.dla import DLABottomUp as TDLABottomUp
from weakcube_tpu_torch.utils.convert import flax_to_torch


def random_variables(shapes, seed):
    """numpy draws into flax's variable shapes: fan-in normal kernels, and
    BatchNorm scale/bias/mean/var well away from the identity."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape).astype(np.float32)
        low, high = {"scale": (0.5, 1.5), "var": (0.5, 2.0)}.get(name, (-0.3, 0.3))
        return rng.uniform(low, high, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def sub_state_dict(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def dla34_fpn():
    from weakcube_tpu_torch.entry import tiny_cfg
    cfg = tiny_cfg(64, dla=True)
    jm = j_build_backbone(cfg, jnp.float32)
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = random_variables(shapes, seed=1)
    want = jax.jit(lambda v, x: jm.apply(v, x))(v, jnp.asarray(x))
    # the full model's layout: bottom_up at the top, the FPN under backbone/
    sd = flax_to_torch({"bottom_up": v["params"]["bottom_up"],
                        "backbone": {"fpn": v["params"]["fpn"]}},
                       {"bottom_up": v["batch_stats"]["bottom_up"]})
    tm = t_build_backbone(cfg, torch.float32)
    tm.load_state_dict(sub_state_dict(sd, "backbone."))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    return v, sd, got, want


@pytest.mark.parametrize("level", ["p2", "p3", "p4", "p5", "p6"])
def test_dla34_fpn_matches_flax(dla34_fpn, level):
    """float32 through ~40 conv layers on both sides: the frameworks' conv
    sums differ in order, so 1e-4 relative to the level's scale."""
    _, _, got, want = dla34_fpn
    assert got[level].shape == want[level].shape
    assert got[level].is_contiguous()          # NHWC, as the ROIAlign kernel reads it
    w = np.asarray(want[level])
    np.testing.assert_allclose(got[level].numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=1e-4)


def test_flax_to_torch_inverts_zoo_convert(dla34_fpn):
    """weakcube_tpu/utils/zoo_convert.py maps detectron2 names onto flax;
    flax_to_torch must be its exact inverse on the DLA trunk and the FPN."""
    from weakcube_tpu.utils.zoo_convert import convert_dla_bottom_up, convert_fpn
    v, sd, _, _ = dla34_fpn
    np_sd = {k: t.numpy() for k, t in sd.items()}
    p, s = convert_dla_bottom_up(np_sd, "dla34")
    fpn = convert_fpn(np_sd)
    for mine, theirs in ((p, v["params"]["bottom_up"]), (s, v["batch_stats"]["bottom_up"]),
                         (fpn, v["params"]["fpn"])):
        a = jax.tree_util.tree_leaves_with_path(mine)
        b = dict(jax.tree_util.tree_leaves_with_path(theirs))
        assert len(a) == len(b)
        for path, leaf in a:
            np.testing.assert_array_equal(leaf, b[path])


@pytest.mark.parametrize("dla_type", ["dla46_c", "dla46x_c"])
def test_bottleneck_trunks_match_flax(dla_type):
    """Bottleneck and grouped bottleneck-X trunks (converted the same way)."""
    x = np.random.default_rng(2).normal(size=(1, 64, 64, 3)).astype(np.float32)
    jm = JDLABottomUp(dla_type=dla_type)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = random_variables(shapes, seed=3)
    want = jax.jit(lambda v, x: jm.apply(v, x))(v, jnp.asarray(x))
    sd = flax_to_torch({"bottom_up": v["params"]}, {"bottom_up": v["batch_stats"]})
    tm = TDLABottomUp(dla_type)
    tm.load_state_dict(sub_state_dict(sd, "backbone.bottom_up."))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for level in ("p2", "p3", "p4", "p5", "p6"):
        w = np.asarray(want[level])
        np.testing.assert_allclose(got[level].permute(0, 2, 3, 1).numpy(), w,
                                   atol=1e-4 * np.abs(w).max(), rtol=1e-4, err_msg=level)


# ---------------------------------------------------------------------------
# The other trunks: ResNet, ShuffleNetV2, MNASNet, DenseNet-121
# ---------------------------------------------------------------------------

TRUNKS = {"resnet18": ("build_resnet_from_vision_fpn_backbone", 18),
          "resnet50": ("build_resnet_from_vision_fpn_backbone", 50),
          "shufflenet": ("build_shufflenet_fpn_backbone", None),
          "mnasnet": ("build_mnasnet_fpn_backbone", None),
          "densenet121": ("build_densenet_fpn_backbone", None)}


def trunk_cfg(trunk, size=64):
    from weakcube_tpu_torch.entry import tiny_cfg
    name, depth = TRUNKS[trunk]
    cfg = tiny_cfg(size).clone()
    cfg.defrost()
    cfg.MODEL.BACKBONE.NAME = name
    if depth:
        cfg.MODEL.RESNETS.DEPTH = depth
    cfg.freeze()
    return cfg


def full_model_layout(tree):
    """A flax Backbone's tree -> the full model's layout (bottom_up at the
    top, the FPN under backbone/)."""
    out = {"bottom_up": tree["bottom_up"]}
    if "fpn" in tree:
        out["backbone"] = {"fpn": tree["fpn"]}
    return out


@contextlib.contextmanager
def float64_convert():
    """flax_to_torch without its rounding to float32."""
    from weakcube_tpu_torch.utils import convert
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convert, "_t", lambda a: torch.from_numpy(np.array(a, np.float64)))
        yield


def pending_stats(tm):
    """The port's recorded training statistics, by state-dict name."""
    from weakcube_tpu_torch.models.layers import BatchNorm2d
    out = {}
    for name, m in tm.named_modules():
        if isinstance(m, BatchNorm2d):
            out[f"backbone.{name}.running_mean"], out[f"backbone.{name}.running_var"] = m.pending
    return out


def check_levels(got, want, scale_tol, msg):
    for level in ("p2", "p3", "p4", "p5", "p6"):
        w = np.asarray(want[level])
        assert got[level].shape == w.shape, (msg, level)
        np.testing.assert_allclose(got[level].numpy(), w, atol=scale_tol * np.abs(w).max(),
                                   rtol=0, err_msg=f"{msg} {level}")


@pytest.fixture
def one_thread():
    """Small shapes, and test workers run side by side: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


X64 = np.random.default_rng(4).normal(size=(2, 64, 64, 3))


@functools.lru_cache(maxsize=None)
def float64_variables(trunk):
    """cfg, the flax Backbone of the trunk in float64 and random variables
    for it (seed 5), drawn as float32 values and held in float64 (a float32
    variable would round what flax computes with it: the eval-mode
    BatchNorm multiplier, the momentum's product with the running
    statistics, the gradients). Cached: the file's tests share one trace of
    each trunk's init."""
    cfg = trunk_cfg(trunk)
    with jax.enable_x64():
        jm = j_build_backbone(cfg, jnp.float64)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(X64)))
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                               random_variables(shapes, 5))
    return cfg, jm, v


def torch_float64(cfg, v):
    with float64_convert():
        sd = flax_to_torch(full_model_layout(v["params"]), v["batch_stats"])
    tm = t_build_backbone(cfg, torch.float64).double()
    tm.load_state_dict(sub_state_dict(sd, "backbone."))
    return tm


@pytest.mark.parametrize("trunk", list(TRUNKS))
def test_trunk_fpn_matches_flax(trunk, one_thread):
    """Each trunk + FPN against the flax Backbone in float64, one jit: the
    eval-mode p2..p6 (running statistics), the train-mode p2..p6 (the
    batch's statistics) and the batch_stats that flax records, held to the
    port's pending statistics, at 1e-9 of each tensor's scale."""
    cfg, jm, v = float64_variables(trunk)
    x = X64
    with jax.enable_x64():

        @jax.jit
        def run(v, x):
            ev = jm.apply(v, x)
            tr, upd = jm.apply(v, x, train=True, mutable=["batch_stats"])
            return ev, tr, upd["batch_stats"]
        ev, tr, stats = jax.device_get(run(v, jnp.asarray(x)))
    with float64_convert():
        want_stats = flax_to_torch(full_model_layout(v["params"]), stats)
    tm = torch_float64(cfg, v)
    with torch.no_grad():
        check_levels(tm.eval()(torch.from_numpy(x)), ev, 1e-9, "eval")
        check_levels(tm.train()(torch.from_numpy(x)), tr, 1e-9, "train")
    got = pending_stats(tm)
    want = {k: s for k, s in want_stats.items() if k.endswith(("running_mean", "running_var"))}
    assert set(got) == set(want) and got
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-9 * float(w.abs().max()), err_msg=k)


def test_resnet18_fpn_gradients_match_flax(one_thread):
    """d(a fixed random projection of the train-mode p2..p6) / d(every
    parameter) through ResNet-18 + FPN, against jax.grad, float64, 1e-9 of
    each gradient's scale."""
    from weakcube_tpu_torch.utils.convert import flax_params_to_torch
    cfg, jm, v = float64_variables("resnet18")
    x, rng = X64, np.random.default_rng(6)
    with jax.enable_x64():
        out_shapes = jax.eval_shape(lambda: jm.apply(v, jnp.asarray(x)))
        proj = {k: rng.normal(size=s.shape) for k, s in out_shapes.items()}

        def loss(params, x):
            out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                              train=True, mutable=["batch_stats"])
            return sum(jnp.sum(out[k] * proj[k]) for k in proj)
        grads = jax.device_get(jax.jit(jax.grad(loss))(v["params"], jnp.asarray(x)))
    with float64_convert():
        want = flax_params_to_torch(full_model_layout(grads))
    tm = torch_float64(cfg, v).train()
    out = tm(torch.from_numpy(x))
    sum((out[k] * torch.from_numpy(p)).sum() for k, p in proj.items()).backward()
    got = {f"backbone.{n}": p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-9 * float(w.abs().max()), err_msg=k)


@pytest.mark.parametrize("trunk", list(TRUNKS))
def test_trunk_param_labels_and_freeze_bn_match_jax(trunk):
    """No compile: every parameter of each trunk + FPN sits in the group
    that the JAX package's _param_labels gives its flax counterpart, and
    freeze_bn takes out the parameters that JAX's freeze_bn zeroes (one
    eager optax update with unit gradients)."""
    import optax
    from weakcube_tpu.solver.build import _param_labels, freeze_bn as j_freeze_bn
    from weakcube_tpu_torch.solver.build import GROUPS, SGD, param_groups, param_label, freeze_bn
    from weakcube_tpu_torch.utils.convert import flax_params_to_torch
    cfg, _, v = float64_variables(trunk)
    params = full_model_layout(v["params"])
    codes = {g: float(i) for i, g in enumerate(GROUPS)}
    coded = jax.tree_util.tree_map(lambda lab, p: np.full(p.shape, codes[lab], np.float32),
                                   _param_labels(params), params)
    want = {n: GROUPS[int(x.flatten()[0])] for n, x in flax_params_to_torch(coded).items()}
    tm = t_build_backbone(cfg, torch.float32)
    got = {f"backbone.{m}.{p}": param_label(mod, p)
           for m, mod in tm.named_modules() for p, _ in mod.named_parameters(recurse=False)}
    assert got == want

    tx = j_freeze_bn(optax.sgd(1.0), params)
    ones = jax.tree_util.tree_map(np.ones_like, params)
    upd, _ = tx.update(ones, tx.init(params), params)
    frozen_want = {n for n, u in flax_params_to_torch(upd).items() if not u.any()}
    opt = freeze_bn(SGD(cfg, param_groups(tm)))
    kept = {id(p) for g in opt.param_groups for p in g["params"]}
    frozen_got = {f"backbone.{n}" for n, p in tm.named_parameters() if id(p) not in kept}
    assert frozen_got == frozen_want and frozen_got
