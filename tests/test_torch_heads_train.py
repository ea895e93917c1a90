"""The training forward of both ROI heads of weakcube_tpu_torch against the
JAX modules, alone (no backbone), in float64.

The JAX `ROIHeads3D` / `ROIHeads3DScore` (float64 compute under
jax.enable_x64) and the port's heads get the same numpy weights (drawn into
flax's shapes, converted by flax_to_torch, float64 in both), the same
random FPN features, the same GT (random rotations, not tiny_batch's
identity poses) and the same injected SampledRois (each package's
module-level label_and_sample_proposals patched, as
tests/test_torch_train.py::port_step does). The JAX heads pool through the
gather forward differentiated by autodiff (TPU.ROI_ALIGN_TRAIN_FWD "gather",
ROI_ALIGN_TRAIN_BWD "autodiff"), exact in float64 (the default matmul plan
accumulates its gradient in float32), compiled without XLA's algebraic
simplifier (COMPILER_OPTIONS). The priors are float32 values, as both
packages store them. Every loss, every metric, and
the gradient of the summed losses with respect to every head parameter
and every feature level are held to JAX within 1e-9 of each tensor's
scale (its largest |entry|). Cube/IoU3D (exact polytope clipping, which
doubles JAX's compile time) is compared in the default supervised variant
and left uncomputed by both elsewhere. The weak head's loss keys must equal
JAX's when the batch lacks depth maps or instance masks (its skip
conditions).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import random_variables
from weakcube_tpu.config import get_cfg as j_get_cfg
from weakcube_tpu.config.config import StaticCfg
from weakcube_tpu.models import roi_heads as j_rh
from weakcube_tpu.ops import rotations as j_rot
from weakcube_tpu.structures import GroundTruth as JGroundTruth
from weakcube_tpu.structures import Proposals as JProposals
from weakcube_tpu.structures import SampledRois as JSampledRois
from weakcube_tpu_torch.config import get_cfg as t_get_cfg
from weakcube_tpu_torch.models import roi_heads as t_rh
from weakcube_tpu_torch.structures import GroundTruth, Proposals, SampledRois
from weakcube_tpu_torch.utils import convert

B, G, S, SIZE, C, NCLS, FC, BINS = 2, 6, 16, 64, 8, 5, 32, 3
STRIDES = (4, 8, 16, 32, 64)
RTOL = 1e-9
# XLA's algebraic simplifier turns a division by a constant into a product
# with its reciprocal: the pooler's sample grid (i + 0.5) / 14, float32 in
# both packages, would move by an ulp and the pooled features by ~1e-7 of
# scale; without it XLA divides as the source (and JAX op by op) does. The
# backend's optimisation level 0 compiles faster and changes no rounding.
COMPILER_OPTIONS = {"xla_disable_hlo_passes": "algsimp", "xla_backend_optimization_level": 0}
WEAK_LOSSES = ["iou", "z", "z_pseudo_gt_patch", "z_pseudo_gt_center", "pose_alignment",
               "pose_ground", "dims", "depth", "segmentation"]

SUPERVISED = {
    "default": {},                                   # disentangled, chamfer, joint
    "l1_pose_inverse_z": {"CHAMFER_POSE": False, "INVERSE_Z_WEIGHT": True},
    "direct": {"DISENTANGLED_LOSS": False},
    "sigmoid": {"DISENTANGLED_LOSS": False, "Z_TYPE": "sigmoid"},
    "log": {"DISENTANGLED_LOSS": False, "Z_TYPE": "log", "DIMS_PRIORS_ENABLED": False},
    "clusters": {"DISENTANGLED_LOSS": False, "Z_TYPE": "clusters", "CLUSTER_BINS": BINS},
    "2d_only": {"LOSS_W_3D": 0.0},
}


def t(x):
    return torch.from_numpy(np.array(x))


def make_cfg(get_cfg, cube: dict, losses=None):
    cfg = get_cfg()
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = NCLS
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = S
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = FC
    cfg.MODEL.ROI_CUBE_HEAD.FC_DIM = FC
    cfg.TPU.IMAGE_SIZE = SIZE
    # the JAX heads' exact float64 pooling plan: the gather forward and its
    # autodiff
    cfg.TPU.ROI_ALIGN_TRAIN_FWD, cfg.TPU.ROI_ALIGN_TRAIN_BWD = "gather", "autodiff"
    for k, v in cube.items():
        setattr(cfg.MODEL.ROI_CUBE_HEAD, k, v)
    if losses is not None:
        cfg.loss_functions = list(losses)
    cfg.freeze()
    return cfg


def random_rotations(rng, n):
    with jax.enable_x64():
        return np.asarray(j_rot.rotation_6d_to_matrix(jnp.asarray(rng.normal(size=(n, 6)))))


def inputs(seed=0):
    """Features, GT with 3D boxes and random poses, RoIs (the fg ones in
    the first S/4 slots, as the sampler packs them), K, image sizes, depth
    maps, cached normals and per-GT instance masks, all numpy."""
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(B, SIZE // s, SIZE // s, C)) for s in STRIDES]
    x1 = rng.uniform(2, SIZE - 24, (B, G))
    y1 = rng.uniform(2, SIZE - 24, (B, G))
    w, h = rng.uniform(8, 22, (B, G)), rng.uniform(8, 22, (B, G))
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1)
    K = np.tile(np.array([[60.0, 0, SIZE / 2], [0, 64.0, SIZE / 2], [0, 0, 1]]), (B, 1, 1))
    z = rng.uniform(2, 8, (B, G))
    cx, cy = x1 + w / 2 + rng.normal(0, 1, (B, G)), y1 + h / 2 + rng.normal(0, 1, (B, G))
    boxes3D = np.concatenate([np.stack([cx, cy, z], -1), rng.uniform(0.3, 1.5, (B, G, 3)),
                              np.stack([z * (cx - SIZE / 2) / 60.0, z * (cy - SIZE / 2) / 64.0,
                                        z], -1)], -1)
    gt = dict(boxes=boxes, classes=rng.integers(0, NCLS, (B, G)),
              valid=np.tile(np.arange(G) < 5, (B, 1)), boxes3D=boxes3D,
              poses=random_rotations(rng, B * G).reshape(B, G, 3, 3))
    n_fg = np.array([4, 3])
    gt_idx = rng.integers(0, 5, (B, S))
    fg = np.arange(S)[None] < n_fg[:, None]
    roi_boxes = np.where(fg[..., None], boxes[np.arange(B)[:, None], gt_idx]
                         + rng.normal(0, 2, (B, S, 4)), 0.0)
    bx = rng.uniform(0, SIZE - 20, (B, S, 2))
    roi_boxes = np.where(fg[..., None], roi_boxes,
                         np.concatenate([bx, bx + rng.uniform(4, 20, (B, S, 2))], -1))
    valid = np.ones((B, S), bool)
    valid[1, -1] = False
    rois = dict(boxes=roi_boxes, classes=np.where(fg, gt["classes"][np.arange(B)[:, None],
                                                                    gt_idx], NCLS),
                gt_idx=gt_idx, fg=fg, valid=valid)
    n = rng.normal(size=(B, 3))
    n[:, 1] = np.abs(n[:, 1]) + 1.0
    masks = rng.uniform(size=(B, G, 16, 16)) < 0.4
    masks[0, gt_idx[0, 0]] = False                    # an empty mask: the whole GT box
    extra = dict(depth_maps=rng.uniform(1, 10, (B, SIZE, SIZE)),
                 ground_normals=n / np.linalg.norm(n, axis=1, keepdims=True),
                 ground_normal_valid=np.array([True, False]), instance_masks=masks)
    priors = dict(dims=np.tile(np.array([[[0.8, 0.7, 0.9], [0.3, 0.25, 0.35]]]), (NCLS, 1, 1)),
                  z_scales=rng.uniform(10, 40, (NCLS, BINS)),
                  z_stats=np.stack([rng.uniform(2, 8, (NCLS, BINS)),
                                    rng.uniform(0.5, 2, (NCLS, BINS))], -1))
    priors = {k: v.astype(np.float32).astype(np.float64) for k, v in priors.items()}
    return dict(feats=feats, gt=gt, rois=rois, K=K, wh=np.tile([[SIZE, SIZE]], (B, 1)) * 1.0,
                extra=extra, priors=priors)


def jax_run(weak: bool, cube: dict, x: dict, extra: dict, losses=None, keys_only=False,
            iou3d=False):
    """The JAX head's losses, metrics and gradients (of the summed losses)
    with respect to its parameters and the features; its parameters.
    keys_only: the names of the losses and metrics alone. iou3d False: the
    Cube/IoU3D metric reads NaN, uncomputed."""
    cfg = make_cfg(j_get_cfg, cube, losses)
    cls = j_rh.ROIHeads3DScore if weak else j_rh.ROIHeads3D
    with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
        if not iou3d:
            mp.setattr(j_rh, "iou3d_train_metric", lambda *a, **k: jnp.asarray(jnp.nan))
        # jnp priors: the normalised-space branch indexes self.dims_priors with
        # traced classes (weakcube_tpu/models/roi_heads.py:977), which the
        # numpy priors that JAX's build_model passes refuse
        pri = {k: jnp.asarray(v) for k, v in x["priors"].items()}
        clusters = cfg.MODEL.ROI_CUBE_HEAD.CLUSTER_BINS > 1
        module = cls(cfg=StaticCfg(cfg), num_classes=NCLS, dims_priors=pri["dims"],
                     z_scales=pri["z_scales"] if clusters else None,
                     z_stats=pri["z_stats"] if clusters else None, dtype=jnp.float64)
        rois = JSampledRois(**{k: jnp.asarray(v) for k, v in x["rois"].items()})
        mp.setattr(j_rh, "label_and_sample_proposals", lambda *a, **k: rois)
        feats = {f"p{i + 2}": jnp.asarray(f) for i, f in enumerate(x["feats"])}
        gt = JGroundTruth(**{k: jnp.asarray(v) for k, v in x["gt"].items()})
        props = JProposals(jnp.zeros((B, 4, 4)), jnp.zeros((B, 4)), jnp.zeros((B, 4), bool))
        kw = {k: jnp.asarray(v) for k, v in extra.items()}
        key = jax.random.PRNGKey(0)

        def apply(params, feats):
            losses, metrics = module.apply({"params": params}, feats, props, gt,
                                           jnp.asarray(x["K"]), jnp.asarray(x["wh"]),
                                           train=True, rng=key, **kw)
            return sum(losses.values()), (losses, metrics)
        shapes = jax.eval_shape(lambda: module.init(key, feats, props, gt, jnp.asarray(x["K"]),
                                                    jnp.asarray(x["wh"]), train=True,
                                                    rng=key, **kw))
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                        random_variables(shapes["params"], seed=3))
        if keys_only:  # traced, not compiled
            _, (losses, metrics) = jax.eval_shape(apply, params, feats)
            return dict(losses=set(losses), metrics=set(metrics), params=params)
        fn = jax.jit(jax.value_and_grad(apply, argnums=(0, 1), has_aux=True))
        (_, (losses, metrics)), (gp, gf) = fn.lower(params, feats).compile(
            compiler_options=COMPILER_OPTIONS)(params, feats)
        return jax.device_get(dict(losses=losses, metrics=metrics, grad_params=gp,
                                   grad_feats=gf, params=params))


def port_run(weak: bool, cube: dict, x: dict, extra: dict, params, losses=None,
             iou3d=False):
    cfg = make_cfg(t_get_cfg, cube, losses)
    cls = t_rh.ROIHeads3DScore if weak else t_rh.ROIHeads3D
    clusters = cfg.MODEL.ROI_CUBE_HEAD.CLUSTER_BINS > 1
    pri = x["priors"]
    head = cls(cfg, NCLS, C, pri["dims"], pri["z_scales"] if clusters else None,
               pri["z_stats"] if clusters else None)
    # the 2D-only JAX head never calls its cube head, so has no weights for it
    missing, unexpected = head.load_state_dict(state_dict_of(params), strict=False)
    assert not unexpected and all(k.startswith("cube_head.") for k in missing)
    assert not missing or cfg.MODEL.ROI_CUBE_HEAD.LOSS_W_3D == 0
    head.double()
    rois = SampledRois(*(t(x["rois"][k]) for k in SampledRois._fields))
    rois = rois._replace(classes=rois.classes.long(), gt_idx=rois.gt_idx.long())
    feats = {f"p{i + 2}": t(f).requires_grad_(True) for i, f in enumerate(x["feats"])}
    g = x["gt"]
    gt = GroundTruth(t(g["boxes"]), t(g["classes"]).long(), t(g["valid"]), t(g["boxes3D"]),
                     t(g["poses"]))
    props = Proposals(torch.zeros((B, 4, 4)), torch.zeros((B, 4)),
                      torch.zeros((B, 4), dtype=torch.bool))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_rh, "label_and_sample_proposals", lambda *a, **k: rois)
        out_losses, metrics = head.forward_train(
            feats, props, gt, t(x["K"]), t(x["wh"]), torch.Generator(), metrics_tick=iou3d,
            **{k: t(v) for k, v in extra.items()})
    sum(out_losses.values()).backward()
    return dict(losses=out_losses, metrics=metrics,
                grad_params={n: p.grad for n, p in head.named_parameters()},
                grad_feats=[feats[f"p{i + 2}"].grad for i in range(len(STRIDES))])


def state_dict_of(params):
    sd = convert.flax_to_torch({"roi_heads": params}, {})
    return {k[len("roi_heads."):]: v for k, v in sd.items()}


def within(got, want, what):
    got = torch.zeros(np.shape(want), dtype=torch.float64) if got is None else got
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-300)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= RTOL * scale, f"{what}: max |err| {err:.3e}, scale {scale:.3e}"


def compare(j, p):
    assert set(p["losses"]) == set(j["losses"])
    assert set(p["metrics"]) == set(j["metrics"])
    for kind in ("losses", "metrics"):
        for k, v in j[kind].items():
            if k == "Cube/IoU3D" and np.isnan(v):  # uncomputed in both
                assert torch.isnan(p[kind][k])
                continue
            assert np.isfinite(v), (kind, k, v)
            within(p[kind][k], v, k)
    with pytest.MonkeyPatch.context() as mp:
        # the gradients in float64 (flax_params_to_torch rounds to float32)
        mp.setattr(convert, "_t", lambda a: torch.from_numpy(np.array(a, np.float64)))
        want = {k[len("roi_heads."):]: v
                for k, v in convert.flax_params_to_torch({"roi_heads": j["grad_params"]}).items()}
    assert set(want) <= set(p["grad_params"])
    assert all(p["grad_params"][k] is None for k in set(p["grad_params"]) - set(want))
    for k, v in want.items():
        within(p["grad_params"][k], v, f"d/d {k}")
    for i, (a, b) in enumerate(zip(p["grad_feats"], j["grad_feats"].values())):
        within(a, b, f"d/d p{i + 2}")


@pytest.fixture(scope="module")
def x():
    """The inputs, and one torch thread (small shapes; test workers run
    side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield inputs()
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant", list(SUPERVISED))
def test_supervised_head_f64(x, variant):
    cube, iou3d = SUPERVISED[variant], variant == "default"
    j = jax_run(False, cube, x, {}, iou3d=iou3d)
    p = port_run(False, cube, x, {}, j["params"], iou3d=iou3d)
    compare(j, p)
    cube_keys = {k for k in j["losses"] if k.startswith("Cube/")}
    if variant == "2d_only":
        assert not cube_keys and set(j["metrics"]) == {"roi_head/num_fg_samples"}
    else:
        assert {"Cube/loss_z", "Cube/loss_xy", "Cube/loss_dims", "Cube/loss_pose",
                "Cube/loss_joint", "Cube/uncert"} == cube_keys


@pytest.mark.parametrize("data", ["all", "no_depth", "nothing"])
def test_weak_head_all_losses_f64(x, data):
    """Every weak loss (z_pseudo_gt_patch wins over z_pseudo_gt_center)
    with per-GT masks and depth maps: held to JAX. Without depth maps
    (z_pseudo_gt_* and depth drop out; pose_ground keeps the cached
    normals), and without depth maps, masks or normals (segmentation and
    pose_ground drop out too): the same loss and metric names as JAX's,
    every loss finite. depth_range_loss without masks is held to JAX at op
    level (tests/test_torch_train_ops.py)."""
    extra = dict(x["extra"])
    if data in ("no_depth", "nothing"):
        extra.pop("depth_maps")
    if data == "nothing":
        extra.pop("instance_masks")
    if data == "nothing":
        extra.pop("ground_normals")
        extra.pop("ground_normal_valid")
    keys_only = data != "all"
    j = jax_run(True, {}, x, extra, WEAK_LOSSES, keys_only=keys_only)
    p = port_run(True, {}, x, extra, j["params"], WEAK_LOSSES)
    if data == "all":
        assert {"Cube/loss_iou", "Cube/loss_pose", "Cube/loss_normal_vec", "Cube/loss_z",
                "Cube/loss_pseudo_gt_z", "Cube/loss_dims_w", "Cube/loss_depth",
                "Cube/loss_seg"} <= set(j["losses"])
    if not keys_only:
        compare(j, p)
        return
    assert set(p["losses"]) == j["losses"] and set(p["metrics"]) == j["metrics"]
    assert all(torch.isfinite(v) for v in p["losses"].values())
    dropped = {"no_depth": {"Cube/loss_pseudo_gt_z", "Cube/loss_depth"},
               "nothing": {"Cube/loss_seg", "Cube/loss_normal_vec", "Cube/loss_pseudo_gt_z",
                           "Cube/loss_depth"}}[data]
    assert not dropped & j["losses"] and "Cube/loss_z" in j["losses"]
