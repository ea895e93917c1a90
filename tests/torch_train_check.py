"""The small training step on the card against the same step on the CPU (no
JAX): used by tests/test_torch_cuda.py and chip_smoke.py.

At tiny_cfg(128, dla=True), float32, the same seeded weights and batch on
both devices, one of three steps (KINDS): the flagship's weak step with the
recipe's losses ("weak"); the supervised Cube R-CNN step (RCNN3D +
ROIHeads3D, GT poses drawn at random: "supervised"); the weak step with
every loss (the default loss_functions, iou and segmentation, per-GT masks
filled from the GT boxes: "all_losses"). The anchor labels and the sampled RoIs
are drawn once, on the CPU, with the port's own samplers (a CUDA generator
draws other numbers than a CPU one) and injected into every run.

The step is ill-conditioned in float32 at this size (tests/test_torch_train.py):
the card's and the CPU's float32 sums, taken in other orders, move the
deepest gradients by far more than rounding. So each loss, gradient and
updated parameter must lie within a margin (1e-4 of the tensor's scale;
1e-5 for the parameters) plus three times the distance between the CPU's
float32 value and the exact one, which is the same step in float64 on the
CPU. A config may change the backbone or the optimizer; after an update of
the Adam family, whose size does not follow the gradient's, the parameters
are held to that update applied on the CPU to the card's own gradients.
"""
import numpy as np
import torch

from weakcube_tpu_torch.entry import dims_priors, tiny_batch, tiny_cfg
from weakcube_tpu_torch.models import roi_heads, rpn
from weakcube_tpu_torch.models.rcnn3d import build_model
from weakcube_tpu_torch.ops import roi_align_cuda
from weakcube_tpu_torch.ops.rotations import rotation_6d_to_matrix
from weakcube_tpu_torch.parallel.train_step import create_train_state, train_step


KINDS = ("weak", "supervised", "all_losses")
ALL_LOSSES = ["dims", "pose_alignment", "pose_ground", "iou", "z", "z_pseudo_gt_patch", "depth",
              "segmentation"]


def _cfg(kind="weak", dla=True):
    cfg = tiny_cfg(128, dla=dla).clone()
    cfg.defrost()
    cfg.SOLVER.WARMUP_FACTOR = 1.0
    if kind == "supervised":
        cfg.MODEL.META_ARCHITECTURE = "RCNN3D"
        cfg.MODEL.ROI_HEADS.NAME = "ROIHeads3D"
    elif kind == "all_losses":
        cfg.loss_functions = list(ALL_LOSSES)
    cfg.freeze()
    return cfg


def with_random_poses(batch: dict, seed: int = 0) -> dict:
    """The batch with GT rotations drawn from a numpy seed (tiny_batch's
    are the identity)."""
    gt = batch["gt"]
    d6 = np.random.default_rng(seed).normal(size=tuple(gt.poses.shape[:-2]) + (6,))
    R = rotation_6d_to_matrix(torch.from_numpy(d6)).to(gt.poses.device, gt.poses.dtype)
    return dict(batch, gt=gt._replace(poses=R))


def with_box_masks(batch: dict, size: int = 64) -> dict:
    """The batch with per-GT instance masks (B, G, size, size) over the
    image frame: the pixels whose centres the GT box covers."""
    boxes, wh = batch["gt"].boxes, batch["image_wh"]
    c = (torch.arange(size, device=boxes.device, dtype=boxes.dtype) + 0.5) / size
    xs = (c * wh[:, 0:1])[:, None, None, :]                       # (B, 1, 1, size)
    ys = (c * wh[:, 1:2])[:, None, :, None]
    b = boxes[..., None, None, :]
    masks = (xs >= b[..., 0]) & (xs <= b[..., 2]) & (ys >= b[..., 1]) & (ys <= b[..., 3])
    return dict(batch, instance_masks=masks)


def kind_batch(kind: str, B: int, size: int, G: int = 8, device=None) -> dict:
    """tiny_batch(B, size, size, G) as the step of `kind` takes it."""
    batch = tiny_batch(B, size, size, G=G, seed=0, device=device)
    if kind == "supervised":
        batch = with_random_poses(batch)
    elif kind == "all_losses":
        batch = with_box_masks(batch)
    return batch


def _moved(x, device, dtype):
    """x (a tensor or a NamedTuple of tensors) on device, float64 where
    dtype is float64."""
    if isinstance(x, tuple):
        return type(x)(*(_moved(v, device, dtype) for v in x))
    x = x.to(device)
    return x.to(dtype) if dtype == torch.float64 and x.is_floating_point() else x


def _step(device, dtype, samples=None, kind="weak", cfg=None):
    """One train_step of the small model (of cfg where given, else of
    _cfg(kind)). samples: (rpn_labels, rois) to inject; None draws them (on
    the CPU) and returns them. Returns the logs, the gradients, the state
    dict after the step and the samples."""
    cfg = cfg or _cfg(kind)
    model = build_model(cfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), device=device,
                        seed=1, dtype=dtype)
    state, opt = create_train_state(cfg, model)
    batch = kind_batch(kind, 2, 128, device=device)
    drawn = {}
    sample_anchors, sample_rois = rpn.label_and_sample_anchors, roi_heads.label_and_sample_proposals
    if samples is None:
        def anchors(*a, **k):
            drawn["rpn"] = sample_anchors(*a, **k)
            return drawn["rpn"]

        def rois(*a, **k):
            drawn["rois"] = sample_rois(*a, **k)
            return drawn["rois"]
    else:
        batch["rpn_labels"] = _moved(samples[0], device, dtype)
        fixed = _moved(samples[1], device, dtype)
        anchors, rois = sample_anchors, lambda *a, **k: fixed
    rpn.label_and_sample_anchors, roi_heads.label_and_sample_proposals = anchors, rois
    try:
        state, logs = train_step(model, opt, state, batch,
                                 torch.Generator(device=device).manual_seed(0))
    finally:
        rpn.label_and_sample_anchors, roi_heads.label_and_sample_proposals = (sample_anchors,
                                                                              sample_rois)
    assert state.applied == 1, f"the step was skipped: {logs}"
    grads = {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()}
    params = {k: v.detach().cpu().double() for k, v in model.state_dict().items()
              if v.is_floating_point()}
    return logs, grads, params, samples or (drawn["rpn"], drawn["rois"])


def _replayed_update(cfg, grads) -> dict:
    """The parameters after one update of cfg's optimizer from the small
    model's initial weights, on the CPU in float64, with the given
    gradients."""
    model = build_model(cfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), device="cpu",
                        seed=1).double()
    _, opt = create_train_state(cfg, model)
    for n, p in model.named_parameters():
        p.grad = grads[n].clone()
    opt.step()
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _heads_reach_fpn(card) -> float:
    """|d(heads' losses) / d(p2 output conv)| on the card, with K1-bwd
    launched once per pooler; 0 would mean the pooler passes no gradient."""
    cfg = _cfg()
    model = build_model(cfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), device=card, seed=1)
    model.train().requires_grad_(True)
    before = roi_align_cuda.roi_align_backward.launches
    losses, _ = model(tiny_batch(2, 128, 128, seed=0, device=card),
                      torch.Generator(device=card).manual_seed(0))
    heads = sum(v for k, v in losses.items() if not k.startswith("rpn/"))
    (g,) = torch.autograd.grad(heads, [model.backbone.fpn_output2.weight])
    torch.cuda.synchronize()
    launched = roi_align_cuda.roi_align_backward.launches - before
    assert launched == 2, f"K1-bwd launched {launched} times, expected 2 (box and cube pooler)"
    return float(g.abs().sum())


def _check(got, want, exact, margin, name):
    bound = margin * max(float(want.abs().max()), 1e-3) + 3 * float((want - exact).abs().max())
    err = float((got - want).abs().max())
    assert err <= bound, f"{name}: card vs CPU max |err| {err:.4e} > bound {bound:.4e}"
    return err / max(float(want.abs().max()), 1e-12)


def train_step_card_vs_cpu(card, kind="weak", cfg=None) -> dict:
    """Raises AssertionError on a disagreement; returns what was compared
    and the largest relative error of each kind. cfg, where given, is a
    variant of _cfg(kind) (another backbone or SOLVER.TYPE) whose step
    takes kind's batch. The weak step of _cfg also checks that the heads'
    gradient reaches the FPN on the card."""
    logs, grads, params, samples = _step("cpu", torch.float32, kind=kind, cfg=cfg)
    logs64, grads64, params64, _ = _step("cpu", torch.float64, samples, kind, cfg)
    launches = roi_align_cuda.roi_align_backward.launches
    logs_c, grads_c, params_c, _ = _step(card, torch.float32, samples, kind, cfg)
    assert roi_align_cuda.roi_align_backward.launches == launches + 2
    worst = {"losses": 0.0, "grads": 0.0, "params": 0.0}
    for k in logs:
        worst["losses"] = max(worst["losses"], _check(
            torch.tensor(logs_c[k]), torch.tensor(logs[k]), torch.tensor(logs64[k]), 1e-4, k))
    for n in grads:
        worst["grads"] = max(worst["grads"], _check(grads_c[n], grads[n], grads64[n], 1e-4, n))
    # SGD's update is linear in the gradient, so the bound on the gradients
    # carries over to the parameters. Adam's divides each gradient by its
    # own magnitude: a gradient far below its float32 noise (the order of
    # the sums) moves its parameter by about +-lr either way. So after an
    # Adam update the parameters are held to the same update applied on the
    # CPU, in float64, to the card's own gradients; the BatchNorm statistics
    # (the forward's) to the bound above.
    replayed = None if (cfg or _cfg(kind)).SOLVER.TYPE == "sgd" else \
        _replayed_update(cfg or _cfg(kind), grads_c)
    for n in params:
        if replayed is not None and n in replayed:
            err = _check(params_c[n], replayed[n], replayed[n], 1e-5, n)
        else:
            err = _check(params_c[n], params[n], params64[n], 1e-5, n)
        worst["params"] = max(worst["params"], err)
    out = dict(n_losses=len(logs), n_grads=len(grads), n_params=len(params), worst_rel=worst)
    if replayed is not None:
        # the bound that holds SGD's parameters, read here for the record
        out["sgd_bound_excess"] = max(
            float((params_c[n] - params[n]).abs().max()) / (
                1e-5 * max(float(params[n].abs().max()), 1e-3)
                + 3 * float((params[n] - params64[n]).abs().max())) for n in replayed)
    if kind == "weak" and cfg is None:
        out["heads_to_fpn_grad"] = _heads_reach_fpn(card)
        assert out["heads_to_fpn_grad"] > 0, "the FPN gets no gradient from the ROI heads"
    return out
