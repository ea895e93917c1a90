"""The small training step on the card against the same step on the CPU (no
JAX): used by tests/test_torch_cuda.py and chip_smoke.py.

The flagship meta-arch at tiny_cfg(128, dla=True), float32, the same seeded
weights and batch on both devices. The anchor labels and the sampled RoIs
are drawn once, on the CPU, with the port's own samplers (a CUDA generator
draws other numbers than a CPU one) and injected into every run.

The step is ill-conditioned in float32 at this size (tests/test_torch_train.py):
the card's and the CPU's float32 sums, taken in other orders, move the
deepest gradients by far more than rounding. So each loss, gradient and
updated parameter must lie within a margin (1e-4 of the tensor's scale;
1e-5 for the parameters) plus three times the distance between the CPU's
float32 value and the exact one, which is the same step in float64 on the
CPU.
"""
import torch

from weakcube_tpu_torch.entry import dims_priors, tiny_batch, tiny_cfg
from weakcube_tpu_torch.models import roi_heads, rpn
from weakcube_tpu_torch.models.rcnn3d import build_model
from weakcube_tpu_torch.ops import roi_align_cuda
from weakcube_tpu_torch.parallel.train_step import create_train_state, train_step


def _cfg():
    cfg = tiny_cfg(128, dla=True).clone()
    cfg.defrost()
    cfg.SOLVER.WARMUP_FACTOR = 1.0
    cfg.freeze()
    return cfg


def _moved(x, device, dtype):
    """x (a tensor or a NamedTuple of tensors) on device, float64 where
    dtype is float64."""
    if isinstance(x, tuple):
        return type(x)(*(_moved(v, device, dtype) for v in x))
    x = x.to(device)
    return x.to(dtype) if dtype == torch.float64 and x.is_floating_point() else x


def _step(device, dtype, samples=None):
    """One train_step of the small model. samples: (rpn_labels, rois) to
    inject; None draws them (on the CPU) and returns them. Returns the logs,
    the gradients, the state dict after the step and the samples."""
    cfg = _cfg()
    model = build_model(cfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), device=device,
                        seed=1, dtype=dtype)
    state, opt = create_train_state(cfg, model)
    batch = tiny_batch(2, 128, 128, seed=0, device=device)
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


def train_step_card_vs_cpu(card) -> dict:
    """Raises AssertionError on a disagreement; returns what was compared
    and the largest relative error of each kind."""
    logs, grads, params, samples = _step("cpu", torch.float32)
    logs64, grads64, params64, _ = _step("cpu", torch.float64, samples)
    launches = roi_align_cuda.roi_align_backward.launches
    logs_c, grads_c, params_c, _ = _step(card, torch.float32, samples)
    assert roi_align_cuda.roi_align_backward.launches == launches + 2
    worst = {"losses": 0.0, "grads": 0.0, "params": 0.0}
    for k in logs:
        worst["losses"] = max(worst["losses"], _check(
            torch.tensor(logs_c[k]), torch.tensor(logs[k]), torch.tensor(logs64[k]), 1e-4, k))
    for kind, c, cpu, exact, margin in (("grads", grads_c, grads, grads64, 1e-4),
                                        ("params", params_c, params, params64, 1e-5)):
        for n in cpu:
            worst[kind] = max(worst[kind], _check(c[n], cpu[n], exact[n], margin, n))
    fpn = _heads_reach_fpn(card)
    assert fpn > 0, "the FPN gets no gradient from the ROI heads"
    return dict(n_losses=len(logs), n_grads=len(grads), n_params=len(params),
                worst_rel=worst, heads_to_fpn_grad=fpn)
