"""The weak training step of weakcube_tpu_torch against weakcube_tpu.

The flagship meta-arch (RCNN3D_combined_features + ROIHeads3DScore, DLA-34 +
FPN) at __graft_entry__._tiny_cfg(dla=True), B = 2, with
SOLVER.WARMUP_FACTOR 1.0. Both packages get the same numpy weights (drawn
into flax's variable shapes, converted by flax_to_torch), the same batch
(__graft_entry__._tiny_batch and its port entry.tiny_batch), the anchor
labels of JAX's make_anchor_labeler as batch["rpn_labels"], and the RoIs
that JAX's own label_and_sample_proposals drew in each step (captured from
its trace; the port's module-level label_and_sample_proposals is patched
to return them).

On the CPU the JAX heads pool with the matmul plan (`pallas` resolves to it
off the TPU) and differentiate through matmul_bwd; the port pools with the
gather and scatters its gradient. Both are exact up to rounding.

Why float64: at this size the step is ill-conditioned in float32.
Train-mode BatchNorm over 32 values per channel (DLA level 5 at 128 px,
B = 2) in a random-weight trunk amplifies rounding: JAX's own float32
gradients of the deepest layers differ from its float64 gradients by up to
~11%. This file holds the algorithm to the reference with both packages
computing in float64 (parameters float32), at 64 px (XLA's float64
convolutions on the CPU take ~33 s per step at 128 px), over two whole
steps: every loss and metric, every gradient, and the parameters and
BatchNorm statistics after each step, to 1e-5 of each tensor's scale
(parameters and their gradients are float32, accumulated over each
weight's uses in another order). The second step runs on the parameters,
running statistics, momentum and schedule the first left. The optimizer
alone (momentum, weight decay, the bias/norm groups, the schedule) is also
held to optax's by replaying the same two gradients through both.
test_torch_train_f32.py holds the float32 and bfloat16 steps at 128 px.
Cube/IoU3D is not ported and not compared.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from weakcube_tpu.models import rcnn3d as j_rcnn3d
from weakcube_tpu.models import roi_heads as j_roi_heads
from weakcube_tpu.solver.build import _param_labels, build_optimizer as j_build_optimizer
from weakcube_tpu_torch.entry import dims_priors, tiny_batch, tiny_cfg
from weakcube_tpu_torch.models import roi_heads as t_roi_heads
from weakcube_tpu_torch.models import rpn as t_rpn
from weakcube_tpu_torch.models.rcnn3d import build_model as t_build_model
from weakcube_tpu_torch.parallel.train_step import create_train_state, train_step
from weakcube_tpu_torch.solver.build import GROUPS, param_label
from weakcube_tpu_torch.structures import SampledRois
from weakcube_tpu_torch.utils.convert import flax_params_to_torch, flax_to_torch
from test_torch_model import random_variables

B, SIZE, NCLS = 2, 128, 5
SIZE_F64 = 64  # see above


def with_solver(cfg):
    cfg = cfg.clone()
    cfg.defrost()
    cfg.SOLVER.WARMUP_FACTOR = 1.0
    cfg.SOLVER.BASE_LR = 1e-4  # the default 1e-3 makes random weights diverge in step 2
    cfg.freeze()
    return cfg


def t(x):
    return torch.from_numpy(np.array(x))


def jax_steps(dtype, steps, rois=None, grads=True, size=SIZE):
    """JAX value_and_grad and optax's update (build_optimizer) for `steps`
    steps (nothing diverges here). rois: per step the SampledRois to train
    on instead of sampling. Returns the initial variables, the batch, and
    per step the losses, metrics, gradients, RoIs and the variables after
    the update. grads=False runs the training forward alone (losses,
    metrics and RoIs)."""
    jcfg = with_solver(graft._tiny_cfg(size, NCLS, dla=True))
    jm = j_rcnn3d.build_model(jcfg, dims_priors(NCLS), dtype=dtype)
    batch = graft._tiny_batch(B, size, size)
    batch["rpn_labels"] = j_rcnn3d.make_anchor_labeler(jcfg)(jax.random.PRNGKey(7), batch["gt"])
    given, captured = [None], []
    sample = j_roi_heads.label_and_sample_proposals

    def capture(*a, **k):
        captured.append(sample(*a, **k) if given[0] is None else given[0])
        return captured[-1]

    def loss_fn(params, bs, rng, step_rois):
        captured.clear()
        given[0] = step_rois
        (losses, metrics), mut = jm.apply({"params": params, "batch_stats": bs}, batch,
                                          train=True, rng=rng, mutable=["batch_stats"])
        total = jnp.sum(jnp.stack(list(losses.values())))
        return total, (losses, metrics, mut["batch_stats"], captured[-1])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_roi_heads, "label_and_sample_proposals", capture)
        if dtype == jnp.float64:  # its polytope clipping does not trace in float64
            mp.setattr(j_roi_heads, "iou3d_train_metric", lambda *a, **k: jnp.float32(jnp.nan))
        shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, batch,
                                                train=True, rng=jax.random.PRNGKey(1)))
        v = random_variables(shapes, seed=1)
        if not grads:
            fwd = jax.jit(loss_fn)
            out = []
            for i in range(steps):
                aux = fwd(v["params"], v["batch_stats"], jax.random.PRNGKey(100 + i),
                          None if rois is None else rois[i])[1]
                out.append(jax.device_get(dict(zip(("losses", "metrics", "batch_stats", "rois"),
                                                   aux))))
            return v, batch, out
        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        tx = j_build_optimizer(jcfg, v["params"])
        update = jax.jit(lambda g, o, p: tx.update(g, o, p))
        params, bs, opt = v["params"], v["batch_stats"], tx.init(v["params"])
        out = []
        for i in range(steps):
            (_, (losses, metrics, bs, sampled)), grads = grad_fn(
                params, bs, jax.random.PRNGKey(100 + i), None if rois is None else rois[i])
            upd, opt = update(grads, opt, params)
            params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
            out.append(jax.device_get(dict(losses=losses, metrics=metrics, grads=grads,
                                           rois=sampled, params=params, batch_stats=bs)))
    return v, batch, out


def port_setup(v, batch_j, dtype, size=SIZE):
    """The port's model on JAX's weights, its optimizer and TrainState, and
    the batch with JAX's anchor labels."""
    cfg = with_solver(tiny_cfg(size, NCLS, dla=True))
    tm = t_build_model(cfg, dims_priors(NCLS), device="cpu", dtype=dtype)
    tm.load_state_dict(flax_to_torch(v["params"], v["batch_stats"]))
    state, opt = create_train_state(cfg, tm)
    batch = tiny_batch(B, size, size, device="cpu")
    lab = batch_j["rpn_labels"]
    batch["rpn_labels"] = t_rpn.RPNLabels(t(lab.labels), t(lab.matched_boxes),
                                          t(lab.matched_ious))
    return tm, opt, state, batch


def port_step(tm, opt, state, batch, r):
    """One train_step with the RoIs r injected. Returns the state and the
    logs, the gradients and the state dict after the step."""
    step_rois = SampledRois(t(r.boxes), t(r.classes).long(), t(r.gt_idx).long(), t(r.fg),
                            t(r.valid))
    applied = state.applied
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_roi_heads, "label_and_sample_proposals", lambda *a, **k: step_rois)
        state, logs = train_step(tm, opt, state, batch, torch.Generator().manual_seed(state.step))
    assert state.applied == applied + 1, f"step {state.step} was skipped: {logs}"
    return state, dict(logs=logs, grads={n: p.grad.clone() for n, p in tm.named_parameters()},
                       state_dict={k: x.clone() for k, x in tm.state_dict().items()})


def port_steps(v, batch_j, rois, dtype, steps, size=SIZE):
    """The port's train_step on the same weights and batch, with JAX's anchor
    labels and RoIs injected. Returns the model, the final state, and per
    step the logs, the gradients and the state dict after the step."""
    tm, opt, state, batch = port_setup(v, batch_j, dtype, size)
    out = []
    for i in range(steps):
        state, rec = port_step(tm, opt, state, batch, rois[i])
        out.append(rec)
    return tm, state, out


@pytest.fixture(scope="module")
def runs():
    """Two whole float64 steps of each package; beside them the port's
    second step from JAX's parameters after the first (the port's own
    momentum, schedule and running statistics)."""
    with jax.enable_x64():
        v, batch, (j64, j64_2) = jax_steps(jnp.float64, 2, size=SIZE_F64)
    tm, opt, state, tbatch = port_setup(v, batch, torch.float64, SIZE_F64)
    state, t64 = port_step(tm, opt, state, tbatch, j64["rois"])
    tm_j, opt_j, state_j = copy.deepcopy((tm, opt, state))
    with torch.no_grad():
        for name, p in flax_params_to_torch(j64["params"]).items():
            tm_j.get_parameter(name).copy_(p)
    state, t64_2 = port_step(tm, opt, state, tbatch, j64_2["rois"])
    _, t64_2j = port_step(tm_j, opt_j, state_j, tbatch, j64_2["rois"])
    return dict(v=v, j64=j64, t64=t64, j64_2=j64_2, t64_2=t64_2, t64_2j=t64_2j, tm=tm,
                state=state)


def as_np(x):
    return x.double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)


def check(got, want, rtol, msg, exact=None, near=None):
    """max |got - want| <= rtol * max|want|, plus 3 max|want - exact| when
    the exact (float64) values are given, plus 3 max|got - near| when a
    nearby run of the port is given."""
    got, want = as_np(got), as_np(want)
    bound = rtol * max(np.abs(want).max(), 1e-3)
    if exact is not None:
        bound += 3 * np.abs(want - as_np(exact)).max()
    if near is not None:
        bound += 3 * np.abs(got - as_np(near)).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{msg}: max |err| {err:.4e} > {bound:.4e} (scale {np.abs(want).max():.4e})"


def logs_of(run):
    out = {**run["losses"], **run["metrics"]}
    out.pop("Cube/IoU3D")
    return out


def check_logs(j, t, near=None):
    want, logs = logs_of(j), t["logs"]
    assert set(want) == set(logs) - {"total_loss", "diverging", "grad_finite"}
    for k, w in want.items():
        check(np.float64(logs[k]), w, 1e-5, k, near=None if near is None else near["logs"][k])
    assert logs["diverging"] == 0.0 and logs["grad_finite"] == 1.0
    assert logs["roi_head/num_fg_samples"] > 0


def check_gradients(j, t, near=None):
    want, got = flax_params_to_torch(j["grads"]), t["grads"]
    assert set(want) == set(got)
    for name, g in want.items():
        check(got[name], g, 1e-5, name, near=None if near is None else near["grads"][name])


def check_state(j, t, near=None):
    """Parameters and BatchNorm running statistics after a step."""
    want = flax_to_torch(j["params"], j["batch_stats"])
    got = t["state_dict"]
    for name, w in want.items():
        if not name.endswith("num_batches_tracked"):
            check(got[name], w, 1e-5, name,
                  near=None if near is None else near["state_dict"][name])


def test_losses_and_metrics_f64(runs):
    check_logs(runs["j64"], runs["t64"])


def test_gradients_f64(runs):
    check_gradients(runs["j64"], runs["t64"])


def test_state_after_the_step_f64(runs):
    check_state(runs["j64"], runs["t64"])


def test_second_step_f64(runs):
    """The second whole step, from the parameters, running statistics,
    momentum and schedule the first left: its losses and metrics, every
    gradient, and the parameters and statistics after its update. Each
    package rounds its first update into its float32 parameters on its own
    (one ulp apart in ~7% of them, from gradients ~1e-6 apart), and the
    trunk amplifies that ~100x into the second step's gradients. So beside
    1e-5 of each tensor's scale the bound allows three times the distance
    between the port's second step from its own parameters and from JAX's
    (test_second_step_from_jax_parameters_f64 holds the latter to 1e-5)."""
    j, tj = runs["j64_2"], runs["t64_2j"]
    check_logs(j, runs["t64_2"], near=tj)
    check_gradients(j, runs["t64_2"], near=tj)
    check_state(j, runs["t64_2"], near=tj)
    # the update moved the parameters between the steps
    p1, p2 = runs["t64"]["state_dict"], runs["t64_2"]["state_dict"]
    assert not torch.equal(p1["roi_heads.box_head.fc1.weight"], p2["roi_heads.box_head.fc1.weight"])
    st = runs["state"]
    assert (st.step, st.applied, st.skipped) == (2, 2, 0)


def test_second_step_from_jax_parameters_f64(runs):
    """The port's second step from JAX's parameters after the first, with
    the momentum, schedule and running statistics the port carried: its
    losses, gradients and the state after its update, to 1e-5 as the first
    step."""
    check_logs(runs["j64_2"], runs["t64_2j"])
    check_gradients(runs["j64_2"], runs["t64_2j"])
    check_state(runs["j64_2"], runs["t64_2j"])


def test_update_of_two_steps(runs):
    """The port's SGD against optax's (build_optimizer of both packages) on
    the same parameters and the same two gradients (JAX's first-step
    gradients, then random ones at their scale), SOLVER defaults with
    WARMUP_FACTOR 1.0: momentum, weight decay, the bias/norm groups and the
    schedule; float32 arithmetic in both (1e-6 of each tensor's scale)."""
    from weakcube_tpu_torch.solver import build_optimizer
    jcfg = graft._tiny_cfg(SIZE_F64, NCLS, dla=True).clone()
    cfg = tiny_cfg(SIZE_F64, NCLS, dla=True).clone()
    for c in (jcfg, cfg):
        c.defrost()
        c.SOLVER.WARMUP_FACTOR = 1.0
    rng = np.random.default_rng(3)
    g0 = runs["j64"]["grads"]
    grads = [g0, jax.tree_util.tree_map(
        lambda g: (rng.normal(size=np.shape(g)) * (np.abs(g).max() + 1e-3)).astype(np.float32), g0)]
    params = runs["v"]["params"]
    tx = j_build_optimizer(jcfg, params)
    opt, update = tx.init(params), jax.jit(tx.update)
    for g in grads:
        upd, opt = update(g, opt, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
    tm = t_build_model(cfg, dims_priors(NCLS), device="cpu")
    tm.load_state_dict(flax_to_torch(runs["v"]["params"], runs["v"]["batch_stats"]))
    sgd = build_optimizer(cfg, tm.requires_grad_(True))
    named = dict(tm.named_parameters())
    for g in grads:
        for name, x in flax_params_to_torch(g).items():
            named[name].grad = x.clone()
        sgd.step()
    want = flax_params_to_torch(jax.device_get(params))
    for name, w in want.items():
        check(named[name].detach(), w, 1e-6, name)
    # decay and momentum move every parameter but those with neither a
    # gradient nor weight decay (the dead projections' norms, group "norm")
    init = flax_params_to_torch(runs["v"]["params"])
    still = {n for n, p in init.items() if torch.equal(want[n], p)}
    assert still == {n for n, p in init.items() if torch.equal(named[n].detach(), p)}
    assert sgd.count == 2


def test_fpn_gets_gradient_from_heads(runs):
    """The pooler passes the heads' gradient into the FPN: p2's output conv
    (where these RoIs pool) carries the box and cube heads' losses, not the
    RPN's alone."""
    g = runs["t64"]["grads"]
    assert g["backbone.fpn_output2.weight"].abs().sum() > 0
    assert g["roi_heads.box_head.fc1.weight"].abs().sum() > 0


def test_param_labels_match_jax(runs):
    """Every parameter sits in the group the JAX package labels its flax
    counterpart with."""
    codes = {g: float(i) for i, g in enumerate(GROUPS)}
    labels = _param_labels(runs["v"]["params"])
    coded = jax.tree_util.tree_map(lambda lab, p: np.full(np.shape(p), codes[lab], np.float32),
                                   labels, runs["v"]["params"])
    want = {n: GROUPS[int(x.flatten()[0])] for n, x in flax_params_to_torch(coded).items()}
    got = {}
    for mname, module in runs["tm"].named_modules():
        for pname, _ in module.named_parameters(recurse=False):
            got[f"{mname}.{pname}"] = param_label(module, pname)
    assert got == want
    assert set(got.values()) == set(GROUPS)
