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
Cube/IoU3D is compared on the first step; the port's train step computes it
every 200th step only and reports NaN on the second. The same two steps
over two data-parallel gloo ranks of B = 1 (spawned, torch only) are held
to the port's one-process steps and to JAX's (test_data_parallel_*).
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import torch_parallel_check as pc
from weakcube_tpu.models import rcnn3d as j_rcnn3d
from weakcube_tpu.models import roi_heads as j_roi_heads
from weakcube_tpu.solver.build import _param_labels, build_optimizer as j_build_optimizer
from weakcube_tpu_torch.entry import dims_priors, tiny_batch, tiny_cfg
from weakcube_tpu_torch.models import roi_heads as t_roi_heads
from weakcube_tpu_torch.models import rpn as t_rpn
from weakcube_tpu_torch.models.rcnn3d import build_model as t_build_model
from weakcube_tpu_torch.parallel import distributed
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

    metric = j_roi_heads.iou3d_train_metric

    def metric_in(dt):
        """JAX's Cube/IoU3D on GT cubes cast to the compute type: its
        polytope clip refuses float32 GT corners beside float64 ones."""
        def fn(dec, gt, *a, **k):
            return metric(dec, gt._replace(boxes3D=gt.boxes3D.astype(dt),
                                           poses=gt.poses.astype(dt)), *a, **k)
        return fn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_roi_heads, "label_and_sample_proposals", capture)
        if dtype == jnp.float64:
            mp.setattr(j_roi_heads, "iou3d_train_metric", metric_in(dtype))
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
    momentum, schedule and running statistics), and the port's two steps
    with float64 parameters (the data-parallel steps' reference)."""
    with jax.enable_x64():
        v, batch, (j64, j64_2) = jax_steps(jnp.float64, 2, size=SIZE_F64)
    tm, opt, state, tbatch = port_setup(v, batch, torch.float64, SIZE_F64)
    tm_d, opt_d, state_d = copy.deepcopy((tm, opt, state))
    state, t64 = port_step(tm, opt, state, tbatch, j64["rois"])
    tm_j, opt_j, state_j = copy.deepcopy((tm, opt, state))
    with torch.no_grad():
        for name, p in flax_params_to_torch(j64["params"]).items():
            tm_j.get_parameter(name).copy_(p)
    state, t64_2 = port_step(tm, opt, state, tbatch, j64_2["rois"])
    _, t64_2j = port_step(tm_j, opt_j, state_j, tbatch, j64_2["rois"])
    tm_d.double()
    opt_d = create_train_state(with_solver(tiny_cfg(SIZE_F64, NCLS, dla=True)), tm_d)[1]
    t64d = []
    for r in (j64["rois"], j64_2["rois"]):
        state_d, rec = port_step(tm_d, opt_d, state_d, tbatch, r)
        t64d.append(dict(rec, state=state_d))
    return dict(v=v, j64=j64, t64=t64, j64_2=j64_2, t64_2=t64_2, t64_2j=t64_2j, tm=tm,
                state=state, batch=batch, t64d=t64d)


@pytest.fixture(scope="module")
def dp(runs, tmp_path_factory):
    """The two float64 steps over 2 gloo ranks of B = 1 (spawned processes
    that import torch and the port only: tests/torch_parallel_check.py::
    train_steps), on the fixture's weights, with float64 parameters, each
    rank on its row of the batch, of JAX's anchor labels and of each
    step's RoIs. Returns rank 0's steps and what the ranks reported."""
    path = tmp_path_factory.mktemp("dp") / "steps.pt"
    lab = runs["batch"]["rpn_labels"]
    torch.save(dict(cfg=with_solver(tiny_cfg(SIZE_F64, NCLS, dla=True)), B=B, size=SIZE_F64,
                    state_dict=flax_to_torch(runs["v"]["params"], runs["v"]["batch_stats"]),
                    rpn_labels=[np.array(x) for x in (lab.labels, lab.matched_boxes,
                                                      lab.matched_ious)],
                    rois=[[np.array(x) for x in runs[k]["rois"]] for k in ("j64", "j64_2")],
                    out=str(path) + ".out"), path)
    report = distributed.launch(pc.train_steps, 2, (str(path),), device_type="cpu")
    return torch.load(str(path) + ".out", weights_only=False), report


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
    return {**run["losses"], **run["metrics"]}


def check_logs(j, t, near=None, tick=True):
    """Every loss and metric to 1e-5 of its scale. tick=False: a step on
    which the port skips Cube/IoU3D (it reads NaN there)."""
    want, logs = logs_of(j), t["logs"]
    assert set(want) == set(logs) - {"total_loss", "diverging", "grad_finite"}
    if not tick:
        assert math.isnan(logs["Cube/IoU3D"])
        want.pop("Cube/IoU3D")
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
    assert runs["t64"]["logs"]["Cube/IoU3D"] > 0  # some fg cube overlaps its GT


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
    check_logs(j, runs["t64_2"], near=tj, tick=False)
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
    check_logs(runs["j64_2"], runs["t64_2j"], tick=False)
    check_gradients(runs["j64_2"], runs["t64_2j"])
    check_state(runs["j64_2"], runs["t64_2j"])


def test_data_parallel_steps_equal_one_process_f64(runs, dp):
    """Two ranks of B = 1 take the one-process steps on B = 2: every loss
    and metric, the skip decision and TrainState, and every parameter and
    BatchNorm statistic after each of the two steps, to 1e-10 of each
    tensor's scale (parameters float64 on both sides, so that the only
    difference is the order of float64 sums: the BatchNorm statistics, the
    loss numerators and the gradients, each split in two and added); the
    replicas hold the same bits after each step; the ranks imported no
    JAX."""
    steps, report = dp
    assert report["world"] == 2 and report["replicas_equal"] == [True, True]
    assert report["imported"] == [[], []]
    for i, (got, want) in enumerate(zip(steps, runs["t64d"])):
        a, b = got["state"], want["state"]
        assert (a.step, a.applied, a.skipped, a.ema_init) == (b.step, b.applied, b.skipped,
                                                              b.ema_init), f"step {i}"
        check(np.float64(a.loss_ema), np.float64(b.loss_ema), 1e-10, f"step {i} loss_ema")
        assert set(got["logs"]) == set(want["logs"])
        for k, w in want["logs"].items():
            if math.isnan(w):
                assert math.isnan(got["logs"][k]), k
            else:
                check(np.float64(got["logs"][k]), np.float64(w), 1e-10, f"step {i} {k}")
        for name, w in want["state_dict"].items():
            check(got["state_dict"][name], w, 1e-10, f"step {i} {name}")


def test_data_parallel_steps_match_jax_f64(runs, dp):
    """The two ranks' steps against JAX's float64 steps, with the
    tolerances of the one-process port's (test_losses_and_metrics_f64,
    test_state_after_the_step_f64, test_second_step_f64)."""
    steps, _ = dp
    first, second = ({"logs": s["logs"], "state_dict": s["state_dict"]} for s in steps)
    check_logs(runs["j64"], first)
    check_state(runs["j64"], first)
    check_logs(runs["j64_2"], second, near=runs["t64_2j"], tick=False)
    check_state(runs["j64_2"], second, near=runs["t64_2j"])


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


def test_in_graph_ground_plane_equals_handed_normals():
    """Without batch["ground_normal"] the weak forward fits each image's
    ground plane by RANSAC (ground_normals_from_maps), drawing from the
    step's generator after the RoI sampler. Handing the forward the normals
    that ground_normals_from_maps returns from the same generator state
    gives the same Cube/loss_normal_vec (and every other loss), exactly."""
    cfg = tiny_cfg(SIZE_F64, NCLS, dla=True)
    tm = t_build_model(cfg, dims_priors(NCLS), device="cpu", seed=2).train()
    batch = tiny_batch(B, SIZE_F64, SIZE_F64, device="cpu")
    for k in ("ground_normal", "ground_normal_valid"):
        batch.pop(k)
    fit, seen = t_roi_heads.ground_normals_from_maps, {}

    def spy(generator, *a, **k):
        seen.update(state=generator.get_state(), args=a, kwargs=k)
        return fit(generator, *a, **k)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_roi_heads, "ground_normals_from_maps", spy)
        fitted, _ = tm(batch, torch.Generator().manual_seed(3))
    assert seen["kwargs"]["num_hypotheses"] == cfg.TPU.RANSAC_HYPOTHESES
    assert seen["kwargs"]["use_nth"] == cfg.TPU.RANSAC_USE_NTH
    again = torch.Generator()
    again.set_state(seen["state"])
    normals = fit(again, *seen["args"], **seen["kwargs"])
    assert torch.allclose(torch.linalg.vector_norm(normals, dim=-1), torch.ones(B))
    with torch.no_grad():
        handed, _ = tm(dict(batch, ground_normal=normals,
                            ground_normal_valid=batch["ground_valid"]),
                       torch.Generator().manual_seed(3))
        other, _ = tm(dict(batch, ground_normal=torch.roll(normals, 1, -1),
                           ground_normal_valid=batch["ground_valid"]),
                      torch.Generator().manual_seed(3))
    assert set(fitted) == set(handed)
    for k in fitted:
        assert torch.equal(fitted[k], handed[k]), k
    assert not torch.equal(fitted["Cube/loss_normal_vec"], other["Cube/loss_normal_vec"])
