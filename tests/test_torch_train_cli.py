"""The port's training CLI (weakcube_tpu_torch/tools/train_net.py) on the
CPU, and its checkpoints.

configs/synthetic_smoke.yaml with the flagship's DLA-34 backbone at 64 px,
batch 2, on 4 synthetic scenes: the CLI trains, logs metrics.json, saves
model_recent and model_final, resumes from model_recent, and restarts from
it when the skipped share reaches MODEL.STABILIZE; it accepts --eval-only,
TEST.EVAL_PERIOD and VIS_PERIOD, which tests/test_torch_eval_cli.py runs. A
checkpoint saved and loaded into a fresh model continues a step exactly.
The published recipe runs through the CLI: the 2D-only pretrain
(configs/Base_Omni3D_2D_only.yaml: RCNN3D, ROIHeads3D, LOSS_W_3D 0), then
the weak run (configs/Omni_combined.yaml) warm-started from its
model_final by MODEL.WEIGHTS_PRETRAIN.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from weakcube_tpu_torch.entry import dims_priors, tiny_batch, tiny_cfg
from weakcube_tpu_torch.models.rcnn3d import build_model
from weakcube_tpu_torch.parallel.train_step import create_train_state, train_step
from weakcube_tpu_torch.solver import checkpoint
from weakcube_tpu_torch.tools import train_net
from weakcube_tpu_torch.utils import events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = ["MODEL.BACKBONE.NAME", "build_dla_from_vision_fpn_backbone", "MODEL.DLA.TYPE", "dla34",
        "TPU.IMAGE_SIZE", "64", "SOLVER.IMS_PER_BATCH", "2", "TEST.EVAL_PERIOD", "0",
        "VIS_PERIOD", "0"]


def cli(out, *args, opts=()):
    return train_net.main(["--config-file", os.path.join(REPO, "configs", "synthetic_smoke.yaml"),
                           "--synthetic", "4", "--device", "cpu", *args, *OPTS,
                           "OUTPUT_DIR", str(out), *opts])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    state, history = cli(out, "--max-iters", "2", opts=("SOLVER.CHECKPOINT_PERIOD", "1"))
    return out, state, history


def test_cli_trains_on_the_cpu(run):
    out, state, history = run
    assert (state.step, state.applied, state.skipped) == (2, 2, 0)
    assert [h["iteration"] for h in history] == [0, 1]
    for h in history:
        assert all(math.isfinite(v) for k, v in h["logs"].items() if k != "Cube/IoU3D")
        assert h["data_time"] >= 0 and h["step_time"] > 0
    # Cube/IoU3D on step 0 (a metric tick), NaN on step 1
    assert math.isfinite(history[0]["logs"]["Cube/IoU3D"])
    assert math.isnan(history[1]["logs"]["Cube/IoU3D"])
    with open(os.path.join(out, "metrics.json")) as f:
        lines = [json.loads(line) for line in f]
    assert lines[-1]["iteration"] == 2
    # the last finite value of the tick-gated metric is carried
    assert lines[-1]["Cube/IoU3D"] == history[0]["logs"]["Cube/IoU3D"]
    assert math.isfinite(lines[-1]["total_loss"])
    for name in ("model_recent", "model_final"):
        assert os.path.exists(os.path.join(out, name + checkpoint.SUFFIX))


def test_cli_trains_the_smoke_config_as_written(tmp_path, monkeypatch, one_thread):
    """configs/synthetic_smoke.yaml with its own backbone (ResNet-18 + FPN),
    no override but the size: one iteration trains and saves (the
    TensorBoard writer stubbed: TensorFlow's import)."""
    monkeypatch.setattr(events, "TensorboardWriter", NoTensorboard)
    state, history = train_net.main([
        "--config-file", os.path.join(REPO, "configs", "synthetic_smoke.yaml"),
        "--synthetic", "4", "--device", "cpu", "--max-iters", "1", "TPU.IMAGE_SIZE", "64",
        "SOLVER.IMS_PER_BATCH", "2", "OUTPUT_DIR", str(tmp_path)])
    assert (state.step, state.applied, state.skipped) == (1, 1, 0)
    assert math.isfinite(history[0]["logs"]["total_loss"])
    sd = torch.load(os.path.join(tmp_path, "model_final" + checkpoint.SUFFIX),
                    weights_only=True)["model"]
    assert "backbone.bottom_up.layer4.1.conv2.weight" in sd


def test_cli_resumes_from_model_recent(run):
    out, _, _ = run
    state, history = cli(out, "--resume", "--max-iters", "3",
                         opts=("SOLVER.CHECKPOINT_PERIOD", "1"))
    assert history[0]["iteration"] == 2 and len(history) == 1
    assert (state.step, state.applied) == (3, 3)
    assert math.isfinite(history[0]["logs"]["total_loss"])


def test_cli_restarts_from_the_checkpoint(tmp_path, caplog):
    """MODEL.STABILIZE 0: every check restarts. Checks run every
    CHECKPOINT_PERIOD // 2 = 1 iterations: after iteration 1 there is no
    checkpoint yet (the counters reset), after 2 and 3 the run goes back to
    model_recent (step 2)."""
    state, history = cli(tmp_path, "--max-iters", "3",
                         opts=("SOLVER.CHECKPOINT_PERIOD", "2", "MODEL.STABILIZE", "0.0"))
    assert [h["attempt"] for h in history] == [1, 2, 3]
    assert (state.step, state.applied, state.skipped) == (2, 0, 0)
    assert sum("restarting from the last checkpoint" in r.message for r in caplog.records) == 3


@pytest.mark.parametrize("args,opts", [
    ((), ("TEST.EVAL_PERIOD", "5")),
    ((), ("VIS_PERIOD", "10")),
    (("--eval-only",), ()),
])
def test_cli_refuses_evaluation(tmp_path, args, opts):
    """These raised NotImplementedError before evaluation and visualisation
    were ported; the CLI's setup now takes them."""
    parsed = train_net.parse_args(["--config-file", os.path.join(REPO, "configs",
                                                                 "synthetic_smoke.yaml"),
                                   *args, *OPTS, "OUTPUT_DIR", str(tmp_path), *opts])
    cfg = train_net.setup(parsed)
    assert parsed.eval_only == ("--eval-only" in args)
    want = dict(zip(opts[::2], map(int, opts[1::2])))
    assert cfg.TEST.EVAL_PERIOD == want.get("TEST.EVAL_PERIOD", 0)
    assert cfg.VIS_PERIOD == want.get("VIS_PERIOD", 0)


@pytest.mark.parametrize("solver", ["sgd", "adam+amsgrad"])
def test_checkpoint_continues_a_step_exactly(tmp_path, solver, one_thread):
    """One step, save, load into a fresh model and optimizer, one more step:
    the same parameters, BatchNorm statistics, optimizer state (momentum;
    Adam's moments and nu_max), schedule and TrainState as one more step
    from the in-memory state."""
    cfg = tiny_cfg(64, 5, dla=True).clone()
    cfg.defrost()
    cfg.SOLVER.TYPE = solver
    cfg.freeze()
    batch = tiny_batch(2, 64, 64, device="cpu")

    def fresh(seed):
        model = build_model(cfg, dims_priors(5), device="cpu", seed=seed)
        state, opt = create_train_state(cfg, model)
        return model, opt, state

    model, opt, state = fresh(0)
    state, _ = train_step(model, opt, state, batch, torch.Generator().manual_seed(1))
    ckpt = checkpoint.PeriodicCheckpointerOnlyOne(str(tmp_path), 1)
    ckpt.step(0, model, opt, state)
    model2, opt2, state2 = fresh(5)
    state2 = ckpt.resume_or_load(model2, opt2, state2)
    assert state2 == state and opt2.count == opt.count == 1
    for m, o, s in ((model, opt, state), (model2, opt2, state2)):
        s, logs = train_step(m, o, s, batch, torch.Generator().manual_seed(2))
        assert s.applied == 2, logs
    a, b = model.state_dict(), model2.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    keys = {"sgd": {"momentum_buffer"},
            "adam+amsgrad": {"exp_avg", "exp_avg_sq", "max_exp_avg_sq"}}[solver]
    for p, q in zip(opt.param_groups, opt2.param_groups):
        assert p["lr"] == q["lr"]
        for x, y in zip(p["params"], q["params"]):
            assert set(opt.state[x]) == set(opt2.state[y]) == keys
            for k in keys:
                assert torch.equal(opt.state[x][k], opt2.state[y][k]), k


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    """tiny_cfg(64)'s model (ResNet-18) as a released detectron2 .pth: the
    flax variables (random, in flax's shapes) under detectron2's names, as
    tests/test_zoo_convert.py's _fake_d2_state_dict lays them out, fc1
    columns in detectron2's (C, 7, 7) order, and the pixel_mean / pixel_std
    that detectron2 checkpoints carry and this model lacks."""
    import jax
    import __graft_entry__ as graft
    from weakcube_tpu.models.rcnn3d import build_model as j_build_model
    from weakcube_tpu_torch.utils.convert import flax_to_torch
    from test_torch_model import random_variables
    cfg = tiny_cfg(64, 5)
    jm = j_build_model(graft._tiny_cfg(64, 5), dims_priors(5))
    jb = {k: jax.numpy.asarray(v) for k, v in graft._tiny_batch(1, 64, 64, with_depth=False).items()
          if k in ("image", "image_wh", "K")}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jb, train=False))
    v = random_variables(shapes, seed=3)
    ours = flax_to_torch(v["params"], v["batch_stats"])  # fc1 over (7, 7, C)
    C = cfg.MODEL.FPN.OUT_CHANNELS
    d2 = {k: x for k, x in ours.items() if not k.endswith("num_batches_tracked")}
    for k in ("roi_heads.box_head.fc1.weight", "roi_heads.cube_head.feature_generator.fc1.weight"):
        w = ours[k]
        d2[k] = w.reshape(w.shape[0], 7, 7, C).permute(0, 3, 1, 2).reshape(w.shape)
    d2["pixel_mean"], d2["pixel_std"] = torch.zeros(3, 1, 1), torch.ones(3, 1, 1)
    root = tmp_path_factory.mktemp("released")
    path = root / "cubercnn_ResNet18_FPN.pth"
    torch.save({"model": d2, "iteration": 7}, path)
    # the same file for JAX, whose zoo_convert does not permute fc1
    jax_path = root / "for_jax.pth"
    torch.save({"model": {k: x for k, x in ours.items()
                          if not k.endswith("num_batches_tracked")}}, jax_path)
    return dict(cfg=cfg, path=str(path), jax_path=str(jax_path), ours=ours, d2=d2)


def test_released_checkpoints_load(released, tmp_path, monkeypatch, caplog, one_thread):
    """A detectron2-layout .pth loads through MODEL.WEIGHTS: the same
    tensors as JAX's load_model_weights gives on that file (handed to JAX
    with fc1 already in (7, 7, C), since JAX does not permute), the fc1
    columns permuted so that the port's fc1 on a pooled RoI flattened as
    (7, 7, C) equals detectron2's fc1 on it flattened as (C, 7, 7); the
    keys the model lacks are dropped and logged. A cubercnn:// name
    resolves from the cache and, missing there and with no network, raises
    FileNotFoundError; a backbone without released checkpoints raises
    ValueError; this package's own checkpoints load as before."""
    import logging
    import urllib.request
    from weakcube_tpu.solver.checkpoint import load_model_weights as j_load_model_weights
    from weakcube_tpu_torch.utils import model_zoo
    from weakcube_tpu_torch.utils.convert import flax_to_torch
    cfg = released["cfg"]
    model = build_model(cfg, dims_priors(5), device="cpu")
    with caplog.at_level(logging.INFO):
        checkpoint.load_model_weights(released["path"], model)
    assert any("pixel_mean" in r.message and "pixel_std" in r.message for r in caplog.records)
    jp, js = j_load_model_weights(released["jax_path"], cfg)
    want = flax_to_torch(jp, js)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, x in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], x), k

    # detectron2's box head: flatten NCHW, then fc1
    C = cfg.MODEL.FPN.OUT_CHANNELS
    pooled = torch.from_numpy(np.random.default_rng(2).normal(size=(6, 7, 7, C)).astype(np.float32))
    d2_w, d2_b = released["d2"]["roi_heads.box_head.fc1.weight"],         released["d2"]["roi_heads.box_head.fc1.bias"]
    d2_out = pooled.permute(0, 3, 1, 2).flatten(1) @ d2_w.T + d2_b
    with torch.no_grad():
        ours = model.roi_heads.box_head.fc1(pooled.flatten(1))
    torch.testing.assert_close(ours, d2_out, rtol=1e-5, atol=1e-5 * float(d2_out.abs().max()))

    # cubercnn:// from the cache; missing, with no network
    monkeypatch.setattr(model_zoo, "CACHE_DIR", str(tmp_path))
    os.makedirs(tmp_path / "omni3d")
    os.symlink(released["path"], tmp_path / "omni3d" / "cubercnn_ResNet18_FPN.pth")
    fresh = build_model(cfg, dims_priors(5), device="cpu", seed=9)
    checkpoint.load_weights_pretrain("cubercnn://omni3d/cubercnn_ResNet18_FPN.pth", fresh)
    assert all(torch.equal(x, got[k]) for k, x in fresh.state_dict().items()
               if not k.endswith("num_batches_tracked"))

    def no_network(*a, **k):
        raise OSError("no network")
    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    with pytest.raises(FileNotFoundError, match="cubercnn_DLA34_FPN.pth"):
        checkpoint.load_model_weights("cubercnn://omni3d/cubercnn_DLA34_FPN.pth", fresh)

    small = tiny_cfg(64, 5).clone()
    small.defrost()
    small.MODEL.BACKBONE.NAME = "build_mnasnet_fpn_backbone"
    small.freeze()
    with pytest.raises(ValueError, match="unsupported backbone"):
        checkpoint.load_model_weights(released["path"], build_model(small, dims_priors(5),
                                                                    device="cpu"))

    # this package's checkpoints load the weights alone
    ckpt = checkpoint.PeriodicCheckpointerOnlyOne(str(tmp_path / "own"), 1)
    state, opt = create_train_state(cfg, model)
    ckpt.finalize(model, opt, state)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    checkpoint.load_model_weights(ckpt.path("model_final"), model)
    for k, x in model.state_dict().items():
        assert torch.equal(x, saved[k]), k


def test_step_generator_depends_on_seed_and_iteration_only():
    draw = [torch.randint(0, 1 << 30, (4,), generator=train_net.step_generator(12, it, "cpu"))
            for it in (0, 1, 0)]
    assert torch.equal(draw[0], draw[2]) and not torch.equal(draw[0], draw[1])
    assert not np.array_equal(
        torch.randint(0, 1 << 30, (4,), generator=train_net.step_generator(13, 0, "cpu")),
        draw[0])


class NoTensorboard:
    """Stands in for the CLI's TensorBoard writer (TensorFlow's import)."""

    def __init__(self, log_dir):
        pass

    def write(self, storage):
        pass

    def close(self):
        pass


# the recipe configs' RoI and head sizes cut to synthetic_smoke.yaml's
SMALL_HEADS = ["MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64", "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "256",
               "MODEL.RPN.POST_NMS_TOPK_TRAIN", "128", "MODEL.ROI_BOX_HEAD.FC_DIM", "256",
               "MODEL.ROI_CUBE_HEAD.FC_DIM", "256"]


@pytest.fixture
def one_thread():
    """Small shapes, and test workers run side by side: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_recipe_2d_pretrain_then_weak_warm_start(tmp_path, monkeypatch, one_thread):
    """Two iterations of the 2D-only pretrain log no Cube/ key and train the
    box branch alone; two of the weak run warm-started from its
    model_final start from every one of its tensors (RCNN3D and
    RCNN3D_combined_features share the names) and train the cube branch."""
    from weakcube_tpu_torch.parallel import train_step as ts
    monkeypatch.setattr(events, "TensorboardWriter", NoTensorboard)
    first, step = {}, ts.train_step

    def spy(model, *a, **k):
        if not first:
            first.update({k: v.clone() for k, v in model.state_dict().items()})
            first["_arch"] = type(model).__name__
        return step(model, *a, **k)
    monkeypatch.setattr(ts, "train_step", spy)

    def recipe(config, out, *opts):
        first.clear()
        return train_net.main(["--config-file", os.path.join(REPO, "configs", config),
                               "--synthetic", "4", "--device", "cpu", "--max-iters", "2",
                               *OPTS, *SMALL_HEADS, "OUTPUT_DIR", str(out), *opts])
    state, hist = recipe("Base_Omni3D_2D_only.yaml", tmp_path / "2d")
    assert first["_arch"] == "RCNN3D" and (state.step, state.applied) == (2, 2)
    for h in hist:
        assert not [k for k in h["logs"] if k.startswith("Cube/")], h["logs"]
        assert all(math.isfinite(v) for v in h["logs"].values())
    final = checkpoint.PeriodicCheckpointerOnlyOne(str(tmp_path / "2d"), 1).path("model_final")
    saved = torch.load(final, weights_only=True)["model"]
    state, hist = recipe("Omni_combined.yaml", tmp_path / "weak", "MODEL.WEIGHTS_PRETRAIN", final)
    assert first.pop("_arch") == "RCNN3DCombinedFeatures"
    assert set(first) == set(saved)
    for k, v in saved.items():
        assert torch.equal(first[k], v), k
    assert (state.step, state.applied) == (2, 2)
    for h in hist:
        assert {"Cube/loss_iou", "Cube/loss_normal_vec", "Cube/loss_pose"} <= set(h["logs"])
        assert all(math.isfinite(v) for k, v in h["logs"].items() if k != "Cube/IoU3D")
