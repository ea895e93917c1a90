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


def test_checkpoint_continues_a_step_exactly(tmp_path):
    """One step, save, load into a fresh model and optimizer, one more step:
    the same parameters, BatchNorm statistics, momentum, schedule and
    TrainState as one more step from the in-memory state."""
    cfg = tiny_cfg(64, 5, dla=True)
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
    for p, q in zip(opt.param_groups, opt2.param_groups):
        assert p["lr"] == q["lr"]
        for x, y in zip(p["params"], q["params"]):
            assert torch.equal(opt.state[x]["momentum_buffer"], opt2.state[y]["momentum_buffer"])


def test_foreign_checkpoints_raise(tmp_path):
    """Released detectron2 checkpoints raise (their fc1 columns need a
    permutation); this package's checkpoints load the weights alone."""
    cfg = tiny_cfg(64, 5, dla=True)
    model = build_model(cfg, dims_priors(5), device="cpu")
    for src in ("model_final.pth", "cubercnn://omni3d/cubercnn_DLA34_FPN.pth"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            checkpoint.load_weights_pretrain(src, model)
    ckpt = checkpoint.PeriodicCheckpointerOnlyOne(str(tmp_path), 1)
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
