"""The port's evaluation entry points on the CPU: the train CLI's
--eval-only (and the eval CLI), TEST.EVAL_PERIOD and VIS_PERIOD, and the
folder demo.

configs/synthetic_smoke.yaml with the flagship's DLA-34 backbone at 64 px,
batches of 2, on 4 synthetic scenes (as tests/test_torch_train_cli.py):
  * a periodic evaluation and the training-time JPEGs leave the training
    bit-identical to a run without them, and do_test and the vis give a
    model back in its own mode with its weights and BatchNorm statistics
    untouched;
  * --eval-only and the eval CLI evaluate the checkpoint just written
    (the same AP as do_test on its state_dict) and count every scene once;
  * the demo writes one JPEG per image, and its detections are do_test's on
    the same images.
"""
import logging
import os

import numpy as np
import pytest
import torch

from weakcube_tpu_torch.data import synthetic
from weakcube_tpu_torch.entry import dims_priors, tiny_batch, tiny_cfg
from weakcube_tpu_torch.evaluation import omni3d_eval
from weakcube_tpu_torch.models.priors import compute_priors
from weakcube_tpu_torch.models.rcnn3d import build_model
from weakcube_tpu_torch.solver import checkpoint
from weakcube_tpu_torch.tools import demo, eval_net, train_net
from weakcube_tpu_torch.utils import events
from weakcube_tpu_torch.utils.util import imwrite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "synthetic_smoke.yaml")
OPTS = ["MODEL.BACKBONE.NAME", "build_dla_from_vision_fpn_backbone", "MODEL.DLA.TYPE", "dla34",
        "TPU.IMAGE_SIZE", "64", "SOLVER.IMS_PER_BATCH", "2", "TEST.IMS_PER_BATCH", "2"]
N_SCENES = 4


def cli(out, *args, opts=()):
    return train_net.main(["--config-file", CONFIG, "--synthetic", str(N_SCENES), "--device",
                           "cpu", *args, *OPTS, "OUTPUT_DIR", str(out), *opts])


class NoTensorboard:
    """Stands in for the CLI's TensorBoard writer, whose import of
    TensorFlow takes longer than these runs; tests/test_torch_train_cli.py
    runs the real one."""

    def __init__(self, log_dir):
        pass

    def write(self, storage):
        pass

    def close(self):
        pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Four iterations without and with TEST.EVAL_PERIOD 2 and VIS_PERIOD 2."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(events, "TensorboardWriter", NoTensorboard)
        for name, opts in (("plain", ("TEST.EVAL_PERIOD", "0", "VIS_PERIOD", "0")),
                           ("eval", ("TEST.EVAL_PERIOD", "2", "VIS_PERIOD", "2"))):
            path = tmp_path_factory.mktemp(name)
            state, history = cli(path, "--max-iters", "4", opts=opts)
            out[name] = dict(path=path, state=state, history=history,
                             ckpt=torch.load(os.path.join(path, "model_final" + checkpoint.SUFFIX),
                                             weights_only=True))
    return out


def test_periodic_eval_leaves_training_unchanged(runs):
    """One evaluation, after iteration 2 (not after the last); every later
    step, the final weights, BatchNorm statistics and momentum are those of
    the run without it."""
    plain, ev = runs["plain"], runs["eval"]
    assert [i for i, h in enumerate(ev["history"]) if "eval" in h] == [1]
    res = ev["history"][1]["eval"]
    assert res["timing"]["images"] == N_SCENES and np.isfinite(res["AP2D"])
    for a, b in zip(plain["history"], ev["history"]):
        assert a["logs"].keys() == b["logs"].keys()
        for k, x in a["logs"].items():
            assert x == b["logs"][k] or (np.isnan(x) and np.isnan(b["logs"][k])), (k, x)
    a, b = plain["ckpt"], ev["ckpt"]
    assert a["model"].keys() == b["model"].keys()
    for k, x in a["model"].items():   # weights and BatchNorm statistics
        assert torch.equal(x, b["model"][k]), k
    for k, x in a["optimizer"]["state"].items():
        assert torch.equal(x["momentum_buffer"], b["optimizer"]["state"][k]["momentum_buffer"]), k
    assert a["train_state"] == b["train_state"]


@pytest.mark.parametrize("training", [True, False])
def test_do_test_and_vis_restore_the_mode(tmp_path, training):
    """do_test on a given model and the training-time vis run it in eval
    mode and give it back in its own mode, every module, with its weights
    and BatchNorm statistics untouched (train_step sets training mode
    itself, so the runs above cannot show this)."""
    cfg = tiny_cfg(64, 5, dla=True).clone()
    cfg.defrost()
    cfg.OUTPUT_DIR, cfg.TEST.IMS_PER_BATCH = str(tmp_path), 2
    cfg.freeze()
    model = build_model(cfg, dims_priors(5), device="cpu").train(training)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    records = synthetic.make_dataset(2, seed=4)
    seen = []
    forward = type(model).forward

    def spy(self, *a, **k):
        seen.append(self.training)
        return forward(self, *a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(model), "forward", spy)
        eval_net.do_test(cfg, None, records, {"image": lambda r: synthetic.render_image(r["_scene"])},
                         model=model)
        train_net._dump_train_vis(cfg, tiny_batch(2, 64, 64, device="cpu"), 7, model)
    assert seen == [False, False]
    assert all(m.training == training for m in model.modules())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert sorted(os.listdir(tmp_path / "vis")) == ["iter_000007_gt.jpg",
                                                   "iter_000007_gt_vs_pred_3d.jpg"]


def test_vis_period_writes_its_jpegs(runs):
    """VIS_PERIOD 2 over 4 iterations: the GT boxes and the GT-vs-predicted
    cuboids at iterations 2 and 4."""
    from PIL import Image
    vis = os.path.join(runs["eval"]["path"], "vis")
    names = sorted(os.listdir(vis))
    assert names == [f"iter_{i:06d}_{k}.jpg" for i in (2, 4) for k in ("gt", "gt_vs_pred_3d")]
    with Image.open(os.path.join(vis, names[1])) as im:
        assert im.size == (128, 64)   # GT and predicted panels side by side


def test_eval_only_evaluates_the_checkpoint(runs, caplog):
    """--eval-only restores OUTPUT_DIR's model_final.pt and gives the AP of
    do_test on that state_dict; --eval-vis 1 writes one JPEG; the eval CLI
    is the same entry point."""
    path = runs["plain"]["path"]
    caplog.set_level(logging.INFO, logger="weakcube_tpu_torch.eval")
    res = cli(path, "--eval-only", "--eval-vis", "1")
    assert any(r.getMessage() == f"restored {path / 'model_final.pt'}" for r in caplog.records)
    assert res["timing"]["images"] == N_SCENES and res["timing"]["batches"] == N_SCENES // 2
    assert os.listdir(os.path.join(path, "eval_vis")) == ["0_pred.jpg"]
    args = train_net.parse_args(["--config-file", CONFIG, "--synthetic", str(N_SCENES),
                                 "--device", "cpu", *OPTS, "OUTPUT_DIR", str(path)])
    cfg = train_net.setup(args)
    records, loaders, ncls = train_net.build_data(cfg, args, "test")
    want = eval_net.do_test(cfg, args, records, loaders, state_dict=runs["plain"]["ckpt"]["model"],
                            priors=compute_priors(cfg, records, cfg.MODEL.ROI_HEADS.NUM_CLASSES))
    again = eval_net.main(["--config-file", CONFIG, "--synthetic", str(N_SCENES), "--device",
                           "cpu", *OPTS, "OUTPUT_DIR", str(path)])
    for got in (res, again):
        for k in ("AP2D", "AP3D", "AP3D@15", "AP3D@25", "AP3D@50", "AP_near"):
            assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k


def test_demo_detections_are_do_test_s(runs, tmp_path):
    """Two rendered PNGs through the demo (threshold 0): two JPEGs, and per
    image the records of do_test on the same images, intrinsics, priors
    and weights."""
    src = tmp_path / "images"
    src.mkdir()
    scenes = synthetic.make_dataset(2, seed=5)
    for r in scenes:
        imwrite(str(src / f"scene_{r['image_id']}.png"), synthetic.render_image(r["_scene"]))
    weights = os.path.join(runs["plain"]["path"], "model_final" + checkpoint.SUFFIX)
    got = demo.main(["--config-file", CONFIG, "--input-folder", str(src), "--output-folder",
                     str(tmp_path / "out"), "--threshold", "0", "--device", "cpu", *OPTS,
                     "MODEL.WEIGHTS", weights])
    assert sorted(os.listdir(tmp_path / "out")) == ["scene_0_3Dboxes.jpg", "scene_1_3Dboxes.jpg"]
    records = [{"file_name": g["file"], "width": 640, "height": 480, "image_id": i,
                "K": [[960.0, 0, 320.0], [0, 960.0, 240.0], [0, 0, 1]], "annotations": []}
               for i, g in enumerate(got)]
    cfg = train_net.setup(train_net.parse_args(["--config-file", CONFIG, *OPTS,
                                                "MODEL.WEIGHTS", weights]))
    kept = []
    add = omni3d_eval.Omni3DEvaluator.add
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(omni3d_eval.Omni3DEvaluator, "add",
                   lambda self, d, g: kept.append(d) or add(self, d, g))
        eval_net.do_test(cfg, None, records, {}, priors=dims_priors(5), batch_size=1,
                         device="cpu")
    assert len(kept) == 2
    for g, want in zip(got, kept):
        assert len(want["scores"]) > 0
        for k in want:
            np.testing.assert_array_equal(g[k], want[k], err_msg=k)
