"""The port's spans (weakcube_tpu_torch/utils/trace.py) on the CPU: nothing
recorded without a profiler, the spans of a training step and of a
detection forward with their parents under one, NMS's convergence checks,
the store's clock against the exported trace, and outputs that do not
depend on whether a profiler runs."""
import copy
import json

import numpy as np
import pytest
import torch

from weakcube_tpu_torch.entry import dims_priors, make_batch, tiny_batch, tiny_cfg
from weakcube_tpu_torch.models.rcnn3d import build_model
from weakcube_tpu_torch.ops import nms as nms_ops
from weakcube_tpu_torch.parallel.train_step import create_train_state, train_step
from weakcube_tpu_torch.utils import trace

SIZE, B = 64, 2
STEP_NAMES = {"train.step", "model.forward", "model.backbone", "model.proposals",
              "model.roi_heads", "nms", "sync", "train.backward", "train.optimizer"}


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg(SIZE, dla=True)
    model = build_model(cfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), "cpu", seed=0)
    return cfg, model


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def one_step(cfg, model):
    """A fresh copy of the model and its optimizer, one step on tiny_batch."""
    m = copy.deepcopy(model)
    state, opt = create_train_state(cfg, m)
    gen = torch.Generator().manual_seed(3)
    _, logs = train_step(m, opt, state, tiny_batch(B, SIZE, SIZE, device="cpu"), gen)
    return m, logs


def detect(model):
    m = copy.deepcopy(model).eval()
    with torch.inference_mode():
        return m(make_batch(B, SIZE, SIZE, seed=1, device="cpu"))


def by_id(spans):
    return {s.id: s for s in spans}


def test_nothing_recorded_without_a_profiler(setup):
    cfg, model = setup
    trace.take()
    one_step(cfg, model)
    detect(model)
    assert trace.take() == []


def test_training_step_spans_and_parents(setup):
    cfg, model = setup
    trace.take()
    with profiled():
        one_step(cfg, model)
    spans = trace.take()
    assert {s.name for s in spans} == STEP_NAMES   # no train.grad_sum at W = 1
    ids = by_id(spans)
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["train.step"]
    assert all(s.root == roots[0].id for s in spans)
    want_parent = {"model.forward": "train.step", "train.backward": "train.step",
                   "train.optimizer": "train.step", "model.backbone": "model.forward",
                   "model.proposals": "model.forward", "model.roi_heads": "model.forward",
                   "nms": "model.proposals"}
    for s in spans:
        if s.name in want_parent:
            assert ids[s.parent].name == want_parent[s.name], s
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = ids[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # every sync is a convergence check of the one NMS, or the step's logs
    syncs = [ids[s.parent].name for s in spans if s.name == "sync"]
    assert syncs.count("train.step") == 1
    assert syncs.count("nms") == len(syncs) - 1 >= 2
    assert sum(s.name == "nms" for s in spans) == 1


def test_detection_forward_spans_and_parents(setup):
    _, model = setup
    trace.take()
    with profiled():
        detect(model)
    spans = trace.take()
    ids = by_id(spans)
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["model.forward"]
    assert all(s.root == roots[0].id for s in spans)
    assert {s.name for s in spans} == {"model.forward", "model.backbone", "model.proposals",
                                       "model.roi_heads", "nms", "sync"}
    # proposal selection's NMS and the box head's
    assert sorted(ids[s.parent].name for s in spans if s.name == "nms") == [
        "model.proposals", "model.roi_heads"]
    assert all(ids[s.parent].name == "nms" for s in spans if s.name == "sync")


def fixed_point_passes(suppress: np.ndarray) -> int:
    """Passes of nms_mask's fixed point over one problem's suppress matrix
    (row j suppresses column i), all boxes valid, counted in numpy."""
    n = len(suppress)
    kept, prev, k = np.ones(n, bool), np.zeros(n, bool), 0
    while k < n and (kept != prev).any():
        prev, kept = kept, ~(suppress & kept[:, None]).any(0)
        k += 1
    return k


def test_nms_records_one_check_per_pass_and_one_more():
    # a chain of 6 boxes, each overlapping its neighbours at IoU 0.6 (over
    # the 0.5 threshold) and the rest under it, with scores falling along
    # it, then 6 boxes apart: the fixed point needs one pass per link
    n = 12
    x = np.concatenate([np.arange(6) * 4.0, 100.0 + np.arange(6) * 40.0]).astype(np.float32)
    boxes = torch.from_numpy(np.stack([x, np.zeros(n), x + 16, np.full(n, 16.0)], -1)
                             .astype(np.float32))
    scores = torch.linspace(1.0, 0.1, n)
    iou = nms_ops.pairwise_iou(boxes, boxes).numpy()
    assert np.isclose(iou[0, 1], 0.6) and iou[0, 2] < 0.5
    k = fixed_point_passes(np.triu(iou > 0.5, 1))
    assert 5 <= k < n
    trace.take()
    with profiled():
        keep = nms_ops.nms_mask(boxes, scores, 0.5)
    spans = trace.take()
    assert keep.tolist() == [i % 2 == 0 or i >= 6 for i in range(n)]   # greedy
    (nms,) = [s for s in spans if s.name == "nms"]
    assert nms.parent is None
    syncs = [s for s in spans if s.name == "sync"]
    assert len(syncs) == k + 1 and all(s.parent == nms.id for s in syncs)
    assert len(spans) == k + 2


def store_against_export(cfg, model, path) -> list:
    """Each store span's start and end less its exported event's (ts +
    baseTimeNanoseconds), in us, for every span but the session's first."""
    trace.take()
    with profiled() as prof:
        one_step(cfg, model)
    spans = trace.take()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        doc = json.load(f)
    base = doc["baseTimeNanoseconds"]
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    out = []
    first = min(spans, key=lambda s: s.start_ns)
    for name in {s.name for s in spans}:
        mine = sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)
        theirs = sorted((e for e in events if e["name"] == name), key=lambda e: e["ts"])
        assert len(mine) == len(theirs), name
        for s, e in zip(mine, theirs):
            if s is first:
                continue
            t0 = float(e["ts"]) + base / 1000.0
            out.append((name, s.start_ns / 1000.0 - t0,
                        s.end_ns / 1000.0 - (t0 + float(e["dur"]))))
    return out


def test_store_agrees_with_the_exported_trace(setup, tmp_path):
    """Within 50 us at both ends. The clocks are the same, so a miss is the
    scheduler preempting the thread between the two readings: the best of
    three sessions is taken."""
    cfg, model = setup
    worst = []
    for attempt in range(3):
        diffs = store_against_export(cfg, model, tmp_path / f"t{attempt}.json")
        assert len(diffs) >= len(STEP_NAMES)
        worst.append(max(max(abs(a), abs(b)) for _, a, b in diffs))
        if worst[-1] < 50.0:
            break
    assert min(worst) < 50.0, worst


def test_outputs_do_not_depend_on_the_profiler(setup):
    cfg, model = setup
    m0, logs0 = one_step(cfg, model)
    with profiled():
        m1, logs1 = one_step(cfg, model)
        det1 = detect(model)
    det0 = detect(model)
    trace.take()
    assert logs0.keys() == logs1.keys()
    for k in logs0:   # a metric the step skips reads NaN
        assert logs0[k] == logs1[k] or (np.isnan(logs0[k]) and np.isnan(logs1[k])), k
    for (n, p0), p1 in zip(m0.named_parameters(), m1.parameters()):
        assert torch.equal(p0, p1), n
        assert (p0.grad is None) == (p1.grad is None), n
        if p0.grad is not None:
            assert torch.equal(p0.grad, p1.grad), n
    for f, a, b in zip(det0._fields, det0, det1):
        assert (a is None and b is None) or torch.equal(a, b), f
