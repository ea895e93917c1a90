"""weakcube_tpu_torch on the card (marker `cuda`; each test skips without a
CUDA device). This file imports nothing of JAX, so it also runs where JAX
is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import contextlib
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from weakcube_tpu_torch.models.layers import BatchNorm2d
from weakcube_tpu_torch.ops import batch_norm_cuda
from weakcube_tpu_torch.ops import bilinear_resize_cuda
from weakcube_tpu_torch.ops import flash_attention_cuda
from weakcube_tpu_torch.ops import nms as nms_ops
from weakcube_tpu_torch.ops import roi_align as t_ra
from weakcube_tpu_torch.ops import roi_align_cuda
from weakcube_tpu_torch.ops.attention import attention
from torch_roi_boxes import BOX_SETS, border_boxes, box_set, edge_boxes, elongated_boxes
import torch_nms_boxes as nms_boxes

STRIDES = (4, 8, 16, 32, 64)
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def pyramid(card, dt, rng, C, B=2, size=256):
    return [torch.from_numpy(rng.normal(size=(B, size // s, size // s, C)).astype(np.float32))
            .to(card, dt) for s in STRIDES]


@pytest.mark.parametrize("boxes_name", BOX_SETS)
@pytest.mark.parametrize("out_size,sr", [(7, 2), (5, 3), (7, 1)])
@pytest.mark.parametrize("C", [5, 6, 64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain(card, dtype, C, out_size, sr, boxes_name):
    """float32: the same sample coordinates, the bilinear sum taken
    separably (x, then y) instead of per sample (atol 2e-5, rtol 1e-5);
    bfloat16: both round a float32 sum to bf16, at most one bf16 step apart
    (1e-2 + 1e-2 rel). C = 5 and 6 take the scalar width (not a multiple of
    8 bf16 or 4 float32 channels), 64 and 256 the 16-byte vectors; (7, 2) the
    compile-time shape, the others the generic one. One launch per call."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(4)
    feats = pyramid(card, dt, rng, C)
    boxes = torch.from_numpy(box_set(boxes_name, rng, 2, 50, 256)).to(card)
    before = roi_align_cuda.multilevel_roi_align.launches
    got = roi_align_cuda.multilevel_roi_align(feats, boxes, STRIDES, out_size, sr)
    torch.cuda.synchronize()
    assert roi_align_cuda.multilevel_roi_align.launches == before + 1
    assert got.shape == (2, 50, out_size, out_size, C) and got.dtype == dt
    want = t_ra.multilevel_roi_align(feats, boxes, STRIDES, out_size, sr)
    tol = dict(atol=2e-5, rtol=1e-5) if dt == torch.float32 else dict(atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_misaligned_levels(card, dtype):
    """Levels that are contiguous views one element past a 16-byte boundary
    take the scalar width and agree with the plain version."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    feats = []
    for f in pyramid(card, dt, rng, 64):
        flat = torch.empty(f.numel() + 8, dtype=dt, device=card)
        view = flat[(2 // f.element_size()) or 1:][:f.numel()].view(f.shape)
        view.copy_(f)
        assert view.is_contiguous() and view.data_ptr() % 16
        feats.append(view)
    boxes = torch.from_numpy(box_set("edge", rng, 2, 50, 256)).to(card)
    before = roi_align_cuda.multilevel_roi_align.launches
    got = roi_align_cuda.multilevel_roi_align(feats, boxes, STRIDES, 7, 2)
    torch.cuda.synchronize()
    assert roi_align_cuda.multilevel_roi_align.launches == before + 1
    tol = dict(atol=2e-5, rtol=1e-5) if dt == torch.float32 else dict(atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(got.float(), t_ra.multilevel_roi_align(
        feats, boxes, STRIDES, 7, 2).float(), **tol)


@pytest.mark.parametrize("seed", [7, 8, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_many_rois_per_block(card, dtype, seed):
    """More RoIs than the persistent grid holds (several per block), mixing
    the box sets, so that blocks move from RoI to RoI and from one RoI's
    last channel chunk to the next RoI's first. Five launches on the same
    input give the same bits (a race in the hand-offs would not) and agree
    with the plain version."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    feats = pyramid(card, dt, rng, 256)
    boxes = np.concatenate([box_set(n, rng, 2, 800, 256) for n in BOX_SETS], 1)
    boxes = torch.from_numpy(np.ascontiguousarray(boxes[:, rng.permutation(boxes.shape[1])]))
    boxes = boxes.to(card)
    before = roi_align_cuda.multilevel_roi_align.launches
    runs = [roi_align_cuda.multilevel_roi_align(feats, boxes, STRIDES, 7, 2) for _ in range(5)]
    torch.cuda.synchronize()
    assert roi_align_cuda.multilevel_roi_align.launches == before + 5
    for got in runs[1:]:
        assert torch.equal(got, runs[0])
    tol = dict(atol=2e-5, rtol=1e-5) if dt == torch.float32 else dict(atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(runs[0].float(), t_ra.multilevel_roi_align(
        feats, boxes, STRIDES, 7, 2).float(), **tol)


def test_kernel_no_rois_launches_nothing(card):
    feats = pyramid(card, torch.bfloat16, np.random.default_rng(6), 64)
    before = roi_align_cuda.multilevel_roi_align.launches
    got = roi_align_cuda.multilevel_roi_align(feats, torch.zeros((2, 0, 4), device=card),
                                              STRIDES, 7, 2)
    assert got.shape == (2, 0, 7, 7, 64) and got.dtype == torch.bfloat16
    assert roi_align_cuda.multilevel_roi_align.launches == before


def test_kernel_refuses_nchw_levels(card):
    feats = [torch.zeros((1, 4, 64 // s, 64 // s), device=card).permute(0, 2, 3, 1)
             for s in STRIDES]
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        roi_align_cuda.multilevel_roi_align(feats, torch.zeros((1, 3, 4), device=card), STRIDES)


def backward_tol(dt):
    """float32: the kernel sums each pixel's terms in RoI order, a bin's
    weights separably, in float32, while the plain version's index_add_ on
    the card adds the samples' corner terms in an order of its own; a pixel
    under ~100 overlapping RoIs sums ~100 terms of O(1) (atol 2e-4, rtol
    2e-5); bfloat16: both accumulate in float32 and round once to bf16, at
    most one bf16 step apart (1e-2 + 1e-2 rel). Two launches of the kernel
    on the same inputs give the same bits."""
    return dict(atol=2e-4, rtol=2e-5) if dt == torch.float32 else dict(atol=1e-2, rtol=1e-2)


def check_backward(card, g, boxes, shapes, dt, out_size=7, sr=2):
    """Two K1-bwd launches on the same inputs: one launch per call,
    gradients NHWC-contiguous in the level dtype, the second bitwise equal
    to the first, both within backward_tol of the plain scatter."""
    before = roi_align_cuda.roi_align_backward.launches
    got = roi_align_cuda.roi_align_backward(g, boxes, shapes, dt, STRIDES, out_size, sr)
    again = roi_align_cuda.roi_align_backward(g, boxes, shapes, dt, STRIDES, out_size, sr)
    torch.cuda.synchronize()
    assert roi_align_cuda.roi_align_backward.launches == before + 2
    want = t_ra.multilevel_roi_align_backward(g, boxes, shapes, [dt] * len(shapes), STRIDES,
                                              out_size, sr)
    for a, b, w, s in zip(got, again, want, shapes):
        assert a.shape == s and a.dtype == dt and a.is_contiguous()
        assert torch.equal(b, a)
        torch.testing.assert_close(a.float(), w.float(), **backward_tol(dt))


@pytest.mark.parametrize("boxes_name", BOX_SETS)
@pytest.mark.parametrize("out_size,sr", [(7, 2), (5, 3), (7, 1)])
@pytest.mark.parametrize("C", [5, 6, 64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_plain(card, dtype, C, out_size, sr, boxes_name):
    """K1-bwd against the plain scatter (check_backward): C = 5 and 6 take
    the scalar width, 64 and 256 the 16-byte vectors; (7, 2) the
    compile-time shape, the others the generic one."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(10)
    shapes = [(2, 256 // s, 256 // s, C) for s in STRIDES]
    boxes = torch.from_numpy(box_set(boxes_name, rng, 2, 50, 256)).to(card)
    g = torch.from_numpy(rng.normal(size=(2, 50, out_size, out_size, C)).astype(np.float32))
    check_backward(card, g.to(card, dt), boxes, shapes, dt, out_size, sr)


def backward_case(case, rng):
    """(boxes (B, R, 4), level shapes) of the geometry K1-bwd's tiles find
    hardest; B = 2, C = 256 unless the case says otherwise."""
    if case == "box sets":        # thousands of overlapping RoIs of every box set
        boxes = np.concatenate([box_set(n, rng, 2, 800, 256) for n in BOX_SETS], 1)
        return boxes, [(2, 256 // s, 256 // s, 256) for s in STRIDES]
    if case == "hot tile":        # 2000 RoIs on one 16 x 16 region of p2 (lines 16-31):
        # its four 8 x 8 tiles keep 500-700 RoIs each, more than a chunk of
        # 256 boxes (denser, the plain float32 scatter itself leaves the
        # float32 tolerance of a float64 sum)
        xy = rng.uniform(66.0, 120.0, (2, 2000, 2))
        wh = rng.uniform(0.2, 8.0, (2, 2000, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, 126.0)], -1)
        return boxes, [(2, 256 // s, 256 // s, 256) for s in STRIDES]
    if case == "elongated":       # p2 of a 1024 px canvas: 16 tiles a side to cross
        return (elongated_boxes(rng, 2, 300, 1024),
                [(2, 1024 // s, 1024 // s, 64) for s in STRIDES])
    if case == "ragged canvas":   # 480 x 640: p2 120 x 160 .. p6 8 x 10, on every border
        boxes = np.concatenate([border_boxes(rng, 2, 300, 640), edge_boxes(rng, 2, 100, 640)], 1)
        boxes[..., 1::2] *= 480.0 / 640.0
        return boxes, [(2, -(-480 // s), -(-640 // s), 256) for s in STRIDES]
    C = int(case.split("C=")[1])  # "misaligned g, C=n": g one element past 16 bytes
    return box_set("edge", rng, 2, 200, 256), [(2, 256 // s, 256 // s, C) for s in STRIDES]


@pytest.mark.parametrize("case", ["box sets", "hot tile", "elongated", "ragged canvas",
                                  "misaligned g, C=5", "misaligned g, C=64"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_many_rois(card, dtype, case):
    """check_backward where the tiles' RoI lists are long or odd: thousands
    of overlapping RoIs adding into the same pixels; more RoIs in one tile
    than a block holds at once; RoIs crossing many tiles on one axis;
    levels whose sides are not multiples of the tile, with boxes on all four
    borders; g at an address that is not 16-byte aligned (the scalar
    width)."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(11)
    boxes, shapes = backward_case(case, rng)
    boxes = torch.from_numpy(np.ascontiguousarray(boxes, np.float32)).to(card)
    n = 2 * boxes.shape[1] * 49 * shapes[0][-1]
    g = torch.randn(n + 8, device=card).to(dt)
    g = (g[1:n + 1] if case.startswith("misaligned") else g[:n]).view(2, -1, 7, 7, shapes[0][-1])
    assert case.startswith("misaligned") == bool(g.data_ptr() % 16)
    check_backward(card, g, boxes, shapes, dt)


def test_backward_no_rois_launches_nothing(card):
    before = roi_align_cuda.roi_align_backward.launches
    grads = roi_align_cuda.roi_align_backward(
        torch.zeros((2, 0, 7, 7, 64), device=card), torch.zeros((2, 0, 4), device=card),
        [(2, 64 // s, 64 // s, 64) for s in STRIDES], torch.float32, STRIDES)
    assert roi_align_cuda.roi_align_backward.launches == before
    assert all(g.shape == (2, 64 // s, 64 // s, 64) and not g.any()
               for g, s in zip(grads, STRIDES))


def test_pooler_autograd_on_card(card):
    """The pooler the heads call is differentiable in the levels on the card:
    backward through it launches K1-bwd once and gives the plain scatter's
    gradient; the boxes get none."""
    rng = np.random.default_rng(12)
    feats = [f.requires_grad_() for f in pyramid(card, torch.float32, rng, 64)]
    boxes = torch.from_numpy(box_set("levels", rng, 2, 40, 256)).to(card)
    out = roi_align_cuda.multilevel_roi_align(feats, boxes, STRIDES, 7, 2)
    g = torch.randn(out.shape, device=card)
    before = roi_align_cuda.roi_align_backward.launches
    got = torch.autograd.grad(out, feats, g)
    assert roi_align_cuda.roi_align_backward.launches == before + 1
    want = t_ra.multilevel_roi_align_backward(g, boxes, [f.shape for f in feats],
                                              [torch.float32] * 5, STRIDES)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **backward_tol(torch.float32))


def test_train_step_card_matches_cpu(card):
    """The small training step on the card against the CPU, and the heads'
    gradient reaching the FPN through K1-bwd (tests/torch_train_check.py)."""
    from torch_train_check import train_step_card_vs_cpu
    report = train_step_card_vs_cpu(card)
    assert report["heads_to_fpn_grad"] > 0


def test_small_model_card_matches_cpu(card):
    """The flagship meta-arch at the small float32 size: the same weights on
    the card (kernel pooler) and on the CPU (plain pooler) give the same
    detections, matched as sets (atol 1e-3: cuDNN's and the CPU's conv sums
    differ in order)."""
    from weakcube_tpu_torch.entry import dims_priors, make_batch, tiny_cfg
    from weakcube_tpu_torch.models.rcnn3d import build_model
    cfg = tiny_cfg(128, dla=True)
    pri = dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES)
    b_cpu = make_batch(2, 128, 128, seed=3, device="cpu")
    launches = roi_align_cuda.multilevel_roi_align.launches
    with torch.inference_mode():
        d_gpu = build_model(cfg, pri, device=card, seed=1)({k: v.to(card) for k, v in b_cpu.items()})
        d_cpu = build_model(cfg, pri, device="cpu", seed=1)(b_cpu)
    assert roi_align_cuda.multilevel_roi_align.launches == launches + 2
    for i in range(2):
        vg, vc = d_gpu.valid[i].cpu(), d_cpu.valid[i]
        assert int(vg.sum()) == int(vc.sum()) > 0
        j = match(d_cpu, d_gpu, i)
        for name in ("boxes", "scores3D", "centers3D"):
            torch.testing.assert_close(getattr(d_gpu, name)[i].cpu()[vg][j],
                                       getattr(d_cpu, name)[i][vc], atol=1e-3, rtol=1e-3)


def test_every_sync_lies_in_a_sync_span(card):
    """Under CUDA's sync debug mode, each sync that a small training step
    and a detection forward make on the card falls inside a `sync` span of
    utils/trace.py, one sync to a span: what the benchmark's host_ms_* and
    host_syncs_* readers take from the spans is what CUDA reports. The step
    syncs twice (the logs, the corner constant) and the forward not at
    all."""
    import time
    import warnings
    from weakcube_tpu_torch.entry import dims_priors, make_batch, tiny_batch, tiny_cfg
    from weakcube_tpu_torch.models.rcnn3d import build_model
    from weakcube_tpu_torch.parallel.train_step import create_train_state, train_step
    from weakcube_tpu_torch.utils import trace
    cfg = tiny_cfg(128, dla=True)
    model = build_model(cfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), device=card, seed=1)
    state, opt = create_train_state(cfg, model)
    batch = tiny_batch(2, 128, 128, device=card)
    state, _ = train_step(model, opt, state, batch, torch.Generator(card).manual_seed(0))
    images = make_batch(2, 128, 128, seed=3, device=card)
    seen = []
    trace.take()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda msg, *a, **k: seen.append((time.time_ns(), str(msg)))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                train_step(model, opt, state, batch, torch.Generator(card).manual_seed(1))
                with torch.inference_mode():
                    model.eval()(images)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    spans = trace.take()
    roots = [s for s in spans if s.parent is None]
    assert sorted(r.name for r in roots) == ["model.forward", "train.step"]
    syncs = [s for s in spans if s.name == "sync"]
    inside = [t for t, msg in seen if "synchroniz" in msg
              and any(r.start_ns <= t <= r.end_ns for r in roots)]
    assert len(inside) == len(syncs) == 2
    for t in inside:
        assert sum(s.start_ns <= t <= s.end_ns for s in syncs) == 1
    # the two sites, by root and parent span: the step's logs (train.step
    # itself) and the weak heads' corner constant (model.roi_heads). NMS
    # runs its kernel on the card, so neither the step's proposal selection
    # nor the detection forward (root model.forward) waits on the device
    ids = {s.id: s for s in spans}
    assert sorted((ids[s.root].name, ids[s.parent].name) for s in syncs) == [
        ("train.step", "model.roi_heads"), ("train.step", "train.step")]
    assert sum(s.name == "nms" for s in spans) == 3  # the step's RPN; the forward's RPN, boxes


def check_nms_call(call, card) -> torch.Tensor:
    """One NMS call on the card through the kernel (one launch), held bit
    for bit to the plain fixed point on the same CUDA tensors and on the
    CPU. Returns the kernel's mask on the CPU."""
    before = nms_ops.nms_mask.launches
    got = nms_boxes.run(call, card)
    torch.cuda.synchronize()
    n_problems = int(np.prod(call["boxes"].shape[:-2]))
    assert nms_ops.nms_mask.launches == before + (n_problems * call["boxes"].shape[-2] > 0)
    got = got.cpu()
    assert got.dtype == torch.bool and got.shape == call["boxes"].shape[:-1]
    assert torch.equal(got, nms_boxes.run(call, card, nms_ops.nms_mask_plain).cpu())
    assert torch.equal(got, nms_boxes.run(call, "cpu"))
    return got


@pytest.mark.parametrize("shape", ["rpn_train", "rpn_detect", "box_detect"])
def test_nms_kernel_matches_plain_at_the_cells_shapes(card, shape):
    """The cells' NMS calls (125 x 2000 with p5 / p6 padded, 40 x 1000, and
    8 x 1024 through batched_nms_mask with 38 classes), boxes drawn as
    near-duplicates around a few centres with bf16-tied scores: the
    kernel's keep mask equals the plain fixed point's, bit for bit."""
    call = nms_boxes.cell_call(shape, seed=11)
    got = check_nms_call(call, card)
    valid = call["valid"]
    assert 0 < int(got.sum()) < int(valid.sum())  # some kept, some suppressed
    assert not (got & ~valid).any()


@pytest.mark.parametrize("case", sorted(nms_boxes.ADVERSARIAL))
def test_nms_kernel_matches_plain_on_adversarial_sets(card, case):
    """Chains across the kernel's 64-box chunks, ties the stable order
    decides, padding, class offsets, NaN boxes, an IoU equal to the
    threshold, an FMA-sensitive union, every box invalid, n in
    {0, 1, 63, 64, 65}."""
    for call in nms_boxes.adversarial(case):
        check_nms_call(call, card)


@pytest.mark.parametrize("case", ["chain2000", "n2000", "n8192"])
def test_nms_kernel_matches_plain_at_depth_and_size(card, case):
    """A suppression chain of depth 2000 (the fixed point takes 2000 passes;
    one problem runs it backwards), and n = 2000 and 8192 near-duplicates."""
    rng = np.random.default_rng(12)
    if case == "chain2000":
        s = np.linspace(1.0, 0.1, 2000, dtype=np.float32)
        call = nms_boxes.nms_call(np.stack([nms_boxes.chain(2000)] * 2),
                                  np.stack([s, s[::-1]]), 0.3)
    else:
        n = int(case[1:])
        call = nms_boxes.nms_call(nms_boxes.near_duplicates(rng, (2, n), 1024.0),
                                  nms_boxes.bf16_scores(rng, (2, n)), 0.7)
    got = check_nms_call(call, card)
    if case == "chain2000":
        assert got[0].tolist() == [i % 2 == 0 for i in range(2000)]
        assert got[1].tolist() == [i % 2 == 1 for i in range(2000)]


def test_nms_kernel_refuses_what_it_does_not_take(card):
    boxes = torch.zeros((2, 5, 4), device=card)
    scores = torch.zeros((2, 5), device=card)
    with pytest.raises(TypeError, match="float32"):
        nms_ops.nms_mask(boxes.double(), scores, 0.5)
    with pytest.raises(ValueError, match="at most"):
        n = nms_ops.MAX_N + 1
        nms_ops.nms_mask(torch.zeros((1, n, 4), device=card), torch.zeros((1, n), device=card),
                         0.5)
    with pytest.raises(ValueError, match="one CUDA device"):
        nms_ops.nms_mask(boxes, scores.cpu(), 0.5)


def test_nms_on_card_records_no_sync(card):
    """On the card an nms_mask call is one `nms` span with nothing inside:
    no convergence check waits on the device."""
    from weakcube_tpu_torch.utils import trace
    call = {k: (v.to(card) if isinstance(v, torch.Tensor) else v)
            for k, v in nms_boxes.cell_call("rpn_detect", seed=13).items()}
    torch.cuda.synchronize()
    trace.take()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        torch.cuda.set_sync_debug_mode("error")
        try:
            nms_boxes.run(call, card)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    spans = trace.take()
    assert [s.name for s in spans] == ["nms"]


def test_detection_forward_nms_kernel_matches_plain(card, monkeypatch):
    """A b8 detection forward of the full-width model (512 px) with the
    kernel gives the same detections as the same forward with nms_mask
    patched to the plain fixed point on the same CUDA tensors."""
    from weakcube_tpu_torch.entry import dims_priors, flagship_cfg, make_batch
    from weakcube_tpu_torch.models.rcnn3d import build_model
    cfg = flagship_cfg(512)
    model = build_model(cfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), device=card, seed=1)
    images = make_batch(8, 512, 512, seed=4, device=card)
    before = nms_ops.nms_mask.launches
    with torch.inference_mode():
        got = model.eval()(images)
        torch.cuda.synchronize()
        assert nms_ops.nms_mask.launches == before + 2  # the RPN's and the box NMS
        monkeypatch.setattr(nms_ops, "nms_mask", nms_ops.nms_mask_plain)
        want = model(images)
    assert int(got.valid.sum()) > 0
    for name in ("valid", "classes", "boxes", "scores", "scores3D", "centers3D"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def match(a, b, i):
    """Image i's valid detections of a matched greedily to b's by class,
    score and box (clipped degenerate boxes may repeat)."""
    def key(d):
        v = d.valid[i].cpu()
        return torch.cat([d.boxes[i].cpu(), 1e3 * d.scores[i].cpu()[:, None],
                          1e6 * d.classes[i].cpu()[:, None].float()], -1)[v]
    dist = torch.cdist(key(a), key(b), p=float("inf"))
    j = []
    for row in dist:
        row = row.clone()
        row[j] = float("inf")
        j.append(int(row.argmin()))
    return torch.tensor(j, dtype=torch.long)


def attention_inputs(card, dt, N, layout, B=2, H=3):
    """q, k, v of (B, H, N, 64): contiguous, or the views of a fused qkv
    projection's (B, N, 3, H, 64) output, as the depth encoder passes them."""
    g = torch.Generator(device=card).manual_seed(N)
    if layout == "contiguous":
        return [torch.randn((B, H, N, 64), generator=g, device=card).to(dt) for _ in range(3)]
    qkv = torch.randn((B, N, 3 * H * 64), generator=g, device=card).to(dt)
    return list(qkv.reshape(B, N, 3, H, 64).permute(2, 0, 3, 1, 4).unbind(0))


@pytest.mark.parametrize("layout", ["contiguous", "projection"])
@pytest.mark.parametrize("N", [1, 50, 63, 64, 65, 127, 128, 129, 197, 1370])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_matches_plain(card, dtype, N, layout):
    """Tile edges (64 and 128 rows or keys) and ragged tiles, a single token,
    contiguous inputs and projection views. bfloat16: P and O are each
    rounded to bf16 once, in other places than the plain version's
    (atol 2e-2, rtol 2e-2); float32: the same math in another order, online
    softmax (atol 1e-5). One launch per call; the output is a (B, H, N, 64)
    view of (B, N, H, 64) memory."""
    dt = getattr(torch, dtype)
    q, k, v = attention_inputs(card, dt, N, layout)
    before = flash_attention_cuda.flash_attention.launches
    got = flash_attention_cuda.flash_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert flash_attention_cuda.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == dt
    assert got.transpose(1, 2).is_contiguous()
    want = attention(q, k, v, 0.125)
    tol = dict(atol=1e-5, rtol=1e-5) if dt == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_flash_attention_refuses_what_it_does_not_take(card):
    q = torch.zeros((1, 2, 10, 64), device=card, dtype=torch.bfloat16)
    before = flash_attention_cuda.flash_attention.launches
    with pytest.raises(TypeError):
        flash_attention_cuda.flash_attention(q.half(), q.half(), q.half(), 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(2, 3).contiguous().transpose(2, 3)
        flash_attention_cuda.flash_attention(t, t, t, 0.125)
    with pytest.raises(ValueError, match="expected all"):
        flash_attention_cuda.flash_attention(q, q, q.cpu(), 0.125)
    assert flash_attention_cuda.flash_attention.launches == before


def rel_pos_inputs(card, B, H, kh, kw, scale=2.0):
    """A decomposed relative-position bias for (B, H, kh * kw) queries:
    float32 (B, H, N, kh) and (B, H, N, kw), N(0, scale)."""
    g = torch.Generator(device=card).manual_seed(kh * 1000 + kw)
    N = kh * kw
    return (scale * torch.randn((B, H, N, kh), generator=g, device=card),
            scale * torch.randn((B, H, N, kw), generator=g, device=card))


# SAM-HQ's shapes at 1024 px (windowed: 14 x 14 tokens, B = 25 windows an
# image; global: 64 x 64), B x H chosen so that the work tiles do not fill
# whole rounds of the grid; small and ragged key grids beside them
RELPOS_SHAPES = {"windowed": (7, 16, 14, 14), "global": (1, 3, 64, 64), "small": (2, 3, 4, 6),
                 "ragged": (3, 2, 10, 20), "tiny_global": (1, 3, 16, 16)}


@pytest.mark.parametrize("layout", ["contiguous", "projection"])
@pytest.mark.parametrize("shape", sorted(RELPOS_SHAPES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_relpos_matches_plain(card, dtype, shape, layout):
    """K2 with SAM's decomposed relative-position bias against the plain
    version's explicit (N, N) sum, at the windowed and global shapes and
    ragged ones; tolerances as without the bias. One launch per call, and a
    second launch gives the same bits."""
    dt = getattr(torch, dtype)
    B, H, kh, kw = RELPOS_SHAPES[shape]
    q, k, v = attention_inputs(card, dt, kh * kw, layout, B=B, H=H)
    rel = rel_pos_inputs(card, B, H, kh, kw)
    before = flash_attention_cuda.flash_attention.launches
    got = flash_attention_cuda.flash_attention(q, k, v, 0.125, rel_pos=rel)
    again = flash_attention_cuda.flash_attention(q, k, v, 0.125, rel_pos=rel)
    torch.cuda.synchronize()
    assert flash_attention_cuda.flash_attention.launches == before + 2
    assert got.shape == q.shape and got.dtype == dt and got.transpose(1, 2).is_contiguous()
    assert torch.equal(got, again)
    want = attention(q, k, v, 0.125, rel)
    tol = dict(atol=1e-5, rtol=1e-5) if dt == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    # the bias moves the output: the unbiased kernel is far from it
    assert (flash_attention_cuda.flash_attention(q, k, v, 0.125).float() - want.float()
            ).abs().max() > 0.1


def test_flash_attention_relpos_refuses_what_it_does_not_take(card):
    q = torch.zeros((1, 2, 24, 64), device=card, dtype=torch.bfloat16)
    bh, bw = rel_pos_inputs(card, 1, 2, 4, 6)
    before = flash_attention_cuda.flash_attention.launches
    for rel, match in (((bh.bfloat16(), bw), "float32"), ((bh, bw.cpu()), "float32"),
                       ((bh, bw[..., :5]), "key grid"), ((bh[..., :3], bw), "key grid"),
                       ((bh.transpose(-1, -2).contiguous().transpose(-1, -2), bw),
                        "contiguous"), ((bh[:, :1], bw), "expected")):
        with pytest.raises(ValueError, match=match):
            flash_attention_cuda.flash_attention(q, q, q, 0.125, rel_pos=rel)
    odd = torch.zeros((1, 2, 15, 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="kw even"):
        flash_attention_cuda.flash_attention(odd, odd, odd, 0.125,
                                             rel_pos=rel_pos_inputs(card, 1, 2, 5, 3))
    wide = torch.zeros((1, 1, 4 * 130, 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="132"):
        flash_attention_cuda.flash_attention(wide, wide, wide, 0.125,
                                             rel_pos=rel_pos_inputs(card, 1, 1, 4, 130))
    assert flash_attention_cuda.flash_attention.launches == before


def test_small_sam_card_matches_cpu(card):
    """SAM-HQ vit_tiny at 256 px in float32 from one seeded model, on the
    card (K2's float32 path with the bias, cuDNN with TF32 off) and on the
    CPU (plain attention): mask logits within 1e-4 of their scale. 12 K2
    launches a forward."""
    from weakcube_tpu_torch.data.pseudo_gt import sam as sam_mod
    m_cpu = sam_mod.init_random_(sam_mod.Sam("vit_tiny", 256), seed=3).eval()
    m_gpu = sam_mod.init_random_(sam_mod.Sam("vit_tiny", 256), seed=3).to(card).eval()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 256, 256, 3)).astype(np.float32))
    boxes = torch.tensor([[[30.0, 100.0, 900.0, 1000.0]], [[0.0, 500.0, 1024.0, 1024.0]]])
    before = flash_attention_cuda.flash_attention.launches
    with torch.inference_mode():
        got, want = m_gpu(x.to(card), boxes.to(card)), m_cpu(x, boxes)
    assert flash_attention_cuda.flash_attention.launches == before + 12
    assert got.shape == (2, 1, 64, 64)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4 * float(want.abs().max()), rtol=0)


def test_small_depth_model_card_matches_cpu(card):
    """Depth Anything V2 ViT-S at 98 px (N = 50) in float32 from one seeded
    state dict, on the card (K2's float32 path, cuDNN convs with TF32 off,
    the resize kernel) and on the CPU (plain attention, F.interpolate):
    depth within 1e-3 m. 12 K2 launches, 5 resize launches."""
    from weakcube_tpu_torch.data.generate_depth_maps import load_model
    m_cpu = load_model(None, "vits", input_size=98, device="cpu", dtype=torch.float32)
    m_gpu = load_model(None, "vits", input_size=98, device=card, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 98, 98, 3)).astype(np.float32))
    before = flash_attention_cuda.flash_attention.launches
    resizes = bilinear_resize_cuda.bilinear_resize.launches
    with torch.inference_mode():
        d_gpu, d_cpu = m_gpu(x.to(card)), m_cpu(x)
    assert flash_attention_cuda.flash_attention.launches == before + 12
    assert bilinear_resize_cuda.bilinear_resize.launches == resizes + 5
    assert float(d_cpu.std()) > 1e-3
    torch.testing.assert_close(d_gpu.cpu(), d_cpu, atol=1e-3, rtol=0)


def test_ransac_card_vs_cpu(card):
    """ransac_plane on 3 tilted, noisy ground clouds with 300 injected draws
    on the card against the CPU (tests/torch_geometry_check.py: inlier
    counts within 0.1% of the valid points, planes within 1e-5 where the
    same hypothesis wins, else |cos| > 0.9999)."""
    from torch_geometry_check import ransac_card_vs_cpu
    rep = ransac_card_vs_cpu(card, 3, 480, 640, 300, seed=1)
    assert rep["min_cos_to_truth"] > 0.999


def test_iou3d_card_vs_cpu(card):
    """matched_iou3d on 200 identical, contained, touching, disjoint and
    overlapping pairs on the card against the CPU (float32, atol 1e-5)."""
    from torch_geometry_check import iou3d_card_vs_cpu
    iou3d_card_vs_cpu(card, 200, seed=1)


# ------------------------------------------------- BatchNorm training kernels
BN_SIZES = {16: (32, 32), 64: (16, 16), 116: (8, 8), 512: (4, 4)}  # C -> (H, W) at N = 25


def bn_inputs(card, dt, C, size=None, seed=0):
    """x and g of (25, C, H, W) in NHWC memory (channels_last) in dt, and
    float32 (weight, bias, running_mean, running_var). x's channels have
    means ~N(0, 1) and spreads in 0.5-2, but channel 1 a mean of 64 against
    a spread of 0.25 and channel 2 the constant 0.75 (its variance clamps
    to 0)."""
    H, W = size or BN_SIZES[C]
    rng = np.random.default_rng(seed + C)
    mean, spread = rng.normal(size=C), rng.uniform(0.5, 2.0, size=C)
    if C > 2:
        mean[1], spread[1] = 64.0, 0.25
        mean[2], spread[2] = 0.75, 0.0

    def nhwc(a):
        return torch.from_numpy(a.astype(np.float32)).to(card, dt).permute(0, 3, 1, 2)
    x = nhwc(rng.normal(size=(25, H, W, C)) * spread + mean)
    g = nhwc(rng.normal(size=(25, H, W, C)))
    params = [torch.from_numpy(a.astype(np.float32)).to(card) for a in (
        rng.uniform(0.5, 1.5, C), rng.normal(size=C), rng.normal(size=C),
        rng.uniform(0.5, 2.0, C))]
    return x, g, params


def bn_module(card, params, param_dtype=torch.float32):
    bn = BatchNorm2d(params[0].shape[0]).to(card, param_dtype)
    with torch.no_grad():
        for t, v in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var), params):
            t.copy_(v)
    return bn


def bn_run(card, x, g, params, plain=False, param_dtype=torch.float32, misalign=False):
    """A training-mode BatchNorm2d on x, its backward from g: (y, pending
    mean, pending var, dx, grad weight, grad bias), through the kernels or
    (plain) the plain chain on the same CUDA tensors; the module's
    parameters and statistics in param_dtype, and (misalign) x a view one
    element into its storage."""
    bn = bn_module(card, params, param_dtype)
    if misalign:
        N, C, H, W = x.shape
        flat = torch.cat([x.new_zeros(1), x.permute(0, 2, 3, 1).reshape(-1)])
        xi = flat.requires_grad_()[1:].view(N, H, W, C).permute(0, 3, 1, 2)
        xi.retain_grad()
    else:
        xi = x.detach().clone().requires_grad_()
    with mock.patch.object(batch_norm_cuda, "takes", lambda *a: False) if plain \
            else contextlib.nullcontext():
        y = bn(xi)
        y.backward(g)
    return (y.detach(), *bn.pending, xi.grad, bn.weight.grad, bn.bias.grad)


def bn_oracle(x, g, params):
    """The same six in float64: flax's statistics, autograd's gradient."""
    x = x.double().requires_grad_()
    w, b = (p.double().requires_grad_() for p in params[:2])
    mean = x.mean((0, 2, 3))
    var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp(min=0.0)
    y = (x - mean[:, None, None]) * (torch.rsqrt(var + 1e-5) * w)[:, None, None] \
        + b[:, None, None]
    y.backward(g.double())
    return (y.detach(), 0.9 * params[2].double() + 0.1 * mean.detach(),
            0.9 * params[3].double() + 0.1 * var.detach(), x.grad, w.grad, b.grad)


def bn_launches():
    return (batch_norm_cuda.batch_norm_train.launches,
            batch_norm_cuda.batch_norm_train_backward.launches)


BN_OUTPUTS = ("y", "pending mean", "pending var", "dx", "grad weight", "grad bias")


@pytest.mark.parametrize("C", sorted(BN_SIZES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_batch_norm_kernels_match_float64(card, dtype, C):
    """The kernels and the plain chain against float64 on (25, C, H, W),
    C = 16, 64 and 512 on the 16-byte vector path, 116 on the scalar one,
    with a channel whose mean is 256 times its spread and a constant one:
    each of y, the pending statistics and the gradients of x, weight and
    bias within three times the plain chain's own error (largest gap over
    the largest value; one float32 rounding where the plain chain is
    exact). Two launches forward and two backward; y and dx in x's dtype
    and layout."""
    dt = getattr(torch, dtype)
    x, g, params = bn_inputs(card, dt, C)
    before = bn_launches()
    got = bn_run(card, x, g, params)
    torch.cuda.synchronize()
    assert bn_launches() == (before[0] + 2, before[1] + 2)
    plain = bn_run(card, x, g, params, plain=True)
    assert bn_launches() == (before[0] + 2, before[1] + 2)
    want = bn_oracle(x, g, params)
    for name, a, p, w in zip(BN_OUTPUTS, got, plain, want):
        assert a.dtype == p.dtype and a.shape == p.shape, name
        err_k, err_p = [float((t.double() - w).abs().max() / w.abs().max()) for t in (a, p)]
        assert err_k <= max(3 * err_p, 2.0 ** -24), \
            f"{name}: kernels {err_k:.3e} against the plain chain's {err_p:.3e}"
    for t in (got[0], got[3]):
        assert t.dtype == dt and t.is_contiguous(memory_format=torch.channels_last)


# the b25 step's DLA-34 BatchNorm shapes at 512 px, ShuffleNetV2's 116, and
# small ragged ones (C = 6: two channels a thread in the statistics)
BN_STEP_SHAPES = [(25, 16, 512, 512), (25, 32, 256, 256), (25, 64, 128, 128), (25, 128, 64, 64),
                  (25, 256, 32, 32), (25, 512, 16, 16), (25, 116, 8, 8), (3, 24, 5, 7),
                  (2, 6, 1, 9)]


@pytest.mark.parametrize("shape", BN_STEP_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_batch_norm_forward_is_the_plain_chain_bit_for_bit(card, dtype, shape):
    """The statistics kernel sums x and x^2 in the order of PyTorch's own
    reduction of the plain chain's float32 tensors and finishes, and the
    normalisation rounds, op by op as the chain does: y and the pending
    statistics equal the plain chain's bit for bit (a rounding-level change
    there moves the RPN's top-k and the sampled RoIs of a step)."""
    N, C, H, W = shape
    g = torch.Generator(device=card).manual_seed(C)
    x = (torch.randn((N, H, W, C), generator=g, device=card) * 1.5 + 0.5).to(
        getattr(torch, dtype)).permute(0, 3, 1, 2)
    params = [torch.rand(C, generator=g, device=card) + 0.5 for _ in range(4)]
    outs = []
    for plain in (False, True):
        bn = bn_module(card, params)
        with torch.no_grad(), (mock.patch.object(batch_norm_cuda, "takes", lambda *a: False)
                               if plain else contextlib.nullcontext()):
            before = bn_launches()
            outs.append((bn(x), *bn.pending))
            assert bn_launches() == (before if plain else (before[0] + 2, before[1]))
    for name, a, b in zip(("y", "pending mean", "pending var"), *outs):
        assert torch.equal(a, b), f"{name}: {int((a != b).sum())} of {a.numel()} differ"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_batch_norm_kernels_same_bits_twice(card, dtype):
    """(25, 16, 128, 128): 409600 rows over a full grid of row chunks; two
    calls give the same bits in all six outputs (no float atomics)."""
    x, g, params = bn_inputs(card, getattr(torch, dtype), 16, size=(128, 128))
    first, second = bn_run(card, x, g, params), bn_run(card, x, g, params)
    for name, a, b in zip(BN_OUTPUTS, first, second):
        assert torch.equal(a, b), name


def test_batch_norm_without_grad_saves_nothing(card):
    """Under no_grad, and with nothing requiring a gradient, a training call
    is the two forward launches and nothing else: no graph, the same y and
    pending statistics bit for bit as the call with a gradient."""
    x, g, params = bn_inputs(card, torch.bfloat16, 64)
    full = bn_run(card, x, g, params)
    bn = bn_module(card, params)
    before = bn_launches()
    with torch.no_grad():
        y = bn(x)
    assert bn_launches() == (before[0] + 2, before[1])
    assert y.grad_fn is None
    for a, b in zip((y, *bn.pending), full[:3]):
        assert torch.equal(a, b)
    bn.weight.requires_grad_(False)
    bn.bias.requires_grad_(False)
    y = bn(x)
    assert bn_launches() == (before[0] + 4, before[1]) and y.grad_fn is None


@pytest.mark.parametrize("case", ["float64", "nchw"])
def test_batch_norm_plain_inputs_on_card(card, case):
    """CUDA tensors the kernels do not take (float64, an NCHW-contiguous
    tensor) run the plain chain: no launch, the plain chain's bits."""
    x, g, params = bn_inputs(card, torch.float32, 64)
    x, g = (x.double(), g.double()) if case == "float64" else (x.contiguous(), g.contiguous())
    before = bn_launches()
    got = bn_run(card, x, g, params)
    want = bn_run(card, x, g, params, plain=True)
    assert bn_launches() == before
    for name, a, b in zip(BN_OUTPUTS, got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case", ["one_channel", "many_channels", "misaligned", "bf16_params"])
def test_batch_norm_kernels_take_every_card_input(card, case):
    """Channels_last CUDA inputs that are not the b25 step's run the kernels
    too, never the plain chain: one channel (25, 1, 16, 16); 140001
    channels at one pixel (1094 column chunks: the counters grow); a bf16 x
    one element into its storage (the scalar path, one channel a load in
    the statistics); bf16 parameters and statistics (read as float32, the
    pending statistics back in bf16). Two launches forward and two
    backward, and each output within three times the plain chain's own
    error against float64, as in test_batch_norm_kernels_match_float64,
    or within five float32 roundings of its value: with one channel the
    largest error is one number, and both paths share r = rsqrtf(v + eps)
    bit for bit, up to 2 ulp (4 roundings) from float64's, before the
    gradient's own product rounds once more (the plain chain's sum can
    cancel part of r's error by chance: 3.1e-8 against the kernels'
    1.0e-7 on the card)."""
    C, size = {"one_channel": (1, (16, 16)), "many_channels": (140001, (1, 1))}.get(case,
                                                                                   (64, None))
    x, g, params = bn_inputs(card, torch.bfloat16, C, size)
    pdt = torch.bfloat16 if case == "bf16_params" else torch.float32
    params = [p.to(pdt).float() for p in params]
    opts = dict(param_dtype=pdt, misalign=case == "misaligned")
    before = bn_launches()
    got = bn_run(card, x, g, params, **opts)
    assert bn_launches() == (before[0] + 2, before[1] + 2)
    plain = bn_run(card, x, g, params, plain=True, **opts)
    want = bn_oracle(x, g, params)
    for name, a, p, w in zip(BN_OUTPUTS, got, plain, want):
        assert a.dtype == p.dtype and a.shape == p.shape, name
        err_k, err_p = [float((t.double() - w).abs().max() / w.abs().max()) for t in (a, p)]
        assert err_k <= max(3 * err_p, 5 * 2.0 ** -24), \
            f"{name}: kernels {err_k:.3e} against the plain chain's {err_p:.3e}"


def test_batch_norm_kernels_take_one_row(card):
    """(1, 24, 1, 1): one value a channel. The kernels take it: y (the
    bias) and the pending statistics are the plain chain's bit for bit, and
    dx (zero but for rounding), grad weight and grad bias within one
    float32 rounding of the largest |g * weight| of the plain chain's."""
    x, g, params = bn_inputs(card, torch.float32, 24, (1, 1))
    x, g = x[:1], g[:1]
    before = bn_launches()
    got = bn_run(card, x, g, params)
    assert bn_launches() == (before[0] + 2, before[1] + 2)
    plain = bn_run(card, x, g, params, plain=True)
    for name, a, b in zip(BN_OUTPUTS[:3], got, plain):
        assert torch.equal(a, b), name
    scale = float((g.abs().amax((0, 2, 3)) * params[0].abs() * 316.3).max())  # rsqrt(1e-5)
    for name, a, b in zip(BN_OUTPUTS[3:], got[3:], plain[3:]):
        assert float((a - b).abs().max()) <= 2.0 ** -23 * scale, name


def test_batch_norm_kernels_take_a_large_tensor(card):
    """(2, 16, 4096, 4100) bfloat16: its float32 copy passes 2^31 bytes, so
    PyTorch's reduction splits it; the kernels index in 64 bits and keep
    their own order. Each output within three times the plain chain's own
    error against float64 (computed a batch entry at a time)."""
    N, C, H, W = 2, 16, 4096, 4100
    gen = torch.Generator(device=card).manual_seed(3)
    x = (torch.randn((N, H, W, C), generator=gen, device=card) * 1.5 + 0.5).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    g = torch.randn((N, H, W, C), generator=gen, device=card).to(torch.bfloat16).permute(
        0, 3, 1, 2)
    params = [torch.rand(C, generator=gen, device=card) + 0.5 for _ in range(4)]
    before = bn_launches()
    got = bn_run(card, x, g, params)
    assert bn_launches() == (before[0] + 2, before[1] + 2)
    plain = bn_run(card, x, g, params, plain=True)
    R = N * H * W
    w, b, rm, rv = (p.double() for p in params)
    s1 = sum(x[n].double().sum((1, 2)) for n in range(N))
    s2 = sum(x[n].double().square().sum((1, 2)) for n in range(N))
    m = s1 / R
    v = (s2 / R - m * m).clamp(min=0.0)
    r = torch.rsqrt(v + 1e-5)
    a = r * w
    sg = sum(g[n].double().sum((1, 2)) for n in range(N))
    sgx = sum((g[n].double() * (x[n].double() - m[:, None, None])).sum((1, 2)) for n in range(N))
    vectors = {"pending mean": 0.9 * rm + 0.1 * m, "pending var": 0.9 * rv + 0.1 * v,
               "grad weight": sgx * r, "grad bias": sg}
    err = {}
    for name, want in vectors.items():
        i = BN_OUTPUTS.index(name)
        err[name] = [float((t[i].double() - want).abs().max() / want.abs().max())
                     for t in (got, plain)]
    k, c = (a / R)[:, None, None], (a * r * r * sgx / R)[:, None, None]
    for name in ("y", "dx"):
        i = BN_OUTPUTS.index(name)
        gaps, top = [0.0, 0.0], 0.0
        for n in range(N):
            xc = x[n].double() - m[:, None, None]
            want = (xc * a[:, None, None] + b[:, None, None] if name == "y"
                    else g[n].double() * a[:, None, None] - k * sg[:, None, None] - c * xc)
            top = max(top, float(want.abs().max()))
            gaps = [max(q, float((t[i][n].double() - want).abs().max()))
                    for q, t in zip(gaps, (got, plain))]
        err[name] = [q / top for q in gaps]
    for name, (err_k, err_p) in err.items():
        assert err_k <= max(3 * err_p, 2.0 ** -24), \
            f"{name}: kernels {err_k:.3e} against the plain chain's {err_p:.3e}"


@pytest.mark.parametrize("case", ["empty", "parameters_on_the_cpu"])
def test_batch_norm_refused_card_input_raises(card, case):
    """A channels_last CUDA input the kernels cannot take raises, and runs
    neither the kernels nor the plain chain: an empty batch (no statistics
    to take), a module whose parameters are on the CPU."""
    x = torch.randn((0 if case == "empty" else 4, 16, 3, 3), device=card).contiguous(
        memory_format=torch.channels_last)
    bn = BatchNorm2d(16).train()
    if case == "empty":
        bn = bn.to(card)
    before = bn_launches()
    with pytest.raises(ValueError):
        bn(x)
    assert bn_launches() == before and bn.pending is None


# ------------------------------------------------- the DPT head's bilinear resize
# (C, side in, side out): the head's five resizes at ViT-L 518 px, and at
# ViT-S 98 px (the small float32 model above)
DPT_RESIZES = [(256, 19, 37), (256, 37, 74), (256, 74, 148), (256, 148, 296), (128, 296, 518)]
VITS_RESIZES = [(64, 4, 7), (64, 7, 14), (64, 14, 28), (64, 28, 56), (32, 56, 98)]


def resize_input(card, N, C, hw, dt, seed, scale=1.0):
    """(N, C, H, W) channels_last, N(0, scale^2) in dt."""
    g = torch.Generator(device=card).manual_seed(seed)
    return (torch.randn((N, *hw, C), generator=g, device=card) * scale).to(dt).permute(0, 3, 1, 2)


def check_resize(x, size):
    """One kernel launch, a new channels_last tensor of x's dtype, ATen's
    F.interpolate bit for bit."""
    before = bilinear_resize_cuda.bilinear_resize.launches
    with torch.inference_mode():
        got = bilinear_resize_cuda.bilinear_resize(x, size)
        want = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
    torch.cuda.synchronize()
    assert bilinear_resize_cuda.bilinear_resize.launches == before + 1
    assert got.dtype == x.dtype and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    n_off = int((got != want).sum())
    assert n_off == 0, f"{n_off} of {got.numel()} elements differ from ATen"


@pytest.mark.parametrize("shape", range(len(DPT_RESIZES)))
@pytest.mark.parametrize("N", [16, 1])
def test_resize_kernel_is_aten_at_the_head_shapes(card, N, shape):
    """bf16 at the depth cell's shapes (b16) and at b1."""
    C, n_in, n_out = DPT_RESIZES[shape]
    check_resize(resize_input(card, N, C, (n_in, n_in), torch.bfloat16, shape), (n_out, n_out))


@pytest.mark.parametrize("shape", range(len(VITS_RESIZES)))
def test_resize_kernel_is_aten_at_the_small_model_shapes(card, shape):
    """float32 at ViT-S 98 px's shapes, b2."""
    C, n_in, n_out = VITS_RESIZES[shape]
    check_resize(resize_input(card, 2, C, (n_in, n_in), torch.float32, shape), (n_out, n_out))


RESIZE_EDGES = {"C3": (3, (13, 17), (50, 33)), "C5 down": (5, (50, 33), (13, 17)),
                "H_out 1": (24, (9, 11), (1, 40)), "H_in 1": (24, (1, 11), (30, 7)),
                "one pixel": (16, (1, 1), (5, 5)), "equal": (40, (9, 9), (9, 9)),
                "large values": (64, (31, 29), (97, 61))}


@pytest.mark.parametrize("case", sorted(RESIZE_EDGES) + ["sliced view", "misaligned"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_resize_kernel_is_aten_at_the_edges(card, dtype, case):
    """Channel counts below a vector (one or two channels a thread), one
    output or input row, a single pixel, equal sizes, values of 1e4, and
    inputs whose pixel stride (70) or pointer (one element in) narrow the
    vector."""
    dt = getattr(torch, dtype)
    if case == "sliced view":
        x = resize_input(card, 2, 70, (21, 23), dt, 1)[:, 4:68]
        assert bilinear_resize_cuda.vec_width(x) == 2
        check_resize(x, (40, 44))
    elif case == "misaligned":
        flat = torch.randn(2 * 15 * 15 * 64 + 1, device=card).to(dt)
        x = flat[1:].view(2, 15, 15, 64).permute(0, 3, 1, 2)
        assert bilinear_resize_cuda.vec_width(x) == 1
        check_resize(x, (29, 29))
    else:
        C, hw_in, hw_out = RESIZE_EDGES[case]
        check_resize(resize_input(card, 2, C, hw_in, dt, 2, 1e4 if case == "large values"
                                  else 1.0), hw_out)


def test_resize_kernel_refuses_what_it_does_not_take(card):
    """NCHW, float16, a CPU/CUDA mix of input and output, and an input that
    asks for a gradient raise ValueError, and nothing is launched."""
    x = resize_input(card, 2, 16, (5, 5), torch.bfloat16, 3)
    out = torch.empty((2, 16, 9, 9), dtype=torch.bfloat16, device=card).contiguous(
        memory_format=torch.channels_last)
    before = bilinear_resize_cuda.bilinear_resize.launches
    with pytest.raises(ValueError, match="NCHW"):
        bilinear_resize_cuda.bilinear_resize(x.contiguous(), (9, 9))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        bilinear_resize_cuda.bilinear_resize(x.half(), (9, 9))
    with pytest.raises(ValueError, match="one CUDA device"):
        bilinear_resize_cuda.launch(x, out.cpu())
    with pytest.raises(ValueError, match="one CUDA device"):
        bilinear_resize_cuda.launch(x.cpu(), out)
    with pytest.raises(ValueError, match="gradient"):
        bilinear_resize_cuda.bilinear_resize(x.float().requires_grad_(), (9, 9))
    assert bilinear_resize_cuda.bilinear_resize.launches == before
