"""weakcube_tpu_torch on the card (marker `cuda`; each test skips without a
CUDA device). This file imports nothing of JAX, so it also runs where JAX
is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

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


def test_small_depth_model_card_matches_cpu(card):
    """Depth Anything V2 ViT-S at 98 px (N = 50) in float32 from one seeded
    state dict, on the card (K2's float32 path, cuDNN convs with TF32 off)
    and on the CPU (plain attention): depth within 1e-3 m. 12 launches."""
    from weakcube_tpu_torch.data.generate_depth_maps import load_model
    m_cpu = load_model(None, "vits", input_size=98, device="cpu", dtype=torch.float32)
    m_gpu = load_model(None, "vits", input_size=98, device=card, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 98, 98, 3)).astype(np.float32))
    before = flash_attention_cuda.flash_attention.launches
    with torch.inference_mode():
        d_gpu, d_cpu = m_gpu(x.to(card)), m_cpu(x)
    assert flash_attention_cuda.flash_attention.launches == before + 12
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
