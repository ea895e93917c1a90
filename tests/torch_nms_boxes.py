"""NMS problems for the tests and chip_smoke.py: boxes drawn the way the RPN
and the box head give them, adversarial sets, and textbook sequential greedy
NMS. Imports nothing of JAX."""
from fractions import Fraction

import numpy as np
import torch

from weakcube_tpu_torch.ops.boxes import pairwise_iou
from weakcube_tpu_torch.ops.nms import NEG_INF

# the cells' NMS calls: (problems, boxes per problem, valid boxes per level)
# for the RPN (b25 x 5 levels at 512 px, PRE_NMS_TOPK_TRAIN 2000; b8 x 5 at
# 704 x 512, PRE_NMS_TOPK_TEST 1000: p5 and p6 hold fewer anchors than the
# top-k and are padded), and the box NMS (b8, candidate_topk 1024, 38 classes)
RPN_TRAIN = (25, 2000, (2000, 2000, 2000, 768, 192), 0.7)
RPN_DETECT = (8, 1000, (1000, 1000, 1000, 1000, 264), 0.7)
BOX_DETECT = (8, 1024, 38, 0.5)


def greedy_nms(boxes, scores, thr, valid=None) -> np.ndarray:
    """Textbook sequential greedy NMS over one problem: visit the boxes by
    descending score, ties in index order, and keep a valid box unless a kept
    box has IoU > thr with it. The IoUs are ops/boxes.py::pairwise_iou's, in
    the boxes' dtype."""
    boxes = torch.as_tensor(boxes)
    scores = torch.as_tensor(scores).float().numpy()
    n = len(scores)
    valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
    iou = pairwise_iou(boxes, boxes).numpy()
    thr = iou.dtype.type(thr)
    keep = np.zeros(n, bool)
    for i in np.argsort(-scores, kind="stable"):
        keep[i] = valid[i] and not any(iou[j, i] > thr for j in np.flatnonzero(keep))
    return keep


def near_duplicates(rng, shape, size: float, per_centre: int = 40) -> np.ndarray:
    """float32 XYXY boxes of `shape` + (4,) inside [0, size]^2, as a head with
    random weights proposes them: clusters of near-duplicates (centre jitter
    of 3 px, sizes within ~15%) around a few centres, and a tenth of the boxes
    anywhere."""
    shape = tuple(shape)
    n = shape[-1]
    lead = int(np.prod(shape[:-1]))
    k = max(1, n // per_centre)
    centre = rng.uniform(0, size, (lead, k, 2))
    base = np.exp(rng.uniform(np.log(12), np.log(size / 2), (lead, k, 2)))
    which = rng.integers(0, k, (lead, n))
    rows = np.arange(lead)[:, None]
    c = centre[rows, which] + rng.normal(0, 3, (lead, n, 2))
    wh = base[rows, which] * np.exp(rng.normal(0, 0.15, (lead, n, 2)))
    far = rng.random((lead, n)) < 0.1
    c[far] = rng.uniform(0, size, (int(far.sum()), 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).clip(0, size)
    return boxes.reshape(shape + (4,)).astype(np.float32)


def bf16_scores(rng, shape) -> torch.Tensor:
    """Normal logits rounded to bfloat16 (8 bits: many tied scores)."""
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)


def rpn_problem(rng, images: int, k: int, counts, size: float = 512.0):
    """select_proposals' NMS input: (images, levels, k) problems, level l's
    first counts[l] boxes valid, the rest zero boxes scored NEG_INF."""
    L = len(counts)
    boxes = near_duplicates(rng, (images, L, k), size)
    scores = bf16_scores(rng, (images, L, k))
    valid = np.arange(k)[None, None] < np.array(counts)[None, :, None]
    valid = np.broadcast_to(valid, (images, L, k)).copy()
    boxes[~valid] = 0
    scores[torch.from_numpy(~valid)] = NEG_INF
    return torch.from_numpy(boxes), scores, torch.from_numpy(valid)


def box_problem(rng, images: int, k: int, classes: int, size: float = 512.0):
    """fast_rcnn_inference's NMS input: top-k (roi, class) candidates per
    image, scores sorted descending in bf16, class ids, and the score
    threshold's valid flags."""
    boxes = near_duplicates(rng, (images, k), size, per_centre=8)
    p = np.sort(rng.beta(1, 30, (images, k)).astype(np.float32), -1)[:, ::-1]
    scores = torch.from_numpy(np.ascontiguousarray(p)).to(torch.bfloat16)
    cls = torch.from_numpy(rng.integers(0, classes, (images, k)))
    return torch.from_numpy(boxes), scores, cls, scores.float() > 0.01


def chain(n: int) -> np.ndarray:
    """n boxes in a row, each at IoU 0.43 with its neighbours and 0.11 with
    the next but one: under 0.3 greedy keeps every other box, and the fixed
    point needs a pass per link."""
    x = np.arange(n, dtype=np.float32) * 4.0
    return np.stack([x, np.zeros(n), x + 10, np.full(n, 10.0)], -1).astype(np.float32)


def threshold_pair():
    """Two boxes whose float32 IoU is 1/3 rounded, and that IoU as a Python
    float: IoU > thr is false at thr = iou, true just below."""
    boxes = np.array([[0, 0, 2, 1], [1, 0, 3, 1]], np.float32)
    return boxes, float(np.float32(1) / np.float32(3))


def _f32(x) -> np.float32:
    return np.float32(float(x))


def fma_sensitive_pair(rng, tries: int = 200000):
    """Two boxes whose union, with w * h + area_b rounded once as a fused
    multiply-add rounds it, gives another float32 IoU than with each step
    rounded (as PyTorch rounds it), and a threshold at the lower of the two:
    fusing flips the decision. Returns (boxes (2, 4), thr, torch's IoU)."""
    for _ in range(tries):
        b = np.sort(rng.uniform(0, 3, (2, 2, 2)).astype(np.float32), -1)
        boxes = np.stack([b[:, 0, 0], b[:, 1, 0], b[:, 0, 1], b[:, 1, 1]], -1)
        (ax1, ay1, ax2, ay2), (bx1, by1, bx2, by2) = boxes
        wa, ha = ax2 - ax1, ay2 - ay1
        area_b = (bx2 - bx1) * (by2 - by1)
        inter = (max(min(ax2, bx2) - max(ax1, bx1), np.float32(0))
                 * max(min(ay2, by2) - max(ay1, by1), np.float32(0)))
        if inter <= 0:
            continue
        twice = (wa * ha + area_b) - inter
        fused = _f32(Fraction(float(wa)) * Fraction(float(ha)) + Fraction(float(area_b))) - inter
        iou_t, iou_f = inter / twice, inter / fused
        if iou_t != iou_f:
            got = float(pairwise_iou(torch.from_numpy(boxes), torch.from_numpy(boxes))[0, 1])
            assert got == float(iou_t)
            return boxes, float(min(iou_t, iou_f)), got
    raise RuntimeError("no FMA-sensitive pair found")


def cell_call(name: str, seed: int = 0) -> dict:
    """The NMS call of a cell at its shapes ("rpn_train" 125 x 2000,
    "rpn_detect" 40 x 1000, "box_detect" 8 x 1024 with 38 classes), drawn
    from `seed`."""
    rng = np.random.default_rng(seed)
    if name == "box_detect":
        images, k, classes, thr = BOX_DETECT
        b, s, c, v = box_problem(rng, images, k, classes)
        return nms_call(b, s, thr, v, c)
    images, k, counts, thr = {"rpn_train": RPN_TRAIN, "rpn_detect": RPN_DETECT}[name]
    b, s, v = rpn_problem(rng, images, k, counts)
    return nms_call(b, s, thr, v)


def nms_call(boxes, scores, thr, valid=None, classes=None) -> dict:
    return {"boxes": torch.as_tensor(boxes), "scores": torch.as_tensor(scores),
            "valid": None if valid is None else torch.as_tensor(valid), "thr": thr,
            "classes": None if classes is None else torch.as_tensor(classes)}


def _chain(rng):
    # a chain across the kernel's 64-box chunks, and one run backwards
    n = 70
    s = np.linspace(1.0, 0.1, n, dtype=np.float32)
    return [nms_call(chain(n)[None], s[None], 0.3),
            nms_call(chain(n)[None], s[None, ::-1].copy(), 0.3)]


def _ties(rng):
    # every score equal (index order decides), then 3 distinct bf16 values
    b = near_duplicates(rng, (2, 100), 64.0, per_centre=10)
    few = torch.from_numpy(rng.integers(0, 3, (2, 100)).astype(np.float32) / 4).to(torch.bfloat16)
    return [nms_call(b, torch.zeros((2, 100)), 0.5), nms_call(b, few, 0.5)]


def _padding(rng):
    # invalid boxes that duplicate valid ones at the top scores, and the
    # RPN's layout: ragged valid prefixes, one level with none
    b = near_duplicates(rng, (3, 90), 64.0, per_centre=10)
    s = bf16_scores(rng, (3, 90))
    valid = rng.random((3, 90)) < 0.6
    b[:, :10] = b[:, 10:20]
    s[:, :10] = 5.0
    valid[:, :10] = False
    rb, rs, rv = rpn_problem(rng, 2, 70, (70, 65, 30, 1, 0), size=96.0)
    return [nms_call(b, s, 0.5, valid), nms_call(rb, rs, 0.7, rv)]


def _classes(rng):
    b, s, c, v = box_problem(rng, 2, 120, 4, size=64.0)
    return [nms_call(b, s, 0.5, v, c)]


def _nan(rng):
    # NaN and +-inf coordinates (PyTorch gives such a box IoU 0 with every
    # box), boxes at x1 = x2 = inf, and a negative threshold, under which
    # IoU 0 suppresses too
    b = near_duplicates(rng, (2, 80), 64.0, per_centre=10)
    hit = rng.random((2, 80, 4))
    b[hit < 0.03] = np.nan
    b[(hit >= 0.03) & (hit < 0.06)] = np.inf
    b[(hit >= 0.06) & (hit < 0.09)] = -np.inf
    b[:, :3, [0, 2]] = np.inf
    s = bf16_scores(rng, (2, 80))
    return [nms_call(b, s, 0.5), nms_call(b, s, -0.5)]


def _threshold(rng):
    b, iou = threshold_pair()
    s = np.array([[1.0, 0.5]], np.float32)
    below = float(np.nextafter(np.float32(iou), np.float32(0)))
    return [nms_call(b[None], s, iou), nms_call(b[None], s, below)]


def _fma(rng):
    b, thr, _ = fma_sensitive_pair(rng)
    return [nms_call(b[None], np.array([[1.0, 0.5]], np.float32), thr)]


def _all_invalid(rng):
    b = near_duplicates(rng, (2, 70), 64.0)
    return [nms_call(b, bf16_scores(rng, (2, 70)), 0.5, np.zeros((2, 70), bool))]


def _sizes(rng):
    return [nms_call(near_duplicates(rng, (2, n), 64.0, per_centre=8),
                     bf16_scores(rng, (2, n)), 0.5) for n in (0, 1, 63, 64, 65)]


ADVERSARIAL = {"chain": _chain, "ties": _ties, "padding": _padding, "classes": _classes,
               "nan": _nan, "threshold": _threshold, "fma": _fma,
               "all_invalid": _all_invalid, "sizes": _sizes}


def adversarial(name: str, seed: int = 0) -> list:
    """The calls of one adversarial set: dicts of boxes (M, n, 4), scores
    (M, n), valid (M, n) or None, thr, classes (M, n) or None (then the call
    goes through batched_nms_mask), as CPU tensors."""
    return ADVERSARIAL[name](np.random.default_rng(seed))


def run(call: dict, device, fn=None) -> torch.Tensor:
    """One adversarial call on `device` through ops/nms.py's nms_mask (or
    `fn` in its place), through batched_nms_mask where it has classes."""
    from weakcube_tpu_torch.ops import nms
    to = {k: (v.to(device) if isinstance(v, torch.Tensor) else v) for k, v in call.items()}
    if to["classes"] is None:
        return (fn or nms.nms_mask)(to["boxes"], to["scores"], to["thr"], to["valid"])
    if fn is None:
        return nms.batched_nms_mask(to["boxes"], to["scores"], to["classes"], to["thr"],
                                    to["valid"])
    saved = nms.nms_mask
    nms.nms_mask = fn
    try:
        return nms.batched_nms_mask(to["boxes"], to["scores"], to["classes"], to["thr"],
                                    to["valid"])
    finally:
        nms.nms_mask = saved


def class_offset_boxes(call: dict) -> torch.Tensor:
    """The boxes batched_nms_mask hands to nms_mask: each class shifted
    apart by the problem's span."""
    b = call["boxes"]
    span = b.amax(dim=(-2, -1)) - b.amin(dim=(-2, -1)) + 1.0
    return b + (call["classes"].to(b.dtype) * (span[..., None] + 1.0))[..., None]
