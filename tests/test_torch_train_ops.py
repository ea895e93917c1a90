"""The training ops of weakcube_tpu_torch against their weakcube_tpu twins.

Inputs are made with numpy from a seed and handed to both packages; values
and gradients (jax.grad against autograd, of the sum of the output times a
random cotangent) are compared at float32 round-off (atol 1e-5 on O(1)
values unless a test says otherwise). Exact ties (touching boxes, corners
on the clamp bound, equal corner coordinates) are included: the port writes
jnp.clip / jnp.maximum / jnp.min as torch.minimum / maximum / amin, which
share JAX's subgradient there. The samplers draw from a torch.Generator,
not JAX's PRNG, so they are held to their invariants.

The weak losses outside the recipe (z, z_pseudo_gt_patch, depth,
segmentation), the focal loss, the soft hull and the supervised head's
chamfer are held in float64 (jax.enable_x64), value and gradients within
1e-9 of each tensor's scale (value_and_grads64), with their ties: hull
corners on integer pixel coordinates, collinear and coincident corners,
an even-count median whose middle pair differs, equal candidate areas in
the z search, a chamfer tie and L1 terms at exactly 0 (jnp.abs's gradient
there is 1, torch.abs's 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weakcube_tpu.config import get_cfg as j_get_cfg
from weakcube_tpu.models import fast_rcnn as j_fast_rcnn
from weakcube_tpu.models import roi_heads as j_roi_heads
from weakcube_tpu.models import rpn as j_rpn
from weakcube_tpu.ops import boxes as j_boxes
from weakcube_tpu.ops import cuboids as j_cuboids
from weakcube_tpu.ops import hull as j_hull
from weakcube_tpu.ops import losses as j_losses
from weakcube_tpu.ops import roi_align as j_ra
from weakcube_tpu.ops import rotations as j_rot
from weakcube_tpu.solver.build import build_lr_schedule as j_schedule
from weakcube_tpu.structures import SampledRois as JSampledRois
from weakcube_tpu.structures import match_boxes as j_match_boxes
from weakcube_tpu_torch.config import get_cfg as t_get_cfg
from weakcube_tpu_torch.models import fast_rcnn as t_fast_rcnn
from weakcube_tpu_torch.models import roi_heads as t_roi_heads
from weakcube_tpu_torch.models import rpn as t_rpn
from weakcube_tpu_torch.models.layers import BatchNorm2d, apply_batch_stats
from weakcube_tpu_torch.ops import boxes as t_boxes
from weakcube_tpu_torch.ops import cuboids as t_cuboids
from weakcube_tpu_torch.ops import hull as t_hull
from weakcube_tpu_torch.ops import losses as t_losses
from weakcube_tpu_torch.ops import roi_align as t_ra
from weakcube_tpu_torch.ops import roi_align_cuda
from weakcube_tpu_torch.ops import rotations as t_rot
from weakcube_tpu_torch.ops import sampling
from weakcube_tpu_torch.parallel.train_step import create_train_state, train_step
from weakcube_tpu_torch.solver import build_lr_schedule as t_schedule
from weakcube_tpu_torch.structures import GroundTruth, Proposals, SampledRois, match_boxes
from torch_roi_boxes import BOX_SETS, box_set

STRIDES = (4, 8, 16, 32, 64)


def t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, atol=1e-5, rtol=1e-5, msg=""):
    np.testing.assert_allclose(a.detach().numpy() if isinstance(a, torch.Tensor) else a,
                               np.asarray(b), atol=atol, rtol=rtol, err_msg=msg)


def value_and_grads(jfn, tfn, args, seed=0, atol=1e-5, rtol=1e-5):
    """Both functions of the same numpy args: their values, and the
    gradients of sum(out * cotangent) for every float argument."""
    jfn = jax.jit(jfn)
    jout = jfn(*[jnp.asarray(a) for a in args])
    cot = np.random.default_rng(seed).normal(size=np.shape(jout)).astype(np.float32)
    floats = [i for i, a in enumerate(args) if np.asarray(a).dtype.kind == "f"]

    def jsum(*fargs):
        full = [jnp.asarray(a) for a in args]
        for i, f in zip(floats, fargs):
            full[i] = f
        return jnp.sum(jfn(*full) * cot)
    jgrads = jax.jit(jax.grad(jsum, argnums=tuple(range(len(floats)))))(
        *[jnp.asarray(args[i]) for i in floats])
    targs = [t(a) for a in args]
    for i in floats:
        targs[i].requires_grad_(True)
    tout = tfn(*targs)
    close(tout, jout, atol=atol, rtol=rtol, msg="value")
    (tout * t(cot)).sum().backward()
    for i, g in zip(floats, jgrads):
        got = targs[i].grad if targs[i].grad is not None else torch.zeros_like(targs[i])
        close(got, g, atol=atol, rtol=rtol, msg=f"grad of argument {i}")


def value_and_grads64(jfn, tfn, args, seed=0, rtol=1e-9):
    """value_and_grads in float64 (jax.enable_x64): float arguments cast to
    float64, the value and the gradient of every float argument held to
    rtol of its scale (the largest |entry| of JAX's). Returns JAX's value."""
    args = [np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f" else np.asarray(a)
            for a in args]
    floats = [i for i, a in enumerate(args) if a.dtype.kind == "f"]

    def of_floats(*fargs):
        full = list(args)
        for i, f in zip(floats, fargs):
            full[i] = f
        return jfn(*full)
    with jax.enable_x64():
        fargs = [args[i] for i in floats]
        cot = np.random.default_rng(seed).normal(size=jax.eval_shape(of_floats, *fargs).shape)

        def value_and_vjp(*fa):  # one compile for the value and the gradients
            out, pull = jax.vjp(of_floats, *fa)
            return out, pull(jnp.asarray(cot))
        jout, jgrads = jax.jit(value_and_vjp)(*fargs)
        jout, jgrads = np.asarray(jout), [np.asarray(g) for g in jgrads]
    targs = [t(a) for a in args]
    for i in floats:
        targs[i].requires_grad_(True)
    tout = tfn(*targs)
    assert tout.dtype == torch.float64

    def within(got, want, what):
        scale = max(float(np.abs(want).max(initial=0.0)), 1e-300)
        err = float(np.abs(got.detach().numpy() - want).max(initial=0.0))
        assert err <= rtol * scale, f"{what}: max |err| {err:.3e}, scale {scale:.3e}"
    within(tout, jout, "value")
    (tout * t(cot)).sum().backward()
    for i, g in zip(floats, jgrads):
        got = targs[i].grad if targs[i].grad is not None else torch.zeros_like(targs[i])
        within(got, g, f"grad of argument {i}")
    return jout


def random_boxes(rng, shape, size=100.0):
    xy = rng.uniform(-10, size, shape + (2,))
    wh = rng.uniform(1, 40, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def tied_boxes(rng, n):
    """Pairs (a, b) of aligned boxes, a quarter of them touching along an
    edge (the intersection's max(., 0) at its tie), a quarter sharing an
    edge (the enclosing box's min / max at a tie)."""
    a, b = random_boxes(rng, (n,)), random_boxes(rng, (n,))
    q = n // 4
    b[:q, 0] = a[:q, 2]                 # b starts where a ends
    b[:q, 2] = b[:q, 0] + 10.0
    b[q:2 * q, 1] = a[q:2 * q, 1]       # the same top edge
    return a, b


# ---------------------------------------------------------------- boxes
@pytest.mark.parametrize("fn", ["elementwise_iou", "giou", "giou_loss"])
def test_matched_box_ious(fn):
    a, b = tied_boxes(np.random.default_rng(0), 64)
    value_and_grads(getattr(j_boxes, fn), getattr(t_boxes, fn), [a, b])


def test_pairwise_ioa():
    rng = np.random.default_rng(1)
    a, b = random_boxes(rng, (7,)), random_boxes(rng, (50,))
    b[3] = [5.0, 5.0, 5.0, 9.0]  # empty
    close(t_boxes.pairwise_ioa(t(a), t(b)), j_boxes.pairwise_ioa(a, b))


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_get_deltas(weights):
    rng = np.random.default_rng(2)
    src, dst = random_boxes(rng, (40,)), random_boxes(rng, (40,))
    src[0, 2] = src[0, 0]  # zero width: the 1e-6 floor
    value_and_grads(lambda s, d: j_boxes.get_deltas(s, d, weights),
                    lambda s, d: t_boxes.get_deltas(s, d, weights), [src, dst], atol=2e-4)


@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_smooth_l1(beta):
    rng = np.random.default_rng(3)
    x, y = rng.normal(size=(2, 100)).astype(np.float32)
    value_and_grads(lambda a, b: j_boxes.smooth_l1(a, b, beta),
                    lambda a, b: t_boxes.smooth_l1(a, b, beta), [x, y])


# ---------------------------------------------------------------- losses
def test_classification_losses():
    rng = np.random.default_rng(4)
    logits = (3 * rng.normal(size=(30, 6))).astype(np.float32)
    labels = rng.integers(0, 6, 30).astype(np.int32)
    targets = rng.uniform(0, 1, (30, 6)).astype(np.float32)
    value_and_grads(j_losses.bce_with_logits, t_losses.bce_with_logits, [logits, targets])
    value_and_grads(lambda x: j_losses.softmax_cross_entropy(x, jnp.asarray(labels)),
                    lambda x: t_losses.softmax_cross_entropy(x, t(labels)), [logits])


def test_masked_reductions():
    """Non-finite entries drop out; an empty mask gives 0."""
    x = np.array([1.0, np.nan, 3.0, np.inf, 5.0, 7.0], np.float32)
    for m in ([True, True, True, True, False, True], [False] * 6, [True, True, False] * 2):
        m = np.array(m)
        close(t_losses.masked_mean(t(x), t(m)), j_losses.masked_mean(x, m))
        close(t_losses.masked_sum(t(x), t(m)), j_losses.masked_sum(x, m))
    assert float(t_losses.masked_mean(t(x), torch.zeros(6, dtype=torch.bool))) == 0.0


# ------------------------------------------------------------- rotations
def random_rotations(rng, n):
    return np.array(j_rot.rotation_6d_to_matrix(jnp.asarray(rng.normal(size=(n, 6)), jnp.float32)))


def test_so3_angles():
    rng = np.random.default_rng(5)
    R1, R2 = np.asarray(random_rotations(rng, 20)), np.asarray(random_rotations(rng, 20))
    R2[:3] = R1[:3]  # angle 0: the cosine clips at 1 - eps
    # the angle's gradient takes arccos' slope (up to ~70 at the clip): 1e-4
    # relative
    for cos in (True, False):
        value_and_grads(lambda a, b: j_rot.so3_relative_angle(a, b, cos),
                        lambda a, b: t_rot.so3_relative_angle(a, b, cos), [R1, R2], atol=2e-5,
                        rtol=1e-4)
        value_and_grads(lambda a: j_rot.so3_rotation_angle(a, cos),
                        lambda a: t_rot.so3_rotation_angle(a, cos), [R1], atol=2e-5, rtol=1e-4)


def test_so3_relative_angle_pairs():
    rng = np.random.default_rng(6)
    R = np.asarray(random_rotations(rng, 9))
    R[4] = R[1]
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1], bool)
    jv, jm = j_rot.so3_relative_angle_pairs(R, mask)
    tv, tm = t_rot.so3_relative_angle_pairs(t(R), t(mask))
    close(tv, jv)
    assert tm.tolist() == np.asarray(jm).tolist()
    value_and_grads(lambda r: j_rot.so3_relative_angle_pairs(r, mask)[0],
                    lambda r: t_rot.so3_relative_angle_pairs(r, t(mask))[0], [R])


# --------------------------------------------------------------- cuboids
def random_cubes(rng, shape):
    ctr = np.concatenate([rng.uniform(-2, 2, shape + (2,)), rng.uniform(2, 8, shape + (1,))], -1)
    dims = rng.uniform(0.3, 2.0, shape + (3,))
    R = np.asarray(random_rotations(rng, int(np.prod(shape)))).reshape(shape + (3, 3))
    return np.concatenate([ctr, dims, R.reshape(shape + (9,))], -1).astype(np.float32)


def test_corners_and_projection():
    rng = np.random.default_rng(7)
    cubes = random_cubes(rng, (3, 5))
    K = np.tile(np.array([[100.0, 0, 64], [0, 110.0, 60], [0, 0, 1]], np.float32), (3, 1, 1))
    value_and_grads(lambda c: j_cuboids.Cubes(c).corners(),
                    lambda c: t_cuboids.Cubes(c).corners(), [cubes])
    pts = rng.normal(size=(3, 10, 3)).astype(np.float32)
    pts[0, 0, 2] = 1e-8   # within min_z of the camera plane
    pts[0, 1, 2] = -1e-8
    value_and_grads(j_cuboids.project_points, t_cuboids.project_points, [K, pts], atol=1e-3)


def test_bube_corners_and_boxes_at_ties():
    """Cubes far off the frame clamp several corners onto the same bound, so
    the enclosing box's min / max and the clamp meet exact ties."""
    rng = np.random.default_rng(8)
    cubes = random_cubes(rng, (2, 12))
    cubes[0, :4, 0] = 40.0        # far right: every corner clamps to 2W - 1
    cubes[1, :3, 1] = -30.0       # far up: clamps to -H/2 + 1
    K = np.tile(np.array([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]], np.float32), (2, 1, 1))
    wh = np.array([[128.0, 128.0], [120.0, 96.0]], np.float32)
    value_and_grads(lambda c: j_cuboids.Cubes(c).bube_corners(K[:, None], wh[:, None]),
                    lambda c: t_cuboids.Cubes(c).bube_corners(t(K)[:, None], t(wh)[:, None]),
                    [cubes], atol=1e-4)
    value_and_grads(lambda c: j_cuboids.Cubes(c).to_boxes(K[:, None], wh[:, None]),
                    lambda c: t_cuboids.Cubes(c).to_boxes(t(K)[:, None], t(wh)[:, None]),
                    [cubes], atol=1e-4)


# -------------------------------------------------------- matching, sampling
def test_match_boxes():
    """Matcher labels, indices and qualities exactly, with tied qualities
    (the first maximum wins in both) and an image without valid GT."""
    rng = np.random.default_rng(9)
    iou = rng.uniform(0, 1, (2, 6, 40)).astype(np.float32)
    iou[:, 2] = iou[:, 4]                   # ties between two GTs
    valid = np.array([[1, 1, 1, 0, 1, 1], [0] * 6], bool)
    ti, tv, tl = match_boxes(t(iou), t(valid), [0.3, 0.7], [0, -1, 1])
    for b in range(2):
        ji, jv, jl = j_match_boxes(iou[b], valid[b], [0.3, 0.7], [0, -1, 1])
        assert tl[b].tolist() == np.asarray(jl).tolist()
        close(tv[b], jv, atol=0)
        if valid[b].any():
            assert ti[b].tolist() == np.asarray(ji).tolist()


def test_gumbel_topk_and_rank_budget():
    gen = torch.Generator().manual_seed(0)
    valid = torch.rand((4, 300), generator=gen) < torch.tensor([[0.9], [0.5], [0.05], [0.0]])
    logw = torch.randn((4, 300), generator=gen)
    mask = sampling.gumbel_topk_mask(gen, logw, valid, 32)
    assert (mask & ~valid).sum() == 0
    assert mask.sum(-1).tolist() == valid.sum(-1).clamp(max=32).tolist()
    budget = torch.tensor([10, 0, 40, 5])
    scores = sampling.gumbel((4, 300), gen)
    cut = sampling.rank_budget_mask(scores, valid, budget, 64)
    assert (cut & ~valid).sum() == 0
    assert cut.sum(-1).tolist() == torch.minimum(budget, valid.sum(-1)).tolist()
    # the kept ones are the highest-scoring valid items
    for b in range(4):
        kept, rest = scores[b][cut[b]], scores[b][valid[b] & ~cut[b]]
        assert not len(kept) or not len(rest) or kept.min() > rest.max()


def sampling_case(seed=10, B=3, P=60, G=6):
    rng = np.random.default_rng(seed)
    gt_boxes = random_boxes(rng, (B, G), 128.0)
    props = np.concatenate([gt_boxes + rng.normal(0, 3, (B, G, 4)),
                            random_boxes(rng, (B, P - G), 128.0)], 1).astype(np.float32)
    classes = rng.integers(0, 5, (B, G)).astype(np.int32)
    classes[:, -1] = -1                      # an ignore region per image
    valid = np.ones((B, G), bool)
    valid[1, 2:] = False
    valid[2] = False                         # an image without GT
    pvalid = rng.uniform(size=(B, P)) < 0.9
    return gt_boxes, props, classes, valid, pvalid


@pytest.mark.parametrize("append_gt", [True, False])
def test_label_and_sample_proposals(append_gt):
    """fg capped at S * fraction and weighted toward high IoU, bg filling
    the rest of S, the chosen RoIs packed fg first (by IoU, as JAX's sort
    key orders them), then bg; classes and gt_idx from the matcher; no RoI
    under an ignore region or invalid is chosen as bg."""
    gt_boxes, props, classes, valid, pvalid = sampling_case()
    S, frac, ncls = 16, 0.25, 5
    gt = GroundTruth(t(gt_boxes), t(classes).long(), t(valid))
    rois = t_roi_heads.label_and_sample_proposals(
        torch.Generator().manual_seed(1), Proposals(t(props), torch.zeros(props.shape[:2]),
                                                    t(pvalid)), gt, ncls, S, frac, [0.5], 0.5,
        append_gt)
    boxes = np.concatenate([props, gt_boxes], 1) if append_gt else props
    bvalid = np.concatenate([pvalid, valid & (classes >= 0)], 1) if append_gt else pvalid
    for b in range(3):
        fg_gt = valid[b] & (classes[b] >= 0)
        iou = np.asarray(j_boxes.pairwise_iou(gt_boxes[b], boxes[b]))
        mi, mv, ml = (np.asarray(x) for x in j_match_boxes(iou, fg_gt, [0.5], [0, 1]))
        ioa = np.where((valid[b] & (classes[b] < 0))[:, None],
                       np.asarray(j_boxes.pairwise_ioa(gt_boxes[b], boxes[b])), 0).max(0)
        ml = np.where((ml == 0) & (ioa >= 0.5), -1, ml)
        ml = np.where(bvalid[b], ml, -1)
        fg, chosen = rois.fg[b].numpy(), rois.valid[b].numpy()
        n_fg, n_avail_fg, n_avail_bg = fg.sum(), (ml == 1).sum(), (ml == 0).sum()
        assert n_fg == min(int(S * frac), n_avail_fg)
        assert chosen.sum() == n_fg + min(S - n_fg, n_avail_bg)
        assert fg[:n_fg].all() and not fg[n_fg:].any() and chosen[:chosen.sum()].all()
        # every chosen RoI is a slot of the candidate set with its matcher label
        sel = [int(np.flatnonzero((boxes[b] == r).all(-1))[0]) for r in rois.boxes[b].numpy()]
        assert (ml[sel][:n_fg] == 1).all() and (ml[sel][n_fg:chosen.sum()] == 0).all()
        assert np.all(np.diff(mv[sel][:n_fg]) <= 1e-6)             # fg by IoU, highest first
        assert rois.gt_idx[b].tolist() == mi[sel].tolist()
        want_cls = np.where(fg, classes[b][mi[sel]], ncls)
        assert rois.classes[b].tolist() == want_cls.tolist()


def test_label_and_sample_anchors():
    """Anchor labels: at most BATCH * fraction positives plus the forced best
    anchor of each fg GT, negatives filling the batch, nothing negative
    under an ignore region, matched boxes and IoUs of the matcher."""
    gt_boxes, props, classes, valid, _ = sampling_case(seed=11)
    anchors = random_boxes(np.random.default_rng(12), (400,), 128.0)
    gt = GroundTruth(t(gt_boxes), t(classes).long(), t(valid))
    lab = t_rpn.label_and_sample_anchors(torch.Generator().manual_seed(2), t(anchors), gt,
                                         64, 0.5, [0.3, 0.7], [0, -1, 1], 0.5)
    for b in range(3):
        fg_gt = valid[b] & (classes[b] >= 0)
        iou = np.asarray(j_boxes.pairwise_iou(gt_boxes[b], anchors))
        mi, mv, ml = (np.asarray(x) for x in j_match_boxes(iou, fg_gt, [0.3, 0.7], [0, -1, 1]))
        labels = lab.labels[b].numpy()
        best = np.argmax(np.where(fg_gt[:, None], iou, -1), 1)
        forced = {int(a) for g, a in enumerate(best) if fg_gt[g] and ml[a] == 1}
        pos = set(np.flatnonzero(labels == 1).tolist())
        assert forced <= pos and pos <= set(np.flatnonzero(ml == 1).tolist())
        assert len(pos - forced) <= 32
        assert (ml[labels == 0] == 0).all()
        close(lab.matched_ious[b], mv, atol=0)
        close(lab.matched_boxes[b], gt_boxes[b][mi], atol=0)


def test_anchor_forcing_is_an_or():
    """An invalid GT whose argmax lands on anchor 0 does not clear anchor 0's
    forced positive (the JAX package's duplicate-index .set lets the last
    writer win there)."""
    anchors = np.array([[0, 0, 20, 20], [50, 50, 90, 90], [100, 100, 120, 130]], np.float32)
    gt = GroundTruth(t(np.array([[[0, 0, 20, 20], [60, 60, 70, 70]]], np.float32)),
                     torch.tensor([[1, 2]]), torch.tensor([[True, False]]))
    lab = t_rpn.label_and_sample_anchors(torch.Generator().manual_seed(0), t(anchors), gt,
                                         2, 0.5, [0.3, 0.7], [0, -1, 1], 0.5)
    assert lab.labels[0, 0] == 1


# ------------------------------------------------------------ RPN and box head
def test_rpn_losses():
    rng = np.random.default_rng(13)
    anchors = random_boxes(rng, (200,), 128.0)
    mboxes = random_boxes(rng, (2, 200), 128.0)
    labels = rng.choice([-1, 0, 1], (2, 200)).astype(np.int32)
    ious = rng.uniform(0, 1, (2, 200)).astype(np.float32)
    logits = rng.normal(size=(2, 200)).astype(np.float32)
    deltas = rng.normal(0, 0.3, (2, 200, 4)).astype(np.float32)
    jl = j_rpn.RPNLabels(jnp.asarray(labels), jnp.asarray(mboxes), jnp.asarray(ious))
    tl = t_rpn.RPNLabels(t(labels), t(mboxes), t(ious))
    for key in ("rpn/cls", "rpn/loc"):
        value_and_grads(lambda lo, d: j_rpn.rpn_losses(anchors, lo, d, jl, 64)[key],
                        lambda lo, d: t_rpn.rpn_losses(t(anchors), lo, d, tl, 64)[key],
                        [logits, deltas])


def test_fast_rcnn_losses():
    rng = np.random.default_rng(14)
    B, S, C = 2, 12, 5
    rb = random_boxes(rng, (B, S), 128.0)
    gtb = random_boxes(rng, (B, S), 128.0)
    cls = rng.integers(0, C + 1, (B, S)).astype(np.int32)
    fg = cls < C
    valid = rng.uniform(size=(B, S)) < 0.8
    scores = rng.normal(size=(B, S, C + 1)).astype(np.float32)
    deltas = rng.normal(0, 0.3, (B, S, 4 * C)).astype(np.float32)
    jr = JSampledRois(jnp.asarray(rb), jnp.asarray(cls), jnp.zeros((B, S), jnp.int32),
                      jnp.asarray(fg), jnp.asarray(valid))
    tr = SampledRois(t(rb), t(cls).long(), torch.zeros((B, S), dtype=torch.long), t(fg), t(valid))
    for key in ("BoxHead/loss_cls", "BoxHead/loss_box_reg"):
        value_and_grads(lambda s, d: j_fast_rcnn.fast_rcnn_losses(s, d, jr, gtb, C)[key],
                        lambda s, d: t_fast_rcnn.fast_rcnn_losses(s, d, tr, t(gtb), C)[key],
                        [scores, deltas])


# ------------------------------------------------------------- weak losses
def test_weak_losses():
    rng = np.random.default_rng(15)
    B, S = 2, 10
    pose = np.asarray(random_rotations(rng, B * S)).reshape(B, S, 3, 3)
    fg = rng.uniform(size=(B, S)) < 0.6
    fg[1] = False
    fg[1, 3] = True                               # one image with a single fg box
    normals = rng.normal(size=(B, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    value_and_grads(lambda p: j_roi_heads.pose_alignment_loss(p, fg)[0],
                    lambda p: t_roi_heads.pose_alignment_loss(p, t(fg))[0], [pose])
    value_and_grads(j_roi_heads.pose_ground_loss, t_roi_heads.pose_ground_loss, [pose, normals])
    value_and_grads(j_roi_heads.pose_ground2_loss, t_roi_heads.pose_ground2_loss,
                    [pose, normals], atol=2e-5)
    depth = rng.uniform(1, 10, (B, 64, 80)).astype(np.float32)
    xy = rng.uniform(-20, 100, (B, S, 2)).astype(np.float32)
    z = rng.uniform(1, 10, (B, S)).astype(np.float32)
    wh = np.array([[80.0, 64.0], [70.0, 60.0]], np.float32)
    close(t_roi_heads.sample_depth_at(t(depth), t(xy), t(wh)),
          j_roi_heads.sample_depth_at(depth, xy, wh), atol=0)
    value_and_grads(lambda zz: j_roi_heads.pseudo_gt_z_point_loss(depth, xy, zz, wh),
                    lambda zz: t_roi_heads.pseudo_gt_z_point_loss(t(depth), t(xy), zz, t(wh)),
                    [z])
    pri = np.tile(np.array([[[1.0, 1.0, 1.0], [0.5, 0.5, 0.5]]], np.float32), (5, 1, 1))
    cls = rng.integers(0, 6, (B, S))
    dims = rng.uniform(0.1, 3, (B, S, 3)).astype(np.float32)
    dims[0, 0] = [1.5, 0.5, 2.0]                 # the hinge exactly at its tie, twice
    value_and_grads(lambda d: j_roi_heads.dims_prior_loss(d, cls, pri),
                    lambda d: t_roi_heads.dims_prior_loss(d, t(cls), t(pri)), [dims])
    per_box = {"a": rng.uniform(size=(B, S)).astype(np.float32)}
    per_box["a"][0, 1] = np.nan
    unc = rng.normal(size=(B, S)).astype(np.float32)
    for conf in (0.0, 1.0):
        value_and_grads(
            lambda a, u: jnp.stack(list(j_roi_heads.uncert_weight_and_reduce(
                {"a": a}, {"s": a * 0 + 2.0}, u, fg, conf, {"a": 3.0, "s": 0.5}, 1.0).values())),
            lambda a, u: torch.stack(list(t_roi_heads.uncert_weight_and_reduce(
                {"a": a}, {"s": a * 0 + 2.0}, u, t(fg), conf, {"a": 3.0, "s": 0.5},
                1.0).values())),
            [per_box["a"], unc])


# --------------------------------------- float64: the weak losses outside the recipe
def test_focal_and_dice_f64():
    """sigmoid_focal_loss (logits exactly 0 among them, where bce's max(x, 0)
    and |x| tie) and dice_loss against JAX."""
    rng = np.random.default_rng(30)
    logits = 3 * rng.normal(size=(4, 50))
    logits[0, :5] = 0.0
    targets = (rng.uniform(size=(4, 50)) < 0.5).astype(np.float64)
    targets[1] = rng.uniform(size=50)
    for alpha, gamma in ((0.25, 2.0), (-1.0, 1.5)):
        value_and_grads64(lambda x, y: j_losses.sigmoid_focal_loss(x, y, alpha, gamma),
                          lambda x, y: t_losses.sigmoid_focal_loss(x, y, alpha, gamma),
                          [logits, targets])
    probs = rng.uniform(size=(4, 50))
    value_and_grads64(j_losses.dice_loss, t_losses.dice_loss, [probs, targets])


def hull_cases(rng):
    """(6, 8, 2) corner sets on a 16 x 12 grid: general position; on integer
    pixel coordinates (edges through pixel centres: the clip at exactly 0
    and 1); three collinear corners and a repeated one; all collinear (the
    hull is a segment); all coincident (no edge); partly off the grid."""
    pts = rng.uniform(1, 11, (6, 8, 2))
    pts[1] = rng.integers(0, 12, (8, 2))
    pts[2, :3] = [[2.0, 2.0], [5.0, 5.0], [8.0, 8.0]]
    pts[2, 5] = pts[2, 4]
    pts[3] = np.stack([np.linspace(1, 14, 8), np.linspace(2, 9, 8)], -1)
    pts[4] = [6.0, 5.0]
    pts[5] = rng.uniform(-6, 20, (8, 2))
    return pts


def test_hull_edges_and_soft_hull_f64():
    rng = np.random.default_rng(31)
    pts = hull_cases(rng)
    with jax.enable_x64():
        for p in pts:
            je, js = j_hull.hull_edges(jnp.asarray(p))
            te, ts = t_hull.hull_edges(t(p))
            assert te.tolist() == np.asarray(je).tolist()
            assert ts.tolist() == np.asarray(js).tolist()
    jfn = jax.vmap(lambda p: j_hull.soft_hull_mask(p, 12, 16))
    mask = value_and_grads64(jfn, lambda p: t_hull.soft_hull_mask(p, 12, 16), [pts])
    # integer corners: every pixel centre is inside, outside or on an edge
    assert np.isin(mask[1], (0.0, 1.0)).all() and mask[1].any()
    assert 0.0 < mask[0].mean() < 1.0 and np.all(mask[4] == 1.0) and np.all(mask[3] == 0.0)


def test_masked_median_depth_in_boxes_f64():
    """The median of the 32 x 32 lattice (1024 samples: the mean of the
    middle two, which differ here, where torch.median would take the lower),
    the centre-depth fallback of zero-area boxes (degenerate, or clipped
    away), and pseudo_gt_z_box_loss's gradient (in z alone)."""
    rng = np.random.default_rng(32)
    B, S, H, W = 2, 7, 48, 64
    depth = rng.uniform(1, 10, (B, H, W))
    boxes = random_boxes(rng, (B, S), 60.0).astype(np.float64)
    boxes[0, 0] = [10.0, 10.0, 10.0, 30.0]        # zero width
    boxes[1, 1] = [70.0, 5.0, 90.0, 20.0]         # clipped away: zero area
    wh = np.array([[64.0, 48.0], [60.0, 40.0]])
    with jax.enable_x64():
        want = np.asarray(j_roi_heads.masked_median_depth_in_boxes(depth, boxes, wh))
    got = t_roi_heads.masked_median_depth_in_boxes(t(depth), t(boxes), t(wh))
    close(got, want, atol=0, rtol=1e-15)
    xs, ys, _ = t_roi_heads.box_lattice(t(boxes), t(wh))
    lower = torch.median(t_roi_heads.lattice_depth(t(depth), xs, ys), -1).values
    assert (got != lower).sum() >= 7    # the middle pairs differ
    z = rng.uniform(1, 10, (B, S))
    z[0, 2] = want[0, 2]                          # |z - median| at exactly 0
    value_and_grads64(lambda zz, d, b: j_roi_heads.pseudo_gt_z_box_loss(d, b, zz, wh),
                      lambda zz, d, b: t_roi_heads.pseudo_gt_z_box_loss(d, b, zz, t(wh)),
                      [z, depth, boxes])


def search_case(rng):
    """Cubes, GT boxes, K and image sizes for the z search: general cubes;
    cubes far off the frame (every corner clamped: all candidate areas 0,
    hence 1e7, a tie the first candidate wins and a loss at exactly 0);
    cubes over the whole extended frame with a GT box larger still (every
    candidate's box clamped to the same area, the first wins); a centre far
    left of its GT box (the flat penalty)."""
    B, S = 2, 8
    cubes = random_cubes(rng, (B, S)).astype(np.float64)
    cubes[0, :2, 0] = 60.0
    cubes[0, :2, 2] = 9.0                         # every candidate in front of the camera
    cubes[1, :2, 2] = 0.5
    cubes[1, :2, 3:6] = 6.0
    K = np.tile(np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]]), (B, 1, 1))
    wh = np.array([[128.0, 96.0], [120.0, 96.0]])
    gt = random_boxes(rng, (B, S), 100.0).astype(np.float64)
    gt[1, :2] = [-100.0, -100.0, 400.0, 300.0]
    gt[0, 3] = [110.0, 10.0, 126.0, 30.0]
    cubes[0, 3, :3] = [-6.0, 0.0, 3.0]
    return cubes, gt, K, wh


def test_z_area_search_loss_f64():
    rng = np.random.default_rng(33)
    cubes, gt, K, wh = search_case(rng)
    out = value_and_grads64(
        lambda c, g: j_roi_heads.z_area_search_loss(g, j_cuboids.Cubes(c), K, wh),
        lambda c, g: t_roi_heads.z_area_search_loss(g, t_cuboids.Cubes(c), t(K), t(wh)),
        [cubes, gt])
    assert out[0, 0] == out[0, 1] == out[1, 0] == 0.0 and out[0, 3] == 2.5
    assert (out > 0).sum() >= 8


def depth_case(rng):
    B, S, G, H, W = 2, 6, 4, 48, 64
    depth = rng.uniform(1, 10, (B, H, W))
    cubes = random_cubes(rng, (B, S)).astype(np.float64)
    gt_idx = rng.integers(0, G, (B, S))
    gt = random_boxes(rng, (B, S), 60.0).astype(np.float64)
    wh = np.array([[64.0, 48.0], [60.0, 40.0]])
    masks = rng.uniform(size=(B, G, 12, 16)) < 0.4
    masks[0, 1] = False                            # an empty mask
    masks[1, 2] = False
    masks[1, 2, 0, 0] = True                       # a mask that misses the lattice
    gt_idx[:, 0] = [1, 2]
    gt[1, 0] = [30.0, 20.0, 50.0, 35.0]
    return depth, cubes, gt_idx, gt, wh, masks


@pytest.mark.parametrize("with_masks", [False, True])
def test_depth_range_loss_f64(with_masks):
    rng = np.random.default_rng(34)
    depth, cubes, gt_idx, gt, wh, masks = depth_case(rng)
    m = masks if with_masks else None
    value_and_grads64(
        lambda c, d, g: j_roi_heads.depth_range_loss(d, m, gt_idx, g, j_cuboids.Cubes(c), wh),
        lambda c, d, g: t_roi_heads.depth_range_loss(d, None if m is None else t(m),
                                                     t(gt_idx), g, t_cuboids.Cubes(c), t(wh)),
        [cubes, depth, gt])


def test_segment_loss_f64(monkeypatch):
    """The soft hull of each RoI's bube corners against its GT mask; some
    corners land on integer mask-grid coordinates. Against JAX with every
    RoI in one hull pass, then in passes of 3 RoIs (the chunks' activation
    checkpointing) against the one pass: the same values and gradients."""
    rng = np.random.default_rng(36)
    B, S, G = 2, 5, 3
    wh = np.array([[64.0, 48.0], [64.0, 48.0]])
    bube = rng.uniform(-10, 70, (B, S, 8, 2))
    bube[0, 1] = 4.0 * rng.integers(0, 14, (8, 2))  # 1/4 scale: integer mask coordinates
    masks = rng.uniform(size=(B, G, 12, 16)) < 0.3
    gt_idx = rng.integers(0, G, (B, S))
    value_and_grads64(lambda c: j_roi_heads.segment_loss(masks, gt_idx, c, wh),
                      lambda c: t_roi_heads.segment_loss(t(masks), t(gt_idx), c, t(wh)),
                      [bube])
    runs = []
    for elements in (None, 3 * 64 * 12 * 16):
        if elements:
            monkeypatch.setattr(t_roi_heads, "SEGMENT_CHUNK_ELEMENTS", elements)
        c = t(bube).requires_grad_(True)
        out = t_roi_heads.segment_loss(t(masks), t(gt_idx), c, t(wh))
        out.sum().backward()
        runs.append((out.detach(), c.grad))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def j_chamfer(c, gt):
    """The JAX supervised head's chamfer (a closure inside ROIHeads3D.__call__,
    weakcube_tpu/models/roi_heads.py), restated."""
    d = jnp.abs(c[..., :, None, :] - gt[..., None, :, :]).sum(-1)
    return d.min(-2).mean(-1) + d.min(-1).mean(-1)


def test_chamfer_and_l1_corner_losses_f64():
    """Ties: a prediction equal to its GT (every |.| at 0), a corner midway
    between two GT corners (a tie in the nearest corner), two equidistant
    candidates for a GT corner."""
    rng = np.random.default_rng(37)
    signs = np.asarray(t_cuboids._CORNER_SIGNS, np.float64)
    gt = np.stack([signs * rng.integers(1, 4, 3) + rng.integers(-5, 5, 3) for _ in range(4)])
    pred = gt + rng.normal(0, 0.4, gt.shape)
    pred[0] = gt[0]
    pred[1] = gt[1]
    pred[1, 0] = (gt[1, 0] + gt[1, 1]) / 2
    value_and_grads64(j_chamfer, t_roi_heads.chamfer_corner_loss, [pred, gt])
    value_and_grads64(lambda c, g: jnp.abs(c - g).mean(axis=(-1, -2)),
                      t_roi_heads.l1_corner_loss, [pred, gt])


# ----------------------------------------------------- K1's plain backward
@pytest.mark.parametrize("boxes_name", BOX_SETS)
def test_plain_backward_matches_jax(boxes_name):
    """The plain feature gradient against jax.vjp of the JAX gather
    (multilevel_roi_align) and against matmul_bwd, the JAX training plan;
    float32 sums in another order (atol 2e-5 on values up to ~10)."""
    rng = np.random.default_rng(16)
    C = 8
    feats = [rng.normal(size=(2, 128 // s, 128 // s, C)).astype(np.float32) for s in STRIDES]
    boxes = box_set(boxes_name, rng, 2, 24, 128)
    g = rng.normal(size=(2, 24, 7, 7, C)).astype(np.float32)
    want = jax.jit(lambda fs, bx, gg: jax.vjp(
        lambda *f: j_ra.multilevel_roi_align(list(f), bx, STRIDES, 7, 2), *fs)[1](gg))(
            feats, boxes, g)
    want_mm = jax.jit(lambda bx, gg: j_ra.matmul_bwd(
        tuple(f.shape for f in feats), (jnp.float32,) * 5, bx, gg, STRIDES, 7, 2, 2))(boxes, g)
    got = t_ra.multilevel_roi_align_backward(t(g), t(boxes), [f.shape for f in feats],
                                             [torch.float32] * 5, STRIDES, 7, 2)
    for lvl in range(5):
        close(got[lvl], want[lvl], atol=2e-5, msg=f"vjp level {lvl}")
        close(got[lvl], want_mm[lvl], atol=2e-5, msg=f"matmul_bwd level {lvl}")


def test_wrapper_gradient_on_cpu():
    """The pooler the heads call is differentiable in the levels on the CPU
    (the plain scatter as its backward), not in the boxes, and equals
    autograd of the plain forward; R = 0 gives zero gradients."""
    rng = np.random.default_rng(17)
    feats = [t(rng.normal(size=(2, 64 // s, 64 // s, 8)).astype(np.float32)).requires_grad_()
             for s in STRIDES]
    for R in (10, 0):
        boxes = t(box_set("edge", rng, 2, 10, 64)[:, :R].copy())
        out = roi_align_cuda.multilevel_roi_align(feats, boxes, STRIDES, 7, 2)
        g = torch.randn(out.shape)
        got = torch.autograd.grad((out * g).sum(), feats)
        want = torch.autograd.grad((t_ra.multilevel_roi_align(feats, boxes, STRIDES, 7, 2)
                                    * g).sum(), feats, allow_unused=True)
        for a, b in zip(got, want):
            assert a.shape == b.shape if b is not None else True
            close(a, b if b is not None else torch.zeros_like(a), atol=1e-5)
            assert a.is_contiguous()


# --------------------------------------------------------------- BatchNorm
def test_batchnorm_training_matches_flax():
    """Output and input gradient of train-mode BatchNorm against flax (the
    batch statistics, E[x^2] - E[x]^2 in float32), and the running
    statistics flax records (momentum 0.9, biased variance), written only
    by apply_batch_stats."""
    import flax.linen as fnn
    rng = np.random.default_rng(18)
    x = (rng.normal(size=(2, 6, 5, 8)) * 2 + 3).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
                    "bias": rng.uniform(-0.3, 0.3, 8).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(size=8).astype(np.float32),
                         "var": rng.uniform(0.5, 2, 8).astype(np.float32)}}
    (jy, jstats), = [bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])]
    cot = rng.normal(size=x.shape).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(bn.apply(v, a, mutable=["batch_stats"])[0] * cot))(
        jnp.asarray(x))
    m = BatchNorm2d(8)
    with torch.no_grad():
        m.weight.copy_(t(v["params"]["scale"]))
        m.bias.copy_(t(v["params"]["bias"]))
        m.running_mean.copy_(t(v["batch_stats"]["mean"]))
        m.running_var.copy_(t(v["batch_stats"]["var"]))
    xt = t(x).permute(0, 3, 1, 2).requires_grad_()
    y = m.train()(xt)
    close(y.permute(0, 2, 3, 1), jy, atol=2e-5)
    (y * t(cot).permute(0, 3, 1, 2)).sum().backward()
    close(xt.grad.permute(0, 2, 3, 1), jg, atol=2e-5)
    close(m.running_mean, v["batch_stats"]["mean"], atol=0)   # not yet written
    apply_batch_stats(torch.nn.Sequential(m))
    close(m.running_mean, jstats["batch_stats"]["mean"], atol=1e-6)
    close(m.running_var, jstats["batch_stats"]["var"], atol=1e-6)
    assert m.pending is None


# ------------------------------------------------- schedule and stabilisation
def test_lr_schedule_matches_jax():
    a, b = t_get_cfg(), j_get_cfg()
    for c in (a, b):
        c.SOLVER.WARMUP_ITERS, c.SOLVER.STEPS, c.SOLVER.BASE_LR = 10, (15, 18), 0.02
    ts, js = t_schedule(a), j_schedule(b)
    for count in (0, 1, 5, 9, 10, 14, 15, 17, 18, 30):
        assert np.float32(ts(count)) == np.float32(js(count)), count


def test_sgd_copy_keeps_schedule_and_count():
    """A deep copy of the port's SGD (of a model copied with it) goes on
    from the same point of the schedule, with the same clipping, and steps
    its copied parameters alone."""
    import copy
    from weakcube_tpu_torch.solver import build_optimizer
    cfg = t_get_cfg()
    cfg.SOLVER.WARMUP_ITERS, cfg.SOLVER.BASE_LR = 10, 0.02
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    model = torch.nn.Linear(3, 2)
    opt = build_optimizer(cfg, model)
    for _ in range(3):
        model.weight.grad = torch.ones_like(model.weight)
        opt.step()
    m2, o2 = copy.deepcopy((model, opt))
    assert (o2.count, o2.clip) == (3, opt.clip) and o2.schedule(o2.count) == opt.schedule(3)
    before = model.weight.detach().clone()
    m2.weight.grad = torch.ones_like(m2.weight)
    o2.step()
    assert o2.count == 4 and opt.count == 3
    assert torch.equal(model.weight, before) and not torch.equal(m2.weight, before)


class ToyModel(torch.nn.Module):
    """The RCNN3D training interface in miniature: a BatchNorm and a weight."""

    def __init__(self):
        super().__init__()
        self.bn = BatchNorm2d(2)
        self.w = torch.nn.Parameter(torch.ones(4))

    def forward(self, batch, generator=None):
        pred = (self.bn(batch["x"]).mean() + batch["x"].mean()) * self.w.sum()
        loss = (pred - batch["y"]) ** 2
        return {"loss": loss}, {"metric": loss.detach()}


def toy_batch(x=1.0, y=2.0):
    x = torch.arange(16.0).reshape(2, 2, 2, 2) * 0.1 + x
    return {"x": x, "y": torch.tensor(y)}


def toy():
    cfg = t_get_cfg()
    cfg.SOLVER.BASE_LR, cfg.SOLVER.WARMUP_FACTOR = 0.01, 1.0
    m = ToyModel()
    state, opt = create_train_state(cfg, m)
    return m, state, opt


def snapshot(m):
    return {k: v.clone() for k, v in m.state_dict().items()}


def test_normal_update_applies():
    m, s, opt = toy()
    s1, logs = train_step(m, opt, s, toy_batch())
    assert (s1.applied, s1.skipped, s1.step) == (1, 0, 1) and opt.count == 1
    assert not torch.equal(m.w.detach(), torch.ones(4))
    assert s1.loss_ema == logs["total_loss"] and logs["grad_finite"] == 1.0
    assert not torch.equal(m.bn.running_mean, torch.zeros(2))


def test_nan_batch_skips_and_keeps_params_and_stats():
    m, s, opt = toy()
    s1, _ = train_step(m, opt, s, toy_batch())
    before, count = snapshot(m), opt.count
    s2, logs = train_step(m, opt, s1, toy_batch(x=float("nan")))
    assert s2.skipped == 1 and logs["diverging"] == 1.0
    assert all(torch.equal(v, before[k]) for k, v in m.state_dict().items())
    assert opt.count == count                       # the schedule did not advance
    assert np.isfinite(s2.loss_ema)                 # the clipped loss, not NaN


def test_explosion_skips():
    m, s, opt = toy()
    for _ in range(3):
        s, _ = train_step(m, opt, s, toy_batch())
    before = snapshot(m)
    s2, logs = train_step(m, opt, s, toy_batch(y=1e6))
    assert logs["diverging"] == 1.0 and s2.skipped == s.skipped + 1
    assert all(torch.equal(v, before[k]) for k, v in m.state_dict().items())
    assert s2.loss_ema == pytest.approx(s.loss_ema * 0.98 + 0.02 * 1.0)


def test_recovers_after_skip():
    m, s, opt = toy()
    s1, _ = train_step(m, opt, s, toy_batch())
    s2, _ = train_step(m, opt, s1, toy_batch(x=float("nan")))
    s3, logs = train_step(m, opt, s2, toy_batch())
    assert logs["diverging"] == 0.0 and s3.applied == 2 and s3.step == 3
    assert torch.isfinite(m.w).all()


def test_non_finite_gradient_skips():
    m, s, opt = toy()
    s1, _ = train_step(m, opt, s, toy_batch())
    before = snapshot(m)
    hook = m.w.register_hook(lambda g: g * float("inf"))
    s2, logs = train_step(m, opt, s1, toy_batch())
    hook.remove()
    assert logs["grad_finite"] == 0.0 and logs["diverging"] == 0.0 and s2.skipped == 1
    assert all(torch.equal(v, before[k]) for k, v in m.state_dict().items())
