"""The whole inference slice of weakcube_tpu_torch against weakcube_tpu.

The flagship meta-arch (RCNN3D_combined_features + ROIHeads3DScore, DLA-34 +
FPN) at __graft_entry__._tiny_cfg(image_size=128, dla=True), float32. Both
packages get the same numpy weights (drawn into flax's variable shapes and
converted by flax_to_torch) and the same numpy batch. Each stage is also
checked alone on the same injected inputs: proposals, fast_rcnn_inference,
the heads and decode_cube_predictions.

Detections are compared on valid slots, matched as sets: the two
frameworks' top-k order near-equal scores differently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from weakcube_tpu.models import cube_head as j_cube_head
from weakcube_tpu.models import fast_rcnn as j_fast_rcnn
from weakcube_tpu.models import roi_heads as j_roi_heads
from weakcube_tpu.models import rpn as j_rpn
from weakcube_tpu.models.rcnn3d import build_model as j_build_model
from weakcube_tpu.structures import Proposals as JProposals
from weakcube_tpu_torch.entry import dims_priors, tiny_cfg
from weakcube_tpu_torch.models import cube_head as t_cube_head
from weakcube_tpu_torch.models import fast_rcnn as t_fast_rcnn
from weakcube_tpu_torch.models import roi_heads as t_roi_heads
from weakcube_tpu_torch.models import rpn as t_rpn
from weakcube_tpu_torch.models.rcnn3d import build_model as t_build_model
from weakcube_tpu_torch.structures import Proposals as TProposals
from weakcube_tpu_torch.utils import convert
from weakcube_tpu_torch.utils.convert import flax_to_torch

B, SIZE, NCLS = 2, 128, 5


def random_variables(shapes, seed):
    """numpy draws into flax's variable shapes: fan-in normal kernels,
    biases in +-0.3, BatchNorm statistics away from the identity."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape).astype(np.float32)
        low, high = {"scale": (0.5, 1.5), "var": (0.5, 2.0)}.get(name, (-0.3, 0.3))
        return rng.uniform(low, high, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, atol, rtol=1e-5, msg=""):
    np.testing.assert_allclose(a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a),
                               np.asarray(b), atol=atol, rtol=rtol, err_msg=msg)


def match_valid(a, b, atol):
    """Per image: the valid detections of a and b as sets, matched greedily
    by class, score and box (clipped degenerate boxes may repeat). Returns
    per-image (a's valid slots, the matching slots of b)."""
    pairs = []
    for i in range(a.valid.shape[0]):
        va, vb = np.flatnonzero(np.asarray(a.valid[i])), np.flatnonzero(np.asarray(b.valid[i]))
        assert len(va) == len(vb), f"image {i}: {len(va)} vs {len(vb)} valid detections"
        key_a = np.concatenate([np.asarray(a.boxes[i]), 1e3 * np.asarray(a.scores[i])[:, None],
                                1e6 * np.asarray(a.classes[i])[:, None]], -1)
        key_b = np.concatenate([np.asarray(b.boxes[i]), 1e3 * np.asarray(b.scores[i])[:, None],
                                1e6 * np.asarray(b.classes[i])[:, None]], -1)
        d = np.abs(key_a[va][:, None] - key_b[vb][None]).max(-1)
        j = []
        for row in d:
            row = row.copy()
            row[j] = np.inf
            j.append(int(row.argmin()))
            assert row[j[-1]] <= atol, f"image {i}: no detection within {atol}"
        pairs.append((va, vb[j]))
    return pairs


def model_pair(size, dla, dtype="float32"):
    """Both packages' models of tiny_cfg(size, NCLS, dla) on the same random
    weights, and their detections on the same uint8 batch. dtype "float64"
    computes in float64 and holds the variables in float64 (under
    jax.enable_x64)."""
    cfg = tiny_cfg(size, NCLS, dla=dla)
    priors = dims_priors(NCLS)
    jm = j_build_model(graft._tiny_cfg(size, NCLS, dla=dla), priors, dtype=getattr(jnp, dtype))
    rng = np.random.default_rng(0)
    K = np.tile(np.array([[100.0, 0, size / 2], [0, 110.0, size / 2], [0, 0, 1]],
                         np.float32), (B, 1, 1))
    batch = {"image": rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8),
             "image_wh": np.tile([[size, size]], (B, 1)).astype(np.float32), "K": K}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jb, train=False))
    v = random_variables(shapes, seed=1)
    if dtype != "float32":
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), v)
    jdet = jax.jit(lambda v, b: jm.apply(v, b, train=False))(v, jb)
    tm = t_build_model(cfg, priors, device="cpu", dtype=getattr(torch, dtype))
    if dtype != "float32":
        tm.to(getattr(torch, dtype))
    with pytest.MonkeyPatch.context() as mp:  # flax_to_torch rounds to float32
        mp.setattr(convert, "_t", lambda a: torch.from_numpy(np.array(a)))
        sd = convert.flax_to_torch(v["params"], v["batch_stats"])
    tm.load_state_dict(sd)
    tb = {k: t(x) for k, x in batch.items()}
    with torch.inference_mode():
        tdet = tm(tb)
    return dict(cfg=cfg, jm=jm, v=v, sd=sd, tm=tm, jdet=jdet, tdet=tdet, batch=batch, tb=tb)


@pytest.fixture(scope="module")
def slice_pair():
    pair = model_pair(SIZE, dla=True)
    jm, tm, tb = pair["jm"], pair["tm"], pair["tb"]
    pair["jfeats"] = jax.jit(lambda v, x: jm.apply(v, x, method=jm.backbone_forward))(
        pair["v"], jnp.asarray(pair["batch"]["image"]))
    with torch.inference_mode():
        pair["tfeats"] = tm.backbone(tm._prep_image(tb["image"]))
    return pair


def test_state_dict_is_the_zoo_inverse(slice_pair):
    """flax_to_torch covers the whole model (the strict load above), and
    weakcube_tpu/utils/zoo_convert.py maps its output back to the flax
    variables exactly."""
    from weakcube_tpu.utils.zoo_convert import convert_zoo_checkpoint
    p, s = convert_zoo_checkpoint({k: x.numpy() for k, x in slice_pair["sd"].items()},
                                  slice_pair["cfg"])
    for mine, theirs in ((p, slice_pair["v"]["params"]), (s, slice_pair["v"]["batch_stats"])):
        a = jax.tree_util.tree_leaves_with_path(mine)
        b = dict(jax.tree_util.tree_leaves_with_path(theirs))
        assert len(a) == len(b)
        for path, leaf in a:
            np.testing.assert_array_equal(leaf, b[path])


@pytest.mark.parametrize("level", ["p2", "p3", "p4", "p5", "p6"])
def test_backbone_features(slice_pair, level):
    """uint8 normalisation + DLA-34 + FPN: conv sums in another order,
    1e-4 relative to the level's scale."""
    w = np.asarray(slice_pair["jfeats"][level])
    close(slice_pair["tfeats"][level], w, atol=1e-4 * np.abs(w).max(), rtol=1e-4)


def check_detections(jd, td):
    jv, tv = np.asarray(jd.valid), td.valid.numpy()
    assert tv.sum() > 0
    pairs = match_valid(td, jd, atol=2e-3)
    for i, (ti, ji) in enumerate(pairs):
        close(td.scores[i][ti], np.asarray(jd.scores)[i][ji], atol=1e-5)
        assert td.classes[i][ti].tolist() == np.asarray(jd.classes)[i][ji].tolist()
        close(td.scores3D[i][ti], np.asarray(jd.scores3D)[i][ji], atol=1e-4)
        close(td.centers3D[i][ti], np.asarray(jd.centers3D)[i][ji], atol=2e-3)
        close(td.dims3D[i][ti], np.asarray(jd.dims3D)[i][ji], atol=1e-4)
        close(td.poses3D[i][ti], np.asarray(jd.poses3D)[i][ji], atol=1e-4)
    # invalid slots carry zero scores in both
    assert not td.scores3D.numpy()[~tv].any() and not np.asarray(jd.scores3D)[~jv].any()


def test_end_to_end_detections(slice_pair):
    """det.boxes, scores3D and centers3D on the valid detections. Pixel boxes
    within 2e-3 px, 3D centres within 2e-3 m and scores within 1e-4: the
    backbone's float32 differences (~1e-5 relative) carried through the heads."""
    check_detections(slice_pair["jdet"], slice_pair["tdet"])


def test_resnet18_end_to_end_detections():
    """tiny_cfg(64)'s default backbone, ResNet-18 + FPN: the whole model's
    detections against JAX's, matched and bounded as the DLA case's. In
    float64 on both sides (variables too: flax rounds its eval-mode
    BatchNorm multiplier to a float32 variable's precision): in float32 the
    features agree to 2e-6 of scale, but this model's heads carry that to
    3e-5 in the scores of near-equal boxes, past the DLA case's bounds."""
    with jax.enable_x64():
        pair = model_pair(64, dla=False, dtype="float64")
    assert pair["cfg"].MODEL.BACKBONE.NAME == "build_resnet_from_vision_fpn_backbone"
    check_detections(pair["jdet"], pair["tdet"])


def test_prep_image(slice_pair):
    """uint8 pixels are normalised by the BGR mean/std; float input passes."""
    tm = slice_pair["tm"]
    img = slice_pair["batch"]["image"]
    want = (img.astype(np.float32) - np.asarray(slice_pair["cfg"].MODEL.PIXEL_MEAN,
                                                np.float32)) \
        / np.asarray(slice_pair["cfg"].MODEL.PIXEL_STD, np.float32)
    close(tm._prep_image(t(img)), want, atol=1e-6)
    f = t(want)
    assert tm._prep_image(f) is f


# ----------------------------------------------------------- stage by stage
def test_rpn_head(slice_pair):
    rng = np.random.default_rng(2)
    feats = [rng.normal(size=(B, s, s, 256)).astype(np.float32) for s in (16, 8, 4)]
    jl, jd = j_rpn.RPNHead(num_anchors=3).apply(
        {"params": slice_pair["v"]["params"]["rpn_head"]}, [jnp.asarray(f) for f in feats])
    tl, td = slice_pair["tm"].proposal_generator.rpn_head([t(f) for f in feats])
    for a, b in zip(tl + td, jl + jd):
        close(a, b, atol=1e-4)


def test_select_proposals():
    """Same logits, deltas and anchors: the same proposals in the same order
    (exact top-k, stable ties)."""
    rng = np.random.default_rng(3)
    from weakcube_tpu.models import anchors as j_anchors
    shapes = [(32, 32), (16, 16), (8, 8), (4, 4), (2, 2)]
    anchors = [np.asarray(a) for a in j_anchors.pyramid_anchors(
        shapes, [4, 8, 16, 32, 64], [[32], [64], [128], [256], [512]], [[0.5, 1.0, 2.0]])]
    logits = [rng.normal(size=(B, len(a))).astype(np.float32) for a in anchors]
    deltas = [rng.normal(0, 0.5, (B, len(a), 4)).astype(np.float32) for a in anchors]
    wh = np.array([[128.0, 128.0], [120.0, 100.0]], np.float32)
    jp = j_rpn.select_proposals([jnp.asarray(a) for a in anchors],
                                [jnp.asarray(x) for x in logits],
                                [jnp.asarray(x) for x in deltas], jnp.asarray(wh), 128, 64, 0.7)
    tp = t_rpn.select_proposals([t(a) for a in anchors], [t(x) for x in logits],
                                [t(x) for x in deltas], t(wh), 128, 64, 0.7)
    assert tp.valid.tolist() == np.asarray(jp.valid).tolist()
    close(tp.boxes, jp.boxes, atol=1e-4)
    close(tp.scores, jp.scores, atol=1e-6)


def test_box_head_and_predictor(slice_pair):
    rng = np.random.default_rng(4)
    pooled = rng.normal(size=(B, 6, 7, 7, 256)).astype(np.float32)
    rh = slice_pair["v"]["params"]["roi_heads"]
    jx = j_fast_rcnn.FastRCNNConvFCHead(2, 1024).apply({"params": rh["box_head"]},
                                                       jnp.asarray(pooled))
    js, jdl = j_fast_rcnn.FastRCNNPredictor(NCLS).apply({"params": rh["box_predictor"]}, jx)
    heads = slice_pair["tm"].roi_heads
    tx = heads.box_head(t(pooled))
    ts, tdl = heads.box_predictor(tx)
    close(tx, jx, atol=1e-4)
    close(ts, js, atol=1e-4)
    close(tdl, jdl, atol=1e-4)


def test_fast_rcnn_inference():
    """Same class logits, per-class boxes and proposals: same detections."""
    rng = np.random.default_rng(5)
    P = 64
    scores = rng.normal(0, 2, (B, P, NCLS + 1)).astype(np.float32)
    pboxes = np.concatenate([rng.uniform(0, 90, (B, P, 2))] * 2, -1) \
        + np.concatenate([np.zeros((B, P, 2)), rng.uniform(5, 40, (B, P, 2))], -1)
    pboxes = pboxes.astype(np.float32)
    deltas = rng.normal(0, 0.5, (B, P, NCLS * 4)).astype(np.float32)
    pvalid = np.arange(P)[None] < np.array([[P], [40]])
    wh = np.full((B, 2), 128.0, np.float32)
    jbpc = j_fast_rcnn.predict_boxes(jnp.asarray(deltas), jnp.asarray(pboxes), NCLS)
    tbpc = t_fast_rcnn.predict_boxes(t(deltas), t(pboxes), NCLS)
    close(tbpc, jbpc, atol=1e-4)
    jprops = JProposals(jnp.asarray(pboxes), jnp.zeros((B, P)), jnp.asarray(pvalid))
    tprops = TProposals(t(pboxes), torch.zeros(B, P), t(pvalid))
    jd, jsel = j_fast_rcnn.fast_rcnn_inference(jnp.asarray(scores), jbpc, jprops,
                                               jnp.asarray(wh), 0.05, 0.5, 8, 1024)
    td, tsel = t_fast_rcnn.fast_rcnn_inference(t(scores), tbpc, tprops, t(wh),
                                               0.05, 0.5, 8, 1024)
    assert td.valid.tolist() == np.asarray(jd.valid).tolist()
    assert td.classes.tolist() == np.asarray(jd.classes).tolist()
    assert tsel.tolist() == np.asarray(jsel).tolist()
    close(td.boxes, jd.boxes, atol=1e-4)
    close(td.scores, jd.scores, atol=1e-6)
    close(td.scores_full, jd.scores_full, atol=1e-6)


@pytest.mark.parametrize("pose_type,shared_fc,bins", [
    ("6d", True, 1), ("quaternion", False, 1), ("euler", True, 3)])
def test_cube_head(pose_type, shared_fc, bins):
    rng = np.random.default_rng(6)
    pooled = rng.normal(size=(B, 4, 7, 7, 16)).astype(np.float32)
    jm = j_cube_head.CubeHead(num_classes=NCLS, fc_dim=64, shared_fc=shared_fc,
                              pose_type=pose_type, cluster_bins=bins)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(pooled)))
    v = random_variables(shapes, seed=7)
    jout = jm.apply(v, jnp.asarray(pooled))
    tm = t_cube_head.CubeHead(7 * 7 * 16, NCLS, 2, 64, shared_fc, pose_type, bins)
    sd = flax_to_torch({"roi_heads": {"cube_head": v["params"]}}, {})
    tm.load_state_dict({k[len("roi_heads.cube_head."):]: x for k, x in sd.items()})
    with torch.no_grad():
        tout = tm(t(pooled))
    for name, a, b in zip(("deltas_2d", "z", "dims", "pose", "uncert"), tout, jout):
        assert a.shape == b.shape, name
        close(a, b, atol=1e-4, msg=name)


def _cube_cfg(variant):
    cfg = tiny_cfg(SIZE, NCLS, dla=True).MODEL.ROI_CUBE_HEAD.clone()
    cfg.defrost()
    if variant == "sigmoid":
        cfg.DIMS_PRIORS_FUNC, cfg.Z_TYPE, cfg.ALLOCENTRIC_POSE = "sigmoid", "sigmoid", False
    elif variant == "log":
        cfg.Z_TYPE, cfg.VIRTUAL_DEPTH, cfg.DIMS_PRIORS_ENABLED = "log", False, False
    elif variant == "clusters":
        cfg.Z_TYPE, cfg.CLUSTER_BINS = "clusters", 3
    return cfg


@pytest.mark.parametrize("variant", ["default", "sigmoid", "log", "clusters"])
def test_decode_cube_predictions(variant):
    """Same head outputs, classes, boxes and K: the same decoded cubes."""
    rng = np.random.default_rng(8)
    S, bins = 6, 3
    cfg = _cube_cfg(variant)
    z_shape = (B, S, bins, NCLS) if variant == "clusters" else (B, S, NCLS)
    inputs = dict(
        deltas_2d=rng.normal(0, 0.2, (B, S, NCLS, 2)), z_raw=rng.normal(0, 1, z_shape),
        dims_raw=rng.normal(0, 0.5, (B, S, NCLS, 3)),
        pose_raw=np.asarray(jax.vmap(j_cube_head.rotations.rotation_6d_to_matrix)(
            jnp.asarray(rng.normal(size=(B, S, NCLS, 6)).astype(np.float32)))),
        uncert=rng.uniform(0.01, 2, (B, S, NCLS)))
    inputs = {k: x.astype(np.float32) for k, x in inputs.items()}
    classes = rng.integers(-1, NCLS, (B, S))
    boxes = np.concatenate([rng.uniform(0, 80, (B, S, 2))] * 2, -1).astype(np.float32)
    boxes[..., 2:] += rng.uniform(5, 40, (B, S, 2)).astype(np.float32)
    K = np.tile(np.array([[100.0, 0, 64], [0, 110.0, 60], [0, 0, 1]], np.float32), (B, 1, 1))
    priors = rng.uniform(0.3, 2, (NCLS, 2, 3)).astype(np.float32)
    z_scales = rng.uniform(10, 80, (NCLS, bins)).astype(np.float32)
    z_stats = rng.uniform(1, 5, (NCLS, bins, 2)).astype(np.float32)
    jdec = j_roi_heads.decode_cube_predictions(
        *(jnp.asarray(inputs[k]) for k in ("deltas_2d", "z_raw", "dims_raw", "pose_raw",
                                           "uncert")),
        jnp.asarray(classes), jnp.asarray(boxes), jnp.asarray(K), cfg, priors, z_scales, z_stats)
    tdec = t_roi_heads.decode_cube_predictions(
        *(t(inputs[k]) for k in ("deltas_2d", "z_raw", "dims_raw", "pose_raw", "uncert")),
        t(classes), t(boxes), t(K), cfg, t(priors), t(z_scales), t(z_stats))
    for name in t_roi_heads.CubeDecode._fields:
        a, b = getattr(tdec, name), getattr(jdec, name)
        if name == "cubes":
            a, b = a.tensor, b.tensor
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        close(a, b, atol=1e-4, rtol=1e-5, msg=name)


# ------------------------------------------- bf16 head outputs, stage by stage
def bf16_pair(x):
    """The same bfloat16 values for both packages: x rounded to bf16 once."""
    r = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return jnp.asarray(r, jnp.bfloat16), torch.from_numpy(r).bfloat16()


def as_f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def test_select_proposals_bf16():
    """bf16 logits and deltas (COMPUTE_DTYPE=bfloat16) with deliberate ties:
    scores stay bf16 and the float32 anchors promote the decode, in both
    packages. The same proposals in the same slots: valid and scores
    exactly, boxes within 1e-3 px."""
    rng = np.random.default_rng(13)
    from weakcube_tpu.models import anchors as j_anchors
    shapes = [(32, 32), (16, 16), (8, 8), (4, 4), (2, 2)]
    anchors = [np.asarray(a) for a in j_anchors.pyramid_anchors(
        shapes, [4, 8, 16, 32, 64], [[32], [64], [128], [256], [512]], [[0.5, 1.0, 2.0]])]
    # logits on a coarse grid: many equal scores within and across levels
    logits = [bf16_pair(rng.integers(-24, 24, (B, len(a))) / 8.0) for a in anchors]
    deltas = [bf16_pair(rng.normal(0, 0.5, (B, len(a), 4))) for a in anchors]
    wh = np.array([[128.0, 128.0], [120.0, 100.0]], np.float32)
    jp = j_rpn.select_proposals([jnp.asarray(a) for a in anchors], [x[0] for x in logits],
                                [x[0] for x in deltas], jnp.asarray(wh), 128, 64, 0.7,
                                approx_topk=False)
    tp = t_rpn.select_proposals([t(a) for a in anchors], [x[1] for x in logits],
                                [x[1] for x in deltas], t(wh), 128, 64, 0.7)
    assert jp.scores.dtype == jnp.bfloat16 and tp.scores.dtype == torch.bfloat16
    assert jp.boxes.dtype == jnp.float32 and tp.boxes.dtype == torch.float32
    assert tp.valid.tolist() == np.asarray(jp.valid).tolist()
    np.testing.assert_array_equal(as_f32(tp.scores), as_f32(jp.scores))
    close(tp.boxes, jp.boxes, atol=1e-3)


def test_fast_rcnn_inference_bf16():
    """bf16 class logits (with ties) and box deltas: the softmax, top-k and
    detection scores stay bf16 in both packages. Selected RoIs, classes and
    valid slots exactly, scores exactly, boxes within 1e-3 px."""
    rng = np.random.default_rng(15)
    P = 64
    js, ts = bf16_pair(rng.integers(-16, 16, (B, P, NCLS + 1)) / 4.0)
    jdl, tdl = bf16_pair(rng.normal(0, 0.5, (B, P, NCLS * 4)))
    pboxes = np.concatenate([rng.uniform(0, 90, (B, P, 2))] * 2, -1) \
        + np.concatenate([np.zeros((B, P, 2)), rng.uniform(5, 40, (B, P, 2))], -1)
    pboxes = pboxes.astype(np.float32)
    pvalid = np.arange(P)[None] < np.array([[P], [40]])
    wh = np.full((B, 2), 128.0, np.float32)
    jbpc = j_fast_rcnn.predict_boxes(jdl, jnp.asarray(pboxes), NCLS)
    tbpc = t_fast_rcnn.predict_boxes(tdl, t(pboxes), NCLS)
    assert jbpc.dtype == jnp.float32 and tbpc.dtype == torch.float32
    close(tbpc, jbpc, atol=1e-3)
    jprops = JProposals(jnp.asarray(pboxes), jnp.zeros((B, P)), jnp.asarray(pvalid))
    tprops = TProposals(t(pboxes), torch.zeros(B, P), t(pvalid))
    jd, jsel = j_fast_rcnn.fast_rcnn_inference(js, jbpc, jprops, jnp.asarray(wh),
                                               0.05, 0.5, 16, 1024)
    td, tsel = t_fast_rcnn.fast_rcnn_inference(ts, tbpc, tprops, t(wh), 0.05, 0.5, 16, 1024)
    assert int(td.valid.sum()) > 8
    assert jd.scores.dtype == jnp.bfloat16 and td.scores.dtype == torch.bfloat16
    assert td.scores_full.dtype == torch.bfloat16
    assert td.valid.tolist() == np.asarray(jd.valid).tolist()
    assert td.classes.tolist() == np.asarray(jd.classes).tolist()
    assert tsel.tolist() == np.asarray(jsel).tolist()
    np.testing.assert_array_equal(as_f32(td.scores), as_f32(jd.scores))
    np.testing.assert_array_equal(as_f32(td.scores_full), as_f32(jd.scores_full))
    close(td.boxes, jd.boxes, atol=1e-3)


@pytest.mark.parametrize("variant", ["default", "sigmoid", "log", "clusters"])
def test_decode_cube_predictions_bf16(variant):
    """bf16 cube-head outputs: each decoded field has the JAX package's
    dtype (bf16 until a float32 box, prior or K promotes it) and its values
    within bf16 rounding: rtol 2e-2, atol 2e-2 (poses, unit-scale fields)
    and 2e-2 relative for metres and pixels."""
    rng = np.random.default_rng(18)
    S, bins = 6, 3
    cfg = _cube_cfg(variant)
    z_shape = (B, S, bins, NCLS) if variant == "clusters" else (B, S, NCLS)
    pose = np.asarray(jax.vmap(j_cube_head.rotations.rotation_6d_to_matrix)(
        jnp.asarray(rng.normal(size=(B, S, NCLS, 6)).astype(np.float32))))
    raw = dict(deltas_2d=rng.normal(0, 0.2, (B, S, NCLS, 2)), z_raw=rng.normal(0, 1, z_shape),
               dims_raw=rng.normal(0, 0.5, (B, S, NCLS, 3)), pose_raw=pose,
               uncert=rng.uniform(0.01, 2, (B, S, NCLS)))
    pairs = {k: bf16_pair(x) for k, x in raw.items()}
    names = ("deltas_2d", "z_raw", "dims_raw", "pose_raw", "uncert")
    classes = rng.integers(-1, NCLS, (B, S))
    boxes = np.concatenate([rng.uniform(0, 80, (B, S, 2))] * 2, -1).astype(np.float32)
    boxes[..., 2:] += rng.uniform(5, 40, (B, S, 2)).astype(np.float32)
    K = np.tile(np.array([[100.0, 0, 64], [0, 110.0, 60], [0, 0, 1]], np.float32), (B, 1, 1))
    priors = rng.uniform(0.3, 2, (NCLS, 2, 3)).astype(np.float32)
    z_scales = rng.uniform(10, 80, (NCLS, bins)).astype(np.float32)
    z_stats = rng.uniform(1, 5, (NCLS, bins, 2)).astype(np.float32)
    jdec = j_roi_heads.decode_cube_predictions(
        *(pairs[k][0] for k in names), jnp.asarray(classes), jnp.asarray(boxes),
        jnp.asarray(K), cfg, priors, z_scales, z_stats)
    tdec = t_roi_heads.decode_cube_predictions(
        *(pairs[k][1] for k in names), t(classes), t(boxes), t(K), cfg, t(priors),
        t(z_scales), t(z_stats))
    for name in t_roi_heads.CubeDecode._fields:
        a, b = getattr(tdec, name), getattr(jdec, name)
        if name == "cubes":
            a, b = a.tensor, b.tensor
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        assert str(a.dtype).split(".")[-1] == str(b.dtype), (name, a.dtype, b.dtype)
        close(as_f32(a), as_f32(b), atol=2e-2, rtol=2e-2, msg=name)


# ------------------------------------------------------ entry points, dtype
def test_entry_on_cpu_and_no_silent_cpu_fallback():
    """entry() runs on the CPU when asked; with no device given it wants
    the card and raises where there is none."""
    from weakcube_tpu_torch.entry import entry
    fn, (model, batch) = entry(device="cpu")
    boxes, scores3d, centers3d = fn(model, batch)
    assert boxes.shape == (1, 8, 4) and scores3d.shape == (1, 8) and centers3d.shape == (1, 8, 3)
    assert all(bool(torch.isfinite(x).all()) for x in (boxes, scores3d, centers3d))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_build_model(tiny_cfg(SIZE, NCLS, dla=True))


def test_bf16_compute_path():
    """COMPUTE_DTYPE=bfloat16 (the flagship's): parameters stay float32, the
    pyramid is bf16, and the detections are finite and of the f32 model's
    shapes, with the JAX package's dtypes: the scores stay bf16, boxes,
    centres, dims and poses are promoted to float32 by the float32 proposals,
    priors and K (the values are not compared: bf16 keeps 8 mantissa bits,
    so near-equal scores reorder)."""
    from weakcube_tpu_torch.entry import make_batch
    cfg = tiny_cfg(SIZE, NCLS, dla=True)
    m32 = t_build_model(cfg, dims_priors(NCLS), device="cpu", seed=2)
    m16 = t_build_model(cfg, dims_priors(NCLS), device="cpu", seed=2, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    batch = make_batch(B, SIZE, SIZE, seed=4, device="cpu")
    with torch.inference_mode():
        feats = m16.backbone(m16._prep_image(batch["image"]))
        d16, d32 = m16(batch), m32(batch)
    assert all(f.dtype == torch.bfloat16 for f in feats.values())
    for name in ("boxes", "scores", "scores3D", "centers3D", "dims3D", "poses3D"):
        a, b = getattr(d16, name), getattr(d32, name)
        want = torch.bfloat16 if name in ("scores", "scores3D") else torch.float32
        assert a.shape == b.shape and a.dtype == want, name
        assert bool(torch.isfinite(a).all()), name
    assert int(d16.valid.sum()) > 0
