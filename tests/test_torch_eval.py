"""The Omni3D evaluator of weakcube_tpu_torch against weakcube_tpu's, on the
same numpy records drawn from seeds: the greedy matcher (native and plain),
AP in 2D, AP in 3D over every depth band with and without proximity, the
multi-dataset helper, the evaluation records, the AP tables and the
drawings.

The JAX evaluator runs its numpy matcher (its native one is switched off):
the port's native matcher is held to that body exactly. 2D AP is the same
float64 numpy arithmetic in both, so it is compared exactly. IoU3D comes
from two implementations (JAX's vmapped clip, the port's batched one) that
agree to about 1e-6, so 3D AP is equal only while no matched pair's IoU
lies near a threshold: the test asserts a 1e-4 margin on JAX's own IoUs and
then equality to 1e-9; a second case gives both evaluators the same IoU
matrices and compares exactly.
"""
import numpy as np
import pytest

from weakcube_tpu.evaluation import _native as j_native
from weakcube_tpu.evaluation import omni3d_eval as j_eval
from weakcube_tpu.ops import cuboids as j_cub
from weakcube_tpu.vis import logperf as j_logperf
from weakcube_tpu.vis import vis as j_vis
from weakcube_tpu_torch.evaluation import _native as t_native
from weakcube_tpu_torch.evaluation import omni3d_eval as t_eval
from weakcube_tpu_torch.ops import cuboids as t_cub
from weakcube_tpu_torch.ops import cuda_build
from weakcube_tpu_torch.vis import logperf as t_logperf
from weakcube_tpu_torch.vis import vis as t_vis

NCLS = 3
THRS_3D = np.round(np.arange(0.05, 0.51, 0.05), 2)


@pytest.fixture(autouse=True)
def jax_numpy_matcher(monkeypatch):
    """The JAX evaluator matches with its numpy body."""
    monkeypatch.setattr(j_native, "native_match", lambda *a: None)


def rotation(rng):
    """Yaw about y with a small tilt about x."""
    a, b = rng.uniform(-np.pi, np.pi), rng.uniform(-0.2, 0.2)
    ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    return (rx @ ry).astype(np.float32)


def scene_records(seed, n_img=6, id0=0):
    """(dt_records, gt_records): per image 4-7 GTs (20% ignored) of NCLS
    classes with rotated cuboids at 2-40 m (every depth band), a detection
    near 80% of them (10% of another class), 2-4 false positives (some far
    from every GT), scores on a 0.05 grid (ties)."""
    rng = np.random.default_rng(seed)
    dts, gts = [], []
    for i in range(n_img):
        G = int(rng.integers(4, 8))
        z = rng.uniform(2, 40, G)
        ctr = np.stack([rng.uniform(-0.4, 0.4, G) * z, rng.uniform(-0.2, 0.2, G) * z, z], -1)
        dims = rng.uniform(0.5, 3.0, (G, 3))
        R = np.stack([rotation(rng) for _ in range(G)])
        cls = rng.integers(0, NCLS, G)
        boxes = np.concatenate([rng.uniform(0, 500, (G, 2)), np.zeros((G, 2))], -1)
        boxes[:, 2:] = boxes[:, :2] + rng.uniform(10, 120, (G, 2))
        gts.append({"image_id": id0 + i, "boxes": boxes.astype(np.float32),
                    "classes": cls.astype(np.int32), "ignore": rng.random(G) < 0.2,
                    "centers3D": ctr.astype(np.float32),
                    "corners3D": t_cub.get_cuboid_verts_3d_np(np.concatenate([ctr, dims], -1), R)})
        hit = rng.random(G) < 0.8
        n_fp = int(rng.integers(2, 5))
        d_ctr = np.concatenate([ctr[hit] + rng.normal(0, 0.15, (hit.sum(), 3)) * (1 + z[hit, None] / 10),
                                np.stack([rng.uniform(-8, 8, n_fp), rng.uniform(-2, 2, n_fp),
                                          rng.uniform(2, 45, n_fp)], -1)])
        d_dims = np.concatenate([dims[hit] * rng.uniform(0.8, 1.25, (hit.sum(), 3)),
                                 rng.uniform(0.5, 3.0, (n_fp, 3))])
        d_R = np.concatenate([R[hit], np.stack([rotation(rng) for _ in range(n_fp)])])
        d_cls = np.concatenate([np.where(rng.random(hit.sum()) < 0.1,
                                         rng.integers(0, NCLS, hit.sum()), cls[hit]),
                                rng.integers(0, NCLS, n_fp)])
        d_boxes = np.concatenate([boxes[hit] + rng.normal(0, 8, (hit.sum(), 4)),
                                  boxes[rng.integers(0, G, n_fp)] + rng.normal(0, 60, (n_fp, 4))])
        D = len(d_cls)
        dts.append({"image_id": id0 + i, "boxes": d_boxes.astype(np.float32),
                    "scores": (np.round(rng.uniform(0.05, 1.0, D) / 0.05) * 0.05).astype(np.float32),
                    "classes": d_cls.astype(np.int32), "centers3D": d_ctr.astype(np.float32),
                    "corners3D": t_cub.get_cuboid_verts_3d_np(
                        np.concatenate([d_ctr, d_dims], -1), d_R)})
    return dts, gts


def assert_same_results(a, b, atol=0.0):
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            assert_same_results(a[k], b[k], atol)
        elif atol == 0.0:
            assert (a[k] == b[k]) or (np.isnan(a[k]) and np.isnan(b[k])), (k, a[k], b[k])
        else:
            np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0, err_msg=k)


MATCH_CASES = {
    "random": (9, 7, 0.3, 0.2, False),
    "ties": (8, 5, 0.2, 0.2, True),
    "all GT ignored": (6, 4, 1.0, 0.0, False),
    "no GT": (5, 0, 0.0, 0.5, False),
    "no detections": (0, 4, 0.2, 0.0, False),
    "crowded": (40, 30, 0.1, 0.3, True),
}


@pytest.mark.parametrize("case", list(MATCH_CASES))
def test_matcher_matches_jax(case):
    """Native and plain matchers vs JAX's numpy matcher: identical (T, D)
    matches and ignore flags, at the 2D and 3D thresholds."""
    D, G, p_gt_ig, p_dt_ig, ties = MATCH_CASES[case]
    rng = np.random.default_rng(sorted(MATCH_CASES).index(case))
    for thrs in (np.round(np.arange(0.5, 0.96, 0.05), 2), THRS_3D):
        for _ in range(3):
            scores = rng.random(D)
            iou = rng.random((D, G)) * (rng.random((D, G)) < 0.6)
            if ties:
                scores = np.round(scores * 4) / 4
                iou = np.round(iou * 10) / 10   # IoUs on the thresholds themselves
            gt_ig, dt_ig = rng.random(G) < p_gt_ig, rng.random(D) < p_dt_ig
            want = j_eval._match_image(scores, iou, gt_ig, thrs, dt_ig)
            for fn in (t_eval._match_image, t_eval._match_image_plain):
                got = fn(scores, iou, gt_ig, thrs, dt_ig)
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])
                assert got[0].dtype == np.int64 and got[1].dtype == bool


def test_native_matcher_builds_into_build_and_a_failure_raises(tmp_path, monkeypatch):
    """The matcher is a g++ library in build/, named by a hash of its
    source; a source that does not compile raises with g++'s output, and
    the loader has no fallback."""
    path, _ = cuda_build.build_host_library(t_native.SOURCE)
    assert path.startswith(cuda_build.BUILD_DIR) and path.endswith(".so")
    assert t_native.get_lib() is not None
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" void greedy_match( {\n")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on .*broken.cpp"):
        cuda_build.build_host_library(str(bad))
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="error"):
        t_eval._match_image(np.ones(2), np.ones((2, 2)), np.zeros(2, bool), THRS_3D)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ap2d_matches_jax_exactly(seed):
    dts, gts = scene_records(seed)
    for proximity in (False, True):
        want = j_eval.evaluate_detections(dts, gts, NCLS, "2D", proximity)
        got = t_eval.evaluate_detections(dts, gts, NCLS, "2D", proximity, device="cpu")
        assert_same_results(got, want)
        assert 0 < got["AP"] < 100


def jax_iou_margin(dts, gts):
    """The distance of JAX's IoU3D of every same-class (detection, GT) pair
    from the nearest 3D threshold."""
    margin = np.inf
    for dt, gt in zip(dts, gts):
        iou = j_eval._iou3d_matrix(dt["corners3D"], gt["corners3D"])
        same = dt["classes"][:, None] == gt["classes"][None]
        margin = min(margin, np.abs(iou[same][:, None] - THRS_3D[None]).min(initial=np.inf))
    return margin


@pytest.mark.parametrize("seed", [3, 4])
def test_ap3d_matches_jax(seed):
    """Every band, proximity on and off, and the helper's summarize_all over
    two datasets (the second with proximity): AP equal to 1e-9 where no
    same-class pair's IoU3D lies within 1e-4 of a threshold."""
    dts, gts = scene_records(seed)
    assert jax_iou_margin(dts, gts) > 1e-4
    for proximity in (False, True):
        want = j_eval.evaluate_detections(dts, gts, NCLS, "3D", proximity)
        got = t_eval.evaluate_detections(dts, gts, NCLS, "3D", proximity, device="cpu")
        assert_same_results(got, want, atol=1e-9)
        assert 0 < got["AP"] < 100
        assert all(np.isfinite(got[k]) for k in ("AP_near", "AP_medium", "AP_far"))

    names = ["Omni_A", "SUNRGBD_B"]
    j_help = j_eval.Omni3DEvaluationHelper(names, NCLS)
    t_help = t_eval.Omni3DEvaluationHelper(names, NCLS, device="cpu")
    for k, name in enumerate(names):
        for d, g in zip(dts[3 * k:3 * k + 3], gts[3 * k:3 * k + 3]):
            assert j_help.add_predictions(name, d, g) == t_help.add_predictions(name, d, g) is True
        assert t_help.add_predictions(name, dts[3 * k], gts[3 * k]) is False  # a repeated image
    assert t_help.evaluators["SUNRGBD_B"].proximity and not t_help.evaluators["Omni_A"].proximity
    assert_same_results(t_help.summarize_all(), j_help.summarize_all(), atol=1e-9)


def test_ap3d_on_the_same_ious_is_exact(monkeypatch):
    """Both evaluators' matching and accumulation on the same IoU3D values
    (the port's, looked up per pair): every AP identical."""
    dts, gts = scene_records(5)
    table = {}
    compute = t_eval._iou3d_matrix

    def port_iou(d, g, device):
        iou = compute(d, g, device)
        for i, a in enumerate(d):
            for j, b in enumerate(g):
                table[(a.tobytes(), b.tobytes())] = iou[i, j]
        return iou
    monkeypatch.setattr(t_eval, "_iou3d_matrix", port_iou)
    monkeypatch.setattr(j_eval, "_iou3d_matrix", lambda d, g: np.array(
        [[table[(a.tobytes(), b.tobytes())] for b in g] for a in d], np.float32).reshape(
        len(d), len(g)))
    for proximity in (False, True):
        got = t_eval.evaluate_detections(dts, gts, NCLS, "3D", proximity, device="cpu")
        assert_same_results(got, j_eval.evaluate_detections(dts, gts, NCLS, "3D", proximity))


def test_perfect_predictions():
    """Detections identical to the GT at 2-8 m: both evaluators agree; AP2D
    is 100 and AP3D is what float32 IoU3D of identical boxes gives (below 100
    where coplanar faces read below IoU 1; ROADMAP.md, Queue C)."""
    dts, gts = scene_records(6, n_img=40)
    for d, g in zip(dts, gts):
        g["ignore"][:] = False
        g["centers3D"][:, 2] = 2 + (g["centers3D"][:, 2] - 2) * 6 / 38
        rng = np.random.default_rng(int(g["image_id"]))
        dims = rng.uniform(0.5, 3.0, (len(g["classes"]), 3))
        g["corners3D"] = t_cub.get_cuboid_verts_3d_np(
            np.concatenate([g["centers3D"], dims], -1),
            np.stack([rotation(rng) for _ in g["classes"]]))
        d.update(boxes=g["boxes"].copy(), classes=g["classes"].copy(),
                 centers3D=g["centers3D"].copy(), corners3D=g["corners3D"].copy(),
                 scores=np.linspace(1.0, 0.5, len(g["classes"]), dtype=np.float32))
    ev = {}
    for name, mod, kw in (("jax", j_eval, {}), ("port", t_eval, {"device": "cpu"})):
        e = mod.Omni3DEvaluator(NCLS, **kw)
        for d, g in zip(dts, gts):
            e.add(d, g)
        ev[name] = e.summarize()
    assert_same_results(ev["port"], ev["jax"], atol=1e-9)
    assert ev["port"]["AP2D"] == 100.0
    assert 90.0 <= ev["port"]["AP3D"] <= 100.0
    print(f"perfect predictions at 2-8 m: AP3D {ev['port']['AP3D']:.4f}, "
          f"AP3D@50 {ev['port']['AP3D@50']:.4f}")


def test_records_match_jax():
    """detections_to_records and gt_records_from_raw, port vs JAX on the same
    arrays and dataset records: identical."""
    from tools import eval_net as j_eval_net
    from weakcube_tpu.data import synthetic as j_synth
    from weakcube_tpu_torch.tools import eval_net as t_eval_net
    rng = np.random.default_rng(7)
    B, D = 3, 6
    fetched = {"boxes": rng.uniform(0, 100, (B, D, 4)).astype(np.float32),
               "scores": rng.random((B, D)).astype(np.float32),
               "classes": rng.integers(0, 5, (B, D)).astype(np.int32),
               "valid": rng.random((B, D)) < 0.7,
               "centers3D": rng.normal(0, 3, (B, D, 3)).astype(np.float32),
               "dims3D": rng.uniform(0.2, 2, (B, D, 3)).astype(np.float32),
               "poses3D": np.stack([[rotation(rng) for _ in range(D)] for _ in range(B)]),
               "scores3D": rng.random((B, D)).astype(np.float32)}
    batch = {"scale": np.array([0.2, 0.5, 1.0], np.float32), "image_id": np.array([4, 9, 2])}
    for got, want in zip(t_eval_net.detections_to_records(fetched, batch, D),
                         j_eval_net.detections_to_records(fetched, batch, D)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    records = j_synth.make_dataset(4, seed=1)
    records[1]["annotations"][0]["ignore"] = True
    records[2]["annotations"] = []
    for got, want in zip(t_eval_net.gt_records_from_raw(records),
                         j_eval_net.gt_records_from_raw(records)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def test_cuboid_verts_np_matches_jax():
    rng = np.random.default_rng(8)
    box3d = rng.normal(0, 2, (5, 4, 6)).astype(np.float32)
    R = np.stack([[rotation(rng) for _ in range(4)] for _ in range(5)])
    np.testing.assert_array_equal(t_cub.get_cuboid_verts_3d_np(box3d, R),
                                  j_cub.get_cuboid_verts_3d_np(box3d, R))
    np.testing.assert_array_equal(t_cub.get_cuboid_verts_3d_np(box3d),
                                  j_cub.get_cuboid_verts_3d_np(box3d))


def test_ap_tables_match_jax(capsys):
    """Every table of vis/logperf.py prints the same text."""
    dts, gts = scene_records(3)
    ev = t_eval.Omni3DEvaluator(NCLS, device="cpu")
    for d, g in zip(dts, gts):
        ev.add(d, g)
    res = ev.summarize()
    by_ds = {"Omni_A": res, "SUNRGBD_B": dict(res, AP3D=float("nan"))}
    names = ["chair", "table", "lamp"]
    printed = []
    for mod in (t_logperf, j_logperf):
        mod.print_ap_table(res, NCLS)
        mod.print_ap_table(res, NCLS, class_names=names)
        mod.print_ap_analysis_histogram(res)
        mod.print_ap_category_histogram("Omni_A", res, class_names=names)
        mod.print_ap_category_histogram("Omni_A", res, n_cols=2)
        mod.print_ap_dataset_histogram(by_ds, iters=100)
        mod.print_dataset_analysis_histogram(by_ds)
        mod.print_ap_omni_histogram(res)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert "| AP3D@25" in printed[0] and "Omni3D" in printed[0]


def test_drawings_match_jax():
    """draw_boxes_2d, draw_scene_view (front and top-down) and
    image_to_pixels: identical pixels."""
    from weakcube_tpu.config import get_cfg as j_get_cfg
    from weakcube_tpu_torch.config import get_cfg as t_get_cfg
    rng = np.random.default_rng(9)
    image = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    boxes = np.concatenate([rng.uniform(0, 60, (5, 2)), rng.uniform(60, 120, (5, 2))], -1)
    labels = [f"{x:.2f}" for x in rng.random(5)]
    np.testing.assert_array_equal(t_vis.draw_boxes_2d(image, boxes, labels),
                                  j_vis.draw_boxes_2d(image, boxes, labels))
    K = np.array([[90.0, 0, 64], [0, 90.0, 48], [0, 0, 1]], np.float32)
    n = 6
    centers = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n), rng.uniform(-0.5, 9, n)],
                       -1).astype(np.float32)   # some behind the camera
    dims = rng.uniform(0.3, 2.0, (n, 3)).astype(np.float32)
    poses = np.stack([rotation(rng) for _ in range(n)])
    for lab in (None, labels):
        got = t_vis.draw_scene_view(image, K, centers, dims, poses, lab)
        want = j_vis.draw_scene_view(image, K, centers, dims, poses, lab)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    empty = np.zeros((0, 3), np.float32)
    for a, b in zip(t_vis.draw_scene_view(image, K, empty, empty, np.zeros((0, 3, 3))),
                    j_vis.draw_scene_view(image, K, empty, empty, np.zeros((0, 3, 3)))):
        np.testing.assert_array_equal(a, b)
    for fmt in ("BGR", "RGB"):
        cfgs = []
        for get_cfg in (t_get_cfg, j_get_cfg):
            c = get_cfg()
            c.INPUT.FORMAT = fmt
            cfgs.append(c)
        for img in (image, rng.normal(size=(8, 8, 3)).astype(np.float32)):
            np.testing.assert_array_equal(t_vis.image_to_pixels(img, cfgs[0]),
                                          j_vis.image_to_pixels(img, cfgs[1]))
