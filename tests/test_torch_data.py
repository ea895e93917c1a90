"""The data pipeline of weakcube_tpu_torch against weakcube_tpu: the mapper,
pad_batch and build_train_batches on the same synthetic records and the same
seed give the same arrays, exactly; repeat factors, priors, the Omni3D JSON
layer and the category metadata on tiny inputs; the prefetch repair.

The reference config sets TPU.SPLIT_TRAIN_STEP "0" (its default backbone
split turns the ground-normal cache off) and TPU.TRANSFER_MASK_BITS False
(the port ships the ground mask as a bool map).
"""
import json
import os

import numpy as np
import pytest

from weakcube_tpu.config import get_cfg as j_get_cfg
from weakcube_tpu.data import build as j_build
from weakcube_tpu.data import datasets as j_ds
from weakcube_tpu.data import synthetic as j_synth
from weakcube_tpu.data.mapper import DatasetMapper3D as JMapper
from weakcube_tpu.models.priors import compute_priors as j_priors
from weakcube_tpu_torch.config import get_cfg as t_get_cfg
from weakcube_tpu_torch.data import build as t_build
from weakcube_tpu_torch.data import builtin as t_builtin
from weakcube_tpu_torch.data import datasets as t_ds
from weakcube_tpu_torch.data import synthetic as t_synth
from weakcube_tpu_torch.data.mapper import DatasetMapper3D as TMapper
from weakcube_tpu_torch.models.priors import compute_priors as t_priors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RECORDS = 6


def cfgs(**extra):
    """(JAX cfg, port cfg): configs/synthetic_smoke.yaml at 96 px with 3D
    boxes, multi-scale jitter, flips and the ground-normal cache."""
    out = []
    for get_cfg, ref in ((j_get_cfg, True), (t_get_cfg, False)):
        c = get_cfg()
        c.merge_from_file(os.path.join(REPO, "configs", "synthetic_smoke.yaml"))
        c.TPU.IMAGE_SIZE = 96
        c.INPUT.MIN_SIZE_TRAIN = (48, 64, 80, 96)
        c.DATALOADER.SAMPLER_TRAIN = "RepeatFactorTrainingSampler"
        if ref:
            c.TPU.SPLIT_TRAIN_STEP = "0"
            c.TPU.TRANSFER_MASK_BITS = False
        for k, v in extra.items():
            node = c
            *path, last = k.split(".")
            for p in path:
                node = getattr(node, p)
            setattr(node, last, v)
        c.freeze()
        out.append(c)
    return out


@pytest.fixture(scope="module")
def data():
    records = j_synth.make_dataset(N_RECORDS, seed=3)
    loaders = {"image": lambda r: j_synth.render_image(r["_scene"]),
               "depth": lambda r: j_synth.render_depth(r["_scene"]),
               "ground": lambda r: j_synth.ground_mask(r["_scene"])}
    return records, loaders


def assert_same(a, b, where):
    """Two examples or batches hold the same keys and the same arrays,
    exactly (dtypes included)."""
    if hasattr(a, "_fields"):
        a, b = a._asdict(), b._asdict()
    assert set(a) == set(b), (where, set(a) ^ set(b))
    for k in a:
        if hasattr(a[k], "_fields"):
            assert_same(a[k], b[k], f"{where}.{k}")
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (where, k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{where}.{k}")


def test_synthetic_records_match(data):
    records, _ = data
    for r, t in zip(records, t_synth.make_dataset(N_RECORDS, seed=3)):
        assert r["K"] == t["K"] and r["annotations"] == t["annotations"]
        np.testing.assert_array_equal(j_synth.render_depth(r["_scene"]),
                                      t_synth.render_depth(t["_scene"]))


@pytest.mark.parametrize("is_train", [True, False])
def test_mapper_matches_jax(data, is_train):
    """Every record through both mappers, each drawing from its own
    np.random.Generator of the same seed: flips, scale jitter, K scaling,
    the uint8 canvas, float16 depth, the bool ground mask and the cached
    ground normal, exactly."""
    records, loaders = data
    jc, tc = cfgs()
    jm, tm = JMapper(jc, is_train=is_train), TMapper(tc, is_train=is_train)
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    flips = 0
    for r in records:
        maps = {k: loaders[k](r) for k in ("image", "depth", "ground")}
        a = jm(r, jr, image=maps["image"], depth_map=maps["depth"], ground_map=maps["ground"])
        b = tm(r, tr, image=maps["image"], depth_map=maps["depth"], ground_map=maps["ground"])
        assert_same(a, b, f"record {r['image_id']}")
        assert b["ground_mask"].dtype == bool and b["depth_map"].dtype == np.float16
        flips += b["flip"]
    if is_train:
        assert 0 < flips < len(records)


def test_train_batches_match_jax(data):
    """The first three batches of build_train_batches (repeat-factor
    sampling, the mapper's draws, pad_batch), array for array."""
    records, loaders = data
    jc, tc = cfgs()
    jit = j_build.build_train_batches(jc, records, batch_size=2, seed=5, loaders=loaders)
    tit = t_build.build_train_batches(tc, records, batch_size=2, seed=5, loaders=loaders)
    for i in range(3):
        a, b = next(jit), next(tit)
        a = dict(a, gt=type(b["gt"])(*(np.asarray(x) for x in a["gt"])))
        assert_same({k: np.asarray(v) if k != "gt" else v for k, v in a.items()}, b,
                    f"batch {i}")


def test_test_batches_match_jax(data):
    records, loaders = data
    jc, tc = cfgs()
    ja = list(j_build.build_test_batches(jc, records, batch_size=4, loaders=loaders))
    tb = list(t_build.build_test_batches(tc, records, batch_size=4, loaders=loaders))
    assert len(ja) == len(tb) == 2
    for i, (a, b) in enumerate(zip(ja, tb)):
        a = dict(a, gt=type(b["gt"])(*(np.asarray(x) for x in a["gt"])))
        assert_same({k: np.asarray(v) if k != "gt" else v for k, v in a.items()}, b,
                    f"batch {i}")


def test_to_device_gives_the_model_batch(data):
    import torch
    records, loaders = data
    _, tc = cfgs()
    batch = next(t_build.build_train_batches(tc, records, batch_size=2, loaders=loaders))
    dev = t_build.to_device(batch, "cpu")
    assert dev["gt"].classes.dtype == torch.int64 and dev["ground_mask"].dtype == torch.bool
    assert dev["image"].dtype == torch.uint8 and dev["depth_map"].dtype == torch.float16
    np.testing.assert_array_equal(dev["gt"].boxes.numpy(), batch["gt"].boxes)
    np.testing.assert_array_equal(dev["ground_normal"].numpy(), batch["ground_normal"])


def test_repeat_factors_match_jax():
    rng = np.random.default_rng(2)
    recs = [{"annotations": [{"category_id": int(c), "ignore": bool(rng.random() < 0.1)}
                             for c in rng.integers(0, 6, rng.integers(0, 4))]}
            for _ in range(40)]
    for t in (0.05, 0.1, 0.5):
        np.testing.assert_array_equal(t_build.repeat_factors_from_category_frequency(recs, t),
                                      j_build.repeat_factors_from_category_frequency(recs, t))
    # the rare category is oversampled
    rare = [{"annotations": [{"category_id": 0}]}] * 3 + [{"annotations": [{"category_id": 1}]}]
    rf = t_build.repeat_factors_from_category_frequency(rare, 0.5)
    assert rf[3] > rf[0] == 1.0


@pytest.mark.parametrize("bins", [1, 3])
def test_compute_priors_match_jax(data, bins):
    records, _ = data
    jc, tc = cfgs(**{"MODEL.ROI_CUBE_HEAD.CLUSTER_BINS": bins})
    a, b = j_priors(jc, records, 7), t_priors(tc, records, 7)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def write_json(tmp_path):
    coco = {
        "images": [{"id": 1, "file_path": "img1.jpg", "width": 64, "height": 48,
                    "K": np.eye(3).tolist(), "dataset_id": 0},
                   {"id": 2, "file_path": "img2.jpg", "width": 64, "height": 48,
                    "K": np.eye(3).tolist(), "dataset_id": 0}],
        "categories": [{"id": 10, "name": "chair"}, {"id": 11, "name": "void"},
                       {"id": 12, "name": "table"}],
        "annotations": [],
    }
    base = {"bbox2D_tight": [5, 5, 30, 40], "bbox2D_proj": [5, 5, 30, 40],
            "bbox2D_trunc": [5, 5, 30, 40], "center_cam": [0, 0, 4], "dimensions": [1, 1, 1],
            "R_cam": np.eye(3).tolist(), "behind_camera": False, "valid3D": True,
            "visibility": 1.0, "truncation": 0.0, "lidar_pts": -1, "segmentation_pts": -1,
            "depth_error": 0.0}
    coco["annotations"] = [dict(base, image_id=1, category_id=10),
                           dict(base, image_id=1, category_id=10, behind_camera=True),
                           dict(base, image_id=2, category_id=12),
                           dict(base, image_id=2, category_id=11)]
    path = os.path.join(tmp_path, "mini.json")
    with open(path, "w") as f:
        json.dump(coco, f)
    return path


def test_omni3d_and_metadata_match_jax(tmp_path):
    path = write_json(str(tmp_path))
    fs = t_ds.get_filter_settings_from_cfg(None)
    fs["category_names"] = ["chair", "table"]
    a, b = j_ds.Omni3D([path], fs), t_ds.Omni3D([path], fs)
    assert len(b) == len(a) == 2 and b.categories == a.categories
    for ra, rb in zip(a.records, b.records):
        assert ra == rb
    assert not b.records[0]["annotations"][0]["ignore"]
    assert b.records[0]["annotations"][1]["ignore"]  # behind the camera
    out_j, out_t = os.path.join(tmp_path, "j"), os.path.join(tmp_path, "t")
    names = t_ds.register_and_store_model_metadata([], out_t, fs)
    assert names == j_ds.register_and_store_model_metadata([], out_j, fs) == ["chair", "table"]
    with open(os.path.join(out_j, "category_meta.json")) as f1, \
            open(os.path.join(out_t, "category_meta.json")) as f2:
        assert json.load(f1) == json.load(f2)
    for key in ("thing_classes", "thing_dataset_id_to_contiguous_id"):
        assert t_ds.METADATA_CATALOG["omni3d_model"][key] == \
            j_ds.METADATA_CATALOG["omni3d_model"][key]
    # the registration is per package: leave neither behind for other tests
    t_ds.METADATA_CATALOG.pop("omni3d_model")
    j_ds.METADATA_CATALOG.pop("omni3d_model")


def test_builtin_categories_match_jax():
    from weakcube_tpu.data import builtin as j_builtin
    for name in ("omni3d", "omni3d_in", "omni3d_out", "SUNRGBD", "KITTI"):
        assert t_builtin.get_omni3d_categories(name) == j_builtin.get_omni3d_categories(name)
    with pytest.raises(ValueError):
        t_builtin.get_omni3d_categories("nope")


def test_prefetch_reraises_the_worker_error():
    """A worker fault reaches the consumer (the JAX package's prefetch ends
    the iterator instead) after the items before it."""
    def items():
        yield 1
        yield 2
        raise KeyError("mapper fault")

    it = t_build.prefetch(items())
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(KeyError, match="mapper fault"):
        next(it)


def test_prefetch_passes_everything_and_stops():
    assert list(t_build.prefetch(iter(range(7)), depth=2)) == list(range(7))
    it = t_build.prefetch(iter(range(1000)), depth=2)
    assert next(it) == 0
    it.close()  # stops the worker; nothing left to consume
