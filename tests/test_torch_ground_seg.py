"""The ground pseudo-GT CLIs of weakcube_tpu_torch against weakcube_tpu:
generate_ground_segmentations (depth-ransac and foundation), filter_ground
and the priors CLI, on the same synthetic records.

depth-ransac runs with JAX's own draws injected into the port
(jax.random.randint(fold_in(PRNGKey(0), i), (1000, 3), 0, n)): the ground
maps and the CSV are equal. The foundation method runs one synthetic image
through both packages with the same numpy weights (GroundingDINO with 1
enhancer, 2 decoders and 16 queries at 112 px; SAM-HQ vit_tiny, float32),
SAM's input side set to 256 in both packages (each package's IMG_SIZE
monkeypatched; 1024 on the card, chip_smoke.py phase 29): the same box,
and the same mask except where SAM's logit lies within 1e-3 of its scale
of 0. That case lives in tests/test_torch_pseudo_gt.py, beside the JAX
GroundingDINO it shares (one draw of its weights, one compile).
"""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weakcube_tpu.data import filter_ground as j_filter
from weakcube_tpu.data import generate_ground_segmentations as j_gen
from weakcube_tpu.data import synthetic as j_synthetic
from weakcube_tpu_torch.data import filter_ground as t_filter
from weakcube_tpu_torch.data import generate_ground_segmentations as t_gen
from weakcube_tpu_torch.data import synthetic as t_synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_draws(i, n):
    key = jax.random.fold_in(jax.random.PRNGKey(0), i)
    return np.asarray(jax.random.randint(key, (1000, 3), 0, n, jnp.int32))


def read_maps(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with np.load(os.path.join(d, f)) as z:
            out[f] = z["ground"]
    return out


def read_csv(path):
    with open(path) as f:
        return [row for row in csv.reader(f) if row]


def test_prompt_and_thresholds_match_jax():
    assert t_gen.GROUND_PROMPT_TOKENS == j_gen.GROUND_PROMPT_TOKENS
    assert (t_gen.BOX_THRESHOLD, t_gen.TEXT_THRESHOLD, t_gen.MIN_MASK_PX) == \
        (j_gen.BOX_THRESHOLD, j_gen.TEXT_THRESHOLD, j_gen.MIN_MASK_PX)


def test_depth_ransac_matches_jax(tmp_path):
    """generate(depth-ransac) on 3 synthetic 640x480 scenes and one map
    with too little ground (its lower rows at the far depth, so no plane
    there holds 1000 pixels): the same maps and the same CSV lines."""
    records = j_synthetic.make_dataset(4)
    depth = {r["image_id"]: j_synthetic.render_depth(r["_scene"]) for r in records}
    depth[2][:] = 50.0
    depth[2][::7, ::5] = np.linspace(1.0, 40.0, 69 * 128).reshape(69, 128)
    for name, gen, kw in (("j", j_gen, {}), ("t", t_gen, dict(draws=jax_draws, device="cpu"))):
        root = tmp_path / name
        gen.generate(records, str(root / "ground_maps"), depth_dir="unused",
                     artifacts_root=str(root), depth_loader=lambda r: depth[r["image_id"]], **kw)
    j_maps, t_maps = read_maps(tmp_path / "j" / "ground_maps"), read_maps(tmp_path / "t" / "ground_maps")
    assert sorted(t_maps) == sorted(j_maps) and len(t_maps) >= 2
    for f in j_maps:
        assert t_maps[f].dtype == bool and t_maps[f].shape == (480, 640)
        np.testing.assert_array_equal(t_maps[f], j_maps[f], err_msg=f)
    ng = read_csv(tmp_path / "t" / "no_ground_idx.csv")
    assert ng == read_csv(tmp_path / "j" / "no_ground_idx.csv") and ["2"] in ng


def test_ground_from_depth_ransac_matches_jax():
    """One 640x480 scene: the port's mask with JAX's draws is JAX's; the
    port's own draws (a generator seeded per image) find the true ground."""
    rec = j_synthetic.make_dataset(1)[0]
    d = j_synthetic.render_depth(rec["_scene"])
    K = np.asarray(rec["K"], np.float32)
    want = j_gen.ground_from_depth_ransac(d, K, jax.random.fold_in(jax.random.PRNGKey(0), 0))
    got = t_gen.ground_from_depth_ransac(d, K, draws=jax_draws(0, d[::4, ::4].size), device="cpu")
    np.testing.assert_array_equal(got, want)
    own = t_gen.ground_from_depth_ransac(d, K, generator=torch.Generator().manual_seed(0),
                                         device="cpu")
    truth = t_synthetic.ground_mask(rec["_scene"])
    assert (own & truth).sum() / (own | truth).sum() > 0.8


def test_filter_ground_matches_jax(tmp_path):
    """Maps at 95, 100 and 0 non-zero pixels at stride 5, a non-numeric
    stem and a stray file: the same removed ids and CSV lines."""
    rng = np.random.default_rng(0)
    maps = {}
    for iid, nnz in ((3, 95), (7, 100), (11, 0), (12, 150)):
        m = np.zeros((60, 80), bool)
        idx = rng.choice(12 * 16, nnz, replace=False)
        m[::5, ::5].flat[idx] = True
        m[1::5, 1::5] = True  # off the stride: never counted
        maps[f"{iid}.npz"] = m
    maps["extra.npz"] = np.zeros((60, 80), bool)
    for name in ("j", "t"):
        d = tmp_path / name / "ground_maps"
        os.makedirs(d)
        for f, m in maps.items():
            np.savez_compressed(d / f, ground=m)
        (d / "notes.txt").write_text("x")
    n_j = j_filter.filter_ground(str(tmp_path / "j" / "ground_maps"), str(tmp_path / "j" / "ng.csv"))
    n_t = t_filter.main(["--ground-dir", str(tmp_path / "t" / "ground_maps"),
                         "--csv", str(tmp_path / "t" / "ng.csv")])
    assert n_t == n_j == 2
    assert sorted(os.listdir(tmp_path / "t" / "ground_maps")) == \
        sorted(os.listdir(tmp_path / "j" / "ground_maps"))
    # in the directory's sorted order
    assert read_csv(tmp_path / "t" / "ng.csv") == read_csv(tmp_path / "j" / "ng.csv") == \
        [["11"], ["3"]]


def test_priors_cli_matches_jax(capsys):
    """The priors CLI on 12 synthetic scenes: the same dimension priors
    within 1e-9 and the same printed table."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("j_priors_cli", os.path.join(REPO, "priors.py"))
    j_priors = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_priors)
    from weakcube_tpu_torch.tools import priors as t_priors
    argv = ["--config-file", os.path.join(REPO, "configs/Omni_combined.yaml"), "--synthetic", "12"]
    want = j_priors.main(argv)
    want_out = capsys.readouterr().out
    got = t_priors.main(argv)
    assert capsys.readouterr().out == want_out
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9, err_msg=k)


def test_foundation_requires_models_and_checkpoints(tmp_path):
    records = t_synthetic.make_dataset(1, width=64, height=64)
    with pytest.raises(ValueError, match="foundation method needs"):
        t_gen.generate(records, str(tmp_path / "g"), depth_dir="unused", method="foundation",
                       artifacts_root=str(tmp_path))
    with pytest.raises(SystemExit):
        t_gen.main(["--method", "foundation", "--synthetic", "1", "--device", "cpu"])
    with pytest.raises(SystemExit):  # vit_h has no specs: not offered
        t_gen.main(["--sam-variant", "vit_h", "--synthetic", "1", "--device", "cpu"])


def test_cli_synthetic_on_the_cpu(tmp_path):
    """main(argv) with --synthetic 3 --device cpu writes one map or one CSV
    line per scene, as the JAX CLI's main does on the same scenes (its
    draws are JAX's, the port's its generator's: the counts are compared,
    not the pixels)."""
    out = tmp_path / "g"
    res = t_gen.main(["--synthetic", "3", "--out", str(out), "--artifacts-root", str(tmp_path),
                      "--device", "cpu"])
    assert res["written"] + len(res["no_ground"]) == 3
    assert len(os.listdir(out)) == res["written"]
    if not torch.cuda.is_available():  # the card is the default: no quiet CPU run
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_gen.ground_from_depth_ransac(np.ones((8, 8), np.float32),
                                           np.eye(3, dtype=np.float32))
