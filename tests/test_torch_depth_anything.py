"""Depth Anything V2 and the depth pseudo-GT CLI of weakcube_tpu_torch
against weakcube_tpu.

ViT-S at 98 px (N = 50 tokens) and 196 px (N = 197), float32: both packages
get the same numpy weights, drawn into the flax parameter tree and handed to
the port through utils/convert.py::dav2_flax_to_torch. The JAX modules run
with their default pad_mode="once" (tokens padded to 512 with segment ids;
the einsum attention on the CPU). The whole pseudo-GT CLI `generate()` runs
in both packages from one flax-params .npz.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weakcube_tpu.data import generate_depth_maps as j_gen
from weakcube_tpu.data import synthetic as j_synthetic
from weakcube_tpu.data.pseudo_gt import depth_anything_v2 as j_dav2
from weakcube_tpu_torch.data import generate_depth_maps as t_gen
from weakcube_tpu_torch.data import synthetic as t_synthetic
from weakcube_tpu_torch.data.pseudo_gt import depth_anything_v2 as t_dav2
from weakcube_tpu_torch.utils.convert import dav2_flax_to_torch

VARIANT = "vits"
B = 2


def draw_params(size, seed):
    """numpy draws into the flax DepthAnythingV2 tree: fan-in normal
    kernels, biases in +-0.1, norm scales and layer scales in [0.5, 1.5],
    position embedding N(0, 0.02)."""
    model = j_dav2.DepthAnythingV2(variant=VARIANT, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, size, size, 3))))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape).astype(np.float32)
        if name in ("scale", "ls1_gamma", "ls2_gamma"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        std = 0.02 if name in ("pos_embed", "cls_token") else None
        if std:
            return rng.normal(0, std, s.shape).astype(np.float32)
        return rng.uniform(-0.1, 0.1, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_model(params, size, dtype=torch.float32):
    m = t_dav2.DepthAnythingV2(VARIANT, 20.0, size)
    m.load_state_dict(dav2_flax_to_torch(params, VARIANT))
    return m.to(dtype).eval()


@pytest.fixture(scope="module", params=[98, 196], ids=["98px", "196px"])
def pair(request):
    size = request.param
    params = draw_params(size, seed=size)
    x = np.random.default_rng(1).normal(size=(B, size, size, 3)).astype(np.float32)
    return dict(size=size, params=params, x=x, tm=port_model(params, size))


def close(a, b, atol, rtol=1e-5, msg=""):
    np.testing.assert_allclose(a.detach().numpy() if isinstance(a, torch.Tensor) else a,
                               np.asarray(b), atol=atol, rtol=rtol, err_msg=msg)


def test_block(pair):
    """One encoder block on random tokens: LayerNorm eps 1e-6, erf GELU,
    layer scales; float32 sums in another order (1e-4 on tokens of size ~1)."""
    p = pair["params"]["backbone"]["block0"]
    dim, _, heads, _, _ = t_dav2.VIT_SPECS[VARIANT]
    x = np.random.default_rng(2).normal(size=(B, 37, dim)).astype(np.float32)
    want = j_dav2.Block(dim, heads, jnp.float32).apply({"params": p}, jnp.asarray(x))
    with torch.no_grad():
        got = pair["tm"].pretrained.blocks[0](torch.from_numpy(x))
    close(got, want, atol=1e-4, rtol=1e-4)


def test_dinov2_taps(pair):
    """The four taps through the final norm, the JAX encoder padding its
    tokens to 512 with segment ids, the port running at the real N."""
    want = j_dav2.DINOv2(VARIANT, dtype=jnp.float32).apply(
        {"params": pair["params"]["backbone"]}, jnp.asarray(pair["x"]))
    with torch.no_grad():
        got = pair["tm"].pretrained(torch.from_numpy(pair["x"]).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 4
    for i, (a, b) in enumerate(zip(got, want)):
        close(a.permute(0, 2, 3, 1), b, atol=1e-4, rtol=1e-4, msg=f"tap {i}")


def test_dpt_head(pair):
    """The decoder alone on the same random taps: learned resize layers,
    refinenet fusion, align_corners bilinear; depth within 1e-4 m."""
    size = pair["size"]
    g = size // t_dav2.PATCH
    dim = t_dav2.VIT_SPECS[VARIANT][0]
    rng = np.random.default_rng(3)
    taps = [rng.normal(size=(B, g, g, dim)).astype(np.float32) for _ in range(4)]
    want = j_dav2.DPTHead(VARIANT, 20.0, jnp.float32).apply(
        {"params": pair["params"]["head"]}, [jnp.asarray(t) for t in taps], (size, size))
    with torch.no_grad():
        got = pair["tm"].depth_head([torch.from_numpy(t).permute(0, 3, 1, 2) for t in taps],
                                    (size, size))
    assert got.shape == (B, size, size) and got.dtype == torch.float32
    close(got, want, atol=1e-4)


def test_depth_anything_v2(pair):
    """The whole model: depth in metres within 1e-4 (float32 op order through
    12 blocks and the decoder), on a depth map that is not degenerate."""
    want = np.asarray(j_dav2.DepthAnythingV2(VARIANT, 20.0, jnp.float32).apply(
        {"params": pair["params"]}, jnp.asarray(pair["x"])))
    with torch.no_grad():
        got = pair["tm"](torch.from_numpy(pair["x"]))
    assert got.shape == (B, pair["size"], pair["size"])
    assert float(np.std(want)) > 1e-3
    close(got, want, atol=1e-4)


def released_state_dict(variant, grid, seed=0):
    """A state dict with the released checkpoints' names and shapes (as in
    tests/test_pseudo_gt_models.py), float32."""
    dim, depth, _, feat, out_ch = t_dav2.VIT_SPECS[variant]
    rng = np.random.default_rng(seed)
    sd = {"pretrained.patch_embed.proj.weight": rng.normal(size=(dim, 3, 14, 14)),
          "pretrained.patch_embed.proj.bias": rng.normal(size=(dim,)),
          "pretrained.cls_token": rng.normal(size=(1, 1, dim)),
          "pretrained.pos_embed": rng.normal(size=(1, 1 + grid * grid, dim)),
          "pretrained.norm.weight": rng.normal(size=dim),
          "pretrained.norm.bias": rng.normal(size=dim)}
    for i in range(depth):
        p = f"pretrained.blocks.{i}."
        for name, shape in (("norm1.weight", (dim,)), ("norm1.bias", (dim,)),
                            ("norm2.weight", (dim,)), ("norm2.bias", (dim,)),
                            ("attn.qkv.weight", (3 * dim, dim)), ("attn.qkv.bias", (3 * dim,)),
                            ("attn.proj.weight", (dim, dim)), ("attn.proj.bias", (dim,)),
                            ("mlp.fc1.weight", (4 * dim, dim)), ("mlp.fc1.bias", (4 * dim,)),
                            ("mlp.fc2.weight", (dim, 4 * dim)), ("mlp.fc2.bias", (dim,)),
                            ("ls1.gamma", (dim,)), ("ls2.gamma", (dim,))):
            sd[p + name] = rng.normal(size=shape)
    for i in range(4):
        sd[f"depth_head.projects.{i}.weight"] = rng.normal(size=(out_ch[i], dim, 1, 1))
        sd[f"depth_head.projects.{i}.bias"] = rng.normal(size=out_ch[i])
        sd[f"depth_head.scratch.layer{i + 1}_rn.weight"] = rng.normal(size=(feat, out_ch[i], 3, 3))
        rn = f"depth_head.scratch.refinenet{i + 1}."
        for unit in ("resConfUnit1", "resConfUnit2"):
            for c in ("conv1", "conv2"):
                sd[rn + f"{unit}.{c}.weight"] = rng.normal(size=(feat, feat, 3, 3))
                sd[rn + f"{unit}.{c}.bias"] = rng.normal(size=feat)
        sd[rn + "out_conv.weight"] = rng.normal(size=(feat, feat, 1, 1))
        sd[rn + "out_conv.bias"] = rng.normal(size=feat)
    for i, k in ((0, 4), (1, 2)):
        sd[f"depth_head.resize_layers.{i}.weight"] = rng.normal(size=(out_ch[i], out_ch[i], k, k))
        sd[f"depth_head.resize_layers.{i}.bias"] = rng.normal(size=out_ch[i])
    sd["depth_head.resize_layers.3.weight"] = rng.normal(size=(out_ch[3], out_ch[3], 3, 3))
    sd["depth_head.resize_layers.3.bias"] = rng.normal(size=out_ch[3])
    sd["depth_head.scratch.output_conv1.weight"] = rng.normal(size=(feat // 2, feat, 3, 3))
    sd["depth_head.scratch.output_conv1.bias"] = rng.normal(size=feat // 2)
    sd["depth_head.scratch.output_conv2.0.weight"] = rng.normal(size=(32, feat // 2, 3, 3))
    sd["depth_head.scratch.output_conv2.0.bias"] = rng.normal(size=32)
    sd["depth_head.scratch.output_conv2.2.weight"] = rng.normal(size=(1, 32, 1, 1))
    sd["depth_head.scratch.output_conv2.2.bias"] = rng.normal(size=1)
    return {k: v.astype(np.float32) for k, v in sd.items()}


def test_converter_is_the_inverse_of_convert_torch_checkpoint():
    """released names -> flax tree (JAX converter) -> port state dict gives
    back every tensor exactly, and the port's module takes it with
    strict=True. refinenet4.resConfUnit1, unused and dropped by the JAX
    converter, comes back as zeros."""
    sd = released_state_dict(VARIANT, 7)
    got = dav2_flax_to_torch(j_dav2.convert_torch_checkpoint(sd, VARIANT), VARIANT)
    assert set(got) == set(sd)
    dead = "depth_head.scratch.refinenet4.resConfUnit1."
    for k, v in sd.items():
        if k.startswith(dead):
            assert not got[k].any() and got[k].shape == v.shape, k
        else:
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    m = t_dav2.DepthAnythingV2(VARIANT, 20.0, 98)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)


def test_preprocess_images_matches_pil():
    """Antialiased bicubic in torch vs PIL's BICUBIC resize, at the canon and
    at 98 px: within one uint8 level before normalisation (PIL rounds to
    uint8 between its horizontal and vertical passes)."""
    recs = t_synthetic.make_dataset(2, seed=3)
    imgs = [t_synthetic.render_image(r["_scene"]) for r in recs]
    imgs.append(np.random.default_rng(0).integers(0, 256, (61, 90, 3), dtype=np.uint8))
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    for size in (518, 98):
        want = j_dav2.preprocess_images(imgs, size)
        got = t_dav2.preprocess_images(imgs, size, device="cpu").numpy()
        assert got.shape == want.shape == (3, size, size, 3)
        levels = np.abs((got - want) * std * 255.0)
        assert levels.max() <= 1.0 + 1e-3, levels.max()


def test_preprocess_images_defaults_to_the_card():
    """With no device given, preprocessing runs on the card and raises where
    there is none; device="cpu" runs it on the CPU."""
    img = np.random.default_rng(0).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    assert t_dav2.preprocess_images([img], 28, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert t_dav2.preprocess_images([img], 28).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_dav2.preprocess_images([img], 28)


def test_attention_passes_projection_views(monkeypatch):
    """The encoder hands the kernel q, k, v as views of its qkv projection's
    (B, N, 3, H, d) output, with no copy between."""
    seen = []
    kernel = t_dav2.flash_attention

    def spy(q, k, v, scale):
        seen.append((q, k, v))
        return kernel(q, k, v, scale)
    monkeypatch.setattr(t_dav2, "flash_attention", spy)
    attn = t_dav2.Attention(2 * 64, 2)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 7, 128)).astype(np.float32))
    with torch.no_grad():
        out = attn(x)
    assert out.shape == (3, 7, 128)
    q, k, v = seen[0]
    assert q.shape == (3, 2, 7, 64)
    for i, t in enumerate((q, k, v)):
        assert t.stride() == (7 * 3 * 128, 64, 3 * 128, 1)
        assert t.data_ptr() == q.data_ptr() + i * 128 * t.element_size()


def test_synthetic_is_the_jax_packages():
    a, b = j_synthetic.make_dataset(3, seed=5), t_synthetic.make_dataset(3, seed=5)
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(j_synthetic.render_image(ra["_scene"]),
                                      t_synthetic.render_image(rb["_scene"]))
        assert ra["annotations"] == rb["annotations"]


def test_generate_matches_jax(tmp_path, monkeypatch):
    """The pseudo-GT CLI end to end in both packages from one flax-params
    .npz (the format the JAX CLI loads): ViT-S at 98 px, batch 2 over 3
    images (the last chunk padded). Both run in float32: with these random
    weights bf16 rounding alone moves the depth by up to 0.2 m in either
    package, so a bf16 comparison could not tell a fault from rounding. The
    same files, float16 depth of each image's size, within 1e-2 m (about one
    float16 step at 8-16 m)."""
    params = draw_params(98, seed=11)
    ckpt = str(tmp_path / "dav2_vits.npz")
    np.savez(ckpt, params=np.array(jax.tree_util.tree_map(np.asarray, params), dtype=object))
    records = t_synthetic.make_dataset(3, seed=2, width=160, height=120)
    loader = lambda r: t_synthetic.render_image(r["_scene"])  # noqa: E731
    monkeypatch.setattr(j_dav2, "DepthAnythingV2",
                        functools.partial(j_dav2.DepthAnythingV2, dtype=jnp.float32))
    j_gen.generate(records, str(tmp_path / "jax"), ckpt, variant=VARIANT, batch_size=2,
                   input_size=98, image_loader=loader)
    model = t_gen.load_model(ckpt, VARIANT, input_size=98, device="cpu", dtype=torch.float32)
    t_gen.generate(records, str(tmp_path / "torch"), batch_size=2, image_loader=loader,
                   model=model)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) == ["0.npz", "1.npz", "2.npz"]
    for n in names:
        with np.load(tmp_path / "jax" / n) as a, np.load(tmp_path / "torch" / n) as b:
            assert a["depth"].dtype == b["depth"].dtype == np.float16
            assert a["depth"].shape == b["depth"].shape == (120, 160)
            assert float(np.std(a["depth"].astype(np.float32))) > 1e-3
            np.testing.assert_allclose(b["depth"].astype(np.float32),
                                       a["depth"].astype(np.float32), atol=1e-2)


def test_depth_entry_points_want_the_card():
    """device="cpu" runs the depth model on the CPU (bfloat16 by default,
    depth in float32, the last chunk padded); with no device given it wants
    the card and raises where there is none."""
    m = t_gen.load_model(None, VARIANT, input_size=28, device="cpu")
    assert next(m.parameters()).dtype == torch.bfloat16
    d = t_gen.depth_of_images(m, torch.zeros((3, 28, 28, 3)), batch_size=2)
    assert d.shape == (3, 28, 28) and d.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_gen.load_model(None, VARIANT, input_size=28)


# --------------------------------------------------------------------------
# the port against the benchmark's plain float32 reference
# (benchmark/reference/depth_anything_v2.py), ViT-S at 56 px (N = 17), on one
# draw of the benchmark's depth weights (benchmark/harness/depth_weights.py)

def _bench_module(rel):
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "benchmark", rel)
    spec = importlib.util.spec_from_file_location("bench_" + rel.replace("/", "_")[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_SIZE = 56


@pytest.fixture(scope="module")
def ref_pair():
    ref_mod = _bench_module("reference/depth_anything_v2.py")
    weights = _bench_module("harness/depth_weights.py")
    ref = ref_mod.DepthAnythingV2(VARIANT, 20.0, REF_SIZE // 14)
    sd = weights.make_state_dict(ref, 20260319, "cpu")
    ref.load_state_dict(sd)
    port = t_gen.load_model(sd, VARIANT, 20.0, REF_SIZE, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (30 + 7 * i, 44 - 5 * i, 3), dtype=np.uint8) for i in range(3)]
    return dict(ref_mod=ref_mod, ref=ref, port=port, images=images)


@pytest.mark.parametrize("part", ["taps", "model", "depth_maps"])
def test_port_matches_plain_reference(ref_pair, part):
    """float32 on both sides, so only the order of float32 sums differs:
    the four encoder taps (LayerNorm'ed, values ~1) and the model's depth
    within 1e-4; depth_maps' float16 host maps against the reference's own
    preprocessing, forward and resize out within 1.6e-2 m, one float16 step
    at 16-20 m (a float32 difference of ~1e-5 can round to either side of
    one). The maps must not be flat."""
    ref_mod, ref, port = ref_pair["ref_mod"], ref_pair["ref"], ref_pair["port"]
    images = ref_pair["images"]
    x = torch.cat([ref_mod.preprocess(torch.from_numpy(im), REF_SIZE) for im in images])
    with torch.no_grad():
        if part == "taps":
            want = ref.encoder(x)
            got = port.pretrained(x)
            assert len(got) == len(want) == 4
            for i, (a, b) in enumerate(zip(got, want)):
                close(a, b, atol=1e-4, rtol=1e-4, msg=f"tap {i}")
        elif part == "model":
            want = ref(x)
            assert float(want.std()) > 0.1
            close(port(x.permute(0, 2, 3, 1)), want, atol=1e-4)
        else:
            sizes = [im.shape[:2] for im in images]
            want = ref_mod.depth_maps(ref, images, sizes, "cpu")
            got = t_gen.depth_maps(port, images, sizes)
            for a, b, hw in zip(got, want, sizes):
                assert a.dtype == b.dtype == torch.float16 and tuple(a.shape) == hw
                assert a.device.type == "cpu" and float(b.float().std()) > 0.1
                close(a.float(), b.float(), atol=1.6e-2)


def test_depth_maps_spans_in_order(ref_pair):
    """Under a profiler, one depth_maps call records the root depth.batch
    holding depth.preprocess, depth.encoder, depth.head and depth.resize_out
    in that order, each inside the root, all under the root's id."""
    from weakcube_tpu_torch.utils import trace as port_trace
    images = ref_pair["images"][:2]
    port_trace.take()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t_gen.depth_maps(ref_pair["port"], images, [im.shape[:2] for im in images])
    spans = port_trace.take()
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["depth.batch"]
    root = roots[0]
    kids = sorted((s for s in spans if s.parent == root.id), key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["depth.preprocess", "depth.encoder", "depth.head",
                                      "depth.resize_out"]
    assert all(s.root == root.id for s in spans)
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in kids)
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
