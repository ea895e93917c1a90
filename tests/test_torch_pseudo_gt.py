"""GroundingDINO (with its Swin-T and BERT), SAM-HQ and their loaders in
weakcube_tpu_torch against weakcube_tpu.

Both packages get the same numpy weights, drawn into the flax parameter
tree and handed to the port through utils/convert.py (gdino_flax_to_torch,
swin_flax_to_torch, sam_flax_to_torch and their parts), on the same numpy
inputs.

  * float64, within 1e-9 of the output's scale: Swin-T at embed_dim 24,
    depths (1, 1, 2, 1) on 64 x 48 px (window padding, the cyclic shift and
    an odd patch merge all occur), BERT (dim 48, one layer) with the per-
    phrase masks, the deformable attention with locations on and past the
    borders, the fusion, enhancer and decoder layers, SAM vit_tiny's
    windowed and global blocks and the HQ mask decoder. The JAX modules
    compute their attention logits in float32 whatever their dtype
    (preferred_element_type); for these cases their jnp.einsum is replaced
    by one without it (torch_pseudo_gt_check.jax_float64), as the port
    computes its logits in the model's dtype when that is wider.
  * float32, within 1e-4 of scale: one whole GroundingDINO (Swin-T,
    BERT-base, 1 enhancer, 2 decoders, 16 queries, 112 px) with the same
    top-k proposal indices, and one whole Sam vit_tiny at 256 px; on those
    two, the ground-segmentation CLI's generate(method="foundation") on one
    scene (its other methods and CLIs: tests/test_torch_ground_seg.py).
    Their weights come from a state dict in the released layout (released
    names and shapes, random values): JAX runs on the tree its own
    convert_torch_checkpoint makes of it, the port on that tree through
    gdino_flax_to_torch / sam_flax_to_torch, and the port's own loader of
    the released dict (convert_released_checkpoint: the JAX converter's
    changes, the unused keys listed by name) must give exactly those
    weights. For SAM, JAX's four converted transposed-convolution kernels
    are first laid out as flax's ConvTranspose reads them (JAX's converter
    cannot). Full-size released dicts load strictly (names and shapes).
"""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from weakcube_tpu.data import generate_ground_segmentations as j_gen
from weakcube_tpu.data import synthetic as j_synthetic
from weakcube_tpu.data.pseudo_gt import grounding_dino as j_gd
from weakcube_tpu.data.pseudo_gt import sam as j_sam
from weakcube_tpu.data.pseudo_gt import swin as j_swin
from weakcube_tpu_torch.data import generate_ground_segmentations as t_gen
from weakcube_tpu_torch.data.pseudo_gt import grounding_dino as t_gd
from weakcube_tpu_torch.data.pseudo_gt import sam as t_sam
from weakcube_tpu_torch.data.pseudo_gt import swin as t_swin
from weakcube_tpu_torch.utils import convert
from weakcube_tpu_torch.utils.convert import gdino_flax_to_torch, sam_flax_to_torch
from torch_pseudo_gt_check import (draw_tree, fill, jax_float64, jitted, released_gdino_shapes,
                                   released_sam_shapes)

F64 = 1e-9
F32 = 1e-4


def close(got, want, rel, msg=""):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{msg}: max |err| {err:.3e} vs {rel:g} x scale {scale:.3e}"


def params64(module, *args, seed, static=()):
    """numpy draws into the module's parameter tree (args traced, `static`
    appended as they are)."""
    shapes = jax.eval_shape(lambda k, *a: module.init(k, *a, *static), jax.random.PRNGKey(0),
                            *args)["params"]
    return draw_tree(shapes, seed)


def apply64(module, p, *args, static=()):
    """The module's float64 apply, jitted (the first call traces it)."""
    return jitted(lambda p, *a: module.apply({"params": p}, *a, *static))(
        p, *map(jnp.asarray, args))


def port(module, sd):
    module.load_state_dict(sd)
    return module.double().eval()


def part(fn, p):
    """A per-layer converter's state dict for a module of its own."""
    sd = {}
    fn(sd, "x", p)
    return {k[2:]: v for k, v in sd.items()}


def t64(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def test_swin_f64():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 64, 48, 3))
    with jax_float64():
        m = j_swin.SwinT(embed_dim=24, depths=(1, 1, 2, 1), dtype=jnp.float64)
        p = params64(m, x, seed=1)
        want = apply64(m, p, x)
    tm = port(t_swin.SwinT(24, (1, 1, 2, 1)), convert.swin_flax_to_torch(p))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert [g.shape[1:3] for g in got] == [(8, 6), (4, 3), (2, 2)]
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, F64, f"stage {i + 1}")


def test_bert_encoder_and_text_masks_f64():
    tokens = np.array([[101, 5, 6, 1012, 7, 8, 9, 1012, 102, 0, 0, 0],
                       [101, 11, 1029, 12, 102, 0, 0, 0, 0, 0, 0, 0]])
    want_masks = j_gd.build_text_masks(tokens)
    got_masks = t_gd.build_text_masks(tokens)
    for g, w in zip(got_masks, want_masks):
        np.testing.assert_array_equal(g, w)
    attn, pos, tmask = got_masks
    with jax_float64():
        m = j_gd.BertEncoder(vocab=1100, dim=48, layers=1, dtype=jnp.float64)
        p = params64(m, tokens, attn, pos, seed=2)
        p["tok"]["embedding"] = p["tok"]["embedding"] * 50  # words as loud as positions
        want = apply64(m, p, tokens, attn, pos)
        want_pad = apply64(m, p, tokens, tmask)
    tm = port(t_gd.BertEncoder(1100, 48, 1), convert.bert_flax_to_torch(p))
    with torch.no_grad():
        close(tm(*t64(tokens, attn, pos)), want, F64, "per-phrase mask")
        close(tm(*t64(tokens, tmask)), want_pad, F64, "padding mask, absolute positions")


def test_position_embeddings():
    np.testing.assert_array_equal(t_gd.sine_pos_embed_hw(5, 7), j_gd.sine_pos_embed_hw(5, 7))
    ref = np.random.default_rng(3).uniform(0, 1, (2, 6, 4)).astype(np.float32)
    close(t_gd.box_sine_embed(torch.from_numpy(ref)), j_gd.box_sine_embed(jnp.asarray(ref)),
          1e-6, "box_sine_embed [y, x, w, h]")


SHAPES = ((4, 6), (2, 3), (2, 2), (1, 1))


def test_ms_deform_attn_f64():
    """Locations on the borders and past them (clamped to the border)."""
    rng = np.random.default_rng(4)
    B, H, Dh, Q = 2, 8, 4, 5
    value = rng.normal(size=(B, sum(h * w for h, w in SHAPES), H, Dh))
    locs = rng.uniform(-0.4, 1.4, (B, Q, H, 4, 4, 2))
    locs[0, 0, :, :, :2] = [0.0, 1.0]
    aw = rng.uniform(0, 1, (B, Q, H, 16))
    aw /= aw.sum(-1, keepdims=True)
    with jax_float64():
        want = jitted(lambda *a: j_gd.ms_deform_attn(a[0], SHAPES, *a[1:]))(value, locs, aw)
    close(t_gd.ms_deform_attn(*t64(value), SHAPES, *t64(locs, aw)), want, F64)


def text_inputs(rng, B=2, T=6):
    txt = rng.normal(size=(B, T, 256))
    mask = np.ones((B, T), bool)
    mask[1, 4:] = False
    return txt, mask


def test_fusion_f64():
    rng = np.random.default_rng(5)
    img = rng.normal(size=(2, 30, 256)) * 3
    txt, mask = text_inputs(rng)
    with jax_float64():
        m = j_gd.BiAttentionFusion(dtype=jnp.float64)
        p = params64(m, img, txt, mask, seed=6)
        want = apply64(m, p, img, txt, mask)
    tm = port(t_gd.BiAttentionFusion(), part(convert.fusion_flax_to_torch, p))
    with torch.no_grad():
        got = tm(*t64(img, txt, mask))
    close(got[0], want[0], F64, "image")
    close(got[1], want[1], F64, "text")


def test_enhancer_f64():
    """The 2-d reference-point form of the deformable attention."""
    rng = np.random.default_rng(7)
    n = sum(h * w for h, w in SHAPES)
    img, img_pos = rng.normal(size=(2, n, 256)), rng.normal(size=(1, n, 256))
    img_ref = rng.uniform(0, 1, (2, n, 2))
    txt, mask = text_inputs(rng)
    txt_pos = rng.normal(size=(2, 6, 256))
    self_mask = np.tile(np.eye(6, dtype=bool), (2, 1, 1)) | mask[:, None, :]
    args = (img, img_pos, img_ref, txt, txt_pos, mask, self_mask)
    with jax_float64():
        m = j_gd.EnhancerLayer(dtype=jnp.float64)
        p = params64(m, *args, seed=8, static=(SHAPES,))
        want = apply64(m, p, *args, static=(SHAPES,))
    parts = [port(t_gd.BiAttentionFusion(), part(convert.fusion_flax_to_torch, p["fusion"])),
             port(t_gd.TextEnhancerLayer(),
                  part(convert.text_layer_flax_to_torch, p["txt_layer"])),
             port(t_gd.DeformableEncoderLayer(), part(convert.image_layer_flax_to_torch, p))]
    with torch.no_grad():
        got = t_gd.enhancer_step(*parts, *t64(*args), SHAPES)
    close(got[0], want[0], F64, "image")
    close(got[1], want[1], F64, "text")


def test_decoder_layer_f64():
    """The 4-d (box) reference form of the deformable attention."""
    rng = np.random.default_rng(9)
    n = sum(h * w for h, w in SHAPES)
    q, q_pos = rng.normal(size=(2, 7, 256)), rng.normal(size=(2, 7, 256))
    ref = rng.uniform(0.05, 0.95, (2, 7, 4))
    img = rng.normal(size=(2, n, 256))
    txt, mask = text_inputs(rng)
    with jax_float64():
        m = j_gd.DecoderLayer(dtype=jnp.float64)
        call = lambda k, *a: m.init(k, *a[:4], SHAPES, *a[4:])  # noqa: E731
        p = draw_tree(jax.eval_shape(call, jax.random.PRNGKey(0), q, q_pos, ref, img, txt,
                                     mask)["params"], seed=10)
        want = jitted(lambda p, *a: m.apply({"params": p}, *a[:4], SHAPES, *a[4:]))(
            p, *map(jnp.asarray, (q, q_pos, ref, img, txt, mask)))
    tm = port(t_gd.DecoderLayer(), part(convert.decoder_layer_flax_to_torch, p))
    with torch.no_grad():
        close(tm(*t64(q, q_pos, ref, img), SHAPES, *t64(txt, mask)), want, F64)


@pytest.mark.parametrize("window", [14, 0], ids=["windowed", "global"])
def test_sam_block_f64(window):
    dim, _, heads, _ = j_sam.SAM_SPECS["vit_tiny"]
    x = np.random.default_rng(11).normal(size=(1, 16, 16, dim))
    with jax_float64():
        m = j_sam.ViTDetBlock(dim, heads, window, 16, dtype=jnp.float64)
        p = params64(m, x, seed=12)
        want = apply64(m, p, x)
    tm = port(t_sam.ViTDetBlock(dim, heads, window, 16), part(convert.sam_block_flax_to_torch, p))
    with torch.no_grad():
        close(tm(torch.from_numpy(x)), want, F64)


def test_mask_decoder_hq_f64():
    rng = np.random.default_rng(13)
    dim = j_sam.SAM_SPECS["vit_tiny"][0]
    emb, pe = rng.normal(size=(1, 16, 16, 256)), rng.normal(size=(16, 16, 256))
    prompts = rng.normal(size=(1, 2, 2, 256))
    early, final = rng.normal(size=(1, 16, 16, dim)), rng.normal(size=(1, 16, 16, 256))
    with jax_float64():
        m = j_sam.MaskDecoder(hq=True, dtype=jnp.float64)
        p = params64(m, emb, pe, prompts, early, final, seed=14)
        want = apply64(m, p, emb, pe, prompts, early, final)
    tm = port(t_sam.MaskDecoder(dim), part(convert.sam_mask_decoder_flax_to_torch, p))
    with torch.no_grad():
        got = tm(*t64(emb, pe, prompts, early, final))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32  # both return float32
    close(got, want, F64)


# ---------------------------------------------------------------------------
# whole models, float32
# ---------------------------------------------------------------------------

TOKENS = np.array([[101, 2598, 1012, 102] + [0] * 12])


@pytest.fixture(scope="module")
def gdino():
    """A released-layout groundingdino state dict (Swin-T, BERT-base, 1
    encoder and 2 decoder layers, 16 queries; random values), JAX's
    GroundingDINO(1, 2, 16) float32 (jitted) on the tree JAX's
    convert_torch_checkpoint makes of it, and the port's on that tree
    through gdino_flax_to_torch. JAX's converter reads one depth for both
    stacks: it is handed the encoder layer twice, and the copy is dropped
    from its tree."""
    sd = fill(released_gdino_shapes(1, 2, 16), seed=20)
    enc = "transformer.encoder."
    twice = dict(sd, **{k.replace(".0.", ".1.", 1): v for k, v in sd.items()
                        if k.startswith(enc) and ".0." in k})
    params = j_gd.convert_torch_checkpoint(twice, num_layers=2)
    del params["enhancer1"]
    m = j_gd.GroundingDINO(num_enhancer=1, num_decoder=2, num_queries=16, dtype=jnp.float32)
    tm = t_gd.GroundingDINO(1, 2, 16)
    tm.load_state_dict(gdino_flax_to_torch(params))
    return dict(apply=jitted(m, xla_backend_optimization_level=0), params=params, port=tm.eval(),
                released=sd)


def run_gdino(j, params, x, monkeypatch):
    """(boxes, logits, top-k indices) of the jitted JAX model."""
    picked = []
    real = jax.lax.top_k

    def top_k(s, k):
        vals, idx = real(s, k)
        jax.debug.callback(lambda i: picked.append(np.asarray(i)), idx)
        return vals, idx
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    attn, pos, tmask = j_gd.build_text_masks(TOKENS)
    boxes, logits = j["apply"]({"params": params}, jnp.asarray(x), jnp.asarray(TOKENS),
                               jnp.asarray(tmask), jnp.asarray(attn), jnp.asarray(pos))
    boxes, logits = np.asarray(boxes), np.asarray(logits)
    jax.effects_barrier()
    return boxes, logits, picked[-1]


def run_port_gdino(tm, x, monkeypatch):
    picked = []
    real = tm.select_queries

    def select(*a):
        ref, idx = real(*a)
        picked.append(idx.numpy().copy())
        return ref, idx
    monkeypatch.setattr(tm, "select_queries", select)
    attn, pos, tmask = t_gd.build_text_masks(TOKENS)
    with torch.no_grad():
        boxes, logits = tm(torch.from_numpy(x), *t64(TOKENS, tmask, attn, pos))
    return boxes, logits, picked[-1]


def test_grounding_dino_whole_f32(gdino, monkeypatch):
    """Boxes and logits within 1e-4 of scale, the same top-k proposals."""
    x = np.random.default_rng(21).normal(size=(1, 112, 112, 3)).astype(np.float32)
    (tb, tl, ti), (jb, jl, ji) = (run_port_gdino(gdino["port"], x, monkeypatch),
                                  run_gdino(gdino, gdino["params"], x, monkeypatch))
    assert ji.shape == (1, 16)
    close(tb, jb, F32, "boxes")
    tl = tl.numpy()
    assert np.array_equal(np.isfinite(tl), np.isfinite(jl))
    fin = np.isfinite(jl)
    close(tl[fin], jl[fin], F32, "logits")
    assert [set(r) for r in ti] == [set(r) for r in ji]


def same_state(got, model):
    """A converted state dict holds exactly the model's tensors; then it
    loads strictly."""
    state = model.state_dict()
    assert set(got) == set(state)
    for k, v in got.items():
        assert torch.equal(v, state[k]), k
    model.load_state_dict(got)


def test_gdino_released_dict_loads_as_jax_converts(gdino):
    """The port's own loader on the released dict (the JAX converter's
    changes, the unused keys dropped) gives exactly the weights whose
    forward matched JAX's on that dict (test_grounding_dino_whole_f32)."""
    same_state(t_gd.convert_released_checkpoint(
        {"module." + k: torch.from_numpy(v) for k, v in gdino["released"].items()}),
        gdino["port"])


@pytest.fixture(scope="module")
def sam_tiny():
    """A released-layout sam_hq vit_tiny state dict at 256 px (random
    values), JAX's Sam float32 (jitted) on the tree JAX's
    convert_torch_checkpoint makes of it, its four transposed-convolution
    kernels laid out as flax reads them (JAX's converter cannot), and the
    port's on that tree through sam_flax_to_torch."""
    sd = fill(released_sam_shapes(256, *t_sam.SAM_SPECS["vit_tiny"]), seed=22)
    tree = j_sam.convert_torch_checkpoint(sd, "vit_tiny", hq=True)
    dec, md = tree["mask_decoder"], "mask_decoder."
    for leaf, key in (("upscale1", "output_upscaling.0"), ("upscale2", "output_upscaling.3"),
                      ("hq_compress_early", "compress_vit_feat.0"),
                      ("hq_compress_final", "embedding_encoder.0")):
        dec[leaf]["kernel"] = sd[md + key + ".weight"].transpose(2, 3, 0, 1)[::-1, ::-1]
    m = j_sam.Sam(variant="vit_tiny", hq=True, dtype=jnp.float32)
    tm = t_sam.Sam("vit_tiny", 256)
    tm.load_state_dict(sam_flax_to_torch(tree, "vit_tiny"))
    return dict(apply=jitted(m), params=tree, port=tm.eval(), released=sd)


@pytest.fixture
def sam_at_256(monkeypatch):
    """SAM's prompt space (IMG_SIZE) at the tiny model's 256 px in both
    packages, as the pipeline has it at 1024 (the JAX module reads it while
    tracing: every call of the shared jitted SAM runs under this)."""
    monkeypatch.setattr(j_sam, "IMG_SIZE", 256)
    monkeypatch.setattr(t_sam, "IMG_SIZE", 256)


SAM_X = np.random.default_rng(23).normal(size=(1, 256, 256, 3)).astype(np.float32)
SAM_BOX = np.array([[[25.0, 37.5, 175.0, 255.0]]], np.float32)  # past the bottom edge


def test_sam_whole_f32(sam_tiny, sam_at_256):
    want = np.asarray(sam_tiny["apply"]({"params": sam_tiny["params"]}, SAM_X, SAM_BOX))
    with torch.no_grad():
        got = sam_tiny["port"](*t64(SAM_X, SAM_BOX))
    assert got.shape == (1, 1, 64, 64)
    close(got, want, F32)
    bad = dict(sam_tiny["params"], dense_pe=sam_tiny["params"]["dense_pe"] + 1)
    with pytest.raises(ValueError, match="one Gaussian matrix"):
        convert.sam_flax_to_torch(bad, "vit_tiny")


def test_sam_released_dict_loads_as_converted(sam_tiny):
    """The port's own loader on the released dict gives exactly what
    sam_flax_to_torch makes of JAX's (kernel-corrected) tree."""
    same_state(t_sam.convert_released_checkpoint(
        {k: torch.from_numpy(v) for k, v in sam_tiny["released"].items()}), sam_tiny["port"])


def test_released_layouts_load_strictly_at_full_size():
    """groundingdino_swint_ogc (6 + 6 layers, 900 queries) and
    sam_hq_vit_l at 1024 px, names and shapes (modules on the meta device,
    the tensors assigned): every key but the listed unused ones is read."""
    for shapes, make, convert_released, unused in (
            (released_gdino_shapes(), t_gd.GroundingDINO, t_gd.convert_released_checkpoint,
             t_gd.UNUSED_CHECKPOINT_KEYS),
            (released_sam_shapes(1024, *t_sam.SAM_SPECS["vit_l"]),
             lambda: t_sam.Sam("vit_l", 1024), t_sam.convert_released_checkpoint,
             t_sam.UNUSED_CHECKPOINT_KEYS)):
        with torch.device("meta"):
            tm = make()
        tm.load_state_dict(convert_released({k: torch.from_numpy(v)
                                             for k, v in fill(shapes).items()}), assign=True)
        assert set(unused) <= set(shapes) and not set(unused) & set(tm.state_dict())


class _Recorder:
    """A JAX model handle whose apply is a jitted one and records its
    outputs."""

    def __init__(self, apply_jit):
        self.apply_jit = apply_jit
        self.outputs = []

    def apply(self, *args, **kw):
        out = self.apply_jit(*args, **kw)
        self.outputs.append(jax.tree_util.tree_map(np.asarray, out))
        return out


def test_generate_foundation_matches_jax(gdino, sam_tiny, sam_at_256, tmp_path):
    """data/generate_ground_segmentations.py::generate(method="foundation")
    on one 128x96 synthetic scene in both packages (box_threshold -1: every
    image reaches SAM; SAM's IMG_SIZE 256 in both). The box fed to SAM
    agrees within 1e-4 of its scale; the written masks are equal except at
    pixels whose SAM logit (at 64 x 64) lies within 1e-3 of its scale of 0,
    resized as the mask is."""
    assert TOKENS.tolist() == [j_gen.GROUND_PROMPT_TOKENS + [0] * 12]
    sam_in, sam_out = [], []

    def record(module, inputs, out):
        sam_in.append(inputs[1].numpy().copy())
        sam_out.append(out.numpy().copy())
    hook = sam_tiny["port"].register_forward_hook(record)
    j_gdino, j_sam_rec = _Recorder(gdino["apply"]), _Recorder(sam_tiny["apply"])
    j_box = []
    real = j_sam_rec.apply
    j_sam_rec.apply = lambda v, x, b: (j_box.append(np.asarray(b)), real(v, x, b))[1]

    records = j_synthetic.make_dataset(1, width=128, height=96, seed=5)
    load = lambda r: j_synthetic.render_image(r["_scene"])  # noqa: E731
    try:
        j_gen.generate(records, str(tmp_path / "j" / "g"), "unused", "foundation",
                       artifacts_root=str(tmp_path / "j"),
                       foundation_models=(j_gdino, gdino["params"], j_sam_rec,
                                          sam_tiny["params"]),
                       image_loader=load, box_threshold=-1.0, gdino_side=112)
        t_gen.generate(records, str(tmp_path / "t" / "g"), "unused", "foundation",
                       artifacts_root=str(tmp_path / "t"),
                       foundation_models=(gdino["port"], sam_tiny["port"]), image_loader=load,
                       box_threshold=-1.0, gdino_side=112)
    finally:
        hook.remove()
    assert len(j_box) == len(sam_in) == 1
    np.testing.assert_allclose(sam_in[0], j_box[0], rtol=0, atol=1e-4 * np.abs(j_box[0]).max())
    logit = j_sam_rec.outputs[0][0, 0]
    np.testing.assert_allclose(sam_out[0][0, 0], logit, rtol=0, atol=1e-4 * np.abs(logit).max())
    unsure = np.abs(logit) <= 1e-3 * np.abs(logit).max()
    unsure = np.asarray(Image.fromarray(unsure.astype(np.uint8) * 255).resize(
        (128, 96), Image.NEAREST)) > 127
    j_maps, t_maps = read_maps(tmp_path / "j" / "g"), read_maps(tmp_path / "t" / "g")
    assert sorted(t_maps) == sorted(j_maps)
    for f in j_maps:
        assert t_maps[f].dtype == bool and t_maps[f].shape == (96, 128)
        assert not np.any((t_maps[f] != j_maps[f]) & ~unsure), f
    assert read_csv(tmp_path / "t" / "no_ground_idx.csv") == \
        read_csv(tmp_path / "j" / "no_ground_idx.csv")


def read_maps(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with np.load(os.path.join(d, f)) as z:
            out[f] = z["ground"]
    return out


def read_csv(path):
    with open(path) as f:
        return [row for row in csv.reader(f) if row]


# ---------------------------------------------------------------------------
# the port against the benchmark's plain float32 reference
# (benchmark/reference/sam_hq.py), vit_tiny at 256 px (a 16 x 16 grid: 4
# padded 14 x 14 windows and global blocks), on one draw of the benchmark's
# SAM weights (benchmark/harness/sam_weights.py)
# ---------------------------------------------------------------------------

def _bench_module(rel):
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "benchmark", rel)
    spec = importlib.util.spec_from_file_location("bench_" + rel.replace("/", "_")[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sam_ref_pair():
    ref_mod = _bench_module("reference/sam_hq.py")
    weights = _bench_module("harness/sam_weights.py")
    ref = ref_mod.SamHQ("vit_tiny", 256).eval()
    sd = weights.make_state_dict(ref, 20260423, "cpu")
    ref.load_state_dict(sd)
    port = t_sam.Sam("vit_tiny", 256)
    port.load_state_dict(sd)
    rng = np.random.default_rng(24)
    images = [rng.integers(0, 256, (48 + 9 * i, 64 - 7 * i, 3), dtype=np.uint8) for i in range(3)]
    boxes = [np.array([2.0 + i, 20.0 + 3 * i, 50.0 - 4 * i, 47.0], np.float32) for i in range(3)]
    return dict(ref_mod=ref_mod, ref=ref, port=port.eval(), images=images, boxes=boxes)


def test_sam_matches_plain_reference(sam_ref_pair):
    """float32 on both sides, so only the order of float32 sums differs:
    the HQ token's low-resolution mask logits of sam_masks' forward within
    1e-4 of their scale, image by image, on the reference's own
    preprocessing; the masks sam_masks returns are the port's logits > 0,
    resized to each image. The logits must not be flat."""
    p = sam_ref_pair
    want = p["ref_mod"].mask_logits(p["ref"], p["images"], p["boxes"], "cpu")
    got = []
    hook = p["port"].register_forward_hook(lambda m, i, out: got.append(out))
    try:
        masks = t_gen.sam_masks(p["port"], p["images"], p["boxes"])
    finally:
        hook.remove()
    assert len(got) == 1 and got[0].shape == (3, 1, 64, 64) and got[0].dtype == torch.float32
    for i, (w, img, m) in enumerate(zip(want, p["images"], masks)):
        assert float(w.std()) > 0.1 and 0.05 < float((w > 0).float().mean()) < 0.95
        close(got[0][i], w, F32, f"image {i}")
        assert m.dtype == bool and m.shape == img.shape[:2]
        low = (got[0][i, 0] > 0).numpy().astype(np.uint8) * 255
        want_m = np.asarray(Image.fromarray(low).resize(img.shape[1::-1], Image.NEAREST)) > 127
        np.testing.assert_array_equal(m, want_m)


def test_sam_masks_spans_in_order(sam_ref_pair):
    """Under a profiler, one sam_masks call records the root sam.batch
    holding sam.preprocess, sam.encoder, sam.decoder and sam.masks_out in
    that order, each inside the root, all under the root's id."""
    from weakcube_tpu_torch.utils import trace as port_trace
    p = sam_ref_pair
    port_trace.take()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t_gen.sam_masks(p["port"], p["images"][:2], p["boxes"][:2])
    spans = port_trace.take()
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["sam.batch"]
    root = roots[0]
    kids = sorted((s for s in spans if s.parent == root.id), key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["sam.preprocess", "sam.encoder", "sam.decoder",
                                      "sam.masks_out"]
    assert all(s.root == root.id for s in spans)
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in kids)
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
