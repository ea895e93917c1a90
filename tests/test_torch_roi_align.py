"""Multi-level ROIAlignV2 of weakcube_tpu_torch against weakcube_tpu.

The plain PyTorch version (ops/roi_align.py) is held to the exact JAX
gather version at float32, and to the Pallas TPU kernel (interpret mode) at
that kernel's bf16 tolerance. The CUDA kernel is held to the plain version
on the card only, in tests/test_torch_cuda.py (marker `cuda`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weakcube_tpu.ops import roi_align as j_ra
from weakcube_tpu_torch.ops import roi_align as t_ra
from weakcube_tpu_torch.ops import roi_align_cuda
from torch_roi_boxes import BOX_SETS, box_set, edge_boxes

STRIDES = (4, 8, 16, 32, 64)


def pyramid(rng, B, size, C):
    return [rng.normal(size=(B, size // s, size // s, C)).astype(np.float32) for s in STRIDES]


def test_assign_fpn_levels():
    b = edge_boxes(np.random.default_rng(0), 2, 30, 128)
    got = t_ra.assign_fpn_levels(torch.from_numpy(b), 2, 6)
    want = j_ra.assign_fpn_levels(jnp.asarray(b), 2, 6)
    assert got.tolist() == np.asarray(want).tolist()
    assert {2, 6} <= set(got.flatten().tolist())


@pytest.mark.parametrize("boxes_name", BOX_SETS)
@pytest.mark.parametrize("out_size,sr", [(7, 2), (5, 3)])
def test_plain_matches_jax_gather(out_size, sr, boxes_name):
    """float32, the same bilinear weights on the same feature values: only
    the order of the float32 sums differs, so atol 1e-5 on N(0, 1) features.
    Besides random and edge-case boxes, the geometry the CUDA kernel's
    staging finds hardest: RoIs far longer than 2 * out_size * sr feature
    units at their level, RoIs hugging each border, sub-pixel RoIs and
    squares sized for every level."""
    rng = np.random.default_rng(1)
    feats = pyramid(rng, 2, 128, 8)
    boxes = box_set(boxes_name, rng, 2, 24, 128)
    got = t_ra.multilevel_roi_align([torch.from_numpy(f) for f in feats],
                                    torch.from_numpy(boxes), STRIDES, out_size, sr)
    want = j_ra.multilevel_roi_align([jnp.asarray(f) for f in feats], jnp.asarray(boxes),
                                     STRIDES, out_size, sampling_ratio=sr)
    assert got.shape == (2, 24, out_size, out_size, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_plain_matches_pallas_kernel(monkeypatch):
    """The Pallas TPU kernel in interpret mode stages its window tiles in
    bf16, so it is held at its own bf16 tolerance (tests/test_roi_align_pallas.py);
    RoIs stay inside its window (its samples past the window edge-clamp)."""
    from weakcube_tpu.ops import roi_align_pallas as rap
    orig = rap.pl.pallas_call
    monkeypatch.setattr(rap.pl, "pallas_call", lambda *a, **k: orig(*a, interpret=True, **k))
    rng = np.random.default_rng(2)
    feats = [f[0] for f in pyramid(rng, 1, 256, 8)]
    xy = rng.uniform(8, 150, (12, 2))
    wh = rng.uniform(16, 100, (12, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    want = rap.roi_align_pallas_single([jnp.asarray(f) for f in feats], jnp.asarray(boxes),
                                       STRIDES)
    got = t_ra.multilevel_roi_align([torch.from_numpy(f)[None] for f in feats],
                                    torch.from_numpy(boxes)[None], STRIDES)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2, rtol=2e-2)


def test_wrapper_takes_plain_path_on_cpu():
    """CPU tensors run the plain version (bit-identical) and launch nothing."""
    rng = np.random.default_rng(3)
    feats = [torch.from_numpy(f) for f in pyramid(rng, 2, 64, 4)]
    boxes = torch.from_numpy(edge_boxes(rng, 2, 10, 64))
    before = roi_align_cuda.multilevel_roi_align.launches
    got = roi_align_cuda.multilevel_roi_align(feats, boxes, STRIDES)
    assert torch.equal(got, t_ra.multilevel_roi_align(feats, boxes, STRIDES))
    assert roi_align_cuda.multilevel_roi_align.launches == before
    # bf16 levels give a bf16 result, computed in float32
    got16 = roi_align_cuda.multilevel_roi_align([f.bfloat16() for f in feats], boxes, STRIDES)
    assert got16.dtype == torch.bfloat16


def test_wrapper_refuses_what_the_kernel_does_not_take():
    feats = [torch.zeros((1, 64 // s, 64 // s, 4)) for s in STRIDES]
    boxes = torch.zeros((1, 3, 4))
    roi_align_cuda._check(feats, boxes, STRIDES, 7, 2)            # accepted
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        nchw = [f.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1) for f in feats]
        roi_align_cuda._check(nchw, boxes, STRIDES, 7, 2)
    with pytest.raises(TypeError):
        roi_align_cuda._check([f.double() for f in feats], boxes, STRIDES, 7, 2)
    with pytest.raises(ValueError, match="strides"):
        roi_align_cuda._check(feats, boxes, STRIDES[:3], 7, 2)
    with pytest.raises(ValueError, match="output_size"):
        roi_align_cuda._check(feats, boxes, STRIDES, 7, 20)


@pytest.mark.parametrize("limit", ["samples", "level size"])
def test_wrapper_refuses_beyond_the_kernels_limits(limit):
    """The staged window holds (2 * out_size * sr)^2 pixels, so out_size * sr
    stops at MAX_SAMPLES (40); line offsets are 32-bit, so a level holds
    fewer than 2^31 elements. Meta tensors: shapes without memory."""
    feats = [torch.zeros((1, 64 // s, 64 // s, 4)) for s in STRIDES]
    boxes = torch.zeros((1, 3, 4))
    if limit == "samples":
        roi_align_cuda._check(feats, boxes, STRIDES, 8, 5)           # 40: accepted
        with pytest.raises(ValueError, match="output_size"):
            roi_align_cuda._check(feats, boxes, STRIDES, 7, 6)
    else:
        meta = torch.device("meta")
        big = [torch.empty((1, 2 ** 14, 2 ** 14, 8), device=meta)]  # 2^31 elements
        ok = [torch.empty((1, 2 ** 14, 2 ** 14 - 1, 8), device=meta)]
        roi_align_cuda._check(ok, boxes.to(meta), STRIDES[:1], 7, 2)
        with pytest.raises(ValueError, match="32-bit"):
            roi_align_cuda._check(big, boxes.to(meta), STRIDES[:1], 7, 2)
