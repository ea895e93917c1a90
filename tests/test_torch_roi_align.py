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
from torch_roi_boxes import (BOX_SETS, box_set, edge_boxes, elongated_boxes, level_boxes,
                             subpixel_boxes)

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


def test_footprint_counts_the_kernels_staging():
    """roi_align_cuda.footprint, which chip_smoke.py's bounds use: a
    sub-pixel RoI stages and touches 2 x 2 pixels; a RoI 128 feature units
    long stages the 2P = 28 touched columns, not its 129-column run (and its
    3-row compact run); a 14-unit square stages its compact 15 x 15 run; the
    union of touched pixels is counted once however many RoIs share them."""
    feats = [torch.zeros((1, 128 // s, 128 // s, 8)) for s in STRIDES]
    boxes = torch.tensor([[[30.0, 30.0, 30.2, 30.2], [0.0, 40.0, 512.0, 44.0],
                           [4.0, 4.0, 60.0, 60.0], [4.0, 4.0, 60.0, 60.0]]])
    fp = roi_align_cuda.footprint(feats, boxes, STRIDES, 7, 2)
    assert fp["levels"].tolist() == [[2, 2, 2, 2]]
    assert fp["ny"].tolist() == [[2, 3, 15, 15]] and fp["nx"].tolist() == [[2, 28, 15, 15]]
    assert fp["staged_bytes"] == (4 + 3 * 28 + 2 * 225) * 8 * 4
    assert fp["out_bytes"] == 4 * 49 * 8 * 4 and fp["gather_bytes"] == 16 * fp["out_bytes"]
    # the two equal RoIs touch the same 15 x 15 pixels; the long one touches
    # 3 rows x 28 columns
    assert 225 * 32 < fp["touched_bytes"] <= (4 + 84 + 225) * 32


@pytest.mark.parametrize("tile", [16, 8])
def test_footprint_counts_the_gathers_tile_overlaps(tile):
    """footprint's (RoI, tile) pairs, which chip_smoke.py's K1-bwd floor
    uses, against a brute force over the plain version's corners
    (ops/roi_align.py::_corners): a RoI meets every tile of its level that
    the bounding box of its touched pixels meets. Sub-pixel, elongated and
    tile-edge RoIs on the ragged levels of a 200 x 120 canvas (p2 50 x 30)."""
    size_h, size_w = 200, 120
    shapes = [(2, -(-size_h // s), -(-size_w // s), 4) for s in STRIDES]
    feats = [torch.zeros(s) for s in shapes]
    rng = np.random.default_rng(13)
    boxes = np.concatenate([
        np.array([[[30.0, 30.0, 30.2, 30.2],      # sub-pixel
                   [0.0, 40.0, 120.0, 44.0],      # elongated across every p2 tile column
                   [2.0, 0.0, 6.0, 200.0],        # ... and every p2 tile row
                   [62.0, 62.0, 66.5, 66.5],      # lines 15 and 16 of p2: a tile edge
                   [66.5, 2.5, 70.0, 20.0],       # starts on line 16 of p2
                   [100.0, 180.0, 121.0, 201.0],  # the ragged corner
                   [-30.0, -30.0, 150.0, 230.0]]] * 2, np.float32),   # past every border, p3
        elongated_boxes(rng, 2, 10, 120), subpixel_boxes(rng, 2, 6, 120),
        level_boxes(rng, 2, 8, 120)], 1)
    boxes = torch.from_numpy(np.ascontiguousarray(boxes, np.float32))
    fp = roi_align_cuda.footprint(feats, boxes, STRIDES, 7, 2, tile=tile)
    hw = [s[1:3] for s in shapes]
    offs = np.cumsum([0] + [h * w for h, w in hw])
    pix = torch.stack([idx for idx, _ in t_ra._corners(boxes, hw, STRIDES, 7, 2, 2)], -1)
    pix = pix.reshape(2, boxes.shape[1], -1).numpy()
    want = 0
    for b in range(2):
        for r in range(boxes.shape[1]):
            l = int(np.searchsorted(offs, pix[b, r, 0], side="right")) - 1
            h, w = hw[l]
            y, x = np.divmod(pix[b, r] - offs[l], w)
            assert (fp["levels"][b, r] - 2).item() == l
            want += sum(y.min() < ty + tile and y.max() >= ty and x.min() < tx + tile
                        and x.max() >= tx for ty in range(0, h, tile) for tx in range(0, w, tile))
    assert fp["tile_overlaps"] == want
    assert fp["tile_g_bytes"] == want * 49 * 4 * 4
    assert want > boxes.shape[1] * 2   # the long RoIs meet several tiles each
