"""The DPT head's align_corners bilinear resize (ops/bilinear_resize_cuda.py)
on the CPU: CPU tensors run F.interpolate as it was, with no kernel launch;
the kernel's plan (source indices and float32 weights, plain Python) gives
F.interpolate's values when written out as a gather and lerp; the vector
width follows C, the dtype, the pointer and the strides; the head calls the
wrapper five times a forward. The kernel itself is held to ATen's CUDA
result bit for bit on the card in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from weakcube_tpu_torch.data.pseudo_gt import depth_anything_v2 as dav2
from weakcube_tpu_torch.ops import bilinear_resize_cuda as br

# (C, in, out) of the head's five resizes at ViT-L, 518 px (square sizes)
HEAD = [(256, 19, 37), (256, 37, 74), (256, 74, 148), (256, 148, 296), (128, 296, 518)]
# (H_in, W_in) -> (H_out, W_out): one output row, one input row, equal
# sizes (the head returns early there; the kernel would run), odd ratios,
# a downscale and a single pixel
EDGES = {"H_out 1": ((9, 11), (1, 40)), "H_in 1": ((1, 11), (30, 7)),
         "equal": ((9, 9), (9, 9)), "odd ratios": ((13, 17), (50, 33)),
         "down": ((50, 33), (13, 17)), "one pixel": ((1, 1), (5, 5)),
         "W_out 1": ((6, 6), (7, 1))}


def lerp_from_taps(x: torch.Tensor, size) -> torch.Tensor:
    """The kernel's plan written out on the CPU in float32: gather the four
    taps that `taps` names and blend them in ATen's order,
    lh0 * (lw0 * a + lw1 * b) + lh1 * (lw0 * c + lw1 * d)."""
    hi0, hi1, lh0, lh1 = (torch.from_numpy(t) for t in br.taps(x.shape[2], size[0]))
    wi0, wi1, lw0, lw1 = (torch.from_numpy(t) for t in br.taps(x.shape[3], size[1]))
    r0, r1 = x[:, :, hi0], x[:, :, hi1]
    lw0, lw1, lh0, lh1 = lw0[None, None, None], lw1[None, None, None], \
        lh0[None, None, :, None], lh1[None, None, :, None]
    top = lw0 * r0[..., wi0] + lw1 * r0[..., wi1]
    bot = lw0 * r1[..., wi0] + lw1 * r1[..., wi1]
    return lh0 * top + lh1 * bot


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_tensor_runs_f_interpolate_and_launches_nothing(dtype, layout):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 16, 13, 17))
                         .astype(np.float32)).to(getattr(torch, dtype))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    before = br.bilinear_resize.launches
    got = br.bilinear_resize(x, (50, 33))
    want = F.interpolate(x, size=(50, 33), mode="bilinear", align_corners=True)
    assert br.bilinear_resize.launches == before
    assert got.dtype == want.dtype and got.stride() == want.stride()
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", [f"head {i}" for i in range(len(HEAD))] + sorted(EDGES))
def test_taps_written_out_match_f_interpolate(case):
    """The plan along each axis at the head's five sizes and at the edges,
    as a float32 gather and lerp, against F.interpolate within float32
    rounding (the CPU's own order differs)."""
    if case.startswith("head"):
        _, n_in, n_out = HEAD[int(case.split()[1])]
        hw_in, hw_out = (n_in, n_in), (n_out, n_out)
    else:
        hw_in, hw_out = EDGES[case]
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 3, *hw_in)).astype(np.float32))
    want = F.interpolate(x, size=hw_out, mode="bilinear", align_corners=True)
    got = lerp_from_taps(x, hw_out)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-6)


def test_taps_by_hand():
    """3 -> 5: scale 0.5, sources 0, 0.5, 1, 1.5, 2; the last index's
    neighbour is itself. 4 -> 1: scale 0, one tap of index 0."""
    i0, i1, l0, l1 = br.taps(3, 5)
    assert i0.tolist() == [0, 0, 1, 1, 2] and i1.tolist() == [1, 1, 2, 2, 2]
    assert l1.tolist() == [0.0, 0.5, 0.0, 0.5, 0.0] and l0.tolist() == [1.0, 0.5, 1.0, 0.5, 1.0]
    assert all(t.dtype == np.float32 for t in (l0, l1))
    assert br.scale(4, 1) == 0 and br.taps(4, 1)[0].tolist() == [0]
    assert br.scale(296, 518) == np.float32(295) / np.float32(517)


@pytest.mark.parametrize("C", [256, 128, 64, 32, 3])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_vector_width_follows_c_and_dtype(dtype, C):
    """16 bytes a thread (8 bf16 or 4 float32 channels) where C divides
    into them; C = 3 takes one channel a thread."""
    x = torch.zeros((2, C, 5, 7), dtype=getattr(torch, dtype)).contiguous(
        memory_format=torch.channels_last)
    want = 1 if C == 3 else 16 // x.element_size()
    assert br.vec_width(x) == want


def test_vector_width_falls_to_the_pointer_and_strides():
    bf, f32 = torch.bfloat16, torch.float32
    dense = lambda C, dt: torch.zeros((2, 5, 7, C), dtype=dt).permute(0, 3, 1, 2)  # noqa: E731
    assert br.vec_width(dense(6, bf)) == 2 and br.vec_width(dense(12, bf)) == 4
    assert br.vec_width(dense(6, f32)) == 2 and br.vec_width(dense(12, f32)) == 4
    # a view one element into its storage
    flat = torch.zeros(2 * 5 * 7 * 64 + 2, dtype=bf)
    assert br.vec_width(flat[1:-1].view(2, 5, 7, 64).permute(0, 3, 1, 2)) == 1
    assert br.vec_width(flat[2:].view(2, 5, 7, 64).permute(0, 3, 1, 2)) == 2
    # 64 channels of pixels 70 wide
    wide = torch.zeros((2, 5, 7, 70), dtype=bf)
    assert br.vec_width(wide[..., :64].permute(0, 3, 1, 2)) == 2
    # the stride of a dimension of length 1 is never used
    one = torch.zeros((1, 5, 7, 64), dtype=bf).as_strided((1, 64, 5, 7), (3, 1, 448, 64))
    assert br.vec_width(one) == 8


def test_other_devices_are_refused_without_a_launch():
    before = br.bilinear_resize.launches
    with pytest.raises(ValueError, match="CPU or CUDA"):
        br.bilinear_resize(torch.zeros((1, 8, 4, 4), device="meta"), (8, 8))
    x = torch.zeros((1, 8, 4, 4)).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="one CUDA device"):
        br.launch(x, torch.empty((1, 8, 8, 8)).contiguous(memory_format=torch.channels_last))
    assert br.bilinear_resize.launches == before


def test_head_resizes_through_the_wrapper_five_times(monkeypatch):
    """A ViT-S forward at 56 px on the CPU: the head's four fusion blocks
    and its output go through `bilinear_resize` (2 -> 4 -> 8 -> 16 -> 32
    -> 56), and the depth is the bits of the forward through F.interpolate."""
    model = dav2.init_random_(dav2.DepthAnythingV2("vits", input_size=56)).eval()
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 56, 56, 3)).astype(np.float32))
    sizes = []

    def counted(t, size):
        sizes.append((tuple(t.shape[2:]), tuple(size)))
        return br.bilinear_resize(t, size)
    monkeypatch.setattr(dav2, "bilinear_resize", counted)
    with torch.inference_mode():
        got = model(x)
    assert [s[1] for s in sizes] == [(4, 4), (8, 8), (16, 16), (32, 32), (56, 56)], sizes
    monkeypatch.setattr(dav2, "bilinear_resize", lambda t, size: F.interpolate(
        t, size=tuple(size), mode="bilinear", align_corners=True))
    with torch.inference_mode():
        want = model(x)
    assert torch.equal(got, want)
