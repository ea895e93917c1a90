"""weakcube_tpu_torch ops and config against their weakcube_tpu twins.

Inputs are made with numpy from a seed and handed to both packages. Unless
a test says otherwise the tolerance is float32 round-off: atol 1e-5 on
O(1)-O(100) values, where the two frameworks evaluate the same expressions
with their own (equally rounded) elementwise kernels.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weakcube_tpu.config import get_cfg as jax_get_cfg
from weakcube_tpu.models import anchors as j_anchors
from weakcube_tpu.ops import boxes as j_boxes
from weakcube_tpu.ops import cuboids as j_cuboids
from weakcube_tpu.ops import nms as j_nms
from weakcube_tpu.ops import pool as j_pool
from weakcube_tpu.ops import rotations as j_rot
from weakcube_tpu_torch.config import get_cfg as torch_get_cfg
from weakcube_tpu_torch.models import anchors as t_anchors
from weakcube_tpu_torch.ops import boxes as t_boxes
from weakcube_tpu_torch.ops import cuboids as t_cuboids
from weakcube_tpu_torch.ops import nms as t_nms
from weakcube_tpu_torch.ops import pool as t_pool
from weakcube_tpu_torch.ops import rotations as t_rot
from weakcube_tpu_torch.ops import sampling as t_sampling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def close(t, j, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), atol=atol, rtol=rtol)


def close_of_scale(t, j, rel):
    """|t - j| within rel of j's largest magnitude."""
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, atol=rel * np.abs(j).max(), rtol=0)


def random_boxes(rng, shape, size=100.0, min_wh=1.0, max_wh=40.0):
    xy = rng.uniform(-10, size, shape + (2,))
    wh = rng.uniform(min_wh, max_wh, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("name", CONFIGS)
def test_config_loads_as_in_jax(name):
    """Every YAML under configs/ loads into the same tree in both packages."""
    a, b = torch_get_cfg(), jax_get_cfg()
    a.merge_from_file(os.path.join(REPO, "configs", name))
    b.merge_from_file(os.path.join(REPO, "configs", name))
    assert a.dump() == b.dump()


def test_tiny_cfg_matches_graft_entry():
    import __graft_entry__ as g
    from weakcube_tpu_torch.entry import tiny_cfg
    assert tiny_cfg(128, dla=True).dump() == g._tiny_cfg(128, dla=True).dump()


# ----------------------------------------------------------------- boxes
class TestBoxes:
    def test_area_clip_iou(self):
        rng = np.random.default_rng(0)
        a = random_boxes(rng, (2, 7))
        b = random_boxes(rng, (2, 9))
        a[0, 0] = [5, 5, 3, 9]                       # degenerate: zero area
        wh = np.array([[64.0, 48.0], [100.0, 80.0]], np.float32)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        close(t_boxes.area(ta), j_boxes.area(jnp.asarray(a)))
        close(t_boxes.clip_boxes(ta, torch.from_numpy(wh)[:, None]),
              j_boxes.clip_boxes(jnp.asarray(a), jnp.asarray(wh)[:, None]))
        for i in range(2):   # batched torch IoU vs per-image JAX IoU
            close(t_boxes.pairwise_iou(ta, tb)[i],
                  j_boxes.pairwise_iou(jnp.asarray(a[i]), jnp.asarray(b[i])), atol=1e-6)

    def test_apply_deltas_with_clamp(self):
        rng = np.random.default_rng(1)
        boxes = random_boxes(rng, (5, 3))
        deltas = rng.normal(0, 2, (5, 3, 4)).astype(np.float32)
        deltas[0, 0, 2:] = 9.0                        # beyond the log(1000/16) clamp
        for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
            # exp() of deltas up to ~4: 1e-5 relative
            close(t_boxes.apply_deltas(torch.from_numpy(deltas), torch.from_numpy(boxes), w),
                  j_boxes.apply_deltas(jnp.asarray(deltas), jnp.asarray(boxes), w),
                  atol=1e-4, rtol=1e-5)

    def test_box_formats(self):
        b = random_boxes(np.random.default_rng(11), (3, 5))
        for t_fn, j_fn in ((t_boxes.xyxy_to_xywh, j_boxes.xyxy_to_xywh),
                           (t_boxes.xywh_to_xyxy, j_boxes.xywh_to_xyxy)):
            close(t_fn(torch.from_numpy(b)), j_fn(jnp.asarray(b)), atol=0, rtol=0)

    def test_mask_iou(self):
        rng = np.random.default_rng(12)
        a = rng.random((3, 5, 17, 23)) < 0.4
        b = rng.random((3, 5, 17, 23)) < 0.6
        a[1, 2] = b[1, 2] = False                     # empty union: IoU 0
        a[2, 0] = b[2, 0]                             # equal masks: IoU 1
        got = t_boxes.mask_iou(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.float32 and got[1, 2] == 0 and got[2, 0] == 1
        close(got, j_boxes.mask_iou(jnp.asarray(a), jnp.asarray(b)), atol=0, rtol=0)


# ------------------------------------------------------------------- NMS
def greedy_nms(boxes, scores, thr):
    """Sequential greedy NMS in numpy (the textbook definition)."""
    order = np.argsort(-scores, kind="stable")
    keep = np.zeros(len(scores), bool)
    iou = np.asarray(j_boxes.pairwise_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    for i in order:
        if not any(keep[j] and iou[j, i] > thr for j in range(len(scores))):
            keep[i] = True
    return keep


class TestNMS:
    def test_chain_needs_several_passes(self):
        """Each box overlaps its neighbours (IoU 0.43) but not the next but
        one (IoU 0.11): greedy keeps every other box, which the fixed point
        reaches only after one pass per link of the chain."""
        n = 9
        x = np.arange(n, dtype=np.float32) * 4.0
        boxes = np.stack([x, np.zeros(n), x + 10, np.full(n, 10.0)], -1).astype(np.float32)
        scores = np.linspace(1.0, 0.1, n).astype(np.float32)
        want = greedy_nms(boxes, scores, 0.3)
        assert want.tolist() == [i % 2 == 0 for i in range(n)]
        got = t_nms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), 0.3)
        assert got.tolist() == want.tolist()
        assert np.asarray(j_nms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), 0.3)).tolist() \
            == want.tolist()

    def test_batched_padded_matches_per_problem(self):
        """A (B, L, N) batch with ragged valid prefixes equals JAX's nms_mask
        run on each problem alone (exact: same comparisons on the same IoUs)."""
        rng = np.random.default_rng(2)
        B, L, N = 2, 3, 40
        boxes = random_boxes(rng, (B, L, N), size=60.0, min_wh=5.0, max_wh=30.0)
        scores = rng.normal(size=(B, L, N)).astype(np.float32)
        valid = np.arange(N)[None, None] < rng.integers(5, N + 1, (B, L, 1))
        got = t_nms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
                             torch.from_numpy(valid)).numpy()
        for b in range(B):
            for l in range(L):
                k = int(valid[b, l].sum())
                want = np.asarray(j_nms.nms_mask(jnp.asarray(boxes[b, l, :k]),
                                                 jnp.asarray(scores[b, l, :k]), 0.5))
                assert got[b, l, :k].tolist() == want.tolist()
                assert not got[b, l, k:].any()

    def test_batched_nms_and_topk(self):
        rng = np.random.default_rng(3)
        B, N, k = 2, 50, 12
        boxes = random_boxes(rng, (B, N), size=50.0, min_wh=5.0, max_wh=30.0)
        scores = rng.uniform(size=(B, N)).astype(np.float32)
        cls = rng.integers(0, 3, (B, N))
        valid = scores > 0.2
        keep = t_nms.batched_nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                                      torch.from_numpy(cls), 0.5, torch.from_numpy(valid))
        out = t_nms.topk_after_nms(torch.from_numpy(boxes), torch.from_numpy(scores), keep, k)
        for b in range(B):
            jk = j_nms.batched_nms_mask(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                                        jnp.asarray(cls[b]), 0.5, jnp.asarray(valid[b]))
            assert keep[b].tolist() == np.asarray(jk).tolist()
            jout = j_nms.topk_after_nms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), jk, k)
            for t, j in zip(out, jout):
                close(t[b], j, atol=0)

    def test_topk_pads_when_k_exceeds_n(self):
        boxes = np.array([[0, 0, 4, 4], [1, 1, 5, 5]], np.float32)
        scores = np.array([0.3, 0.9], np.float32)
        keep = np.array([True, True])
        out = t_nms.topk_after_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                   torch.from_numpy(keep), 4)
        jout = j_nms.topk_after_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.asarray(keep), 4)
        for t, j in zip(out, jout):
            close(t, j, atol=0)


# ------------------------------------------------------------- rotations
class TestRotations:
    def test_6d_quaternion_euler_axis_angle(self):
        rng = np.random.default_rng(4)
        d6 = rng.normal(size=(3, 5, 6)).astype(np.float32)
        q = rng.normal(size=(7, 4)).astype(np.float32)
        e = rng.uniform(-3, 3, (7, 3)).astype(np.float32)
        aa = rng.normal(size=(7, 3)).astype(np.float32)
        aa[0] = 0.0                                    # identity at angle 0
        close(t_rot.rotation_6d_to_matrix(torch.from_numpy(d6)),
              j_rot.rotation_6d_to_matrix(jnp.asarray(d6)))
        close(t_rot.quaternion_to_matrix(torch.from_numpy(q)),
              j_rot.quaternion_to_matrix(jnp.asarray(q)))
        for conv in ("XYZ", "ZYX"):
            close(t_rot.euler_angles_to_matrix(torch.from_numpy(e), conv),
                  j_rot.euler_angles_to_matrix(jnp.asarray(e), conv))
        close(t_rot.axis_angle_to_matrix(torch.from_numpy(aa)),
              j_rot.axis_angle_to_matrix(jnp.asarray(aa)))

    def test_matrix_to_6d_and_quaternion_f64(self):
        """float64 at 1e-12: 64 random rotations; 180 degrees about x, y, z
        and the identity (each picks another candidate); tied keys (w = z
        at 90 degrees about z, x = y at 180 about (1, 1, 0), all four at 120
        about (1, 1, 1)), where both take the first; the round trip through
        quaternion_to_matrix."""
        q = np.random.default_rng(13).normal(size=(64, 4))
        R = t_rot.quaternion_to_matrix(torch.from_numpy(q)).numpy()
        special = np.array([np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                            np.diag([-1.0, -1, 1]), np.eye(3),
                            [[0.0, -1, 0], [1, 0, 0], [0, 0, 1]],
                            [[0.0, 1, 0], [1, 0, 0], [0, 0, -1]],
                            [[0.0, 0, 1], [1, 0, 0], [0, 1, 0]]])
        R = np.concatenate([R, special])
        with jax.enable_x64():
            jR = jnp.asarray(R)
            j6, jq = jax.jit(lambda r: (j_rot.matrix_to_rotation_6d(r),
                                        j_rot.matrix_to_quaternion(r)))(jR)
            assert jq.dtype == jnp.float64
        tR = torch.from_numpy(R)
        t6, tq = t_rot.matrix_to_rotation_6d(tR), t_rot.matrix_to_quaternion(tR)
        assert tq.dtype == torch.float64
        close(t6, j6, atol=0, rtol=0)
        close(tq, jq, atol=1e-12, rtol=0)
        # the branch each special rotation takes: its largest component
        assert np.abs(tq.numpy()[64:]).argmax(-1).tolist() == [1, 2, 3, 0, 0, 1, 0]
        assert (tq[:, 0] >= 0).all()
        close(t_rot.quaternion_to_matrix(tq), R, atol=1e-12, rtol=0)
        close(t_rot.rotation_6d_to_matrix(t6), R, atol=1e-12, rtol=0)
        flipped = t_rot.standardize_quaternion(-tq)
        close(flipped[tq[:, 0] > 0], tq[tq[:, 0] > 0].numpy(), atol=0, rtol=0)


# --------------------------------------------------------------- cuboids
class TestCuboids:
    def test_allocentric_backproject_cubes(self):
        rng = np.random.default_rng(5)
        B, S = 2, 6
        K = np.tile(np.array([[300.0, 0, 64], [0, 310.0, 48], [0, 0, 1]], np.float32),
                    (B, 1, 1))
        R = np.array(j_rot.rotation_6d_to_matrix(
            jnp.asarray(rng.normal(size=(B, S, 6)).astype(np.float32))))
        u = rng.uniform(0, 128, (B, S)).astype(np.float32)
        v = rng.uniform(0, 96, (B, S)).astype(np.float32)
        u[0, 0], v[0, 0] = 64.0, 48.0                 # on the optical axis
        z = rng.uniform(1, 20, (B, S)).astype(np.float32)
        dims = rng.uniform(0.2, 3, (B, S, 3)).astype(np.float32)
        tK, jK = torch.from_numpy(K)[:, None], jnp.asarray(K)[:, None]
        Rt = t_cuboids.R_from_allocentric(tK, torch.from_numpy(R), torch.from_numpy(u),
                                          torch.from_numpy(v))
        Rj = j_cuboids.R_from_allocentric(jK, jnp.asarray(R), jnp.asarray(u), jnp.asarray(v))
        close(Rt, Rj)
        uv = np.stack([u, v], -1)
        ct = t_cuboids.backproject(torch.from_numpy(uv), torch.from_numpy(z), tK)
        cj = j_cuboids.backproject(jnp.asarray(uv), jnp.asarray(z), jK)
        close(ct, cj, atol=1e-4)                      # metres up to ~10
        close(t_cuboids.Cubes.from_parts(ct, torch.from_numpy(dims), Rt).tensor,
              j_cuboids.Cubes.from_parts(cj, jnp.asarray(dims), Rj).tensor, atol=1e-4)
        x = rng.normal(size=(B, S, 3)).astype(np.float32)
        close(t_cuboids.scaled_sigmoid(torch.from_numpy(x), torch.from_numpy(dims),
                                       torch.from_numpy(2 * dims)),
              j_cuboids.scaled_sigmoid(jnp.asarray(x), jnp.asarray(dims), jnp.asarray(2 * dims)))

    def test_convert_3d_box_to_2d_f64(self):
        """float64 at 1e-10 of scale: cubes in front of, partly behind and
        fully behind the camera, XYWH on and off, with and without
        clipw / cliph; the behind flags equal."""
        rng = np.random.default_rng(14)
        n = 24
        box = np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(2, 20, (n, 1)),
                              rng.uniform(0.3, 3, (n, 3))], -1)
        box[8:16, 2] = rng.uniform(-0.5, 1.0, 8)      # straddling z = min_z
        box[8:16, 3:] = rng.uniform(2.0, 4.0, (8, 3))
        box[16:, 2] = rng.uniform(-20, -3, 8)         # fully behind
        R = t_rot.quaternion_to_matrix(torch.from_numpy(rng.normal(size=(n, 4)))).numpy()
        K = np.array([[500.0, 0, 320], [0, 510.0, 240], [0, 0, 1]])
        cases = [dict(clipw=640.0, cliph=480.0, XYWH=False), dict(clipw=640.0, cliph=480.0),
                 dict(XYWH=False), dict()]
        with jax.enable_x64():
            j_out, j_verts = jax.jit(lambda *a: (
                [j_cuboids.convert_3d_box_to_2d(*a, **kw) for kw in cases],
                j_cuboids.get_cuboid_verts(*a)))(jnp.asarray(K), jnp.asarray(box), jnp.asarray(R))
        tK, tb, tR = torch.from_numpy(K), torch.from_numpy(box), torch.from_numpy(R)
        for kw, (jb, jbehind, jfully) in zip(cases, j_out):
            b, behind, fully = t_cuboids.convert_3d_box_to_2d(tK, tb, tR, **kw)
            assert b.dtype == torch.float64
            close_of_scale(b, jb, 1e-10)
            close(behind, jbehind, atol=0, rtol=0)
            close(fully, jfully, atol=0, rtol=0)
        assert behind[:8].sum() == 0 and 0 < behind[8:16].sum() and fully[16:].all()
        assert not fully[:16].any()
        for t, j in zip(t_cuboids.get_cuboid_verts(tK, tb, tR), j_verts):
            close_of_scale(t, j, 1e-10)

    def test_R_to_allocentric_f64(self):
        """float64 at 1e-12 on 32 poses at 32 pixels, and R_from_allocentric
        its inverse; the virtual scale on tests/test_cuboids.py's values."""
        rng = np.random.default_rng(15)
        R = t_rot.quaternion_to_matrix(torch.from_numpy(rng.normal(size=(32, 4)))).numpy()
        K = np.tile(np.array([[500.0, 0, 320], [0, 510.0, 240], [0, 0, 1]]), (32, 1, 1))
        u, v = rng.uniform(0, 640, 32), rng.uniform(0, 480, 32)
        u[0], v[0] = 320.0, 240.0                     # on the optical axis: M = I
        with jax.enable_x64():
            jR = jax.jit(j_cuboids.R_to_allocentric)(jnp.asarray(K), jnp.asarray(R),
                                                     jnp.asarray(u), jnp.asarray(v))
        args = [torch.from_numpy(x) for x in (K, R, u, v)]
        tR = t_cuboids.R_to_allocentric(*args)
        close(tR, jR, atol=1e-12, rtol=0)
        close(tR[0], R[0], atol=0, rtol=0)
        back = t_cuboids.R_from_allocentric(args[0], tR, args[2], args[3])
        close(back, R, atol=1e-12, rtol=0)
        values = (512.0, 512.0, 500.0, 480.0)
        assert t_cuboids.compute_virtual_scale_from_focal_spaces(*values) == \
            float(j_cuboids.compute_virtual_scale_from_focal_spaces(*values))


# -------------------------------------------------------------- sampling
def test_uniform_topk_mask():
    """Random draws differ between the frameworks, so the properties: rows
    of 0, 3 and 40 valid items with k = 20 get min(k, valid) picks, all
    valid; one seed gives one mask; over 2000 draws each valid item's count
    is within 5 sigma of 2000 k / n_valid."""
    k, n, draws = 20, 64, 2000
    valid = torch.zeros((3, n), dtype=torch.bool)
    valid[1, [5, 30, 63]] = True
    valid[2, torch.randperm(n, generator=torch.Generator().manual_seed(0))[:40]] = True
    masks = [t_sampling.uniform_topk_mask(torch.Generator().manual_seed(3), valid, k)
             for _ in range(2)]
    assert torch.equal(masks[0], masks[1])
    many = t_sampling.uniform_topk_mask(torch.Generator().manual_seed(4),
                                        valid.expand(draws, 3, n), k)
    n_valid = valid.sum(-1)
    assert not (many & ~valid).any()
    assert torch.equal(many.sum(-1), torch.minimum(n_valid, torch.tensor(k)).expand(draws, 3))
    counts = many.sum(0).double()
    for row in (1, 2):
        p = k / n_valid[row].item() if n_valid[row] > k else 1.0
        sigma = (draws * p * (1 - p)) ** 0.5
        got = counts[row][valid[row]]
        assert (got - draws * p).abs().max() <= 5 * sigma, (row, got)


# ---------------------------------------------------------- anchors, pool
def test_pyramid_anchors():
    shapes, strides = [(32, 24), (16, 12), (8, 6)], [4, 8, 16]
    for sizes, offset in (([[32], [64], [128]], 0.0), ([[32, 48]], 0.5)):
        t = t_anchors.pyramid_anchors(shapes, strides, sizes, [[0.5, 1.0, 2.0]], offset)
        j = j_anchors.pyramid_anchors(shapes, strides, sizes, [[0.5, 1.0, 2.0]], offset)
        for a, b in zip(t, j):
            close(a, b, atol=0)


@pytest.mark.parametrize("hw", [(16, 16), (17, 13)])
def test_pool_ops(hw):
    """VALID max pool drops trailing rows/cols; subsample2 keeps ceil(H/2)."""
    x = np.random.default_rng(6).normal(size=(2,) + hw + (5,)).astype(np.float32)
    for s in (1, 2):
        close(t_pool.max_pool_nonoverlap(torch.from_numpy(x), s),
              j_pool.max_pool_nonoverlap(jnp.asarray(x), s), atol=0)
    close(t_pool.subsample2(torch.from_numpy(x)), j_pool.subsample2(jnp.asarray(x)), atol=0)
