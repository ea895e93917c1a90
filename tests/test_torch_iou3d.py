"""Exact 3D IoU of weakcube_tpu_torch against weakcube_tpu: pairwise_iou3d,
matched_iou3d and box_volume on random rotated boxes (identical, contained,
touching, disjoint and overlapping pairs) within 1e-5 in float32, the box
planes, and the cases of tests/test_iou3d.py on the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as SR

from weakcube_tpu.ops import cuboids as j_cub
from weakcube_tpu.ops import iou3d as j_iou
from weakcube_tpu_torch.ops import cuboids as t_cub
from weakcube_tpu_torch.ops import iou3d as t_iou
from test_iou3d import ref_intersection_volume


def corners(center, whl, R=None):
    """(8, 3) corners by the port's cuboids (held to JAX's elsewhere)."""
    box = torch.from_numpy(np.concatenate([center, whl]).astype(np.float32))
    Rm = torch.eye(3) if R is None else torch.from_numpy(R.astype(np.float32))
    return t_cub.get_cuboid_verts_3d(box, Rm)


def random_pairs(rng, n):
    """n pairs: a quarter identical, then contained, touching (face to face
    along a box axis), disjoint, and random overlaps."""
    c1, c2 = [], []
    for i in range(n):
        ctr, whl, R = rng.uniform(-1, 1, 3), rng.uniform(0.3, 2, 3), SR.random(rng=rng).as_matrix()
        a = corners(ctr, whl, R)
        kind = i % 5
        if kind == 0:
            b = a.clone()
        elif kind == 1:
            b = corners(ctr, whl * rng.uniform(0.3, 0.9, 3), R)
        elif kind == 2:
            shift = np.zeros(3)
            shift[i % 3] = whl[[2, 1, 0][i % 3]]          # corners' x, y, z extents: l, h, w
            b = corners(ctr + R @ shift, whl, R)
        elif kind == 3:
            b = corners(ctr + 10, whl, R)
        else:
            b = corners(ctr + rng.normal(0, 0.4, 3), rng.uniform(0.3, 2, 3),
                        SR.random(rng=rng).as_matrix())
        c1.append(a)
        c2.append(b)
    return torch.stack(c1), torch.stack(c2)


@pytest.mark.parametrize("seed", [0, 1])
def test_matched_and_pairwise_match_jax(seed):
    c1, c2 = random_pairs(np.random.default_rng(seed), 60)
    j1, j2 = jnp.asarray(c1.numpy()), jnp.asarray(c2.numpy())
    got = t_iou.matched_iou3d(c1, c2)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_iou.matched_iou3d(j1, j2)),
                               atol=1e-5, rtol=0)
    inter, iou = t_iou.pairwise_iou3d(c1[:24], c2[:20])
    j_inter, j_iou_ = j_iou.pairwise_iou3d(j1[:24], j2[:20])
    np.testing.assert_allclose(iou.numpy(), np.asarray(j_iou_), atol=1e-5, rtol=0)
    np.testing.assert_allclose(inter.numpy(), np.asarray(j_inter), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_iou.box_volume(c1).numpy(), np.asarray(j_iou.box_volume(j1)),
                               atol=0, rtol=1e-6)
    # identical pairs are 1, disjoint ones 0. Face-to-face touching pairs
    # are not 0 in either package: the shared face is kept in one pass and
    # cut in the other, and its lone fan adds the volume of the pyramid
    # from the origin to it (ROADMAP.md, Queue C)
    g = got.numpy()
    np.testing.assert_allclose(g[0::5], 1.0, atol=1e-5)
    np.testing.assert_allclose(g[3::5], 0.0, atol=0)


def test_box_planes_match_jax():
    c1, _ = random_pairs(np.random.default_rng(3), 10)
    for c in c1:
        pj, nj = j_iou.box_planes(jnp.asarray(c.numpy()))
        pt, nt = t_iou.box_planes(c)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
        np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-6)


def test_corner_order_matches_jax():
    rng = np.random.default_rng(4)
    box = np.concatenate([rng.uniform(-1, 1, 3), rng.uniform(0.3, 2, 3)]).astype(np.float32)
    R = SR.random(rng=rng).as_matrix().astype(np.float32)
    np.testing.assert_allclose(corners(box[:3], box[3:], R).numpy(),
                               np.asarray(j_cub.get_cuboid_verts_3d(jnp.asarray(box),
                                                                    jnp.asarray(R))),
                               atol=1e-6)


class TestIoU3D:
    """tests/test_iou3d.py on the port."""

    def test_identical(self):
        c = corners(np.array([0.0, 0, 5]), np.array([2.0, 3, 4]))
        _, iou = t_iou.pairwise_iou3d(c[None], c[None])
        np.testing.assert_allclose(float(iou[0, 0]), 1.0, atol=1e-4)

    def test_axis_aligned_partial(self):
        c1 = corners(np.array([0.0, 0, 0]), np.array([2.0, 2, 2]))
        c2 = corners(np.array([1.0, 0, 0]), np.array([2.0, 2, 2]))
        inter, iou = t_iou.pairwise_iou3d(c1[None], c2[None])
        np.testing.assert_allclose(float(inter[0, 0]), 4.0, atol=1e-4)
        np.testing.assert_allclose(float(iou[0, 0]), 4.0 / 12.0, atol=1e-4)

    def test_disjoint(self):
        c1 = corners(np.array([0.0, 0, 0]), np.array([1.0, 1, 1]))
        c2 = corners(np.array([5.0, 0, 0]), np.array([1.0, 1, 1]))
        _, iou = t_iou.pairwise_iou3d(c1[None], c2[None])
        np.testing.assert_allclose(float(iou[0, 0]), 0.0, atol=1e-6)

    def test_contained(self):
        c1 = corners(np.array([0.0, 0, 0]), np.array([4.0, 4, 4]))
        c2 = corners(np.array([0.0, 0, 0]), np.array([2.0, 2, 2]))
        inter, iou = t_iou.pairwise_iou3d(c1[None], c2[None])
        np.testing.assert_allclose(float(inter[0, 0]), 8.0, atol=1e-3)
        np.testing.assert_allclose(float(iou[0, 0]), 8.0 / 64.0, atol=1e-4)

    def test_rotated_45_self_overlap(self):
        c1 = corners(np.array([0.0, 0, 0]), np.array([1.0, 1, 1]))
        R = SR.from_euler("y", 45, degrees=True).as_matrix()
        c2 = corners(np.array([0.0, 0, 0]), np.array([1.0, 1, 1]), R)
        inter, _ = t_iou.pairwise_iou3d(c1[None], c2[None])
        np.testing.assert_allclose(float(inter[0, 0]), 2 * (np.sqrt(2) - 1), atol=1e-3)

    def test_random_vs_scipy(self):
        rng = np.random.default_rng(11)
        n_checked = 0
        for _ in range(12):
            c1 = corners(rng.uniform(-0.5, 0.5, 3), rng.uniform(0.8, 2.0, 3),
                         SR.random(rng=rng).as_matrix())
            c2 = corners(rng.uniform(-0.5, 0.5, 3), rng.uniform(0.8, 2.0, 3),
                         SR.random(rng=rng).as_matrix())
            ref = ref_intersection_volume(c1.numpy(), c2.numpy())
            if ref is None:
                continue
            inter, _ = t_iou.pairwise_iou3d(c1[None], c2[None])
            np.testing.assert_allclose(float(inter[0, 0]), ref, rtol=2e-3, atol=1e-4)
            n_checked += 1
        assert n_checked >= 5

    def test_matched_matches_pairwise_diag(self):
        c1, c2 = random_pairs(np.random.default_rng(3), 8)
        _, full = t_iou.pairwise_iou3d(c1, c2)
        np.testing.assert_allclose(t_iou.matched_iou3d(c1, c2).numpy(),
                                   np.diag(full.numpy()), atol=1e-5)

    def test_volume(self):
        c = corners(np.array([1.0, -2, 3]), np.array([2.0, 3, 4]),
                    SR.from_euler("xz", [20, 50], degrees=True).as_matrix())
        np.testing.assert_allclose(float(t_iou.box_volume(c)), 24.0, atol=1e-3)

    def test_degenerate_box_gives_zero(self):
        c1 = corners(np.array([0.0, 0, 0]), np.array([1.0, 1, 1]))
        c2 = corners(np.array([0.0, 0, 0]), np.array([1.0, 0.0, 1]))
        assert float(t_iou.matched_iou3d(c1[None], c2[None])[0]) == 0.0
