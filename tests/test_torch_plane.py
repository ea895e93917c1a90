"""Ground-plane fits of weakcube_tpu_torch against weakcube_tpu.

`ransac_plane` is held to JAX's with JAX's own draws injected (rebuilt
outside the JAX function with jax.random.randint from the same key): the
same winning hypothesis, inliers exactly, the plane within 1e-6.
`ground_normals_from_maps` likewise at B = 2 with the draws of the per-image
split keys. `ground_normal_np` is a numpy copy and must agree exactly. The
statistical cases of tests/test_ground_normal.py::TestHostGroundNormal and
tests/test_weak_losses.py::TestGroundNormals run on the port's own draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weakcube_tpu.models import roi_heads as j_rh
from weakcube_tpu.ops import plane as j_plane
from weakcube_tpu_torch.models import roi_heads as t_rh
from weakcube_tpu_torch.ops import plane as t_plane
from test_ground_normal import _tilted_ground


def jax_draws(key, H, n):
    """The (H, 3) draws JAX's ransac_plane takes from `key`."""
    return np.array(jax.random.randint(key, (H, 3), 0, n, jnp.int32))


def noisy_plane(rng, n=600, n_plane=350, invalid=0.2):
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 2
    normal = rng.normal(size=3)
    normal /= np.linalg.norm(normal)
    on = pts[:n_plane] - np.outer(pts[:n_plane] @ normal - 0.3, normal)
    pts[:n_plane] = on + 0.01 * rng.normal(size=(n_plane, 3))
    valid = rng.random(n) >= invalid
    return pts.astype(np.float32), valid, normal


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_matches_jax_with_injected_draws(seed):
    rng = np.random.default_rng(seed)
    pts, valid, _ = noisy_plane(rng)
    pts[5] = pts[6]                  # a duplicate point: some triples degenerate
    key = jax.random.PRNGKey(seed)
    H = 300
    eq_j, inl_j = j_plane.ransac_plane(key, jnp.asarray(pts), jnp.asarray(valid), 0.05, H)
    eq_t, inl_t = t_plane.ransac_plane(torch.from_numpy(pts), torch.from_numpy(valid), 0.05, H,
                                       draws=torch.from_numpy(jax_draws(key, H, len(pts))))
    np.testing.assert_allclose(eq_t.numpy(), np.asarray(eq_j), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))


def test_ransac_batched_equals_per_cloud():
    """A batch of clouds in one pass gives each cloud's own fit."""
    rng = np.random.default_rng(4)
    clouds = [noisy_plane(rng) for _ in range(3)]
    pts = torch.from_numpy(np.stack([c[0] for c in clouds]))
    valid = torch.from_numpy(np.stack([c[1] for c in clouds]))
    draws = torch.randint(0, pts.shape[1], (3, 200, 3), generator=torch.Generator().manual_seed(0))
    eq, inl = t_plane.ransac_plane(pts, valid, 0.05, 200, draws=draws)
    for b in range(3):
        e1, i1 = t_plane.ransac_plane(pts[b], valid[b], 0.05, 200, draws=draws[b])
        torch.testing.assert_close(eq[b], e1, atol=0, rtol=0)
        assert torch.equal(inl[b], i1)
    # the fit recovers each plane's normal
    for b, (_, _, n) in enumerate(clouds):
        assert abs(float(eq[b, :3].double() @ torch.from_numpy(n))) > 0.999


def test_ransac_first_maximum_and_degenerate_triples():
    """All hypotheses degenerate but one: that one wins; no valid point at
    all: every triple is degenerate and the first hypothesis is returned."""
    pts = torch.tensor([[0.0, 0, 0], [1, 0, 0], [0, 0, 1], [2, 0, 0]])
    draws = torch.tensor([[0, 0, 1], [0, 1, 3], [0, 1, 2], [1, 2, 0]])
    eq, inl = t_plane.ransac_plane(pts, None, 0.05, 4, draws=draws)
    torch.testing.assert_close(eq, torch.tensor([0.0, 1.0, 0.0, 0.0]))  # negated (0,-1,0,0)
    assert inl.all()
    eq, inl = t_plane.ransac_plane(pts, torch.zeros(4, dtype=torch.bool), 0.05, 4, draws=draws)
    assert not inl.any()


def test_up_vector_matches_jax():
    eqs = np.random.default_rng(5).normal(size=(16, 4)).astype(np.float32)
    np.testing.assert_allclose(t_plane.up_vector_from_plane(torch.from_numpy(eqs)).numpy(),
                               np.asarray(j_plane.up_vector_from_plane(jnp.asarray(eqs))),
                               atol=1e-7, rtol=0)


def maps(B=2, H=60, W=80, seed=0):
    """Tilted, noisy ground depth maps with outliers and partial masks."""
    rng = np.random.default_rng(seed)
    zs, ms, Ks = [], [], []
    for b in range(B):
        z, mask, K, _ = _tilted_ground(H, W, f=61.0 + 17 * b, tilt_deg=8.0 + 9 * b)
        z = z + 0.01 * rng.normal(size=z.shape).astype(np.float32) * mask
        out = rng.random(z.shape) < 0.15
        z = np.where(out & mask, rng.uniform(0.5, 20, z.shape), z).astype(np.float32)
        zs.append(z)
        ms.append(mask & (rng.random(z.shape) > 0.1))
        Ks.append(K)
    return np.stack(zs), np.stack(ms), np.stack(Ks)


@pytest.mark.parametrize("use_nth,H", [(5, 200), (3, 120)])
def test_ground_normals_from_maps_matches_jax(use_nth, H):
    """B = 2 on JAX's split keys, JAX's draws injected: the same normals
    (wall flips included) within 1e-6."""
    z, m, K = maps()
    key = jax.random.PRNGKey(7)
    want = np.asarray(j_rh.ground_normals_from_maps(
        key, jnp.asarray(z), jnp.asarray(m), jnp.ones((2,), bool), use_nth=use_nth,
        K=jnp.asarray(K), num_hypotheses=H))
    n = z[:, ::use_nth, ::use_nth][0].size
    draws = np.stack([jax_draws(k, H, n) for k in jax.random.split(key, 2)])
    got = t_rh.ground_normals_from_maps(
        None, torch.from_numpy(z), torch.from_numpy(m), torch.ones(2, dtype=torch.bool),
        use_nth=use_nth, K=torch.from_numpy(K), num_hypotheses=H,
        draws=torch.from_numpy(draws)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_wall_flip_cases():
    """The three orientation fixes in their order (JAX's per-image branch,
    written out in numpy) on normals that take each of them."""
    ns = np.array([[0.1, 0.2, 0.97], [0.9, 0.3, 0.1], [0.2, -0.95, 0.1], [0.6, 0.1, -0.7],
                   [0.0, 1.0, 0.0]], np.float32)
    got = t_plane.wall_flip(torch.from_numpy(ns)).numpy()
    for n, g in zip(ns, got):
        ax, ay, az = np.abs(n)
        w = np.array([n[0], n[2], -n[1]]) if az > ay else n.copy()
        if abs(w[0]) > abs(w[1]):
            w = np.array([-w[2], w[0], w[1]])
        w = -w if w[1] < 0 else w
        np.testing.assert_array_equal(g, w.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_ground_normal_np_matches_jax(seed):
    z, m, K = maps(seed=seed)
    for b in range(2):
        for mask in (m[b], None):
            a, ok_a = j_plane.ground_normal_np(z[b], K[b], mask)
            c, ok_c = t_plane.ground_normal_np(z[b], K[b], mask)
            assert ok_a == ok_c
            np.testing.assert_array_equal(a, c)


class TestHostGroundNormal:
    """tests/test_ground_normal.py::TestHostGroundNormal on the port."""

    def test_recovers_plane(self):
        z, mask, K, n_true = _tilted_ground()
        n, ok = t_plane.ground_normal_np(z, K, mask)
        assert ok and n[1] > 0
        assert abs(float(n @ n_true)) > 0.999, (n, n_true)

    def test_matches_device_ransac(self):
        z, mask, K, _ = _tilted_ground()
        n_host, ok = t_plane.ground_normal_np(z, K, mask)
        assert ok
        n_dev = t_rh.ground_normals_from_maps(
            torch.Generator().manual_seed(0), torch.from_numpy(z[None]),
            torch.from_numpy(mask[None]), torch.ones(1, dtype=torch.bool),
            K=torch.from_numpy(K[None]))[0].numpy()
        cos = abs(float(n_host @ n_dev / max(np.linalg.norm(n_dev), 1e-9)))
        assert cos > 0.995, (n_host, n_dev)

    def test_degenerate_returns_invalid(self):
        z = np.zeros((60, 80), np.float32)
        K = np.array([[50, 0, 40], [0, 50, 30], [0, 0, 1]], np.float32)
        _, ok = t_plane.ground_normal_np(z, K, np.zeros((60, 80), bool))
        assert not ok


def test_recovers_synthetic_ground():
    """tests/test_weak_losses.py::TestGroundNormals on the port: a ground
    plane at y = 1.2 in camera coordinates gives an up-dominant normal."""
    H = W = 120
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    fy = 100.0
    denom = np.maximum(v - H / 2, 1e-3)
    depth = np.where(v > H / 2, fy * 1.2 / denom, 30.0).astype(np.float32)
    K = np.array([[fy, 0, W / 2], [0, fy, H / 2], [0, 0, 1]], np.float32)
    n = t_rh.ground_normals_from_maps(torch.Generator().manual_seed(0),
                                      torch.from_numpy(depth)[None],
                                      torch.from_numpy(v > H / 2)[None],
                                      torch.ones(1, dtype=torch.bool),
                                      K=torch.from_numpy(K)[None])
    assert abs(float(n[0, 1])) > 0.95
