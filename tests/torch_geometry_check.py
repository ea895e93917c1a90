"""The port's RANSAC ground plane and exact IoU3D on the card against the same
functions on the CPU (no JAX): used by tests/test_torch_cuda.py (small) and
chip_smoke.py (the training step's size: 25 images, 1000 hypotheses, 25 x 128
cube pairs).

IoU3D: the same float32 corners on both devices, atol 1e-5.
RANSAC: a tilted, noisy ground plane with outliers per image and the same
injected draws on both devices. The distances are float32 sums taken in
other orders on the two devices, so a point within rounding of the 0.05 m
threshold may count on one and not the other: the winner's inlier count
must agree within 0.1% of the valid points; where both pick the same
hypothesis the planes agree within 1e-5, else |cos| > 0.9999.
"""
import numpy as np
import torch

from weakcube_tpu_torch.ops import cuboids, iou3d, plane


def tilted_ground(H=240, W=320, f=200.0, tilt_deg=12.0):
    """Depth map of a ground plane tilted about camera x, its mask, K and
    the plane normal (tests/test_ground_normal.py::_tilted_ground)."""
    t = np.deg2rad(tilt_deg)
    n = np.array([0.0, np.cos(t), -np.sin(t)], np.float32)
    d = 1.5
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    rx = (u - W / 2) / f
    ry = (v - H / 2) / f
    denom = n[0] * rx + n[1] * ry + n[2]
    with np.errstate(divide="ignore"):
        z = d / denom
    mask = (denom > 1e-3) & (z > 0.5) & (z < 50)
    z = np.where(mask, z, 0.0).astype(np.float32)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return z, mask, K, n


def ground_clouds(B, H, W, seed=0):
    """B tilted ground maps with 1 cm noise and 15% outliers, subsampled by
    5 and backprojected as ground_normals_from_maps does: points (B, N, 3),
    valid (B, N), true normals (B, 3)."""
    rng = np.random.default_rng(seed)
    pts, valid, normals = [], [], []
    for b in range(B):
        z, mask, K, n = tilted_ground(H, W, f=float(rng.uniform(300, 600)),
                                      tilt_deg=float(rng.uniform(2, 20)))
        z = z + 0.01 * rng.normal(size=z.shape).astype(np.float32) * mask
        out = rng.random(z.shape) < 0.15
        z = np.where(out & mask, rng.uniform(0.5, 20, z.shape), z).astype(np.float32)
        zs, ms = z[::5, ::5], mask[::5, ::5]
        h, w = zs.shape
        u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        fx, fy = K[0, 0] // 5, K[1, 1] // 5
        pts.append(np.stack([(u - w / 2) * zs / fx, (v - h / 2) * zs / fy, zs], -1).reshape(-1, 3))
        valid.append(ms.reshape(-1))
        normals.append(n)
    return (torch.from_numpy(np.stack(pts)), torch.from_numpy(np.stack(valid)),
            np.stack(normals))


def _winner(eq, pts, draws, valid):
    """Index of the hypothesis whose plane `eq` is (the nearest normal among
    the hypotheses rebuilt on the CPU in float64)."""
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    idx = order[draws.long() % max(int(valid.sum()), 1)]
    tri = pts.double()[idx]
    normal = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)
    normal = normal / torch.linalg.vector_norm(normal, dim=-1, keepdim=True).clamp(min=1e-12)
    return int(torch.argmin(torch.linalg.vector_norm(normal + eq[:3].double(), dim=-1)))


def ransac_card_vs_cpu(dev, B, H_img=480, W_img=640, hypotheses=1000, seed=0):
    """ransac_plane on the card and on the CPU with the same injected draws.
    Returns a report dict; raises AssertionError on a disagreement."""
    pts, valid, true_n = ground_clouds(B, H_img, W_img, seed)
    draws = torch.randint(0, pts.shape[1], (B, hypotheses, 3),
                          generator=torch.Generator().manual_seed(seed))
    eq_c, inl_c = plane.ransac_plane(pts, valid, 0.05, hypotheses, draws=draws)
    eq_g, inl_g = plane.ransac_plane(pts.to(dev), valid.to(dev), 0.05, hypotheses,
                                     draws=draws.to(dev))
    eq_g, inl_g = eq_g.cpu(), inl_g.cpu()
    n_valid = valid.sum(-1)
    count_diff = (inl_g.sum(-1) - inl_c.sum(-1)).abs()
    assert bool((count_diff <= 1e-3 * n_valid).all()), \
        f"inlier counts differ by {count_diff.tolist()} of {n_valid.tolist()} valid points"
    same, worst_same, worst_cos = 0, 0.0, 1.0
    for b in range(B):
        wc = _winner(eq_c[b], pts[b], draws[b], valid[b])
        wg = _winner(eq_g[b], pts[b], draws[b], valid[b])
        if wc == wg:
            same += 1
            err = float((eq_g[b] - eq_c[b]).abs().max())
            worst_same = max(worst_same, err)
            assert err <= 1e-5, f"image {b}: hypothesis {wc} on both, planes differ by {err:.3e}"
        else:
            cos = abs(float(eq_g[b, :3].double() @ eq_c[b, :3].double()))
            worst_cos = min(worst_cos, cos)
            assert cos > 0.9999, f"image {b}: hypotheses {wg} (card) and {wc} (CPU), |cos| {cos}"
    fit_cos = np.abs(np.einsum("bi,bi->b", eq_g[:, :3].double().numpy(), true_n))
    return {"images": B, "points": int(pts.shape[1]), "same_winner": same,
            "max_count_diff": int(count_diff.max()), "worst_same_err": worst_same,
            "worst_cos_other": worst_cos, "min_cos_to_truth": float(fit_cos.min())}


def _rotations(rng, n):
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


def cube_pairs(n, seed=0):
    """n aligned pairs of (8, 3) float32 corners: identical, contained,
    face-to-face touching, disjoint and random overlapping pairs in turn."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-2, 2, (n, 3)).astype(np.float32) + np.float32([0, 0, 6])
    whl = rng.uniform(0.3, 2, (n, 3)).astype(np.float32)
    R = _rotations(rng, n)
    kind = np.arange(n) % 5
    ctr2, whl2, R2 = ctr.copy(), whl.copy(), R.copy()
    whl2[kind == 1] *= rng.uniform(0.3, 0.9, (int((kind == 1).sum()), 3)).astype(np.float32)
    axis = np.arange(n) % 3
    ext = whl[np.arange(n), 2 - axis]                      # the corners' x, y, z extents: l, h, w
    touch = kind == 2
    ctr2[touch] += np.einsum("nij,nj->ni", R[touch], np.eye(3, dtype=np.float32)[axis[touch]]
                             * ext[touch, None])
    ctr2[kind == 3] += 10
    over = kind == 4
    ctr2[over] += rng.normal(0, 0.4, (int(over.sum()), 3)).astype(np.float32)
    whl2[over] = rng.uniform(0.3, 2, (int(over.sum()), 3))
    R2[over] = _rotations(rng, int(over.sum()))

    def corners(c, d, r):
        return cuboids.get_cuboid_verts_3d(torch.from_numpy(np.concatenate([c, d], -1)),
                                           torch.from_numpy(r))
    return corners(ctr, whl, R), corners(ctr2, whl2, R2)


def iou3d_card_vs_cpu(dev, n, seed=0):
    """matched_iou3d on n pairs on the card and on the CPU (float32, atol
    1e-5). Returns a report dict; raises AssertionError on a disagreement."""
    c1, c2 = cube_pairs(n, seed)
    want = iou3d.matched_iou3d(c1, c2)
    got = iou3d.matched_iou3d(c1.to(dev), c2.to(dev)).cpu()
    err = float((got - want).abs().max())
    assert err <= 1e-5, f"IoU3D card vs CPU: max |err| {err:.3e} > 1e-5"
    assert bool((want[3::5] == 0).all()), "disjoint pairs are not at IoU 0"
    # coplanar faces are decided by a +-1e-6 test that float32 rounding at a
    # few metres from the origin can cross (the JAX package's algorithm,
    # ROADMAP.md Queue C): some identical pairs read below 1 on both devices
    off = int(((want[0::5] - 1).abs() > 1e-5).sum())
    return {"pairs": n, "max_abs_err": err, "mean_iou": float(want.mean()),
            "identical_below_1": off, "identical": int(want[0::5].numel())}
