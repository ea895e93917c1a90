"""The weak training step of weakcube_tpu_torch against weakcube_tpu in
float32 and bfloat16: the first step of test_torch_train.py's setup (the
same weights, batch and anchor labels, and the RoIs JAX sampled in its
float32 step, injected into every run) in the packages' working types.

The step is ill-conditioned at this size (test_torch_train.py's
docstring): JAX's float32 step is up to ~19% off the exact one in the
deepest gradients (level 4 and 5 of the DLA; the median gradient ~2%, the
losses ~1e-4), and its bf16 step up to ~22% off in the dims losses and
~38% in Cube/2D_IoU. So every loss, metric and gradient must lie within a
small margin (1e-4 of the tensor's scale in float32, 5e-2 in bf16) plus
three times the largest distance between JAX's value and the exact one:
the port must be as close to the exact step as the reference in the same
type is. The exact values are JAX's own float64 step (parameters float32)
on the same inputs, so a fault of the port's algorithm cannot widen its
own bound; test_torch_train.py holds the algorithm to 1e-5 in float64.

    PYTHONPATH=. python tests/test_torch_train_f32.py

prints the bound each loss, metric and gradient gets, relative to its
scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import as_np, check, jax_steps, logs_of, port_steps
from weakcube_tpu_torch.utils.convert import flax_params_to_torch


def make_runs():
    v, batch, (j32,) = jax_steps(jnp.float32, 1)
    rois = [j32["rois"]]
    with jax.enable_x64():
        _, _, (j64,) = jax_steps(jnp.float64, 1, rois)
    (t32,) = port_steps(v, batch, rois, torch.float32, 1)[2]
    return dict(v=v, batch=batch, rois=rois, j32=j32, j64=j64, t32=t32)


@pytest.fixture(scope="module")
def runs():
    return make_runs()


def test_losses_and_metrics_f32(runs):
    t32, exact = runs["t32"], logs_of(runs["j64"])
    for k, w in logs_of(runs["j32"]).items():
        check(np.float32(t32["logs"][k]), w, 1e-4, k, exact=exact[k])


def test_gradients_f32(runs):
    t32 = runs["t32"]
    want = flax_params_to_torch(runs["j32"]["grads"])
    exact = flax_params_to_torch(runs["j64"]["grads"])
    assert set(want) == set(t32["grads"])
    for name, g in want.items():
        check(t32["grads"][name], g, 1e-4, name, exact=exact[name])
    # the FPN level the RoIs pool from gets the heads' gradient
    assert t32["grads"]["backbone.fpn_output2.weight"].abs().sum() > 0


def bf16_logs(runs):
    _, _, (j16,) = jax_steps(jnp.bfloat16, 1, runs["rois"], grads=False)
    (t16,) = port_steps(runs["v"], runs["batch"], runs["rois"], torch.bfloat16, 1)[2]
    return logs_of(j16), t16["logs"]


def test_losses_and_metrics_bf16(runs):
    """bf16 compute. Beside the conditioning, the two round at other places:
    the JAX matmul pooling plan rounds its hat weights to bf16
    (ops/roi_align.py:342-343), the port's pooler keeps them in float32, and
    each layer rounds its output once."""
    want, got = bf16_logs(runs)
    exact = logs_of(runs["j64"])
    for k, w in want.items():
        check(np.float32(got[k]), w, 5e-2, k, exact=exact[k])


def relative_bound(want, exact, rtol):
    """check()'s bound for `want` against `exact`, over the scale of want."""
    want, exact = as_np(want), as_np(exact)
    scale = max(np.abs(want).max(), 1e-3)
    return (rtol * scale + 3 * np.abs(want - exact).max()) / scale


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    r = make_runs()
    exact = logs_of(r["j64"])
    print("float32 losses and metrics: bound / scale")
    for k, w in logs_of(r["j32"]).items():
        print(f"  {k:32s} {relative_bound(w, exact[k], 1e-4):.3e}")
    print("bf16 losses and metrics: bound / scale")
    for k, w in bf16_logs(r)[0].items():
        print(f"  {k:32s} {relative_bound(w, exact[k], 5e-2):.3e}")
    grads = flax_params_to_torch(r["j32"]["grads"])
    gexact = flax_params_to_torch(r["j64"]["grads"])
    rel = sorted(((relative_bound(g, gexact[n], 1e-4), n) for n, g in grads.items()),
                 reverse=True)
    print(f"float32 gradients: bound / scale over {len(rel)} tensors: median "
          f"{np.median([x for x, _ in rel]):.3e}; largest:")
    for x, n in rel[:8]:
        print(f"  {n:56s} {x:.3e}")
