"""BatchNorm2d's training calls that the kernels of ops/batch_norm_cuda.py
do not take (CPU tensors, float64, an NCHW-contiguous tensor, a
data-parallel run) run the plain chain as it was: no kernel launch, and the
bits of a verbatim copy of that chain in the output, the pending running
statistics and the gradients. The kernels' launch plan (plain Python)
covers every row and channel once within the kernels' limits. The kernels
themselves are held to float64 on the card in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from weakcube_tpu_torch.models import layers
from weakcube_tpu_torch.ops import batch_norm_cuda
from weakcube_tpu_torch.parallel import distributed


def chain(bn, x):
    """models/layers.py::BatchNorm2d's training chain before the kernels,
    verbatim: (y, pending)."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))  # float64 stays
    if distributed.process_count() == 1:
        mean, mean_sq = x32.mean((0, 2, 3)), (x32 * x32).mean((0, 2, 3))
    else:
        C = x32.shape[1]
        s = layers.global_sum(torch.cat([x32.sum((0, 2, 3)), (x32 * x32).sum((0, 2, 3)),
                                         x32.new_full((1,), x32.numel() // C)]))
        mean, mean_sq = s[:C] / s[-1], s[C:2 * C] / s[-1]
    var = (mean_sq - mean * mean).clamp(min=0.0)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (x32 - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    with torch.no_grad():
        m = bn.momentum
        dt = bn.running_mean.dtype
        pending = ((1 - m) * bn.running_mean + m * mean.to(dt),
                   (1 - m) * bn.running_var + m * var.to(dt))
    return y.to(x.dtype), pending


def module(C, rng):
    bn = layers.BatchNorm2d(C).train()
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
            t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)))
    return bn


def run(bn, x, g, fn):
    xi = x.detach().clone().requires_grad_()
    y, pending = fn(bn, xi)
    y.backward(g)
    return [y.detach(), *pending, xi.grad, bn.weight.grad, bn.bias.grad]


@pytest.mark.parametrize("case", ["cpu_bfloat16", "cpu_float32", "float64", "nchw",
                                  "data_parallel"])
def test_plain_chain_where_the_kernels_do_not_take(case, monkeypatch):
    """(3, 24, 5, 7) with a channel of large mean: the layer's output,
    pending statistics and gradients equal the verbatim chain's bit for bit,
    and neither kernel counter moves; `takes` refuses the tensor.
    data_parallel: process_count() 2 and the all-reduce an identity, so the
    global-batch branch runs."""
    rng = np.random.default_rng(7)
    dt = {"cpu_bfloat16": torch.bfloat16, "float64": torch.float64}.get(case, torch.float32)
    a = rng.normal(size=(3, 24, 5, 7)) + 40.0 * (np.arange(24) == 3)[None, :, None, None]
    x = torch.from_numpy(a).to(dt)
    g = torch.from_numpy(rng.normal(size=a.shape)).to(dt)
    if case != "nchw":
        x, g = (t.contiguous(memory_format=torch.channels_last) for t in (x, g))
    if case == "data_parallel":
        monkeypatch.setattr(distributed, "process_count", lambda: 2)
        monkeypatch.setattr(layers, "global_sum", lambda t: t)
    C = x.shape[1]
    bn_layer, bn_chain = module(C, np.random.default_rng(1)), module(C, np.random.default_rng(1))
    before = (batch_norm_cuda.batch_norm_train.launches,
              batch_norm_cuda.batch_norm_train_backward.launches)
    assert not batch_norm_cuda.takes(x)

    def layer(bn, xi):
        y = bn(xi)
        return y, bn.pending
    got = run(bn_layer, x, g, layer)
    want = run(bn_chain, x, g, chain)
    assert (batch_norm_cuda.batch_norm_train.launches,
            batch_norm_cuda.batch_norm_train_backward.launches) == before
    assert got[0].dtype == dt
    for name, p, q in zip(("y", "pending mean", "pending var", "dx", "grad weight",
                           "grad bias"), got, want):
        assert torch.equal(p, q), name


# (rows, C, vec): the b25 step's DLA-34 levels at 512 px, ShuffleNetV2's 116 and
# 232 on the scalar path, ResNet's 2048 in float32, ragged small ones, one row,
# and 140001 channels (1094 column chunks, more than the counters' first 1024)
PLAN_CASES = [(25 * 512 * 512, 16, 8), (25 * 256 * 256, 32, 8), (25 * 128 * 128, 64, 8),
              (25 * 64 * 64, 128, 8), (25 * 32 * 32, 256, 8), (25 * 16 * 16, 512, 8),
              (25 * 8 * 8, 116, 1), (25 * 4 * 4, 232, 1), (6400, 2048, 4), (7, 3, 1),
              (1, 8, 8), (1000, 24, 4), (3001, 200, 8), (50000, 1, 1), (1, 5, 1),
              (4, 140001, 1)]


@pytest.mark.parametrize("rows,C,vec", PLAN_CASES)
def test_plan_covers_every_row_and_channel(rows, C, vec):
    """The grid stays within the kernels' limits (256 threads, column chunks
    of at most 128 channels, CUDA's 65535 of them, about two blocks an SM of
    an H100's 132), no row chunk is empty, and the threads' (row, channel)
    places cover each element once (checked element by element where the
    tensor is small)."""
    p = batch_norm_cuda.plan(rows, C, vec, 132)
    assert p.vec == vec and p.lanes * p.cols <= batch_norm_cuda.THREADS
    assert p.cols * vec <= batch_norm_cuda.CHUNK_CHANNELS and p.lanes >= 1
    assert (p.grid_y - 1) * p.cols * vec < C <= p.grid_y * p.cols * vec
    assert p.grid_y <= batch_norm_cuda.MAX_GRID_Y
    assert (p.grid_x - 1) * p.rows_per_block < rows <= p.grid_x * p.rows_per_block
    assert p.grid_x * p.grid_y <= 2 * batch_norm_cuda.BLOCKS_PER_SM * 132 + p.grid_y
    if rows * C > 2e6:
        return
    seen = np.zeros((rows, C), np.int32)
    for by in range(p.grid_y):
        for t in range(batch_norm_cuda.THREADS):
            lane, c0 = t // p.cols, (by * p.cols + t % p.cols) * vec
            if lane >= p.lanes or c0 >= C:
                continue
            for bx in range(p.grid_x):
                r0 = bx * p.rows_per_block
                r1 = min(rows, r0 + p.rows_per_block)
                seen[r0 + lane:r1:p.lanes, c0:c0 + vec] += 1
    assert (seen == 1).all()


def test_vector_width_follows_channels_and_alignment():
    x = torch.zeros(64)
    assert batch_norm_cuda.vec_width(16, torch.bfloat16, x) == 8
    assert batch_norm_cuda.vec_width(116, torch.bfloat16, x) == 1
    assert batch_norm_cuda.vec_width(116, torch.float32, x) == 4
    assert batch_norm_cuda.vec_width(16, torch.float32, x[1:]) == 1


@pytest.mark.parametrize("rows,C,want", [
    (25 * 512 * 512, 16, dict(ovs=4, bw=4, bh=32, grid_x=1, ctas=2112, step_input=67584)),
    (25 * 16 * 16, 512, dict(ovs=4, bw=32, bh=4, grid_x=4, ctas=100, step_input=400)),
    (3 * 5 * 7, 24, dict(ovs=4, bw=4, bh=32, grid_x=1, ctas=1, step_input=1, out_mult1=4)),
    (2 * 9, 6, dict(ovs=2, bw=2, bh=16, grid_x=1, ctas=1, step_input=1, out_mult1=2))])
def test_stats_plan_is_pytorchs_reduce_config(rows, C, want):
    """The statistics launch as ATen's setReduceConfig lays out the float32
    reduction on an H100 (132 SMs of 2048 threads), worked by hand from
    Reduce.cuh: level0 of the b25 step splits its 6.5 M rows over 2112
    blocks, level5's over 100; 105 rows of 24 channels and 18 of 6 stay
    whole in each thread (too few to split across warps)."""
    q = batch_norm_cuda.stats_plan(rows, C, 132, 2048)
    assert {k: getattr(q, k) for k in want} == want
    assert q.factor == float(np.float32(C) / np.float32(C * rows))


@pytest.mark.parametrize("align,C,ovs", [(4, 16, 4), (2, 16, 2), (1, 16, 1), (4, 6, 2),
                                         (2, 7, 1), (4, 1, 1)])
def test_stats_plan_width_follows_alignment(align, C, ovs):
    """The statistics launch loads ovs channels at once: the largest of 4, 2
    and 1 that divides C and x's alignment in elements (a view that starts
    one bfloat16 into its storage loads one channel at a time)."""
    assert batch_norm_cuda.stats_plan(6400, C, 132, 2048, align).ovs == ovs
    x = torch.zeros(65, dtype=torch.bfloat16)
    assert batch_norm_cuda.elements_aligned(x[:64]) == 4
    assert batch_norm_cuda.elements_aligned(x[1:]) == 1
    assert batch_norm_cuda.elements_aligned(x[2:]) == 2


@pytest.mark.parametrize("case", ["empty", "wrong_shape", "float64_params", "bf16_params"])
def test_kernel_parameters_are_float32_or_refused(case):
    """What batch_norm_train hands the kernels: the four per-channel vectors
    as contiguous float32 (a cast autograd follows, where they are another
    dtype), or a ValueError for an empty batch or a vector of the wrong
    shape; nothing falls back to the plain chain."""
    x = torch.zeros((0 if case == "empty" else 2, 8, 3, 3))
    C = 9 if case == "wrong_shape" else 8
    dt = {"float64_params": torch.float64, "bf16_params": torch.bfloat16}.get(case,
                                                                            torch.float32)
    w = torch.linspace(0.5, 1.5, C, dtype=dt).requires_grad_()
    params = [w] + [torch.ones(C, dtype=dt) for _ in range(3)]
    if case in ("empty", "wrong_shape"):
        with pytest.raises(ValueError):
            batch_norm_cuda._float32_params(x, *params)
        return
    got = batch_norm_cuda._float32_params(x, *params)
    assert all(t.dtype == torch.float32 and t.is_contiguous() and t.shape == (C,) for t in got)
    got[0].sum().backward()
    assert w.grad.dtype == dt and torch.equal(w.grad, torch.ones(C, dtype=dt))
