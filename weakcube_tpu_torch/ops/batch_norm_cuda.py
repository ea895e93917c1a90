"""BatchNorm's training pass through the CUDA kernels of csrc/batch_norm.cu.

models/layers.py::BatchNorm2d calls `batch_norm_train` in training mode,
on one process, for every input `takes` accepts: a 4-d NHWC-contiguous
(channels_last) CUDA tensor in bfloat16 or float32. The kernels take every
such tensor with at least one row, any C, any alignment and any size, and
raise for what they cannot take (an empty batch, parameters of another
device or shape); there is no fallback from the card to the plain chain.
The parameters and running statistics are read as float32 (a cast where
they are not), and the pending statistics come back in the running
statistics' dtype. Two launches give the output and the pending running
statistics of the layer's plain chain bit for bit (flax's statistics E[x]
and E[x^2] - E[x]^2 summed in the order of PyTorch's own reduction, whose
launch plan `stats_plan` computes; the normalisation in float32), and two
more the gradient, through a `torch.autograd.Function` that saves x in its
own dtype and four float32 vectors per channel. Without a gradient to take
(torch.no_grad, or nothing requiring one) the forward's two launches run
and nothing is saved.

The vector width of the normalisation and gradient kernels follows C and
the pointers: 16-byte vectors (8 bfloat16 or 4 float32 channels) where C
divides into them, else one channel a thread; the statistics launch's
width likewise follows C and x's alignment. `batch_norm_train.launches`
and `batch_norm_train_backward.launches` count kernel launches. The
kernels are built at first use with nvcc for sm_90a into `build/` at the
repository root (ops/cuda_build.py) and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from .cuda_build import CSRC_DIR, KernelLibrary

SOURCE = os.path.join(CSRC_DIR, "batch_norm.cu")
THREADS = 256          # = csrc/batch_norm.cu's kThreads
UNROLL = 4             # kUnroll: row sets a thread has in flight
CHUNK_CHANNELS = 128   # kChunkChannels: the channels of a column chunk
BLOCKS_PER_SM = 2      # blocks of a launch per SM, all column chunks together
MAX_GRID_Y = 65535     # CUDA's limit on a grid's second dimension
REDUCE_THREADS = 512   # PyTorch's reductions' MAX_NUM_THREADS (ATen/native/cuda/Reduce.cuh)

_devices = {}  # device index -> [its counters, SMs, threads an SM]: see _device

_i, _ll, _f, _p = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p
_library = KernelLibrary(SOURCE, {
    "bn_train_forward": ([_i, _i, _i, _p, _p, _ll, _i, _i, _ll, _i, _i, _p, _f, _p, _p, _p, _p,
                          _f, _f, _f, _p, _p, _p, _p, _p], _i),
    "bn_train_backward": ([_i, _i, _p, _p, _p, _ll, _i, _i, _ll, _i, _i, _p, _p, _p, _p, _p,
                           _p], _i)})
build = _library.build
__getattr__ = _library.module_attr  # build_log: the compiler's report


class Plan(NamedTuple):
    """A call's launch geometry: `vec` channels a thread, `cols` vectors in
    a column chunk, `lanes` rows a block reads at once, a grid of `grid_x`
    row chunks of `rows_per_block` rows by `grid_y` column chunks."""
    vec: int
    cols: int
    lanes: int
    rows_per_block: int
    grid_x: int
    grid_y: int


def plan(rows: int, C: int, vec: int, sms: int) -> Plan:
    """The grid for (rows, C) at `vec` channels a thread on a card of `sms`
    SMs: column chunks of at most CHUNK_CHANNELS channels, about
    BLOCKS_PER_SM blocks an SM, each row chunk at least one step's rows
    (lanes x UNROLL), no row chunk empty."""
    cols = min(C // vec, CHUNK_CHANNELS // vec)
    lanes = THREADS // cols
    grid_y = -(-C // (cols * vec))
    want = max(1, -(-BLOCKS_PER_SM * sms // grid_y))
    grid_x = max(1, min(-(-rows // (lanes * UNROLL)), want))
    rows_per_block = -(-rows // grid_x)
    return Plan(vec, cols, lanes, rows_per_block, -(-rows // rows_per_block), grid_y)


class StatsPlan(NamedTuple):
    """The statistics launch: PyTorch's reduction of the float32 (R, C)
    tensor over R (channels contiguous) as ATen/native/cuda/Reduce.cuh's
    setReduceConfig lays it out, which fixes the order of its sums. `ovs`
    channels a thread; blocks of (bw, bh) threads; a thread's rows start at
    threadIdx.y * in_mult1 + blockIdx.y * in_mult2 and step by step_input;
    its channels at (threadIdx.x + threadIdx.y * out_mult1 + blockIdx.x *
    step_output) * ovs; a grid of (grid_x, ctas) blocks, the ctas of one
    grid column summed by the last of them (global reduce); `factor` is the
    mean's (float)C / (float)(C * R)."""
    ovs: int
    step_input: int
    bw: int
    bh: int
    out_mult1: int
    in_mult1: int
    in_mult2: int
    step_output: int
    grid_x: int
    ctas: int
    factor: float


def _last_pow2(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def stats_plan(rows: int, C: int, sms: int, threads_per_sm: int, align: int = 4) -> StatsPlan:
    """setReduceConfig (PyTorch 2.11-2.13) for `x32.sum((0, 2, 3))` of a
    dense channels_last float32 (N, C, H, W), rows = N * H * W >= 2 and
    C >= 2, on a card of `sms` SMs of `threads_per_sm` threads: the
    iterator's two dims are the reduced rows (stride C) and the channels
    (stride 1), so the channels are vectorised by 4, 2 or 1 (the largest
    that divides C and, at most `align`, x's alignment in elements; the
    float32 copy is aligned) and split over the lanes, the rows over the
    warps where each thread would sum at least min(16 bh, 256) of them,
    and over blocks when it would still sum 256. One row, one channel, an
    x aligned below 4 elements or a float32 copy of 2^31 bytes or more get
    the same layout, which is there no longer PyTorch's order (PyTorch
    reshapes or splits such reductions) but one fixed order all the same."""
    ovs = next(k for k in (4, 2, 1) if k <= align and C % k == 0)
    dim0, dim1 = C // ovs, rows
    mnt = REDUCE_THREADS // ovs
    p0 = _last_pow2(dim0) if dim0 < mnt else mnt
    p1 = _last_pow2(dim1) if dim1 < mnt else mnt
    bw = min(p0, 32)
    bh = min(p1, mnt // bw)
    bw = min(p0, mnt // bh)
    step_input, step_output, out_mult1, in_mult1, in_mult2 = 1, bw, 0, 0, 0
    if rows >= min(bh * 16, 256):
        in_mult1, step_input = 1, bh
    else:
        out_mult1, step_output = bw, bw * bh
    grid_x = -(-dim0 // step_output)
    target = sms * (threads_per_sm // (bw * bh))
    per_thread = -(-rows // step_input)
    ctas = 1
    if in_mult1 and per_thread >= 256 and grid_x <= target:
        ctas = max(min(-(-target // grid_x), -(-per_thread // 16)), -(-per_thread // 256))
        if ctas > 1:
            in_mult2, step_input = step_input, step_input * ctas
    factor = float(np.float32(C) / np.float32(C * rows))
    return StatsPlan(ovs, step_input, bw, bh, out_mult1, in_mult1, in_mult2, step_output,
                     grid_x, ctas, factor)


@functools.lru_cache(maxsize=512)
def _plans(rows: int, C: int, vec: int, align: int, sms: int, threads_per_sm: int):
    """(plan, stats_plan, the stats plan's integers as the C array the entry
    point reads) for one shape; a model has a few dozen."""
    q = stats_plan(rows, C, sms, threads_per_sm, align)
    sp = (ctypes.c_longlong * 9)(q.step_input, q.bw, q.bh, q.out_mult1, q.in_mult1, q.in_mult2,
                                 q.step_output, q.grid_x, q.ctas)
    return plan(rows, C, vec, sms), q, sp


def vec_width(C: int, dtype: torch.dtype, *tensors: torch.Tensor) -> int:
    """Channels a thread takes: a 16-byte vector where C divides into them
    and every tensor is 16-byte aligned, else 1."""
    v = 8 if dtype == torch.bfloat16 else 4
    return v if C % v == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def elements_aligned(x: torch.Tensor) -> int:
    """The statistics launch's widest load, in elements (4, 2 or 1), that
    x's pointer is aligned to."""
    return next(k for k in (4, 2, 1) if x.data_ptr() % (k * x.element_size()) == 0)


def takes(x: torch.Tensor) -> bool:
    """Whether a training call is the kernels': x a 4-d NHWC-contiguous
    CUDA tensor in bfloat16 or float32. Every other call stays on the plain
    chain; of these, `batch_norm_train` raises for what it cannot take."""
    return (x.is_cuda and x.dtype in (torch.bfloat16, torch.float32) and x.dim() == 4
            and x.is_contiguous(memory_format=torch.channels_last))


def _device(device: torch.device, columns: int):
    """(the device's counters: at least `columns` zeroed int32 that the
    kernels leave zeroed, one a grid column; its SM count; its threads an
    SM), made at its first call and grown when a launch has more grid
    columns than counters."""
    got = _devices.get(device.index)
    if got is None:
        props = torch.cuda.get_device_properties(device)
        got = _devices[device.index] = [torch.zeros(0, dtype=torch.int32, device=device),
                                        props.multi_processor_count,
                                        props.max_threads_per_multi_processor]
    if got[0].numel() < columns:
        got[0] = torch.zeros(max(columns, 1024), dtype=torch.int32, device=device)
    return got


def _sms(device: torch.device):
    return _device(device, 0)[1:]


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


def _forward(x, weight, bias, running_mean, running_var, momentum: float, eps: float):
    """The two forward launches: (y, coef (4, C), pending (2, C)) for x as
    `takes` accepts it and float32 parameters as `_float32_params` gives
    them."""
    N, C, H, W = x.shape
    rows = N * H * W
    y = torch.empty_like(x)
    sms, tpm = _sms(x.device)
    p, q, sp = _plans(rows, C, vec_width(C, x.dtype, x, y), elements_aligned(x), sms, tpm)
    if max(p.grid_y, q.ctas) > MAX_GRID_Y:
        raise ValueError(f"BatchNorm of {tuple(x.shape)}: a grid of {p.grid_y} column chunks "
                         f"and {q.ctas} row blocks passes CUDA's {MAX_GRID_Y}")
    counters = _device(x.device, max(p.grid_y, q.grid_x))[0]
    small = torch.empty((6, C), dtype=torch.float32, device=x.device)
    staging = torch.empty(q.grid_x * q.ctas * q.bw * 2 * q.ovs if q.ctas > 1 else 1,
                          dtype=torch.float32, device=x.device)
    lib = _library.load()
    with torch.cuda.device(x.device):
        err = lib.bn_train_forward(
            int(x.dtype == torch.bfloat16), p.vec, q.ovs, x.data_ptr(), y.data_ptr(), rows, C,
            p.cols, p.rows_per_block, p.grid_x, p.grid_y, sp, q.factor, weight.data_ptr(),
            bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(), 1.0 - momentum,
            momentum, eps, staging.data_ptr(), counters.data_ptr(), small.data_ptr(),
            small[4].data_ptr(), torch.cuda.current_stream().cuda_stream)
    _check(err, "bn_train_forward")
    batch_norm_train.launches += 2
    return y, small[:4], small[4:]


def batch_norm_train_backward(g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                              coef: torch.Tensor, input_grad: bool = True):
    """The gradient of `batch_norm_train`'s y: (dx or None, grad_weight,
    grad_bias) from g (made NHWC-contiguous in x's dtype if it is not), the
    saved x, weight and the forward's coef. Two launches, one without dx."""
    if g.dtype != x.dtype or not g.is_contiguous(memory_format=torch.channels_last):
        g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
    N, C, H, W = x.shape
    rows = N * H * W
    dx = torch.empty_like(x) if input_grad else None
    p = plan(rows, C, vec_width(C, x.dtype, g, x, *([dx] if input_grad else [])),
             _sms(x.device)[0])
    counters = _device(x.device, p.grid_y)[0]
    grads = torch.empty((4, C), dtype=torch.float32, device=x.device)
    ws = torch.empty(2 * p.grid_x * C, dtype=torch.float64, device=x.device)
    lib = _library.load()
    with torch.cuda.device(x.device):
        err = lib.bn_train_backward(
            int(x.dtype == torch.bfloat16), p.vec, g.data_ptr(), x.data_ptr(),
            dx.data_ptr() if input_grad else None, rows, C, p.cols, p.rows_per_block,
            p.grid_x, p.grid_y, weight.data_ptr(), coef.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), grads.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _check(err, "bn_train_backward")
    batch_norm_train_backward.launches += 1 + input_grad
    return dx, grads[0], grads[1]


batch_norm_train_backward.launches = 0


class BatchNormTrainFunction(torch.autograd.Function):
    """y = BatchNorm(x) in training mode with its gradient in x, weight and
    bias; the pending statistics are outputs without a gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps):
        y, coef, pending = _forward(x, weight, bias, running_mean, running_var, momentum, eps)
        ctx.save_for_backward(x, weight, coef)
        pm, pv = pending[0], pending[1]
        ctx.mark_non_differentiable(pm, pv)
        return y, pm, pv

    @staticmethod
    def backward(ctx, gy, _gm, _gv):
        x, weight, coef = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, gw, gb = batch_norm_train_backward(gy, x, weight, coef, need[0])
        return dx, gw if need[1] else None, gb if need[2] else None, None, None, None, None


def _float32_params(x: torch.Tensor, *params: torch.Tensor):
    """weight, bias, running_mean and running_var as the kernels read them:
    C contiguous float32 values each on x's device (a cast, which autograd
    follows, where they are not). Raises for an empty x or a parameter of
    another device or shape."""
    if x.numel() == 0:
        raise ValueError(f"BatchNorm in training of an empty batch {tuple(x.shape)}: no "
                         "statistics to take")
    device, shape = x.device, (x.shape[1],)
    for t in params:
        if t.device != device or t.shape != shape:
            raise ValueError(f"BatchNorm of {tuple(x.shape)} on {x.device}: a parameter of "
                             f"shape {tuple(t.shape)} on {t.device}")
    return [t if t.dtype == torch.float32 and t.is_contiguous()
            else t.to(torch.float32).contiguous() for t in params]


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor,
                     momentum: float, eps: float):
    """Training-mode BatchNorm of x (N, C, H, W), channels_last, as
    `takes` accepts it: (y in x's dtype and layout, pending running mean,
    pending running variance), the last two in the running statistics'
    dtype and without a gradient. `momentum` is PyTorch's (flax's is
    1 - momentum). Raises ValueError for an input the kernels cannot take."""
    dt = running_mean.dtype
    w, b, rm, rv = _float32_params(x, weight, bias, running_mean, running_var)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad):
        y, pm, pv = BatchNormTrainFunction.apply(x, w, b, rm, rv, momentum, eps)
    else:
        y, _, pending = _forward(x, w, b, rm, rv, momentum, eps)
        pm, pv = pending[0], pending[1]
    return y, pm.to(dt), pv.to(dt)


batch_norm_train.launches = 0
