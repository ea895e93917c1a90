"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. print the card's name and power limit (nvidia-smi);
  2. build the ROIAlign (K1) and flash-attention (K2) CUDA kernels from
     weakcube_tpu_torch/csrc, one nvcc each, in parallel;
  3. hold K1 against its plain PyTorch version at the main path's shapes
     (b8, levels 128^2..8^2 x 256, R = 1000 and 100), with edge-case boxes
     (past the borders, sub-pixel, elongated, hugging a border, empty,
     huge), in float32 and bfloat16;
  4. build the full-width flagship model (configs/Omni_combined.yaml:
     DLA-34 + FPN 256, 38 classes, bf16 compute) with random weights from a
     seed, and run one warm-up plus 3 forwards of 8 images at 512 px;
  5. check the outputs (shapes, finite values, K1 launched exactly twice per
     forward) and hold K1 against the plain version on the forward's own
     pyramid and boxes; check a small float32 model on the card against the
     same model on the CPU;
  6. time the forward; K1 and a library yardstick in turns (5 rounds,
     medians), K1's device time per launch (the host's enqueue hidden
     behind a sleep kernel) and K1's plain
     version, per pooler, beside two bounds (the whole pyramid, and the
     pixels the forward's boxes touch) and the bytes K1 stages from L2;
     K1 on as many real-size RoIs (p3-p5 squares of 14-28 feature units)
     and on sub-pixel RoIs at one spot (every read a cache hit), checked
     and timed; profile one forward;
  7. hold K2 against its plain PyTorch version at B16 H16 d64 with
     N = 1, 50, 63, 64, 65, 127, 128, 129, 197 and 1370 (the tile edges and
     ragged tiles), in bfloat16 and float32, on contiguous q, k, v and on
     the views of a fused (B, N, 3, H, 64) projection that the encoder
     passes;
  8. the depth pseudo-GT path at full width: Depth Anything V2 ViT-L
     (random weights from a seed) at 518 px through
     data/generate_depth_maps.py::generate() on 32 synthetic 640x480 images
     (two batches of 16); check the 32 depth maps and that K2 launched 24
     times per forward; hold K2 against the plain version on one block's
     own q, k, v from that run (contiguous copies and the projection's own
     views); a small float32 ViT-S on the card against the CPU at 98 and
     196 px;
  9. time the depth forward (B16), K2 (on block 11's q, k, v made
     contiguous, and on the path's own strided views) and
     F.scaled_dot_product_attention as a yardstick in turns, and K2's plain
     version; profile one forward and
     count its layout copies (at most 28: no q, k, v or output copies
     around K2);
 10. print the kernels line and, last, {"ok": true, "device": {...}}.

It needs a CUDA device and the repository beside it; without either it
exits non-zero and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores (K1's arithmetic is float32 FMA on the CUDA
# cores), dense bf16 FLOP/s on the tensor cores (K2's products)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# SFU exponentials per second: 16 ex2 per clock per SM, 132 SMs, 1.98 GHz
# boost (H100 SXM)
PEAK_EX2_PER_S = 16 * 132 * 1.98e9
K1_REPLACES = "weakcube_tpu/ops/roi_align_pallas.py:198"
K1_SOURCE = "weakcube_tpu_torch/csrc/roi_align.cu"
K2_REPLACES = "weakcube_tpu/data/pseudo_gt/depth_anything_v2.py:37"
K2_SOURCE = "weakcube_tpu_torch/csrc/flash_attention.cu"
DEPTH_BATCH, DEPTH_SIZE, DEPTH_IMAGES = 16, 518, 32


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def timed_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device ms per call over `iters` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, iters: int) -> float:
    """Device ms per call of fn, the host's enqueue hidden: a sleep kernel
    holds the stream while the host queues `iters` calls, so the CUDA events
    around them time the device alone. (Events around back-to-back calls
    time the host when a kernel is shorter than its Python wrapper's
    enqueue.) Fails if the queueing outlasted the sleep."""
    import torch
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    torch.cuda._sleep(20_000_000)  # ~10 ms at the H100's clocks
    ev[1].record()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        fail(f"queueing {iters} calls took {host_ms:.3f} ms, longer than the "
             f"{ev[0].elapsed_time(ev[1]):.3f} ms sleep that hides it")
    return ev[1].elapsed_time(ev[2]) / iters


def roi_align_bound(levels, boxes, strides, out_size: int, sr: int):
    """Least time for one pooler call, against its float32 operations (per
    output value: sr^2 samples x 4 corners x multiply-add, one divide), in
    two byte counts over HBM bandwidth: the whole pyramid read once (the
    figure of earlier runs), and the pixels these boxes touch (their union
    per image and level, counted on the device) read once; both with the
    boxes read and the output written once. Also returns the bytes that
    K1's staging moves from L2 into shared memory (each RoI's window once)."""
    from weakcube_tpu_torch.ops.roi_align_cuda import footprint
    fp = footprint(levels, boxes, strides, out_size, sr)
    elt = levels[0].element_size()
    n_out = fp["out_bytes"] // elt
    t_ops = n_out * (sr * sr * 4 * 2 + 1) / PEAK_F32_FLOPS
    rest = boxes.numel() * 4 + fp["out_bytes"]
    out = {}
    for name, nbytes in (("whole", sum(f.numel() for f in levels) * elt + rest),
                         ("touched", fp["touched_bytes"] + rest)):
        t_bytes = nbytes / PEAK_BYTES_PER_S
        out[name] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    out["staged_bytes"], out["touched_bytes"] = fp["staged_bytes"], fp["touched_bytes"]
    return out


def attention_bound(q):
    """Least time for one attention call on (B, H, N, d) q, k, v: the two
    products (4 B H N^2 d FLOPs) on the bf16 tensor cores against q, k, v
    read once and o written once. Also returns the exponentials it takes
    (B H N^2) and their least time on the SFU, which runs beside the
    tensor cores."""
    B, H, N, d = q.shape
    flops = 4 * B * H * N * N * d
    nbytes = 4 * q.numel() * q.element_size()
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    n_exp = B * H * N * N
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            flops, nbytes, n_exp, n_exp / PEAK_EX2_PER_S * 1e3)


def library_roi_align(levels, boxes, strides, out_size: int, sr: int):
    """Yardstick the port never calls: per-level F.grid_sample (bilinear,
    border padding, align_corners=True, i.e. samples clamped to
    [0, size - 1]) + the sr x sr mean. The per-level sample grids are made
    beforehand (every RoI at every level, masked to its own level), so the
    returned closure times the library sampling and the mean only."""
    import torch
    import torch.nn.functional as F
    from weakcube_tpu_torch.ops.roi_align import assign_fpn_levels
    B, R = boxes.shape[:2]
    P = out_size * sr
    lvl = assign_fpn_levels(boxes, 2, 1 + len(levels)) - 2
    grid = (torch.arange(P, device=boxes.device, dtype=torch.float32) + 0.5) / P
    inputs = []
    for l, (f, s) in enumerate(zip(levels, strides)):
        H, W = f.shape[1:3]
        b = boxes / s - 0.5
        rw = (b[..., 2] - b[..., 0]).clamp(min=1e-6)
        rh = (b[..., 3] - b[..., 1]).clamp(min=1e-6)
        gx = (b[..., 0, None] + rw[..., None] * grid) * (2.0 / max(W - 1, 1)) - 1.0
        gy = (b[..., 1, None] + rh[..., None] * grid) * (2.0 / max(H - 1, 1)) - 1.0
        g = torch.stack([gx[:, :, None, :].expand(B, R, P, P),
                         gy[:, :, :, None].expand(B, R, P, P)], -1)
        inputs.append((f.permute(0, 3, 1, 2), g.reshape(B, R * P, P, 2).to(f.dtype),
                       (lvl == l)[:, :, None, None, None]))

    def run():
        out = None
        for x, g, m in inputs:
            s = F.grid_sample(x, g, mode="bilinear", padding_mode="border",
                              align_corners=True)            # (B, C, R*P, P)
            s = s.reshape(B, -1, R, out_size, sr, out_size, sr).mean(dim=(4, 6))
            s = s.permute(0, 2, 3, 4, 1)                     # (B, R, 7, 7, C)
            out = torch.where(m, s, out) if out is not None else torch.where(m, s, 0)
        return out
    return run


def check_close(name, got, want, atol, rtol):
    import torch
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    try:
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    except AssertionError as e:
        fail(f"{name}: kernel disagrees with the plain version (max |err| {err}): {e}")
    print(f"  {name}: max |err| {err:.3e} (atol {atol}, rtol {rtol})")
    return err


def match_detections(a, b, i):
    """Image i's valid detections of a, matched greedily to b's by class,
    score and box (clipped degenerate boxes may repeat). Returns the slots of
    b's valid detections in a's order."""
    import torch

    def key(d):
        v = d.valid[i].cpu()
        return torch.cat([d.boxes[i].cpu(), 1e3 * d.scores[i].cpu()[:, None],
                          1e6 * d.classes[i].cpu()[:, None].float()], -1)[v]
    dist = torch.cdist(key(a), key(b), p=float("inf"))
    j = []
    for row in dist:
        row = row.clone()
        row[j] = float("inf")
        j.append(int(row.argmin()))
    return torch.tensor(j, dtype=torch.long)


def profile_forward(model, batch, top: int = 12):
    """torch.profiler over one forward: the device's busy share of the
    forward's wall time and the kernels that take most of it. Returns the
    number of layout-copy kernels launched (PyTorch's `direct_copy_kernel`,
    which `.contiguous()` and copying reshapes run; None where the profiler
    saw no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        model(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        print("[profile] the profiler recorded no device time: busy share not measured")
        return None
    copies = [e for e in kernels if "direct_copy_kernel" in e.key]
    n_copies = sum(e.count for e in copies)
    print(f"[profile] one forward under the profiler: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), idle "
          f"{100 * (1 - busy_us / wall_us):.1f}%, {sum(e.count for e in kernels)} kernel launches, "
          f"{n_copies} of them layout copies ({sum(e.self_device_time_total for e in copies) / 1e3:.3f} ms)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {100 * e.self_device_time_total / busy_us:5.1f}%"
              f" x{e.count:<5d} {e.key[:110]}")
    return n_copies


def edge_boxes(B, R, size, gen, device):
    """Random boxes over a size x size canvas, with edge cases: boxes past
    every border, sub-pixel boxes, elongated boxes (far wider or taller than
    the 2 * 7 * 2 lines a window holds at their level), boxes hugging each
    border, zero-area boxes and huge boxes (p6)."""
    import torch
    xy = torch.rand((B, R, 2), generator=gen, device=device) * size
    wh = torch.rand((B, R, 2), generator=gen, device=device) ** 3 * size * 0.8 + 1.0
    b = torch.cat([xy, xy + wh], -1)
    n = R // 10
    b[:, :n] = b[:, :n] * 1.6 - 0.3 * size                  # past the borders
    b[:, n:2 * n, 2:] = b[:, n:2 * n, :2] + 0.3             # sub-pixel
    # elongated: 0.5-1.2 x size long, 2-16 px thin, half of them vertical
    u = torch.rand((B, n, 4), generator=gen, device=device)
    long, thin = (0.5 + 0.7 * u[..., 0]) * size, 2.0 + 14.0 * u[..., 1]
    x0, y0 = (u[..., 2] * 0.8 - 0.2) * size, u[..., 3] * size
    el = torch.stack([x0, y0, x0 + long, y0 + thin], -1)
    el[:, ::2] = el[:, ::2][..., [1, 0, 3, 2]]
    b[:, 3 * n:4 * n] = el
    # hugging a border: one edge on it (or half a pixel past it), in turn
    hb = b[:, 4 * n:5 * n].clone()
    for k in range(4):
        side = hb[:, k::4]
        w = side[..., 2:] - side[..., :2]
        edge = float(size) if k >= 2 else 0.0
        side[..., k] = edge - 0.5 if k < 2 else edge + 0.5
        side[..., (k + 2) % 4] = side[..., k] + (w[..., k % 2] if k < 2 else -w[..., k % 2])
        hb[:, k::4] = side
    b[:, 4 * n:5 * n] = torch.stack([torch.minimum(hb[..., 0], hb[..., 2]),
                                     torch.minimum(hb[..., 1], hb[..., 3]),
                                     torch.maximum(hb[..., 0], hb[..., 2]),
                                     torch.maximum(hb[..., 1], hb[..., 3])], -1)
    b[:, 2 * n:2 * n + 4] = torch.tensor([[-50.0, -50.0, size + 80.0, size + 80.0],
                                          [0.0, 0.0, size, size],
                                          [10.0, 10.0, 10.0, 10.0],
                                          [size - 1.0, 0.0, size + 30.0, 5.0]],
                                         device=device)     # huge, full, empty, edge
    return b.contiguous()


def large_boxes(B, R, size, gen, device):
    """Square RoIs of 14-28 feature units (log-uniform) on p3, p4 or p5 at
    random centres on a size x size canvas: the windows of 225-784 pixels
    that real-size objects give, where random-weight proposals stay on p2."""
    import torch
    u = torch.rand((B, R, 4), generator=gen, device=device)
    side = 14.0 * 2.0 ** u[..., 0] * 2.0 ** (3 + (3 * u[..., 1]).floor())
    c = u[..., 2:] * size
    return torch.cat([c - side[..., None] / 2, c + side[..., None] / 2], -1).contiguous()


def depth_phases(dev):
    """Phases 7-9: K2 against its plain version, the depth pseudo-GT path at
    full width, the small depth model card vs CPU, timings. Returns K2's
    entry of the kernels line."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F
    from weakcube_tpu_torch.data import synthetic
    from weakcube_tpu_torch.data.generate_depth_maps import generate, load_model
    from weakcube_tpu_torch.ops import flash_attention_cuda, roi_align_cuda

    K2 = flash_attention_cuda.flash_attention
    plain = flash_attention_cuda.plain
    scale = 64 ** -0.5
    # bf16: P and O are each rounded to bf16 once, in other places than the
    # plain version's (probabilities after normalising, output after the
    # product), so they differ by about a bf16 step of |o| <= max |v|;
    # float32: the same math in another order with an online softmax
    tols = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-5, 1e-5)}
    errs = []

    # -- 7. K2 against its plain version at the path's shape and ragged N ---
    print("[compare] K2 vs plain, B16 H16 d64, contiguous and projection views")
    gen = torch.Generator(device=dev).manual_seed(1)
    for dt in (torch.bfloat16, torch.float32):
        for N in (1, 50, 63, 64, 65, 127, 128, 129, 197, 1370):
            qkv = torch.randn((16, N, 3 * 16 * 64), generator=gen, device=dev).to(dt)
            views = qkv.reshape(16, N, 3, 16, 64).permute(2, 0, 3, 1, 4).unbind(0)
            for layout, (q, k, v) in (("contiguous", [t.contiguous() for t in views]),
                                      ("views", views)):
                got = K2(q, k, v, scale)
                torch.cuda.synchronize()
                if got.shape != q.shape or got.dtype != dt or not got.transpose(1, 2).is_contiguous():
                    fail(f"K2 output {tuple(got.shape)} {got.dtype} strides {got.stride()}")
                errs.append(check_close(f"{str(dt)[6:]} N={N} {layout}", got,
                                        plain(q, k, v, scale), *tols[dt]))
            del qkv, views, q, k, v, got

    # -- 8. the depth path: ViT-L through generate() ------------------------
    t = time.time()
    model = load_model(None, "vitl", 20.0, DEPTH_SIZE, device=dev)
    torch.cuda.synchronize()
    print(f"[depth model] DepthAnythingV2 vitl (1024 wide, 24 blocks, 16 heads, DPT 256), "
          f"{DEPTH_SIZE} px, {next(model.parameters()).dtype}, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
          f"built in {time.time() - t:.1f} s")
    captured = []
    blk = 11
    attn = model.pretrained.blocks[blk].attn

    def grab_qkv(mod, inputs, out):
        if not captured:
            captured.append(out.clone())
    hook = attn.qkv.register_forward_hook(grab_qkv)
    records = synthetic.make_dataset(DEPTH_IMAGES)
    out_dir = tempfile.mkdtemp(prefix="depth_maps_")
    roi_align_cuda.multilevel_roi_align.launches = K2.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    generate(records, out_dir, batch_size=DEPTH_BATCH,
             image_loader=lambda r: synthetic.render_image(r["_scene"]), model=model)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    k2_launches = K2.launches
    hook.remove()
    n_fwd = -(-DEPTH_IMAGES // DEPTH_BATCH)
    depth_blocks = len(model.pretrained.blocks)
    if k2_launches != depth_blocks * n_fwd:
        fail(f"K2 launched {k2_launches} times in {n_fwd} forwards, expected "
             f"{depth_blocks} per forward")
    stds = []
    for r in records:
        path = os.path.join(out_dir, f"{r['image_id']}.npz")
        if not os.path.exists(path):
            fail(f"generate() wrote no {path}")
        with np.load(path) as z:
            d = z["depth"]
        if d.shape != (r["height"], r["width"]) or d.dtype != np.float16:
            fail(f"{path}: depth {d.shape} {d.dtype}, expected "
                 f"({r['height']}, {r['width']}) float16")
        if not np.isfinite(d).all() or d.min() < 0 or d.max() > 20:
            fail(f"{path}: depth not finite or outside [0, 20] m")
        stds.append(float(d.astype(np.float32).std()))
    shutil.rmtree(out_dir)
    if min(stds) <= 1e-3:
        fail(f"degenerate depth maps (least std {min(stds):.2e} m)")
    print(f"[depth] generate(): {len(records)} maps of {records[0]['height']}x"
          f"{records[0]['width']} float16 in {gen_s:.3f} s ({len(records) / gen_s:.2f} "
          f"images/s end to end, synthetic rendering and npz writes included); depth std "
          f"{min(stds):.4f}-{max(stds):.4f} m; K2 launches {k2_launches} "
          f"({depth_blocks} per forward)")
    B_, N_, _ = captured[0].shape
    views = captured[0].reshape(B_, N_, 3, attn.heads, -1).permute(2, 0, 3, 1, 4).unbind(0)
    q, k, v = (t.contiguous() for t in views)
    print(f"[compare] K2 vs plain on block {blk}'s own q, k, v of that run "
          f"({tuple(q.shape)} {q.dtype}), as contiguous copies and as the projection's views")
    errs.append(check_close(f"block {blk} contiguous", K2(q, k, v, scale),
                            plain(q, k, v, scale), *tols[q.dtype]))
    errs.append(check_close(f"block {blk} views", K2(*views, scale), plain(q, k, v, scale),
                            *tols[q.dtype]))

    # a small float32 ViT-S on the card against the same model on the CPU
    for size in (98, 196):
        m_gpu = load_model(None, "vits", 20.0, size, device=dev, dtype=torch.float32)
        m_cpu = load_model(None, "vits", 20.0, size, device="cpu", dtype=torch.float32)
        x = torch.from_numpy(np.random.default_rng(size).normal(
            size=(2, size, size, 3)).astype(np.float32))
        with torch.inference_mode():
            d_gpu, d_cpu = m_gpu(x.to(dev)).cpu(), m_cpu(x)
        err = (d_gpu - d_cpu).abs().max().item()
        # float32 with TF32 off: cuDNN's, cuBLAS's and K2's sums run in
        # another order than the CPU's
        if not err <= 1e-3 or not float(d_cpu.std()) > 1e-3:
            fail(f"small depth model at {size} px: card vs CPU max |err| {err} m "
                 f"(tolerance 1e-3), CPU depth std {float(d_cpu.std())}")
        print(f"[reference] small float32 ViT-S at {size} px (N = {(size // 14) ** 2 + 1}), "
              f"card vs CPU: max |err| {err:.3e} m (atol 1e-3)")

    # -- 9. timing ------------------------------------------------------------
    batch = torch.randn((DEPTH_BATCH, DEPTH_SIZE, DEPTH_SIZE, 3), generator=gen, device=dev)
    times = []
    with torch.inference_mode():
        for _ in range(4):  # one warm-up + 3 timed
            torch.cuda.synchronize()
            t = time.perf_counter()
            model(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    fwd_ms = statistics.median(times[1:])
    print(f"[timing] depth forward B{DEPTH_BATCH} @ {DEPTH_SIZE} px: median {fwd_ms:.3f} ms "
          f"over {len(times) - 1} (each {', '.join(f'{x:.3f}' for x in times)} ms, first is "
          f"the warm-up), {DEPTH_BATCH * 1e3 / fwd_ms:.2f} images/s")
    # K2 and the library call in turns (the card's clock drifts within a run),
    # five rounds of 20 launches each; the medians are reported
    calls = {"K2": lambda: K2(q, k, v, scale), "K2 views": lambda: K2(*views, scale),
             "library": lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)}
    rounds = {name: [] for name in calls}
    for r in range(5):
        for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            rounds[name].append(timed_ms(calls[name], 20))
    ms, views_ms, lib_ms = (statistics.median(rounds[n]) for n in calls)
    print("[timing] rounds (ms per launch): " + "; ".join(
        f"{n} {' '.join(f'{x:.4f}' for x in v)}" for n, v in rounds.items()))
    plain_ms = timed_ms(lambda: plain(q, k, v, scale), 3, warmup=1)
    lib_err = (F.scaled_dot_product_attention(q, k, v, scale=scale).float()
               - plain(q, k, v, scale).float()).abs().max().item()
    bound, by, flops, nbytes, n_exp, sfu_ms = attention_bound(q)
    print(f"[timing] K2 at {tuple(q.shape)} {q.dtype}: {ms:.4f} ms per launch on contiguous "
          f"q, k, v, {views_ms:.4f} ms on the projection's views (medians; bound {bound:.4f} ms by {by}: "
          f"{flops:.3e} FLOP, {nbytes:.3e} bytes; {100 * bound / ms:.1f}% of the bound; beside "
          f"it {n_exp:.3e} exponentials, {sfu_ms:.4f} ms on the SFU), {flops / ms / 1e9:.1f} "
          f"TFLOP/s; plain {plain_ms:.3f} ms; library (F.scaled_dot_product_attention, a "
          f"yardstick the port never calls) {lib_ms:.4f} ms (median), max |err| vs plain "
          f"{lib_err:.3e}")
    print(f"[timing] K2 per depth forward: {depth_blocks} launches, "
          f"{depth_blocks * views_ms:.3f} ms of the {fwd_ms:.3f} ms forward "
          f"(bound {depth_blocks * bound:.3f} ms)")
    n_copies = profile_forward(model, batch)
    if n_copies is not None and n_copies > 28:
        fail(f"the depth forward launched {n_copies} layout copies, expected at most 28 "
             "(no q, k, v or output copies around K2)")
    return {"name": "flash_attention (non-causal attention fwd), per launch at "
                    f"{'x'.join(map(str, q.shape))} {str(q.dtype)[6:]}",
            "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
            "launches": k2_launches, "max_abs_err": max(errs), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA device")
    sys.path.insert(0, HERE)
    try:
        from weakcube_tpu_torch.entry import (dims_priors, flagship_cfg, make_batch,
                                              tiny_cfg)
        from weakcube_tpu_torch.models.rcnn3d import build_model
        from weakcube_tpu_torch.models.roi_heads import FPN_STRIDES
        from weakcube_tpu_torch.ops import flash_attention_cuda, roi_align_cuda
    except ImportError as e:
        fail(f"the weakcube_tpu_torch package is not beside this script: {e}")
    # every float32 comparison below runs in full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()

    # -- 1. the card ------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi unavailable (rc {smi.returncode})"
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # -- 2. build K1 and K2, one nvcc each, in parallel ---------------------
    t = time.time()
    with ThreadPoolExecutor(2) as pool:
        builds = [(name, mod, pool.submit(mod.build))
                  for name, mod in (("K1", roi_align_cuda), ("K2", flash_attention_cuda))]
        for name, mod, fut in builds:
            lib_path = fut.result()
            print(f"[build] {name} {os.path.relpath(lib_path, HERE)} "
                  f"(both built in {time.time() - t:.1f} s)")
            for line in mod.build_log.splitlines():
                if any(w in line for w in ("registers", "spill", "Compiling entry", "C75")):
                    print(f"  ptxas: {line.strip()}")

    # -- 3. K1 against its plain version at the main path's shapes ---------
    gen = torch.Generator(device=dev).manual_seed(0)
    B, C, size = 8, 256, 512
    K1 = roi_align_cuda.multilevel_roi_align
    plain = roi_align_cuda.plain
    max_err = {}
    print("[compare] K1 vs plain, synthetic pyramid, edge-case boxes")
    for dt in (torch.float32, torch.bfloat16):
        levels = [torch.randn((B, size // s, size // s, C), generator=gen, device=dev).to(dt)
                  for s in FPN_STRIDES]
        for R in (1000, 100):
            boxes = edge_boxes(B, R, size, gen, dev)
            got = K1(levels, boxes, FPN_STRIDES, 7, 2)
            torch.cuda.synchronize()
            want = plain(levels, boxes, FPN_STRIDES, 7, 2)
            if got.shape != (B, R, 7, 7, C) or got.dtype != dt:
                fail(f"K1 output {tuple(got.shape)} {got.dtype}")
            # float32: same arithmetic, other summation order; bfloat16: both
            # round one float32 sum to bf16 (8 mantissa bits), so they differ
            # by at most one bf16 step of the value
            tol = (2e-5, 1e-5) if dt == torch.float32 else (1e-2, 1e-2)
            max_err[(dt, R)] = check_close(f"{str(dt)[6:]} R={R}", got, want, *tol)

    # -- 4. the flagship forward, full width ------------------------------
    cfg = flagship_cfg(512)
    ncls = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    t = time.time()
    model = build_model(cfg, dims_priors(ncls), device="cuda", seed=0)
    batch = make_batch(8, 512, 512, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[model] {cfg.MODEL.META_ARCHITECTURE} / {cfg.MODEL.ROI_HEADS.NAME} "
          f"{cfg.MODEL.DLA.TYPE} FPN {cfg.MODEL.FPN.OUT_CHANNELS}, {ncls} classes, "
          f"compute {cfg.TPU.COMPUTE_DTYPE}, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
          f"built in {time.time() - t:.1f} s")
    n_fwd = 4  # one warm-up + 3 timed
    K1.launches = flash_attention_cuda.flash_attention.launches = 0
    times = []
    with torch.inference_mode():
        for i in range(n_fwd):
            torch.cuda.synchronize()
            t = time.perf_counter()
            det = model(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    launches = K1.launches

    # -- 5. outputs -------------------------------------------------------
    D = cfg.TEST.DETECTIONS_PER_IMAGE
    for name, x, shape in (("boxes", det.boxes, (8, D, 4)), ("scores3D", det.scores3D, (8, D)),
                           ("centers3D", det.centers3D, (8, D, 3)),
                           ("dims3D", det.dims3D, (8, D, 3)),
                           ("poses3D", det.poses3D, (8, D, 3, 3))):
        if tuple(x.shape) != shape:
            fail(f"det.{name} has shape {tuple(x.shape)}, expected {shape}")
        if not bool(torch.isfinite(x).all()):
            fail(f"det.{name} has non-finite values")
    n_valid = int(det.valid.sum())
    if n_valid == 0:
        fail("no valid detections")
    if launches != 2 * n_fwd:
        fail(f"K1 launched {launches} times in {n_fwd} forwards, expected {2 * n_fwd}")
    print(f"[forward] {n_fwd} forwards: K1 launches {launches} (2 per forward), "
          f"{n_valid} valid detections in the last")

    # the forward's own pooler inputs: pyramid, proposals, detections
    with torch.inference_mode():
        feats = model.backbone(model._prep_image(batch["image"]))
        props = model._proposals_from_feats(feats, batch)
        det2d, _ = model.roi_heads.forward_box_inference(feats, props, batch["image_wh"])
    levels = [feats[f] for f in cfg.MODEL.ROI_HEADS.IN_FEATURES]
    sr = cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO or 2
    res_box, res_cube = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION, cfg.MODEL.ROI_CUBE_HEAD.POOLER_RESOLUTION
    calls = [("box pooler", props.boxes.contiguous(), res_box),
             ("cube pooler", model.roi_heads._scale_boxes(det2d.boxes).float().contiguous(),
              res_cube)]
    print("[compare] K1 vs plain on the forward's pyramid and boxes "
          f"({levels[0].dtype}, levels {[tuple(f.shape[1:3]) for f in levels]})")
    for name, bx, res in calls:
        got = K1(levels, bx, FPN_STRIDES, res, sr)
        want = plain(levels, bx, FPN_STRIDES, res, sr)
        tol = (1e-2, 1e-2) if levels[0].dtype == torch.bfloat16 else (2e-5, 1e-5)
        check_close(f"{name} R={bx.shape[1]}", got, want, *tol)

    # a small float32 model on the card against the same model on the CPU
    small = tiny_cfg(image_size=128, dla=True)
    pri = dims_priors(small.MODEL.ROI_HEADS.NUM_CLASSES)
    m_gpu = build_model(small, pri, device="cuda", seed=1)
    m_cpu = build_model(small, pri, device="cpu", seed=1)
    b_cpu = make_batch(2, 128, 128, seed=3, device="cpu")
    b_gpu = {k: v.to(dev) for k, v in b_cpu.items()}
    with torch.inference_mode():
        d_gpu, d_cpu = m_gpu(b_gpu), m_cpu(b_cpu)
    n_match = 0
    for i in range(d_cpu.valid.shape[0]):
        vg, vc = d_gpu.valid[i].cpu(), d_cpu.valid[i]
        if int(vg.sum()) != int(vc.sum()):
            fail(f"small model, image {i}: {int(vg.sum())} valid detections on the "
                 f"card, {int(vc.sum())} on the CPU")
        # the same detections, matched as sets (near-equal scores may swap slots)
        j = match_detections(d_cpu, d_gpu, i)
        for name in ("boxes", "scores3D", "centers3D"):
            a = getattr(d_gpu, name)[i].cpu()[vg][j]
            b = getattr(d_cpu, name)[i][vc]
            # float32 with TF32 off: cuDNN's and the CPU's sums differ in order
            try:
                torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)
            except AssertionError as e:
                fail(f"small model: det.{name} differs between the card and the CPU: {e}")
        n_match += len(j)
    if n_match == 0:
        fail("small model: no valid detections to compare")
    print(f"[reference] small float32 model, card vs CPU: {n_match} valid "
          "detections agree (atol 1e-3, rtol 1e-3)")

    # -- 6. timing ----------------------------------------------------------
    fwd_ms = statistics.median(times[1:])
    print(f"[timing] forward b8 @ 512 px: median {fwd_ms:.3f} ms over {len(times) - 1} "
          f"(each {', '.join(f'{x:.3f}' for x in times)} ms, first is the warm-up), "
          f"{8e3 / fwd_ms:.1f} images/s")
    # K1 and the library yardstick in turns, five rounds each; the medians
    # are reported
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "whole_bound_ms": 0.0}
    bound_by = None
    for name, bx, res in calls:
        lib = library_roi_align(levels, bx, FPN_STRIDES, res, sr)
        turns = {"K1": (lambda: K1(levels, bx, FPN_STRIDES, res, sr), 20), "library": (lib, 3)}
        rounds = {k: [] for k in turns}
        for r in range(5):
            for k in (list(turns) if r % 2 == 0 else list(turns)[::-1]):
                rounds[k].append(timed_ms(turns[k][0], turns[k][1], warmup=1))
        ev_ms, lib_ms = statistics.median(rounds["K1"]), statistics.median(rounds["library"])
        ms = kernel_device_ms(turns["K1"][0], 20)  # the kernel, not the host
        plain_ms = timed_ms(lambda: plain(levels, bx, FPN_STRIDES, res, sr), 3, warmup=1)
        lib_err = (lib().float() - plain(levels, bx, FPN_STRIDES, res, sr).float()).abs().max().item()
        bd = roi_align_bound(levels, bx, FPN_STRIDES, res, sr)
        (bound, by), (whole, _) = bd["touched"], bd["whole"]
        bound_by = bound_by or by
        for k, x in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound), ("library_ms", lib_ms),
                     ("whole_bound_ms", whole)):
            tot[k] += x
        print(f"[timing] K1 {name} R={bx.shape[1]}: {ms:.4f} ms of device time per launch "
              f"(20 launches queued behind a sleep kernel); {ev_ms:.4f} ms per call by CUDA "
              f"events (median; rounds "
              f"{' '.join(f'{x:.4f}' for x in rounds['K1'])}); bound {bound:.4f} ms by {by} over "
              f"the touched pixels ({bd['touched_bytes']:.4e} B; {100 * bound / ms:.1f}% of it), "
              f"{whole:.4f} ms over the whole pyramid ({100 * whole / ms:.1f}%); staged L2->SM "
              f"{bd['staged_bytes']:.4e} B; plain {plain_ms:.3f} ms; library {lib_ms:.3f} ms "
              f"(median; rounds {' '.join(f'{x:.3f}' for x in rounds['library'])}; max |err| vs "
              f"plain {lib_err:.3e})")
    print(f"[timing] K1 per forward (box + cube pooler): {tot['ms']:.4f} ms, bound "
          f"{tot['bound_ms']:.4f} ms over the touched pixels, {tot['whole_bound_ms']:.4f} ms over "
          "the whole pyramid")
    # the box pooler's count of other RoIs on the forward's pyramid, checked
    # and timed the same way: real-size RoIs (p3-p5 windows of 225-784
    # pixels), and sub-pixel RoIs at one spot (every read a cache hit: what
    # is left is the kernel's instruction issue)
    other = {"p3-p5 squares": large_boxes(8, 1000, 512, torch.Generator(device=dev).manual_seed(2),
                                          dev),
             "sub-pixel RoIs at one spot": torch.tensor([100.0, 100.0, 100.3, 100.3],
                                                        device=dev).expand(8, 1000, 4).contiguous()}
    for name, bx in other.items():
        fp = roi_align_cuda.footprint(levels, bx, FPN_STRIDES, res_box, sr)
        lv = fp["levels"].flatten().tolist()
        px = (fp["ny"] * fp["nx"]).float()
        check_close(f"{name} R={bx.shape[1]}", K1(levels, bx, FPN_STRIDES, res_box, sr),
                    plain(levels, bx, FPN_STRIDES, res_box, sr), *tol)
        call = lambda: K1(levels, bx, FPN_STRIDES, res_box, sr)
        ev_ms = statistics.median(timed_ms(call, 20, warmup=1) for _ in range(5))
        ms = kernel_device_ms(call, 20)
        bd = roi_align_bound(levels, bx, FPN_STRIDES, res_box, sr)
        print(f"[timing] K1 on {name} R={bx.shape[1]} (RoIs per level p2..p6 "
              f"{[lv.count(l) for l in range(2, 7)]}; staged pixels per RoI: mean "
              f"{px.mean():.1f}, max {px.max():.0f}): {ms:.4f} ms of device time per launch; "
              f"{ev_ms:.4f} ms per call by CUDA events (median of 5); bound {bd['touched'][0]:.4f} "
              f"ms by {bd['touched'][1]} over the touched pixels ({bd['touched_bytes']:.4e} B), "
              f"{bd['whole'][0]:.4f} ms over the whole pyramid; staged L2->SM "
              f"{bd['staged_bytes']:.4e} B")
    profile_forward(model, batch)
    del model, feats, levels, calls, det, det2d, props
    torch.cuda.empty_cache()

    # -- 7.-9. K2 and the depth pseudo-GT path -------------------------------
    k2 = depth_phases(dev)
    print(f"[done] total run {time.time() - t_start:.1f} s")

    # -- 10. result lines ---------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "multilevel_roi_align (ROIAlignV2 fwd), box + cube pooler per forward",
        "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches, "max_abs_err": max(max_err.values()),
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": bound_by, "library_ms": tot["library_ms"]}, k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
