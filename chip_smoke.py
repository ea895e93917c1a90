"""The PyTorch port's correctness check on one NVIDIA GPU.

    python3 chip_smoke.py

Every phase checks the port on the card (against its plain versions, the
CPU, launch and sync counts, bit identity) and fails the run (non-zero
exit) when a check fails. Beside the checks it times each kernel alone
(`kernel_device_ms`: the device's time per call, the host's enqueue hidden
behind a sleep kernel) next to the least time of the benchmark's frozen
yardstick (benchmark/harness/bounds.py and k2_bound.py), and the paths that
no benchmark cell measures yet (the CLIs, the mapper, the evaluator, the
ground pseudo-GT pipeline, data-parallel NCCL; each names the ROADMAP.md
Queue F item whose cell will replace it). End-to-end timings of what a cell
measures (the b8 detection forward, the depth forward, the b25 training
step), profiles and library yardsticks are the benchmark's
(benchmark/run.py).

Phases, in the order they run:
  1. print the card's name and power limit (nvidia-smi);
  2. build the ROIAlign (K1 and K1-bwd, one source), flash-attention (K2),
     NMS, BatchNorm and bilinear resize CUDA kernels from
     weakcube_tpu_torch/csrc, one nvcc each, and the evaluator's greedy
     matcher (host C++, g++), in parallel;
  3. hold K1 against its plain PyTorch version at the main path's shapes
     (b8, levels 128^2..8^2 x 256, R = 1000 and 100), with edge-case boxes
     (past the borders, sub-pixel, elongated, hugging a border, empty,
     huge), in float32 and bfloat16;
 3b. K1's open fault: tests/test_torch_cuda.py::
     test_kernel_many_rois_per_block's seeds, dtypes and box mixes, 50
     launches each (300), every launch bit-identical to the first and within
     tolerance of the plain version; on a mismatch the RoI, its level,
     staged lines, persistent block and channel chunk;
 3c. compute-sanitizer racecheck on one such K1 launch where the host has
     the tool (a hazard fails the run);
 32. the NMS kernel (csrc/nms.cu) at the cells' shapes: the RPN's 125 x
     2000 (b25 x 5 levels, p5 / p6 padded) and 40 x 1000, and the box NMS's
     8 x 1024 with 38 classes through batched_nms_mask, boxes drawn as
     near-duplicates with bf16-tied scores (tests/torch_nms_boxes.py): the
     keep mask held bit for bit to the plain fixed point on the same CUDA
     tensors, and the kernel launched alone to nms_mask's; the kernel's
     and the whole nms_mask call's device time, beside the bytes nms_mask
     needs over HBM bandwidth;
 33. BatchNorm's training kernels (csrc/batch_norm.cu) on the 39 BatchNorm
     calls of the b25 step at 512 px (DLA-34; 37 with a gradient, 2
     without): each input channels_last, the kernels' launches per call, y
     and dx against the plain chain on the same tensors; the kernels' device
     ms forward and backward beside the least bytes the function needs (x
     read and y written forward; g and x read and dx written backward) over
     HBM bandwidth; the kernels' launches a step, which phase 12 checks;
  4. build the full-width flagship model (configs/Omni_combined.yaml:
     DLA-34 + FPN 256, 38 classes, bf16 compute) with random weights from a
     seed, and run 4 forwards of 8 images at 512 px;
  5. check the outputs (shapes, finite values, K1 and NMS launched exactly
     twice per forward) and hold K1 against the plain version on the
     forward's own pyramid and boxes; check a small float32 model on the
     card against the same model on the CPU;
  6. K1's device time per launch on the forward's two pooler calls beside
     its bound (bounds.roi_align_bound_s: the pixels the boxes touch); K1
     on as many real-size RoIs (p3-p5 squares of 14-28 feature units) and
     on sub-pixel RoIs at one spot (every read a cache hit), checked and
     timed the same way;
 10. hold K1-bwd (the feature gradient of K1) against its plain version (the
     explicit scatter), float32 and bfloat16, on the forward checks' box
     sets (edge cases, p3-p5 squares, tests/torch_roi_boxes.py), the
     detection forward's own pyramid and proposals, and no RoIs; a second
     launch on the same inputs must give the same bits;
 34. the DPT head's bilinear resize kernel (csrc/bilinear_resize.cu) at the
     depth cell's five resizes (b16, bf16: 19^2 -> 37^2, 37 -> 74, 74 -> 148
     and 148 -> 296 at C = 256, 296 -> 518 at C = 128) held to ATen's
     F.interpolate on the same tensors bit for bit (at most one bf16 ulp
     apart, else the run fails), a second launch giving the same bits; its
     device time per launch beside the bytes the resize needs (input read
     once, output written once) over HBM bandwidth;
  7. hold K2 against its plain PyTorch version at B16 H16 d64 with
     N = 1, 50, 63, 64, 65, 127, 128, 129, 197 and 1370 (the tile edges and
     ragged tiles), in bfloat16 and float32, on contiguous q, k, v and on
     the views of a fused (B, N, 3, H, 64) projection that the encoder
     passes;
  8. the depth pseudo-GT path at full width: Depth Anything V2 ViT-L
     (random weights from a seed) at 518 px through
     data/generate_depth_maps.py::generate() on 32 synthetic 640x480 images
     (two batches of 16); check the 32 depth maps and that K2 launched 24
     times per forward and the DPT head's resize kernel 5; hold K2 against
     the plain version on one block's own q, k, v from that run (contiguous
     copies and the projection's own views); a small float32 ViT-S on the
     card against the CPU at 98 and 196 px; the maps stay for phase 29;
  9. K2's device time per launch on block 11's q, k, v (contiguous and the
     projection's views) beside its bound (k2_bound.flash_attention_bound_s);
     one B16 depth forward under the profiler launches at most 28 layout
     copies (no q, k, v or output copies around K2);
 35. K2 with SAM's decomposed relative-position bias at the SAM cell's
     shapes (b8 at 1024 px, bf16, the views of a fused qkv projection):
     windowed, B 200 H 16 N 196 (14 x 14), and global, B 8 H 16 N 4096
     (64 x 64), held to the plain version on a slice, a second launch
     giving the same bits, the device time per launch beside its bound
     (k2_relpos_bound.flash_attention_relpos_bound_s);
 29. the recipe's ground pseudo-GT pipeline from phase 8's depth maps
     (re-generated if gone): (a) depth-ransac ground maps on the card
     (data/generate_ground_segmentations.py), their IoU with each scene's
     true ground (ops/boxes.py::mask_iou), and the same on the scenes'
     analytic depth; card vs CPU on 4 maps with the same injected draws
     (equal masks); (b) the foundation method at full width with random
     weights (GroundingDINO Swin-T OGC: BERT-base, 6 + 6 layers, 900
     queries, 768 px; SAM-HQ vit_l at 1024 px; bf16; box_threshold -1):
     every .npz a bool map of the image's shape, the CSV written; ms per
     image of each model and of the path, peak memory; (c) small float32
     GroundingDINO (1 + 2 layers, 16 queries, 112 px) and SAM vit_tiny (256
     px), card vs CPU within 1e-3 of scale, the same top-k proposals; (d)
     filter_ground, the priors CLI, the dataset loader (ground_image_path
     only outside no_ground_idx.csv) and one mapper batch with finite
     cached ground normals from the written maps;
 11. the small float32 training step on the card against the CPU with the
     same injected anchor labels and RoIs (tests/torch_train_check.py), and
     the ROI heads' gradient reaching the FPN through K1-bwd;
 12. the full-width weak training step (configs/Omni_combined.yaml, 38
     classes, bf16, batch 25 of tiny_batch at 512 px with 16 GT rows) through
     create_train_state + train_step: 6 steps, every loss finite, every
     update applied, K1 and K1-bwd launched twice per step, NMS once, and
     BatchNorm's kernels 4 times per layer with a gradient and twice per
     layer without (phase 33's count of the step's calls: 152 a step); peak
     memory;
 13. K1 and K1-bwd held to their plain versions on that step's own
     pyramid, boxes and gradients (box pooler R = 512, cube pooler R = 128
     per image), K1-bwd's second launch bitwise equal to its first, and
     each K1-bwd call launching its kernel and nothing else (profiler);
     K1-bwd's device time per call on them beside its bound
     (bounds.roi_align_bwd_bound_s: g read, the level gradients written
     once);
 25. the supervised Cube R-CNN step at full width
     (configs/cubercnn_DLA34_FPN.yaml: RCNN3D + ROIHeads3D, DLA-34, 38
     classes, bf16), b25 of tiny_batch at 512 px with GT rotations drawn at
     random: 6 steps, every loss finite, K1 and K1-bwd launched twice per
     step and held to their plain versions on a step's own inputs; ms per
     step, peak memory; the same step with LOSS_W_3D 0 (the recipe's
     2D-only pretrain): once per step;
 26. the weak step with every loss at full width (the default
     loss_functions, iou and segmentation; 64 x 64 per-GT masks filled from
     the GT boxes), checked and timed as 25, every new loss logged;
 27. the small float32 supervised and all-loss steps on the card against
     the CPU with injected anchor labels and RoIs (tests/torch_train_check.py);
 30. the backbone sweep: configs/cubercnn_ResNet34_FPN.yaml,
     cubercnn_shufflenet_FPN.yaml, cubercnn_mnasnet_FPN.yaml and
     cubercnn_densenet_FPN.yaml at full width (RCNN3D + ROIHeads3D, 38
     classes, bf16, 512 px, random weights from seed 0), the card freed
     between configs: (a) detection at b8, median of 3 forwards after a
     warm-up, K1 twice per forward and held to its plain version on a
     forward's own pyramid and boxes; (b) the supervised step at b25 as
     phase 25, K1 and K1-bwd 2 + 2 per step and held to their plain
     versions; ms per step, images/s, peak memory; (c) the small float32
     supervised step of ResNet-18 (tiny_cfg(128)) with SOLVER.TYPE
     adam+amsgrad, card vs CPU as phase 27, the parameters after the update
     held to the same Adam update applied on the CPU to the card's
     gradients; (d) the ResNet-34 model written as a released detectron2
     .pth (fc1 columns in (C, 7, 7) order) and loaded through MODEL.WEIGHTS
     into a fresh model: the same tensors and detections;
 23. DP-step: two data-parallel ranks over gloo, both on this card, b4 each
     of a global b8, the full-width flagship in float32 (TF32 off, cuDNN
     deterministic), against one process on the b8 with the same weights,
     step generators and samples, after steps 1 and 3: every log, the skip
     decision, every parameter and BatchNorm statistic, within three times
     the one-process run's own difference when its rows are reordered or
     its convolutions run without cuDNN (the same sums in another order): a
     tensor's own or, where larger, its group's median share of its change
     from the initial weights, and a log's step's largest share of its
     value; each rank's Gumbel draws are its rows of the global draw, the
     replicas hold the same bits, and each rank launches K1 and K1-bwd twice
     per step, holds them to their plain versions on its own inputs and
     times them;
 15. the train CLI at full width (weakcube_tpu_torch/tools/train_net.py:
     configs/Omni_combined.yaml, 50 synthetic scenes, b25 @ 512 px, bf16,
     cached ground normals): 6 iterations with a checkpoint at 4, then
     --resume to 8 from model_recent (iteration 4); K1 and K1-bwd launched
     twice per step, metrics.json written; steps/s, data and step time per
     iteration, the mapper alone, Cube/IoU3D of step 0;
 16. one full-width step on the mapper's batch without cached normals: the
     RANSAC ground planes on the card against the SVD fit of the same
     canvases (|cos| > 0.995; the mapper's cached normals reported beside);
     K1 and K1-bwd checked and timed on that step's pooler inputs;
 17. exact IoU3D on 25 x 128 cube pairs, card vs CPU (atol 1e-5);
 18. RANSAC on 25 tilted noisy ground clouds with 1000 injected draws, card
     vs CPU (inlier counts within 0.1%, planes within 1e-5 where the same
     hypothesis wins, else |cos| > 0.9999);
 31. the ops layer's last public functions, on the card and on the CPU:
     convert_3d_box_to_2d and get_cuboid_verts on phase 4's b8 detections
     (800 cubes, K per image) and on the GT cubes of
     tiny_batch(25, 512, 512, G=16), as they are and 4 m nearer (in front
     of, straddling and behind the camera); R_to_allocentric at each cube's
     projected centre, round-tripped through R_from_allocentric;
     matrix_to_rotation_6d and matrix_to_quaternion on the poses,
     round-tripped; mask_iou of phase 29's 64 depth-ransac ground maps
     (K2's and the analytic depth's) against the scenes' true ground;
     uniform_topk_mask on the card's generator (its count, validity and
     seed); card vs CPU within 1e-5 of scale, equal flags and masks;
 19. the eval CLI at full width (tools/eval_net.py --synthetic 64
     --eval-only) on phase 15's checkpoint: 38 classes, 512 px, bf16, two
     batches of 32; every scene counted once, K1 launched twice per batch;
     the APs, images/s end to end and at steady state, the data /
     inference / records ms per batch, the evaluator's seconds, peak memory;
 20. K1 at an eval batch's shapes (b32, R = 1000 and 100, from phase 15's
     checkpoint): held to its plain version, its device time beside its
     bound;
 21. phase 19's records through the evaluator with IoU3D on the card and on
     the CPU: the same AP within 1e-9, seconds per image on each;
 22. the demo (tools/demo.py) on four rendered PNGs, four JPEGs; the train
     CLI resumed for two iterations with TEST.EVAL_PERIOD and VIS_PERIOD:
     one evaluation of the live model, the two vis JPEGs;
 28. the published recipe through the train CLI at full width on 50
     synthetic scenes: configs/Base_Omni3D_2D_only.yaml for 4 iterations (K1
     and K1-bwd once per step, no Cube/ key), then configs/Omni_combined.yaml
     warm-started from its model_final by MODEL.WEIGHTS_PRETRAIN for 4
     (twice per step); steps/s of each;
 24. DP-CLI, only where 2 or more cards are visible (else one line says it
     was not run): the train CLI data-parallel over W = 1, 2, 4, ... cards
     up to all (NCCL, 25 images per card): 6 iterations with a checkpoint
     at 4, --resume to 8 under the profiler (rank 0's NCCL kernels per step
     by kind), images/s, each rank's data, step and mapper ms; the eval CLI
     sharded over all cards on that checkpoint;
 14. print the kernels line (K1, K1-bwd, K2, NMS, BN, the resize, K2 with the
     bias: their launches on every path above, each counted from 0 before
     it, their largest errors, device ms and bounds) and, last, {"ok": true,
     "device": {...}}.

The CLI phases before 24 run one process (TPU.MESH_SHAPE [1]), so that the
script does the same on a machine with several cards.

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
# the benchmark's frozen yardstick, harness/bounds.py and k2_bound.py, is
# imported as `harness` from here, as benchmark/run.py does
BENCH_DIR = os.path.join(HERE, "benchmark")

K1_REPLACES = "weakcube_tpu/ops/roi_align_pallas.py:198"
K1_SOURCE = "weakcube_tpu_torch/csrc/roi_align.cu"
K1_BWD_REPLACES = "weakcube_tpu/ops/roi_align.py:403"
K2_REPLACES = "weakcube_tpu/data/pseudo_gt/depth_anything_v2.py:37"
K2_SOURCE = "weakcube_tpu_torch/csrc/flash_attention.cu"
NMS_REPLACES = "weakcube_tpu/ops/nms.py:21 (an XLA while_loop, no Pallas kernel)"
NMS_SOURCE = "weakcube_tpu_torch/csrc/nms.cu"
BN_REPLACES = ("none: flax's BatchNorm in weakcube_tpu/models/backbone is XLA; the port's "
               "plain chain is models/layers.py::BatchNorm2d")
BN_SOURCE = "weakcube_tpu_torch/csrc/batch_norm.cu"
RESIZE_REPLACES = ("none: the JAX package's `_resize` (weakcube_tpu/data/pseudo_gt/"
                   "depth_anything_v2.py:235) is two XLA matrix products; the port's head "
                   "called ATen's upsample_bilinear2d")
RESIZE_SOURCE = "weakcube_tpu_torch/csrc/bilinear_resize.cu"
K2_RELPOS_REPLACES = ("none: the JAX package's SAM (weakcube_tpu/data/pseudo_gt/sam.py:73) "
                      "adds the bias to einsum logits in XLA; the port's SAM did the same")
# (name, B, key grid side, launches per b8 request) of SAM-HQ ViT-L's
# attention at 1024 px: 25 windows an image, 20 windowed and 4 global blocks
SAM_ATTENTION = (("windowed", 8 * 25, 14, 20), ("global", 8, 64, 4))
SAM_HEADS = 16
# (C, side in, side out) of the DPT head's resizes at ViT-L, 518 px
DPT_RESIZES = ((256, 19, 37), (256, 37, 74), (256, 74, 148), (256, 148, 296), (128, 296, 518))
DEPTH_BATCH, DEPTH_SIZE, DEPTH_IMAGES = 16, 518, 32
TRAIN_BATCH, TRAIN_SIZE, TRAIN_GT, TRAIN_STEPS = 25, 512, 16, 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def kernel_device_ms(fn, iters: int, sleep_cycles: int = 20_000_000) -> float:
    """Device ms per call of fn, the host's enqueue hidden: a sleep kernel
    of `sleep_cycles` (the default ~10 ms at the H100's clocks) holds the
    stream while the host queues `iters` calls, so the CUDA events around
    them time the device alone. (Events around back-to-back calls time the
    host when a kernel is shorter than its Python wrapper's enqueue.) Fails
    if the queueing outlasted the sleep."""
    import torch
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    torch.cuda._sleep(sleep_cycles)
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


def k1_bound_ms(levels, boxes, strides, out_size: int, sr: int) -> float:
    """The benchmark's least time of one K1 call (harness/bounds.py), in ms."""
    from harness import bounds
    return 1e3 * bounds.roi_align_bound_s([tuple(f.shape) for f in levels],
                                          levels[0].element_size(), boxes, strides, out_size, sr)


def k1_bwd_bound_ms(shapes, dtype, boxes, strides, out_size: int, sr: int) -> float:
    """The benchmark's least time of one K1-bwd call (harness/bounds.py), in
    ms: g read, the boxes read and every level's gradient written once."""
    import torch
    from harness import bounds
    elt = torch.empty((), dtype=dtype).element_size()
    return 1e3 * bounds.roi_align_bwd_bound_s(shapes, elt, boxes, strides, out_size, sr)


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


def layout_copies(fn, arg):
    """The layout-copy kernels (PyTorch's `direct_copy_kernel`, which
    `.contiguous()` and copying reshapes run) that one call of fn(arg)
    launches, counted under torch.profiler; None where the profiler saw no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        fn(arg)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    if not kernels:
        print("[profile] the profiler recorded no device time: layout copies not counted")
        return None
    return sum(e.count for e in kernels if "direct_copy_kernel" in e.key)


def kernels_launched(call, n: int = 5) -> list:
    """The names (template arguments cut) of the kernels that n calls of
    call() launch under torch.profiler, after one call outside it; empty
    where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    return sorted({e.key.removeprefix("void ").split("<")[0].split("(")[0]
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0})


def check_grads(name, got, want, atol, rtol):
    """check_close over the per-level gradients of K1-bwd, laid end to end."""
    import torch
    return check_close(name, torch.cat([g.flatten() for g in got]),
                       torch.cat([w.flatten() for w in want]), atol, rtol)


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


def depth_phases(dev, artifacts_root):
    """Phases 7-9: K2 against its plain version, the depth pseudo-GT path at
    full width, the small depth model card vs CPU, K2's device time and the
    depth forward's layout copies. Returns K2's
    entry of the kernels line and phase 8's run (its records, the
    artifacts_root/depth_maps it wrote, K2's launches), which phase 29
    continues from."""
    import numpy as np
    import torch
    from harness import k2_bound
    from weakcube_tpu_torch.data import synthetic
    from weakcube_tpu_torch.data.generate_depth_maps import generate, load_model
    from weakcube_tpu_torch.ops import bilinear_resize_cuda, flash_attention_cuda, roi_align_cuda

    K2 = flash_attention_cuda.flash_attention
    resize = bilinear_resize_cuda.bilinear_resize
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
    out_dir = os.path.join(artifacts_root, "depth_maps")
    roi_align_cuda.multilevel_roi_align.launches = K2.launches = resize.launches = 0
    generate(records, out_dir, batch_size=DEPTH_BATCH,
             image_loader=lambda r: synthetic.render_image(r["_scene"]), model=model)
    torch.cuda.synchronize()
    k2_launches, resize_launches = K2.launches, resize.launches
    hook.remove()
    n_fwd = -(-DEPTH_IMAGES // DEPTH_BATCH)
    depth_blocks = len(model.pretrained.blocks)
    if k2_launches != depth_blocks * n_fwd:
        fail(f"K2 launched {k2_launches} times in {n_fwd} forwards, expected "
             f"{depth_blocks} per forward")
    if resize_launches != 5 * n_fwd:
        fail(f"the resize kernel launched {resize_launches} times in {n_fwd} forwards, expected "
             "5 per forward (the DPT head's four fusion blocks and its output)")
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
    if min(stds) <= 1e-3:
        fail(f"degenerate depth maps (least std {min(stds):.2e} m)")
    print(f"[depth] generate(): {len(records)} maps of {records[0]['height']}x"
          f"{records[0]['width']} float16; depth std {min(stds):.4f}-{max(stds):.4f} m; K2 "
          f"launches {k2_launches} ({depth_blocks} per forward), resize kernel launches "
          f"{resize_launches} (5 per forward)")
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

    # -- 9. K2's device time; the depth forward's layout copies ---------------
    ms = kernel_device_ms(lambda: K2(q, k, v, scale), 20)
    views_ms = kernel_device_ms(lambda: K2(*views, scale), 20)
    bound = 1e3 * k2_bound.flash_attention_bound_s(*q.shape, q.element_size())
    print(f"[timing] K2 at {tuple(q.shape)} {q.dtype}: {ms:.4f} ms of device time per launch on "
          f"contiguous q, k, v, {views_ms:.4f} ms on the projection's views (20 launches queued "
          f"behind a sleep kernel); bound {bound:.4f} ms ({100 * bound / ms:.1f}% of it)")
    batch = torch.randn((DEPTH_BATCH, DEPTH_SIZE, DEPTH_SIZE, 3), generator=gen, device=dev)
    n_copies = layout_copies(model, batch)
    if n_copies is not None and n_copies > 28:
        fail(f"the depth forward launched {n_copies} layout copies, expected at most 28 "
             "(no q, k, v or output copies around K2)")
    print(f"[depth] one B{DEPTH_BATCH} forward launches {n_copies} layout copies (at most 28)")
    return ({"name": "flash_attention (non-causal attention fwd), per launch at "
                     f"{'x'.join(map(str, q.shape))} {str(q.dtype)[6:]}",
             "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
             "launches": k2_launches, "max_abs_err": max(errs), "ms": ms, "views_ms": views_ms,
             "bound_ms": bound},
            {"records": records, "depth_dir": out_dir, "k2_launches": k2_launches,
             "resize_launches": resize_launches})


PGT_GDINO_SIDE = 768     # GroundingDINO's input square in the pipeline
PGT_SAM_VARIANT = "vit_l"  # the recipe's SAM-HQ (generate_ground_segmentations --sam-variant)


def write_omni3d_json(records, path, categories):
    """The records (data/synthetic.py) as an Omni3D-format JSON, as
    data/datasets.py::load_omni3d_json reads one."""
    import numpy as np
    images, annos = [], []
    for r in records:
        images.append({"id": r["image_id"], "file_path": f"{r['image_id']}.png",
                       "width": r["width"], "height": r["height"], "K": r["K"], "dataset_id": 0})
        for a in r["annotations"]:
            box = [float(v) for v in a["bbox"]]
            annos.append({"image_id": r["image_id"], "category_id": a["category_id"],
                          "bbox2D_tight": box, "bbox2D_proj": box, "bbox2D_trunc": box,
                          "center_cam": [float(v) for v in a["center_cam"]],
                          "dimensions": [float(v) for v in a["dimensions"]],
                          "R_cam": np.asarray(a["pose"]).tolist(), "behind_camera": False,
                          "valid3D": True, "visibility": 1.0, "truncation": 0.0})
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annos,
                   "categories": [{"id": i, "name": n} for i, n in enumerate(categories)]}, f)


def pseudo_gt_phase(dev, depth_run, artifacts_root, card):
    """Phase 29: the recipe's ground pseudo-GT pipeline from phase 8's depth
    maps (the K2 path) to the artefacts training reads: (a) depth-ransac
    ground maps on the card, their IoU with the scenes' true ground, card vs
    CPU on 4 maps with the same draws; (b) foundation maps at full width
    (GroundingDINO Swin-T OGC at 768 px, SAM-HQ vit_l at 1024 px, bf16,
    random weights from seeds), timed, peak memory; (c)
    small float32 GroundingDINO and SAM, card vs CPU; (d) filter_ground,
    the priors CLI, the dataset loader and one mapper batch on the maps.
    Returns K2's launches on this path, and for phase 31 the depth-ransac
    maps of (a), on the K2 depth and on the analytic depth (an empty map
    where none was written), with the true ground, stacked."""
    import numpy as np
    import torch
    from weakcube_tpu_torch.data import datasets as ds
    from weakcube_tpu_torch.data import filter_ground, synthetic
    from weakcube_tpu_torch.data import generate_ground_segmentations as ggs
    from weakcube_tpu_torch.data.build import build_train_batches
    from weakcube_tpu_torch.data.generate_depth_maps import generate as generate_depth
    from weakcube_tpu_torch.data.pseudo_gt import grounding_dino as gd
    from weakcube_tpu_torch.data.pseudo_gt import sam as sam_mod
    from weakcube_tpu_torch.entry import flagship_cfg
    from weakcube_tpu_torch.ops import flash_attention_cuda
    from weakcube_tpu_torch.ops.boxes import mask_iou
    from weakcube_tpu_torch.tools import priors as priors_cli

    K2 = flash_attention_cuda.flash_attention
    records, depth_dir = depth_run["records"], depth_run["depth_dir"]
    k2_launches = 0  # K2's launches beyond phase 8's, were its maps gone
    if not all(os.path.exists(os.path.join(depth_dir, f"{r['image_id']}.npz")) for r in records):
        K2.launches = 0
        generate_depth(records, depth_dir, batch_size=DEPTH_BATCH, device=dev,
                       image_loader=lambda r: synthetic.render_image(r["_scene"]))
        torch.cuda.synchronize()
        k2_launches = K2.launches
        print(f"[pgt] phase 8's depth maps were gone: re-generated, K2 launches {k2_launches}")
    truth = np.stack([synthetic.ground_mask(r["_scene"]) for r in records])

    def read_maps(ground_dir):
        """The written maps, stacked in the records' order; an empty map
        where none was written (IoU 0)."""
        maps = np.zeros(truth.shape, bool)
        for i, r in enumerate(records):
            path = os.path.join(ground_dir, f"{r['image_id']}.npz")
            if os.path.exists(path):
                with np.load(path) as z:
                    m = z["ground"]
                if m.dtype != bool or m.shape != (r["height"], r["width"]):
                    fail(f"{path}: ground {m.dtype} {m.shape}")
                maps[i] = m
        return maps

    def ious_of(maps):
        return mask_iou(torch.from_numpy(maps).to(dev), torch.from_numpy(truth).to(dev)).tolist()

    # -- (a) depth-ransac ground maps on the card ----------------------------
    ground_dir = os.path.join(artifacts_root, "ground_maps")
    res = ggs.generate(records, ground_dir, depth_dir, artifacts_root=artifacts_root, device=dev)
    maps = read_maps(ground_dir)
    ious = ious_of(maps)
    if res["written"] + len(res["no_ground"]) != len(records):
        fail(f"depth-ransac: {res['written']} maps and {len(res['no_ground'])} no-ground ids "
             f"for {len(records)} records")
    ms = res["image_ms"][1:]
    print(f"[pgt] {card}: depth-ransac on phase 8's K2 depth maps (random ViT-L weights): "
          f"{res['written']} maps, {len(res['no_ground'])} no-ground ids; IoU with the true "
          f"ground median {statistics.median(ious):.4f}, min {min(ious):.4f} (no map: 0); "
          f"{statistics.median(ms):.3f} ms per image (median of {len(ms)}; {min(ms):.3f}-"
          f"{max(ms):.3f})")
    # the --synthetic CLI's analytic depth: the same RANSAC on true geometry
    sdir = os.path.join(artifacts_root, "analytic")
    res_a = ggs.generate(records, os.path.join(sdir, "ground_maps"), "unused", artifacts_root=sdir,
                         depth_loader=lambda r: synthetic.render_depth(r["_scene"]), device=dev)
    maps_a = read_maps(os.path.join(sdir, "ground_maps"))
    ious_a = ious_of(maps_a)
    ms = res_a["image_ms"][1:]
    print(f"[pgt] {card}: depth-ransac on the scenes' analytic depth (the --synthetic CLI): "
          f"{res_a['written']} maps; IoU median {statistics.median(ious_a):.4f}, min "
          f"{min(ious_a):.4f}; {statistics.median(ms):.3f} ms per image")
    if statistics.median(ious_a) < 0.5:
        fail(f"depth-ransac on analytic depth: median IoU {statistics.median(ious_a):.4f} "
             "with the true ground")
    # card vs CPU, 4 maps of the pipeline, the same injected draws
    rng = np.random.default_rng(29)
    for r in records[:4]:
        with np.load(os.path.join(depth_dir, f"{r['image_id']}.npz")) as z:
            d = z["depth"].astype(np.float32)
        K = np.asarray(r["K"], np.float32)
        draws = rng.integers(0, d[::4, ::4].size, (ggs.NUM_HYPOTHESES, 3))
        on_card = ggs.ground_from_depth_ransac(d, K, draws=draws, device=dev)
        on_cpu = ggs.ground_from_depth_ransac(d, K, draws=draws, device="cpu")
        if not np.array_equal(on_card, on_cpu):
            fail(f"depth-ransac image {r['image_id']}: card and CPU masks differ in "
                 f"{int((on_card != on_cpu).sum())} pixels")
    print("[pgt] depth-ransac card vs CPU on 4 of the pipeline's maps, the same injected draws: "
          "equal masks")

    # -- (b) foundation ground maps at full width ----------------------------
    t = time.time()
    gdino = gd.init_random_(gd.GroundingDINO(), seed=0).to(dev, torch.bfloat16).eval()
    sam = sam_mod.init_random_(sam_mod.Sam(PGT_SAM_VARIANT), seed=1).to(dev, torch.bfloat16).eval()
    torch.cuda.synchronize()
    print(f"[pgt] GroundingDINO Swin-T OGC (BERT-base, 6 + 6 layers, 900 queries) "
          f"{sum(p.numel() for p in gdino.parameters()) / 1e6:.1f} M params, SAM-HQ "
          f"{PGT_SAM_VARIANT} {sum(p.numel() for p in sam.parameters()) / 1e6:.1f} M params, "
          f"bf16, random weights (seeds 0, 1), built in {time.time() - t:.1f} s; SAM's "
          "attention through K2 with the bias")
    # an artifacts root of its own beside phase 8's depth maps: (d) hands it
    # to the loader and the mapper
    fdir = os.path.join(artifacts_root, "foundation")
    os.makedirs(fdir)
    os.symlink(os.path.abspath(depth_dir), os.path.join(fdir, "depth_maps"))
    load = lambda r: synthetic.render_image(r["_scene"])  # noqa: E731
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    k2_before = K2.launches
    res_f = ggs.generate(records, os.path.join(fdir, "ground_maps"), "unused", "foundation",
                         artifacts_root=fdir, foundation_models=(gdino, sam), image_loader=load,
                         box_threshold=-1.0, gdino_side=PGT_GDINO_SIDE)
    peak = torch.cuda.max_memory_allocated(dev)
    # SAM's 24 attentions a forward run through K2 with the bias
    sam_k2 = depth_run["sam_k2_launches"] = K2.launches - k2_before
    if sam_k2 != 24 * len(records):
        fail(f"foundation: K2 launched {sam_k2} times in {len(records)} SAM-HQ forwards, "
             "expected 24 a forward")
    n_maps = 0
    for r in records:
        path = os.path.join(fdir, "ground_maps", f"{r['image_id']}.npz")
        if os.path.exists(path):
            n_maps += 1
            with np.load(path) as z:
                m = z["ground"]
            if m.dtype != bool or m.shape != (r["height"], r["width"]):
                fail(f"{path}: ground {m.dtype} {m.shape}")
    csv_path = os.path.join(fdir, "no_ground_idx.csv")
    if not os.path.exists(csv_path):
        fail("the foundation method wrote no no_ground_idx.csv")
    with open(csv_path) as f:
        n_csv = sum(1 for line in f if line.strip())
    if n_maps != res_f["written"] or n_maps + n_csv != len(records) or \
            len(res_f["sam_ms"]) != len(records):
        fail(f"foundation: {n_maps} maps, {n_csv} CSV lines, {len(res_f['sam_ms'])} SAM calls "
             f"for {len(records)} records")
    # timed until a cell measures this pipeline (ROADMAP.md F6)
    g_ms, s_ms, i_ms = (statistics.median(res_f[k][1:]) for k in ("gdino_ms", "sam_ms", "image_ms"))
    print(f"[pgt] {card}: foundation (box_threshold -1: every image reaches SAM) on "
          f"{len(records)} {records[0]['width']}x{records[0]['height']} images: {n_maps} maps, "
          f"{n_csv} no-ground ids; per image (medians after the first) GroundingDINO at "
          f"{PGT_GDINO_SIDE} px {g_ms:.3f} ms, SAM-HQ {PGT_SAM_VARIANT} at "
          f"{sam_mod.IMG_SIZE} px {s_ms:.3f} ms, the whole path {i_ms:.3f} ms (host resizes "
          f"and the npz write included; first image {res_f['image_ms'][0]:.1f} ms); peak "
          f"memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the models)")
    del gdino, sam
    torch.cuda.empty_cache()

    # -- (c) small float32 models, card against CPU ----------------------------
    tol = 1e-3  # of the output's largest magnitude: float32, TF32 off, sums in other orders
    m_cpu = gd.init_random_(gd.GroundingDINO(1, 2, 16), seed=2).eval()
    m_gpu = gd.init_random_(gd.GroundingDINO(1, 2, 16), seed=2).to(dev).eval()
    x = torch.from_numpy(np.random.default_rng(30).normal(size=(1, 112, 112, 3)).astype(np.float32))
    tokens, tmask = ggs.prompt_tokens("cpu")
    attn, pos, _ = gd.build_text_masks(tokens.numpy())
    picked = {}
    for name, m, d in (("cpu", m_cpu, "cpu"), ("card", m_gpu, dev)):
        real = m.select_queries
        m.select_queries = lambda *a, real=real, name=name: picked.setdefault(name, real(*a))
        args = [t.to(d) for t in (x, tokens, tmask, torch.from_numpy(attn), torch.from_numpy(pos))]
        with torch.inference_mode():
            picked[name + "_out"] = [o.cpu() for o in m(*args)]
    errs = []
    for i, what in enumerate(("boxes", "logits")):
        a, b = picked["card_out"][i], picked["cpu_out"][i]
        fin = torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), fin):
            fail(f"small GroundingDINO: {what} finite in other places on the card and the CPU")
        err = (a[fin] - b[fin]).abs().max().item() / b[fin].abs().max().item()
        errs.append(err)
        if not err <= tol:
            fail(f"small GroundingDINO: {what} card vs CPU {err:.3e} of scale (tolerance {tol})")
    sets = [set(picked[n][1][0].tolist()) for n in ("card", "cpu")]
    if sets[0] != sets[1]:
        fail(f"small GroundingDINO: top-k proposals differ: {sorted(sets[0] ^ sets[1])}")
    s_cpu = sam_mod.init_random_(sam_mod.Sam("vit_tiny", 256), seed=3).eval()
    s_gpu = sam_mod.init_random_(sam_mod.Sam("vit_tiny", 256), seed=3).to(dev).eval()
    xs = torch.from_numpy(np.random.default_rng(31).normal(size=(1, 256, 256, 3)).astype(np.float32))
    boxes = torch.tensor([[[100.0, 150.0, 700.0, 900.0], [-20.0, 0.0, 1024.0, 400.0]]])
    with torch.inference_mode():
        a, b = s_gpu(xs.to(dev), boxes.to(dev)).cpu(), s_cpu(xs, boxes)
    err = (a - b).abs().max().item() / b.abs().max().item()
    if not err <= tol:
        fail(f"small SAM: card vs CPU {err:.3e} of scale (tolerance {tol})")
    print(f"[reference] small float32 GroundingDINO (1 enhancer, 2 decoders, 16 queries, 112 px), "
          f"card vs CPU: boxes {errs[0]:.3e}, logits {errs[1]:.3e} of scale, the same 16 top-k "
          f"proposals; SAM-HQ vit_tiny at 256 px {err:.3e} of scale (tolerance {tol} of scale)")

    # -- (d) the recipe's steps 3-4 and the hand-off to training -------------
    removed = [filter_ground.main(["--ground-dir", os.path.join(root, "ground_maps"),
                                   "--csv", os.path.join(root, "no_ground_idx.csv")])
               for root in (artifacts_root, fdir)]
    pri = priors_cli.main(["--config-file", os.path.join(HERE, "configs/Omni_combined.yaml"),
                           "--synthetic", str(len(records))])
    if not np.isfinite(pri["priors_dims_per_cat"]).all():
        fail("the priors CLI gave non-finite dimension priors")
    # the foundation root (its maps, its CSV, phase 8's depth maps) as a dataset
    json_path = os.path.join(fdir, "synthetic_pgt.json")
    write_omni3d_json(records, json_path, synthetic.CATEGORIES)
    fs = ds.get_filter_settings_from_cfg(None)
    fs["category_names"] = list(synthetic.CATEGORIES)
    loaded = ds.load_omni3d_json(json_path, fdir, "synthetic_pgt", fs, artifacts_root=fdir)
    with open(os.path.join(fdir, "no_ground_idx.csv")) as f:
        no_ground = {int(line.split(",")[0]) for line in f if line.strip()}
    for r in loaded:
        iid = r["image_id"]
        has_map = os.path.exists(os.path.join(fdir, "ground_maps", f"{iid}.npz"))
        if ("ground_image_path" in r) != (has_map and iid not in no_ground):
            fail(f"loader: image {iid} ground_image_path {'ground_image_path' in r}, map "
                 f"{has_map}, in no_ground_idx.csv {iid in no_ground}")
        if "depth_image_path" not in r:
            fail(f"loader: image {iid} has no depth_image_path")
    n_attached = sum("ground_image_path" in r for r in loaded)
    if n_attached == 0:
        fail("loader: no ground map attached")
    scenes = {r["image_id"]: r["_scene"] for r in records}
    loaders = {"image": lambda r: synthetic.render_image(scenes[r["image_id"]]),
               "depth": lambda r: ds.load_npz_map(r["depth_image_path"]),
               "ground": lambda r: ds.load_npz_map(r["ground_image_path"])
               if "ground_image_path" in r else None}
    batch = next(build_train_batches(flagship_cfg(512), loaded, batch_size=8, loaders=loaders))
    n, ok = batch["ground_normal"], batch["ground_normal_valid"]
    if not np.isfinite(n).all() or not ok.any() or not batch["ground_valid"].any():
        fail(f"mapper batch: cached ground normals {n} valid {ok}, ground maps valid "
             f"{batch['ground_valid']}")
    print(f"[pgt] filter_ground removed {removed[0]} depth-ransac and {removed[1]} foundation "
          f"maps; priors CLI: {len(pri['priors_dims_per_cat'])} categories, finite; the loader "
          f"attached {n_attached} foundation ground maps to {len(loaded)} records ({len(no_ground)} "
          f"ids in its no_ground_idx.csv); one mapper batch of 8 from the written depth and "
          f"ground maps: {int(batch['ground_valid'].sum())} ground masks, cached ground normals "
          f"finite, {int(ok.sum())} valid")
    return k2_launches, {"maps": np.concatenate([maps, maps_a]),
                         "truth": np.concatenate([truth, truth])}


def k1_backward_checks(dev, fwd_levels, fwd_boxes):
    """Phase 10: K1-bwd against its plain version (the explicit scatter) on
    the card, float32 and bfloat16, on the forward checks' box sets, the
    detection forward's own pyramid and proposals, and no RoIs; a second
    launch on the same inputs must give the same bits (each pixel sums its
    RoIs in index order)."""
    import numpy as np
    import torch
    from weakcube_tpu_torch.models.roi_heads import FPN_STRIDES
    from weakcube_tpu_torch.ops import roi_align_cuda
    from torch_roi_boxes import BOX_SETS, box_set

    bwd, plain = roi_align_cuda.roi_align_backward, roi_align_cuda.plain_backward
    # float32: the kernel sums each pixel's terms in RoI order, a bin's
    # weights separably, while the plain version's index_add_ adds the
    # samples' corner terms in an order of its own: a pixel under ~100
    # overlapping RoIs sums ~100 terms of O(1), so ~1e-5 of that sum;
    # bfloat16: both accumulate in float32 and round once, at most one bf16
    # step apart
    tols = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (1e-2, 1e-2)}
    gen = torch.Generator(device=dev).manual_seed(5)
    rng = np.random.default_rng(5)
    B, C, size = 8, 256, 512

    def compare(name, shapes, dt, boxes, out_size=7, sr=2):
        g = torch.randn((*boxes.shape[:2], out_size, out_size, shapes[0][-1]), generator=gen,
                        device=dev).to(dt)
        before = bwd.launches
        got = bwd(g, boxes, shapes, dt, FPN_STRIDES, out_size, sr)
        again = bwd(g, boxes, shapes, dt, FPN_STRIDES, out_size, sr)
        torch.cuda.synchronize()
        if bwd.launches != before + (2 if boxes.shape[1] else 0):
            fail(f"K1-bwd {name}: {bwd.launches - before} launches for 2 calls")
        for a, s in zip(got, shapes):
            if a.shape != s or a.dtype != dt or not a.is_contiguous():
                fail(f"K1-bwd {name}: gradient {tuple(a.shape)} {a.dtype} strides {a.stride()}")
        want = plain(g, boxes, shapes, [dt] * len(shapes), FPN_STRIDES, out_size, sr)
        check_grads(f"{str(dt)[6:]} {name}", got, want, *tols[dt])
        if not all(torch.equal(a, b) for a, b in zip(again, got)):
            fail(f"K1-bwd {str(dt)[6:]} {name}: a second launch on the same inputs gave "
                 "other bits")

    print("[compare] K1-bwd vs plain, synthetic pyramid b8 x 256 channels at 512 px")
    shapes = [(B, size // s, size // s, C) for s in FPN_STRIDES]
    for dt in (torch.float32, torch.bfloat16):
        for R in (1000, 100):
            compare(f"edge boxes R={R}", shapes, dt, edge_boxes(B, R, size, gen, dev))
        compare("p3-p5 squares R=1000", shapes, dt, large_boxes(B, 1000, size, gen, dev))
        for name in BOX_SETS:
            compare(f"{name} boxes R=200", shapes, dt,
                    torch.from_numpy(box_set(name, rng, B, 200, size)).to(dev))
        compare("(5, 3) edge boxes R=100", shapes, dt, edge_boxes(B, 100, size, gen, dev), 5, 3)
        compare("no RoIs", shapes, dt, torch.zeros((B, 0, 4), device=dev))
    print("[compare] K1-bwd vs plain on the detection forward's pyramid and proposals")
    compare(f"forward's proposals R={fwd_boxes.shape[1]}", [tuple(f.shape) for f in fwd_levels],
            fwd_levels[0].dtype, fwd_boxes)


def with_pooler_calls_kept(step, n: int = 2):
    """Run step() (one training step) with the inputs of its n K1 calls
    (pyramid and boxes) and n K1-bwd calls (g and boxes) kept: 2 (box and
    cube pooler), 1 for a 2D-only step (box pooler). Returns (K1 calls,
    K1-bwd calls), the box pooler's first in each (the forward meets the
    box pooler first, the backward the cube pooler; the box pooler has the
    more RoIs). The K1-bwd wrapper counts its launches on its module's
    name, which is the stand-in meanwhile: they are added to its own count
    after the step."""
    import torch
    from weakcube_tpu_torch.ops import roi_align_cuda
    fwd_calls, bwd_calls = [], []
    fwd, bwd = roi_align_cuda._forward, roi_align_cuda.roi_align_backward

    def keep_fwd(features, boxes, *args):
        fwd_calls.append(([f.detach().clone() for f in features], boxes.clone(), args))
        return fwd(features, boxes, *args)

    def keep_bwd(g, boxes, *args):
        bwd_calls.append((g.detach().clone(), boxes, args))
        return bwd(g, boxes, *args)
    keep_bwd.launches = 0
    roi_align_cuda._forward, roi_align_cuda.roi_align_backward = keep_fwd, keep_bwd
    try:
        step()
    finally:
        roi_align_cuda._forward, roi_align_cuda.roi_align_backward = fwd, bwd
        bwd.launches += keep_bwd.launches
    torch.cuda.synchronize()
    if len(fwd_calls) != n or len(bwd_calls) != n:
        fail(f"the kept step made {len(fwd_calls)} K1 and {len(bwd_calls)} K1-bwd calls, "
             f"expected {n} each")
    fwd_calls.sort(key=lambda c: -c[1].shape[1])
    bwd_calls.sort(key=lambda c: -c[1].shape[1])
    return fwd_calls, bwd_calls


def check_pooler_calls(fwd_calls, bwd_calls, label: str = "") -> dict:
    """Hold the kept K1 and K1-bwd calls of one training step
    (with_pooler_calls_kept) to their plain versions, and K1-bwd's second
    launch to its first bit for bit. Returns each kernel's largest error."""
    import torch
    from weakcube_tpu_torch.ops import roi_align_cuda
    K1, bwd = roi_align_cuda.multilevel_roi_align, roi_align_cuda.roi_align_backward
    # bf16 levels: kernel and plain version both sum in float32 and round
    # once to bf16, so they differ by at most one bf16 step of the value
    # (2^-8 of it, under rtol 1e-2) plus the float32 sums' order (about 1e-6
    # of the summed magnitudes); atol is 1e-3 of the largest |value| (2e-5
    # for float32 levels) because the step's gradients are far below the
    # O(1) that phase 10's absolute tolerances assume
    errs = {"K1": 0.0, "K1-bwd": 0.0}
    for name, (levels, boxes, args), (g, gboxes, bargs) in zip(("box pooler", "cube pooler"),
                                                                fwd_calls, bwd_calls):
        name = label + name
        if not torch.equal(boxes, gboxes):
            fail(f"{name}: the kept K1 and K1-bwd calls pooled other boxes")
        strides, out_size, sr, min_level = args
        want = roi_align_cuda.plain(levels, boxes, strides, out_size, sr, min_level)
        rtol, atol = (1e-2, 1e-3) if levels[0].dtype == torch.bfloat16 else (1e-5, 2e-5)
        errs["K1"] = max(errs["K1"], check_close(
            f"K1 {name} R={boxes.shape[1]} {str(levels[0].dtype)[6:]}",
            K1(levels, boxes, strides, out_size, sr, min_level), want,
            atol * want.float().abs().max().item(), rtol))
        shapes, dt = bargs[0], bargs[1]
        want = roi_align_cuda.plain_backward(g, gboxes, shapes, [dt] * len(shapes), *bargs[2:])
        scale = max(w.float().abs().max().item() for w in want)
        got = bwd(g, gboxes, *bargs)
        errs["K1-bwd"] = max(errs["K1-bwd"], check_grads(
            f"K1-bwd {name} R={gboxes.shape[1]} {str(dt)[6:]} (max |grad| {scale:.3e})",
            got, want, atol * scale, rtol))
        if not all(torch.equal(a, b) for a, b in zip(bwd(g, gboxes, *bargs), got)):
            fail(f"K1-bwd {name}: a second launch on the step's inputs gave other bits")
        print(f"  K1-bwd {name}: a second launch gives the same bits")
    return errs


def train_phases(dev, bn_per_step: int):
    """Phases 11-13: the small training step card vs CPU; the full-width
    weak training step (configs/Omni_combined.yaml, 38 classes, 512 px,
    batch 25, bf16) through create_train_state + train_step; K1 and K1-bwd
    held to their plain versions on the step's own pooler inputs, and K1-bwd
    timed on them. `bn_per_step` is the BatchNorm kernels' launches a step
    should make (phase 33's count of its calls). Returns K1-bwd's entry of
    the kernels line, K1's largest error on the step's inputs, the NMS
    kernel's launches in the full-width steps (one per step: the RPN's
    proposal selection) and the BatchNorm kernels' there."""
    import numpy as np
    import torch
    from weakcube_tpu_torch.entry import dims_priors, flagship_cfg, tiny_batch
    from weakcube_tpu_torch.models.rcnn3d import build_model
    from weakcube_tpu_torch.ops import batch_norm_cuda as bnc
    from weakcube_tpu_torch.ops import nms as nms_ops
    from weakcube_tpu_torch.ops import roi_align_cuda
    from weakcube_tpu_torch.parallel.train_step import create_train_state, train_step
    from torch_train_check import train_step_card_vs_cpu

    K1, bwd = roi_align_cuda.multilevel_roi_align, roi_align_cuda.roi_align_backward

    # -- 11. the small training step, card vs CPU ---------------------------
    rep = train_step_card_vs_cpu(dev)
    print(f"[reference] small float32 training step, card vs CPU (the same injected anchor "
          f"labels and RoIs): {rep['n_losses']} losses and metrics, {rep['n_grads']} gradients "
          f"and {rep['n_params']} parameters and statistics after the update agree (worst "
          f"relative error {', '.join(f'{k} {v:.3e}' for k, v in rep['worst_rel'].items())}; "
          f"bound: 1e-4 of scale, 1e-5 for parameters, plus 3x the CPU float32 step's distance "
          f"to its float64 step); the heads' gradient reaches the FPN through K1-bwd "
          f"(|d heads / d fpn_output2| = {rep['heads_to_fpn_grad']:.4e})")

    # -- 12. the full-width training step -----------------------------------
    cfg = flagship_cfg(TRAIN_SIZE)
    ncls = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    t = time.time()
    model = build_model(cfg, dims_priors(ncls), device=dev, seed=0)
    state, opt = create_train_state(cfg, model)
    batch = tiny_batch(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, G=TRAIN_GT, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    print(f"[train model] {cfg.MODEL.META_ARCHITECTURE} / {cfg.MODEL.ROI_HEADS.NAME} "
          f"{trunk_name(cfg)} FPN {cfg.MODEL.FPN.OUT_CHANNELS}, {ncls} classes, compute "
          f"{cfg.TPU.COMPUTE_DTYPE}, losses {list(cfg.loss_functions)}, SGD lr "
          f"{cfg.SOLVER.BASE_LR} (warmup factor {cfg.SOLVER.WARMUP_FACTOR} over "
          f"{cfg.SOLVER.WARMUP_ITERS}), batch {TRAIN_BATCH} x {TRAIN_SIZE} px, {TRAIN_GT} GT "
          f"rows, built in {time.time() - t:.1f} s")
    n_steps = 1 + TRAIN_STEPS
    torch.cuda.reset_peak_memory_stats()
    K1.launches = bwd.launches = nms_ops.nms_mask.launches = 0
    bnc.batch_norm_train.launches = bnc.batch_norm_train_backward.launches = 0
    all_logs = []
    for _ in range(n_steps):
        state, logs = train_step(model, opt, state, batch, gen)
        all_logs.append(logs)
    torch.cuda.synchronize()
    k1_launches, bwd_launches = K1.launches, bwd.launches
    nms_launches = nms_ops.nms_mask.launches
    bn_launches = bnc.batch_norm_train.launches + bnc.batch_norm_train_backward.launches
    # Cube/IoU3D is computed on step 0 and reads NaN on the other steps
    bad = [(i, k) for i, l in enumerate(all_logs) for k, v in l.items()
           if not np.isfinite(v) and (i == 0 or k != "Cube/IoU3D")]
    if bad:
        fail(f"non-finite training logs (step, key): {bad[:8]}")
    if state.applied != n_steps or state.skipped:
        fail(f"{state.applied} of {n_steps} updates applied, {state.skipped} skipped: "
             f"{all_logs[-1]}")
    if k1_launches != 2 * n_steps or bwd_launches != 2 * n_steps:
        fail(f"K1 launched {k1_launches} and K1-bwd {bwd_launches} times in {n_steps} steps, "
             "expected 2 each per step (box and cube pooler)")
    if nms_launches != n_steps:
        fail(f"the NMS kernel launched {nms_launches} times in {n_steps} steps, expected 1 per "
             "step (the RPN's proposal selection)")
    if bn_launches != bn_per_step * n_steps:
        fail(f"BatchNorm's kernels launched {bn_launches} times in {n_steps} steps "
             f"({bnc.batch_norm_train.launches} forward, "
             f"{bnc.batch_norm_train_backward.launches} backward), expected {bn_per_step} per "
             "step (4 a layer with a gradient, 2 without)")
    print(f"[train] {n_steps} steps: applied {state.applied}, skipped {state.skipped}; every "
          f"loss finite; K1 launches {k1_launches}, K1-bwd launches {bwd_launches} (2 + 2 per "
          f"step), NMS launches {nms_launches} (1 per step), BatchNorm kernel launches "
          f"{bn_launches} ({bn_per_step} per step); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    print(f"[train] Cube/IoU3D of step 0 (a metric tick; NaN on the others): "
          f"{all_logs[0]['Cube/IoU3D']:.6f}")
    print(f"[train] losses of the last step: " + ", ".join(
        f"{k} {v:.4f}" for k, v in all_logs[-1].items()))

    # one more step whose two K1 calls (pyramid and boxes) and two K1-bwd
    # calls (g and boxes) are kept, to hold both kernels to their plain
    # versions on the step's own inputs and to time K1-bwd on them
    fwd_calls, bwd_calls = with_pooler_calls_kept(lambda: train_step(model, opt, state, batch,
                                                                    gen))

    # -- 13. K1 and K1-bwd on the step's own inputs ---------------------------
    print(f"[compare] K1 and K1-bwd vs plain on the training step's own pyramid, boxes and "
          f"gradients (b{TRAIN_BATCH} @ {TRAIN_SIZE} px)")
    errs = check_pooler_calls(fwd_calls, bwd_calls)

    tot = {"ms": 0.0, "bound_ms": 0.0}
    for name, (g, boxes, args) in zip(("box pooler", "cube pooler"), bwd_calls):
        shapes, dt, strides, out_size, sr = args[0], args[1], args[2], args[3], args[4]
        call = lambda: bwd(g, boxes, *args)  # noqa: E731
        ms = kernel_device_ms(call, 20)
        bound = k1_bwd_bound_ms(shapes, dt, boxes, strides, out_size, sr)
        tot["ms"] += ms
        tot["bound_ms"] += bound
        print(f"[timing] K1-bwd {name} R={boxes.shape[1]} {str(dt)[6:]}: {ms:.4f} ms of device "
              f"time per call (20 calls queued behind a sleep kernel); bound {bound:.4f} ms "
              f"({100 * bound / ms:.1f}% of it)")
        launched = kernels_launched(call)
        if not launched:
            print(f"[profile] K1-bwd {name}: the profiler recorded no device time: the kernels a "
                  "call launches not checked")
        elif launched != ["roi_align_bwd_kernel"]:
            fail(f"K1-bwd {name}: calls launched {launched}, expected roi_align_bwd_kernel and "
                 "nothing else (no zero fill, no cast)")
        else:
            print(f"[profile] K1-bwd {name}: calls launch roi_align_bwd_kernel and nothing else")
    print(f"[timing] K1-bwd per step (box + cube pooler): {tot['ms']:.4f} ms of device time, "
          f"bound {tot['bound_ms']:.4f} ms ({100 * tot['bound_ms'] / tot['ms']:.1f}% of it)")
    return {"name": "roi_align_backward (ROIAlignV2 feature gradient), box + cube pooler per "
                    "training step",
            "route": "cuda", "source": K1_SOURCE, "replaces": K1_BWD_REPLACES,
            "launches": bwd_launches, "max_abs_err": errs["K1-bwd"], **tot}, \
        errs["K1"], nms_launches, bn_launches


def k1_stress(dev, rounds: int = 50):
    """Phase 3b: K1's open fault (ROADMAP.md, Queue C: one mismatch in an
    earlier chip run, never reproduced). tests/test_torch_cuda.py::
    test_kernel_many_rois_per_block's seeds, dtypes and box mixes (2 x 4000
    RoIs over 256 px levels, C = 256, more RoIs than the persistent grid
    holds), `rounds` launches each, every launch held bit for bit to the
    first and within tolerance to the plain version. On a mismatch: the
    first mismatching RoI, its level, its persistent block and its channel
    chunk, then fail. Returns the launch count."""
    import numpy as np
    import torch
    from weakcube_tpu_torch.models.roi_heads import FPN_STRIDES
    from weakcube_tpu_torch.ops import roi_align_cuda
    from torch_roi_boxes import BOX_SETS, box_set

    K1 = roi_align_cuda.multilevel_roi_align
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = 0
    for seed in (7, 8, 9):
        for dt in (torch.float32, torch.bfloat16):
            rng = np.random.default_rng(seed)
            feats = [torch.from_numpy(rng.normal(size=(2, 256 // s, 256 // s, 256))
                                      .astype(np.float32)).to(dev, dt) for s in FPN_STRIDES]
            boxes = np.concatenate([box_set(b, rng, 2, 800, 256) for b in BOX_SETS], 1)
            boxes = torch.from_numpy(np.ascontiguousarray(
                boxes[:, rng.permutation(boxes.shape[1])])).to(dev)
            want = roi_align_cuda.plain(feats, boxes, FPN_STRIDES, 7, 2).float()
            atol, rtol = (2e-5, 1e-5) if dt == torch.float32 else (1e-2, 1e-2)
            first = None
            for i in range(rounds):
                got = K1(feats, boxes, FPN_STRIDES, 7, 2)
                n += 1
                bad = (got.float() - want).abs() > atol + rtol * want.abs()
                if first is not None:
                    bad |= got != first
                else:
                    first = got
                if bool(bad.any()):
                    k1_mismatch_report(feats, boxes, got, want, first, bad, sms, seed, dt, i)
    return n


def k1_staged_lines(box, stride: float, H: int, W: int, out_size: int = 7, sr: int = 2):
    """The lines (rows, columns) K1's staging plan moves for one RoI on its
    level: per axis, the compact run from its lowest to its highest touched
    line where that run holds at most 2P lines (P = out_size * sr) and no
    bin spans more than 2 * sr of them, else the 2P touched lines."""
    import numpy as np
    P = out_size * sr
    grid = (np.arange(P, dtype=np.float32) + np.float32(0.5)) / np.float32(P)
    scale = np.float32(1.0 / stride)

    def lines(a0, a1, size):
        c0 = np.float32(a0) * scale - np.float32(0.5)
        ln = max(np.float32(a1) * scale - np.float32(0.5) - c0, np.float32(1e-6))
        c = np.minimum(np.maximum(c0 + ln * grid, 0), size - 1)
        lo = np.floor(c).astype(np.int64)
        hi = np.minimum(lo + 1, size - 1)
        run = int(hi[-1] - lo[0] + 1)
        band = hi[sr - 1::sr] - lo[::sr] + 1
        return run if run <= 2 * P and (band <= 2 * sr).all() else 2 * P
    x0, y0, x1, y1 = (float(v) for v in box)
    return lines(y0, y1, H), lines(x0, x1, W)


def k1_mismatch_report(feats, boxes, got, want, first, bad, sms, seed, dt, launch):
    """Print where K1 first disagrees: the RoI, its level and staged lines,
    the persistent block that took it (RoI index mod the grid; the grid is
    SMs x the blocks that fit an SM by shared memory, an estimate of the
    kernel's occupancy query) and the channel chunk of the staging plan;
    then fail."""
    import torch
    from weakcube_tpu_torch.models.roi_heads import FPN_STRIDES
    from weakcube_tpu_torch.ops.roi_align import assign_fpn_levels
    b, r, i, j, c = [int(x) for x in bad.nonzero()[0]]
    R, C = boxes.shape[1], feats[0].shape[-1]
    level = int(assign_fpn_levels(boxes[b, r].float().cpu(), 2, 1 + len(feats)))
    H, W = feats[level - 2].shape[1:3]
    ny, nx = k1_staged_lines(boxes[b, r].tolist(), FPN_STRIDES[level - 2], H, W)
    V = 4 if dt == torch.float32 else 8
    P, VB = 14, 16
    stage = max(4 * P * P * V * feats[0].element_size(), 24 * 1024)
    stage = (stage + 127) // 128 * 128
    per_sm = min((228 * 1024) // (2 * stage + 1024), 2048 // 128)
    nvec = C // V
    cv = min(nvec, stage // (ny * nx * VB))
    if cv < min(nvec, 4):
        cv = min(nvec, 2 * stage // (ny * nx * VB))
    chunks = -(-nvec // cv)
    cv = -(-nvec // chunks)
    roi = b * R + r
    fail(f"K1 stress (seed {seed}, {str(dt)[6:]}, launch {launch}): {int(bad.sum())} values "
         f"disagree; first at image {b} RoI {r} (linear {roi}, box "
         f"{[round(x, 3) for x in boxes[b, r].tolist()]}), bin ({i}, {j}), channel {c}: kernel "
         f"{got[b, r, i, j, c].item()!r}, first launch {first[b, r, i, j, c].item()!r}, plain "
         f"{want[b, r, i, j, c].item()!r}; level p{level}, staged {ny} x {nx} "
         f"lines, channel chunk {(c // V) // cv} of {chunks}; persistent block {roi % (sms * per_sm)}"
         f" of an estimated grid of {sms} x {per_sm}")


def k1_racecheck():
    """Phase 3c: compute-sanitizer's racecheck on one K1 launch of the
    stress loop's shape (bf16), in a subprocess, instrumenting K1 alone.
    Fails on a reported hazard; a sanitizer that is absent, or that does
    not run K1 at all (an unsupported device), is reported as such.
    Returns a one-line outcome."""
    import re
    import shutil
    tool = shutil.which("compute-sanitizer") or shutil.which(
        "compute-sanitizer", path=os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                               "bin"))
    if tool is None:
        print("[racecheck] compute-sanitizer is not on this host: K1 racecheck not run")
        return "not run: compute-sanitizer absent"
    code = (
        "import sys, numpy as np, torch\n"
        f"sys.path[:0] = [{HERE!r}, {os.path.join(HERE, 'tests')!r}]\n"
        "from weakcube_tpu_torch.ops import roi_align_cuda\n"
        "from torch_roi_boxes import BOX_SETS, box_set\n"
        "rng = np.random.default_rng(7)\n"
        "S = (4, 8, 16, 32, 64)\n"
        "f = [torch.from_numpy(rng.normal(size=(2, 256 // s, 256 // s, 256)).astype(np.float32))"
        ".to('cuda', torch.bfloat16) for s in S]\n"
        "b = np.concatenate([box_set(n, rng, 2, 800, 256) for n in BOX_SETS], 1)\n"
        "b = torch.from_numpy(np.ascontiguousarray(b[:, rng.permutation(b.shape[1])])).cuda()\n"
        "roi_align_cuda.multilevel_roi_align(f, b, S, 7, 2)\n"
        "torch.cuda.synchronize()\n"
        "print('K1 launches', roi_align_cuda.multilevel_roi_align.launches)\n")
    cmd = [tool, "--tool", "racecheck", "--racecheck-report", "all",
           "--kernel-name", "kns=roi_align_kernel", sys.executable, "-c", code]
    t = time.time()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=HERE)
    except subprocess.TimeoutExpired:
        print("[racecheck] compute-sanitizer racecheck did not finish within 300 s: not measured")
        return "not measured: timed out after 300 s"
    out = (res.stdout + res.stderr).strip().splitlines()
    summary = [line for line in out if "SUMMARY" in line or "hazard" in line.lower()
               or "K1 launches" in line]
    print(f"[racecheck] compute-sanitizer --tool racecheck on one K1 launch (2 x 4000 RoIs, "
          f"bf16): rc {res.returncode} in {time.time() - t:.1f} s")
    for line in (summary or out[-12:]):
        print(f"  {line}")
    ran = any(line.strip() == "K1 launches 1" for line in out)
    if not ran:
        why = next((line.strip("= ").strip() for line in out if "Error:" in line),
                   f"exit code {res.returncode}")
        print(f"[racecheck] the sanitizer did not run K1 ({why}): racecheck not measured")
        return f"not measured: {why}"
    hazards = [int(m.group(1)) for line in out
               for m in [re.search(r"RACECHECK SUMMARY: (\d+) hazard", line)] if m]
    if not hazards or any(h > 0 for h in hazards) or any("Race reported" in line for line in out):
        fail("compute-sanitizer racecheck reported a shared-memory hazard in K1 (or no summary)")
    return "0 hazards"


def cli_phases(dev, out):
    """Phase 15: the train CLI at full width (configs/Omni_combined.yaml:
    DLA-34, 38 classes, b25, 512 px, bf16, cached ground normals) on 50
    synthetic scenes into OUTPUT_DIR `out`: 6 iterations with a checkpoint
    at 4, then --resume to 8, which must start at 4 (model_recent). Checks
    K1 and K1-bwd ran twice per step, every loss finite, metrics.json and
    the checkpoints written. Returns the numbers PERF.md keeps: the CLI's
    steps/s and its mapper's ms per batch are the only record of the step
    fed by the data pipeline until a cell measures it (ROADMAP.md F1)."""
    import math
    import torch
    from weakcube_tpu_torch.ops import roi_align_cuda
    from weakcube_tpu_torch.solver import checkpoint
    from weakcube_tpu_torch.tools import train_net

    K1, bwd = roi_align_cuda.multilevel_roi_align, roi_align_cuda.roi_align_backward
    base = ["--config-file", os.path.join(HERE, "configs", "Omni_combined.yaml"),
            "--synthetic", "50"]
    opts = ["SOLVER.CHECKPOINT_PERIOD", "4", "TEST.EVAL_PERIOD", "0", "VIS_PERIOD", "0",
            "TPU.MESH_SHAPE", "[1]", "OUTPUT_DIR", out]
    K1.launches = bwd.launches = 0
    t = time.time()
    state, hist = train_net.main(base + ["--max-iters", "6"] + opts)
    torch.cuda.synchronize()
    wall = time.time() - t
    k1, kb = K1.launches, bwd.launches
    if state.step != 6 or len(hist) != 6:
        fail(f"the CLI ran {len(hist)} iterations to step {state.step}, expected 6")
    if k1 != 12 or kb != 12:
        fail(f"the CLI launched K1 {k1} and K1-bwd {kb} times in 6 steps, expected 12 each")
    bad = [(h["iteration"], k) for h in hist for k, v in h["logs"].items()
           if k != "Cube/IoU3D" and not math.isfinite(v)]
    if bad:
        fail(f"non-finite CLI logs (iteration, key): {bad[:8]}")
    iou0 = hist[0]["logs"]["Cube/IoU3D"]
    if not math.isfinite(iou0):
        fail(f"Cube/IoU3D of step 0 is {iou0}")
    with open(os.path.join(out, "metrics.json")) as f:
        lines = [json.loads(x) for x in f]
    if not lines or lines[-1].get("iteration") != 6:
        fail(f"metrics.json holds {lines[-1:] or 'nothing'}")
    for name in ("model_recent", "model_final"):
        if not os.path.exists(os.path.join(out, name + checkpoint.SUFFIX)):
            fail(f"the CLI wrote no {name}{checkpoint.SUFFIX}")
    timed = hist[1:]
    secs = sum(h["data_time"] + h["step_time"] for h in timed)
    rep = {"steps_per_s": len(timed) / secs, "images_per_s": 25 * len(timed) / secs,
           "data_ms": [1e3 * h["data_time"] for h in hist],
           "step_ms": [1e3 * h["step_time"] for h in hist], "iou3d_step0": iou0,
           "applied": state.applied, "skipped": state.skipped, "wall_s": wall}
    print(f"[cli] python -m weakcube_tpu_torch.tools.train_net --config-file "
          f"configs/Omni_combined.yaml --synthetic 50 --max-iters 6 SOLVER.CHECKPOINT_PERIOD "
          f"4 TEST.EVAL_PERIOD 0 VIS_PERIOD 0 TPU.MESH_SHAPE [1]: {wall:.1f} s; applied {state.applied}, skipped "
          f"{state.skipped}; K1 launches {k1}, K1-bwd launches {kb} (2 + 2 per step); "
          f"Cube/IoU3D of step 0 {iou0:.6f}; metrics.json {len(lines)} line(s)")
    print("[cli] per iteration (data time / step time, ms): " + ", ".join(
        f"{h['iteration']}: {1e3 * h['data_time']:.1f} / {1e3 * h['step_time']:.1f}"
        for h in hist))
    print(f"[timing] CLI iterations 2-6: {rep['steps_per_s']:.3f} steps/s, "
          f"{rep['images_per_s']:.1f} images/s at b25 (data time "
          f"{1e3 * sum(h['data_time'] for h in timed) / len(timed):.1f} ms, step time "
          f"{1e3 * sum(h['step_time'] for h in timed) / len(timed):.1f} ms per iteration)")
    state2, hist2 = train_net.main(base + ["--resume", "--max-iters", "8"] + opts)
    first = hist2[0]
    if first["iteration"] != 4 or state2.step != 8:
        fail(f"--resume started at iteration {first['iteration']} and ended at step "
             f"{state2.step}, expected 4 (model_recent) and 8")
    if not math.isfinite(first["logs"]["total_loss"]):
        fail(f"the resumed run's first loss is {first['logs']['total_loss']}")
    print(f"[cli] --resume --max-iters 8: started at iteration {first['iteration']} "
          f"(model_recent), first loss {first['logs']['total_loss']:.4f}, ended at step "
          f"{state2.step}")
    # the CLI's data stages alone, on this thread: does the mapper keep up
    # with the step? (renders memoised as in the CLI; the first batch
    # renders them)
    from weakcube_tpu_torch.data.build import build_train_batches, to_device
    args = train_net.parse_args(base + ["--max-iters", "6"] + opts)
    cfg = train_net.setup(args)
    records, loaders, _ = train_net.build_data(cfg, args)
    batches = build_train_batches(cfg, records, loaders=loaders)
    next(batches)
    map_ms, copy_ms = [], []
    for _ in range(4):
        t = time.perf_counter()
        b = next(batches)
        map_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        to_device(b, dev)
        torch.cuda.synchronize()
        copy_ms.append((time.perf_counter() - t) * 1e3)
    rep["mapper_ms"], rep["copy_ms"] = statistics.median(map_ms), statistics.median(copy_ms)
    print(f"[timing] the CLI's data stages alone, one thread: mapper + pad_batch "
          f"{rep['mapper_ms']:.1f} ms per b25 batch (median of 4: "
          f"{' '.join(f'{x:.1f}' for x in map_ms)}), pinned copy to the card "
          f"{rep['copy_ms']:.1f} ms (median of 4: {' '.join(f'{x:.1f}' for x in copy_ms)}); "
          f"the step {1e3 * sum(h['step_time'] for h in timed) / len(timed):.1f} ms")
    return rep


def ground_phase(dev):
    """Phase 16: one full-width training step on a batch of the port's
    mapper with TPU.CACHE_GROUND_NORMALS False, so that pose_ground fits the
    ground planes by RANSAC on the card (ground_normals_from_maps: 25
    images, 1000 hypotheses, every 5th pixel); its normals held to the SVD
    fit of the same canvases (|cos| > 0.995 where the ground mask is valid)
    and compared with the mapper's cached normals; K1 and K1-bwd held to
    their plain versions on this step's pooler inputs and timed on them.
    Returns the numbers PERF.md keeps."""
    import numpy as np
    import torch
    from weakcube_tpu_torch.data import synthetic
    from weakcube_tpu_torch.data.build import build_train_batches, to_device
    from weakcube_tpu_torch.entry import flagship_cfg
    from weakcube_tpu_torch.models import roi_heads
    from weakcube_tpu_torch.models.priors import compute_priors
    from weakcube_tpu_torch.models.rcnn3d import build_model
    from weakcube_tpu_torch.ops import roi_align_cuda
    from weakcube_tpu_torch.ops.plane import ground_normal_np
    from weakcube_tpu_torch.parallel.train_step import create_train_state, train_step

    records = synthetic.make_dataset(50, seed=0)
    loaders = {"image": lambda r: synthetic.render_image(r["_scene"]),
               "depth": lambda r: synthetic.render_depth(r["_scene"]),
               "ground": lambda r: synthetic.ground_mask(r["_scene"])}
    cfgs = {}
    for cache in (True, False):
        c = flagship_cfg(512).clone()
        c.defrost()
        c.TPU.CACHE_GROUND_NORMALS = cache
        c.freeze()
        cfgs[cache] = c
    cached = next(build_train_batches(cfgs[True], records, loaders=loaders))
    batch = next(build_train_batches(cfgs[False], records, loaders=loaders))
    if "ground_normal" in batch or not np.array_equal(batch["image"], cached["image"]):
        fail("the mapper's batches with and without the normal cache differ")
    batch = to_device(batch, dev)
    cfg = cfgs[False]
    model = build_model(cfg, compute_priors(cfg, records, cfg.MODEL.ROI_HEADS.NUM_CLASSES),
                        device=dev, seed=0)
    state, opt = create_train_state(cfg, model)
    fit, seen, out = roi_heads.ground_normals_from_maps, {}, {}
    K1, bwd = roi_align_cuda.multilevel_roi_align, roi_align_cuda.roi_align_backward

    def spy(generator, *a, **k):
        seen.update(args=a, kwargs=k, out=fit(generator, *a, **k))
        return seen["out"]

    def step():
        out["state"], out["logs"] = train_step(model, opt, state, batch,
                                               torch.Generator(device=dev).manual_seed(0))
    roi_heads.ground_normals_from_maps = spy
    try:
        calls = with_pooler_calls_kept(step)
    finally:
        roi_heads.ground_normals_from_maps = fit
    state, logs = out["state"], out["logs"]
    torch.cuda.synchronize()
    if "out" not in seen:
        fail("the step without cached normals did not fit the ground plane")
    if not all(np.isfinite(v) for k, v in logs.items()) or state.applied != 1:
        fail(f"the in-graph ground-plane step: applied {state.applied}, logs {logs}")
    kw = seen["kwargs"]
    print(f"[ground] one b25 @ 512 px step without cached normals: pose_ground fit "
          f"{seen['args'][0].shape[0]} ground planes on the card ({kw['num_hypotheses']} "
          f"hypotheses, every {kw['use_nth']}th pixel); Cube/loss_normal_vec "
          f"{logs['Cube/loss_normal_vec']:.5f}, total {logs['total_loss']:.4f}")
    # the in-graph fit backprojects the canvas with its principal point at
    # the canvas centre (the JAX package's convention); the mapper's cached
    # SVD normal fits the original map. On a canvas padded below the content
    # the two differ by the padding's offset, so the gate holds the RANSAC to
    # the same SVD fit on the canvas it sees, and the cached normals (and the
    # SVD fit on the content alone) are reported beside it
    normals = seen["out"].double().cpu().numpy()
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    ok = cached["ground_normal_valid"] & cached["ground_valid"]
    svd, svd_content = np.zeros_like(normals), np.zeros_like(normals)
    for b in range(len(normals)):
        w, h = (int(x) for x in cached["image_wh"][b])
        depth, mask, K = (cached["depth_map"][b].astype(np.float32), cached["ground_mask"][b],
                          cached["K"][b])
        svd[b], ok_b = ground_normal_np(depth, K, mask)
        svd_content[b], _ = ground_normal_np(depth[:h, :w], K, mask[:h, :w])
        ok[b] &= ok_b

    def cos(a, b):
        return np.abs((a * b).sum(-1)) / np.linalg.norm(b, axis=-1)
    c_same, c_cached = cos(normals, svd), cos(normals, cached["ground_normal"].astype(np.float64))
    c_content = cos(svd_content, cached["ground_normal"].astype(np.float64))
    if not ok.any() or (c_same[ok] <= 0.995).any():
        fail(f"in-graph RANSAC normals vs the SVD fit of the same canvases: |cos| "
             f"{c_same.round(5).tolist()} (valid {ok.tolist()}), bound 0.995")
    print(f"  on {int(ok.sum())} images with a valid ground mask, |cos| of the RANSAC normals to "
          f"the SVD fit (ops/plane.py::ground_normal_np) of the same canvases: min "
          f"{c_same[ok].min():.6f}, median {np.median(c_same[ok]):.6f} (bound > 0.995); to the "
          f"mapper's cached SVD normals of the original maps: min {c_cached[ok].min():.6f}, "
          f"median {np.median(c_cached[ok]):.6f} (the canvas centre is "
          f"{512 / 2 - float(cached['K'][0, 1, 2]):.1f} px below the principal point); the SVD "
          f"fit of the canvas's content alone to the cached normals: min "
          f"{c_content[ok].min():.6f}")

    # K1 and K1-bwd on this step's own pooler inputs: checked and timed
    rep = {"min_cos": float(c_same[ok].min()), "k1_ms": 0.0, "k1_bound_ms": 0.0,
           "bwd_ms": 0.0, "bwd_bound_ms": 0.0}
    for name, (levels, boxes, args), (g, gboxes, bargs) in zip(
            ("box pooler", "cube pooler"), *calls):
        strides, out_size, sr, min_level = args
        want = roi_align_cuda.plain(levels, boxes, strides, out_size, sr, min_level)
        rtol, atol = (1e-2, 1e-3) if levels[0].dtype == torch.bfloat16 else (1e-5, 2e-5)
        check_close(f"K1 {name} R={boxes.shape[1]} on the mapper's batch",
                    K1(levels, boxes, strides, out_size, sr, min_level), want,
                    atol * want.float().abs().max().item(), rtol)
        shapes, dt = bargs[0], bargs[1]
        gw = roi_align_cuda.plain_backward(g, gboxes, shapes, [dt] * len(shapes), *bargs[2:])
        scale = max(w.float().abs().max().item() for w in gw)
        check_grads(f"K1-bwd {name} R={gboxes.shape[1]} on the mapper's batch",
                    bwd(g, gboxes, *bargs), gw, atol * scale, rtol)
        k1_ms = kernel_device_ms(lambda: K1(levels, boxes, strides, out_size, sr, min_level), 20)
        k1_bound = k1_bound_ms(levels, boxes, strides, out_size, sr)
        bwd_ms = kernel_device_ms(lambda: bwd(g, gboxes, *bargs), 20)
        bwd_bound = k1_bwd_bound_ms(shapes, dt, gboxes, strides, out_size, sr)
        for k, x in (("k1_ms", k1_ms), ("k1_bound_ms", k1_bound), ("bwd_ms", bwd_ms),
                     ("bwd_bound_ms", bwd_bound)):
            rep[k] += x
        print(f"[timing] on the mapper's batch, {name} R={boxes.shape[1]}: K1 {k1_ms:.4f} ms of "
              f"device time (bound {k1_bound:.4f} ms), K1-bwd {bwd_ms:.4f} ms (bound "
              f"{bwd_bound:.4f} ms)")
    print(f"[timing] per CLI step (box + cube pooler): K1 {rep['k1_ms']:.4f} ms (bound "
          f"{rep['k1_bound_ms']:.4f}), K1-bwd {rep['bwd_ms']:.4f} ms (bound "
          f"{rep['bwd_bound_ms']:.4f})")
    return rep


def geometry_phases(dev):
    """Phases 17-18: exact IoU3D on 25 x 128 pairs and RANSAC on 25 tilted,
    noisy ground clouds with 1000 injected draws, each on the card against
    the CPU (tests/torch_geometry_check.py). Returns the numbers PERF.md
    keeps."""
    from torch_geometry_check import iou3d_card_vs_cpu, ransac_card_vs_cpu
    try:
        iou = iou3d_card_vs_cpu(dev, 25 * 128)
        ran = ransac_card_vs_cpu(dev, 25, 480, 640, 1000)
    except AssertionError as e:
        fail(str(e))
    print(f"[iou3d] matched_iou3d on {iou['pairs']} pairs (identical, contained, touching, "
          f"disjoint, overlapping), card vs CPU float32: max |err| {iou['max_abs_err']:.3e} "
          f"(atol 1e-5); {iou['identical_below_1']} of {iou['identical']} identical pairs read "
          f"below 1 on both (coplanar faces, ROADMAP.md Queue C)")
    print(f"[ransac] ransac_plane on {ran['images']} clouds of {ran['points']} points, 1000 "
          f"injected draws, card vs CPU: the same winner on {ran['same_winner']} images (planes "
          f"within {ran['worst_same_err']:.3e}), |cos| >= {ran['worst_cos_other']:.7f} on the "
          f"others; inlier counts within {ran['max_count_diff']} points (bound 0.1% of the valid "
          f"points); |cos| to the true plane >= {ran['min_cos_to_truth']:.6f}")
    return {"iou3d_err": iou["max_abs_err"], "ransac_same_winner": ran["same_winner"]}


def ops_phase(dev, det, ground) -> dict:
    """Phase 31: the ops layer's last public functions on the card and on
    the CPU, on the main path's own data: phase 4's detections (b8, K per
    image), the b25 GT cubes of tiny_batch, phase 29's ground maps. Card vs
    CPU within 1e-5 of scale, equal flags and masks. Returns each function's
    largest error."""
    import torch
    from weakcube_tpu_torch.entry import tiny_batch
    from weakcube_tpu_torch.ops import boxes, cuboids, rotations, sampling
    tol = 1e-5  # of the reference's largest magnitude: float32, other sum orders
    cpu = torch.device("cpu")
    tb = tiny_batch(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, G=TRAIN_GT, seed=0, device=dev)
    gt = tb["gt"]  # boxes3D: projected centre (2), z, dims (3), centre (3)
    gt_box3d = torch.cat([gt.boxes3D[..., 6:9], gt.boxes3D[..., 3:6]], -1)
    # the GT cubes 4 m nearer (z in -2..4): in front of, straddling and
    # behind the camera, so that the clipping branch runs
    nearer = gt_box3d - torch.tensor([0.0, 0, 4, 0, 0, 0], device=dev)
    sets = {f"phase 4's detections (b{det['centers'].shape[0]} x {det['centers'].shape[1]})":
            (det["K"][:, None], torch.cat([det["centers"], det["dims"]], -1).float(),
             det["poses"].float(), det["valid"], 50),
            f"tiny_batch GT cubes (b{TRAIN_BATCH} x {TRAIN_GT})":
            (tb["K"][:, None], gt_box3d, gt.poses, gt.valid, 3),
            "the GT cubes 4 m nearer": (tb["K"][:, None], nearer, gt.poses, gt.valid, 3)}
    del tb
    errs = {}

    def compare(name, got, want, exact=False):
        got, want = got.cpu(), want.cpu()
        if exact or got.dtype == torch.bool:
            if not torch.equal(got, want):
                fail(f"phase 31: {name}: card and CPU differ in {int((got != want).sum())} "
                     f"of {got.numel()} values")
            err = 0.0
        else:
            err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
            if not err <= tol:
                fail(f"phase 31: {name}: {err:.3e} of scale (tolerance {tol})")
        errs[name] = max(errs.get(name, 0.0), err)

    def both(fn, *args):
        """fn on the card's tensors and on their CPU copies."""
        return fn(*args), fn(*(a.to(cpu) if torch.is_tensor(a) else a for a in args))

    for label, (K, box3d, R, valid, k) in sets.items():
        for xywh in (True, False):
            for clip in (0.0, float(TRAIN_SIZE)):
                out = both(lambda *a: cuboids.convert_3d_box_to_2d(
                    *a, clipw=clip, cliph=clip, XYWH=xywh), K, box3d, R)
                compare("convert_3d_box_to_2d box", out[0][0], out[1][0])
                compare("convert_3d_box_to_2d flags", torch.stack(out[0][1:]),
                        torch.stack(out[1][1:]))
        behind, fully = out[0][1:]
        for c, w in zip(*both(cuboids.get_cuboid_verts, K, box3d, R)):
            compare("get_cuboid_verts", c, w)
        # the pose at each cube's projected centre, there and back
        uv = cuboids.project_points(K, box3d[..., None, :3])[..., 0, :2]
        u, v = uv[..., 0].contiguous(), uv[..., 1].contiguous()
        allo = both(cuboids.R_to_allocentric, K, R, u, v)
        compare("R_to_allocentric", *allo)
        compare("R_to_allocentric round trip", cuboids.R_from_allocentric(K, allo[0], u, v), R)
        # the poses made orthonormal in float32 (Gram-Schmidt of their 6D),
        # then the quaternion there and back
        Ro = rotations.rotation_6d_to_matrix(rotations.matrix_to_rotation_6d(R))
        compare("matrix_to_rotation_6d round trip",
                rotations.rotation_6d_to_matrix(rotations.matrix_to_rotation_6d(Ro)), Ro)
        q = both(rotations.matrix_to_quaternion, Ro)
        compare("matrix_to_quaternion", *q)
        compare("matrix_to_quaternion round trip", rotations.quaternion_to_matrix(q[0]), Ro)
        # the uniform sampler: min(k, valid) picks in each row, all valid;
        # one seed, one mask
        pick = [sampling.uniform_topk_mask(torch.Generator(device=dev).manual_seed(31), valid, k)
                for _ in range(2)]
        if not torch.equal(pick[0], pick[1]) or bool((pick[0] & ~valid).any()) or \
                not torch.equal(pick[0].sum(-1), valid.sum(-1).clamp(max=k)):
            fail(f"phase 31: uniform_topk_mask on {label} (k {k}): picks per row "
                 f"{pick[0].sum(-1).tolist()}, valid per row {valid.sum(-1).tolist()}, "
                 f"one seed one mask {torch.equal(pick[0], pick[1])}")
        print(f"[ops] {label}: convert_3d_box_to_2d (XYWH on and off, clip 0 and "
              f"{TRAIN_SIZE} px), get_cuboid_verts, R_to_allocentric and its round trip, "
              f"matrix_to_rotation_6d and matrix_to_quaternion and their round trips: card vs "
              f"CPU within {tol} of scale, equal flags ({int(behind.sum())} cubes with a corner "
              f"behind the camera, {int(fully.sum())} of them fully); uniform_topk_mask k {k}: "
              f"{pick[0].sum(-1).tolist()} picks per row, all valid, one seed one mask")
    maps, truth = (torch.from_numpy(ground[k]).to(dev) for k in ("maps", "truth"))
    ious = both(boxes.mask_iou, maps, truth)
    compare("mask_iou", *ious, exact=True)
    print(f"[ops] mask_iou of phase 29's {maps.shape[0]} depth-ransac ground maps "
          f"({maps.shape[1]}x{maps.shape[2]}; on K2's depth, then on the analytic depth; "
          f"{int(maps.flatten(1).any(1).sum())} not empty) against the true ground, card vs "
          f"CPU: equal (median IoU {statistics.median(ious[0].tolist()):.4f})")
    print("[ops] largest card vs CPU error of scale: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return {"errs": errs}


EVAL_SCENES, EVAL_BATCH = 64, 32


def kept_records(cls):
    """Patch cls.add (an evaluator's) to keep every (dt, gt) record pair it
    is given; returns (the list, a function that undoes the patch)."""
    kept, add = [], cls.add

    def keep(self, dt, gt):
        kept.append((dt, gt))
        return add(self, dt, gt)
    cls.add = keep
    return kept, lambda: setattr(cls, "add", add)


def eval_phase(dev, out):
    """Phase 19: the eval CLI at full width (python -m
    weakcube_tpu_torch.tools.eval_net --config-file configs/Omni_combined.yaml
    --synthetic 64 --eval-only, in process) on phase 15's OUTPUT_DIR, so that
    it evaluates the checkpoint the train CLI wrote: 38 classes, 512 px, bf16,
    two batches of 32. Checks every scene counted once, K1 launched twice per
    batch, AP2D and AP3D finite. Returns the numbers PERF.md keeps (the
    eval CLI's speed, until a cell measures it: ROADMAP.md F5) and the
    evaluator's record pairs (for phase 21)."""
    import math
    import torch
    from weakcube_tpu_torch.evaluation import omni3d_eval
    from weakcube_tpu_torch.ops import roi_align_cuda
    from weakcube_tpu_torch.tools import eval_net

    K1 = roi_align_cuda.multilevel_roi_align
    argv = ["--config-file", os.path.join(HERE, "configs", "Omni_combined.yaml"),
            "--synthetic", str(EVAL_SCENES), "--eval-only", "TPU.MESH_SHAPE", "[1]",
            "OUTPUT_DIR", out]
    torch.cuda.reset_peak_memory_stats()
    kept, undo = kept_records(omni3d_eval.Omni3DEvaluator)
    try:
        K1.launches = 0
        t = time.time()
        res = eval_net.main(argv)
        wall = time.time() - t
        launches = K1.launches
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tm = res["timing"]
    if tm["images"] != EVAL_SCENES or len(kept) != EVAL_SCENES:
        fail(f"the eval CLI counted {tm['images']} images ({len(kept)} records), expected "
             f"{EVAL_SCENES}")
    if tm["batches"] != EVAL_SCENES // EVAL_BATCH or launches != 2 * tm["batches"]:
        fail(f"the eval CLI ran {tm['batches']} batches with {launches} K1 launches, expected "
             f"{EVAL_SCENES // EVAL_BATCH} and 2 per batch")
    if not all(math.isfinite(res[k]) for k in ("AP2D", "AP3D")):
        fail(f"AP2D {res['AP2D']}, AP3D {res['AP3D']}")
    n_det = sum(len(d["scores"]) for d, _ in kept)
    n_gt = sum(len(g["classes"]) for _, g in kept)
    print(f"[eval] python -m weakcube_tpu_torch.tools.eval_net --config-file "
          f"configs/Omni_combined.yaml --synthetic {EVAL_SCENES} --eval-only (phase 15's "
          f"model_final.pt, 38 classes, 512 px, bf16, b{tm['batch_size']}): {wall:.1f} s; "
          f"{tm['images']} images counted of {EVAL_SCENES} scenes, {tm['batches']} batches, K1 "
          f"launches {launches} (2 per batch); {n_det} detections, {n_gt} GT")
    print("[eval] AP2D {:.4f} AP3D {:.4f} AP3D@15 {:.4f} AP3D@25 {:.4f} AP3D@50 {:.4f} AP_near "
          "{:.4f} AP_medium {:.4f} AP_far {:.4f}".format(
              *(res.get(k, float("nan")) for k in ("AP2D", "AP3D", "AP3D@15", "AP3D@25",
                                                   "AP3D@50", "AP_near", "AP_medium", "AP_far"))))
    print(f"[timing] eval CLI: {tm['images_per_s']:.2f} images/s end to end (inference loop "
          f"{tm['seconds']:.3f} s), {tm['steady_images_per_s']:.2f} images/s at steady state "
          f"(median of {tm['steady_batches']} batch(es) after the first: {tm['batch_ms']:.1f} ms "
          f"per b{tm['batch_size']} batch = data {tm['data_ms']:.1f} + inference "
          f"{tm['inference_ms']:.1f} + records {tm['records_ms']:.1f} ms; first batch "
          f"{' '.join(f'{x:.1f}' for x in tm['first_batch_ms'])} ms); evaluator "
          f"{tm['evaluator_s']:.3f} s after the loop ({1e3 * tm['evaluator_s'] / tm['batches']:.1f} "
          f"ms per batch, {tm['evaluator_ms_per_image']:.2f} ms per image, IoU3D on the card); "
          f"peak memory {peak:.2f} GiB")
    rep = dict(tm, wall_s=wall, launches=launches, peak_gib=peak,
               **{k: res.get(k, float("nan")) for k in ("AP2D", "AP3D", "AP3D@15", "AP3D@25",
                                                        "AP3D@50", "AP_near", "AP_medium",
                                                        "AP_far")})
    return rep, kept


def eval_k1_phase(dev, out):
    """Phase 20: K1 at an eval batch's shapes: one b32 batch of phase 19's
    records through phase 15's checkpoint with its two K1 calls (box pooler,
    R = POST_NMS_TOPK_TEST 1000; cube pooler, R = DETECTIONS_PER_IMAGE 100)
    kept; K1 held to its plain version on them (in chunks of 8 images),
    timed by kernel_device_ms beside its bound. Returns K1's eval-batch
    numbers."""
    import torch
    from weakcube_tpu_torch.data.build import build_test_batches, to_device
    from weakcube_tpu_torch.models.priors import compute_priors
    from weakcube_tpu_torch.models.rcnn3d import build_model
    from weakcube_tpu_torch.ops import roi_align_cuda
    from weakcube_tpu_torch.tools import eval_net, train_net

    args = train_net.parse_args(["--config-file", os.path.join(HERE, "configs",
                                                               "Omni_combined.yaml"),
                                 "--synthetic", str(EVAL_SCENES), "--eval-only", "OUTPUT_DIR", out])
    cfg = train_net.setup(args)
    records, loaders, ncls = train_net.build_data(cfg, args, "test")
    model = build_model(cfg, compute_priors(cfg, records, max(ncls, cfg.MODEL.ROI_HEADS.NUM_CLASSES)),
                        device=dev)
    eval_net.restore_weights(cfg, model)
    batch = next(build_test_batches(cfg, records, EVAL_BATCH, loaders))
    model_batch = to_device({k: batch[k] for k in ("image", "image_wh", "K")}, dev)
    K1, fwd, calls = roi_align_cuda.multilevel_roi_align, roi_align_cuda._forward, []

    def keep(features, boxes, *a):
        calls.append(([f.clone() for f in features], boxes.clone(), a))
        return fwd(features, boxes, *a)
    roi_align_cuda._forward = keep
    try:
        with torch.no_grad():
            model(model_batch)
    finally:
        roi_align_cuda._forward = fwd
    del model
    torch.cuda.synchronize()
    if len(calls) != 2:
        fail(f"one eval batch made {len(calls)} K1 calls, expected 2")
    calls.sort(key=lambda c: -c[1].shape[1])
    rep = {"ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    for name, (levels, boxes, (strides, out_size, sr, min_level)) in zip(
            ("box pooler", "cube pooler"), calls):
        got = K1(levels, boxes, strides, out_size, sr, min_level)
        for i in range(0, boxes.shape[0], 8):   # the plain version's gathers, 8 images at a time
            want = roi_align_cuda.plain([f[i:i + 8] for f in levels], boxes[i:i + 8], strides,
                                        out_size, sr, min_level)
            rep["max_abs_err"] = max(rep["max_abs_err"], check_close(
                f"K1 {name} images {i}-{i + 7} of the eval batch", got[i:i + 8], want, 1e-2, 1e-2))
            del want
        del got
        ms = kernel_device_ms(lambda: K1(levels, boxes, strides, out_size, sr, min_level), 20)
        bound = k1_bound_ms(levels, boxes, strides, out_size, sr)
        rep["ms"] += ms
        rep["bound_ms"] += bound
        torch.cuda.empty_cache()
        print(f"[timing] K1 on the eval batch, {name} b{boxes.shape[0]} R={boxes.shape[1]} "
              f"({levels[0].dtype}, levels {[tuple(f.shape[1:3]) for f in levels]}): {ms:.4f} ms "
              f"of device time per launch; bound {bound:.4f} ms ({100 * bound / ms:.1f}% of it)")
    print(f"[timing] K1 per eval batch (box + cube pooler, b{EVAL_BATCH}): {rep['ms']:.4f} ms, "
          f"bound {rep['bound_ms']:.4f} ms")
    return rep


def gt_from_detections(kept):
    """Record pairs whose GT is each image's three best detections, moved
    by a few pixels and centimetres and grown by 4% (as
    tests/test_torch_eval_e2e.py makes them): the detections of a barely
    trained model match nothing of the scenes, and these give the
    evaluator's IoU3D and matching real work."""
    import numpy as np
    pairs = []
    for d, _ in kept:
        k = np.argsort(-d["scores"], kind="stable")[:3]
        ctr = d["centers3D"][k] + np.float32([0.04, -0.02, 0.06])
        corners = (d["corners3D"][k] - d["centers3D"][k][:, None]) * np.float32(1.04) + ctr[:, None]
        pairs.append((d, {"image_id": d["image_id"],
                          "boxes": d["boxes"][k] + np.float32([1.5, -1.0, 2.0, 0.5]),
                          "classes": d["classes"][k], "ignore": np.zeros(len(k), bool),
                          "centers3D": ctr, "corners3D": corners}))
    return pairs


def evaluator_phase(dev, kept):
    """Phase 21: phase 19's record pairs, and its detections against GT made
    from them (gt_from_detections), through the evaluator with IoU3D on the
    card and on the CPU: every AP the same within 1e-9 (should a pair's
    IoU3D fall on two sides of a threshold, the card's evaluator is held to
    the CPU's exactly on the CPU's IoUs, and those pairs are printed), and
    each side's seconds per image (until a cell measures the evaluator,
    ROADMAP.md F5)."""
    rep = {}
    for name, pairs in (("phase 19's records", kept),
                        ("its detections against GT made from them", gt_from_detections(kept))):
        rep[name] = evaluator_card_vs_cpu(dev, pairs, name)
    return rep


def evaluator_card_vs_cpu(dev, kept, what):
    import math
    from weakcube_tpu_torch.evaluation import omni3d_eval

    ncls = 38
    res, secs = {}, {}
    for name, device in (("card", dev), ("CPU", "cpu")):
        ev = omni3d_eval.Omni3DEvaluator(ncls, proximity=True, device=device)
        for d, g in kept:
            ev.add(d, g)
        t = time.time()
        res[name] = ev.summarize()
        secs[name] = time.time() - t

    def flat(r):
        out = {k: v for k, v in r.items() if not isinstance(v, dict)}
        for k in ("per_class_2D", "per_class_3D"):
            out.update({f"{k}[{c}]": v for c, v in r[k].items()})
        return out
    a, b = flat(res["card"]), flat(res["CPU"])
    bad = [k for k in b if k not in a or not (abs(a[k] - b[k]) <= 1e-9 or
                                              (math.isnan(a[k]) and math.isnan(b[k])))]
    if bad:
        thrs = omni3d_eval.Omni3DParams("3D").iou_thrs
        cross = []
        for d, g in kept:
            card = omni3d_eval._iou3d_matrix(d["corners3D"], g["corners3D"], dev)
            cpu = omni3d_eval._iou3d_matrix(d["corners3D"], g["corners3D"], "cpu")
            i, j, t = ((card[..., None] >= thrs) != (cpu[..., None] >= thrs)).nonzero()
            cross += [(d["image_id"], int(x), int(y), float(card[x, y]), float(cpu[x, y]))
                      for x, y in zip(i, j)]
        if not cross:
            fail(f"the evaluator on the card and on the CPU differ in {bad[:8]} with no IoU3D "
                 "across a threshold")
        print(f"[evaluator] {len(cross)} IoU3D pair(s) lie on two sides of a threshold on the "
              f"card and the CPU (image, detection, GT, card, CPU): {cross[:8]}")
        compute = omni3d_eval._iou3d_matrix
        omni3d_eval._iou3d_matrix = lambda dt, gt, device: compute(dt, gt, "cpu")
        try:
            ev = omni3d_eval.Omni3DEvaluator(ncls, proximity=True, device=dev)
            for d, g in kept:
                ev.add(d, g)
            again = flat(ev.summarize())
        finally:
            omni3d_eval._iou3d_matrix = compute
        if any(again[k] != b[k] and not (math.isnan(again[k]) and math.isnan(b[k])) for k in b):
            fail("the card's evaluator on the CPU's IoU3D differs from the CPU's evaluator")
    n = len(kept)
    print(f"[evaluator] {what}: {n} images, 38 classes, proximity on: the card and the CPU give "
          f"the same {len(b)} AP values (within 1e-9{'' if not bad else ' on the same IoU3D'}); "
          f"AP2D {b['AP2D']:.6f}, AP3D {b['AP3D']:.6f}, AP3D@50 {b.get('AP3D@50', math.nan):.6f}")
    print(f"[timing] evaluator summarize: IoU3D on the card {secs['card']:.3f} s "
          f"({1e3 * secs['card'] / n:.2f} ms per image), on the CPU {secs['CPU']:.3f} s "
          f"({1e3 * secs['CPU'] / n:.2f} ms per image)")
    return {"card_ms_per_image": 1e3 * secs["card"] / n, "cpu_ms_per_image": 1e3 * secs["CPU"] / n,
            "n_values": len(b), "crossings": bool(bad)}


def periodic_phase(dev, out):
    """Phase 22: the demo on four rendered PNGs with phase 15's model_final,
    which must write four JPEGs; then the train CLI with TEST.EVAL_PERIOD 9
    and VIS_PERIOD 9, resumed from phase 15's model_recent (iteration 8) to
    10: one evaluation of the live model on the 50 scenes and the two
    training-time JPEGs at iteration 9, K1 launched for the steps, the
    evaluation and the vis."""
    import shutil
    import tempfile
    import torch
    from weakcube_tpu_torch.data import synthetic
    from weakcube_tpu_torch.ops import roi_align_cuda
    from weakcube_tpu_torch.solver import checkpoint
    from weakcube_tpu_torch.tools import demo, train_net
    from weakcube_tpu_torch.utils.util import imwrite

    K1, bwd = roi_align_cuda.multilevel_roi_align, roi_align_cuda.roi_align_backward
    config = os.path.join(HERE, "configs", "Omni_combined.yaml")
    weights = os.path.join(out, "model_final" + checkpoint.SUFFIX)
    src = tempfile.mkdtemp(prefix="chip_smoke_demo_")
    try:
        for r in synthetic.make_dataset(4, seed=3):
            imwrite(os.path.join(src, f"scene_{r['image_id']}.png"),
                    synthetic.render_image(r["_scene"]))
        K1.launches = 0
        t = time.time()
        got = demo.main(["--config-file", config, "--input-folder", src, "--output-folder",
                         os.path.join(src, "out"), "MODEL.WEIGHTS", weights])
        demo_s, demo_k1 = time.time() - t, K1.launches
        jpgs = sorted(os.listdir(os.path.join(src, "out")))
    finally:
        shutil.rmtree(src, ignore_errors=True)
    if len(got) != 4 or len(jpgs) != 4 or demo_k1 != 8:
        fail(f"the demo wrote {jpgs} for {len(got)} images with {demo_k1} K1 launches, "
             "expected 4 JPEGs and 8 launches")
    print(f"[demo] python -m weakcube_tpu_torch.tools.demo on 4 rendered 640x480 PNGs (phase "
          f"15's model_final.pt, threshold 0.25): {demo_s:.1f} s, wrote {', '.join(jpgs)}; "
          f"boxes drawn {[len(g['scores']) for g in got]}; K1 launches {demo_k1}")

    K1.launches = bwd.launches = 0
    t = time.time()
    state, hist = train_net.main(["--config-file", config, "--synthetic", "50", "--resume",
                                  "--max-iters", "10", "SOLVER.CHECKPOINT_PERIOD", "4",
                                  "TEST.EVAL_PERIOD", "9", "VIS_PERIOD", "9", "TPU.MESH_SHAPE",
                                  "[1]", "OUTPUT_DIR", out])
    torch.cuda.synchronize()
    wall, k1, kb = time.time() - t, K1.launches, bwd.launches
    evals = [h for h in hist if "eval" in h]
    vis = sorted(os.listdir(os.path.join(out, "vis")))
    if [h["iteration"] for h in hist] != [8, 9] or len(evals) != 1 or \
            evals[0]["iteration"] != 8 or evals[0]["eval"]["timing"]["images"] != 50:
        fail(f"the periodic run: iterations {[h['iteration'] for h in hist]}, evaluations after "
             f"{[h['iteration'] + 1 for h in evals]}, expected one after iteration 9 on 50 images")
    if vis != ["iter_000009_gt.jpg", "iter_000009_gt_vs_pred_3d.jpg"]:
        fail(f"VIS_PERIOD 9 wrote {vis}")
    n_eval_batches = evals[0]["eval"]["timing"]["batches"]
    want_k1 = 2 * 2 + 2 * n_eval_batches + 2
    if k1 != want_k1 or kb != 4:
        fail(f"the periodic run launched K1 {k1} times (expected {want_k1}: 2 steps, "
             f"{n_eval_batches} eval batches and one vis forward) and K1-bwd {kb} (expected 4)")
    res = evals[0]["eval"]
    print(f"[periodic] train_net --resume --max-iters 10 TEST.EVAL_PERIOD 9 VIS_PERIOD 9: "
          f"{wall:.1f} s; one evaluation after iteration 9 on {res['timing']['images']} images "
          f"(AP2D {res['AP2D']:.4f}, AP3D {res['AP3D']:.4f}, "
          f"{res['timing']['seconds']:.2f} s inference + {res['timing']['evaluator_s']:.2f} s "
          f"evaluator), vis {', '.join(vis)}; K1 launches {k1}, K1-bwd {kb}")
    return {"demo_s": demo_s, "periodic_s": wall}


# ------------------------------------------------ every head and loss (PR 11)
ALL_LOSSES = ["dims", "pose_alignment", "pose_ground", "iou", "z", "z_pseudo_gt_patch", "depth",
              "segmentation"]  # the default loss_functions, and segmentation
MASK_SIZE = 64


def config_at(name: str, **opts):
    """configs/<name> (over its bases) at a square TRAIN_SIZE canvas, with
    opts (dotted keys) set."""
    from weakcube_tpu_torch.config import get_cfg
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(HERE, "configs", name))
    cfg.TPU.IMAGE_SIZE = TRAIN_SIZE
    cfg.merge_from_list([x for kv in opts.items() for x in kv])
    cfg.freeze()
    return cfg


def full_width_steps(dev, cfg, batch, label: str, n_calls: int) -> dict:
    """One warm-up and TRAIN_STEPS timed steps of cfg's model (random
    weights from seed 0) on batch through create_train_state + train_step,
    then one step whose pooler calls are kept and held to the kernels'
    plain versions. Fails unless every loss is finite (Cube/IoU3D off its
    tick excepted), every update applied and K1 and K1-bwd launched n_calls
    times per step. Returns the times, peak memory, launches and errors.
    The steps' times are the only record of these configurations' speed
    until cells measure them (ROADMAP.md F2: all losses, F4: supervised and
    2D-only, F7: the backbone sweep)."""
    import numpy as np
    import torch
    from weakcube_tpu_torch.entry import dims_priors
    from weakcube_tpu_torch.models.rcnn3d import build_model
    from weakcube_tpu_torch.ops import roi_align_cuda
    from weakcube_tpu_torch.parallel.train_step import create_train_state, train_step

    K1, bwd = roi_align_cuda.multilevel_roi_align, roi_align_cuda.roi_align_backward
    model = build_model(cfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), device=dev, seed=0)
    state, opt = create_train_state(cfg, model)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_steps = 1 + TRAIN_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K1.launches = bwd.launches = 0
    times, all_logs = [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, logs = train_step(model, opt, state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        all_logs.append(logs)
    k1, kb = K1.launches, bwd.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bad = [(i, k) for i, l in enumerate(all_logs) for k, v in l.items()
           if not np.isfinite(v) and (i == 0 or k != "Cube/IoU3D")]
    if bad:
        fail(f"{label}: non-finite training logs (step, key): {bad[:8]}")
    if state.applied != n_steps or state.skipped:
        fail(f"{label}: {state.applied} of {n_steps} updates applied, {state.skipped} skipped")
    if k1 != n_calls * n_steps or kb != n_calls * n_steps:
        fail(f"{label}: K1 launched {k1} and K1-bwd {kb} times in {n_steps} steps, expected "
             f"{n_calls} each per step")
    ms = statistics.median(times[1:])
    print(f"[{label}] {cfg.MODEL.META_ARCHITECTURE} / {cfg.MODEL.ROI_HEADS.NAME} "
          f"{trunk_name(cfg)} FPN {cfg.MODEL.FPN.OUT_CHANNELS}, "
          f"{cfg.MODEL.ROI_HEADS.NUM_CLASSES} classes, {cfg.TPU.COMPUTE_DTYPE}, LOSS_W_3D "
          f"{cfg.MODEL.ROI_CUBE_HEAD.LOSS_W_3D}, b{TRAIN_BATCH} @ {TRAIN_SIZE} px: {n_steps} "
          f"steps applied, every loss finite; K1 launches {k1}, K1-bwd launches {kb} "
          f"({n_calls} + {n_calls} per step); peak memory {peak:.2f} GiB")
    print(f"[{label}] losses of the last step: " + ", ".join(
        f"{k} {v:.4f}" for k, v in all_logs[-1].items()))
    print(f"[timing] {label} b{TRAIN_BATCH} @ {TRAIN_SIZE} px: median {ms:.3f} ms over "
          f"{TRAIN_STEPS} (each {', '.join(f'{x:.3f}' for x in times)} ms, first is the "
          f"warm-up; spread {min(times[1:]):.3f}-{max(times[1:]):.3f} ms), "
          f"{TRAIN_BATCH * 1e3 / ms:.2f} images/s")
    fwd_calls, bwd_calls = with_pooler_calls_kept(
        lambda: train_step(model, opt, state, batch, gen), n_calls)
    print(f"[compare] K1 and K1-bwd vs plain on the {label}'s own pyramid, boxes and gradients")
    errs = check_pooler_calls(fwd_calls, bwd_calls, f"{label} ")
    return dict(ms=ms, times=times, peak_gib=peak, k1=k1, k1_bwd=kb, errs=errs,
                logs=all_logs[-1])


def heads_phases(dev) -> dict:
    """Phases 25-27: the supervised step at full width (and its 2D-only
    form), the weak step with every loss at full width, and the small
    supervised and all-loss steps on the card against the CPU."""
    import torch
    from weakcube_tpu_torch.entry import flagship_cfg
    from torch_train_check import train_step_card_vs_cpu, with_box_masks, with_random_poses
    from weakcube_tpu_torch.entry import tiny_batch

    rep = {}
    batch = tiny_batch(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, G=TRAIN_GT, seed=0, device=dev)
    # -- 25. supervised Cube R-CNN, and the 2D-only pretrain ------------------
    sup_batch = with_random_poses(batch)
    for key, cfg, n in (("supervised", config_at("cubercnn_DLA34_FPN.yaml"), 2),
                        ("2d_only", config_at("cubercnn_DLA34_FPN.yaml",
                                              **{"MODEL.ROI_CUBE_HEAD.LOSS_W_3D": "0.0"}), 1)):
        t = time.time()
        run = full_width_steps(dev, cfg, sup_batch, f"{key} step", n)
        if key == "2d_only" and any(k.startswith("Cube/") for k in run["logs"]):
            fail(f"the 2D-only step logged cube keys: {sorted(run['logs'])}")
        rep[key] = {k: run[k] for k in ("ms", "times", "peak_gib", "k1", "k1_bwd", "errs")}
        del run
        torch.cuda.empty_cache()
        print(f"[phase] 25 ({key} step) took {time.time() - t:.1f} s")
    # -- 26. the weak step with every loss ----------------------------------------
    t = time.time()
    cfg = flagship_cfg(TRAIN_SIZE).clone()
    cfg.defrost()
    cfg.loss_functions = list(ALL_LOSSES)
    cfg.freeze()
    all_batch = with_box_masks(batch, MASK_SIZE)
    run = full_width_steps(dev, cfg, all_batch, "all-loss weak step", 2)
    want = {"Cube/loss_z", "Cube/loss_pseudo_gt_z", "Cube/loss_depth", "Cube/loss_seg",
            "Cube/loss_iou", "Cube/loss_normal_vec", "Cube/loss_pose", "Cube/loss_dims_w"}
    if not want <= set(run["logs"]):
        fail(f"the all-loss step logged {sorted(run['logs'])}, missing {want - set(run['logs'])}")
    rep["all_losses"] = {k: run[k] for k in ("ms", "times", "peak_gib", "k1", "k1_bwd", "errs")}
    del run
    torch.cuda.empty_cache()
    print(f"[phase] 26 (all-loss weak step) took {time.time() - t:.1f} s")
    # -- 27. the small supervised and all-loss steps, card vs CPU -------------------
    for kind in ("supervised", "all_losses"):
        t = time.time()
        r = train_step_card_vs_cpu(dev, kind)
        print(f"[reference] small float32 {kind} training step, card vs CPU (the same injected "
              f"anchor labels and RoIs): {r['n_losses']} losses and metrics, {r['n_grads']} "
              f"gradients and {r['n_params']} parameters and statistics after the update agree "
              f"(worst relative error "
              f"{', '.join(f'{k} {v:.3e}' for k, v in r['worst_rel'].items())}; bound: 1e-4 of "
              f"scale, 1e-5 for parameters, plus 3x the CPU float32 step's distance to its "
              f"float64 step); {time.time() - t:.1f} s")
    return rep


def recipe_cli_phase(dev, out: str) -> dict:
    """Phase 28: the published recipe through the train CLI at full width
    on 50 synthetic scenes: the 2D-only pretrain
    (configs/Base_Omni3D_2D_only.yaml: RCNN3D, ROIHeads3D, LOSS_W_3D 0) for
    4 iterations, then the weak run (configs/Omni_combined.yaml)
    warm-started from its model_final by MODEL.WEIGHTS_PRETRAIN for 4. K1
    and K1-bwd launch once per 2D-only step and twice per weak step; the
    2D-only run logs no Cube/ key. Returns steps/s (until cells measure
    the CLI's step and the 2D-only pretrain, ROADMAP.md F1 and F4) and
    launches of each."""
    import math
    import torch
    from weakcube_tpu_torch.ops import roi_align_cuda
    from weakcube_tpu_torch.tools import train_net

    K1, bwd = roi_align_cuda.multilevel_roi_align, roi_align_cuda.roi_align_backward
    rep = {}
    stages = (("2d_only", "Base_Omni3D_2D_only.yaml", 1, []),
              ("weak", "Omni_combined.yaml", 2,
               ["MODEL.WEIGHTS_PRETRAIN", os.path.join(out, "2d_only", "model_final.pt")]))
    for key, config, n, extra in stages:
        argv = ["--config-file", os.path.join(HERE, "configs", config), "--synthetic", "50",
                "--max-iters", "4", "SOLVER.CHECKPOINT_PERIOD", "4", "TEST.EVAL_PERIOD", "0",
                "VIS_PERIOD", "0", "TPU.MESH_SHAPE", "[1]", "OUTPUT_DIR",
                os.path.join(out, key), *extra]
        K1.launches = bwd.launches = 0
        t = time.time()
        state, hist = train_net.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t
        k1, kb = K1.launches, bwd.launches
        if state.step != 4 or state.applied != 4:
            fail(f"recipe {key}: step {state.step}, applied {state.applied}, expected 4")
        if k1 != 4 * n or kb != 4 * n:
            fail(f"recipe {key}: K1 {k1} and K1-bwd {kb} launches in 4 steps, expected {4 * n}")
        bad = [(h["iteration"], k) for h in hist for k, v in h["logs"].items()
               if k != "Cube/IoU3D" and not math.isfinite(v)]
        if bad:
            fail(f"recipe {key}: non-finite logs (iteration, key): {bad[:8]}")
        cube = sorted({k for h in hist for k in h["logs"] if k.startswith("Cube/")})
        if (key == "2d_only") == bool(cube):
            fail(f"recipe {key}: cube keys {cube}")
        timed = hist[1:]
        secs = sum(h["data_time"] + h["step_time"] for h in timed)
        rep[key] = {"steps_per_s": len(timed) / secs, "k1": k1, "k1_bwd": kb, "wall_s": wall,
                    "step_ms": [1e3 * h["step_time"] for h in hist],
                    "data_ms": [1e3 * h["data_time"] for h in hist]}
        print(f"[recipe] train_net --config-file configs/{config} --synthetic 50 --max-iters 4 "
              f"{' '.join(extra)}: {wall:.1f} s; K1 launches {k1}, K1-bwd launches {kb} "
              f"({n} + {n} per step); last loss {hist[-1]['logs']['total_loss']:.4f}")
        print(f"[timing] recipe {key} iterations 2-4: {rep[key]['steps_per_s']:.3f} steps/s at "
              f"b25 (data / step ms per iteration: " + ", ".join(
                  f"{d:.1f} / {s_:.1f}" for d, s_ in zip(rep[key]["data_ms"],
                                                          rep[key]["step_ms"])) + ")")
    return rep


# ------------------------------------------------------------- the backbone sweep
SWEEP_CONFIGS = ("cubercnn_ResNet34_FPN.yaml", "cubercnn_shufflenet_FPN.yaml",
                 "cubercnn_mnasnet_FPN.yaml", "cubercnn_densenet_FPN.yaml")
SWEEP_BATCH = 8


def trunk_name(cfg) -> str:
    from weakcube_tpu_torch.models.backbone.build import trunk_name as name
    return name(cfg)


def k1_calls_kept(fn):
    """Run fn() with the inputs of its K1 calls (pyramid, boxes, arguments)
    kept; returns them, the most RoIs first (box pooler, cube pooler)."""
    import torch
    from weakcube_tpu_torch.ops import roi_align_cuda
    calls, fwd = [], roi_align_cuda._forward

    def keep(features, boxes, *args):
        calls.append(([f.detach().clone() for f in features], boxes.clone(), args))
        return fwd(features, boxes, *args)
    roi_align_cuda._forward = keep
    try:
        fn()
    finally:
        roi_align_cuda._forward = fwd
    torch.cuda.synchronize()
    return sorted(calls, key=lambda c: -c[1].shape[1])


def check_k1_calls(calls, label: str) -> float:
    """K1 against its plain version on kept calls, with check_pooler_calls'
    tolerance (bf16: atol 1e-3 of the largest |value|, rtol 1e-2)."""
    import torch
    from weakcube_tpu_torch.ops import roi_align_cuda
    err = 0.0
    for name, (levels, boxes, args) in zip(("box pooler", "cube pooler"), calls):
        want = roi_align_cuda.plain(levels, boxes, *args)
        rtol, atol = (1e-2, 1e-3) if levels[0].dtype == torch.bfloat16 else (1e-5, 2e-5)
        err = max(err, check_close(f"K1 {label} {name} R={boxes.shape[1]} "
                                   f"{str(levels[0].dtype)[6:]}",
                                   roi_align_cuda.multilevel_roi_align(levels, boxes, *args),
                                   want, atol * want.float().abs().max().item(), rtol))
    return err


def check_same_detections(a, b, label: str, atol: float, rtol: float) -> int:
    """The same valid detections in a and b, matched as sets (near-equal
    scores may swap slots); returns their count."""
    import torch
    n = 0
    for i in range(a.valid.shape[0]):
        va, vb = a.valid[i].cpu(), b.valid[i].cpu()
        if int(va.sum()) != int(vb.sum()):
            fail(f"{label}, image {i}: {int(va.sum())} against {int(vb.sum())} valid detections")
        j = match_detections(a, b, i)
        for name in ("boxes", "scores3D", "centers3D"):
            x, y = getattr(b, name)[i].cpu()[vb][j], getattr(a, name)[i].cpu()[va]
            try:
                torch.testing.assert_close(x, y, atol=atol, rtol=rtol)
            except AssertionError as e:
                fail(f"{label}: det.{name} differs: {e}")
        n += len(j)
    return n


def sweep_detection(dev, cfg, label: str) -> dict:
    """30(a): the inference forward of cfg's model (random weights, seed 0)
    at b8 of make_batch at 512 px: one warm-up and 3 timed forwards (until
    a cell measures these trunks, ROADMAP.md F7), the outputs checked, K1
    twice per forward and held to its plain version on a forward's own
    pyramid and boxes. Returns the numbers and the model."""
    import torch
    from weakcube_tpu_torch.entry import dims_priors, make_batch
    from weakcube_tpu_torch.models.rcnn3d import build_model
    from weakcube_tpu_torch.ops import roi_align_cuda
    K1 = roi_align_cuda.multilevel_roi_align
    t = time.time()
    model = build_model(cfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), device=dev, seed=0)
    batch = make_batch(SWEEP_BATCH, TRAIN_SIZE, TRAIN_SIZE, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"[{label}] {cfg.MODEL.META_ARCHITECTURE} / {cfg.MODEL.ROI_HEADS.NAME} "
          f"{trunk_name(cfg)} FPN {cfg.MODEL.FPN.OUT_CHANNELS}, "
          f"{cfg.MODEL.ROI_HEADS.NUM_CLASSES} classes, {cfg.TPU.COMPUTE_DTYPE}, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, built in "
          f"{time.time() - t:.1f} s")
    K1.launches = 0
    times = []
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            det = model(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    k1 = K1.launches
    if k1 != 8:
        fail(f"{label}: K1 launched {k1} times in 4 forwards, expected 8")
    D = cfg.TEST.DETECTIONS_PER_IMAGE
    for name in ("boxes", "scores3D", "centers3D", "dims3D", "poses3D"):
        x = getattr(det, name)
        if x.shape[:2] != (SWEEP_BATCH, D) or not bool(torch.isfinite(x).all()):
            fail(f"{label}: det.{name} {tuple(x.shape)}, finite {bool(torch.isfinite(x).all())}")
    if int(det.valid.sum()) == 0:
        fail(f"{label}: no valid detections")
    with torch.inference_mode():
        calls = k1_calls_kept(lambda: model(batch))
    if len(calls) != 2:
        fail(f"{label}: the kept forward made {len(calls)} K1 calls, expected 2")
    err = check_k1_calls(calls, label)
    ms = statistics.median(times[1:])
    print(f"[timing] {label} forward b{SWEEP_BATCH} @ {TRAIN_SIZE} px: median {ms:.3f} ms over 3 "
          f"(each {', '.join(f'{x:.3f}' for x in times)} ms, first is the warm-up), "
          f"{SWEEP_BATCH * 1e3 / ms:.2f} images/s; K1 launches {k1} (2 per forward); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return dict(ms=ms, times=times, k1=k1, err=err, valid=int(det.valid.sum()), model=model,
                batch=batch, det=det)


def released_load_check(dev, cfg, model, batch, det, out: str) -> dict:
    """30(d): model written as a released detectron2 .pth (detectron2's
    names, which the port's modules carry; fc1 columns in detectron2's
    (C, 7, 7) order; pixel_mean / pixel_std, which the model lacks; no
    num_batches_tracked), loaded through MODEL.WEIGHTS into a fresh model
    (another seed) on the card: every tensor equal, and the detections of
    the model it was written from."""
    import torch
    from weakcube_tpu_torch.entry import dims_priors
    from weakcube_tpu_torch.models.rcnn3d import build_model
    from weakcube_tpu_torch.solver.checkpoint import load_model_weights
    C = cfg.MODEL.FPN.OUT_CHANNELS
    d2 = {}
    for k, x in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        x = x.detach().cpu()
        if k.endswith("fc1.weight") and k.startswith(("roi_heads.box_head",
                                                      "roi_heads.cube_head.feature_generator")):
            r = int(round((x.shape[1] // C) ** 0.5))
            x = x.reshape(x.shape[0], r, r, C).permute(0, 3, 1, 2).reshape(x.shape)
        d2[k] = x.contiguous()
    d2["pixel_mean"] = torch.tensor(cfg.MODEL.PIXEL_MEAN).view(3, 1, 1)
    d2["pixel_std"] = torch.tensor(cfg.MODEL.PIXEL_STD).view(3, 1, 1)
    path = os.path.join(out, "cubercnn_ResNet34_FPN.pth")
    torch.save({"model": d2, "iteration": 0}, path)
    wcfg = cfg.clone()
    wcfg.defrost()
    wcfg.MODEL.WEIGHTS = path
    wcfg.freeze()
    fresh = build_model(wcfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), device=dev, seed=1)
    t = time.time()
    load_model_weights(wcfg.MODEL.WEIGHTS, fresh)
    load_s = time.time() - t
    a, b = model.state_dict(), fresh.state_dict()
    bad = [k for k in a if not k.endswith("num_batches_tracked") and not torch.equal(a[k], b[k])]
    if bad:
        fail(f"the released .pth loaded other tensors: {bad[:8]}")
    with torch.inference_mode():
        got = fresh(batch)
    n = check_same_detections(det, got, "released .pth load", 1e-2, 1e-2)
    same_bits = all(torch.equal(getattr(det, f), getattr(got, f))
                    for f in ("boxes", "scores3D", "centers3D", "dims3D", "poses3D"))
    print(f"[released] {trunk_name(cfg)} written as a detectron2 .pth ({os.path.getsize(path)} B, "
          f"fc1 columns in (C, 7, 7) order, pixel_mean / pixel_std) and loaded through "
          f"MODEL.WEIGHTS into a fresh model on the card in {load_s:.2f} s: {len(a)} tensors "
          f"equal, {n} valid detections the same as the model it was written from "
          f"(bit for bit: {same_bits})")
    return {"tensors": len(a), "detections": n, "same_bits": same_bits}


def backbone_sweep_phase(dev, out: str) -> dict:
    """Phase 30: the backbone sweep. For each of SWEEP_CONFIGS at full width
    (RCNN3D + ROIHeads3D, 38 classes, bf16, 512 px, random weights from seed
    0): (a) detection at b8, (b) the supervised step at b25 of phase 25's
    batch (tiny_batch with random GT poses), K1 and K1-bwd 2 + 2 per step
    and held to their plain versions on a step's own inputs; the card freed
    between configs. (c) the small float32 supervised step of ResNet-18
    (tiny_cfg(128)) with SOLVER.TYPE adam+amsgrad, card vs CPU. (d) the
    ResNet-34 model through a released detectron2 .pth."""
    import torch
    from weakcube_tpu_torch.entry import tiny_batch
    from torch_train_check import _cfg, train_step_card_vs_cpu, with_random_poses
    rep = {}
    batch = with_random_poses(tiny_batch(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, G=TRAIN_GT,
                                         seed=0, device=dev))
    for config in SWEEP_CONFIGS:
        t = time.time()
        cfg = config_at(config)
        key = trunk_name(cfg)
        det = sweep_detection(dev, cfg, f"sweep {key}")
        if config == "cubercnn_ResNet34_FPN.yaml":
            det["released"] = released_load_check(dev, cfg, det["model"], det["batch"],
                                                  det["det"], out)
        for k in ("model", "batch", "det"):
            del det[k]
        torch.cuda.empty_cache()
        run = full_width_steps(dev, cfg, batch, f"sweep {key} step", 2)
        rep[key] = {"detection": det, "train": {k: run[k] for k in ("ms", "times", "peak_gib",
                                                                     "k1", "k1_bwd", "errs")}}
        del run
        torch.cuda.empty_cache()
        print(f"[phase] 30 ({key}) took {time.time() - t:.1f} s")
    t = time.time()
    cfg = _cfg("supervised", dla=False).clone()
    cfg.defrost()
    cfg.SOLVER.TYPE = "adam+amsgrad"
    cfg.freeze()
    r = train_step_card_vs_cpu(dev, "supervised", cfg)
    print(f"[reference] small float32 supervised step of {trunk_name(cfg)} with SOLVER.TYPE "
          f"{cfg.SOLVER.TYPE}, card vs CPU (the same injected anchor labels and RoIs): "
          f"{r['n_losses']} losses and metrics and {r['n_grads']} gradients agree within 1e-4 of "
          f"scale plus 3x the CPU float32 step's distance to its float64 step; the "
          f"{r['n_params']} parameters and statistics after the update within 1e-5 of scale of "
          f"the same Adam update applied on the CPU in float64 to the card's own gradients "
          f"(worst relative error "
          f"{', '.join(f'{k} {v:.3e}' for k, v in r['worst_rel'].items())}); SGD's parameter "
          f"bound, which an Adam update need not meet, read at {r['sgd_bound_excess']:.3f}x; "
          f"{time.time() - t:.1f} s")
    rep["adam_card_vs_cpu"] = r
    return rep


# ---------------------------------------------------------------- data parallel
DP_BATCH, DP_STEPS, DP_RANKS = 8, 3, 2
DP_CLI_PER_CARD = 25  # the flagship's images per card (Omni_combined.yaml's b25)


def dp_cfg(size: int = TRAIN_SIZE):
    """configs/Omni_combined.yaml (38 classes, DLA-34 + FPN 256, the recipe's
    losses) at `size`, computing in float32."""
    from weakcube_tpu_torch.entry import flagship_cfg
    cfg = flagship_cfg(size).clone()
    cfg.defrost()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.freeze()
    return cfg


def deterministic_float32() -> None:
    """Full float32 (no TF32) and cuDNN's deterministic algorithms."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def take_rows(x, idx):
    """Rows idx of every array of a batch (a dict or NamedTuple of tensors)."""
    if isinstance(x, dict):
        return {k: take_rows(v, idx) for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(take_rows(v, idx) for v in x))
    return x[idx.to(x.device)] if getattr(x, "ndim", 0) >= 1 else x


def dp_steps(dev, cfg, batch_size: int, samples=None, order=None, kept: bool = False) -> dict:
    """DP_STEPS training steps of cfg's model (random weights from seed 0) on
    the global batch tiny_batch(batch_size, S, S, G=TRAIN_GT, seed=0), its
    rows in the order `order` (default as made), cut to this process's rows
    in a data-parallel rank; step i draws from a generator seeded with i.
    samples: per step the global batch's anchor labels and RoIs to inject
    (ordered and cut like the batch), or None: drawn, and returned.
    kept: the first step runs under with_pooler_calls_kept. Returns the
    logs per step, the TrainState, the samples, the state dict before the
    first step and after the first and the last (on the CPU) and the kept
    calls."""
    import torch
    from weakcube_tpu_torch.entry import dims_priors, tiny_batch
    from weakcube_tpu_torch.models import roi_heads, rpn
    from weakcube_tpu_torch.models.rcnn3d import build_model
    from weakcube_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from weakcube_tpu_torch.parallel.train_step import create_train_state, train_step
    mesh, size = make_mesh(), cfg.TPU.IMAGE_SIZE
    model = build_model(cfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), device=dev, seed=0,
                        dtype=torch.float32)
    state, opt = create_train_state(cfg, model)
    order = torch.arange(batch_size) if order is None else order

    def part(x):
        return shard_batch(take_rows(x, order), mesh)
    batch = part(tiny_batch(batch_size, size, size, G=TRAIN_GT, seed=0, device=dev))
    sample_anchors, sample_rois = rpn.label_and_sample_anchors, roi_heads.label_and_sample_proposals
    out, drawn = {"logs": [], "kept": None}, []
    out["init"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    for i in range(DP_STEPS):
        cur, step_batch = {}, batch
        if samples is None:
            def spy_anchors(*a, **k):
                cur["rpn"] = sample_anchors(*a, **k)
                return cur["rpn"]

            def spy_rois(*a, **k):
                cur["rois"] = sample_rois(*a, **k)
                return cur["rois"]
            rpn.label_and_sample_anchors, roi_heads.label_and_sample_proposals = (spy_anchors,
                                                                                  spy_rois)
        else:
            step_batch = dict(batch, rpn_labels=part(samples[i][0]))
            cur["rois"] = part(samples[i][1])
            roi_heads.label_and_sample_proposals = lambda *a, **k: cur["rois"]

        def step():
            nonlocal state
            state, logs = train_step(model, opt, state, step_batch,
                                     torch.Generator(device=dev).manual_seed(i))
            out["logs"].append(logs)
        try:
            if kept and i == 0:
                out["kept"] = with_pooler_calls_kept(step)
            else:
                step()
        finally:
            rpn.label_and_sample_anchors, roi_heads.label_and_sample_proposals = (sample_anchors,
                                                                                  sample_rois)
        if samples is None:
            drawn.append((cur["rpn"], cur["rois"]))
        if i in (0, DP_STEPS - 1):
            out[f"after_{i + 1}"] = {k: v.detach().cpu().clone()
                                     for k, v in model.state_dict().items()}
    out.update(state=state, samples=samples or drawn)
    return out


def fingerprints(state_dict: dict) -> list:
    import hashlib
    return [hashlib.sha1(v.contiguous().numpy().tobytes()).hexdigest()
            for v in state_dict.values()]


def _dp_rank(rank: int, address: str, tmp: str, cfg, batch_size: int, device: str) -> None:
    """One DP-step rank (a spawned process): joins the gloo group, checks its
    Gumbel draws, takes the DP_STEPS steps on its rows with the one-process
    run's samples injected (the first under with_pooler_calls_kept), holds
    K1 and K1-bwd to their plain versions on its own pooler inputs and
    times them (one rank at a time on the shared card), and writes its
    report to tmp/rank<r>.pt."""
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import torch
    from weakcube_tpu_torch.ops import roi_align_cuda, sampling
    from weakcube_tpu_torch.parallel import distributed
    from weakcube_tpu_torch.parallel.mesh import Mesh, shard_batch
    dev = torch.device(device)
    if dev.type == "cuda":
        deterministic_float32()
    # gloo, not NCCL: both ranks share the one card, and NCCL puts one rank
    # on a card; gloo's CUDA support covers the all-reduces of the step
    torch.distributed.init_process_group("gloo", init_method=address, world_size=DP_RANKS,
                                         rank=rank, timeout=distributed.TIMEOUT)
    try:
        d = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False, map_location=dev)
        g = sampling.gumbel((batch_size // DP_RANKS, d["gumbel"].shape[1]),
                            torch.Generator(device=dev).manual_seed(5))
        K1, bwd = roi_align_cuda.multilevel_roi_align, roi_align_cuda.roi_align_backward
        K1.launches = bwd.launches = 0
        run = dp_steps(dev, cfg, batch_size, samples=d["samples"], kept=dev.type == "cuda")
        rep = {"rank": rank, "logs": run["logs"], "state": run["state"], "k1": K1.launches,
               "k1_bwd": bwd.launches,
               "gumbel_rows_equal": torch.equal(g, shard_batch(d["gumbel"],
                                                               Mesh(DP_RANKS, rank))),
               "prints": [fingerprints(run[k]) for k in ("after_1", f"after_{DP_STEPS}")]}
        if rank == 0:
            rep.update(after_1=run["after_1"], after_last=run[f"after_{DP_STEPS}"])
        for r in range(DP_RANKS):  # one rank at a time on the shared card
            if r == rank and run["kept"]:
                fwd_calls, bwd_calls = run["kept"]
                rep["errs"] = check_pooler_calls(fwd_calls, bwd_calls, f"rank {rank} ")
                rep["ms"] = {
                    "K1": sum(kernel_device_ms(lambda: K1(lv, b, *a), 20) for lv, b, a in fwd_calls),
                    "K1-bwd": sum(kernel_device_ms(lambda: bwd(gr, b, *a), 20)
                                  for gr, b, a in bwd_calls)}
            distributed.barrier()
        torch.save(rep, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


def dp_step_phase(dev, cfg=None, batch_size: int = DP_BATCH) -> dict:
    """Phase 23 (DP-step): two data-parallel ranks over gloo, both on this
    card, each with batch_size / 2 rows of the global batch, against one
    process on the global batch, the full-width flagship in float32 (TF32
    off, cuDNN deterministic), the same weights, generators and samples:
    after the first and the last of DP_STEPS steps, every log, the skip
    decision, every parameter and BatchNorm statistic. The split reorders
    float32 sums (BatchNorm's sums over the batch, the loss numerators, the
    gradients: each is two partial sums added by an all-reduce), so each
    log and tensor is held to three times the one-process run's own
    difference under such a reordering, measured: the same steps on the
    same rows rolled by one and reversed (the samples with them), and with
    PyTorch's convolutions in place of cuDNN's. A tensor after a step
    (parameter or statistic) is held to the larger of its own reordered
    runs' difference and its group's median difference as a share of a
    tensor's change from its initial value, times its own change; a log,
    one number, to its step's largest difference as a share of a log's
    value, times its value; each plus 2^-22 of its scale (two float32 roundings of it: the all-reduce's add and the
    division by the global count, or the update's add). A fault in the
    update (a wrong share of the gradient) moves a tensor by a part of its
    change, which its bound, a small share of that change, does not hide.
    The ranks draw the same Gumbel noise as
    one process, row for row; they hold the same bits after each step; each
    launches K1 and K1-bwd twice per step, holds them to their plain
    versions on its own inputs and times them. Returns the numbers PERF.md
    keeps."""
    import math
    import shutil
    import tempfile
    import torch
    import torch.multiprocessing as mp
    from weakcube_tpu_torch.ops import sampling
    from weakcube_tpu_torch.parallel.distributed import free_port
    cfg = cfg or dp_cfg()
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    if dev.type == "cuda":
        deterministic_float32()
    t = time.time()
    one = dp_steps(dev, cfg, batch_size)
    # the reference's own reorderings: its rows rolled by one, and reversed
    # (a roll by half the batch would leave a sum split at the middle as it
    # was), which reorder the sums over the batch; and PyTorch's own
    # convolutions in place of cuDNN's, which reorder each image's sums, as
    # cuDNN's choice of algorithm for the ranks' b4 does
    orders = [torch.roll(torch.arange(batch_size), 1), torch.arange(batch_size).flip(0)]
    others = [dp_steps(dev, cfg, batch_size, samples=one["samples"], order=o) for o in orders]
    torch.backends.cudnn.enabled = False
    try:
        others.append(dp_steps(dev, cfg, batch_size, samples=one["samples"]))
    finally:
        torch.backends.cudnn.enabled = True
    print(f"[dp-step] one process, b{batch_size} @ {cfg.TPU.IMAGE_SIZE} px float32, {DP_STEPS} "
          f"steps, and again on its rows rolled by one, reversed, and without cuDNN: "
          f"{time.time() - t:.1f} s; applied {one['state'].applied}, "
          f"{[o['state'].applied for o in others]}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        n_anchors = one["samples"][0][0].labels.shape[1]
        torch.save({"samples": one["samples"],
                    "gumbel": sampling.gumbel((batch_size, n_anchors),
                                              torch.Generator(device=dev).manual_seed(5))},
                   os.path.join(tmp, "inputs.pt"))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t = time.time()
        ctx = mp.start_processes(_dp_rank, args=(f"tcp://localhost:{free_port()}", tmp, cfg,
                                                 batch_size, str(dev)),
                                 nprocs=DP_RANKS, join=False, start_method="spawn")
        deadline = time.time() + 900
        try:
            while not ctx.join(timeout=5):
                if time.time() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    fail("the DP-step ranks did not finish in 900 s")
        except Exception as e:  # a rank raised or exited: its error, then fail
            fail(f"a DP-step rank failed: {e}")
        wall = time.time() - t
        reps = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(DP_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    for rep in reps:
        if not rep["gumbel_rows_equal"]:
            fail(f"rank {rep['rank']}: its Gumbel draws are not its rows of the global draw")
        if rep["prints"] != reps[0]["prints"]:
            fail(f"rank {rep['rank']} holds other parameters or statistics than rank 0")
        if dev.type == "cuda" and (rep["k1"] != 2 * DP_STEPS or rep["k1_bwd"] != 2 * DP_STEPS):
            fail(f"rank {rep['rank']} launched K1 {rep['k1']} and K1-bwd {rep['k1_bwd']} times "
                 f"in {DP_STEPS} steps, expected {2 * DP_STEPS} each")
        if any(rep["logs"][i][k] != v and not (math.isnan(v) and math.isnan(rep["logs"][i][k]))
               for i, logs in enumerate(reps[0]["logs"]) for k, v in logs.items()):
            fail(f"rank {rep['rank']} logged other values than rank 0")
    got, worst, n = reps[0], [0.0, ""], 0
    st, st1 = got["state"], one["state"]
    if (st.step, st.applied, st.skipped) != (st1.step, st1.applied, st1.skipped):
        fail(f"the ranks' TrainState {st} differs from one process's {st1}")
    for i in range(DP_STEPS):
        if {k: got["logs"][i][k] for k in ("diverging", "grad_finite")} != \
                {k: one["logs"][i][k] for k in ("diverging", "grad_finite")}:
            fail(f"step {i}: the ranks' skip decision differs from one process's")
    # each member: (the ranks' value, one process's, the reordered runs', its
    # value before the steps: 0 for a log, the initial weights for a tensor)
    groups = [(f"step {i} logs", {k: (got["logs"][i][k], a, [o["logs"][i][k] for o in others], 0.0)
                                  for k, a in one["logs"][i].items()}) for i in range(DP_STEPS)]
    for which, key in (("after_1", "after_1"), (f"after_{DP_STEPS}", "after_last")):
        for name, a in one[which].items():
            if not a.is_floating_point() and not torch.equal(got[key][name], a):
                fail(f"DP-step {name} {which}: {got[key][name]} vs {a}")
        groups.append((f"state {which}", {
            name: (got[key][name], a, [o[which][name] for o in others], one["init"][name])
            for name, a in one[which].items() if a.is_floating_point()}))
    ref = {}
    for group, members in groups:
        # per member: its own reordered runs' largest difference r, its change
        # c over the steps (its value, for a log) and its scale s. A tensor's
        # r is the largest of its many elements' differences, a stable
        # yardstick; the group's median r / c holds a tensor whose own
        # reorderings happened to agree closely (or whose change is a
        # rounding of its value) to the group's typical share of the change.
        # A log is one number, too noisy a yardstick alone: a log is held to
        # the group's largest r / c, times its value
        logs = group.endswith("logs")
        rows = []
        for name, (d, a, bs, base) in members.items():
            d, a = torch.as_tensor(d).double(), torch.as_tensor(a).double()
            bs = [torch.as_tensor(b).double() for b in bs]
            finite = torch.isfinite(a)
            if any(not torch.equal(finite, torch.isfinite(x)) for x in [d, *bs]):
                fail(f"DP-step {group} {name}: finite where one process is not, or the other way")
            if finite.any():
                delta = (a - torch.as_tensor(base).double())[finite]
                rows.append((name, float((d - a)[finite].abs().max()),
                             max(float((b - a)[finite].abs().max()) for b in bs),
                             float(delta.abs().max()), float(a[finite].abs().max())))
        rho = (max if logs else statistics.median)([r / c for _, _, r, c, _ in rows if c > 0]
                                                    or [0.0])
        held, own = [], 0
        for name, err, r, c, scale in rows:
            bound = 3 * max(r, rho * c) + 2.0 ** -22 * scale
            own += r > rho * c
            n += 1
            if err > bound:
                fail(f"DP-step {group} {name}: max |2 ranks - 1 process| {err:.4e} > bound "
                     f"{bound:.4e} (3 x max(its reordered runs' {r:.3e}, {rho:.3e} x its change "
                     f"{c:.4e}) + 2^-22 x its scale {scale:.4e})")
            if err and err / bound > worst[0]:
                worst[:] = [err / bound, f"{group} {name}"]
            if c > 0:
                held.append(bound / c)
        ref[group] = {"r_over_change": rho, "own_r_sets": own, "members": len(rows),
                      "median_bound_over_change": statistics.median(held or [0.0])}
        print(f"[dp-step] {group}: {len(rows)} members; the reordered runs' "
              f"{'largest' if logs else 'median'} difference {rho:.3e} of a member's change; "
              f"{own} held to their own larger difference; a member's bound is a median "
              f"{ref[group]['median_bound_over_change']:.3e} of its change")
    ms = [r["ms"] for r in reps if "ms" in r]
    print(f"[dp-step] {DP_RANKS} ranks over gloo on one card, b{batch_size // DP_RANKS} each, "
          f"{DP_STEPS} steps: {wall:.1f} s (spawn, build, steps, checks); every rank's Gumbel "
          f"draws are its rows of the global draw; the replicas hold the same bits after steps "
          f"1 and {DP_STEPS}; {n} logs and tensors held to one process within 3 x max(their "
          f"reordered runs' difference, the group's largest (logs) or median (tensors) share "
          f"of their change) + 2^-22 x their scale (worst {worst[0]:.3f} of its bound, "
          f"{worst[1]}); "
          f"skip decisions equal; K1 and K1-bwd launched {reps[0]['k1']} and "
          f"{reps[0]['k1_bwd']} times on each rank")
    for r, m in enumerate(ms):
        print(f"[timing] DP-step rank {r}: K1 {m['K1']:.4f} ms and K1-bwd {m['K1-bwd']:.4f} ms of "
              f"device time per step (box + cube pooler, b{batch_size // DP_RANKS}, 20 calls "
              "queued behind a sleep kernel, one rank at a time)")
    return {"k1": sum(r["k1"] for r in reps), "k1_bwd": sum(r["k1_bwd"] for r in reps),
            "errs": {k: max(r["errs"][k] for r in reps) for k in ("K1", "K1-bwd")}
            if all("errs" in r for r in reps) else {"K1": 0.0, "K1-bwd": 0.0},
            "ms": ms, "worst": worst[0], "compared": n, "reference": ref}


def nccl_in_trace(path: str, bn_sizes: set, steps: int) -> dict:
    """From rank 0's torch.profiler chrome trace of `steps` training steps:
    the NCCL kernels per step and their device ms, split by the message
    each moved (In msg nelems of the collective's CPU op, found through the
    kernel's launch on the host): BatchNorm statistics (2C + 1 elements),
    gradient buckets (more than 1e5 elements), other (counts, logs), and
    unattributed where the trace does not link them; the other kernels'
    device ms per step against the kernels' span (the device's busy
    share); K1's and K1-bwd's launches."""
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    kernels = [e for e in ev if e.get("cat") == "kernel"]
    launches = {e["args"].get("correlation"): e for e in ev
                if e.get("cat", "").startswith("cuda_") and "args" in e}  # API calls
    comms = [e for e in ev if e.get("cat") == "cpu_op" and "In msg nelems" in e.get("args", {})]
    out = {k: [0, 0.0] for k in ("BatchNorm statistics", "gradient buckets", "other",
                                 "unattributed")}
    for k in kernels:
        if "nccl" not in k["name"].lower():
            continue
        at = launches.get(k.get("args", {}).get("correlation"))
        op = next((c for c in comms if at is not None and c["tid"] == at["tid"]
                   and c["ts"] <= at["ts"] <= c["ts"] + c.get("dur", 0)), None)
        n = int(op["args"]["In msg nelems"]) if op else None
        kind = ("unattributed" if n is None else "BatchNorm statistics" if n in bn_sizes
                else "gradient buckets" if n > 1e5 else "other")
        out[kind][0] += 1
        out[kind][1] += k.get("dur", 0) / 1e3
    res = {k: {"per_step": c / steps, "ms_per_step": ms / steps} for k, (c, ms) in out.items()}
    compute = [k for k in kernels if "nccl" not in k["name"].lower()]
    if compute:
        span = max(k["ts"] + k.get("dur", 0) for k in kernels) - min(k["ts"] for k in kernels)
        res["busy_ms_per_step"] = sum(k.get("dur", 0) for k in compute) / 1e3 / steps
        res["window_ms_per_step"] = span / 1e3 / steps
    res["K1_launches"] = sum(1 for k in kernels if "roi_align_kernel" in k["name"])
    res["K1_bwd_launches"] = sum(1 for k in kernels if "roi_align_bwd_kernel" in k["name"])
    return res


def dp_cli_phase(dev) -> dict:
    """Phase 24 (DP-CLI), where at least 2 cards are visible: the train CLI
    over W = 1, 2, 4, ... cards up to all of them, one process each over
    NCCL (TPU.MESH_SHAPE [W], [-1] for all), the flagship at 25 images per
    card (SOLVER.IMS_PER_BATCH 25 W) on 8 W synthetic scenes: 6 iterations
    with a checkpoint at 4 (images/s, each rank's data and step ms), then
    --resume to 8 under --profile (rank 0's NCCL kernels per step by kind,
    K1 and K1-bwd in the trace); each rank's mapper ms (its 25 rows of a
    global batch, one thread); at all cards, the eval CLI sharded over them
    on that checkpoint. On one card it prints that it was not run. Its
    images/s, NCCL kernels and scaling are the only record of data
    parallel's speed until a cell measures it (ROADMAP.md F3)."""
    import math
    import shutil
    import tempfile
    import torch
    from weakcube_tpu_torch.data.build import build_train_batches
    from weakcube_tpu_torch.entry import dims_priors
    from weakcube_tpu_torch.models.layers import BatchNorm2d
    from weakcube_tpu_torch.models.rcnn3d import build_model
    from weakcube_tpu_torch.tools import eval_net, train_net
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"[dp-cli] needs 2 or more cards; {cards} visible: not run")
        return {}
    cfg = dp_cfg()
    model = build_model(cfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), device="cpu")
    n_params = sum(p.numel() for p in model.parameters())
    bn_sizes = {2 * m.num_features + 1 for m in model.modules() if isinstance(m, BatchNorm2d)}
    n_bn = sum(isinstance(m, BatchNorm2d) for m in model.modules())
    del model
    worlds = sorted({w for w in (1, 2, 4, 8) if w < cards} | {cards})
    print(f"[dp-cli] {cards} cards; W = {worlds}; {n_params} parameters, gradient bytes per "
          f"step {4 * n_params} (float32); {n_bn} BatchNorm layers, each one all-reduce in the "
          "forward and one in the backward")
    rep = {}
    for W in worlds:
        out = tempfile.mkdtemp(prefix=f"chip_smoke_dp{W}_")
        try:
            base = ["--config-file", os.path.join(HERE, "configs", "Omni_combined.yaml"),
                    "--synthetic", str(8 * W)]
            opts = ["SOLVER.IMS_PER_BATCH", str(DP_CLI_PER_CARD * W), "SOLVER.CHECKPOINT_PERIOD",
                    "4", "TEST.EVAL_PERIOD", "0", "VIS_PERIOD", "0", "TPU.MESH_SHAPE",
                    "[-1]" if W == cards else f"[{W}]", "OUTPUT_DIR", out]
            t = time.time()
            state, hist = train_net.main(base + ["--max-iters", "6"] + opts)
            wall = time.time() - t
            bad = [(h["iteration"], k) for h in hist for k, v in h["logs"].items()
                   if k != "Cube/IoU3D" and not math.isfinite(v)]
            if state.step != 6 or bad:
                fail(f"DP-CLI W={W}: step {state.step}, non-finite logs {bad[:6]}")
            with open(os.path.join(out, "metrics.json")) as f:
                lines = [json.loads(x) for x in f]
            if [x["iteration"] for x in lines] != [6]:
                fail(f"DP-CLI W={W}: metrics.json holds iterations "
                     f"{[x['iteration'] for x in lines]}, expected [6] (rank 0 alone)")
            timed = hist[1:]
            secs = sum(h["data_time"] + h["step_time"] for h in timed)
            ranks = [h.get("rank_times", [(h["data_time"], h["step_time"])]) for h in timed]
            per_rank = [(1e3 * statistics.median(r[i][0] for r in ranks),
                         1e3 * statistics.median(r[i][1] for r in ranks)) for i in range(W)]
            ips = DP_CLI_PER_CARD * W * len(timed) / secs
            state2, hist2 = train_net.main(base + ["--resume", "--profile", "--max-iters", "8"]
                                           + opts)
            if hist2[0]["iteration"] != 4 or state2.step != 8:
                fail(f"DP-CLI W={W}: --resume started at {hist2[0]['iteration']}, ended at "
                     f"{state2.step}, expected 4 and 8")
            trace = os.path.join(out, "profile", "trace.json")
            nccl = nccl_in_trace(trace, bn_sizes, 2) if os.path.exists(trace) else None
            args = train_net.parse_args(base + ["--max-iters", "6"] + opts)
            wcfg = train_net.setup(args)
            records, loaders, _ = train_net.build_data(wcfg, args)
            map_ms = []
            for r in range(W):
                it = build_train_batches(wcfg, records, loaders=loaders, rank=r, world=W)
                next(it)  # renders the scenes
                t0 = time.perf_counter()
                for _ in range(3):
                    next(it)
                map_ms.append((time.perf_counter() - t0) / 3 * 1e3)
            rep[W] = {"images_per_s": ips, "per_rank_ms": per_rank, "wall_s": wall,
                      "nccl": nccl, "mapper_ms": map_ms}
            print(f"[dp-cli] W={W}: train_net --synthetic {8 * W} SOLVER.IMS_PER_BATCH "
                  f"{DP_CLI_PER_CARD * W} TPU.MESH_SHAPE {opts[9]}: {wall:.1f} s; iterations 2-6 "
                  f"{ips:.2f} images/s ({ips / W:.2f} per card); per rank median data / step ms "
                  f"{', '.join(f'{d:.1f} / {s:.1f}' for d, s in per_rank)}; each rank's mapper "
                  f"alone (its {DP_CLI_PER_CARD} rows, one thread) "
                  f"{', '.join(f'{m:.1f}' for m in map_ms)} ms per batch")
            if nccl is None:
                print(f"[dp-cli] W={W}: no profiler trace: NCCL time not measured")
            else:
                ring = 2 * (W - 1) / W * 4 * n_params
                print(f"[dp-cli] W={W}: rank 0's NCCL kernels per step (profiled iterations 6-7): "
                      + "; ".join(f"{k} {v['per_step']:.1f} launches, {v['ms_per_step']:.3f} ms"
                                  for k, v in nccl.items() if isinstance(v, dict))
                      + f"; K1 {nccl['K1_launches']} and K1-bwd {nccl['K1_bwd_launches']} "
                      f"launches in 2 steps; the gradients' ring all-reduce moves {ring:.4e} B "
                      f"per card each way, {1e3 * ring / 450e9:.3f} ms at NVLink's 450 GB/s")
                if "busy_ms_per_step" in nccl:
                    busy, span = nccl["busy_ms_per_step"], nccl["window_ms_per_step"]
                    print(f"[dp-cli] W={W}: rank 0's card busy with other kernels "
                          f"{busy:.3f} ms per step of a {span:.3f} ms span per step (first to "
                          f"last kernel of the 2 profiled steps): idle {100 * (1 - busy / span):.1f}%")
            if W == cards:
                res = eval_net.main(["--config-file", os.path.join(HERE, "configs",
                                                                   "Omni_combined.yaml"),
                                     "--synthetic", str(8 * W), "--eval-only", "TPU.MESH_SHAPE",
                                     "[-1]", "OUTPUT_DIR", out])
                tm = res["timing"]
                if tm["images"] != 8 * W or tm["processes"] != W or \
                        not all(math.isfinite(res[k]) for k in ("AP2D", "AP3D")):
                    fail(f"DP-CLI eval over {W} cards: {tm['images']} images, "
                         f"{tm['processes']} processes, AP2D {res['AP2D']}, AP3D {res['AP3D']}")
                rep[W]["eval"] = tm
                print(f"[dp-cli] eval_net over {W} cards on that checkpoint: {tm['images']} "
                      f"images in {tm['batches']} global batches of {tm['batch_size']}, "
                      f"{tm['images_per_s']:.2f} images/s end to end; AP2D {res['AP2D']:.4f}, "
                      f"AP3D {res['AP3D']:.4f}")
        finally:
            shutil.rmtree(out, ignore_errors=True)
    base_ips = rep[1]["images_per_s"]
    print("[dp-cli] scaling: " + ", ".join(
        f"W={W} {r['images_per_s']:.2f} images/s ({100 * r['images_per_s'] / (W * base_ips):.1f}% "
        "of W x W=1's)" for W, r in rep.items()))
    return rep


def nms_phase(dev) -> dict:
    """Phase 32: the NMS kernel at the cells' shapes against the plain fixed
    point (bit for bit), its device time beside the bytes nms_mask needs.
    Returns the kernels-line entry (ms per shape)."""
    import torch
    import torch_nms_boxes as nms_boxes
    from harness import bounds
    from weakcube_tpu_torch.ops import nms as nms_ops
    for line in nms_ops.build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "smem")):
            print(f"  ptxas: {line.strip()}")
    # design targets for the RPN calls, set by the greedy chain's latency
    targets = {"rpn_train": 0.5, "rpn_detect": 0.15, "box_detect": None}
    entry = {"name": "nms_mask (greedy NMS, one block per problem)", "route": "cuda",
             "source": NMS_SOURCE, "replaces": NMS_REPLACES, "bound_by": "bytes",
             "paced_by": "the greedy chain's latency: ceil(n / 64) chunk steps of two block "
                         "barriers each (csrc/nms.cu's note); not bounded here", "shapes": {}}
    for shape, target in targets.items():
        call = nms_boxes.cell_call(shape, seed=32)
        on = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in call.items()}
        got = nms_boxes.run(on, dev)
        want = nms_boxes.run(on, dev, nms_ops.nms_mask_plain)
        if not torch.equal(got, want):
            fail(f"NMS kernel differs from the plain fixed point at {shape}: "
                 f"{int((got != want).sum())} of {got.numel()} flags")
        boxes = on["boxes"] if on["classes"] is None else nms_boxes.class_offset_boxes(on)
        n = boxes.shape[-2]
        boxes = boxes.reshape(-1, n, 4).contiguous()
        M = boxes.shape[0]
        valid = on["valid"].reshape(M, n).contiguous()
        order = nms_ops._rank_order(on["scores"].reshape(M, n), valid).contiguous()
        keep = torch.empty_like(valid)
        ms = kernel_device_ms(lambda: nms_ops.launch(boxes, order, valid, keep, on["thr"]), 20)
        if not torch.equal(keep, got.reshape(M, n)):
            fail(f"the NMS kernel launched alone differs from nms_mask at {shape}")
        call_ms = kernel_device_ms(lambda: nms_boxes.run(on, dev), 20)
        # the bytes nms_mask needs: each box, score and valid flag read once,
        # the mask written once (the rank order is the wrapper's own)
        bound = (M * n * (16 + on["scores"].element_size() + 1 + 1) / bounds.PEAK_BYTES_PER_S
                 * 1e3)
        kept = int(got.sum())
        print(f"[nms] {shape}: {M} x {n}, {kept} of {int(valid.sum())} valid boxes kept, equal "
              f"bit for bit; kernel {ms:.4f} ms device per launch (target {target} ms), the "
              f"nms_mask call (rank sort + kernel) {call_ms:.4f}, byte bound {bound:.4f} ms "
              f"({100 * bound / ms:.2f}%; the greedy chain's {-(-n // 64)} chunk steps pace it)")
        entry["shapes"][shape] = {"M": M, "n": n, "kept": kept, "ms": ms, "call_ms": call_ms,
                                  "bound_ms": bound}
    return entry


def bn_shapes(dev) -> list:
    """The BatchNorm calls of one b25 training step at 512 px of the
    flagship model (DLA-34): (shape, dtype, whether a gradient is taken),
    in call order, from one training forward of its backbone."""
    import torch
    from weakcube_tpu_torch.entry import dims_priors, flagship_cfg, make_batch
    from weakcube_tpu_torch.models.layers import BatchNorm2d
    from weakcube_tpu_torch.models.rcnn3d import build_model
    cfg = flagship_cfg(TRAIN_SIZE)
    model = build_model(cfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), device=dev, seed=1)
    model.train()
    calls = []

    def hook(module, args):
        x = args[0]
        if not x.is_contiguous(memory_format=torch.channels_last):
            fail(f"a BatchNorm input of shape {tuple(x.shape)} is not channels_last")
        calls.append((tuple(x.shape), x.dtype, torch.is_grad_enabled()))
    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, BatchNorm2d)]
    images = make_batch(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, seed=5, device=dev)["image"]
    model.backbone(model._prep_image(images))
    for h in hooks:
        h.remove()
    del model
    torch.cuda.empty_cache()
    return calls


def bn_phase(dev) -> dict:
    """Phase 33: BatchNorm's training kernels (csrc/batch_norm.cu) on the 39
    BatchNorm calls of the b25 step at 512 px: per call, the kernels'
    launches, y and dx held to the plain chain (models/layers.py with the
    kernels switched off) on the same tensors, and the kernels' device ms
    forward and backward against the least bytes the function needs
    (`bound_ms`: forward x read and y written, backward g and x read and dx
    written) over HBM bandwidth. Returns the kernels-line entry (ms a step)
    with `launches_a_step`, the kernels' launches in one step's calls."""
    from unittest import mock
    import torch
    from harness import bounds
    from weakcube_tpu_torch.models.layers import BatchNorm2d
    from weakcube_tpu_torch.ops import batch_norm_cuda as bnc
    for line in bnc.build_log.splitlines():
        if any(w in line for w in ("registers", "spill")):
            print(f"  ptxas: {line.strip()}")
    calls = bn_shapes(dev)
    print(f"[bn] {len(calls)} BatchNorm calls in the b{TRAIN_BATCH} step's backbone forward, "
          f"{sum(not c[2] for c in calls)} without a gradient (the dead project)")
    gen = torch.Generator(device=dev).manual_seed(33)
    plain_off = mock.patch.object(bnc, "takes", lambda *a: False)
    tot = {"ms": 0.0, "bound_ms": 0.0}
    for i, (shape, dt, grad) in enumerate(calls):
        N, C, H, W = shape
        x = torch.randn((N, H, W, C), generator=gen, device=dev).to(dt).permute(0, 3, 1, 2)
        g = torch.randn((N, H, W, C), generator=gen, device=dev).to(dt).permute(0, 3, 1, 2)
        bn = BatchNorm2d(C).to(dev).train()
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=gen)
            bn.bias.normal_(generator=gen)
        args = (bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.momentum, bn.eps)
        xr = x.detach().requires_grad_(grad)

        def kernel_step():
            y = bn(xr)
            if grad:
                y.backward(g)
            return y
        before = (bnc.batch_norm_train.launches, bnc.batch_norm_train_backward.launches)
        y_k = kernel_step()
        dx_k = xr.grad if grad else None
        xr.grad = None
        after = (bnc.batch_norm_train.launches, bnc.batch_norm_train_backward.launches)
        if after != (before[0] + 2, before[1] + 2 * grad):
            fail(f"BatchNorm call {i}: launches {before} -> {after}")
        with plain_off:
            y_p = kernel_step()
        for name, a, b in (("y", y_k, y_p), ("dx", dx_k, xr.grad)):
            if a is None:
                continue
            err = float((a.float() - b.float()).abs().max() / b.float().abs().max())
            if not err <= 1e-2:  # a few bf16 steps of the largest value
                fail(f"BatchNorm call {i} {shape}: {name} off the plain chain by {err:.3e}")
        xr.grad = None
        fwd = lambda: bnc._forward(x, *args)  # noqa: E731
        _, coef, _ = fwd()
        ms_f = kernel_device_ms(fwd, 20)
        ms_b = kernel_device_ms(lambda: bnc.batch_norm_train_backward(g, x, bn.weight, coef),
                                20) if grad else 0.0
        bound = x.numel() * x.element_size() * (2 + 3 * grad) / bounds.PEAK_BYTES_PER_S * 1e3
        bn.zero_grad(set_to_none=True)
        ms = ms_f + ms_b
        tot["ms"] += ms
        tot["bound_ms"] += bound
        print(f"[bn] {i:2d} {shape} {str(dt)[6:]} {'grad' if grad else 'no grad'}: kernels "
              f"{ms_f:.4f} + {ms_b:.4f} = {ms:.4f} ms device, least bytes {bound:.4f} ms "
              f"({100 * bound / ms:.1f}%)")
    per_step = sum(4 if grad else 2 for _, _, grad in calls)
    print(f"[bn] a step's {len(calls)} calls: kernels {tot['ms']:.3f} ms device (least-bytes "
          f"bound {tot['bound_ms']:.3f} ms, {100 * tot['bound_ms'] / tot['ms']:.1f}%); the "
          f"kernels' launches a step: {per_step}")
    return {"name": "batch_norm_train (BatchNorm training: statistics, normalisation, "
                    "gradient), the b25 step's calls", "route": "cuda", "source": BN_SOURCE,
            "replaces": BN_REPLACES, "bound_by": "bytes", "calls": len(calls),
            "launches_a_step": per_step, **tot}


def bf16_ulps(a, b) -> int:
    """The widest gap between two bf16 tensors of one shape, in bf16 steps
    (their bit patterns ordered as the numbers are)."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def resize_phase(dev) -> dict:
    """Phase 34: the DPT head's bilinear resize kernel (csrc/bilinear_resize.cu)
    at the depth cell's five resizes (b16, bf16): held to ATen's
    F.interpolate on the same tensors (at most one bf16 step apart, else the
    run fails; bit for bit is the design), a second launch giving the same
    bits, and its device time per launch beside the bytes the resize needs
    (input read once, output written once) over HBM bandwidth. Returns the
    kernels-line entry (ms a forward)."""
    import torch
    import torch.nn.functional as F
    from harness import bounds
    from weakcube_tpu_torch.ops import bilinear_resize_cuda as brc
    for line in brc.build_log.splitlines():
        if any(w in line for w in ("registers", "spill")):
            print(f"  ptxas: {line.strip()}")
    gen = torch.Generator(device=dev).manual_seed(34)
    tot = {"ms": 0.0, "bound_ms": 0.0}
    entry = {"name": "bilinear_resize (the DPT head's align_corners resizes), the b16 depth "
                     "forward's five", "route": "cuda", "source": RESIZE_SOURCE,
             "replaces": RESIZE_REPLACES, "bound_by": "bytes", "max_ulps": 0, "shapes": {}}
    for C, n_in, n_out in DPT_RESIZES:
        x = torch.randn((DEPTH_BATCH, n_in, n_in, C), generator=gen, device=dev).to(
            torch.bfloat16).permute(0, 3, 1, 2)
        with torch.inference_mode():
            got = brc.bilinear_resize(x, (n_out, n_out))
            want = F.interpolate(x, size=(n_out, n_out), mode="bilinear", align_corners=True)
        ulps = bf16_ulps(got, want)
        n_diff = int((got != want).sum())
        if ulps > 1:
            fail(f"resize {n_in}^2 -> {n_out}^2 C={C}: the kernel is {ulps} bf16 steps off ATen")
        out = torch.empty_like(got)
        ms = kernel_device_ms(lambda: brc.launch(x, out), 20)
        if not torch.equal(out, got):
            fail(f"resize {n_in}^2 -> {n_out}^2 C={C}: a second launch gave other bits")
        bound = (x.numel() + got.numel()) * x.element_size() / bounds.PEAK_BYTES_PER_S * 1e3
        tot["ms"] += ms
        tot["bound_ms"] += bound
        entry["max_ulps"] = max(entry["max_ulps"], ulps)
        name = f"{n_in}->{n_out} C{C}"
        entry["shapes"][name] = {"ms": ms, "bound_ms": bound, "elements_off": n_diff}
        same = "equal to ATen bit for bit" if not n_diff else \
            f"{n_diff} elements one bf16 step off ATen"
        print(f"[resize] b{DEPTH_BATCH} {n_in}^2 -> {n_out}^2 C={C} bf16 (vec "
              f"{brc.vec_width(x)}): {same}; {ms:.4f} ms device per launch, least bytes "
              f"{bound:.4f} ms ({100 * bound / ms:.1f}%)")
        del x, got, want, out
    print(f"[resize] a b{DEPTH_BATCH} forward's five: {tot['ms']:.4f} ms device, least bytes "
          f"{tot['bound_ms']:.4f} ms ({100 * tot['bound_ms'] / tot['ms']:.1f}%)")
    torch.cuda.empty_cache()
    return dict(entry, **tot)


def relpos_phase(dev) -> dict:
    """Phase 35: K2 with SAM's decomposed relative-position bias at the SAM
    cell's two shapes (SAM_ATTENTION; bf16, q, k, v the views of a fused
    (B, N, 3, H, 64) projection, a N(0, 2) bias): held to the plain version
    on a slice (the first 8 windows, the first image), a second launch
    giving the same bits, and its device time per launch beside
    k2_relpos_bound. Returns the kernels-line entry (ms and bound_ms of a
    b8 request's 24 launches)."""
    import torch
    from harness import k2_relpos_bound
    from weakcube_tpu_torch.ops import flash_attention_cuda as fac
    K2, plain = fac.flash_attention, fac.plain
    gen = torch.Generator(device=dev).manual_seed(35)
    entry = {"name": "flash_attention with SAM's relative-position bias (flash_fwd_relpos_bf16), "
                     "a b8 SAM-HQ ViT-L request's 24 launches at 1024 px",
             "route": "cuda", "source": K2_SOURCE, "replaces": K2_RELPOS_REPLACES,
             "ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0, "shapes": {}}
    for name, B, side, calls in SAM_ATTENTION:
        N, H = side * side, SAM_HEADS
        qkv = torch.randn((B, N, 3 * H * 64), generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = qkv.view(B, N, 3, H, 64).permute(2, 0, 3, 1, 4).unbind(0)
        rel = tuple(2 * torch.randn((B, H, N, side), generator=gen, device=dev) for _ in "hw")
        n = min(B, 8) if name == "windowed" else 1
        with torch.inference_mode():
            got = K2(q, k, v, 0.125, rel_pos=rel)
            want = plain(q[:n], k[:n], v[:n], 0.125, tuple(t[:n] for t in rel))
        err = check_close(f"K2 with the bias, {name} B{B} H{H} N{N} ({side} x {side}), first {n}",
                          got[:n], want, 2e-2, 2e-2)
        ms = kernel_device_ms(lambda: K2(q, k, v, 0.125, rel_pos=rel), 20)
        if not torch.equal(K2(q, k, v, 0.125, rel_pos=rel), got):
            fail(f"K2 with the bias, {name}: a second launch gave other bits")
        bound = 1e3 * k2_relpos_bound.flash_attention_relpos_bound_s(B, H, N, 64, side, side)
        print(f"[timing] K2 with the bias, {name} B{B} H{H} N{N} bf16: {ms:.4f} ms of device "
              f"time per launch (20 queued behind a sleep kernel); bound {bound:.4f} ms "
              f"({100 * bound / ms:.1f}% of it); x{calls} a b8 request")
        entry["shapes"][name] = {"B": B, "N": N, "ms": ms, "bound_ms": bound, "per_request": calls}
        entry["ms"] += calls * ms
        entry["bound_ms"] += calls * bound
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        del qkv, q, k, v, rel, got, want
    print(f"[timing] K2 with the bias, a b8 request's 24 launches: {entry['ms']:.4f} ms device, "
          f"bound {entry['bound_ms']:.4f} ms ({100 * entry['bound_ms'] / entry['ms']:.1f}%)")
    torch.cuda.empty_cache()
    return entry


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA device")
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))  # box sets and the train-step check
    sys.path.insert(0, BENCH_DIR)  # the frozen bounds
    try:
        from weakcube_tpu_torch.entry import (dims_priors, flagship_cfg, make_batch,
                                              tiny_cfg)
        from weakcube_tpu_torch.models.rcnn3d import build_model
        from weakcube_tpu_torch.evaluation import _native as eval_native
        from weakcube_tpu_torch.models.roi_heads import FPN_STRIDES
        from weakcube_tpu_torch.ops import flash_attention_cuda, roi_align_cuda
        from weakcube_tpu_torch.ops import batch_norm_cuda, bilinear_resize_cuda
        from weakcube_tpu_torch.ops import nms as nms_ops
        from weakcube_tpu_torch.ops.cuda_build import build_host_library
        from harness import bounds  # noqa: F401
    except ImportError as e:
        fail(f"the weakcube_tpu_torch package or benchmark/harness is not beside this script: "
             f"{e}")
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

    # -- 2. build the five kernel sources, one nvcc each, and the evaluator's
    # matcher (g++), in parallel, so that no later phase's time holds a compile
    t = time.time()
    with ThreadPoolExecutor(6) as pool:
        builds = [(name, mod, pool.submit(mod.build))
                  for name, mod in (("K1", roi_align_cuda), ("K2", flash_attention_cuda),
                                    ("NMS", nms_ops), ("BN", batch_norm_cuda),
                                    ("resize", bilinear_resize_cuda))]
        matcher = pool.submit(build_host_library, eval_native.SOURCE)
        for name, mod, fut in builds:
            lib_path = fut.result()
            print(f"[build] {name} {os.path.relpath(lib_path, HERE)} "
                  f"(all built in {time.time() - t:.1f} s)")
            for line in mod.build_log.splitlines():
                if any(w in line for w in ("registers", "spill", "Compiling entry", "C75")):
                    print(f"  ptxas: {line.strip()}")
        print(f"[build] the evaluator's matcher (g++) "
              f"{os.path.relpath(matcher.result()[0], HERE)}")

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

    print(f"[phase] 3 (K1 vs plain) ended at {time.time() - t_start:.1f} s")

    # -- 3b-3c. K1's open fault: a stress loop and racecheck ----------------
    t = time.time()
    n_stress = k1_stress(dev)
    print(f"[stress] K1 on tests/test_torch_cuda.py::test_kernel_many_rois_per_block's inputs "
          f"(seeds 7, 8, 9; float32 and bfloat16; 2 x 4000 RoIs of every box set): {n_stress} "
          f"launches, each bit-identical to the first of its input and within tolerance of the "
          f"plain version, in {time.time() - t:.1f} s")
    t = time.time()
    racecheck = k1_racecheck()
    print(f"[phase] 3b-3c (K1 stress, racecheck: {racecheck}) took {time.time() - t:.1f} s")
    t = time.time()
    nms_entry = nms_phase(dev)
    print(f"[phase] 32 (NMS kernel at the cells' shapes) took {time.time() - t:.1f} s")
    t = time.time()
    bn_entry = bn_phase(dev)
    bn_phase_launches = (batch_norm_cuda.batch_norm_train.launches
                         + batch_norm_cuda.batch_norm_train_backward.launches)
    print(f"[phase] 33 (BatchNorm training kernels) took {time.time() - t:.1f} s")

    # -- 4. the flagship forward, full width ------------------------------
    cfg = flagship_cfg(512)
    ncls = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    t = time.time()
    model = build_model(cfg, dims_priors(ncls), device="cuda", seed=0)
    batch = make_batch(8, 512, 512, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[model] {cfg.MODEL.META_ARCHITECTURE} / {cfg.MODEL.ROI_HEADS.NAME} "
          f"{trunk_name(cfg)} FPN {cfg.MODEL.FPN.OUT_CHANNELS}, {ncls} classes, "
          f"compute {cfg.TPU.COMPUTE_DTYPE}, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
          f"built in {time.time() - t:.1f} s")
    n_fwd = 4
    K1.launches = flash_attention_cuda.flash_attention.launches = nms_ops.nms_mask.launches = 0
    with torch.inference_mode():
        for _ in range(n_fwd):
            det = model(batch)
    torch.cuda.synchronize()
    launches, nms_fwd_launches = K1.launches, nms_ops.nms_mask.launches

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
    if nms_fwd_launches != 2 * n_fwd:
        fail(f"the NMS kernel launched {nms_fwd_launches} times in {n_fwd} forwards, expected "
             f"{2 * n_fwd} (the RPN's and the box NMS)")
    print(f"[forward] {n_fwd} forwards: K1 launches {launches} (2 per forward), NMS launches "
          f"{nms_fwd_launches} (2 per forward), "
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
        max_err[name] = check_close(f"{name} R={bx.shape[1]}", got, want, *tol)

    # a small float32 model on the card against the same model on the CPU
    small = tiny_cfg(image_size=128, dla=True)
    pri = dims_priors(small.MODEL.ROI_HEADS.NUM_CLASSES)
    m_gpu = build_model(small, pri, device="cuda", seed=1)
    m_cpu = build_model(small, pri, device="cpu", seed=1)
    b_cpu = make_batch(2, 128, 128, seed=3, device="cpu")
    b_gpu = {k: v.to(dev) for k, v in b_cpu.items()}
    with torch.inference_mode():
        d_gpu, d_cpu = m_gpu(b_gpu), m_cpu(b_cpu)
    # float32 with TF32 off: cuDNN's and the CPU's sums differ in order
    n_match = check_same_detections(d_cpu, d_gpu, "small model, card vs CPU", 1e-3, 1e-3)
    if n_match == 0:
        fail("small model: no valid detections to compare")
    print(f"[reference] small float32 model, card vs CPU: {n_match} valid "
          "detections agree (atol 1e-3, rtol 1e-3)")

    # -- 6. K1's device time on the forward's calls, and on other RoIs --------
    tot = {"ms": 0.0, "bound_ms": 0.0}
    for name, bx, res in calls:
        ms = kernel_device_ms(lambda: K1(levels, bx, FPN_STRIDES, res, sr), 20)
        bound = k1_bound_ms(levels, bx, FPN_STRIDES, res, sr)
        tot["ms"] += ms
        tot["bound_ms"] += bound
        print(f"[timing] K1 {name} R={bx.shape[1]}: {ms:.4f} ms of device time per launch "
              f"(20 launches queued behind a sleep kernel); bound {bound:.4f} ms "
              f"({100 * bound / ms:.1f}% of it)")
    print(f"[timing] K1 per forward (box + cube pooler): {tot['ms']:.4f} ms, bound "
          f"{tot['bound_ms']:.4f} ms")
    # the box pooler's count of other RoIs on the forward's pyramid, checked
    # and timed the same way: real-size RoIs (p3-p5 windows of 225-784
    # pixels), and sub-pixel RoIs at one spot (every read a cache hit: what
    # is left is the kernel's instruction issue)
    other = {"p3-p5 squares": large_boxes(8, 1000, 512, torch.Generator(device=dev).manual_seed(2),
                                          dev),
             "sub-pixel RoIs at one spot": torch.tensor([100.0, 100.0, 100.3, 100.3],
                                                        device=dev).expand(8, 1000, 4).contiguous()}
    for name, bx in other.items():
        check_close(f"{name} R={bx.shape[1]}", K1(levels, bx, FPN_STRIDES, res_box, sr),
                    plain(levels, bx, FPN_STRIDES, res_box, sr), *tol)
        ms = kernel_device_ms(lambda: K1(levels, bx, FPN_STRIDES, res_box, sr), 20)
        bound = k1_bound_ms(levels, bx, FPN_STRIDES, res_box, sr)
        print(f"[timing] K1 on {name} R={bx.shape[1]}: {ms:.4f} ms of device time per launch; "
              f"bound {bound:.4f} ms ({100 * bound / ms:.1f}% of it)")

    # -- 10. K1-bwd against its plain version --------------------------------
    k1_backward_checks(dev, levels, props.boxes.contiguous())
    det31 = {"centers": det.centers3D, "dims": det.dims3D, "poses": det.poses3D,
             "valid": det.valid, "K": batch["K"]}  # phase 31's cubes
    del model, feats, levels, calls, det, det2d, props
    torch.cuda.empty_cache()

    # -- 34. the DPT head's resize kernel at the depth cell's shapes ----------
    t = time.time()
    resize_before = bilinear_resize_cuda.bilinear_resize.launches
    resize_entry = resize_phase(dev)
    resize_phase_launches = bilinear_resize_cuda.bilinear_resize.launches - resize_before
    print(f"[phase] 34 (the DPT head's resize kernel) took {time.time() - t:.1f} s")

    # -- 7.-9. K2 and the depth pseudo-GT path; 29. the ground pseudo-GT
    # pipeline from phase 8's depth maps ---------------------------------------
    import shutil
    import tempfile
    pgt_root = tempfile.mkdtemp(prefix="chip_smoke_pgt_")
    try:
        k2, depth_run = depth_phases(dev, pgt_root)
        torch.cuda.empty_cache()
        t = time.time()
        pgt_k2, ground31 = pseudo_gt_phase(dev, depth_run, pgt_root, card)
        print(f"[phase] 29 (the pseudo-GT pipeline) took {time.time() - t:.1f} s")
    finally:
        shutil.rmtree(pgt_root, ignore_errors=True)
    torch.cuda.empty_cache()
    k2 = dict(k2, launches=k2["launches"] + pgt_k2, launches_by_path={
        f"depth pseudo-GT (phase 8: {DEPTH_IMAGES} images, b{DEPTH_BATCH})": k2["launches"],
        "pseudo-GT pipeline (phase 8 → 29): the depth maps the ground maps read":
            depth_run["k2_launches"] + pgt_k2})

    # -- 35. K2 with SAM's relative-position bias at the SAM cell's shapes ------
    t = time.time()
    relpos_before = flash_attention_cuda.flash_attention.launches
    relpos = relpos_phase(dev)
    relpos = dict(relpos, launches_by_path={
        "phase 35 (checks and timing)": flash_attention_cuda.flash_attention.launches
        - relpos_before,
        f"phase 29 (b): SAM-HQ {PGT_SAM_VARIANT}, one forward an image":
            depth_run["sam_k2_launches"]})
    relpos["launches"] = sum(relpos["launches_by_path"].values())
    print(f"[phase] 35 (K2 with the bias) took {time.time() - t:.1f} s")

    # -- 11.-13. the training step ---------------------------------------------
    t = time.time()
    bn_before_12 = (batch_norm_cuda.batch_norm_train.launches
                    + batch_norm_cuda.batch_norm_train_backward.launches - bn_phase_launches)
    k1_bwd, max_err["train"], nms_step_launches, bn_step_launches = train_phases(
        dev, bn_entry["launches_a_step"])
    print(f"[phase] 11-13 (training step) took {time.time() - t:.1f} s")
    torch.cuda.empty_cache()

    # -- 25.-27. every head and loss: the supervised, 2D-only and all-loss
    # steps at full width, and small ones card vs CPU ---------------------------
    t = time.time()
    heads = heads_phases(dev)
    max_err["heads"] = max(r["errs"]["K1"] for r in heads.values())
    print(f"[phase] 25-27 (supervised, 2D-only and all-loss steps) took {time.time() - t:.1f} s")
    torch.cuda.empty_cache()

    # -- 30. the backbone sweep: ResNet-34, ShuffleNetV2, MNASNet, DenseNet-121
    # at full width; Adam on the card; a released .pth --------------------------
    t = time.time()
    sweep_out = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    try:
        sweep = backbone_sweep_phase(dev, sweep_out)
    finally:
        shutil.rmtree(sweep_out, ignore_errors=True)
    max_err["sweep"] = max(max(r["detection"]["err"], r["train"]["errs"]["K1"])
                           for k, r in sweep.items() if k != "adam_card_vs_cpu")
    print(f"[phase] 30 (the backbone sweep) took {time.time() - t:.1f} s")
    torch.cuda.empty_cache()

    # -- 23. DP-step: two ranks on this card against one process --------------
    t = time.time()
    dp = dp_step_phase(dev)
    max_err["dp"] = dp["errs"]["K1"]
    print(f"[phase] 23 (DP-step) took {time.time() - t:.1f} s")
    torch.cuda.empty_cache()

    # -- 15.-22. the train CLI, the in-graph ground plane, IoU3D, RANSAC; the
    # eval CLI on the train CLI's checkpoint, K1 at its shapes, the evaluator
    # card vs CPU, periodic evaluation, vis and the demo ----------------------
    cli_out = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    rep = {}
    try:
        for name, phase in (
                ("15 (train CLI)", lambda: cli_phases(dev, cli_out)),
                ("16 (in-graph ground plane)", lambda: ground_phase(dev)),
                ("17-18 (IoU3D and RANSAC, card vs CPU)", lambda: geometry_phases(dev)),
                ("31 (the ops layer's last functions, card vs CPU)",
                 lambda: ops_phase(dev, det31, ground31)),
                ("19 (eval CLI)", lambda: eval_phase(dev, cli_out)),
                ("20 (K1 at the eval batch's shapes)", lambda: eval_k1_phase(dev, cli_out)),
                ("21 (evaluator, card vs CPU)", lambda: evaluator_phase(dev, rep["19"][1])),
                ("22 (periodic eval, vis, demo)", lambda: periodic_phase(dev, cli_out)),
                ("28 (the recipe through the CLI)",
                 lambda: recipe_cli_phase(dev, os.path.join(cli_out, "recipe"))),
                ("24 (DP-CLI)", lambda: dp_cli_phase(dev))):
            t = time.time()
            rep[name.split()[0]] = phase()
            torch.cuda.empty_cache()
            print(f"[phase] {name} took {time.time() - t:.1f} s")
    finally:
        shutil.rmtree(cli_out, ignore_errors=True)
    print(f"[done] total run {time.time() - t_start:.1f} s")
    ev, ev_k1 = rep["19"][0], rep["20"]
    recipe = rep["28"]
    # the launches of this PR's paths: the supervised, 2D-only and all-loss
    # steps (6 each), and the recipe's two CLI runs (4 iterations each)
    new_paths = {f"supervised step (6 x b{TRAIN_BATCH})": "supervised",
                 f"2D-only step (6 x b{TRAIN_BATCH})": "2d_only",
                 f"all-loss weak step (6 x b{TRAIN_BATCH})": "all_losses"}
    new_k1 = {k: heads[v]["k1"] for k, v in new_paths.items()}
    new_bwd = {k: heads[v]["k1_bwd"] for k, v in new_paths.items()}
    for key, name in (("2d_only", "recipe CLI 2D-only (4 x b25)"),
                      ("weak", "recipe CLI weak, warm-started (4 x b25)")):
        new_k1[name], new_bwd[name] = recipe[key]["k1"], recipe[key]["k1_bwd"]
    # phase 30's: each trunk's detection forwards and supervised steps
    for key, r in sweep.items():
        if key != "adam_card_vs_cpu":
            new_k1[f"sweep {key} detection (4 x b{SWEEP_BATCH})"] = r["detection"]["k1"]
            new_k1[f"sweep {key} supervised step (6 x b{TRAIN_BATCH})"] = r["train"]["k1"]
            new_bwd[f"sweep {key} supervised step (6 x b{TRAIN_BATCH})"] = r["train"]["k1_bwd"]

    # -- 14. result lines ---------------------------------------------------
    bn_after_12 = (batch_norm_cuda.batch_norm_train.launches
                   + batch_norm_cuda.batch_norm_train_backward.launches)
    print(card)  # again beside the results at the end of the output
    # K1's launches: the detection forward's and the eval CLI's runs, each
    # counted from 0; its times are per b8 forward, and per b32 eval batch
    # under "eval_batch"
    print(json.dumps({"kernels": [{
        "name": "multilevel_roi_align (ROIAlignV2 fwd), box + cube pooler per forward",
        "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches + ev["launches"] + dp["k1"] + sum(new_k1.values()),
        "launches_by_path": {"detection forward (4 x b8)": launches,
                             f"eval CLI ({ev['batches']} x b{EVAL_BATCH})": ev["launches"],
                             f"DP-step ({DP_RANKS} ranks x {DP_STEPS} steps of "
                             f"b{DP_BATCH // DP_RANKS})": dp["k1"], **new_k1},
        "max_abs_err": max(max(max_err.values()), ev_k1["max_abs_err"]), **tot,
        "eval_batch": {k: ev_k1[k] for k in ("ms", "bound_ms")}},
        dict(k1_bwd, launches=k1_bwd["launches"] + dp["k1_bwd"] + sum(new_bwd.values()),
             launches_by_path={"training step (6 x b25)": k1_bwd["launches"],
                               f"DP-step ({DP_RANKS} ranks x {DP_STEPS} steps of "
                               f"b{DP_BATCH // DP_RANKS})": dp["k1_bwd"], **new_bwd},
             max_abs_err=max(k1_bwd["max_abs_err"], dp["errs"]["K1-bwd"],
                             *(r["errs"]["K1-bwd"] for r in heads.values()),
                             *(r["train"]["errs"]["K1-bwd"] for k, r in sweep.items()
                               if k != "adam_card_vs_cpu"))), k2,
        dict(nms_entry, launches=nms_fwd_launches + nms_step_launches, launches_by_path={
            "detection forward (4 x b8)": nms_fwd_launches,
            f"training step ({1 + TRAIN_STEPS} x b{TRAIN_BATCH})": nms_step_launches}),
        dict(bn_entry, launches=bn_phase_launches + bn_before_12 + bn_after_12,
             launches_by_path={
                 "phase 33 (the b25 step's calls, checks and timing)": bn_phase_launches,
                 "phases 4-11": bn_before_12,
                 f"training step ({1 + TRAIN_STEPS} x b{TRAIN_BATCH})": bn_step_launches,
                 "the other one-process training steps (phase 12's kept step, phases "
                 "15-31)": bn_after_12 - bn_step_launches}),
        dict(resize_entry, launches=resize_phase_launches + depth_run["resize_launches"],
             launches_by_path={
                 "phase 34 (the five resizes, checks and timing)": resize_phase_launches,
                 f"depth pseudo-GT (phase 8: {DEPTH_IMAGES} images, b{DEPTH_BATCH})":
                     depth_run["resize_launches"]}), relpos]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
