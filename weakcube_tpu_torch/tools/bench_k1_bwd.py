"""Time K1-bwd (csrc/roi_align.cu, `roi_align_backward`) on the card at the
full-width training step's own pooler inputs.

    python -m weakcube_tpu_torch.tools.bench_k1_bwd split
    python -m weakcube_tpu_torch.tools.bench_k1_bwd variants

Both build the flagship (configs/Omni_combined.yaml, random weights of seed
0), take 7 training steps on entry.tiny_batch(25, 512, 512, G=16) and keep
the inputs of the eighth step's two K1-bwd calls (box pooler R = 512, cube
pooler R = 128 per image).

`split` times each call: its device time (CUDA events around 20 calls
queued behind a sleep kernel), the kernels one call launches with their
device time (torch.profiler over 5 calls), and, as PyTorch ops, a zero fill
of the levels in float32 and a cast of float32 levels to the level dtype:
the two passes that an atomic scatter into float32 buffers adds. It uses
only entry points the package has had since the training step was ported,
so it runs as well from the root of an older checkout.

`variants` builds copies of csrc/roi_align.cu with the edits of VARIANTS
into build/ and times each against the source as it stands, in turns over
3 rounds, on the same inputs, checking that each gives the same bits.

It needs a CUDA device; it prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

# edits of csrc/roi_align.cu: (text of the source, its replacement)
VARIANTS = {
    # a warp of 4 columns x 8 vectors, 13 RoIs a batch
    "16x16 tiles of 64 channels": [("#define BWD_TILE_W 8 ", "#define BWD_TILE_W 16 "),
                                   ("#define BWD_TILE_H 8 ", "#define BWD_TILE_H 16 "),
                                   ("#define BWD_CHUNK_BYTES 512 ", "#define BWD_CHUNK_BYTES 128 "),
                                   ("#define BWD_STAGE_BYTES (98 * 1024)",
                                    "#define BWD_STAGE_BYTES (80 * 1024)")],
    "batches of 3 RoIs": [("#define BWD_STAGE_BYTES (98 * 1024)",
                           "#define BWD_STAGE_BYTES (80 * 1024)")],
    "column loop unrolled": [("#pragma unroll 1  // 1-2 trips", "// 1-2 trips")],
}


def device_ms(fn, iters: int = 20) -> float:
    """Device ms per call of fn: a sleep kernel holds the stream while the
    host queues `iters` calls, so the CUDA events around them time the
    device alone."""
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    torch.cuda._sleep(20_000_000)
    ev[1].record()
    for _ in range(iters):
        fn()
    ev[2].record()
    torch.cuda.synchronize()
    return ev[1].elapsed_time(ev[2]) / iters


def kept_calls(dev):
    """The (g, boxes, args) of the two K1-bwd calls of the eighth training
    step, the box pooler's first."""
    from ..entry import dims_priors, flagship_cfg, tiny_batch
    from ..models.rcnn3d import build_model
    from ..ops import roi_align_cuda
    from ..parallel.train_step import create_train_state, train_step
    cfg = flagship_cfg(512)
    model = build_model(cfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), device=dev, seed=0)
    state, opt = create_train_state(cfg, model)
    batch = tiny_batch(25, 512, 512, G=16, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(7):
        state, _ = train_step(model, opt, state, batch, gen)
    calls, bwd = [], roi_align_cuda.roi_align_backward

    def keep(g, boxes, *args):
        calls.append((g.detach().clone(), boxes, args))
        return bwd(g, boxes, *args)
    keep.launches = 0  # the wrapper counts on the module's name, which is this now
    roi_align_cuda.roi_align_backward = keep
    try:
        train_step(model, opt, state, batch, gen)
    finally:
        roi_align_cuda.roi_align_backward = bwd
    torch.cuda.synchronize()
    return sorted(calls, key=lambda c: -c[1].shape[1])


def kernels_of(call, n: int = 5):
    """(kernel name, launches seen per call, device ms per launch) of n
    calls of `call` (after one outside the profiler) under torch.profiler;
    empty where it saw no device time. (It has recorded only some of the
    launches of such a loop on the card: the counts are what it saw.)"""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    return [(e.key.removeprefix("void ").split("(")[0][:70], e.count / n,
             e.self_device_time_total / 1e3 / e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]


def split(calls, dev):
    from ..ops import roi_align_cuda
    for name, (g, boxes, args) in zip(("box", "cube"), calls):
        shapes, dt = args[0], args[1]
        bufs = [torch.zeros(s, dtype=torch.float32, device=dev) for s in shapes]
        parts = {"call": lambda: roi_align_cuda.roi_align_backward(g, boxes, *args),
                 "float32 zero fill": lambda: [torch.zeros(s, dtype=torch.float32, device=dev)
                                               for s in shapes],
                 "cast to the level dtype": lambda: [b.to(dt) for b in bufs]}
        rounds = {k: [device_ms(f) for _ in range(3)] for k, f in parts.items()}
        print(f"{name} pooler R={boxes.shape[1]} {dt}: " + "; ".join(
            f"{k} {statistics.median(v):.4f} ms (rounds {' '.join(f'{x:.4f}' for x in v)})"
            for k, v in rounds.items()))
        for k, n, ms in kernels_of(parts["call"]):
            print(f"  a call launches {k}: {n:.1f} per call seen, {ms:.4f} ms each")


def variants(calls, dev):
    from ..ops import roi_align_cuda
    from ..ops.cuda_build import BUILD_DIR, build_library
    src = open(roi_align_cuda.SOURCE).read()
    paths = {"as it stands": roi_align_cuda.SOURCE}
    os.makedirs(os.path.join(BUILD_DIR, "variants"), exist_ok=True)
    for name, edits in VARIANTS.items():
        s = src
        for old, new in edits:
            if s.count(old) != 1:
                sys.exit(f"variant {name!r}: {old!r} is not once in {roi_align_cuda.SOURCE}")
            s = s.replace(old, new)
        paths[name] = os.path.join(BUILD_DIR, "variants", name.replace(" ", "_") + ".cu")
        with open(paths[name], "w") as f:
            f.write(s)
    t = time.time()
    with ThreadPoolExecutor(len(paths)) as ex:
        built = dict(zip(paths, ex.map(lambda p: build_library(p)[0], paths.values())))
    print(f"built {len(built)} libraries in {time.time() - t:.1f} s")
    argtypes = roi_align_cuda._load().roi_align_backward.argtypes
    libs = {}
    for name, path in built.items():
        libs[name] = ctypes.CDLL(path)
        libs[name].roi_align_backward.argtypes = argtypes
    for pooler, (g, boxes, args) in zip(("box", "cube"), calls):
        shapes, dt, strides, out_size, sr, min_level = args
        B, R = boxes.shape[:2]
        C, L = shapes[0][-1], len(shapes)
        vec = 8 if dt == torch.bfloat16 else 4
        results = {}

        def launch(lib, grads):
            err = lib.roi_align_backward(
                1 if dt == torch.bfloat16 else 0, vec,
                (ctypes.c_void_p * L)(*[t.data_ptr() for t in grads]),
                (ctypes.c_int * L)(*[s[1] for s in shapes]),
                (ctypes.c_int * L)(*[s[2] for s in shapes]),
                (ctypes.c_float * L)(*[1.0 / s for s in strides]), L, min_level,
                boxes.data_ptr(), g.data_ptr(), B, R, C, out_size, sr,
                torch.cuda.current_stream().cuda_stream)
            if err:
                sys.exit(f"roi_align_backward failed with CUDA error {err}")
        rounds = {n: [] for n in libs}
        for r in range(3):
            for n in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
                grads = [torch.empty(s, dtype=dt, device=dev) for s in shapes]
                rounds[n].append(device_ms(lambda: launch(libs[n], grads)))
                results[n] = grads
        ref = results["as it stands"]
        for n, v in rounds.items():
            same = all(torch.equal(a, b) for a, b in zip(results[n], ref))
            print(f"{pooler} pooler R={R}, {n}: {statistics.median(v):.4f} ms (rounds "
                  f"{' '.join(f'{x:.4f}' for x in v)}), same bits as the source: {same}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("split", "variants"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_k1_bwd needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    calls = kept_calls(dev)
    (split if args.mode == "split" else variants)(calls, dev)


if __name__ == "__main__":
    main()
