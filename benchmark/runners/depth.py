"""Runner `depth`: one batch of the port's depth pseudo-GT path as a served
request.

Set-up draws the configuration's weights (harness/depth_weights.py), builds
the port's Depth Anything V2 from them with
`data/generate_depth_maps.py::load_model` (the configuration's dtype,
channels_last, eval mode) and puts the traffic's pool of image batches,
turned from the generator's BGR into RGB, in pinned host memory; WARMUP
requests of the pool run as the timed ones do.

A request hands one batch of uint8 images and their sizes to
`generate_depth_maps.depth_maps`, the batch path of the pseudo-GT CLI's
`generate()`: the images resized and normalised on the card, one forward,
each map back to its image's size. It ends when the float16 maps are host
tensors. generate()'s npz compression and file writes are left out: they
are disk work, not the port's. One client sends the next request when the
last one's maps are on the host (a closed loop).

After the window, once the program's state is freed, a sample of the
finished requests (drawn from the seed while the window runs, by reservoir,
so that only the sample's maps are kept) is run again through the plain
float32 reference (benchmark/reference/depth_anything_v2.py), image by
image, on the same card, weights and images; the program's maps are held to
the reference's (harness/depth_compare.py). Where calibrate.py puts a
reference in the program's place (ctx["system"] named "reference" or
"reference_fp8"), this runner puts the depth reference there, in float32 or
with fp8 operands.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import common, depth_compare, depth_weights, stats
from harness import depth_faults  # noqa: F401  (calibrate.py's --fault finds its faults)
from harness import trace as trace_lib
from harness.k2_probe import FlashProbe
from harness.spec import load_file_module

WARMUP = 3
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _host_pool(pool: List[Dict[str, np.ndarray]], pin: bool) -> List[dict]:
    """Each batch's RGB images as views of one (pinned) host tensor, cut to
    each image's size, and those (height, width) sizes."""
    out = []
    for b in pool:
        img = torch.from_numpy(np.ascontiguousarray(b["image"][..., ::-1]))
        img = img.pin_memory() if pin else img
        sizes = [(int(h), int(w)) for w, h in b["image_wh"]]
        out.append({"images": [img[i, :h, :w] for i, (h, w) in enumerate(sizes)],
                    "sizes": sizes})
    return out


def _reference(ref_mod, spec: dict, sd, precision=None):
    with torch.device("meta"):
        m = ref_mod.DepthAnythingV2(spec["variant"], spec["max_depth"],
                                    spec["input_size"] // ref_mod.PATCH, precision)
    m.load_state_dict(sd, assign=True)
    return m


def _weights(ref_mod, spec: dict, device):
    with torch.device("meta"):
        meta = ref_mod.DepthAnythingV2(spec["variant"], spec["max_depth"],
                                       spec["input_size"] // ref_mod.PATCH)
    return depth_weights.make_state_dict(meta, spec["weights_seed"], device, spec.get("init"))


def run(ctx: dict) -> dict:
    # the port's batch path first: a checkout without it fails here, at once
    from weakcube_tpu_torch.data.generate_depth_maps import depth_maps, load_model
    from weakcube_tpu_torch.data.pseudo_gt import depth_anything_v2 as port_dav2
    from weakcube_tpu_torch.ops import flash_attention_cuda
    from reference import depth_anything_v2 as ref_mod

    cell, spec, seed, device = ctx["cell"], ctx["cfg_spec"], ctx["seed"], ctx["device"]
    side = getattr(ctx.get("system"), "name", "port")
    tp = cell["traffic"]
    cuda = device.type == "cuda"

    # ---- set-up
    marks = list(ctx.get("marks", [])) + [("imports", time.perf_counter())]
    sd = _weights(ref_mod, spec, device)
    traffic = load_file_module("traffic", tp["kind"])
    pool = _host_pool(traffic.generate(tp, seed), cuda)
    B = len(pool[0]["sizes"])
    marks.append(("weights and pool", time.perf_counter()))
    if side == "port":
        model = load_model(sd, spec["variant"], spec["max_depth"], spec["input_size"], device,
                           DTYPES[spec["dtype"]])

        def program(host):
            return depth_maps(model, host["images"], host["sizes"])
    elif side.startswith("reference"):
        model = _reference(ref_mod, spec, sd, side.partition("_")[2] or None)

        def program(host):
            return ref_mod.depth_maps(model, host["images"], host["sizes"], device)
    else:
        raise ValueError(f"no depth program for the side {side!r}")
    del sd
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("load_model", time.perf_counter()))
    for k in range(WARMUP):
        program(pool[k % len(pool)])
    if cuda:
        torch.cuda.synchronize(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - ctx["t0"]
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way in the window

    # ---- the window: a closed loop with one client; a seeded reservoir
    # keeps the maps of check_requests of the finished requests
    k_check = cell["check_requests"]
    rng = np.random.default_rng(common.sub_seed(seed, "sample"))
    kept: Dict[int, tuple] = {}
    lat, layer = [], {}
    launches0 = flash_attention_cuda.flash_attention.launches

    def serve(n: int):
        t = time.perf_counter()
        maps = program(pool[n % len(pool)])
        lat.append(time.perf_counter() - t)
        slot = n if n < k_check else int(rng.integers(0, n + 1))
        if slot < k_check:
            kept[slot] = (n, maps)

    if ctx["trace"]:
        out = {}
        with FlashProbe(port_dav2) as probe, trace_lib.traced(device, out):
            for n in range(cell["trace_requests"]):
                with torch.profiler.record_function("bench.request"):
                    serve(n)
        layer.update(trace=out["trace"], k2=probe.summary())
        window = out["trace"].window_s
    else:
        t_start = time.perf_counter()
        n = 0
        while time.perf_counter() - t_start < ctx["seconds"]:
            serve(n)
            n += 1
        window = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    n_req = len(lat)
    k2_per_request = (flash_attention_cuda.flash_attention.launches - launches0) / n_req
    gc.unfreeze()

    # ---- free the program's state, then the reference on the sample
    del model, program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_model = _reference(ref_mod, spec, _weights(ref_mod, spec, device))
    refs: Dict[int, list] = {}
    flops = None
    prog, ref = [], []
    for n, maps in sorted(kept.values(), key=lambda nm: nm[0]):
        k = n % len(pool)
        if k not in refs:
            count = ctx["trace"] and flops is None   # the FLOPs of one request, traced runs
            with FlopCounterMode(display=False) if count else contextlib.nullcontext() as fc:
                refs[k] = ref_mod.depth_maps(ref_model, pool[k]["images"], pool[k]["sizes"],
                                             device)
            if count:
                flops = float(fc.get_total_flops())
        prog += maps
        ref += refs[k]
    del ref_model
    numbers = depth_compare.compare_maps(prog, ref)

    e2e = {"detect_images_per_s": stats.rate(n_req * B, window), "setup_s": setup_s}
    layer.update(kind="depth", requests=n_req, images=n_req * B, window_s=window, chips=1,
                 flops_per_request=flops)
    return {"attempted": n_req, "failed": 0, "setup_s": setup_s, "e2e": e2e, "layer": layer,
            "numbers": numbers, "memory_peak_bytes": int(peak),
            "notes": [common.setup_note(ctx["t0"], marks),
                      f"latency p50 ms {stats.percentile(lat, 50) * 1e3:.3f} max ms "
                      f"{max(lat) * 1e3:.3f} over {n_req} requests",
                      f"program {side}: flash_attention.launches per request {k2_per_request}",
                      f"compared {len(prog)} maps of requests "
                      f"{sorted(n for n, _ in kept.values())}; " + depth_compare.map_stats(ref)]
            + ([f"flops_per_request {flops}"] if flops else [])}
