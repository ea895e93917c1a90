"""Runner `sam`: one batch of the port's ground-mask path, SAM-HQ on one box
per image, as a served request.

Set-up draws the configuration's weights (harness/sam_weights.py), builds
the port's Sam from them (the configuration's variant, input size and
dtype, eval mode) and keeps the traffic's pool of image batches, turned
from the generator's BGR into RGB, with their boxes, in host memory;
WARMUP requests of the pool run as the timed ones do.

A request hands one batch of uint8 images and one XYXY box per image, in
the image's pixels, to
`generate_ground_segmentations.sam_masks`, the SAM half of the foundation
method: the images resized and normalised on the host and copied to the
card, one forward, the low-resolution masks thresholded, copied to the
host and resized to each image. It ends when the bool masks are on the
host. One client sends the next request when the last one's masks are on
the host (a closed loop). A forward hook keeps a reference to the
forward's float32 low-resolution mask logits, which the comparison reads.

After the window, once the program's state is freed, a sample of the
finished requests (drawn from the seed while the window runs, by
reservoir, so that only the sample's logits are kept) is run again through
the plain float32 reference (benchmark/reference/sam_hq.py), image by
image, on the same card, weights, images and boxes; the program's logits
are held to the reference's (harness/sam_compare.py). Where calibrate.py
puts a reference in the program's place (ctx["system"] named "reference"
or "reference_fp8"), this runner puts the SAM reference there, in float32
or with fp8 operands.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import common, sam_compare, sam_weights, stats
from harness import sam_faults  # noqa: F401  (calibrate.py's --fault finds its faults)
from harness import trace as trace_lib
from harness.sam_probe import SamFlashProbe
from harness.spec import load_file_module

WARMUP = 3
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _host_pool(pool: List[Dict[str, np.ndarray]]) -> List[dict]:
    """Each batch's RGB images, cut to each image's size, and their boxes."""
    out = []
    for b in pool:
        rgb = np.ascontiguousarray(b["image"][..., ::-1])
        out.append({"images": [np.ascontiguousarray(rgb[i, :int(h), :int(w)])
                               for i, (w, h) in enumerate(b["image_wh"])],
                    "boxes": [np.asarray(x, np.float32) for x in b["boxes"]]})
    return out


def _reference(ref_mod, spec: dict, sd, precision=None):
    with torch.device("meta"):
        m = ref_mod.SamHQ(spec["variant"], spec["img_size"], precision)
    m.load_state_dict(sd, assign=True)
    return m.eval()


def _weights(ref_mod, spec: dict, device):
    with torch.device("meta"):
        meta = ref_mod.SamHQ(spec["variant"], spec["img_size"])
    return sam_weights.make_state_dict(meta, spec["weights_seed"], device, spec.get("init"))


def run(ctx: dict) -> dict:
    # the port's batch path first: a checkout without it fails here, at once
    from weakcube_tpu_torch.data.generate_ground_segmentations import sam_masks
    from weakcube_tpu_torch.data.pseudo_gt import sam as port_sam
    from weakcube_tpu_torch.ops import flash_attention_cuda
    from reference import sam_hq as ref_mod

    cell, spec, seed, device = ctx["cell"], ctx["cfg_spec"], ctx["seed"], ctx["device"]
    side = getattr(ctx.get("system"), "name", "port")
    tp = cell["traffic"]
    cuda = device.type == "cuda"

    # ---- set-up
    marks = list(ctx.get("marks", [])) + [("imports", time.perf_counter())]
    sd = _weights(ref_mod, spec, device)
    traffic = load_file_module("traffic", tp["kind"])
    pool = _host_pool(traffic.generate(tp, seed))
    B = len(pool[0]["images"])
    marks.append(("weights and pool", time.perf_counter()))
    if side == "port":
        with torch.device("meta"):
            model = port_sam.Sam(spec["variant"], spec["img_size"])
        model.load_state_dict(sd, assign=True)
        model = model.to(device=device, dtype=DTYPES[spec["dtype"]]).eval()
        captured: Dict[str, torch.Tensor] = {}
        model.register_forward_hook(lambda m, i, out: captured.__setitem__("logits", out))

        def program(host):
            sam_masks(model, host["images"], host["boxes"])
            return list(captured.pop("logits")[:, 0:1].float())
    elif side.startswith("reference"):
        model = _reference(ref_mod, spec, sd, side.partition("_")[2] or None)

        def program(host):
            return ref_mod.mask_logits(model, host["images"], host["boxes"], device)
    else:
        raise ValueError(f"no SAM program for the side {side!r}")
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
    # keeps the logits of check_requests of the finished requests
    k_check = cell["check_requests"]
    rng = np.random.default_rng(common.sub_seed(seed, "sample"))
    kept: Dict[int, tuple] = {}
    lat, layer = [], {}
    launches0 = flash_attention_cuda.flash_attention.launches

    def serve(n: int):
        t = time.perf_counter()
        logits = program(pool[n % len(pool)])
        lat.append(time.perf_counter() - t)
        slot = n if n < k_check else int(rng.integers(0, n + 1))
        if slot < k_check:
            kept[slot] = (n, logits)

    if ctx["trace"]:
        out = {}
        with SamFlashProbe(port_sam) as probe, trace_lib.traced(device, out):
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
    kept = {s: (n, [t.cpu() for t in lg]) for s, (n, lg) in kept.items()}
    del model, program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_model = _reference(ref_mod, spec, _weights(ref_mod, spec, device))
    refs: Dict[int, list] = {}
    flops = None
    prog, ref = [], []
    for n, logits in sorted(kept.values(), key=lambda nl: nl[0]):
        k = n % len(pool)
        if k not in refs:
            count = ctx["trace"] and flops is None   # the FLOPs of one request, traced runs
            with FlopCounterMode(display=False) if count else contextlib.nullcontext() as fc:
                refs[k] = ref_mod.mask_logits(ref_model, pool[k]["images"], pool[k]["boxes"],
                                              device)
            if count:
                flops = float(fc.get_total_flops())
        prog += logits
        ref += refs[k]
    del ref_model
    numbers = sam_compare.compare_logits(prog, ref)

    e2e = {"detect_images_per_s": stats.rate(n_req * B, window), "setup_s": setup_s}
    layer.update(kind="sam", requests=n_req, images=n_req * B, window_s=window, chips=1,
                 flops_per_request=flops)
    k2 = layer.get("k2", {}).get("by_shape", {})
    return {"attempted": n_req, "failed": 0, "setup_s": setup_s, "e2e": e2e, "layer": layer,
            "numbers": numbers, "memory_peak_bytes": int(peak),
            "notes": [common.setup_note(ctx["t0"], marks),
                      f"latency p50 ms {stats.percentile(lat, 50) * 1e3:.3f} max ms "
                      f"{max(lat) * 1e3:.3f} over {n_req} requests",
                      f"program {side}: flash_attention.launches per request {k2_per_request}",
                      f"compared {len(prog)} mask logits of requests "
                      f"{sorted(n for n, _ in kept.values())}; disagreeing mask pixels "
                      f"{sam_compare.disagreeing_share(prog, ref):.6f}; "
                      + sam_compare.logit_stats(ref)]
            + [f"k2 {s}: {e['calls']} calls, event ms {e['event_s'] * 1e3:.4f}, bound ms "
               f"{e['bound_s'] * 1e3:.4f}" for s, e in sorted(k2.items())]
            + ([f"flops_per_request {flops}"] if flops else [])}
