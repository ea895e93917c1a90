"""Per-layer metric `dpt_resize_ms_per_request.depth`: the summed device
time of the DPT head's align_corners bilinear resizes in the traced window,
per request, in ms. It reads the kernels whose names hold
`upsample_bilinear2d` (ATen's, which the head ran through F.interpolate) or
`bilinear_resize_` (weakcube_tpu_torch/csrc/bilinear_resize.cu), each kernel
counted once, so that both programs are read by one yardstick. The resize
out of depth_maps runs ATen's antialiased `upsample_gen2d_aa`, which holds
neither. None without a trace or where the trace holds neither."""
NEEDLES = ("upsample_bilinear2d", "bilinear_resize_")


def read(layer: dict):
    if layer.get("kind") != "depth" or "trace" not in layer or not layer.get("requests"):
        return None
    us = sum(float(e["dur"]) for e in layer["trace"].kernels
             if any(n in e["name"] for n in NEEDLES))
    return 1e-3 * us / layer["requests"] if us > 0 else None
