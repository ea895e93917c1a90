"""Per-layer metric `idle_in_preprocess_pct.depth`: see harness/depth_spans.py::idle_in_pct."""
from harness import depth_spans


def read(layer: dict):
    return depth_spans.idle_in_pct(layer, "depth.preprocess")
