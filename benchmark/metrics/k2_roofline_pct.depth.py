"""Per-layer metric `k2_roofline_pct.depth`: see harness/depth_readers.py::k2_roofline_pct."""
from harness import depth_readers


def read(layer: dict):
    return depth_readers.k2_roofline_pct(layer)
