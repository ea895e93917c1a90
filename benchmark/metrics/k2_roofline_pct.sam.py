"""Per-layer metric `k2_roofline_pct.sam`: see harness/sam_spans.py::k2_roofline_pct."""
from harness import sam_spans


def read(layer: dict):
    return sam_spans.k2_roofline_pct(layer)
