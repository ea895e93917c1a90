"""Per-layer metric `idle_in_preprocess_pct.sam`: see harness/sam_spans.py::idle_in_pct."""
from harness import sam_spans


def read(layer: dict):
    return sam_spans.idle_in_pct(layer, "sam.preprocess")
