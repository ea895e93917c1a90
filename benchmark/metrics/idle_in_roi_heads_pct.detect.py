"""Per-layer metric `idle_in_roi_heads_pct.detect`: see harness/program_spans.py::idle_in_pct."""
from harness import program_spans


def read(layer: dict):
    return program_spans.idle_in_pct(layer, "detect", "model.roi_heads")
