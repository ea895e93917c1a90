"""Per-layer metric `idle_in_forward_pct.train`: see harness/program_spans.py::idle_in_pct."""
from harness import program_spans


def read(layer: dict):
    return program_spans.idle_in_pct(layer, "train", "model.forward")
