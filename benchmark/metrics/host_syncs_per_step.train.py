"""Per-layer metric `host_syncs_per_step.train`: see harness/program_spans.py::syncs_per_root."""
from harness import program_spans


def read(layer: dict):
    return program_spans.syncs_per_root(layer, "train")
