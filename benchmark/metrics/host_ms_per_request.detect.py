"""Per-layer metric `host_ms_per_request.detect`: see harness/program_spans.py::host_ms_per_root."""
from harness import program_spans


def read(layer: dict):
    return program_spans.host_ms_per_root(layer, "detect")
