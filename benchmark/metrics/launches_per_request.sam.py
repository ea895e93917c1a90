"""Per-layer metric `launches_per_request.sam`: see
harness/sam_spans.py::launches_per_request."""
from harness import sam_spans


def read(layer: dict):
    return sam_spans.launches_per_request(layer)
