"""Per-layer metric `launches_per_request.depth`: see
harness/depth_readers.py::launches_per_request."""
from harness import depth_readers


def read(layer: dict):
    return depth_readers.launches_per_request(layer)
