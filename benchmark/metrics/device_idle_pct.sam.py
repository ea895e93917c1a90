"""Per-layer metric `device_idle_pct.sam`: see harness/readers.py::idle_pct."""
from harness import readers


def read(layer: dict):
    return readers.idle_pct(layer, "sam")
