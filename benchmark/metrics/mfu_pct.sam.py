"""Per-layer metric `mfu_pct.sam`: see harness/readers.py::mfu_pct."""
from harness import readers


def read(layer: dict):
    return readers.mfu_pct(layer, "sam")
