"""The per-layer arithmetic of a depth cell that harness/readers.py does not
cover: K2's share of its roofline and the launches per request. Each
returns None where the layer context holds nothing to read (another kind of
cell, no trace, no K2 call)."""
from __future__ import annotations

from typing import Optional

K2_KERNEL = "flash_fwd_bf16"


def _traced(layer: dict) -> bool:
    return layer.get("kind") == "depth" and "trace" in layer


def k2_roofline_pct(layer: dict) -> Optional[float]:
    """Summed least time of the traced window's K2 calls (harness/k2_bound.py,
    from the shapes the probe recorded) over the device time of the trace's
    flash_fwd_bf16 kernels, or where the trace has none, the calls' CUDA
    events."""
    if not _traced(layer) or not layer.get("k2", {}).get("calls"):
        return None
    rec = layer["k2"]
    t_dev = layer["trace"].kernel_seconds(K2_KERNEL) or rec["event_s"]
    return 100.0 * rec["bound_s"] / t_dev if t_dev > 0 else None


def launches_per_request(layer: dict) -> Optional[float]:
    """Kernels that started in the traced window, per request."""
    if not _traced(layer) or not layer.get("requests"):
        return None
    return layer["trace"].n_kernels() / layer["requests"]
