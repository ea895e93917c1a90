"""The port's SAM spans (weakcube_tpu_torch/utils/trace.py: sam.batch and
its children) on the traced window's axis, and the per-layer arithmetic
of a SAM cell that harness/readers.py does not cover.

As harness/depth_spans.py does for the depth cell, with the root
`sam.batch` (data/generate_ground_segmentations.py::sam_masks) placed
inside the runner's `bench.request` spans, one root to each, within
program_spans.TOLERANCE_US. Where a root lies outside its request, or the
port records no SAM spans (a checkout from before them), the span readers
return None; so do K2's, where the probe recorded no biased call."""
from __future__ import annotations

from typing import List, Optional, Sequence

from . import program_spans, stats
from .program_spans import Placed

KIND = "sam"
ROOT = "sam.batch"
BENCH = "bench.request"
K2_KERNEL = "flash_fwd_relpos_bf16"


def _traced(layer: dict) -> bool:
    return layer.get("kind") == KIND and "trace" in layer


def place(tr, spans: Optional[Sequence], base_ns: Optional[int]) -> Optional[List[Placed]]:
    """The spans of the window's sam.batch roots on the trace's axis, or
    None where the roots do not each lie inside their own bench.request."""
    if not spans or base_ns is None:
        return None
    placed = [Placed(s.name, (s.start_ns - base_ns) / 1000.0, (s.end_ns - base_ns) / 1000.0,
                     s.id, s.parent, s.root) for s in spans]
    roots = sorted((p for p in placed if p.parent is None and p.name == ROOT),
                   key=lambda p: p.start)
    bench = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in tr.spans if e["name"] == BENCH)
    if not roots or len(roots) != len(bench):
        return None
    tol = program_spans.TOLERANCE_US
    for r, (b0, b1) in zip(roots, bench):
        if r.start < b0 - tol or r.end > b1 + tol:
            return None
    ids = {r.id for r in roots}
    return [p for p in placed if p.root in ids]


def spans(layer: dict) -> Optional[List[Placed]]:
    """The placed spans of a traced run of a SAM cell, taken once."""
    if not _traced(layer):
        return None
    if "program_spans" not in layer:
        layer["program_spans"] = place(layer["trace"], *program_spans._store(layer))
    return layer["program_spans"]


def idle_in_pct(layer: dict, name: str) -> Optional[float]:
    """The device's idle time inside the `name` spans, in % of the window."""
    ps = spans(layer)
    if ps is None:
        return None
    tr = layer["trace"]
    gaps = stats.gaps(tr.intervals(), tr.lo, tr.hi)
    inside = program_spans._merged((p.start, p.end) for p in ps if p.name == name)
    return 100.0 * program_spans._overlap(gaps, inside) / (tr.hi - tr.lo)


def k2_roofline_pct(layer: dict) -> Optional[float]:
    """Summed least time of the traced window's biased K2 calls
    (harness/k2_relpos_bound.py, from the shapes the probe recorded) over
    the device time of the trace's flash_fwd_relpos_bf16 kernels, or where
    the trace has none, the calls' CUDA events."""
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
