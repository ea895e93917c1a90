"""The port's depth spans (weakcube_tpu_torch/utils/trace.py:
depth.batch and its children) on the traced window's axis, and the
per-layer metrics that read them in a depth cell.

As harness/program_spans.py does for the detector's cells, with the root
`depth.batch` (data/generate_depth_maps.py::depth_maps) placed inside the
runner's `bench.request` spans, one root to each, within
program_spans.TOLERANCE_US; it reuses that module's store and interval
arithmetic. Where a root lies outside its request, or the port records no
depth spans (a checkout from before them), every reader returns None."""
from __future__ import annotations

from typing import List, Optional, Sequence

from . import program_spans, stats
from .program_spans import Placed

KIND = "depth"
ROOT = "depth.batch"
BENCH = "bench.request"


def place(tr, spans: Optional[Sequence], base_ns: Optional[int]) -> Optional[List[Placed]]:
    """The spans of the window's depth.batch roots on the trace's axis, or
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
    """The placed spans of a traced run of a depth cell, taken once."""
    if layer.get("kind") != KIND or "trace" not in layer:
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
