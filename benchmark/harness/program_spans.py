"""The port's own spans (weakcube_tpu_torch/utils/trace.py) on the traced
window's axis, and the arithmetic of the per-layer metrics that read them.

While the traced window's profiler runs, the port records its spans
(train.step, model.forward, model.proposals, sync, ...) in a store, each
with its start and end on the host's Unix clock. The trace's events sit at
`ts` us after the profiler's `baseTimeNanoseconds`, which is fixed for the
process: a one-op CPU profile after the window reads it. The store is taken
once per run (the first reader does it and keeps the result in the layer
context). Every root, train.step in a training cell and model.forward in a
detection cell, must then lie inside its own bench.step / bench.request
span, one root to each, within TOLERANCE_US; where one does not, or the
port records no spans (a checkout from before the store), every reader
returns None.

"Idle in X" is the length of the device's idle gaps in the window
(stats.gaps over Trace.intervals()) that fall inside the union of the X
spans, as a share of the window: nested or repeated spans count once, and
a gap half inside counts half.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import List, NamedTuple, Optional, Sequence, Tuple

from . import stats

ROOT = {"train": "train.step", "detect": "model.forward"}
BENCH = {"train": "bench.step", "detect": "bench.request"}
TOLERANCE_US = 50.0


class Placed(NamedTuple):
    name: str
    start: float  # us on the trace's axis
    end: float
    id: int
    parent: Optional[int]
    root: int


def trace_base_ns() -> int:
    """The profiler's baseTimeNanoseconds in this process, read from the
    export of a one-op CPU profile."""
    import torch
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.zeros(1).add_(1)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_base_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return int(json.load(f)["baseTimeNanoseconds"])
    finally:
        os.remove(path)


def _store(layer: dict) -> Tuple[Optional[list], Optional[int]]:
    """(the port's spans, the trace's base in ns); a test puts its own pair
    under layer["span_store"]."""
    if "span_store" in layer:
        return layer["span_store"]
    try:
        from weakcube_tpu_torch.utils import trace as port_trace
    except ImportError:
        return None, None
    return port_trace.take(), trace_base_ns()


def place(tr, kind: str, spans: Optional[Sequence], base_ns: Optional[int]
          ) -> Optional[List[Placed]]:
    """The spans of the window's roots on the trace's axis, or None where
    the roots do not each lie inside their own bench span."""
    if not spans or base_ns is None:
        return None
    placed = [Placed(s.name, (s.start_ns - base_ns) / 1000.0, (s.end_ns - base_ns) / 1000.0,
                     s.id, s.parent, s.root) for s in spans]
    roots = sorted((p for p in placed if p.parent is None and p.name == ROOT[kind]),
                   key=lambda p: p.start)
    bench = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in tr.spans if e["name"] == BENCH[kind])
    if not roots or len(roots) != len(bench):
        return None
    for r, (b0, b1) in zip(roots, bench):
        if r.start < b0 - TOLERANCE_US or r.end > b1 + TOLERANCE_US:
            return None
    ids = {r.id for r in roots}
    return [p for p in placed if p.root in ids]


def spans(layer: dict, kind: str) -> Optional[List[Placed]]:
    """The placed spans of a traced run of a `kind` cell, taken once."""
    if layer.get("kind") != kind or "trace" not in layer:
        return None
    if "program_spans" not in layer:
        layer["program_spans"] = place(layer["trace"], kind, *_store(layer))
    return layer["program_spans"]


def _merged(iv) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_pct(layer: dict, kind: str, name: str) -> Optional[float]:
    """The device's idle time inside the `name` spans, in % of the window."""
    ps = spans(layer, kind)
    if ps is None:
        return None
    tr = layer["trace"]
    gaps = stats.gaps(tr.intervals(), tr.lo, tr.hi)
    inside = _merged((p.start, p.end) for p in ps if p.name == name)
    return 100.0 * _overlap(gaps, inside) / (tr.hi - tr.lo)


def host_ms_per_root(layer: dict, kind: str) -> Optional[float]:
    """The host's own time per step or request: each root's length less
    its sync spans, averaged over the roots, in ms."""
    ps = spans(layer, kind)
    if ps is None:
        return None
    roots = [p for p in ps if p.parent is None]
    own = [(r.end - r.start) - stats.union_length(
        [(p.start, p.end) for p in ps if p.root == r.id and p.name == "sync"], r.start, r.end)
           for r in roots]
    return sum(own) / len(own) / 1000.0


def syncs_per_root(layer: dict, kind: str) -> Optional[float]:
    """`sync` spans per step or request."""
    ps = spans(layer, kind)
    if ps is None:
        return None
    return sum(p.name == "sync" for p in ps) / sum(p.parent is None for p in ps)
