"""Spans of the port's layers on the profiler's timeline, and their store.

`with span(name): ...` marks a stretch of host code. With no torch.profiler
session active it records nothing and costs one read of the profiler's
enabled flag. With one active it is a `torch.profiler.record_function`
range, so the exported trace shows it above the kernels it launched, and
it appends a `Span` to this module's store: its name, its start and end on
the host's Unix clock in ns, its id, its parent's id and its root's id.
That clock (`time.time_ns()`) is the exported trace's: an event sits at
`ts` + `baseTimeNanoseconds` / 1000 Unix-epoch us. After heavy host work
`record_function`'s enter can take 100 us, with the profiler's stamp about
halfway through it, and its exit stamps at its end: a span starts at the
midpoint of the clock read just before and just after the enter, and ends
just after the exit. Spans nest per thread; the spans of one training step
or one detection request share the id of their root.

`take()` returns the spans recorded since the last call and empties the
store, which otherwise grows while a profiler is active.

The port's spans (fixed names; readers look them up by name):
  train.step       parallel/train_step.py::train_step, the whole step (root)
  train.backward   the backward (K1-bwd runs inside)
  train.grad_sum   sum_gradients' bucketed all-reduce (data parallel only)
  train.optimizer  optimizer.step() and the BatchNorm statistics, or their
                   reset on a skipped update
  model.forward    models/rcnn3d.py::RCNN3D.forward (root in detection)
  model.backbone   the backbone on the normalised images
  model.proposals  the RPN head and proposal selection (with its losses in
                   training)
  model.roi_heads  the ROI heads (inference, or their training losses)
  nms              one ops/nms.py::nms_mask call
  sync             the host blocked on the device for a value: the step's
                   logs, the weak heads' corner constant copied from pageable
                   memory on a card, and each pass's convergence check in
                   nms_mask on the CPU (on a card NMS is one kernel launch,
                   and its span holds no sync)
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]  # None for a root
    root: int


_store: List[Span] = []
_ids = itertools.count()
_local = threading.local()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Off:
    """What `span` gives with no profiler active: a context that does
    nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _On:
    """A span under an active profiler: a `record_function` range and a
    stored Span."""

    __slots__ = ("name", "_rf", "_id", "_parent", "_root", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_On":
        stack = _stack()
        self._id = next(_ids)
        if stack:
            self._parent, self._root = stack[-1]._id, stack[-1]._root
        else:
            self._parent, self._root = None, self._id
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        t = time.time_ns()
        self._rf.__enter__()
        self._start = (t + time.time_ns()) // 2
        return self

    def __exit__(self, *exc) -> bool:
        self._rf.__exit__(*exc)
        end = time.time_ns()
        _stack().pop()
        _store.append(Span(self.name, self._start, end, self._id, self._parent, self._root))
        return False


def span(name: str):
    """Context manager for a stretch of host code named `name`: recorded
    while a profiler is active, nothing otherwise (see the module's
    docstring)."""
    return _On(name) if _profiler._is_profiler_enabled else _OFF


def take() -> List[Span]:
    """The spans recorded since the last call, in the order they ended; the
    store is emptied."""
    global _store
    out, _store = _store, []
    return out
