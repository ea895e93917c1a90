"""The readers of the port's spans (harness/program_spans.py): their
arithmetic on a synthetic trace and store, and a traced tiny run of each
cell on the CPU, where every one of them prints."""
from typing import NamedTuple, Optional

import pytest

import bm_tiny
from harness import program_spans, readers, spec
from harness.trace import Trace

BASE_NS = 1_000_000_000
SPAN_METRICS = {"train": ["host_ms_per_step.train", "host_syncs_per_step.train",
                          "idle_in_forward_pct.train", "idle_in_backward_pct.train",
                          "idle_in_optimizer_pct.train"],
                "detect": ["host_ms_per_request.detect", "host_syncs_per_request.detect",
                           "idle_in_proposals_pct.detect", "idle_in_roi_heads_pct.detect"]}
CELLS = {"train": "weak_dla34.train_b25", "detect": "cubercnn_dla34.detect_b8"}


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    root: int


def ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def span(name, t0_us, t1_us, id, parent, root):
    return Span(name, BASE_NS + int(t0_us * 1000), BASE_NS + int(t1_us * 1000), id, parent, root)


def train_layer(step_shift_us=0.0):
    """A window of 0-1000 us with two steps. The device runs 0-100, 300-400
    and 500-1000; so the gaps are 100-300 and 400-500. Step 1 (bench.step
    0-480): forward 50-200 (a gap of 100 inside), backward 200-350 (100
    inside: half of the gap 100-300 and none of 300-400), a sync 350-360,
    optimizer 400-450 with a nested optimizer span 410-420 (50 inside,
    counted once). Step 2 (bench.step 500-990): forward 510-600 (no gap),
    two syncs."""
    events = [ev("bench.window", 0, 1000), ev("bench.step", 0, 480), ev("bench.step", 500, 490),
              ev("k", 0, 100, "kernel"), ev("k", 300, 100, "kernel"),
              ev("k", 500, 500, "kernel")]
    s = step_shift_us
    store = [span("train.step", 10 + s, 470 + s, 0, None, 0),
             span("model.forward", 50, 200, 1, 0, 0),
             span("train.backward", 200, 350, 2, 0, 0),
             span("sync", 350, 360, 3, 0, 0),
             span("train.optimizer", 400, 450, 4, 0, 0),
             span("train.optimizer", 410, 420, 5, 4, 0),
             span("train.step", 510, 980, 6, None, 6),
             span("model.forward", 510, 600, 7, 6, 6),
             span("sync", 600, 610, 8, 7, 6),
             span("sync", 700, 730, 9, 6, 6)]
    return {"kind": "train", "trace": Trace(events), "span_store": (store, BASE_NS)}


def read(name, layer):
    return spec.load_file_module("metrics", name).read(layer)


def test_idle_in_a_span_counts_what_lies_inside():
    layer = train_layer()
    # forward: 100 of gap 100-300 in step 1, none in step 2
    assert read("idle_in_forward_pct.train", layer) == pytest.approx(10.0)
    # backward 200-350: the half of gap 100-300 it covers
    assert read("idle_in_backward_pct.train", layer) == pytest.approx(10.0)
    # optimizer 400-450 with a nested 410-420: 50 of gap 400-500, once
    assert read("idle_in_optimizer_pct.train", layer) == pytest.approx(5.0)
    total = sum(read(n, layer) for n in SPAN_METRICS["train"][2:])
    assert total <= readers.idle_pct(layer, "train") == pytest.approx(30.0)


def test_host_time_and_syncs_per_root():
    layer = train_layer()
    # step 1: 460 less a 10 us sync; step 2: 470 less 10 + 30
    assert read("host_ms_per_step.train", layer) == pytest.approx((450 + 430) / 2 / 1000)
    assert read("host_syncs_per_step.train", layer) == pytest.approx(1.5)


def test_a_root_outside_its_bench_span_silences_every_reader():
    assert read("host_ms_per_step.train", train_layer(step_shift_us=40.0)) is not None
    late = train_layer(step_shift_us=61.0)   # ends 51 us after its bench.step
    for name in SPAN_METRICS["train"]:
        assert read(name, late) is None, name
    layer = train_layer()
    layer["span_store"] = ([s for s in layer["span_store"][0] if s.root == 0], BASE_NS)
    assert read("host_ms_per_step.train", layer) is None   # one root for two steps


def test_each_reader_returns_none_for_the_other_kind_and_without_spans():
    for kind, names in SPAN_METRICS.items():
        other = "detect" if kind == "train" else "train"
        for name in names:
            layer = train_layer()
            layer["kind"] = other
            assert read(name, layer) is None, name
            assert read(name, {}) is None, name
    empty = train_layer()
    empty["span_store"] = ([], BASE_NS)
    assert all(read(n, empty) is None for n in SPAN_METRICS["train"])


def test_each_metric_is_declared_for_its_cell():
    for kind, names in SPAN_METRICS.items():
        mine = {m["name"] for m in spec.per_layer(CELLS[kind])}
        assert set(names) <= mine


@pytest.mark.parametrize("kind", ["train", "detect"])
def test_every_span_metric_prints_in_a_tiny_traced_run(kind):
    """On the CPU the window's device is idle throughout, so each span's
    idle share is its share of the window."""
    out = bm_tiny.drive(CELLS[kind], trace=True)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(SPAN_METRICS[kind]) <= set(m), sorted(m)
    idle = m[f"device_idle_pct.{kind}"]
    assert sum(m[n] for n in SPAN_METRICS[kind][2:]) <= idle + 1e-9
    assert all(m[n] > 0 for n in SPAN_METRICS[kind])
    syncs = m[SPAN_METRICS[kind][1]]
    assert syncs >= 2   # NMS checks its fixed point at least twice
