"""The depth cell (dav2_vitl.depth_b16) at a size the CPU holds: the
comparison that decides `correct` (a sound run passes; the fp8 control and
each planted fault fail), K2's bound against the figures worked by hand,
and the depth span readers on a hand-made store and trace."""
import time
from typing import NamedTuple, Optional

import pytest
import torch

from harness import depth_compare, depth_readers, depth_spans, faults, readers, spec, systems
from harness.k2_bound import flash_attention_bound_s
from harness.trace import Trace

CELL = "dav2_vitl.depth_b16"
SPAN_METRICS = ["idle_in_preprocess_pct.depth", "idle_in_resize_out_pct.depth"]


def drive(trace=False, system=None, batch=2, seed=2**31 + 17):
    """One run of the cell's runner on the CPU: ViT-S at 56 px in float32,
    pools of 64x48 images; returns the result line."""
    import run
    cell = spec.cell(CELL)
    cell["traffic"].update(pool=3, batch=batch, canvas=[48, 64], scene_wh=[64, 48],
                           objects={"mean": 3, "min": 1, "max": 8, "dispersion": 2})
    cell.update(trace_requests=3, check_requests=2)
    cfg = dict(spec.config(cell["config"]), variant="vits", input_size=56, dtype="float32")
    ctx = {"cell": cell, "cfg_spec": cfg, "seed": seed, "seconds": 0.2, "trace": trace,
           "device": torch.device("cpu"), "t0": time.perf_counter()}
    if system is not None:
        ctx["system"] = system
    res = spec.load_file_module("runners", cell["runner"]).run(ctx)
    return run.result_line(cell, res, trace, "cpu")


@pytest.fixture
def plant():
    spec.load_file_module("runners", "depth")   # registers the depth faults
    undo = []
    yield lambda name: undo.append(faults.FAULTS[name]())
    for u in reversed(undo):
        u()


def test_sound_run_is_correct():
    """float32 on both sides: the maps differ by float16 rounding alone."""
    out = drive()
    assert out["correct"], out["checks"]
    assert out["checks"]["depth_max_gap"]["value"] < 0.02
    assert set(out["metrics"]) == {"detect_images_per_s", "setup_s"}


@pytest.mark.parametrize("fault,batch", [("half_batch_depth", 4), ("depth_map_altered", 2),
                                         ("block_skipped", 2)])
def test_fault_is_not_correct(plant, fault, batch):
    plant(fault)
    out = drive(batch=batch)
    assert not out["correct"], out["checks"]


def test_control_is_not_correct():
    out = drive(system=systems.reference("fp8"))
    assert not out["correct"], out["checks"]


def test_compare_maps():
    r = [torch.arange(12.0).view(3, 4).half(), torch.ones(2, 2).half()]
    assert depth_compare.compare_maps(r, r) == {"depth_max_gap": 0.0, "depth_mean_gap": 0.0}
    p = [r[0].clone(), r[1].clone()]
    p[0][1, 1] += 1.0
    got = depth_compare.compare_maps(p, r)
    assert got["depth_max_gap"] == pytest.approx(1.0 / float(r[0].double().std()))
    # the flat map's spread is floored at 1 mm
    p = [r[0], r[1] + 0.5]
    assert depth_compare.compare_maps(p, r)["depth_max_gap"] == pytest.approx(500.0)
    assert depth_compare.compare_maps(r[:1], r)["depth_max_gap"] == float("inf")
    assert depth_compare.compare_maps([r[1], r[0]], r)["depth_mean_gap"] == float("inf")


def test_k2_bound_by_hand():
    """B16 H16 N1370 d64 in bf16: 4 B H N^2 d = 1.2300e11 operations over
    989e12 is 0.1244 ms; 8 B H N d = 1.7957e8 bytes over 3.35e12 is 0.0536 ms,
    so the operations bound it."""
    assert flash_attention_bound_s(16, 16, 1370, 64) * 1e3 == pytest.approx(0.12437, rel=1e-4)
    assert flash_attention_bound_s(1, 1, 4, 64) == pytest.approx(8 * 4 * 64 / 3.35e12)


# --------------------------------------------------------------------------
# readers on a hand-made trace and store

BASE_NS = 1_000_000_000


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


def depth_layer(shift_us=0.0):
    """A window of 0-1000 us with two requests (bench.request 0-480 and
    500-990). The device runs 50-100 (a copy), 150-400 (K2 100 us of it),
    600-900; its gaps: 0-50, 100-150, 400-600, 900-1000. Request 1:
    preprocess 10-140 (40 + 40 of gaps inside), encoder 140-300, head
    300-380, resize_out 380-470 (70 inside). Request 2: preprocess 510-590
    (80), resize_out 900-980 (80)."""
    events = [ev("bench.window", 0, 1000), ev("bench.request", 0, 480),
              ev("bench.request", 500, 490), ev("copy", 50, 50, "gpu_memcpy"),
              ev("void flash_fwd_bf16<>", 150, 100, "kernel"), ev("k", 250, 150, "kernel"),
              ev("k", 600, 300, "kernel")]
    s = shift_us
    store = [span("depth.batch", 5 + s, 475 + s, 0, None, 0),
             span("depth.preprocess", 10, 140, 1, 0, 0),
             span("depth.encoder", 140, 300, 2, 0, 0),
             span("depth.head", 300, 380, 3, 0, 0),
             span("depth.resize_out", 380, 470, 4, 0, 0),
             span("depth.batch", 505, 985, 5, None, 5),
             span("depth.preprocess", 510, 590, 6, 5, 5),
             span("depth.resize_out", 900, 980, 7, 5, 5)]
    return {"kind": "depth", "trace": Trace(events), "span_store": (store, BASE_NS),
            "requests": 2, "k2": {"calls": 2, "bound_s": 50e-6, "event_s": 0.0}}


def read(name, layer):
    return spec.load_file_module("metrics", name).read(layer)


def test_idle_in_the_depth_spans():
    layer = depth_layer()
    assert read("idle_in_preprocess_pct.depth", layer) == pytest.approx(16.0)
    assert read("idle_in_resize_out_pct.depth", layer) == pytest.approx(15.0)
    assert read("device_idle_pct.depth", layer) == pytest.approx(40.0)
    assert read("launches_per_request.depth", layer) == pytest.approx(1.5)


def test_k2_roofline_reads_the_kernel_time():
    layer = depth_layer()
    assert read("k2_roofline_pct.depth", layer) == pytest.approx(50.0)
    layer["k2"] = {"calls": 0, "bound_s": 0.0, "event_s": 0.0}
    assert read("k2_roofline_pct.depth", layer) is None


def test_a_root_outside_its_request_silences_the_span_readers():
    assert read(SPAN_METRICS[0], depth_layer(shift_us=40.0)) is not None
    for name in SPAN_METRICS:
        assert read(name, depth_layer(shift_us=61.0)) is None, name
    layer = depth_layer()
    layer["span_store"] = ([s for s in layer["span_store"][0] if s.root == 0], BASE_NS)
    assert depth_spans.spans(layer) is None   # one root for two requests


def test_depth_readers_return_none_elsewhere():
    names = SPAN_METRICS + ["k2_roofline_pct.depth", "launches_per_request.depth",
                            "mfu_pct.depth", "device_idle_pct.depth"]
    for name in names:
        layer = depth_layer()
        layer["kind"] = "detect"
        assert read(name, layer) is None, name
        assert read(name, {}) is None, name
    assert depth_readers.k2_roofline_pct({"kind": "depth"}) is None
    assert readers.launches_per_request(depth_layer()) is None   # the detector's reader


def test_each_metric_is_declared_for_the_cell():
    mine = {m["name"] for m in spec.per_layer(CELL)}
    assert mine == {"mfu_pct.depth", "device_idle_pct.depth", "k2_roofline_pct.depth",
                    "idle_in_preprocess_pct.depth", "idle_in_resize_out_pct.depth",
                    "launches_per_request.depth"}
    assert {m["name"] for m in spec.end_to_end(CELL)} == {"detect_images_per_s", "setup_s"}


def test_traced_tiny_run_prints_the_span_metrics():
    """On the CPU the device is idle throughout and K2 is the plain
    version (no kernel, so no roofline share)."""
    out = drive(trace=True)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(SPAN_METRICS + ["mfu_pct.depth", "device_idle_pct.depth",
                               "launches_per_request.depth"]) <= set(m), sorted(m)
    assert "k2_roofline_pct.depth" not in m
    assert all(m[n] > 0 for n in SPAN_METRICS)
    assert sum(m[n] for n in SPAN_METRICS) <= m["device_idle_pct.depth"] + 1e-9
