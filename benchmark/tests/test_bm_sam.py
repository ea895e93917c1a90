"""The SAM cell (samhq_vitl.ground_b8) at a size the CPU holds: its spec,
the comparison that decides `correct` (a sound run passes; the fp8 control
and each planted fault fail), the biased K2 bound against the figures
worked by hand, and the SAM readers on a hand-made store and trace."""
import time
from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch

from harness import faults, readers, sam_compare, sam_faults, sam_spans, spec, systems
from harness.k2_relpos_bound import flash_attention_relpos_bound_s, rel_pos_bytes
from harness.sam_probe import SamFlashProbe
from harness.trace import Trace

CELL = "samhq_vitl.ground_b8"
SPAN_METRICS = ["idle_in_preprocess_pct.sam", "idle_in_masks_out_pct.sam"]
METRICS = {"mfu_pct.sam", "device_idle_pct.sam", "k2_roofline_pct.sam",
           "idle_in_preprocess_pct.sam", "idle_in_masks_out_pct.sam",
           "launches_per_request.sam"}


def drive(trace=False, system=None, batch=2, seed=2**31 + 23):
    """One run of the cell's runner on the CPU: vit_tiny at 256 px in
    float32 (16 x 16 tokens: 4 padded windows and global blocks), pools of
    64x48 images; returns the result line."""
    import run
    cell = spec.cell(CELL)
    cell["traffic"].update(pool=3, batch=batch, canvas=[48, 64], scene_wh=[64, 48],
                           objects={"mean": 3, "min": 1, "max": 8, "dispersion": 2})
    cell.update(trace_requests=3, check_requests=2)
    cfg = dict(spec.config(cell["config"]), variant="vit_tiny", img_size=256, dtype="float32")
    ctx = {"cell": cell, "cfg_spec": cfg, "seed": seed, "seconds": 0.2, "trace": trace,
           "device": torch.device("cpu"), "t0": time.perf_counter()}
    if system is not None:
        ctx["system"] = system
    res = spec.load_file_module("runners", cell["runner"]).run(ctx)
    return run.result_line(cell, res, trace, "cpu")


@pytest.fixture
def plant():
    spec.load_file_module("runners", "sam")   # registers the SAM faults
    undo = []
    yield lambda name: undo.append(faults.FAULTS[name]())
    for u in reversed(undo):
        u()


def test_spec_of_the_config_traffic_and_cell():
    c = spec.cell(CELL)
    cfg = spec.config(c["config"])
    assert c["chips"] == 1 and c["runner"] == "sam" and c["traffic_name"] == "images_b8_box1_closed"
    assert cfg["reduced"] == [] and cfg["dtype"] == "bfloat16"
    assert (cfg["variant"], cfg["img_size"]) == ("vit_l", 1024)
    assert "build_sam_hq_vit_l" in cfg["yaml"][cfg["entry"]]
    tp = c["traffic"]
    assert tp["batch"] == 8 and tp["scene_wh"] == [640, 480] and tp["canvas"] == [480, 640]
    assert set(c["limits"]) == set(sam_compare.NUMBERS)
    pool = spec.load_file_module("traffic", tp["kind"]).generate(
        dict(tp, pool=2, batch=3, canvas=[48, 64], scene_wh=[64, 48]), 2**40 + 3)
    for b in pool:
        wh = np.asarray(b["image_wh"], np.float64)
        x0, y0, x1, y1 = (b["boxes"] / np.concatenate([wh, wh], 1)).T
        band = tp["box_band"]
        for v, k in ((x0, "x0"), (y0, "y0"), (x1, "x1"), (y1, "y1")):
            assert np.all((v >= band[k][0] - 1e-6) & (v <= band[k][1] + 1e-6)), k


def test_each_metric_is_declared_for_the_cell():
    assert {m["name"] for m in spec.per_layer(CELL)} == METRICS
    assert {m["name"] for m in spec.end_to_end(CELL)} == {"detect_images_per_s", "setup_s"}


def test_sound_run_is_correct():
    """float32 on both sides: the logits differ by the order of float32
    sums alone."""
    out = drive()
    assert out["correct"], out["checks"]
    assert out["checks"]["mask_max_gap"]["value"] < 1e-3
    assert set(out["metrics"]) == {"detect_images_per_s", "setup_s"}


@pytest.mark.parametrize("fault,batch", [("half_batch_sam", 4), ("rel_pos_left_out", 2),
                                         ("global_block_windowed", 2),
                                         ("last_block_skipped", 2)])
def test_fault_is_not_correct(plant, fault, batch):
    plant(fault)
    out = drive(batch=batch)
    assert not out["correct"], out["checks"]


def test_every_fault_registered():
    spec.load_file_module("runners", "sam")
    assert set(sam_faults.FAULTS) <= set(faults.FAULTS)
    assert set(sam_faults.FAULTS) == {"half_batch_sam", "rel_pos_left_out",
                                      "global_block_windowed", "last_block_skipped"}


def test_control_is_not_correct():
    out = drive(system=systems.reference("fp8"))
    assert not out["correct"], out["checks"]


def test_compare_logits():
    r = [torch.arange(12.0).view(1, 3, 4), torch.linspace(-1, 1, 4).view(1, 2, 2)]
    assert sam_compare.compare_logits(r, r) == {"mask_max_gap": 0.0, "mask_mean_gap": 0.0}
    p = [r[0].clone(), r[1].clone()]
    p[0][0, 1, 1] += 1.0
    got = sam_compare.compare_logits(p, r)
    assert got["mask_max_gap"] == pytest.approx(1.0 / float(r[0].double().std()))
    assert got["mask_mean_gap"] == pytest.approx(got["mask_max_gap"] / 16)
    # a flat map's spread is floored
    flat = [torch.zeros(1, 2, 2)]
    assert sam_compare.compare_logits([flat[0] + 1e-6], flat)["mask_max_gap"] == \
        pytest.approx(1.0)
    assert sam_compare.compare_logits(r[:1], r)["mask_max_gap"] == float("inf")
    assert sam_compare.compare_logits([r[1], r[0]], r)["mask_mean_gap"] == float("inf")
    bad = [r[0] * float("nan"), r[1]]
    assert sam_compare.compare_logits(bad, r)["mask_max_gap"] == float("inf")
    # the sign share: the two halves of r[1] swap sides in p
    assert sam_compare.disagreeing_share([-r[1]], [r[1]]) == 1.0
    assert sam_compare.disagreeing_share(r, r) == 0.0


def test_relpos_bound_by_hand():
    """SAM-HQ ViT-L at b8, bf16. Windowed: B 200 (8 x 25 windows), H 16, N
    196: 4 B H N d 2 = 3.2113e8 bytes of q, k, v, o and 4 B H N (14 + 14) =
    7.0246e7 of bias, 3.9137e8 over 3.35e12 = 0.11683 ms (the operations,
    3.15e10, take 0.0318 ms). Global: B 8, H 16, N 4096: 4 B H N^2 d =
    5.4976e11 operations over 989e12 = 0.55587 ms."""
    assert rel_pos_bytes(200, 16, 196, 14, 14) == pytest.approx(7.02464e7)
    assert flash_attention_relpos_bound_s(200, 16, 196, 64, 14, 14) * 1e3 == \
        pytest.approx(0.116828, rel=1e-5)
    assert flash_attention_relpos_bound_s(8, 16, 4096, 64, 64, 64) * 1e3 == \
        pytest.approx(0.555870, rel=1e-5)
    # the bias alone, where it is all the bytes
    assert flash_attention_relpos_bound_s(1, 1, 4, 64, 2, 2) == \
        pytest.approx((8 * 4 * 64 + 4 * 4 * 4) / 3.35e12)


def test_probe_records_the_calls_on_the_cpu():
    class Mod:
        calls = []

        @staticmethod
        def flash_attention(q, k, v, scale, rel_pos=None):
            Mod.calls.append(rel_pos is not None)
            return q
    q = torch.zeros(2, 3, 16, 64)
    rel = (torch.zeros(2, 3, 16, 4), torch.zeros(2, 3, 16, 4))
    with SamFlashProbe(Mod) as probe:
        Mod.flash_attention(q, q, q, 0.125, rel_pos=rel)
        Mod.flash_attention(q, q, q, 0.125, rel_pos=rel)
    s = probe.summary()
    assert Mod.calls == [True, True] and s["calls"] == 2 and s["event_s"] == 0.0
    assert s["by_shape"]["2.3.16"]["calls"] == 2
    assert s["bound_s"] == pytest.approx(2 * flash_attention_relpos_bound_s(2, 3, 16, 64, 4, 4,
                                                                            4))


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


def sam_layer(shift_us=0.0):
    """A window of 0-1000 us with two requests (bench.request 0-480 and
    500-990). The device runs 50-100 (a copy), 150-400 (biased K2 100 us of
    it), 600-900; its gaps: 0-50, 100-150, 400-600, 900-1000. Request 1:
    preprocess 10-140 (40 + 40 of gaps inside), encoder 140-300, decoder
    300-380, masks_out 380-470 (70 inside). Request 2: preprocess 510-590
    (80), masks_out 900-980 (80)."""
    events = [ev("bench.window", 0, 1000), ev("bench.request", 0, 480),
              ev("bench.request", 500, 490), ev("copy", 50, 50, "gpu_memcpy"),
              ev("void flash_fwd_relpos_bf16<>", 150, 100, "kernel"),
              ev("k", 250, 150, "kernel"), ev("k", 600, 300, "kernel")]
    s = shift_us
    store = [span("sam.batch", 5 + s, 475 + s, 0, None, 0),
             span("sam.preprocess", 10, 140, 1, 0, 0),
             span("sam.encoder", 140, 300, 2, 0, 0),
             span("sam.decoder", 300, 380, 3, 0, 0),
             span("sam.masks_out", 380, 470, 4, 0, 0),
             span("sam.batch", 505, 985, 5, None, 5),
             span("sam.preprocess", 510, 590, 6, 5, 5),
             span("sam.masks_out", 900, 980, 7, 5, 5)]
    return {"kind": "sam", "trace": Trace(events), "span_store": (store, BASE_NS),
            "requests": 2, "k2": {"calls": 2, "bound_s": 50e-6, "event_s": 0.0},
            "flops_per_request": 989e12 * 1e-3, "chips": 1}


def read(name, layer):
    return spec.load_file_module("metrics", name).read(layer)


def test_idle_in_the_sam_spans():
    layer = sam_layer()
    assert read("idle_in_preprocess_pct.sam", layer) == pytest.approx(16.0)
    assert read("idle_in_masks_out_pct.sam", layer) == pytest.approx(15.0)
    assert read("device_idle_pct.sam", layer) == pytest.approx(40.0)
    assert read("launches_per_request.sam", layer) == pytest.approx(1.5)
    # 2 requests of 1 ms at the peak in a 1 ms window
    assert read("mfu_pct.sam", layer) == pytest.approx(200.0)


def test_k2_roofline_reads_the_biased_kernel_time():
    layer = sam_layer()
    assert read("k2_roofline_pct.sam", layer) == pytest.approx(50.0)
    layer["k2"] = {"calls": 0, "bound_s": 0.0, "event_s": 0.0}
    assert read("k2_roofline_pct.sam", layer) is None
    # the depth cell's unbiased kernel is not the biased one
    layer = sam_layer()
    layer["trace"] = Trace([ev("bench.window", 0, 1000),
                            ev("void flash_fwd_bf16<>", 150, 100, "kernel")])
    layer["k2"]["event_s"] = 200e-6
    assert read("k2_roofline_pct.sam", layer) == pytest.approx(25.0)


def test_a_root_outside_its_request_silences_the_span_readers():
    assert read(SPAN_METRICS[0], sam_layer(shift_us=40.0)) is not None
    for name in SPAN_METRICS:
        assert read(name, sam_layer(shift_us=61.0)) is None, name
    layer = sam_layer()
    layer["span_store"] = ([s for s in layer["span_store"][0] if s.root == 0], BASE_NS)
    assert sam_spans.spans(layer) is None   # one root for two requests


def test_sam_readers_return_none_elsewhere():
    for name in METRICS:
        layer = sam_layer()
        layer["kind"] = "depth"
        assert read(name, layer) is None, name
        assert read(name, {}) is None, name
        layer = sam_layer()
        del layer["trace"]
        assert read(name, layer) is None, name
    assert readers.launches_per_request(sam_layer()) is None   # the detector's reader


def test_traced_tiny_run_prints_the_span_metrics():
    """On the CPU the device is idle throughout and K2 is the plain
    version (no kernel, no CUDA events: no roofline share)."""
    out = drive(trace=True)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(SPAN_METRICS + ["mfu_pct.sam", "device_idle_pct.sam",
                               "launches_per_request.sam"]) <= set(m), sorted(m)
    assert "k2_roofline_pct.sam" not in m
    assert all(m[n] > 0 for n in SPAN_METRICS)
    assert sum(m[n] for n in SPAN_METRICS) <= m["device_idle_pct.sam"] + 1e-9
