"""Every host sync of the steps or requests of a cell's traced window, as
CUDA reports it, against the port's `sync` spans:

    python3 benchmark/sync_audit.py --workload <cell> --seed <n>

from a checkout's root, on a CUDA device. The cell is set up as its runner
sets it up (model, weights, traffic, the first steps or warm-up requests);
then the steps or requests of its traced window (the same batches, in the
same order, with the same sampler seeds) run under
`torch.cuda.set_sync_debug_mode("warn")` and a torch.profiler session. Each
sync that CUDA reports prints with its site (the innermost frame of the
port, else of the benchmark) and whether it lies inside one of the port's
`sync` spans (weakcube_tpu_torch/utils/trace.py). The last line is a JSON
summary: syncs inside the roots (train.step or model.forward) in and out
of `sync` spans and by site, per root beside the store's `sync` spans per
root (what host_syncs_per_*'s reader counts in a traced run), whether the
trace's base time is the same in three profiles of the process (what
harness/program_spans.py assumes), and the cost of a span with no
profiler (us). It
exits 1 where a sync inside a root lies outside every `sync` span. The
benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import tempfile
import time
import timeit
import traceback
import warnings

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT_DIR = os.path.dirname(BENCH_DIR)


def _site() -> str:
    frames = traceback.extract_stack()[:-2]
    for needle in ("weakcube_tpu_torch", "benchmark"):
        mine = [f for f in frames if needle in f.filename]
        if mine:
            f = mine[-1]
            return f"{os.path.relpath(f.filename, ROOT_DIR)}:{f.lineno} {f.name}"
    return "elsewhere"


def _export(prof) -> dict:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="sync_audit_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def audit(cell: dict, seed: int, device, overrides=()) -> dict:
    import torch
    from harness import common, program_spans, systems, weights
    from harness.spec import config, load_file_module
    from weakcube_tpu_torch.utils import trace as port_trace

    spec = config(cell["config"])
    runner = load_file_module("runners", cell["runner"])
    side, ref_side = systems.port(), systems.reference()
    ov = list(cell.get("overrides", [])) + list(overrides)
    cfg = common.build_cfg(side.get_cfg, spec, ov)
    priors = common.dims_priors(spec, cfg.MODEL.ROI_HEADS.NUM_CLASSES)
    sd = weights.make_state_dict(
        systems.meta_model(ref_side, common.build_cfg(ref_side.get_cfg, spec, ov), priors),
        spec["weights_seed"], device, spec.get("init"))
    tp = cell["traffic"]
    raw = load_file_module("traffic", tp["kind"]).generate(tp, seed)
    model = side.rcnn3d.build_model(cfg, priors, device)
    weights.load(model, sd)
    train = cell["runner"] == "train_step"
    if train:
        raw_pool = runner._device_pool(raw, device)
        state, opt, _ = runner.first_steps(side, cfg, model, raw_pool, seed, device, sd)
        pools = [runner._side_batch(r, side.GroundTruth) for r in raw_pool]

        def window():
            nonlocal state
            for i in range(runner.FIRST_STEPS, runner.FIRST_STEPS + cell["trace_steps"]):
                state, _ = side.train.train_step(model, opt, state, pools[i % len(pools)],
                                                 runner._generator(device, seed, i))
    else:
        pool = runner._host_pool(raw, device.type == "cuda")
        for k in range(runner.WARMUP):
            runner._request(model, pool[k % len(pool)], device)

        def window():
            for n in range(cell["trace_requests"]):
                runner._request(model, pool[n % len(pool)], device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    base_before = program_spans.trace_base_ns()
    port_trace.take()
    seen = []
    show = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            seen.append((time.time_ns(), _site()))
        else:
            show(message, category, filename, lineno, file, line)
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        with torch.profiler.profile(activities=acts) as prof:
            if device.type == "cuda":
                torch.cuda.set_sync_debug_mode("warn")
            try:
                window()
            finally:
                if device.type == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
                    torch.cuda.synchronize(device)
    spans = port_trace.take()
    root_name = "train.step" if train else "model.forward"
    roots = [s for s in spans if s.parent is None and s.name == root_name]
    syncs = [s for s in spans if s.name == "sync"]
    out = {"workload": cell["name"], "seed": seed, "roots": len(roots),
           "sync_spans": len(syncs), "syncs_reported": len(seen),
           "sync_spans_per_root": len(syncs) / max(len(roots), 1),
           "inside_root": {"in_sync_span": 0, "outside": 0}, "outside_root": 0, "sites": {}}
    for t, site in seen:
        in_root = any(r.start_ns <= t <= r.end_ns for r in roots)
        in_sync = any(s.start_ns <= t <= s.end_ns for s in syncs)
        key = f"{site} | {'sync span' if in_sync else 'NO sync span'}" + (
            "" if in_root else " | outside the root")
        out["sites"][key] = out["sites"].get(key, 0) + 1
        if not in_root:
            out["outside_root"] += 1
        else:
            out["inside_root"]["in_sync_span" if in_sync else "outside"] += 1
        print(f"sync at {key}")
    out["syncs_reported_per_root"] = sum(out["inside_root"].values()) / max(len(roots), 1)
    out["base_ns"] = [base_before, _export(prof)["baseTimeNanoseconds"],
                      program_spans.trace_base_ns()]
    out["base_fixed"] = len(set(out["base_ns"])) == 1

    def off():
        with port_trace.span("sync"):
            pass
    out["span_off_us"] = timeit.timeit(off, number=200000) / 200000 * 1e6
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args()
    sys.path[:0] = [ROOT_DIR, BENCH_DIR]
    import torch
    from harness import spec
    if not torch.cuda.is_available():
        print("sync_audit.py: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = audit(spec.cell(args.workload), args.seed, device)
    print(json.dumps(out), flush=True)
    return 1 if out["inside_root"]["outside"] else 0


if __name__ == "__main__":
    sys.exit(main())
