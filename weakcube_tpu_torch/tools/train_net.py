"""Training entry point (tools/train_net.py of the JAX package), on one
card or data-parallel over several.

    python -m weakcube_tpu_torch.tools.train_net --config-file configs/Omni_combined.yaml \
        [--eval-only] [--eval-vis N] [--resume] [--max-iters N] [--synthetic N] \
        [--device cpu] [--profile] OPT1 VAL1 OPT2 VAL2 ...

Runs on the card unless `--device cpu` is given. TPU.MESH_SHAPE [n] runs n
data-parallel processes (parallel/distributed.py): [-1], the default, is
every visible card (one process on the CPU); `--device cpu
TPU.MESH_SHAPE [2]` runs two gloo processes. SOLVER.IMS_PER_BATCH is the
global batch and must divide over them (it raises otherwise); each rank
maps and trains on its rows, and the step is that of one process on the
global batch (parallel/train_step.py). Rank 0 alone writes the logs,
metrics.json, checkpoints and JPEGs; the evaluations are sharded. Several
hosts: the WEAKCUBE_* variables of parallel/distributed.py.

Trains on the registered datasets of cfg.DATASETS.TRAIN, or on N
procedurally rendered scenes (`--synthetic N`), with the stabilised train
step; logs every 20
iterations (console and OUTPUT_DIR/metrics.json), keeps one rolling
checkpoint (model_recent, every SOLVER.CHECKPOINT_PERIOD steps) and
model_final, and restarts from model_recent when the share of skipped
updates reaches MODEL.STABILIZE (checked every CHECKPOINT_PERIOD // 2
iterations, up to MAX_TRAINING_ATTEMPTS). Each step draws from a generator
seeded from SEED and the iteration, so a resumed run draws what an
uninterrupted one would.

`--eval-only` evaluates a checkpoint on cfg.DATASETS.TEST
(tools/eval_net.py::do_test). During training, TEST.EVAL_PERIOD > 0
evaluates the live model every EVAL_PERIOD iterations (before the last),
and VIS_PERIOD > 0 saves JPEGs of the GT 2D boxes and of the GT and
predicted cuboids of the batch's first image into OUTPUT_DIR/vis. Errors
of either stop the run.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import math
import os
import sys
import time
from functools import lru_cache

import numpy as np
import torch

logger = logging.getLogger("weakcube_tpu_torch")

# metrics the train step computes every METRICS_PERIOD steps and reports as
# NaN on the others: the logs carry their last finite value
TICK_GATED_METRICS = ("Cube/IoU3D",)
MAX_TRAINING_ATTEMPTS = 10  # reference train_net.py:62
LOG_PERIOD = 20
PROFILE_FIRST, PROFILE_STEPS = 2, 10  # --profile's window, after the run's first iteration


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-file", required=True)
    p.add_argument("--eval-only", action="store_true",
                   help="evaluate MODEL.WEIGHTS (else OUTPUT_DIR's checkpoint) on cfg.DATASETS.TEST")
    p.add_argument("--eval-vis", type=int, default=0,
                   help="save the first N evaluated images' detections as JPEGs in "
                        "OUTPUT_DIR/eval_vis")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--max-iters", type=int, default=None,
                   help="override SOLVER.MAX_ITER")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N procedurally generated scenes instead of "
                        "the registered datasets")
    p.add_argument("--profile", action="store_true",
                   help=f"write a torch.profiler trace of {PROFILE_STEPS} iterations from the "
                        f"run's {PROFILE_FIRST + 1}th (or to its end) to "
                        "OUTPUT_DIR/profile/trace.json (rank 0's)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda; 'cpu' for the CPU)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def seed_of(cfg) -> int:
    return 12 if cfg.SEED < 0 else cfg.SEED  # the reference's SEED


def setup(args):
    from ..config import get_cfg
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.max_iters:
        cfg.SOLVER.MAX_ITER = args.max_iters
    cfg.freeze()
    np.random.seed(seed_of(cfg))
    return cfg


def build_data(cfg, args, split: str = "train"):
    """Return (records, loaders, num_classes) of the training split
    (cfg.DATASETS.TRAIN) or the test split (cfg.DATASETS.TEST; detectron2's
    do_test evaluates it), or of `--synthetic N` rendered scenes for either.
    The test split loads images alone: inference reads nothing else, and
    its synthetic scenes are rendered up front, so that the evaluation's
    throughput measures the pipeline rather than the rasteriser."""
    from ..data import datasets as ds
    test = split == "test"
    if args.synthetic:
        from ..data import synthetic
        records = synthetic.make_dataset(args.synthetic, seed=0)
        by_id = {r["image_id"]: r for r in records}

        # the scene set is small and fixed: render each scene once
        @lru_cache(maxsize=4096)
        def _img(i):
            return synthetic.render_image(by_id[i]["_scene"])

        @lru_cache(maxsize=4096)
        def _depth(i):
            return synthetic.render_depth(by_id[i]["_scene"])

        @lru_cache(maxsize=4096)
        def _ground(i):
            return synthetic.ground_mask(by_id[i]["_scene"])

        loaders = {"image": lambda r: _img(r["image_id"])}
        if test:
            t0 = time.time()
            for r in records:
                _img(r["image_id"])
            logger.info("pre-rendered %d synthetic scenes in %.1fs", len(records), time.time() - t0)
        else:
            loaders.update(depth=lambda r: _depth(r["image_id"]),
                           ground=lambda r: _ground(r["image_id"]))
        return records, loaders, len(synthetic.CATEGORIES)

    fs = ds.get_filter_settings_from_cfg(cfg)
    records = []
    for name in (cfg.DATASETS.TEST if test else cfg.DATASETS.TRAIN):
        if name not in ds.DATASET_CATALOG:
            ds.simple_register(name, fs)
        records.extend(ds.DATASET_CATALOG[name]())
    loaders = {}
    if not test and any("depth_image_path" in r for r in records):
        loaders["depth"] = lambda r: ds.load_npz_map(r["depth_image_path"]) \
            if "depth_image_path" in r else None
        loaders["ground"] = lambda r: ds.load_npz_map(r["ground_image_path"]) \
            if "ground_image_path" in r else None
    return records, loaders, cfg.MODEL.ROI_HEADS.NUM_CLASSES


def check_batch_divides(cfg, world: int) -> None:
    """Refuse a global batch that does not divide over the processes, as
    detectron2 and the JAX package's sharding do: the batch is not rounded."""
    if cfg.SOLVER.IMS_PER_BATCH % world:
        raise ValueError(f"SOLVER.IMS_PER_BATCH {cfg.SOLVER.IMS_PER_BATCH} does not divide over "
                         f"{world} data-parallel processes")


def step_generator(seed: int, it: int, device) -> torch.Generator:
    """The generator of iteration `it`: seeded from (seed, it) alone."""
    s = int(np.random.SeedSequence([seed, it]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def do_train(cfg, args, records, loaders, num_classes):
    """Train from cfg (and args.resume / args.profile / args.device), as one
    rank of a data-parallel run or alone. Returns (state, history): the
    final TrainState and one dict per iteration (iteration, attempt,
    data_time and step_time in seconds (this rank's), the step's logs
    (global), "eval", do_test's results, after an evaluation, and with
    several ranks "rank_times", every rank's (data_time, step_time), on
    rank 0)."""
    from ..data.build import build_train_batches, prefetch, to_device
    from ..models.priors import compute_priors
    from ..models.rcnn3d import build_model, resolve_device
    from ..parallel import distributed
    from ..parallel.mesh import make_mesh, replicate
    from ..parallel.train_step import create_train_state, train_step
    from ..solver.checkpoint import (PeriodicCheckpointerOnlyOne, load_model_weights,
                                     load_weights_pretrain)
    from ..utils.events import EventStorage, default_writers
    from ..utils.util import ETA
    from .eval_net import do_test

    dev = resolve_device(args.device)
    seed = seed_of(cfg)
    mesh = make_mesh(cfg.TPU.MESH_SHAPE)
    check_batch_divides(cfg, mesh.world)
    # priors for every class of the model (a dataset may name fewer)
    priors = compute_priors(cfg, records, max(num_classes, cfg.MODEL.ROI_HEADS.NUM_CLASSES))
    model = build_model(cfg, priors, device=dev, seed=seed)
    state, opt = create_train_state(cfg, model)
    if cfg.MODEL.WEIGHTS_PRETRAIN:
        load_weights_pretrain(cfg.MODEL.WEIGHTS_PRETRAIN, model)
        logger.info("warm-started weights from %s", cfg.MODEL.WEIGHTS_PRETRAIN)
    elif cfg.MODEL.WEIGHTS:
        load_model_weights(cfg.MODEL.WEIGHTS, model)
        logger.info("initialised weights from MODEL.WEIGHTS=%s", cfg.MODEL.WEIGHTS)
    ckpt = PeriodicCheckpointerOnlyOne(cfg.OUTPUT_DIR, cfg.SOLVER.CHECKPOINT_PERIOD)
    state = ckpt.resume_or_load(model, opt, state, resume=args.resume)
    replicate(model, mesh)  # every rank starts from rank 0's weights
    start_iter = state.step
    logger.info("model on %s (rank %d of %d, %d images each); %s at step %d", dev, mesh.rank,
                mesh.world, cfg.SOLVER.IMS_PER_BATCH // mesh.world,
                "resumed" if args.resume and start_iter else "starting", start_iter)

    # two pipeline stages: the mapper (of this rank's rows), and the copy of
    # each batch to the device, both ahead of the step
    batches = prefetch(build_train_batches(cfg, records, loaders=loaders, rank=mesh.rank,
                                           world=mesh.world))
    dev_batches = prefetch(to_device(b, dev) for b in batches)

    max_iter = cfg.SOLVER.MAX_ITER
    storage = EventStorage(start_iter)
    writers = default_writers(cfg.OUTPUT_DIR, use_wandb=bool(cfg.log)) \
        if distributed.is_main_process() else []
    eta = ETA(max_iter - start_iter)
    attempt, it = 1, start_iter
    history, last_finite = [], {}
    eval_data = None  # the test split's (records, loaders), built at the first evaluation
    data_time = step_time = 0.0
    t0, n_logged = time.time(), 0
    prof = None
    while it < max_iter:
        if args.profile and it == start_iter + PROFILE_FIRST and distributed.is_main_process():
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU] + (
                [torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda" else []))
            prof.__enter__()
        t_d = time.perf_counter()
        batch = next(dev_batches)
        dt_data = time.perf_counter() - t_d
        t_s = time.perf_counter()
        state, logs = train_step(model, opt, state, batch, step_generator(seed, it, dev))
        dt_step = time.perf_counter() - t_s  # the step ends in a host sync
        data_time += dt_data
        step_time += dt_step
        history.append(dict(iteration=it, attempt=attempt, data_time=dt_data,
                            step_time=dt_step, logs=logs))
        it += 1
        storage.step()
        if prof is not None and it in (start_iter + PROFILE_FIRST + PROFILE_STEPS, max_iter):
            _export_trace(cfg, prof)
            prof = None
        # periodic JPEGs (reference VIS_PERIOD images, rcnn3d.py:126-263) and
        # evaluation (reference do_test every TEST.EVAL_PERIOD); an error in
        # either stops the run
        if cfg.VIS_PERIOD > 0 and it % cfg.VIS_PERIOD == 0 and distributed.is_main_process():
            _dump_train_vis(cfg, batch, it, model)
        if cfg.TEST.EVAL_PERIOD > 0 and it % cfg.TEST.EVAL_PERIOD == 0 and it < max_iter:
            if eval_data is None:
                eval_data = build_data(cfg, args, "test")[:2]
            history[-1]["eval"] = do_test(cfg, args, *eval_data, model=model)
        for k in TICK_GATED_METRICS:
            v = logs.get(k)
            if v is not None and not math.isnan(v):
                last_finite[k] = v
        n_logged += 1
        if it % LOG_PERIOD == 0 or it == max_iter:
            host_logs = dict(logs)
            # only the tick-gated metrics carry their last finite value: a
            # NaN in a loss signals divergence and stays visible
            for k in TICK_GATED_METRICS:
                if k in host_logs and math.isnan(host_logs[k]):
                    if k in last_finite:
                        host_logs[k] = last_finite[k]
                    else:
                        del host_logs[k]
            storage.put_scalars(**host_logs, data_time=data_time / n_logged,
                                step_time=step_time / n_logged)
            for w in writers:
                w.write(storage)
            remaining = eta.tick(n_logged)
            logger.info("iter %d/%d  loss %.4f  (%.3fs/it: data %.4f, step %.4f; eta %dm)  %s",
                        it, max_iter, host_logs.get("total_loss", float("nan")),
                        (time.time() - t0) / n_logged, data_time / n_logged,
                        step_time / n_logged, int(remaining // 60),
                        " ".join(f"{k}={v:.3f}" for k, v in sorted(host_logs.items())
                                 if k.startswith(("rpn", "BoxHead", "Cube"))))
            data_time = step_time = 0.0
            t0, n_logged = time.time(), 0
        ckpt.step(it - 1, model, opt, state)

        # restart from the last checkpoint when too many updates exploded
        # (reference train_net.py:270-302): rank 0 decides (the counters are
        # global, so every rank would), every rank reloads what rank 0 wrote
        if it % max(cfg.SOLVER.CHECKPOINT_PERIOD // 2, 1) == 0:
            frac = state.skipped / max(state.skipped + state.applied, 1)
            if distributed.broadcast_object(frac >= cfg.MODEL.STABILIZE) \
                    and attempt < MAX_TRAINING_ATTEMPTS:
                attempt += 1
                logger.warning("exploded fraction %.3f >= STABILIZE; restarting from the last "
                               "checkpoint (attempt %d)", frac, attempt)
                state = ckpt.resume_or_load(model, opt, state, resume=True)
                state = dataclasses.replace(state, skipped=0, applied=0)

    dev_batches.close()  # stops the copy stage; the mapper stage stops with it
    ckpt.finalize(model, opt, state)
    ranks = distributed.gather_objects([(h["data_time"], h["step_time"]) for h in history])
    if mesh.world > 1 and ranks is not None:
        for i, h in enumerate(history):
            h["rank_times"] = [r[i] for r in ranks]
    for w in writers:
        w.close()
    logger.info("training done: %d iters, %d skipped updates", state.step, state.skipped)
    return state, history


def _export_trace(cfg, prof) -> None:
    prof.__exit__(None, None, None)
    path = os.path.join(cfg.OUTPUT_DIR, "profile", "trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def _dump_train_vis(cfg, batch, it: int, model) -> None:
    """JPEGs of the batch's first image into OUTPUT_DIR/vis (the reference's
    visualize_training, rcnn3d.py:126-263): its GT 2D boxes, and its GT
    cuboids beside the predicted ones of the current weights (the 20 highest
    scores3D among the valid detections). The inference runs on that image
    alone, in eval mode under no_grad; the model goes back to its own mode
    after."""
    from ..utils.util import imwrite
    from ..vis.vis import draw_boxes_2d, draw_scene_view, image_to_pixels
    from .eval_net import fetch
    img = image_to_pixels(batch["image"][0].cpu().numpy(), cfg)
    gt = batch["gt"]
    valid = gt.valid[0].cpu().numpy()
    vis_dir = os.path.join(cfg.OUTPUT_DIR, "vis")
    os.makedirs(vis_dir, exist_ok=True)
    imwrite(os.path.join(vis_dir, f"iter_{it:06d}_gt.jpg"),
            draw_boxes_2d(img, gt.boxes[0].cpu().numpy()[valid]))

    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            det = fetch(model({k: batch[k][:1] for k in ("image", "image_wh", "K")}))
    finally:
        model.train(was_training)
    K0 = batch["K"][0].cpu().numpy()
    # boxes3D: [proj_cx, proj_cy, z, w, h, l, x3d, y3d, z3d]
    g3d = gt.boxes3D[0].cpu().numpy()[valid]
    gt_front, _ = draw_scene_view(img, K0, g3d[:, 6:9], g3d[:, 3:6],
                                  gt.poses[0].cpu().numpy()[valid])
    s3d = det["scores3D"][0]
    order = np.argsort(-s3d)[:20]
    keep = order[det["valid"][0][order]]
    pr_front, _ = draw_scene_view(img, K0, det["centers3D"][0][keep], det["dims3D"][0][keep],
                                  det["poses3D"][0][keep], labels=[f"{x:.2f}" for x in s3d[keep]])
    imwrite(os.path.join(vis_dir, f"iter_{it:06d}_gt_vs_pred_3d.jpg"),
            np.concatenate([gt_front, pr_front], axis=1))


def main(argv=None):
    """Train (returns (state, history)), or with --eval-only evaluate
    (returns do_test's results). With TPU.MESH_SHAPE asking for several
    processes, spawns them (each runs main) and returns rank 0's result."""
    from ..parallel import distributed
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    cfg = setup(args)
    device_type = torch.device(args.device or "cuda").type
    if not distributed.maybe_initialize_distributed(device_type):
        n = distributed.processes_for(cfg.TPU.MESH_SHAPE, device_type)
        if n > 1:
            if not args.eval_only:
                check_batch_divides(cfg, n)  # before spawning anything
            return distributed.launch(main, n, (argv,), device_type=device_type)
    if not distributed.is_main_process():
        logger.setLevel(logging.WARNING)
    if args.eval_only:
        from ..models.priors import compute_priors
        from .eval_net import do_test
        # the model's priors come from the training split, as in training
        train_records, _, num_classes = build_data(cfg, args, "train")
        records, loaders, _ = build_data(cfg, args, "test")
        logger.info("dataset: %d test records", len(records))
        priors = compute_priors(cfg, train_records,
                                max(num_classes, cfg.MODEL.ROI_HEADS.NUM_CLASSES))
        return do_test(cfg, args, records, loaders, priors=priors)
    records, loaders, num_classes = build_data(cfg, args)
    logger.info("dataset: %d records", len(records))
    return do_train(cfg, args, records, loaders, num_classes)


if __name__ == "__main__":
    main()
