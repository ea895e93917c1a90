"""Evaluation (tools/eval_net.py of the JAX package): inference over the test
split and Omni3D AP in 2D and 3D (the reference's do_test,
tools/train_net.py:65-124, with inference_on_dataset,
omni3d_evaluation.py:523-642).

    python -m weakcube_tpu_torch.tools.eval_net --config-file configs/Omni_combined.yaml \
        [--synthetic N] [--eval-vis N] [--device cpu] OPT1 VAL1 ...

is `python -m weakcube_tpu_torch.tools.train_net --eval-only ...`: it
evaluates MODEL.WEIGHTS, else OUTPUT_DIR's model_final.pt or
model_recent.pt, else (with a warning) the random init, on the records of
cfg.DATASETS.TEST or on N rendered scenes, on the card unless
`--device cpu` is given, and prints the AP tables. `--eval-vis N` saves the
first N images' detections as JPEGs in OUTPUT_DIR/eval_vis. With
TPU.MESH_SHAPE asking for several processes (tools/train_net.py) the
inference is sharded over them, as the JAX CLI shards it over its devices.
"""
from __future__ import annotations

import logging
import os
import sys
import time
import types
from typing import Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger("weakcube_tpu_torch.eval")

# the Detections fields that the host records read
FETCH_FIELDS = ("boxes", "scores", "classes", "valid",
                "centers3D", "dims3D", "poses3D", "scores3D")


def fetch(det) -> Dict[str, np.ndarray]:
    """The FETCH_FIELDS of a Detections, on the host: one copy per field per
    batch."""
    out = {}
    for k in FETCH_FIELDS:
        v = getattr(det, k)
        if v is not None:
            out[k] = (v if k in ("classes", "valid") else v.float()).cpu().numpy()
    return out


def detections_to_records(fetched, batch, detections_per_image: int) -> List[Dict]:
    """Fetched detections -> per-image evaluation records at the original
    resolution (boxes divided by the batch's scale, as
    GeneralizedRCNN._postprocess does); the score is scores3D."""
    from ..ops.cuboids import get_cuboid_verts_3d_np
    out = []
    boxes = np.asarray(fetched["boxes"])
    scores = np.asarray(fetched["scores"])
    classes = np.asarray(fetched["classes"])
    valid = np.asarray(fetched["valid"])
    centers = np.asarray(fetched["centers3D"]) if fetched.get("centers3D") is not None else None
    dims = np.asarray(fetched["dims3D"]) if fetched.get("dims3D") is not None else None
    poses = np.asarray(fetched["poses3D"]) if fetched.get("poses3D") is not None else None
    s3d = np.asarray(fetched["scores3D"]) if fetched.get("scores3D") is not None else scores
    for b in range(boxes.shape[0]):
        m = valid[b]
        scale = float(batch["scale"][b])
        rec = {"image_id": int(batch["image_id"][b]), "boxes": boxes[b][m] / scale,
               "scores": s3d[b][m], "classes": classes[b][m]}
        if centers is not None:
            box3d = np.concatenate([centers[b][m], dims[b][m]], -1)
            rec["centers3D"] = centers[b][m]
            rec["corners3D"] = get_cuboid_verts_3d_np(box3d, poses[b][m])
        out.append(rec)
    return out


def gt_records_from_raw(records) -> List[Dict]:
    """Dataset records -> evaluator GT records (original resolution)."""
    from ..ops.cuboids import get_cuboid_verts_3d_np
    out = []
    for r in records:
        annos = list(r.get("annotations", []))
        boxes = np.asarray([a["bbox"] for a in annos], np.float32).reshape(-1, 4)
        classes = np.asarray([a["category_id"] for a in annos], np.int32)
        ignore = np.asarray([a.get("ignore", False) for a in annos], bool)
        centers = np.asarray([a["center_cam"] for a in annos], np.float32).reshape(-1, 3)
        dims = np.asarray([a["dimensions"] for a in annos], np.float32).reshape(-1, 3)
        poses = np.asarray([a["pose"] for a in annos], np.float32).reshape(-1, 3, 3)
        corners = get_cuboid_verts_3d_np(np.concatenate([centers, dims], -1), poses) \
            if annos else np.zeros((0, 8, 3), np.float32)
        out.append({"image_id": r["image_id"], "boxes": boxes, "classes": classes,
                    "ignore": ignore, "centers3D": centers, "corners3D": corners})
    return out


def restore_weights(cfg, model, state_dict=None) -> str:
    """Load `state_dict`, else MODEL.WEIGHTS, else OUTPUT_DIR's model_final /
    model_recent, into `model`; with none of them the model keeps its random
    init. Returns what was loaded."""
    from ..solver.checkpoint import SUFFIX, load_model_weights
    if state_dict is not None:
        model.load_state_dict(state_dict)
        return "the given state_dict"
    if cfg.MODEL.WEIGHTS:
        load_model_weights(cfg.MODEL.WEIGHTS, model)
        logger.info("restored MODEL.WEIGHTS=%s", cfg.MODEL.WEIGHTS)
        return cfg.MODEL.WEIGHTS
    for name in ("model_final", "model_recent"):
        path = os.path.join(cfg.OUTPUT_DIR, name + SUFFIX)
        if os.path.exists(path):
            load_model_weights(path, model)
            logger.info("restored %s", path)
            return path
    logger.warning("no checkpoint found in %s; evaluating random init", cfg.OUTPUT_DIR)
    return "random init"


def _dump_eval_vis(cfg, fetched, batch, budget: int) -> int:
    """JPEGs of the batch's first images' detections into
    OUTPUT_DIR/eval_vis (reference vis.visualize_from_instances); returns
    the budget left."""
    from ..vis.vis import image_to_pixels, visualize_from_instances
    det = types.SimpleNamespace(**{k: fetched.get(k) for k in FETCH_FIELDS})
    vdir = os.path.join(cfg.OUTPUT_DIR, "eval_vis")
    os.makedirs(vdir, exist_ok=True)
    for i in range(min(budget, len(batch["image_id"]))):
        visualize_from_instances(image_to_pixels(batch["image"][i], cfg), np.asarray(batch["K"][i]),
                                 det, i, os.path.join(vdir, f"{int(batch['image_id'][i])}_pred.jpg"))
        budget -= 1
    return budget


def do_test(cfg, args, records, loaders, model=None, state_dict=None, proximity: bool = True,
            batch_size: Optional[int] = None, device=None, priors=None) -> Dict:
    """Inference over `records` and their AP.

    model: a model to evaluate as it is (the train CLI's live model); it
      runs in eval mode under no_grad and goes back to its own mode after.
    Without a model, one is built (priors: `priors`, else computed from
      `records`) and restore_weights() fills it from `state_dict`,
      MODEL.WEIGHTS or OUTPUT_DIR.
    device: the card unless 'cpu' is given (default args.device; a given
      model's own device).
    Data parallel (every rank calls do_test): the global batch is
    batch_size rounded up to a multiple of the ranks, as the JAX CLI
    rounds it to its devices, and each rank runs inference (K1 on its card)
    on its rows of every global batch. The records go to rank 0 over the
    gloo group (NCCL has no object gather), where the evaluator and the AP
    tables run; every rank returns rank 0's results. The timing is rank
    0's, over the global images.
    Returns the evaluator's results (AP2D, AP3D, AP3D@15/25/50, the band
    APs, per class) and "timing": images, seconds, images/s, the steady
    state and the medians per batch of data, inference and record ms, and
    the evaluator's seconds.
    """
    from ..data.build import build_test_batches, prefetch, to_device
    from ..evaluation import Omni3DEvaluationHelper, Omni3DEvaluator
    from ..models.priors import compute_priors
    from ..models.rcnn3d import build_model, resolve_device
    from ..parallel import distributed
    from ..vis.logperf import (print_ap_analysis_histogram, print_ap_category_histogram,
                               print_ap_dataset_histogram, print_ap_omni_histogram,
                               print_ap_table, print_dataset_analysis_histogram)

    num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    if batch_size is None:
        batch_size = int(cfg.TEST.IMS_PER_BATCH)
    world, rank = distributed.process_count(), distributed.rank()
    batch_size = -(-batch_size // world) * world
    main_rank = rank == 0
    if model is not None:
        dev = next(model.parameters()).device
    else:
        dev = resolve_device(device if device is not None else getattr(args, "device", None))
        if priors is None:
            priors = compute_priors(cfg, records, num_classes)
        model = build_model(cfg, priors, device=dev)
        restore_weights(cfg, model, state_dict)

    gt_recs = {g["image_id"]: g for g in gt_records_from_raw(records)}
    # several datasets: one evaluator each, and the pooled summarize_all
    # (reference Omni3DEvaluationHelper, omni3d_evaluation.py:168-520)
    ds_of = {r["image_id"]: r.get("dataset_name", "dataset") for r in records}
    ds_names = sorted(set(ds_of.values()))
    multi_ds = len(ds_names) > 1
    if multi_ds:
        helper = Omni3DEvaluationHelper(
            ds_names, num_classes, device=dev,
            output_folder=os.path.join(cfg.OUTPUT_DIR, "eval") if cfg.OUTPUT_DIR else None)

        def add_record(rec):
            return helper.add_predictions(ds_of[rec["image_id"]], rec, gt_recs[rec["image_id"]])
    else:
        evaluator = Omni3DEvaluator(num_classes, proximity=proximity, device=dev)

        def add_record(rec):
            return evaluator.add(rec, gt_recs[rec["image_id"]])

    vis_budget = int(getattr(args, "eval_vis", 0) or 0) if main_rank else 0
    others = []  # a rank > 0's records, sent to rank 0 at the end
    # two pipeline stages ahead of the model: the mapper, and the pinned copy
    # of the model's inputs (the inference reads image, image_wh and K only)
    batches = prefetch(build_test_batches(cfg, records, batch_size=batch_size, loaders=loaders,
                                          rank=rank, world=world))
    dev_batches = prefetch((to_device({k: b[k] for k in ("image", "image_wh", "K")}, dev), b)
                           for b in batches)
    was_training = model.training
    model.eval()
    n_img, shapes_seen = 0, set()
    per_batch = []   # (data, inference, records) seconds; first batch of each shape marked
    t0 = time.time()
    try:
        with torch.no_grad():
            while True:
                t = time.perf_counter()
                nxt = next(dev_batches, None)
                t_data = time.perf_counter() - t
                if nxt is None:
                    break
                model_batch, batch = nxt
                t = time.perf_counter()
                fetched = fetch(model(model_batch))  # the copy to the host syncs
                t_inf = time.perf_counter() - t
                t = time.perf_counter()
                if vis_budget > 0:
                    vis_budget = _dump_eval_vis(cfg, fetched, batch, vis_budget)
                for rec in detections_to_records(fetched, batch, cfg.TEST.DETECTIONS_PER_IMAGE):
                    # a tail batch repeats its last image; add() drops it
                    if not main_rank:
                        others.append(rec)
                    elif rec["image_id"] in gt_recs and add_record(rec):
                        n_img += 1
                shape = tuple(batch["image"].shape)
                per_batch.append((t_data, t_inf, time.perf_counter() - t, shape in shapes_seen))
                shapes_seen.add(shape)
    finally:
        dev_batches.close()
        model.train(was_training)
    gathered = distributed.gather_objects(others)
    for rec in (r for recs in gathered or [] for r in recs):
        if rec["image_id"] in gt_recs and add_record(rec):
            n_img += 1
    dt = time.time() - t0
    if not main_rank:
        return distributed.broadcast_object(None)
    logger.info("inference on %d images in %.1fs (%.2f img/s)", n_img, dt, n_img / max(dt, 1e-9))
    # the steady state leaves out the first batch of each shape (cuDNN's
    # algorithm search, allocator growth)
    steady = [b for b in per_batch if b[3]]
    med = {k: float(np.median([b[i] for b in steady])) if steady else float("nan")
           for i, k in enumerate(("data", "inference", "records"))}
    batch_s = float(np.median([sum(b[:3]) for b in steady])) if steady else float("nan")
    steady_ips = batch_size / batch_s
    if steady:
        logger.info("steady-state %.2f img/s (%.0f ms/batch of %d, of which %.0f ms blocked on "
                    "host data, %.0f ms inference, %.0f ms records; median over %d batches, "
                    "first batch of each shape excluded)", steady_ips, 1e3 * batch_s,
                    batch_size, 1e3 * med["data"], 1e3 * med["inference"], 1e3 * med["records"],
                    len(steady))

    t = time.time()
    if multi_ds:
        for name in ds_names:
            helper.save_predictions(name)
        summary = helper.summarize_all()
        eval_s = time.time() - t
        for name, res in summary["per_dataset"].items():
            print(f"== {name} ==")
            print_ap_table(res, num_classes)
            print_ap_category_histogram(name, res)
        print_dataset_analysis_histogram(summary["per_dataset"])
        print_ap_dataset_histogram(summary["per_dataset"])
        print_ap_omni_histogram(summary["overall"])
        results = summary["overall"]
        results["per_dataset"] = summary["per_dataset"]
    else:
        results = evaluator.summarize()
        eval_s = time.time() - t
        print_ap_table(results, num_classes)
        print_ap_category_histogram(ds_names[0] if ds_names else "dataset", results)
        print_ap_analysis_histogram(results)
    logger.info("evaluator: %.3fs for %d images (%.2f ms per image, IoU3D on %s)", eval_s, n_img,
                1e3 * eval_s / max(n_img, 1), dev)
    results["timing"] = {
        "images": n_img, "batches": len(per_batch), "batch_size": batch_size, "seconds": dt,
        "images_per_s": n_img / max(dt, 1e-9), "steady_images_per_s": steady_ips,
        "steady_batches": len(steady), "batch_ms": 1e3 * batch_s, "data_ms": 1e3 * med["data"],
        "inference_ms": 1e3 * med["inference"], "records_ms": 1e3 * med["records"],
        "first_batch_ms": [1e3 * sum(b[:3]) for b in per_batch if not b[3]],
        "evaluator_s": eval_s, "evaluator_ms_per_image": 1e3 * eval_s / max(n_img, 1),
        "processes": world}
    return distributed.broadcast_object(results)


def main(argv=None):
    from .train_net import main as train_main
    return train_main(["--eval-only"] + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
