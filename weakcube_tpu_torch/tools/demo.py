"""Folder inference demo (demo/demo.py of the JAX package): run the model on
a folder of images with default or given intrinsics, and save the 3D
wireframes and a top-down view of each image as a JPEG.

    python -m weakcube_tpu_torch.tools.demo --config-file configs/Omni_combined.yaml \
        --input-folder imgs/ --output-folder out/ [--focal-length F] \
        [--principal-point PX PY] [--threshold 0.25] [--depth-folder D] \
        [--ground-folder G] [--device cpu] MODEL.WEIGHTS model_final.pt ...

Runs on the card unless `--device cpu` is given. The weights come from
MODEL.WEIGHTS (a checkpoint of this package, a released detectron2 .pth or a
cubercnn:// name), else the random init of seed 0; every class gets the
flat dims priors of the reference demo (mean 0.8 m, std 0.3 m). The
default intrinsics follow the reference (demo.py:67-80): f = 4 h / 2 in
NDC, i.e. a focal length of twice the image height, and the principal
point at the centre. Depth and ground maps (`<stem>.npz` in
--depth-folder / --ground-folder) go through the mapper when present
(demo.py:81-94). Detections whose scores3D is below --threshold are not
drawn.
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
import types
from typing import Dict, List

import numpy as np
import torch

logger = logging.getLogger("weakcube_tpu_torch.demo")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-file", required=True)
    p.add_argument("--input-folder", required=True)
    p.add_argument("--output-folder", default="demo_out")
    p.add_argument("--focal-length", type=float, default=0.0)
    p.add_argument("--principal-point", type=float, nargs=2, default=None)
    p.add_argument("--threshold", type=float, default=0.25)
    p.add_argument("--depth-folder", default=None)
    p.add_argument("--ground-folder", default=None)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda; 'cpu' for the CPU)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def _npz_map(folder, stem):
    path = os.path.join(folder, stem + ".npz") if folder else None
    if path and os.path.exists(path):
        with np.load(path) as z:
            return z[list(z.keys())[0]]
    return None


def main(argv=None) -> List[Dict]:
    """Returns, per image in file-name order, its evaluation record
    (tools/eval_net.py::detections_to_records, image_id = the index) of the
    drawn detections, with "file" and "output"."""
    from ..config import get_cfg
    from ..data.build import pad_batch, to_device
    from ..data.mapper import DatasetMapper3D
    from ..entry import dims_priors
    from ..models.rcnn3d import build_model, resolve_device
    from ..solver.checkpoint import load_model_weights
    from ..utils.util import imread
    from ..vis.vis import image_to_pixels, visualize_from_instances
    from .eval_net import detections_to_records, fetch

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    args = parse_args(argv)
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    dev = resolve_device(args.device)

    files = sorted(sum((glob.glob(os.path.join(args.input_folder, e))
                        for e in ("*.jpg", "*.png", "*.jpeg")), []))
    if not files:
        logger.error("no images found in %s", args.input_folder)
        return []
    os.makedirs(args.output_folder, exist_ok=True)

    model = build_model(cfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), device=dev)
    if cfg.MODEL.WEIGHTS:
        load_model_weights(cfg.MODEL.WEIGHTS, model)
        logger.info("restored MODEL.WEIGHTS=%s", cfg.MODEL.WEIGHTS)
    mapper = DatasetMapper3D(cfg, is_train=False)
    out = []
    for i, path in enumerate(files):
        img = imread(path)
        h, w = img.shape[:2]
        f = args.focal_length or 2.0 * h  # the reference's default: f = 4 h / 2 in NDC
        px, py = args.principal_point or (w / 2, h / 2)
        K = np.array([[f, 0, px], [0, f, py], [0, 0, 1]], np.float32)
        record = {"file_name": path, "width": w, "height": h, "K": K, "image_id": i,
                  "annotations": []}
        stem = os.path.splitext(os.path.basename(path))[0]
        example = mapper(record, image=img, depth_map=_npz_map(args.depth_folder, stem),
                         ground_map=_npz_map(args.ground_folder, stem))
        batch = pad_batch([example])
        with torch.no_grad():
            det = fetch(model(to_device({k: batch[k] for k in ("image", "image_wh", "K")}, dev)))
        det["valid"] = det["valid"] & (det["scores3D"] >= args.threshold)
        # drawn at the network's resolution
        dst = os.path.join(args.output_folder, stem + "_3Dboxes.jpg")
        visualize_from_instances(image_to_pixels(batch["image"][0], cfg), batch["K"][0],
                                 types.SimpleNamespace(**det), 0, dst)
        logger.info("wrote %s (%d boxes)", dst, int(det["valid"][0].sum()))
        rec = detections_to_records(det, batch, cfg.TEST.DETECTIONS_PER_IMAGE)[0]
        out.append(dict(rec, file=path, output=dst))
    return out


if __name__ == "__main__":
    main()
