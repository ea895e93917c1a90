#!/usr/bin/env python
"""Generate metric depth-map pseudo-GT artefacts on the GPU
(weakcube_tpu/data/generate_depth_maps.py).

Depth Anything V2 runs batched over the images. `depth_maps` is one
batch's whole path: uint8 images on the host, resized and normalised on the
card into one (B, 518, 518, 3) tensor, one forward at a static batch size,
each depth map resized back to its image's size and returned as a float16
host tensor. `generate` runs it over the records and saves each map as
datasets/depth_maps/{image_id}.npz (float16 `depth`), the artefact the weak
recipe's z_pseudo_gt_center loss and the ground planes read.

  python -m weakcube_tpu_torch.data.generate_depth_maps --synthetic 32 --out /tmp/depth
  python -m weakcube_tpu_torch.data.generate_depth_maps \\
      --checkpoint depth_anything_v2_metric_hypersim_vitl.pth \\
      --config-file configs/Omni_combined.yaml --out datasets/depth_maps

It runs on the card; the functions take `device="cpu"` to run on the CPU.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..models.rcnn3d import resolve_device
from ..utils.trace import span
from .datasets import read_image
from .pseudo_gt.depth_anything_v2 import (UNUSED_CHECKPOINT_KEYS, DepthAnythingV2,
                                          init_random_, preprocess_images)


def depth_of_images(model: DepthAnythingV2, images: torch.Tensor,
                    batch_size: int = 48) -> torch.Tensor:
    """Batched inference: (N, H, W, 3) -> (N, H, W) float32 metric depth.
    The last chunk is padded to the static batch with copies of its last
    image."""
    outs = []
    with torch.inference_mode():
        for s in range(0, len(images), batch_size):
            chunk = images[s:s + batch_size]
            n = len(chunk)
            if n < batch_size:
                chunk = torch.cat([chunk, chunk[-1:].expand(batch_size - n, -1, -1, -1)])
            outs.append(model(chunk)[:n].float())
    return torch.cat(outs)


def load_model(checkpoint: Union[None, str, Mapping[str, torch.Tensor]], variant: str = "vitl",
               max_depth: float = 20.0, input_size: int = 518, device=None,
               dtype: torch.dtype = torch.bfloat16) -> DepthAnythingV2:
    """DepthAnythingV2 from a released `.pth` state dict, a `.npz` holding
    the JAX package's parameter tree under "params" (numpy arrays), a state
    dict already in memory under the released names, or, with no
    checkpoint, random weights from seed 0. On `device` (the card unless
    "cpu" is given) in `dtype`, in eval mode. The convolution weights are
    kept channels_last, as the activations are (the images come in NHWC), so
    that no forward copies them into that layout again. A state dict in
    memory is assigned, not copied: where its tensors already have the
    device and dtype asked for, they become the model's parameters."""
    dev = resolve_device(device)
    if isinstance(checkpoint, Mapping):
        with torch.device("meta"):
            model = DepthAnythingV2(variant, max_depth, input_size)
        model.load_state_dict({k: v for k, v in checkpoint.items()
                               if k not in UNUSED_CHECKPOINT_KEYS}, assign=True)
        return model.to(device=dev, dtype=dtype, memory_format=torch.channels_last).eval()
    model = DepthAnythingV2(variant, max_depth, input_size)
    if checkpoint and checkpoint.endswith(".npz"):
        from ..utils.convert import dav2_flax_to_torch
        params = dict(np.load(checkpoint, allow_pickle=True))["params"].item()
        model.load_state_dict(dav2_flax_to_torch(params, variant))
    elif checkpoint:
        sd = torch.load(checkpoint, map_location="cpu")
        model.load_state_dict({k: v for k, v in sd.items() if k not in UNUSED_CHECKPOINT_KEYS})
    else:
        init_random_(model)
        print("WARNING: no checkpoint given; using random weights (smoke mode)")
    return model.to(device=dev, dtype=dtype, memory_format=torch.channels_last).eval()


def depth_maps(model: DepthAnythingV2, images: Sequence, sizes: Sequence[Tuple[int, int]],
               batch_size: Optional[int] = None) -> List[torch.Tensor]:
    """One batch of the pseudo-GT path: (H, W, 3) uint8 RGB images on the
    host (numpy arrays or tensors, pinned or not) -> each image's metric
    depth as a float16 host tensor of its (height, width) in `sizes`.

    On the model's device: preprocess_images to the model's input size, the
    forward under inference_mode (padded to `batch_size` images with copies
    of the last where given), then each map back to its image's size by
    antialiased bilinear, as the JAX package's PIL "F"-mode BILINEAR resize,
    cast to float16 and copied to the host. Its spans (utils/trace.py):
    depth.batch around the whole, holding depth.preprocess, depth.encoder
    and depth.head (the model's forward) and depth.resize_out in order."""
    dev = next(model.parameters()).device
    with span("depth.batch"), torch.inference_mode():
        with span("depth.preprocess"):
            batch = preprocess_images(images, model.input_size, dev)
        depth = depth_of_images(model, batch, batch_size or len(batch))
        with span("depth.resize_out"):
            return [F.interpolate(d[None, None], size=(h, w), mode="bilinear",
                                  align_corners=False, antialias=True)[0, 0]
                    .to(torch.float16).cpu() for d, (h, w) in zip(depth, sizes)]


def generate(records: Sequence[Dict], out_dir: str, checkpoint: Optional[str] = None,
             variant: str = "vitl", max_depth: float = 20.0, batch_size: int = 48,
             input_size: int = 518, image_loader=None, device=None,
             model: Optional[DepthAnythingV2] = None) -> None:
    """Write out_dir/{image_id}.npz (float16 `depth`, the image's height x
    width) for every record. `model`, when given, is used as it is (its
    device and dtype); else `load_model(checkpoint, ...)` builds one."""
    os.makedirs(out_dir, exist_ok=True)
    if model is None:
        model = load_model(checkpoint, variant, max_depth, input_size, device)
    load = image_loader or (lambda r: read_image(r["file_name"], record=r))
    t0 = time.time()
    n_done = 0
    for s in range(0, len(records), batch_size):
        chunk = records[s:s + batch_size]
        maps = depth_maps(model, [load(r) for r in chunk],
                          [(r["height"], r["width"]) for r in chunk], batch_size)
        for r, d in zip(chunk, maps):
            np.savez_compressed(os.path.join(out_dir, f"{r['image_id']}.npz"), depth=d.numpy())
            n_done += 1
        if s % (10 * batch_size) == 0:
            dt = time.time() - t0
            print(f"{n_done}/{len(records)} depth maps "
                  f"({n_done / max(dt, 1e-9):.2f} img/s)")
    print(f"done: {n_done} maps in {time.time() - t0:.1f}s")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-file", default="configs/Omni_combined.yaml")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--variant", default="vitl", choices=["vits", "vitb", "vitl"])
    p.add_argument("--max-depth", type=float, default=20.0)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--out", default="datasets/depth_maps")
    p.add_argument("--synthetic", type=int, default=0)
    args = p.parse_args(argv)

    if args.synthetic:
        from . import synthetic
        records = synthetic.make_dataset(args.synthetic)
        loader = lambda r: synthetic.render_image(r["_scene"])  # noqa: E731
    else:
        from ..config import get_cfg
        from . import datasets as ds
        cfg = get_cfg()
        cfg.merge_from_file(args.config_file)
        fs = ds.get_filter_settings_from_cfg(cfg)
        records = []
        for name in list(cfg.DATASETS.TRAIN) + list(cfg.DATASETS.TEST):
            if name not in ds.DATASET_CATALOG:
                ds.simple_register(name, fs)
            records.extend(ds.DATASET_CATALOG[name]())
        loader = None
    generate(records, args.out, args.checkpoint, args.variant, args.max_depth,
             args.batch_size, image_loader=loader)


if __name__ == "__main__":
    main()
