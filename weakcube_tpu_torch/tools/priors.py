#!/usr/bin/env python
"""Per-category dimension priors of the training annotations, printed as a
table and optionally held against a CSV of hand-made typical sizes (the
root priors.py of the JAX package, the reference's priors.py).

  python -m weakcube_tpu_torch.tools.priors --config-file configs/Omni_combined.yaml \\
      [--synthetic N] [--typical-sizes-csv sizes.csv]

A thin CLI over models/priors.py::compute_priors (host-side numpy).
"""
from __future__ import annotations

import argparse
import csv
import os

from ..models.priors import compute_priors


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-file", default="configs/Omni_combined.yaml")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--typical-sizes-csv", default=None,
                   help="optional CSV of hand-made typical sizes to compare")
    args = p.parse_args(argv)

    from ..config import get_cfg
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    cfg.freeze()

    if args.synthetic:
        from ..data import synthetic
        records = synthetic.make_dataset(args.synthetic)
        names = synthetic.CATEGORIES
        num_classes = len(names)
    else:
        from ..data import datasets as ds
        fs = ds.get_filter_settings_from_cfg(cfg)
        records = []
        for name in cfg.DATASETS.TRAIN:
            if name not in ds.DATASET_CATALOG:
                ds.simple_register(name, fs)
            records.extend(ds.DATASET_CATALOG[name]())
        names = list(cfg.DATASETS.CATEGORY_NAMES)
        num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES

    priors = compute_priors(cfg, records, num_classes)
    dims = priors["priors_dims_per_cat"]
    print(f"{'category':20s} {'w_mean':>7s} {'h_mean':>7s} {'l_mean':>7s} "
          f"{'w_std':>6s} {'h_std':>6s} {'l_std':>6s}")
    for c in range(num_classes):
        n = names[c] if c < len(names) else str(c)
        m, s = dims[c, 0], dims[c, 1]
        print(f"{n:20s} {m[0]:7.3f} {m[1]:7.3f} {m[2]:7.3f} "
              f"{s[0]:6.3f} {s[1]:6.3f} {s[2]:6.3f}")

    if args.typical_sizes_csv and os.path.exists(args.typical_sizes_csv):
        with open(args.typical_sizes_csv) as f:
            rows = list(csv.DictReader(f))
        print("\ncomparison vs typical sizes:")
        by_name = {r.get("name", r.get("item", "")).strip().lower(): r for r in rows}
        for c, n in enumerate(names[:num_classes]):
            r = by_name.get(n.lower())
            if r:
                print(f"  {n}: computed {dims[c, 0].round(2)} vs typical {r}")
    return priors


if __name__ == "__main__":
    main()
