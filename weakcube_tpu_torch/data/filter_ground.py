#!/usr/bin/env python
"""Prune degenerate ground maps (weakcube_tpu/data/filter_ground.py, the
reference's cubercnn/data/filter_ground.py): a map with fewer than 100
non-zero pixels at stride 5 is removed and its id appended to
no_ground_idx.csv.

  python -m weakcube_tpu_torch.data.filter_ground --ground-dir datasets/ground_maps \\
      --csv datasets/no_ground_idx.csv

Host-side numpy: nothing here runs on the card.
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np


def filter_ground(ground_dir: str = "datasets/ground_maps",
                  csv_path: str = "datasets/no_ground_idx.csv",
                  min_nnz: int = 100, stride: int = 5) -> int:
    """Returns the number of maps removed."""
    removed = []
    for fname in sorted(os.listdir(ground_dir)):
        if not fname.endswith(".npz"):
            continue
        path = os.path.join(ground_dir, fname)
        with np.load(path) as z:
            m = z[list(z.keys())[0]]
        if np.count_nonzero(m[::stride, ::stride]) < min_nnz:
            os.remove(path)
            stem = fname.split(".")[0]
            if stem.isdigit():
                removed.append(int(stem))
    if removed:
        os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
        with open(csv_path, "a") as f:
            w = csv.writer(f)
            for iid in removed:
                w.writerow([iid])
    print(f"removed {len(removed)} degenerate ground maps")
    return len(removed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ground-dir", default="datasets/ground_maps")
    p.add_argument("--csv", default="datasets/no_ground_idx.csv")
    args = p.parse_args(argv)
    return filter_ground(args.ground_dir, args.csv)


if __name__ == "__main__":
    main()
