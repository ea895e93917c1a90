"""Dataset statistics and results analysis (the JAX package's root
VisualiseGT.py, after the reference's): per-category annotation counts,
dimension/depth distributions, AP-vs-class plots, and parsing metrics back
out of training logs.

    python -m weakcube_tpu_torch.tools.visualise_gt --synthetic 64   # dataset stats
    python -m weakcube_tpu_torch.tools.visualise_gt --log output/x/log.txt --metric AP3D

Statistics and log parsing need numpy alone; matplotlib is imported inside
the plotting functions (--plots), so the rest runs where it is missing.
"""
from __future__ import annotations

import argparse
import os
import re
from collections import Counter, defaultdict

import numpy as np


def dataset_statistics(records, class_names=None):
    """Per-category counts + dims/z distributions; returns a dict and
    prints a table."""
    counts = Counter()
    dims = defaultdict(list)
    zs = defaultdict(list)
    for r in records:
        for a in r.get("annotations", []):
            if a.get("ignore", False):
                continue
            c = a["category_id"]
            counts[c] += 1
            dims[c].append(a["dimensions"])
            zs[c].append(a["center_cam"][2])
    print(f"{'category':>16s} {'count':>7s} {'z_mean':>7s} "
          f"{'w':>6s} {'h':>6s} {'l':>6s}")
    stats = {}
    for c in sorted(counts):
        d = np.asarray(dims[c])
        z = np.asarray(zs[c])
        name = class_names[c] if class_names and c < len(class_names) else str(c)
        print(f"{name:>16s} {counts[c]:7d} {z.mean():7.2f} "
              f"{d[:, 0].mean():6.2f} {d[:, 1].mean():6.2f} {d[:, 2].mean():6.2f}")
        stats[c] = {"count": counts[c], "z_mean": float(z.mean()),
                    "dims_mean": d.mean(0).tolist()}
    return stats


def search_file_backwards(path: str, pattern: str):
    """Find the last occurrence of a metric in a log file (reference
    VisualiseGT.py:382 `search_file_backwards`)."""
    rx = re.compile(pattern)
    hit = None
    with open(path) as f:
        for line in f:
            m = rx.search(line)
            if m:
                hit = m
    return hit


def parse_metrics_from_log(path: str, metrics=("AP2D", "AP3D")):
    out = {}
    for m in metrics:
        hit = search_file_backwards(path, rf"{re.escape(m)}\s*[|:=]\s*([0-9.]+)")
        if hit:
            out[m] = float(hit.group(1))
    return out


def plot_ap_vs_class(per_class: dict, class_names=None, out_path="ap_vs_class.png"):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plot")
        return
    cats = sorted(per_class)
    vals = [per_class[c] for c in cats]
    names = [class_names[c] if class_names and c < len(class_names) else str(c)
             for c in cats]
    plt.figure(figsize=(max(6, len(cats) * 0.4), 4))
    plt.bar(names, vals)
    plt.ylabel("AP")
    plt.xticks(rotation=90)
    plt.tight_layout()
    plt.savefig(out_path, dpi=120)
    print(f"wrote {out_path}")


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _annos(records):
    for r in records:
        for a in r.get("annotations", []):
            if not a.get("ignore", False):
                yield a


def category_distribution(records, class_names=None,
                          out_path="category_distribution.png"):
    """Annotation-count bar chart per category (reference VisualiseGT.py
    category_distribution :144-178)."""
    plt = _plt()
    counts = Counter(a["category_id"] for a in _annos(records))
    cats = sorted(counts)
    names = [class_names[c] if class_names and c < len(class_names) else str(c)
             for c in cats]
    plt.figure(figsize=(max(6, len(cats) * 0.5), 4))
    plt.bar(names, [counts[c] for c in cats])
    plt.ylabel("# annotations")
    plt.xticks(rotation=90)
    plt.tight_layout()
    plt.savefig(out_path, dpi=120)
    plt.close()
    print(f"wrote {out_path}")
    return counts


def spatial_statistics(records, out_path="2d_histogram.png"):
    """2D histogram of GT 3D centres, camera x vs depth z (reference
    spatial_statistics :180-256)."""
    plt = _plt()
    ctrs = np.asarray([a["center_cam"] for a in _annos(records)], np.float32)
    if not len(ctrs):
        return
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].hist2d(ctrs[:, 0], ctrs[:, 2], bins=40)
    axes[0].set_xlabel("x (m)"); axes[0].set_ylabel("z (m)")
    axes[0].set_title("centre x vs depth")
    axes[1].hist(ctrs[:, 2], bins=40)
    axes[1].set_xlabel("z (m)"); axes[1].set_ylabel("count")
    axes[1].set_title("depth distribution")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    print(f"wrote {out_path}")


def gt_stats(records, class_names=None, out_dir="."):
    """Per-category dims and z histograms (reference gt_stats :540-585:
    center.png + dimensions.png)."""
    plt = _plt()
    dims = defaultdict(list)
    zs = defaultdict(list)
    for a in _annos(records):
        dims[a["category_id"]].append(a["dimensions"])
        zs[a["category_id"]].append(a["center_cam"][2])
    cats = sorted(dims)
    if not cats:
        return
    fig, axes = plt.subplots(len(cats), 2, figsize=(9, 2.2 * len(cats)),
                             squeeze=False)
    for i, c in enumerate(cats):
        name = class_names[c] if class_names and c < len(class_names) else str(c)
        d = np.asarray(dims[c])
        for j, ax_name in enumerate("whl"):
            axes[i][0].hist(d[:, j], bins=25, alpha=0.5, label=ax_name)
        axes[i][0].set_ylabel(name)
        axes[i][0].legend(fontsize=7)
        axes[i][1].hist(np.asarray(zs[c]), bins=25, color="tab:green")
        axes[i][1].set_xlabel("z (m)")
    axes[0][0].set_title("dimensions (m)")
    axes[0][1].set_title("depth (m)")
    fig.tight_layout()
    out = os.path.join(out_dir, "dimensions.png")
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out}")


def vol_over_cat(records, class_names=None, out_path="volume_distribution.png"):
    """Cuboid-volume distribution per category (reference vol_over_cat
    :484-537)."""
    plt = _plt()
    vols = defaultdict(list)
    for a in _annos(records):
        w, h, l = a["dimensions"]
        vols[a["category_id"]].append(w * h * l)
    cats = sorted(vols)
    if not cats:
        return
    names = [class_names[c] if class_names and c < len(class_names) else str(c)
             for c in cats]
    plt.figure(figsize=(max(6, len(cats) * 0.6), 4))
    plt.boxplot([vols[c] for c in cats], tick_labels=names, showfliers=False)
    plt.ylabel("volume (m^3)")
    plt.xticks(rotation=90)
    plt.tight_layout()
    plt.savefig(out_path, dpi=120)
    plt.close()
    print(f"wrote {out_path}")


def ap_vs_annotations(records, per_class_ap, class_names=None,
                      out_path="ap_vs_annotations.png"):
    """Scatter of per-category AP against the category's annotation count
    (reference AP_vs_no_of_classes :258-316)."""
    plt = _plt()
    counts = Counter(a["category_id"] for a in _annos(records))
    cats = sorted(set(counts) & set(per_class_ap))
    if not cats:
        return
    xs = [counts[c] for c in cats]
    ys = [per_class_ap[c] for c in cats]
    plt.figure(figsize=(6, 4))
    plt.scatter(xs, ys)
    for c, x, y in zip(cats, xs, ys):
        name = class_names[c] if class_names and c < len(class_names) else str(c)
        plt.annotate(name, (x, y), fontsize=7)
    plt.xscale("log")
    plt.xlabel("# annotations (log)")
    plt.ylabel("AP")
    plt.tight_layout()
    plt.savefig(out_path, dpi=120)
    plt.close()
    print(f"wrote {out_path}")


def compare_logs(files, metrics=("AP2D", "AP3D"), out_path="ap3d_vs_ap2d.png"):
    """Final-metric comparison across training logs (reference
    AP3D_vs_AP2D :318-379 / parallel_coordinate_plot :749+)."""
    plt = _plt()
    rows = []
    for f in files:
        vals = parse_metrics_from_log(f, metrics)
        if vals:
            rows.append((os.path.basename(os.path.dirname(f)) or f, vals))
    if not rows:
        print("no metrics found in any log")
        return
    plt.figure(figsize=(6, 4))
    for name, vals in rows:
        if "AP2D" in vals and "AP3D" in vals:
            plt.scatter(vals["AP2D"], vals["AP3D"])
            plt.annotate(name, (vals["AP2D"], vals["AP3D"]), fontsize=7)
    plt.xlabel("AP2D")
    plt.ylabel("AP3D")
    plt.tight_layout()
    plt.savefig(out_path, dpi=120)
    plt.close()
    print(f"wrote {out_path}")
    for name, vals in rows:
        print(name, vals)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--config-file", default=None)
    p.add_argument("--log", default=None)
    p.add_argument("--logs", nargs="*", default=None,
                   help="compare final metrics across several run logs")
    p.add_argument("--metric", nargs="*", default=["AP2D", "AP3D"])
    p.add_argument("--plots", action="store_true",
                   help="save analysis PNGs (category distribution, spatial "
                        "stats, dims/z histograms, volumes)")
    p.add_argument("--out-dir", default="output/figures")
    args = p.parse_args(argv)

    if args.logs:
        os.makedirs(args.out_dir, exist_ok=True)
        compare_logs(args.logs, args.metric,
                     out_path=os.path.join(args.out_dir, "ap3d_vs_ap2d.png"))
        return
    if args.log:
        print(parse_metrics_from_log(args.log, args.metric))
        return
    if args.synthetic:
        from ..data import synthetic
        records = synthetic.make_dataset(args.synthetic)
        dataset_statistics(records, synthetic.CATEGORIES)
        if args.plots:
            os.makedirs(args.out_dir, exist_ok=True)
            category_distribution(records, synthetic.CATEGORIES,
                                  os.path.join(args.out_dir,
                                               "category_distribution.png"))
            spatial_statistics(records,
                               os.path.join(args.out_dir, "2d_histogram.png"))
            gt_stats(records, synthetic.CATEGORIES, args.out_dir)
            vol_over_cat(records, synthetic.CATEGORIES,
                         os.path.join(args.out_dir, "volume_distribution.png"))
        return
    if args.config_file:
        from ..config import get_cfg
        from ..data import datasets as ds
        cfg = get_cfg()
        cfg.merge_from_file(args.config_file)
        fs = ds.get_filter_settings_from_cfg(cfg)
        records = []
        for name in cfg.DATASETS.TRAIN:
            if name not in ds.DATASET_CATALOG:
                ds.simple_register(name, fs)
            records.extend(ds.DATASET_CATALOG[name]())
        names = list(cfg.DATASETS.CATEGORY_NAMES)
        dataset_statistics(records, names)
        if args.plots:
            os.makedirs(args.out_dir, exist_ok=True)
            category_distribution(records, names,
                                  os.path.join(args.out_dir,
                                               "category_distribution.png"))
            spatial_statistics(records,
                               os.path.join(args.out_dir, "2d_histogram.png"))
            gt_stats(records, names, args.out_dir)
            vol_over_cat(records, names,
                         os.path.join(args.out_dir, "volume_distribution.png"))
        return
    p.print_help()


if __name__ == "__main__":
    main()
