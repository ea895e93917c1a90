"""ASCII AP tables (weakcube_tpu/vis/logperf.py; reference
cubercnn/vis/logperf.py)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence


def _table(headers, rows) -> str:
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows)) if rows else len(str(h))
              for i, h in enumerate(headers)]
    def fmt(cells):
        return "| " + " | ".join(str(c).ljust(w) for c, w in zip(cells, widths)) + " |"
    sep = "|" + "|".join("-" * (w + 2) for w in widths) + "|"
    return "\n".join([fmt(headers), sep] + [fmt(r) for r in rows])


def print_ap_table(results: Dict, num_classes: int,
                   class_names: Optional[Sequence[str]] = None) -> None:
    headers = ["metric", "value"]
    rows = [[k, f"{v:.2f}"] for k, v in sorted(results.items())
            if isinstance(v, (int, float)) and v == v]
    print(_table(headers, rows))
    per_class = results.get("per_class_3D") or results.get("per_class_2D") or {}
    if per_class:
        headers = ["category", "AP"]
        rows = []
        for c, v in sorted(per_class.items()):
            name = class_names[c] if class_names and c < len(class_names) else str(c)
            rows.append([name, f"{v:.2f}"])
        print(_table(headers, rows))


def print_ap_analysis_histogram(results: Dict) -> None:
    """AP3D@15/25/50 and near/medium/far bands (logperf.py analysis table)."""
    keys = ["AP3D", "AP3D@15", "AP3D@25", "AP3D@50",
            "AP_near", "AP_medium", "AP_far"]
    rows = [[k, f"{results[k]:.2f}"] for k in keys if k in results]
    print(_table(["analysis", "AP"], rows))


def _f(v) -> str:
    return f"{v:.2f}" if isinstance(v, (int, float)) and v == v else "-"


def print_ap_category_histogram(dataset: str, results: Dict,
                                class_names: Optional[Sequence[str]] = None,
                                n_cols: int = 3) -> None:
    """Per-category AP2D/AP3D table (reference print_ap_category_histogram,
    logperf.py:9-41), wrapped over n_cols category columns."""
    p2 = results.get("per_class_2D") or {}
    p3 = results.get("per_class_3D") or {}
    cats = sorted(set(p2) | set(p3))
    cells = []
    for c in cats:
        name = class_names[c] if class_names and c < len(class_names) else str(c)
        cells.append([name, _f(p2.get(c)), _f(p3.get(c))])
    rows = []
    for i in range(0, len(cells), n_cols):
        chunk = cells[i:i + n_cols]
        chunk += [["", "", ""]] * (n_cols - len(chunk))
        rows.append(sum(chunk, []))
    print(f"Performance for each of {len(cats)} categories on {dataset}:")
    print(_table(["category", "AP2D", "AP3D"] * n_cols, rows))


def print_ap_dataset_histogram(results_by_dataset: Dict[str, Dict],
                               iters: Optional[int] = None) -> None:
    """Per-dataset AP2D/AP3D rows (reference print_ap_dataset_histogram,
    logperf.py:70-92)."""
    rows = [[name, iters if iters is not None else "-",
             _f(r.get("AP2D")), _f(r.get("AP3D"))]
            for name, r in results_by_dataset.items()]
    print("Per-dataset performance on test set:")
    print(_table(["Dataset", "#iters", "AP2D", "AP3D"], rows))


def print_dataset_analysis_histogram(results_by_dataset: Dict[str, Dict],
                                     iters: Optional[int] = None) -> None:
    """Per-dataset IoU-threshold + near/medium/far analysis (reference
    print_ap_analysis_histogram, logperf.py:44-67)."""
    rows = []
    for name, r in results_by_dataset.items():
        rows.append([name, iters if iters is not None else "-",
                     _f(r.get("AP2D")), _f(r.get("AP3D")),
                     _f(r.get("AP3D@15")), _f(r.get("AP3D@25")),
                     _f(r.get("AP3D@50")), _f(r.get("AP_near")),
                     _f(r.get("AP_medium")), _f(r.get("AP_far"))])
    print("Per-dataset performance analysis on test set:")
    print(_table(["Dataset", "#iters", "AP2D", "AP3D", "AP3D@15", "AP3D@25",
                  "AP3D@50", "AP3D-N", "AP3D-M", "AP3D-F"], rows))


def print_ap_omni_histogram(overall: Dict, iters: Optional[int] = None) -> None:
    """Pooled Omni3D row — the number to compare against other approaches
    (reference print_ap_omni_histogram, logperf.py:95-117)."""
    print("Omni3D performance on test set (compare to other approaches "
          "on Omni3D, such as Cube R-CNN):")
    print(_table(["Dataset", "#iters", "AP2D", "AP3D"],
                 [["Omni3D", iters if iters is not None else "-",
                   _f(overall.get("AP2D")), _f(overall.get("AP3D"))]]))
