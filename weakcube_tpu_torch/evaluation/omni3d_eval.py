"""Omni3D evaluation: COCO-style AP in 2D (IoU) and 3D (IoU3D)
(weakcube_tpu/evaluation/omni3d_eval.py).

The reference is cubercnn/evaluation/omni3d_evaluation.py, a
re-implementation of COCOeval's evaluate / accumulate without pycocotools:
  * Omni3DParams (:1020-1087): 2D IoU thresholds 0.5:0.05:0.95, 3D IoU3D
    thresholds 0.05:0.05:0.50, depth bands near / medium / far =
    [0,10) / [10,35) / [35,inf) m;
  * greedy per-(image, category) matching with ignore handling
    (evaluateImg, :1434+), with *proximity evaluation* for datasets that are
    not exhaustively annotated (SUN RGB-D): detections farther than 3 m from
    every GT are ignored rather than counted as false positives
    (:1418-1431);
  * accumulate / summarize (:1173-1358, :1554+): the precision envelope over
    101 recall points, AP per category and threshold, AP3D@15/25/50.

Everything is host numpy except IoU3D: ops/iou3d.py::pairwise_iou3d on the
evaluator's device, in float32, once per image over all classes (a pair's
IoU does not depend on its class), in chunks of IOU3D_CHUNK_ROWS
detections. The greedy matcher is native (csrc/eval_match.cpp, built with
g++ at first use); `_match_image_plain` is its numpy version.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.rcnn3d import resolve_device
from ..ops.iou3d import pairwise_iou3d
from . import _native

# detection rows per pairwise_iou3d call: a (rows x G) block of pairs
IOU3D_CHUNK_ROWS = 256


class Omni3DParams:
    def __init__(self, mode: str = "3D"):
        if mode == "2D":
            self.iou_thrs = np.round(np.arange(0.5, 0.96, 0.05), 2)
        else:
            self.iou_thrs = np.round(np.arange(0.05, 0.51, 0.05), 2)
        self.rec_thrs = np.linspace(0.0, 1.00, 101)
        self.max_dets = 100
        # near / medium / far depth bands in metres (omni3d_evaluation.py:1063-1064)
        self.depth_bands = {"all": (0.0, np.inf), "near": (0.0, 10.0),
                            "medium": (10.0, 35.0), "far": (35.0, np.inf)}
        self.proximity_radius = 3.0  # metres, SUN RGB-D proximity evaluation


def _iou2d_matrix(dts: np.ndarray, gts: np.ndarray) -> np.ndarray:
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    lt = np.maximum(dts[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dts[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a1 = np.prod(np.clip(dts[:, 2:] - dts[:, :2], 0, None), -1)
    a2 = np.prod(np.clip(gts[:, 2:] - gts[:, :2], 0, None), -1)
    union = a1[:, None] + a2[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _iou3d_matrix(dt_corners: np.ndarray, gt_corners: np.ndarray,
                  device: torch.device) -> np.ndarray:
    """Exact IoU3D (D, G) float32 of cuboid corners (D, 8, 3) x (G, 8, 3),
    computed on `device` in blocks of IOU3D_CHUNK_ROWS detections."""
    D, G = len(dt_corners), len(gt_corners)
    if D == 0 or G == 0:
        return np.zeros((D, G), np.float32)
    dt = torch.as_tensor(np.asarray(dt_corners, np.float32), device=device)
    gt = torch.as_tensor(np.asarray(gt_corners, np.float32), device=device)
    blocks = [pairwise_iou3d(dt[i:i + IOU3D_CHUNK_ROWS], gt)[1]
              for i in range(0, D, IOU3D_CHUNK_ROWS)]
    return torch.cat(blocks).cpu().numpy()


def _match_image(dt_scores, iou_mat, gt_ignore, iou_thrs, dt_ignore=None):
    """Greedy COCO matching for one (image, category), by the native
    matcher. Returns (dt_matched (T, D) GT index or -1, dt_ig (T, D))."""
    if dt_ignore is None:
        dt_ignore = np.zeros(iou_mat.shape[0], bool)
    return _native.greedy_match(dt_scores, iou_mat, gt_ignore, iou_thrs, dt_ignore)


def _match_image_plain(dt_scores, iou_mat, gt_ignore, iou_thrs, dt_ignore=None):
    """numpy version of _match_image (the JAX package's matcher body)."""
    D, G = iou_mat.shape
    T = len(iou_thrs)
    order = np.argsort(-dt_scores, kind="stable")
    dtm = -np.ones((T, D), np.int64)
    dt_ig = np.zeros((T, D), bool)
    if dt_ignore is None:
        dt_ignore = np.zeros(D, bool)
    # real GTs first (COCO convention)
    g_order = np.argsort(gt_ignore.astype(np.int8), kind="stable")
    for ti, t in enumerate(iou_thrs):
        gt_taken = np.zeros(G, bool)
        for di in order:
            best, best_iou = -1, min(t, 1 - 1e-10)
            for gi in g_order:
                if gt_taken[gi] and not gt_ignore[gi]:
                    continue
                # once matched to a real GT, never move to an ignored one
                if best > -1 and not gt_ignore[best] and gt_ignore[gi]:
                    break
                if iou_mat[di, gi] < best_iou:
                    continue
                best_iou = iou_mat[di, gi]
                best = gi
            if best >= 0:
                gt_taken[best] = True
                dtm[ti, di] = best
                dt_ig[ti, di] = gt_ignore[best]
            else:
                dt_ig[ti, di] = dt_ignore[di]
    return dtm, dt_ig


def evaluate_detections(dt_records: Sequence[Dict], gt_records: Sequence[Dict],
                        num_classes: int, mode: str = "3D",
                        proximity: bool = False,
                        params: Optional[Omni3DParams] = None, device=None) -> Dict:
    """Full AP evaluation.

    dt_records: per-image dicts {image_id, boxes (D, 4), scores (D,),
      classes (D,), [corners3D (D, 8, 3), centers3D (D, 3)]}
    gt_records: per-image dicts {image_id, boxes (G, 4), classes (G,),
      ignore (G,), [corners3D (G, 8, 3), centers3D (G, 3)]}
    mode: '2D' | '3D'.
    proximity: handling of datasets that are not exhaustively annotated
      (SUN RGB-D).
    device: where IoU3D runs in 3D mode (the card unless 'cpu' is given).
    Returns {AP, per_class AP, and in 3D AP15, AP25, AP50,
    AP_near / medium / far}.
    """
    p = params or Omni3DParams(mode)
    T = len(p.iou_thrs)
    R = len(p.rec_thrs)
    gt_by_img = {g["image_id"]: g for g in gt_records}
    dev = resolve_device(device) if mode == "3D" else None

    bands = list(p.depth_bands.items()) if mode == "3D" else [("all", (0.0, np.inf))]
    # accumulation: per (band, class) lists
    acc = {b: {c: {"scores": [], "matched": [], "ignored": [], "n_gt": 0}
               for c in range(num_classes)} for b, _ in bands}

    for dt in dt_records:
        gt = gt_by_img.get(dt["image_id"])
        if gt is None:
            continue
        iou_all = None  # the image's IoU3D over all classes, made on first use
        for c in range(num_classes):
            dsel = np.asarray(dt["classes"]) == c
            gsel = np.asarray(gt["classes"]) == c
            if not dsel.any() and not gsel.any():
                continue
            d_boxes = np.asarray(dt["boxes"])[dsel]
            d_scores = np.asarray(dt["scores"])[dsel]
            g_boxes = np.asarray(gt["boxes"])[gsel]
            # the first len(g_boxes) flags of the image, not those of class
            # c: the JAX package's indexing, kept for parity (ROADMAP.md,
            # Queue C)
            g_ignore = np.asarray(gt.get("ignore", np.zeros(gsel.sum(), bool)))[
                :len(g_boxes)] if gsel.any() else np.zeros(0, bool)
            # keep the top max_dets
            if len(d_scores) > p.max_dets:
                keep = np.argsort(-d_scores)[:p.max_dets]
                d_boxes, d_scores = d_boxes[keep], d_scores[keep]
                dsel_idx = np.nonzero(dsel)[0][keep]
            else:
                dsel_idx = np.nonzero(dsel)[0]

            if mode == "3D":
                if iou_all is None:
                    iou_all = _iou3d_matrix(np.asarray(dt["corners3D"]),
                                            np.asarray(gt["corners3D"]), dev)
                iou = iou_all[dsel_idx][:, gsel]
                d_z = np.asarray(dt["centers3D"])[dsel_idx][:, 2] if len(dsel_idx) else np.zeros(0)
                g_z = np.asarray(gt["centers3D"])[gsel][:, 2] if gsel.any() else np.zeros(0)
            else:
                iou = _iou2d_matrix(d_boxes, g_boxes)
                d_z = np.zeros(len(d_boxes))
                g_z = np.zeros(len(g_boxes))

            dt_prox_ignore = np.zeros(len(d_boxes), bool)
            if proximity and mode == "3D" and len(d_boxes):
                # detections far from every annotation of any class are
                # ignored (omni3d_evaluation.py:1418-1431)
                all_g = np.asarray(gt["centers3D"])
                if len(all_g):
                    d_ctr = np.asarray(dt["centers3D"])[dsel_idx]
                    dist = np.linalg.norm(d_ctr[:, None] - all_g[None], axis=-1)
                    dt_prox_ignore = dist.min(1) > p.proximity_radius
                else:
                    dt_prox_ignore[:] = True

            for band, (lo, hi) in bands:
                g_band_ig = g_ignore | ~((g_z >= lo) & (g_z < hi))
                d_band_ig = dt_prox_ignore | (
                    ~((d_z >= lo) & (d_z < hi)) if mode == "3D" and band != "all"
                    else np.zeros(len(d_boxes), bool))
                dtm, dt_ig = _match_image(d_scores, iou, g_band_ig, p.iou_thrs, d_band_ig)
                a = acc[band][c]
                a["scores"].append(d_scores)
                a["matched"].append(dtm)
                a["ignored"].append(dt_ig)
                a["n_gt"] += int((~g_band_ig).sum())

    def band_ap(band, thr_sel=None):
        aps = []
        per_class = {}
        for c in range(num_classes):
            a = acc[band][c]
            if a["n_gt"] == 0:
                continue
            scores = np.concatenate(a["scores"]) if a["scores"] else np.zeros(0)
            dtm = np.concatenate(a["matched"], 1) if a["matched"] else -np.ones((T, 0), np.int64)
            dt_ig = np.concatenate(a["ignored"], 1) if a["ignored"] else np.zeros((T, 0), bool)
            order = np.argsort(-scores, kind="mergesort")
            dtm, dt_ig = dtm[:, order], dt_ig[:, order]
            tps = (dtm >= 0) & ~dt_ig
            fps = (dtm < 0) & ~dt_ig
            tp_cum = np.cumsum(tps, 1).astype(np.float64)
            fp_cum = np.cumsum(fps, 1).astype(np.float64)
            thr_idx = range(T) if thr_sel is None else thr_sel
            ap_t = []
            for ti in thr_idx:
                rc = tp_cum[ti] / a["n_gt"]
                pr = tp_cum[ti] / np.maximum(tp_cum[ti] + fp_cum[ti], 1e-12)
                # precision envelope
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                inds = np.searchsorted(rc, p.rec_thrs, side="left")
                q = np.zeros(R)
                valid = inds < len(pr)
                q[valid] = pr[inds[valid]]
                ap_t.append(q.mean())
            per_class[c] = float(np.mean(ap_t))
            aps.append(per_class[c])
        return (float(np.mean(aps)) * 100 if aps else float("nan")), \
            {c: v * 100 for c, v in per_class.items()}

    results = {}
    ap, per_class = band_ap("all")
    results["AP"] = ap
    results["per_class"] = per_class
    if mode == "3D":
        thrs = list(p.iou_thrs)
        for t, name in ((0.15, "AP15"), (0.25, "AP25"), (0.50, "AP50")):
            if any(abs(x - t) < 1e-6 for x in thrs):
                ti = int(np.argmin(np.abs(np.asarray(thrs) - t)))
                results[name], _ = band_ap("all", [ti])
        for band in ("near", "medium", "far"):
            results[f"AP_{band}"], _ = band_ap(band)
    return results


class Omni3DEvaluator:
    """Streaming evaluator: add per-image records, then summarize (the
    role of the reference's Omni3DEvaluator). IoU3D runs on `device`, the
    card unless 'cpu' is given."""

    def __init__(self, num_classes: int, proximity: bool = False,
                 class_names: Optional[List[str]] = None, device=None):
        self.num_classes = num_classes
        self.proximity = proximity
        self.class_names = class_names
        self.device = resolve_device(device)
        self.dt: List[Dict] = []
        self.gt: List[Dict] = []
        self._seen = set()

    def add(self, dt_record: Dict, gt_record: Dict) -> bool:
        """Returns True iff the record was accepted: a tail batch repeats its
        last image, and a repeated image_id is dropped."""
        iid = dt_record["image_id"]
        if iid in self._seen:
            return False
        self._seen.add(iid)
        self.dt.append(dt_record)
        self.gt.append(gt_record)
        return True

    def summarize(self) -> Dict:
        out = {}
        res2d = evaluate_detections(self.dt, self.gt, self.num_classes, "2D", self.proximity)
        out["AP2D"] = res2d["AP"]
        out["per_class_2D"] = res2d["per_class"]
        if self.gt and "corners3D" in self.gt[0]:
            res3d = evaluate_detections(self.dt, self.gt, self.num_classes, "3D",
                                        self.proximity, device=self.device)
            out["AP3D"] = res3d["AP"]
            for k in ("AP15", "AP25", "AP50", "AP_near", "AP_medium", "AP_far"):
                if k in res3d:
                    out[f"AP3D@{k[2:]}" if k.startswith(("AP1", "AP2", "AP5")) else k] = res3d[k]
            out["per_class_3D"] = res3d["per_class"]
        return out


class Omni3DEvaluationHelper:
    """Evaluation over several datasets (reference omni3d_evaluation.py:
    168-520): one evaluator per dataset, the predictions saved as JSON, and
    `summarize_all`, the AP over the pooled images of every dataset."""

    def __init__(self, dataset_names: Sequence[str], num_classes: int,
                 output_folder: Optional[str] = None,
                 proximity_datasets: Sequence[str] = ("SUNRGBD",),
                 class_names: Optional[List[str]] = None, device=None):
        self.dataset_names = list(dataset_names)
        self.num_classes = num_classes
        self.output_folder = output_folder
        self.class_names = class_names
        self.device = resolve_device(device)
        self.evaluators: Dict[str, Omni3DEvaluator] = {}
        self.results: Dict[str, Dict] = {}
        for name in self.dataset_names:
            prox = any(p.lower() in name.lower() for p in proximity_datasets)
            self.evaluators[name] = Omni3DEvaluator(num_classes, proximity=prox,
                                                    class_names=class_names, device=self.device)

    def add_predictions(self, dataset: str, dt_record: Dict, gt_record: Dict) -> bool:
        return self.evaluators[dataset].add(dt_record, gt_record)

    def save_predictions(self, dataset: str) -> None:
        if not self.output_folder:
            return
        os.makedirs(self.output_folder, exist_ok=True)
        path = os.path.join(self.output_folder, f"instances_predictions_{dataset}.json")
        with open(path, "w") as f:
            json.dump([{"image_id": int(r["image_id"]),
                        "boxes": np.asarray(r["boxes"]).tolist(),
                        "scores": np.asarray(r["scores"]).tolist(),
                        "classes": np.asarray(r["classes"]).tolist()}
                       for r in self.evaluators[dataset].dt], f)

    def evaluate(self, dataset: str) -> Dict:
        self.results[dataset] = self.evaluators[dataset].summarize()
        return self.results[dataset]

    def summarize_all(self) -> Dict:
        """Evaluate any dataset still pending, then the AP over the union of
        images, each dataset's ids offset by 10^9. The pooled evaluation
        runs without proximity, as the JAX package's does."""
        for name in self.dataset_names:
            if name not in self.results:
                self.evaluate(name)
        pooled_dt, pooled_gt = [], []
        offset = 0
        for name in self.dataset_names:
            ev = self.evaluators[name]
            for d, g in zip(ev.dt, ev.gt):
                pooled_dt.append(dict(d, image_id=d["image_id"] + offset))
                pooled_gt.append(dict(g, image_id=g["image_id"] + offset))
            offset += 10 ** 9
        overall: Dict = {}
        if pooled_dt:
            res2d = evaluate_detections(pooled_dt, pooled_gt, self.num_classes, "2D")
            overall["AP2D"] = res2d["AP"]
            overall["per_class_2D"] = res2d["per_class"]
            if pooled_gt and "corners3D" in pooled_gt[0]:
                res3d = evaluate_detections(pooled_dt, pooled_gt, self.num_classes, "3D",
                                            device=self.device)
                overall["AP3D"] = res3d["AP"]
                overall["per_class_3D"] = res3d["per_class"]
                for k in ("AP15", "AP25", "AP50"):
                    if k in res3d:
                        overall[f"AP3D@{k[2:]}"] = res3d[k]
                for k in ("AP_near", "AP_medium", "AP_far"):
                    if k in res3d:
                        overall[k] = res3d[k]
        return {"per_dataset": self.results, "overall": overall}
