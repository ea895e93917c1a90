"""Omni3D dataset layer: COCO-style JSON loading, filtering, registration
(a copy of weakcube_tpu/data/datasets.py).

  * is_ignore and the 2D-box source priority of the reference's datasets.py;
  * load_omni3d_json, incl. attaching depth_image_path / ground_image_path
    when the npz artefacts exist;
  * simple_register / DATASET_CATALOG;
  * Omni3D (multi-json concat + filtering) and
    register_and_store_model_metadata (category_meta.json);
  * read_image (synthetic:// fixtures, else Pillow, imported only for real
    files) and load_npz_map.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

DATASET_CATALOG: Dict[str, Callable[[], List[Dict]]] = {}
METADATA_CATALOG: Dict[str, Dict] = {}


def get_filter_settings_from_cfg(cfg=None) -> Dict:
    """Mirror of the reference's data.get_filter_settings_from_cfg."""
    if cfg is None:
        return {
            "category_names": [], "ignore_names": [], "truncation_thres": 0.99,
            "visibility_thres": 0.01, "min_height_thres": 0.00,
            "max_height_thres": 1.50, "modal_2D_boxes": False,
            "trunc_2D_boxes": True, "max_depth": 1e8,
        }
    return {
        "category_names": list(cfg.DATASETS.CATEGORY_NAMES),
        "ignore_names": list(cfg.DATASETS.IGNORE_NAMES),
        "truncation_thres": cfg.DATASETS.TRUNCATION_THRES,
        "visibility_thres": cfg.DATASETS.VISIBILITY_THRES,
        "min_height_thres": cfg.DATASETS.MIN_HEIGHT_THRES,
        "max_height_thres": 1.50,
        "modal_2D_boxes": cfg.DATASETS.MODAL_2D_BOXES,
        "trunc_2D_boxes": cfg.DATASETS.TRUNC_2D_BOXES,
        "max_depth": cfg.DATASETS.MAX_DEPTH,
    }


def _select_2d_box(anno: Dict, fs: Dict) -> Optional[List[float]]:
    """2D box source priority: tight -> trunc -> proj (XYXY)."""
    if fs.get("modal_2D_boxes") and anno.get("bbox2D_tight", [-1])[0] != -1:
        return list(anno["bbox2D_tight"])
    if fs.get("trunc_2D_boxes") and "bbox2D_trunc" in anno and \
            not all(v == -1 for v in anno["bbox2D_trunc"]):
        return list(anno["bbox2D_trunc"])
    if "bbox2D_proj" in anno:
        return list(anno["bbox2D_proj"])
    if "bbox" in anno:  # XYWH -> XYXY
        x, y, w, h = anno["bbox"]
        return [x, y, x + w, y + h]
    return None


def is_ignore(anno: Dict, filter_settings: Dict, image_height: float) -> bool:
    """Ignore-region rules (datasets.py:83-123)."""
    fs = filter_settings
    ignore = bool(anno.get("behind_camera", False))
    ignore |= not bool(anno.get("valid3D", True))
    if ignore:
        return True
    dims = anno.get("dimensions", [1, 1, 1])
    ignore |= dims[0] <= 0.01 or dims[1] <= 0.01 or dims[2] <= 0.01
    ignore |= anno.get("center_cam", [0, 0, 0])[2] > fs["max_depth"]
    ignore |= anno.get("lidar_pts", -1) == 0
    ignore |= anno.get("segmentation_pts", -1) == 0
    ignore |= anno.get("depth_error", 0.0) > 0.5

    box = _select_2d_box(anno, fs)
    if box is not None:
        h = box[3] - box[1]
        ignore |= h <= fs["min_height_thres"] * image_height
        ignore |= h >= fs["max_height_thres"] * image_height

    trunc = anno.get("truncation", -1)
    vis = anno.get("visibility", -1)
    ignore |= (trunc >= 0 and trunc >= fs["truncation_thres"])
    ignore |= (0 <= vis <= fs["visibility_thres"])
    if fs.get("ignore_names"):
        ignore |= anno.get("category_name", "") in fs["ignore_names"]
    return bool(ignore)


def load_omni3d_json(json_file: str, image_root: str, dataset_name: str,
                     filter_settings: Dict, filter_empty: bool = True,
                     artifacts_root: str = "datasets") -> List[Dict]:
    """Omni3D JSON -> list of per-image records in our mapper format."""
    with open(json_file) as f:
        coco = json.load(f)

    cats = {c["id"]: c["name"] for c in coco.get("categories", [])}
    fs = filter_settings
    wanted = set(fs.get("category_names") or cats.values())
    # contiguous id mapping over the *model* category list when registered,
    # else over this json's categories
    model_meta = METADATA_CATALOG.get("omni3d_model")
    if model_meta and "thing_dataset_id_to_contiguous_id" in model_meta:
        id_map = model_meta["thing_dataset_id_to_contiguous_id"]
    else:
        id_map = {cid: i for i, cid in enumerate(sorted(
            cid for cid, name in cats.items() if name in wanted))}

    anns_by_img: Dict[int, List[Dict]] = {}
    for a in coco.get("annotations", []):
        anns_by_img.setdefault(a["image_id"], []).append(a)

    depth_dir = os.path.join(artifacts_root, "depth_maps")
    ground_dir = os.path.join(artifacts_root, "ground_maps")
    no_ground = set()
    ng_csv = os.path.join(artifacts_root, "no_ground_idx.csv")
    if os.path.exists(ng_csv):
        with open(ng_csv) as f:
            for line in f:
                line = line.strip().split(",")[0]
                if line and line.isdigit():
                    no_ground.add(int(line))

    records = []
    for img in coco.get("images", []):
        rec = {
            "file_name": os.path.join(image_root, img.get("file_path", img.get("file_name", ""))),
            "image_id": img["id"],
            "dataset_id": img.get("dataset_id", 0),
            "dataset_name": dataset_name,
            "width": img["width"],
            "height": img["height"],
            "K": img["K"],
        }
        dpath = os.path.join(depth_dir, f"{img['id']}.npz")
        gpath = os.path.join(ground_dir, f"{img['id']}.npz")
        if os.path.exists(dpath):
            rec["depth_image_path"] = dpath
        if os.path.exists(gpath) and img["id"] not in no_ground:
            rec["ground_image_path"] = gpath

        annos = []
        for a in anns_by_img.get(img["id"], []):
            name = cats.get(a["category_id"], a.get("category_name", ""))
            a = dict(a, category_name=name)
            ignore = is_ignore(a, fs, img["height"])
            if name not in wanted and not ignore:
                continue
            box = _select_2d_box(a, fs)
            if box is None:
                continue
            cid = id_map.get(a["category_id"], -1)
            if cid < 0 and not ignore:
                continue
            annos.append({
                "category_id": cid,
                "category_name": name,
                "bbox": box,
                "bbox_mode": "XYXY_ABS",
                "center_cam": a.get("center_cam", [0, 0, 0]),
                "dimensions": a.get("dimensions", [0, 0, 0]),
                "pose": a.get("R_cam", a.get("pose", np.eye(3).tolist())),
                "ignore": ignore,
                "iscrowd": 0,
            })
        rec["annotations"] = annos
        if filter_empty and not any(not a["ignore"] for a in annos):
            continue
        records.append(rec)
    return records


def simple_register(dataset_name: str, filter_settings: Dict,
                    filter_empty: bool = True,
                    datasets_root_path: Optional[str] = None) -> None:
    root = datasets_root_path or os.path.join("datasets", "Omni3D")
    json_path = os.path.join(root, dataset_name + ".json")
    DATASET_CATALOG[dataset_name] = lambda: load_omni3d_json(
        json_path, "datasets", dataset_name, filter_settings, filter_empty)
    METADATA_CATALOG.setdefault(dataset_name, {}).update(
        json_file=json_path, image_root="datasets", evaluator_type="coco")


def register_and_store_model_metadata(datasets, output_dir: str,
                                      filter_settings: Optional[Dict] = None):
    """Fix the model's category universe + contiguous id map and persist it
    (datasets.py:303-336 writes category_meta.json)."""
    names = filter_settings.get("category_names") if filter_settings else None
    if not names:
        names = sorted({c for d in datasets for c in d.get("category_names", [])})
    thing_classes = list(names)
    id_map = {i: i for i in range(len(thing_classes))}
    METADATA_CATALOG.setdefault("omni3d_model", {}).update(
        thing_classes=thing_classes,
        thing_dataset_id_to_contiguous_id=id_map)
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "category_meta.json"), "w") as f:
        json.dump({"thing_classes": thing_classes,
                   "thing_dataset_id_to_contiguous_id": id_map}, f)
    return thing_classes


class Omni3D:
    """Multi-json dataset concat + filtering (datasets.py:141-301)."""

    def __init__(self, dataset_paths: Sequence[str], filter_settings: Dict):
        self.records: List[Dict] = []
        self.categories: Dict[int, str] = {}
        for p in dataset_paths:
            with open(p) as f:
                coco = json.load(f)
            for c in coco.get("categories", []):
                self.categories[c["id"]] = c["name"]
            name = os.path.splitext(os.path.basename(p))[0]
            self.records.extend(load_omni3d_json(
                p, "datasets", name, filter_settings))

    def __len__(self):
        return len(self.records)


def read_image(file_name: str, record: Optional[Dict] = None) -> np.ndarray:
    """RGB uint8 image loader. Supports synthetic:// fixtures."""
    if file_name.startswith("synthetic://"):
        from . import synthetic
        if record is None or "_scene" not in record:
            raise ValueError(f"{file_name} needs its record's '_scene'")
        return synthetic.render_image(record["_scene"])
    from PIL import Image
    with Image.open(file_name) as im:
        return np.asarray(im.convert("RGB"))


def load_npz_map(path: str, key: Optional[str] = None) -> np.ndarray:
    """Load a depth/ground npz artefact (single-array archives)."""
    with np.load(path) as z:
        k = key or list(z.keys())[0]
        return z[k]
