"""Hard-coded category universes per Omni3D split (cubercnn/data/builtin.py;
a copy of weakcube_tpu/data/builtin.py)."""
from __future__ import annotations


def get_omni3d_categories(dataset: str = "omni3d"):
    """Category sets for each known split (builtin.py:6-45)."""
    if dataset == "omni3d":
        return {
            "chair", "table", "cabinet", "car", "lamp", "books", "sofa",
            "pedestrian", "picture", "window", "pillow", "truck", "door",
            "blinds", "sink", "shelves", "television", "shoes", "cup",
            "bottle", "bookcase", "laptop", "desk", "cereal box", "floor mat",
            "traffic cone", "mirror", "barrier", "counter", "camera", "bicycle",
            "toilet", "bus", "bed", "refrigerator", "trailer", "box", "oven",
            "clothes", "van", "towel", "motorcycle", "night stand", "stove",
            "machine", "stationery", "bathtub", "cyclist", "curtain", "bin"
        }
    if dataset == "omni3d_in":
        return {
            "stationery", "sink", "table", "floor mat", "bottle", "bookcase",
            "blinds", "desk", "sofa", "books", "oven", "bed", "toilet",
            "chair", "mirror", "pillow", "cup", "television", "curtain",
            "refrigerator", "counter", "clothes", "door", "cabinet", "shoes",
            "towel", "night stand", "lamp", "stove", "bin", "box", "laptop",
            "shelves", "machine", "picture", "window", "bathtub"
        }
    if dataset == "omni3d_out":
        return {"cyclist", "pedestrian", "trailer", "bus", "motorcycle",
                "car", "barrier", "truck", "van", "traffic cone", "bicycle"}
    if dataset in ("SUNRGBD", "sunrgbd"):
        return {
            "bicycle", "books", "bottle", "chair", "cup", "laptop", "shoes",
            "towel", "blinds", "window", "lamp", "shelves", "mirror", "sink",
            "cabinet", "bathtub", "door", "toilet", "desk", "box", "bookcase",
            "picture", "table", "counter", "bed", "night stand", "pillow",
            "sofa", "television", "floor mat", "curtain", "clothes",
            "stationery", "refrigerator", "bin", "stove", "oven", "machine"
        }
    if dataset in ("KITTI", "kitti"):
        return {"pedestrian", "car", "cyclist", "van", "truck"}
    raise ValueError(f"Unknown dataset split {dataset}")
