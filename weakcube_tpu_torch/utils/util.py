"""Misc utilities (reference cubercnn/util/util.py; a copy of
weakcube_tpu/utils/util.py): json/pickle IO, ETA accounting, COCO-style
color table with jitter."""
from __future__ import annotations

import json
import pickle
import time
from typing import Any, Iterable, List, Tuple

import numpy as np


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def save_json(path: str, obj: Any) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(path: str, obj: Any) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def imread(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def imwrite(path: str, img: np.ndarray, **save_kwargs) -> None:
    """Save an HWC uint8 image; save_kwargs go to PIL (e.g. quality=90)."""
    from PIL import Image
    Image.fromarray(np.asarray(img, np.uint8)).save(path, **save_kwargs)


class ETA:
    """Rolling ETA over iterations (reference compute_eta, util.py:78-100)."""

    def __init__(self, total: int, window: int = 100):
        self.total = total
        self.window = window
        self.times: List[float] = []
        self.last = time.time()
        self.done = 0

    def tick(self, n: int = 1) -> float:
        now = time.time()
        self.times.append((now - self.last) / max(n, 1))
        self.last = now
        self.done += n
        if len(self.times) > self.window:
            self.times.pop(0)
        rate = float(np.mean(self.times)) if self.times else 0.0
        return rate * max(self.total - self.done, 0)

    def __str__(self) -> str:
        secs = self.tick(0) if self.times else 0
        h, rem = divmod(int(secs), 3600)
        m, s = divmod(rem, 60)
        return f"{h:d}:{m:02d}:{s:02d}"


# 80-entry COCO-ish color table (reference util.py:129-300 carries a fixed
# palette with jitter; we generate a deterministic one)
def color_table(n: int = 80, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    hues = np.linspace(0, 1, n, endpoint=False)
    rng.shuffle(hues)
    import colorsys
    return np.asarray([colorsys.hsv_to_rgb(h, 0.8, 0.95) for h in hues]) * 255


def jitter_color(color: Iterable[float], amount: float = 20.0,
                 seed: int | None = None) -> Tuple[int, int, int]:
    rng = np.random.default_rng(seed)
    c = np.asarray(list(color), float) + rng.uniform(-amount, amount, 3)
    c = np.clip(c, 0, 255)
    return int(c[0]), int(c[1]), int(c[2])
