"""Metric logging (a copy of weakcube_tpu/utils/events.py; reference:
detectron2 EventStorage + default_writers + optional W&B mirroring,
tools/train_net.py:140,184,317-320,376-379).

Writers:
  * JSONWriter  — one JSON line per flush into OUTPUT_DIR/metrics.json
    (the d2 metrics.json format VisualiseGT-style tooling parses);
  * TensorboardWriter — tensorboardX/tf event files when available, no-op
    otherwise (keeps the zero-dependency promise);
  * WandbWriter — mirrors scalars when `wandb` is importable and cfg.log.
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional


class EventStorage:
    def __init__(self, start_iter: int = 0):
        self.iter = start_iter
        self._latest: Dict[str, float] = {}
        self._history = defaultdict(list)

    def put_scalar(self, name: str, value: float) -> None:
        v = float(value)
        self._latest[name] = v
        self._history[name].append((self.iter, v))

    def put_scalars(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    def latest(self) -> Dict[str, float]:
        return dict(self._latest, iteration=self.iter)

    def step(self) -> None:
        self.iter += 1


class JSONWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, storage: EventStorage) -> None:
        self._f.write(json.dumps(storage.latest()) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class TensorboardWriter:
    def __init__(self, log_dir: str):
        self._w = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._w = SummaryWriter(log_dir)
        except Exception:
            pass

    def write(self, storage: EventStorage) -> None:
        if self._w is None:
            return
        for k, v in storage.latest().items():
            if k != "iteration":
                self._w.add_scalar(k, v, storage.iter)

    def close(self):
        if self._w is not None:
            self._w.close()


class WandbWriter:
    def __init__(self, project: str = "cube", enabled: bool = True):
        self._run = None
        if not enabled:
            return
        try:
            import wandb
            self._run = wandb.init(project=project, sync_tensorboard=False)
        except Exception:
            pass

    def write(self, storage: EventStorage) -> None:
        if self._run is not None:
            self._run.log(storage.latest(), step=storage.iter)

    def close(self):
        if self._run is not None:
            self._run.finish()


def default_writers(output_dir: str, use_wandb: bool = False) -> List:
    writers = [JSONWriter(os.path.join(output_dir, "metrics.json")),
               TensorboardWriter(os.path.join(output_dir, "tb"))]
    if use_wandb:
        writers.append(WandbWriter())
    return writers
