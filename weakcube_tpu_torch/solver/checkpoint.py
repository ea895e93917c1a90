"""Checkpoints (weakcube_tpu/solver/checkpoint.py): one rolling checkpoint,
a final one, and weights-only warm starts.

`PeriodicCheckpointerOnlyOne` keeps `model_recent.pt` (overwritten every
`period` steps) and `model_final.pt` (on finalize), as the reference's
checkpointer of the same name does (cubercnn/solver/checkpoint.py:18-27).
A checkpoint is one `torch.save` of plain containers, loaded with
`weights_only=True`:
  * "model": the model's state_dict, BatchNorm running statistics included;
  * "optimizer": the optimizer's state_dict (momentum buffers, groups) and
    "schedule_count", the position of its learning-rate schedule (the
    schedule itself is rebuilt from the config);
  * "train_state": the TrainState's fields.
MODEL.WEIGHTS and MODEL.WEIGHTS_PRETRAIN also take a released detectron2
`.pth` and a `cubercnn://` name (utils/model_zoo.py), as the JAX package's
load_model_weights does: the port's modules carry detectron2's names, so
the file's tensors load by name, with one change: detectron2 flattens a
pooled RoI as (C, 7, 7) and this package as (7, 7, C), so the input
columns of roi_heads.box_head.fc1 and of every
roi_heads.cube_head.feature_generator*.fc1 are permuted to (7, 7, C) (the
JAX package's zoo_convert does not permute them; ROADMAP.md, Queue C).

In a data-parallel run rank 0 alone writes, and every rank waits at a
barrier after each save, so that all of them can then load it (OUTPUT_DIR
is shared by the ranks). The ranks hold plain models, not wrapped ones: a
checkpoint of W ranks has one process's keys and loads into one process
and into the eval CLI.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import re

import torch
import torch.nn as nn

from ..models.backbone.dla import DLABottomUp
from ..models.backbone.resnet import ResNetBottomUp
from ..parallel import distributed
from ..parallel.train_step import TrainState
from ..utils import model_zoo

SUFFIX = ".pt"
logger = logging.getLogger(__name__)

# the released checkpoints' fc1 layers, whose input is a flattened pooled RoI
_FC1 = re.compile(r"roi_heads\.(box_head|cube_head\.feature_generator\w*)\.fc1\.weight")


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


class PeriodicCheckpointerOnlyOne:
    """Save `model_recent` every `period` steps (overwriting) and
    `model_final` at the end."""

    def __init__(self, output_dir: str, period: int):
        self.output_dir = os.path.abspath(output_dir)
        self.period = max(int(period), 1)
        os.makedirs(self.output_dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.output_dir, name + SUFFIX)

    def save(self, name: str, model: nn.Module, optimizer, state: TrainState) -> None:
        """Write checkpoint `name` (rank 0) and wait until it is written."""
        if distributed.is_main_process():
            ckpt = {"model": model.state_dict(),
                    "optimizer": {**optimizer.state_dict(), "schedule_count": optimizer.count},
                    "train_state": dataclasses.asdict(state)}
            tmp = self.path(name) + ".tmp"
            torch.save(ckpt, tmp)
            os.replace(tmp, self.path(name))  # a reader never sees half a file
        distributed.barrier()

    def step(self, iteration: int, model, optimizer, state: TrainState) -> None:
        if (iteration + 1) % self.period == 0:
            self.save("model_recent", model, optimizer, state)

    def finalize(self, model, optimizer, state: TrainState) -> None:
        self.save("model_final", model, optimizer, state)

    def has_checkpoint(self) -> bool:
        return os.path.exists(self.path("model_recent"))

    def load(self, name: str, model: nn.Module, optimizer) -> TrainState:
        """Restore the model, the optimizer and its schedule in place from
        checkpoint `name`; returns its TrainState."""
        ckpt = _load(self.path(name))
        model.load_state_dict(ckpt["model"])
        opt = dict(ckpt["optimizer"])
        optimizer.count = int(opt.pop("schedule_count"))
        optimizer.load_state_dict(opt)
        return TrainState(**ckpt["train_state"])

    def resume_or_load(self, model, optimizer, state: TrainState,
                       resume: bool = True) -> TrainState:
        """model_recent when resuming and it exists, else `state` as it is."""
        if resume and self.has_checkpoint():
            return self.load("model_recent", model, optimizer)
        return state


def _pooled_chw_to_hwc(w: torch.Tensor, channels: int) -> torch.Tensor:
    """fc1 weight (out, C * r * r) over detectron2's (C, r, r) flatten ->
    the same layer over this package's (r, r, C) flatten."""
    out, n = w.shape
    r = int(round((n // channels) ** 0.5))
    return w.reshape(out, channels, r, r).permute(0, 2, 3, 1).reshape(out, n)


def load_released(path: str, model: nn.Module) -> None:
    """Load a released detectron2 `.pth` (its "model" entry where it has
    one) into model by name, the fc1 columns permuted. Keys the model lacks
    (detectron2's pixel_mean / pixel_std, ...) are dropped and logged; a
    tensor the model has and the file lacks raises, BatchNorm's
    num_batches_tracked (which FrozenBatchNorm checkpoints lack) excepted.
    Only the DLA and ResNet trunks have released checkpoints (ValueError
    for the others, as in the JAX package)."""
    bottom_up = model.backbone.bottom_up
    if not isinstance(bottom_up, (DLABottomUp, ResNetBottomUp)):
        raise ValueError(f"unsupported backbone for zoo conversion: "
                         f"{model.cfg.MODEL.BACKBONE.NAME}")
    obj = _load(path)
    src = obj["model"] if isinstance(obj, dict) and "model" in obj else obj
    own = model.state_dict()
    channels = model.cfg.MODEL.FPN.OUT_CHANNELS
    sd, dropped = {}, []
    for k, v in src.items():
        if k not in own:
            dropped.append(k)
            continue
        v = torch.as_tensor(v)
        sd[k] = _pooled_chw_to_hwc(v, channels) if _FC1.fullmatch(k) else v
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} of the model's tensors: {missing[:8]}")
    if dropped:
        logger.info("%s: dropped %d keys the model lacks: %s", path, len(dropped), dropped)
    model.load_state_dict(sd, strict=False)


def load_weights_pretrain(path: str, model: nn.Module) -> None:
    """Weights-only warm start (MODEL.WEIGHTS_PRETRAIN): the model's
    parameters and statistics from a checkpoint of this package, a released
    detectron2 `.pth` or a `cubercnn://` name; no optimizer state, no
    step."""
    path = model_zoo.resolve(path)
    if path.endswith(".pth"):
        load_released(path, model)
    else:
        model.load_state_dict(_load(os.path.abspath(path))["model"])


def load_model_weights(src: str, model: nn.Module) -> None:
    """MODEL.WEIGHTS: initialise the model from a named checkpoint (the
    reference's DetectionCheckpointer.resume_or_load(cfg.MODEL.WEIGHTS),
    tools/train_net.py:149-155), of any kind load_weights_pretrain takes."""
    load_weights_pretrain(src, model)
