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
A released detectron2 `.pth` is not loaded yet: its fc1 input columns need
the (C, 7, 7) -> (7, 7, C) permutation (ROADMAP.md, Queue C).

In a data-parallel run rank 0 alone writes, and every rank waits at a
barrier after each save, so that all of them can then load it (OUTPUT_DIR
is shared by the ranks). The ranks hold plain models, not wrapped ones: a
checkpoint of W ranks has one process's keys and loads into one process
and into the eval CLI.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.nn as nn

from ..parallel import distributed
from ..parallel.train_step import TrainState

SUFFIX = ".pt"


def _refuse_foreign(src: str) -> None:
    if src.startswith("cubercnn://") or src.endswith(".pth"):
        raise NotImplementedError(
            f"{src}: loading released detectron2 checkpoints is not ported to PyTorch yet "
            "(their box_head.fc1 and cube_head fc1 columns need the (C, 7, 7) -> (7, 7, C) "
            "permutation; ROADMAP.md, Queue A item 4 and Queue C)")


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


def load_weights_pretrain(path: str, model: nn.Module) -> None:
    """Weights-only warm start (MODEL.WEIGHTS_PRETRAIN): the model's
    parameters and statistics from a checkpoint of this package; no
    optimizer state, no step."""
    _refuse_foreign(path)
    model.load_state_dict(_load(os.path.abspath(path))["model"])


def load_model_weights(src: str, model: nn.Module) -> None:
    """MODEL.WEIGHTS: initialise the model from a named checkpoint of this
    package (the reference's DetectionCheckpointer.resume_or_load(
    cfg.MODEL.WEIGHTS), tools/train_net.py:149-155)."""
    load_weights_pretrain(src, model)
