"""Batch builders (weakcube_tpu/data/build.py): mapped examples -> dense
padded batches; the training sampler and the test iterator; background
prefetch; and the copy of a batch to the device.

Replaces cubercnn/data/build.py: the training loader with category
repeat-factor sampling (build.py:76-203) and the batched test loader
(build.py:222-259). Everything but `to_device` is host-side numpy.
"""
from __future__ import annotations

import queue
import threading
from collections import Counter
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..structures import GroundTruth
from .mapper import DatasetMapper3D

GT_FIELDS = (("boxes", "gt_boxes"), ("classes", "gt_classes"), ("valid", "gt_valid"),
             ("boxes3D", "gt_boxes3D"), ("poses", "gt_poses"))


def pad_batch(examples: List[Dict]) -> Dict:
    """Stack mapped examples into one dense batch dict of numpy arrays, with
    a GroundTruth of numpy arrays under "gt"."""
    def stack(key):
        return np.stack([e[key] for e in examples])

    batch = {
        "image": stack("image"),
        "image_wh": stack("image_wh"),
        "K": stack("K"),
        "gt": GroundTruth(**{f: stack(k) for f, k in GT_FIELDS}),
    }
    for opt in ("depth_map", "ground_mask", "ground_normal"):
        if opt in examples[0]:
            batch[opt] = stack(opt)
    for opt in ("ground_valid", "ground_normal_valid"):
        if opt in examples[0]:
            batch[opt] = np.asarray([e[opt] for e in examples])
    batch["image_id"] = np.asarray([e["image_id"] for e in examples])
    batch["scale"] = np.asarray([e["scale"] for e in examples], np.float32)
    return batch


def to_device(batch: Dict, device) -> Dict:
    """The model's batch dict (models/rcnn3d.py) on `device`: every array a
    tensor (gt_classes as int64), copied from pinned host memory without
    blocking when the device is a GPU. "image_id" and "scale" stay numpy."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(x, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dtype is not None:
            t = t.to(dtype)
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    out = {k: v for k, v in batch.items() if k in ("image_id", "scale")}
    for k, v in batch.items():
        if k == "gt":
            out[k] = GroundTruth(**{f: put(getattr(v, f), torch.long if f == "classes" else None)
                                    for f, _ in GT_FIELDS})
        elif k not in out:
            out[k] = put(v)
    return out


def repeat_factors_from_category_frequency(records: Sequence[Dict],
                                           repeat_thresh: float) -> np.ndarray:
    """d2 RepeatFactorTrainingSampler factors (build.py:158-203 semantics):
    r(img) = max over its categories of max(1, sqrt(t / f(c)))."""
    freq = Counter()
    n = len(records)
    for r in records:
        cats = {a["category_id"] for a in r.get("annotations", [])
                if not a.get("ignore", False)}
        freq.update(cats)
    cat_rep = {c: max(1.0, np.sqrt(repeat_thresh / (f / n)))
               for c, f in freq.items()}
    out = np.ones(n, np.float64)
    for i, r in enumerate(records):
        cats = {a["category_id"] for a in r.get("annotations", [])
                if not a.get("ignore", False)}
        if cats:
            out[i] = max(cat_rep.get(c, 1.0) for c in cats)
    return out


def _default_image(record: Dict) -> np.ndarray:
    from .datasets import read_image
    return read_image(record["file_name"], record=record)


def _map(mapper, record, loaders, rng=None):
    return mapper(record, rng,
                  image=loaders.get("image", _default_image)(record),
                  depth_map=loaders["depth"](record) if "depth" in loaders else None,
                  ground_map=loaders["ground"](record) if "ground" in loaders else None)


def _rows(n: int, rank: int, world: int) -> slice:
    """Rank `rank`'s rows of a global batch of n."""
    if n % world:
        raise ValueError(f"a global batch of {n} does not divide over {world} ranks")
    return slice(rank * (n // world), (rank + 1) * (n // world))


def build_train_batches(cfg, records: Sequence[Dict],
                        batch_size: Optional[int] = None,
                        seed: int = 0,
                        loaders: Optional[Dict] = None,
                        rank: int = 0, world: int = 1) -> Iterator[Dict]:
    """Infinite iterator of dense train batches (numpy).

    loaders: optional dict of callables {image, depth, ground}(record) ->
    numpy array, so that callers can plug npz pseudo-GT artefacts or
    synthetic renderers in without the mapper knowing the storage format.
    batch_size: the global batch (default SOLVER.IMS_PER_BATCH).
    rank, world: a data-parallel rank's rows of every global batch (below).
    """
    mapper = DatasetMapper3D(cfg, is_train=True)
    rng = np.random.default_rng(seed)
    bs = batch_size or cfg.SOLVER.IMS_PER_BATCH
    loaders = loaders or {}

    if cfg.DATALOADER.SAMPLER_TRAIN == "RepeatFactorTrainingSampler":
        rf = repeat_factors_from_category_frequency(records,
                                                    cfg.DATALOADER.REPEAT_THRESHOLD)
        probs = rf / rf.sum()
    else:
        probs = np.full(len(records), 1.0 / len(records))

    # per-bucket accumulation (d2 AspectRatioGroupedDataset, reference
    # data/build.py:76-155): a batch is emitted when one canvas bucket
    # fills, so every batch has one shape
    if world == 1:
        pools: Dict[tuple, List[Dict]] = {}
        while True:
            idx = rng.choice(len(records), size=bs, p=probs)
            for i in idx:
                ex = _map(mapper, records[i], loaders, rng)
                pool = pools.setdefault(ex["bucket"], [])
                pool.append(ex)
                if len(pool) == bs:
                    yield pad_batch(pool)
                    pools[ex["bucket"]] = []
    # data parallel: every rank runs the same sampler over the records and
    # groups them by the bucket of their size, so all ranks see the same
    # global batches, and maps its own rows alone. The draws of the mapper
    # (scale jitter, flip) cannot then come from the sampler's generator
    # as above: each example draws from one seeded from (seed, its position
    # in the sampled sequence), so a global batch is the same at any W > 1
    rows = _rows(bs, rank, world)
    pools, pos = {}, 0
    while True:
        idx = rng.choice(len(records), size=bs, p=probs)
        for i in idx:
            pool = pools.setdefault(mapper.bucket(records[i])[0], [])
            pool.append((i, pos))
            pos += 1
            if len(pool) == bs:
                yield pad_batch([_map(mapper, records[j], loaders, np.random.default_rng([seed, p]))
                                 for j, p in pool[rows]])
                pool.clear()


def build_test_batches(cfg, records: Sequence[Dict],
                       batch_size: int = 8,
                       loaders: Optional[Dict] = None,
                       rank: int = 0, world: int = 1) -> Iterator[Dict]:
    """Finite iterator over the dataset (the last batch of each bucket padded
    by repetition; consumers dedupe by image_id). With aspect buckets the
    records are grouped by canvas shape, so each batch has one shape.
    rank, world: a data-parallel rank's rows of every global batch of
    batch_size (which must divide over the ranks); every rank yields as
    many batches."""
    mapper = DatasetMapper3D(cfg, is_train=False)
    loaders = loaders or {}
    rows = _rows(batch_size, rank, world)

    def batch(idx):
        return pad_batch([_map(mapper, records[i], loaders) for i in idx[rows]])

    pools: Dict[tuple, List[int]] = {}
    for i, r in enumerate(records):
        pool = pools.setdefault(mapper.bucket(r)[0], [])
        pool.append(i)
        if len(pool) == batch_size:
            yield batch(pool)
            pool.clear()
    for tail in pools.values():  # in the order the buckets first appeared
        if tail:
            yield batch(tail + [tail[-1]] * (batch_size - len(tail)))


class _Raised:
    def __init__(self, error: BaseException):
        self.error = error


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run `iterator` in a background thread, `depth` items ahead, so that
    the host's decoding, augmentation and copies overlap the device's step.
    An exception in the worker is raised again in the consumer: a mapper
    fault stops training instead of ending the data as if it ran out.
    Closing the consumer (or dropping it) stops the worker."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
        except Exception as e:  # handed to the consumer
            put(_Raised(e))
            return
        put(end)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, _Raised):
                raise item.error
            yield item
    finally:
        stop.set()
