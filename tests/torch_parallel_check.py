"""Data-parallel workers of the CPU tests (tests/test_torch_parallel.py,
tests/test_torch_train.py): functions that weakcube_tpu_torch's
parallel/distributed.py::launch runs in spawned gloo processes, one per
rank. They import torch and the port only (`no_jax` checks it in each
rank), take their inputs as arguments or from a file the test wrote, and
return what rank 0 gathered.
"""
import hashlib
import sys

import numpy as np
import torch

from weakcube_tpu_torch.models import roi_heads
from weakcube_tpu_torch.models.layers import BatchNorm2d
from weakcube_tpu_torch.ops import losses, plane, sampling
from weakcube_tpu_torch.parallel import distributed
from weakcube_tpu_torch.parallel.mesh import global_sum, make_mesh, shard_batch
from weakcube_tpu_torch.parallel.train_step import sum_gradients

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "weakcube_tpu")


def no_jax() -> list:
    return [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]


def ops(x: dict) -> list:
    """One rank's share of every op the global batch reduces over, on its
    rows of the global inputs `x` (float64): the synced BatchNorm (output,
    input and parameter gradients, pending statistics), global_sum (value
    and gradient), masked_mean and pose_alignment_loss (values and
    gradients), and the Gumbel and RANSAC draws. Returns every rank's
    results on rank 0."""
    mesh = make_mesh()
    rows = shard_batch({k: torch.from_numpy(v) for k, v in x.items() if k != "seed"}, mesh)
    out = {"rank": mesh.rank, "world": mesh.world, "imported": no_jax()}

    bn = BatchNorm2d(x["bn_x"].shape[1]).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(x["bn_w"]))
        bn.bias.copy_(torch.from_numpy(x["bn_b"]))
    inp = rows["bn_x"].clone().requires_grad_(True)
    y = bn(inp)
    (y * rows["bn_g"]).sum().backward()
    sum_gradients([bn.weight.grad, bn.bias.grad])
    out["bn"] = dict(y=y.detach(), dx=inp.grad, dw=bn.weight.grad, db=bn.bias.grad,
                     pending=bn.pending)

    v = rows["sum_x"].clone().requires_grad_(True)
    s = global_sum(v)
    (s * rows["sum_c"]).sum().backward()
    out["global_sum"] = dict(value=s.detach(), grad=v.grad)

    v = rows["mm_x"].clone().requires_grad_(True)
    mm = losses.masked_mean(v, rows["mm_mask"])
    mm.backward()
    out["masked_mean"] = dict(value=mm.detach(), grad=v.grad)

    pose = rows["pose"].clone().requires_grad_(True)
    pl, has = roi_heads.pose_alignment_loss(pose, rows["pose_fg"])
    (pl / mesh.world).backward()  # each rank holds the whole value: a share of it
    out["pose_alignment"] = dict(value=pl.detach(), has=has, grad=pose.grad)

    out["supervised_head"] = supervised_head(rows)

    gen = torch.Generator().manual_seed(x["seed"])
    out["gumbel"] = sampling.gumbel(rows["gumbel_shape"].shape, gen)
    eq, inliers = plane.ransac_plane(rows["pts"], None, 0.05, 64, gen)
    out["ransac"] = dict(eq=eq, inliers=inliers)
    return distributed.gather_objects(out)


def train_steps(path: str) -> dict:
    """One rank's float64 training steps (tests/test_torch_train.py): the
    model of the file's config on its state dict, with float64 parameters;
    the global batch tiny_batch(B, size, size) with the file's anchor
    labels, cut to this rank's rows; per step the file's RoIs (this rank's
    rows) in place of the sampler. Rank 0 writes, to the file's "out", per
    step the logs, the TrainState and the state dict after the update, and
    returns whether every rank holds the same parameters and statistics
    after each step, and what the ranks imported."""
    from weakcube_tpu_torch.entry import dims_priors, tiny_batch
    from weakcube_tpu_torch.models.rcnn3d import build_model
    from weakcube_tpu_torch.models.rpn import RPNLabels
    from weakcube_tpu_torch.parallel.train_step import create_train_state, train_step
    from weakcube_tpu_torch.structures import SampledRois
    d = torch.load(path, weights_only=False)
    cfg, B, size = d["cfg"], d["B"], d["size"]
    model = build_model(cfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), device="cpu",
                        dtype=torch.float64)
    model.load_state_dict(d["state_dict"])
    model.double()
    state, opt = create_train_state(cfg, model)
    mesh = make_mesh()
    batch = shard_batch(dict(tiny_batch(B, size, size, device="cpu"),
                             rpn_labels=RPNLabels(*map(torch.from_numpy, d["rpn_labels"]))), mesh)
    sample, steps, same = roi_heads.label_and_sample_proposals, [], []
    try:
        for r in d["rois"]:
            boxes, classes, gt_idx, fg, valid = map(torch.from_numpy, r)
            rois = shard_batch(SampledRois(boxes, classes.long(), gt_idx.long(), fg, valid), mesh)
            roi_heads.label_and_sample_proposals = lambda *a, **k: rois
            state, logs = train_step(model, opt, state, batch,
                                     torch.Generator().manual_seed(state.step))
            sd = {k: v.clone() for k, v in model.state_dict().items()}
            steps.append(dict(logs=logs, state=state, state_dict=sd))
            # every tensor's bits, folded: equal on every rank iff the
            # replicas hold the same values (up to a hash collision)
            prints = distributed.gather_objects(
                [hashlib.sha1(v.numpy().tobytes()).hexdigest() for v in sd.values()])
            same.append(prints is None or all(p == prints[0] for p in prints))
    finally:
        roi_heads.label_and_sample_proposals = sample
    imported = distributed.gather_objects(no_jax())
    if mesh.rank == 0:
        torch.save(steps, d["out"])
    return dict(replicas_equal=same, imported=imported, world=mesh.world)


def supervised_head(rows: dict) -> dict:
    """ROIHeads3D.forward_train (3 classes, FC 16, float64, weights from a
    seed) on the head_* rows: FPN features at 64 px, GT with 3D boxes and
    rotations, the injected RoIs (2 fg slots of 8), K and image sizes.
    Returns its losses and metrics (this rank's shares), the gradients of
    their sum with respect to the head's parameters (summed over the ranks)
    and to the features (this rank's rows)."""
    from weakcube_tpu_torch.config import get_cfg
    from weakcube_tpu_torch.models.rcnn3d import init_weights
    from weakcube_tpu_torch.ops.rotations import rotation_6d_to_matrix
    from weakcube_tpu_torch.structures import GroundTruth, Proposals, SampledRois
    cfg = get_cfg()
    cfg.MODEL.ROI_HEADS.NUM_CLASSES, cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 3, 8
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = cfg.MODEL.ROI_CUBE_HEAD.FC_DIM = 16
    cfg.freeze()
    head = roi_heads.ROIHeads3D(cfg, 3, 4, np.tile([[[0.8, 0.7, 0.9], [0.3, 0.3, 0.3]]], (3, 1, 1)))
    init_weights(head, torch.Generator().manual_seed(0))
    head.double()
    feats = {f"p{i}": rows[f"head_p{i}"].clone().requires_grad_(True) for i in range(2, 7)}
    gt = GroundTruth(rows["head_gt_boxes"], rows["head_gt_classes"], rows["head_gt_valid"],
                     rows["head_boxes3D"], rotation_6d_to_matrix(rows["head_gt_6d"]))
    rois = SampledRois(rows["head_roi_boxes"], rows["head_roi_classes"], rows["head_gt_idx"],
                       rows["head_fg"], rows["head_valid"])
    n = rois.boxes.shape[0]
    sample = roi_heads.label_and_sample_proposals
    roi_heads.label_and_sample_proposals = lambda *a, **k: rois
    try:
        losses, metrics = head.forward_train(
            feats, Proposals(torch.zeros((n, 1, 4)), torch.zeros((n, 1)),
                             torch.zeros((n, 1), dtype=torch.bool)),
            gt, rows["head_K"], rows["head_wh"], torch.Generator(), metrics_tick=True)
    finally:
        roi_heads.label_and_sample_proposals = sample
    sum(losses.values()).backward()
    sum_gradients([p.grad for p in head.parameters()])
    return dict(losses={k: v.detach() for k, v in losses.items()}, metrics=metrics,
                grads={k: p.grad for k, p in head.named_parameters()},
                feat_grads={k: f.grad for k, f in feats.items()})


def draws_of_one_process(x: dict) -> dict:
    """The draws `ops` makes, by one process on the global batch."""
    gen = torch.Generator().manual_seed(x["seed"])
    g = sampling.gumbel(x["gumbel_shape"].shape, gen)
    eq, inliers = plane.ransac_plane(torch.from_numpy(x["pts"]), None, 0.05, 64, gen)
    return {"gumbel": g, "ransac": dict(eq=eq, inliers=inliers)}


def global_inputs(seed: int, world: int) -> dict:
    """Float64 global inputs of `ops`, 2 rows per rank, from a numpy seed."""
    rng = np.random.default_rng(seed)
    n = 2 * world
    fg = rng.random((n, 6)) < 0.6
    fg[0] = False  # an image without a pair
    return {
        "bn_x": rng.normal(3.0, 2.0, (n, 4, 5, 6)), "bn_g": rng.normal(size=(n, 4, 5, 6)),
        "bn_w": rng.normal(1.0, 0.2, 4), "bn_b": rng.normal(size=4),
        "sum_x": rng.normal(size=(world, 3)), "sum_c": rng.normal(size=(world, 3)),
        "mm_x": rng.normal(size=(n, 7)), "mm_mask": rng.random((n, 7)) < 0.5,
        "pose": rng.normal(size=(n, 6, 3, 3)), "pose_fg": fg,
        "gumbel_shape": np.zeros((n, 33)), "seed": seed,
        "pts": np.concatenate([rng.normal(size=(n, 40, 2)),
                               0.01 * rng.normal(size=(n, 40, 1))], -1),
        **head_inputs(rng, n),
    }


def head_inputs(rng, n: int, G: int = 3, S: int = 8) -> dict:
    """supervised_head's global inputs: n images at 64 px."""
    out = {f"head_p{i}": rng.normal(size=(n, 64 >> i, 64 >> i, 4)) for i in range(2, 7)}
    xy = rng.uniform(2, 40, (n, G, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 20, (n, G, 2))], -1)
    z = rng.uniform(2, 8, (n, G))
    ctr = (boxes[..., :2] + boxes[..., 2:]) / 2
    out.update(
        head_gt_boxes=boxes, head_gt_classes=rng.integers(0, 3, (n, G)),
        head_gt_valid=np.arange(G)[None].repeat(n, 0) < 2 + (np.arange(n)[:, None] % 2),
        head_boxes3D=np.concatenate([ctr, z[..., None], rng.uniform(0.3, 1.5, (n, G, 3)),
                                     (ctr - 32) * z[..., None] / 60.0, z[..., None]], -1),
        head_gt_6d=rng.normal(size=(n, G, 6)),
        head_K=np.tile(np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]]), (n, 1, 1)),
        head_wh=np.full((n, 2), 64.0))
    gt_idx = rng.integers(0, 2, (n, S))
    fg = np.arange(S)[None].repeat(n, 0) < 2
    fg[0, 1] = False
    rxy = rng.uniform(0, 40, (n, S, 2))
    out.update(head_roi_boxes=np.concatenate([rxy, rxy + rng.uniform(4, 20, (n, S, 2))], -1),
               head_roi_classes=np.where(fg, out["head_gt_classes"][np.arange(n)[:, None],
                                                                    gt_idx], 3),
               head_gt_idx=gt_idx, head_fg=fg, head_valid=np.ones((n, S), bool))
    return out


class NoTensorboard:
    """Stands in for the CLI's TensorBoard writer, whose import of
    TensorFlow takes longer than these runs."""

    def __init__(self, log_dir):
        pass

    def write(self, storage):
        pass

    def close(self):
        pass


def cli_runs(runs: list) -> list:
    """Each (tool, argv) of `runs` in turn, in this rank: tools/train_net.py's
    main ("train") or tools/eval_net.py's ("eval"), which run as one rank of
    the initialised group (what their own launch runs in each process),
    with the TensorBoard writer stubbed. Returns their results and, last,
    the iterations at which each rank drew the training JPEGs (on rank 0)."""
    from weakcube_tpu_torch.tools import eval_net, train_net
    from weakcube_tpu_torch.utils import events
    events.TensorboardWriter = NoTensorboard
    vis, drew = train_net._dump_train_vis, []

    def spy(cfg, batch, it, model):
        drew.append(it)
        return vis(cfg, batch, it, model)
    train_net._dump_train_vis = spy
    try:
        out = [{"train": train_net.main, "eval": eval_net.main}[tool](argv)
               for tool, argv in runs]
    finally:
        train_net._dump_train_vis = vis
    return [*out, distributed.gather_objects(drew)]


def ops_then_cli(x: dict, runs: list) -> tuple:
    """`ops(x)`, then `cli_runs(runs)`, in one pair of ranks (one spawn),
    each rank on one thread (the shapes are small, and test workers run
    side by side)."""
    torch.set_num_threads(1)
    return ops(x), cli_runs(runs)
