"""The port's data-parallel layer (weakcube_tpu_torch/parallel/) on the CPU,
over gloo.

  * op level, float64, 2 spawned ranks (tests/torch_parallel_check.py::ops)
    against one process on the concatenated input: the synced BatchNorm
    (output, input and parameter gradients, pending statistics),
    global_sum, masked_mean and pose_alignment_loss (values and
    gradients), the supervised ROI head's training forward (losses,
    metrics, parameter and feature gradients), and the Gumbel and RANSAC
    draws (a rank's draws are the global draw's rows, exactly);
  * the batch iterators at W = 2 and 4: the ranks' rows form one global
    batch of one bucket, the same at every W > 1; the test iterator covers
    every record once after deduplication;
  * the WEAKCUBE_* / torchrun / SLURM environments and TPU.MESH_SHAPE;
  * the CLIs: a 2-rank training run (2 iterations, a checkpoint, --resume)
    in which rank 0 alone writes, its checkpoint loaded by one process, and
    a 2-rank evaluation with the AP of one process.
The whole float64 step over 2 ranks is held to one process and to JAX in
tests/test_torch_train.py. Each launch picks a free port, so test workers
side by side do not meet.
"""
import json
import os

import numpy as np
import pytest
import torch

import torch_parallel_check as pc
from weakcube_tpu_torch.data import build as t_build
from weakcube_tpu_torch.data import synthetic
from weakcube_tpu_torch.entry import dims_priors
from weakcube_tpu_torch.models import roi_heads
from weakcube_tpu_torch.models.layers import BatchNorm2d
from weakcube_tpu_torch.models.rcnn3d import build_model
from weakcube_tpu_torch.ops import losses
from weakcube_tpu_torch.parallel import distributed
from weakcube_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from weakcube_tpu_torch.solver import checkpoint
from weakcube_tpu_torch.structures import GroundTruth
from weakcube_tpu_torch.tools import eval_net, train_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "synthetic_smoke.yaml")
OPTS = ["MODEL.BACKBONE.NAME", "build_dla_from_vision_fpn_backbone", "MODEL.DLA.TYPE", "dla34",
        "TPU.IMAGE_SIZE", "64", "SOLVER.IMS_PER_BATCH", "2", "TEST.IMS_PER_BATCH", "2",
        "TEST.EVAL_PERIOD", "0", "VIS_PERIOD", "0"]
RTOL = 1e-12  # float64 sums taken in another order


def close(got, want, msg):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    err = float((got - want).abs().max())
    assert err <= RTOL * max(float(want.abs().max()), 1e-300), f"{msg}: max |err| {err:.3e}"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every test here on one thread, as the ranks are (torch_parallel_check.
    ops_then_cli): the shapes are small, and test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ ops
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One pair of gloo ranks: the op checks on global_inputs, then the
    CLIs in OUTPUT_DIR `out`: 2 training iterations with a checkpoint at 2
    and the JPEGs of every iteration; --resume to 4 with a periodic
    evaluation at 3 and a checkpoint of that model; the eval CLI on that
    checkpoint (each rank infers 1 row of every global batch of 2)."""
    x, out = pc.global_inputs(seed=4, world=2), tmp_path_factory.mktemp("dp_cli")

    def argv(args, opts=()):
        return ["--config-file", CONFIG, "--synthetic", "4", "--device", "cpu", *args, *OPTS,
                "TPU.MESH_SHAPE", "[2]", "OUTPUT_DIR", str(out), *opts]
    runs = [("train", argv(["--max-iters", "2"], ["SOLVER.CHECKPOINT_PERIOD", "2",
                                                   "VIS_PERIOD", "1"])),
            ("train", argv(["--resume", "--max-iters", "4"], ["SOLVER.CHECKPOINT_PERIOD", "3",
                                                              "TEST.EVAL_PERIOD", "3"])),
            ("eval", argv([], ["MODEL.WEIGHTS", str(out / "model_recent.pt")]))]
    ops, cli = distributed.launch(pc.ops_then_cli, 2, (x, runs), device_type="cpu")
    return x, ops, out, cli


@pytest.fixture(scope="module")
def ops_run(ranks):
    return ranks[:2]


def one_process(x):
    """The same ops by one process on the global inputs."""
    t = {k: torch.from_numpy(v) for k, v in x.items() if k != "seed"}
    bn = BatchNorm2d(x["bn_x"].shape[1]).double().train()
    with torch.no_grad():
        bn.weight.copy_(t["bn_w"])
        bn.bias.copy_(t["bn_b"])
    inp = t["bn_x"].clone().requires_grad_(True)
    y = bn(inp)
    (y * t["bn_g"]).sum().backward()
    out = {"bn": dict(y=y.detach(), dx=inp.grad, dw=bn.weight.grad, db=bn.bias.grad,
                      pending=bn.pending)}
    # rank r's loss is (sum over ranks of x) . c_r: the gradient of the sum
    # of the ranks' losses is the sum of the c_r for every row
    out["global_sum"] = dict(value=t["sum_x"].sum(0, keepdim=True),
                             grad=t["sum_c"].sum(0, keepdim=True))
    v = t["mm_x"].clone().requires_grad_(True)
    mm = losses.masked_mean(v, t["mm_mask"])
    mm.backward()
    out["masked_mean"] = dict(value=mm.detach(), grad=v.grad)
    pose = t["pose"].clone().requires_grad_(True)
    pl, has = roi_heads.pose_alignment_loss(pose, t["pose_fg"])
    pl.backward()
    out["pose_alignment"] = dict(value=pl.detach(), has=has, grad=pose.grad)
    out["supervised_head"] = pc.supervised_head(t)
    return {**out, **pc.draws_of_one_process(x)}


def test_ranks_import_no_jax(ops_run):
    _, ranks = ops_run
    assert [r["rank"] for r in ranks] == [0, 1] and all(r["world"] == 2 for r in ranks)
    assert all(r["imported"] == [] for r in ranks)


@pytest.mark.parametrize("op", ["bn", "global_sum", "masked_mean", "pose_alignment",
                                "supervised_head", "gumbel", "ransac"])
def test_op_over_two_ranks_equals_one_process(ops_run, op):
    """Row-wise values and input gradients are the rank's rows of one
    process's; reduced values (BatchNorm's parameter gradients and pending
    statistics after sum_gradients, pose_alignment_loss) are the whole on
    every rank, and masked_mean's shares sum to it. Draws are equal
    exactly."""
    x, ranks = ops_run
    want = one_process(x)[op]
    mesh = [Mesh(2, r) for r in range(2)]
    if op == "bn":
        for r, got in enumerate(ranks):
            got = got[op]
            for k in ("y", "dx"):
                close(got[k], shard_batch(want[k], mesh[r]), f"bn {k} rank {r}")
            for k in ("dw", "db"):
                close(got[k], want[k], f"bn {k} rank {r}")
            for a, b in zip(got["pending"], want["pending"]):
                close(a, b, f"bn pending rank {r}")
    elif op in ("global_sum", "pose_alignment"):
        for r, got in enumerate(ranks):
            close(got[op]["value"], want["value"], f"{op} rank {r}")
            rows = want["grad"] if op == "global_sum" else shard_batch(want["grad"], mesh[r])
            close(got[op]["grad"], rows, f"{op} grad rank {r}")
        if op == "pose_alignment":
            assert all(bool(g[op]["has"]) == bool(want["has"]) for g in ranks)
    elif op == "masked_mean":
        close(sum(g[op]["value"] for g in ranks), want["value"], op)
        for r, got in enumerate(ranks):
            close(got[op]["grad"], shard_batch(want["grad"], mesh[r]), f"{op} grad rank {r}")
    elif op == "supervised_head":
        # losses and metrics are the ranks' shares; the parameter gradients
        # the whole on every rank (after sum_gradients), the feature
        # gradients each rank's rows
        for kind in ("losses", "metrics"):
            assert all(set(g[op][kind]) == set(want[kind]) for g in ranks)
            for k, v in want[kind].items():
                close(sum(g[op][kind][k] for g in ranks), v, f"{op} {k}")
        for r, got in enumerate(ranks):
            for k, v in want["grads"].items():
                close(got[op]["grads"][k], v, f"{op} d/d {k} rank {r}")
            for k, v in want["feat_grads"].items():
                close(got[op]["feat_grads"][k], shard_batch(v, mesh[r]), f"{op} d/d {k} rank {r}")
    elif op == "gumbel":
        assert torch.equal(torch.cat([g[op] for g in ranks]), want)
    else:
        for k in ("eq", "inliers"):
            assert torch.equal(torch.cat([g[op][k] for g in ranks]), want[k]), k


# -------------------------------------------------------------- helpers
def test_shard_batch_takes_the_rows_of_every_array():
    gt = GroundTruth(*(torch.arange(6 * k).reshape(6, k) for k in (4, 1, 1, 9, 9)))
    batch = {"image": np.arange(12).reshape(6, 2), "gt": gt, "scale": np.float32(2.0)}
    part = shard_batch(batch, Mesh(3, 1))
    np.testing.assert_array_equal(part["image"], [[4, 5], [6, 7]])
    assert isinstance(part["gt"], GroundTruth) and torch.equal(part["gt"].boxes, gt.boxes[2:4])
    assert part["scale"] == 2.0
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(batch, Mesh(4, 0))


def test_one_process_mesh():
    assert make_mesh([-1]) == Mesh(1, 0) == make_mesh([1])
    assert distributed.process_count() == 1 and distributed.is_main_process()
    with pytest.raises(ValueError, match="MESH_SHAPE"):
        make_mesh([2])


@pytest.mark.parametrize("env,local,want", [
    ({}, 4, None),
    ({"WEAKCUBE_COORDINATOR": "host0:8476", "WEAKCUBE_NUM_PROCESSES": "3",
      "WEAKCUBE_PROCESS_ID": "2"}, 4, distributed.Rendezvous("tcp://host0:8476", 12, 8, 4)),
    ({"WEAKCUBE_MULTIHOST": "1", "RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
      "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234"}, 1,
     distributed.Rendezvous("tcp://10.0.0.1:1234", 8, 5, 1)),
    ({"WEAKCUBE_MULTIHOST": "1", "SLURM_PROCID": "3", "SLURM_NTASKS": "4",
      "SLURM_LOCALID": "3", "SLURM_LAUNCH_NODE_IPADDR": "10.0.0.2"}, 1,
     distributed.Rendezvous("tcp://10.0.0.2:29500", 4, 3, 1)),
], ids=["none", "coordinator", "torchrun", "slurm"])
def test_rendezvous_from_env(env, local, want):
    assert distributed.rendezvous_from_env(env, local) == want
    if "LOCAL_RANK" in env or "SLURM_LOCALID" in env:
        assert distributed.local_rank_from_env(env) == int(env.get("LOCAL_RANK",
                                                                   env.get("SLURM_LOCALID")))


@pytest.mark.parametrize("env", [
    {"WEAKCUBE_COORDINATOR": "h:1", "WEAKCUBE_NUM_PROCESSES": "2", "WEAKCUBE_PROCESS_ID": "2"},
    {"WEAKCUBE_MULTIHOST": "1"}])
def test_rendezvous_refuses_a_bad_environment(env):
    with pytest.raises((ValueError, RuntimeError)):
        distributed.rendezvous_from_env(env, 1)


def test_processes_for_mesh_shape():
    assert distributed.processes_for([-1], "cpu") == 1
    assert distributed.processes_for([3], "cpu") == 3
    for bad in ([2, 2], [0]):
        with pytest.raises(ValueError, match="MESH_SHAPE"):
            distributed.processes_for(bad, "cpu")


# ----------------------------------------------------------------- data
def bucket_data():
    """Synthetic scenes, every other one portrait, with two aspect buckets."""
    cfg = train_net.setup(train_net.parse_args(["--config-file", CONFIG, *OPTS]))
    cfg.defrost()
    cfg.TPU.ASPECT_BUCKETS = [[48, 64], [64, 48]]
    cfg.freeze()
    records = synthetic.make_dataset(12, seed=1)
    for r in records[::2]:
        r["width"], r["height"] = r["height"], r["width"]

    def image(r):
        return synthetic.render_image(r["_scene"])[:r["height"], :r["width"]]
    return cfg, records, {"image": image}


def rows_of(cfg, records, loaders, world, n, bs=4):
    its = [t_build.build_train_batches(cfg, records, batch_size=bs, seed=3, loaders=loaders,
                                       rank=r, world=world) for r in range(world)]
    return [[next(it) for it in its] for _ in range(n)]


def test_train_batches_over_ranks():
    """At W = 2 each rank's rows are half of one global batch of one bucket;
    the global batch is the same at W = 4; each row is the mapper's output
    for its record with its own generator, seeded from (seed, position in
    the sampled sequence), the sequence being the sampler's draws grouped
    by bucket."""
    cfg, records, loaders = bucket_data()
    two, four = (rows_of(cfg, records, loaders, w, 4) for w in (2, 4))
    mapper = t_build.DatasetMapper3D(cfg, is_train=True)
    probs = t_build.repeat_factors_from_category_frequency(records,
                                                           cfg.DATALOADER.REPEAT_THRESHOLD) \
        if cfg.DATALOADER.SAMPLER_TRAIN == "RepeatFactorTrainingSampler" \
        else np.ones(len(records))
    rng, pools, pos, want = np.random.default_rng(3), {}, 0, []
    while len(want) < len(two):
        for i in rng.choice(len(records), size=4, p=probs / probs.sum()):
            pool = pools.setdefault(mapper.bucket(records[i])[0], [])
            pool.append((i, pos))
            pos += 1
            if len(pool) == 4:
                want.append(list(pool))
                pool.clear()
    seen = set()
    for parts, parts4, rows in zip(two, four, want):
        assert [p["image"].shape[0] for p in parts] == [2, 2]
        assert parts[0]["image"].shape == parts[1]["image"].shape  # one bucket
        seen.add(parts[0]["image"].shape[1:3])
        for k in ("image", "image_wh", "K", "image_id", "scale"):
            np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]),
                                          np.concatenate([p[k] for p in parts4]), k)
        for j, (i, p) in enumerate(rows):
            ex = mapper(records[i], np.random.default_rng([3, p]), image=loaders["image"](records[i]))
            np.testing.assert_array_equal(parts[j // 2]["image"][j % 2], ex["image"])
            assert parts[j // 2]["image_id"][j % 2] == records[i]["image_id"]
    assert seen == {(48, 64), (64, 48)}  # both buckets met
    with pytest.raises(ValueError, match="does not divide"):
        next(t_build.build_train_batches(cfg, records, batch_size=3, loaders=loaders, rank=0,
                                         world=2))


def test_test_batches_cover_every_record_once():
    cfg, records, loaders = bucket_data()
    per_rank = [list(t_build.build_test_batches(cfg, records, batch_size=4, loaders=loaders,
                                                rank=r, world=2)) for r in range(2)]
    assert len(per_rank[0]) == len(per_rank[1]) > 0
    ids = []
    for a, b in zip(*per_rank):
        assert a["image"].shape == b["image"].shape and a["image"].shape[0] == 2
        ids += [*a["image_id"], *b["image_id"]]
    assert sorted(set(ids)) == sorted(r["image_id"] for r in records)
    one = [i for b in t_build.build_test_batches(cfg, records, batch_size=4, loaders=loaders)
           for i in b["image_id"]]
    assert ids == one  # the same global batches as one process


# ------------------------------------------------------------------ CLI
@pytest.fixture(scope="module")
def cli_run(ranks):
    return (ranks[2], *ranks[3])


def test_two_rank_training_writes_from_rank_zero(cli_run):
    out, (state, history), (state2, history2), _, vis_calls = cli_run
    assert (state.step, state.applied, state.skipped) == (2, 2, 0)
    assert [h["iteration"] for h in history] == [0, 1]
    assert all(len(h["rank_times"]) == 2 for h in history)
    assert [h["iteration"] for h in history2] == [2, 3] and state2.step == 4
    # one metrics.json line per log point (iterations 2 and 4): one writer
    with open(os.path.join(out, "metrics.json")) as f:
        lines = [json.loads(x) for x in f]
    assert [x["iteration"] for x in lines] == [2, 4]
    assert lines[0]["total_loss"] == history[-1]["logs"]["total_loss"]
    assert sorted(os.listdir(out)) == ["metrics.json", "model_final.pt", "model_recent.pt",
                                       "vis"]
    # VIS_PERIOD 1 in the first run: rank 0 alone drew each iteration's JPEGs
    assert vis_calls == [[1, 2], []]
    assert sorted(os.listdir(os.path.join(out, "vis"))) == [
        f"iter_{i:06d}_{k}.jpg" for i in (1, 2) for k in ("gt", "gt_vs_pred_3d")]


def test_two_rank_checkpoint_loads_in_one_process(cli_run):
    out = cli_run[0]
    cfg = train_net.setup(train_net.parse_args(["--config-file", CONFIG, *OPTS]))
    model = build_model(cfg, dims_priors(cfg.MODEL.ROI_HEADS.NUM_CLASSES), device="cpu")
    ckpt = torch.load(os.path.join(out, "model_final" + checkpoint.SUFFIX), weights_only=True)
    assert set(ckpt["model"]) == set(model.state_dict())  # no wrapper's prefix
    checkpoint.load_model_weights(os.path.join(out, "model_final" + checkpoint.SUFFIX), model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, ckpt["model"][k]), k
    assert ckpt["train_state"]["step"] == 4


def test_two_rank_evaluation_gives_the_one_process_ap(cli_run):
    """The eval CLI over 2 ranks, the resumed run's periodic evaluation
    over 2 ranks (TEST.EVAL_PERIOD 3 of 4 iterations: once, at 3) and the
    eval CLI in one process, on the checkpoint of iteration 3: the same APs
    and every scene counted once."""
    out, history2, two = cli_run[0], cli_run[2][1], cli_run[3]
    periodic = [h["eval"] for h in history2 if "eval" in h]
    assert [h["iteration"] for h in history2 if "eval" in h] == [2]  # after iteration 3
    one = eval_net.main(["--config-file", CONFIG, "--synthetic", "4", "--device", "cpu", *OPTS,
                         "TPU.MESH_SHAPE", "[1]", "OUTPUT_DIR", str(out),
                         "MODEL.WEIGHTS", os.path.join(out, "model_recent.pt")])
    assert torch.load(os.path.join(out, "model_recent.pt"),
                      weights_only=True)["train_state"]["step"] == 3
    assert one["timing"]["processes"] == 1
    for got in (two, *periodic):
        assert got["timing"]["processes"] == 2
        assert got["timing"]["images"] == one["timing"]["images"] == 4
        for k in ("AP2D", "AP3D", "AP3D@15", "AP3D@25", "AP3D@50"):
            assert got[k] == one[k], k


def test_a_batch_that_does_not_divide_raises(tmp_path):
    argv = ["--config-file", CONFIG, "--synthetic", "4", "--device", "cpu", "--max-iters", "1",
            *OPTS, "SOLVER.IMS_PER_BATCH", "3", "TPU.MESH_SHAPE", "[2]", "OUTPUT_DIR",
            str(tmp_path)]
    with pytest.raises(Exception, match="SOLVER.IMS_PER_BATCH 3 does not divide"):
        train_net.main(argv)
