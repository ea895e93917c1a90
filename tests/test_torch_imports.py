"""The PyTorch package and chip_smoke.py import nothing of JAX: no jax,
flax, optax or orbax, and nothing of the weakcube_tpu package."""
import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "weakcube_tpu")
SOURCES = sorted(glob.glob(os.path.join(REPO, "weakcube_tpu_torch", "**", "*.py"),
                           recursive=True)) + [os.path.join(REPO, "chip_smoke.py")]


def imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_import_leaves_jax_out():
    code = ("import sys, weakcube_tpu_torch.entry, weakcube_tpu_torch.utils.convert, "
            "weakcube_tpu_torch.ops.roi_align_cuda, weakcube_tpu_torch.ops.flash_attention_cuda, "
            "weakcube_tpu_torch.data.generate_depth_maps, weakcube_tpu_torch.data.datasets, "
            "weakcube_tpu_torch.data.synthetic, weakcube_tpu_torch.solver, "
            "weakcube_tpu_torch.parallel.train_step, weakcube_tpu_torch.parallel.distributed, "
            "weakcube_tpu_torch.parallel.mesh, weakcube_tpu_torch.ops.sampling, "
            "weakcube_tpu_torch.ops.losses, weakcube_tpu_torch.ops.plane, "
            "weakcube_tpu_torch.ops.iou3d, weakcube_tpu_torch.data.mapper, "
            "weakcube_tpu_torch.data.build, weakcube_tpu_torch.data.builtin, "
            "weakcube_tpu_torch.models.priors, weakcube_tpu_torch.utils.util, "
            "weakcube_tpu_torch.utils.events, weakcube_tpu_torch.solver.checkpoint, "
            "weakcube_tpu_torch.tools.train_net, weakcube_tpu_torch.tools.eval_net, "
            "weakcube_tpu_torch.tools.demo, weakcube_tpu_torch.evaluation, "
            "weakcube_tpu_torch.evaluation.omni3d_eval, weakcube_tpu_torch.evaluation._native, "
            "weakcube_tpu_torch.vis, weakcube_tpu_torch.vis.logperf, weakcube_tpu_torch.vis.vis, "
            "weakcube_tpu_torch.data.pseudo_gt, weakcube_tpu_torch.data.pseudo_gt.swin, "
            "weakcube_tpu_torch.data.pseudo_gt.grounding_dino, weakcube_tpu_torch.data.pseudo_gt.sam, "
            "weakcube_tpu_torch.data.generate_ground_segmentations, "
            "weakcube_tpu_torch.data.filter_ground, weakcube_tpu_torch.tools.priors, "
            "weakcube_tpu_torch.models.backbone.resnet, weakcube_tpu_torch.models.backbone.small_nets, "
            "weakcube_tpu_torch.utils.model_zoo, weakcube_tpu_torch.data.kitti_export, "
            "weakcube_tpu_torch.tools.visualise_gt; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]; "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)
