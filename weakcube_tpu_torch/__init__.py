"""weakcube_tpu_torch — Weak Cube R-CNN in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of the JAX package `weakcube_tpu` (which stays the reference). It keeps
that package's sub-package layout and module names, and its public layouts
(images (B, H, W, 3), NHWC pyramid levels, pooled features (B, R, 7, 7, C)),
so each module's counterpart is easy to find and test. It imports torch,
numpy and yaml, and nothing of JAX.

Ported so far: the inference forward of the flagship model (meta-arch
RCNN3D_combined_features + ROIHeads3DScore on DLA + FPN), with the
multi-level ROIAlignV2 as a CUDA kernel (csrc/roi_align.cu); its weak
training step (parallel/train_step.py), with the ROIAlign feature gradient
as a second CUDA kernel in the same source; and the depth pseudo-GT
generator (Depth Anything V2, data/generate_depth_maps.py), with its
attention as a CUDA flash-attention kernel (csrc/flash_attention.cu); and the
training CLI on a dataset (tools/train_net.py: the data pipeline, the RANSAC
ground plane, the exact IoU3D metric, checkpoints and logs); and evaluation
(tools/eval_net.py: Omni3D AP in 2D and 3D, with a host C++ greedy
matcher, csrc/eval_match.cpp), its AP tables and drawings, and the folder
demo (tools/demo.py).

Package layout:
  config/     YAML config system (a copy of the JAX package's)
  ops/        box, NMS, rotation, cuboid, pooling, ROIAlign and attention
              ops, RANSAC planes, exact IoU3D, losses and samplers; the
              CUDA wrappers
              (ops/roi_align_cuda.py, ops/flash_attention_cuda.py) and the
              nvcc / g++ build of csrc/ (cuda_build.py)
  models/     DLA + FPN backbone, RPN, box and cube heads, meta-archs
  solver/     SGD with detectron2's parameter groups, WarmupMultiStep;
              checkpoints
  parallel/   the stabilised training step (one device)
  data/       synthetic scenes, the Omni3D dataset layer, the mapper and
              batch builders, the depth pseudo-GT model (pseudo_gt/) and CLI
  evaluation/ the Omni3D evaluator and its native matcher's loader
  vis/        AP tables, 2D boxes, cuboid wireframes and top-down views
  tools/      the training and evaluation CLIs, the demo
  utils/      flax -> torch parameter conversion, event writers, helpers
  csrc/       CUDA sources (nvcc) and the matcher's C++ (g++), built at
              first use into build/
"""

__version__ = "0.1.0"
