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
attention as a CUDA flash-attention kernel (csrc/flash_attention.cu).

Package layout:
  config/     YAML config system (a copy of the JAX package's)
  ops/        box, NMS, rotation, cuboid, pooling, ROIAlign and attention
              ops, losses and samplers; the CUDA wrappers
              (ops/roi_align_cuda.py, ops/flash_attention_cuda.py) and their
              nvcc build (cuda_build.py)
  models/     DLA + FPN backbone, RPN, box and cube heads, meta-archs
  solver/     SGD with detectron2's parameter groups, WarmupMultiStep
  parallel/   the stabilised training step (one device)
  data/       synthetic scenes, the Omni3D dataset layer, the depth
              pseudo-GT model (pseudo_gt/) and CLI
  utils/      flax -> torch parameter conversion
  csrc/       CUDA sources, built with nvcc at first use
"""

__version__ = "0.1.0"
