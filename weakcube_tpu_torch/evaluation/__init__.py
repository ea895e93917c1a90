"""Omni3D evaluation (weakcube_tpu/evaluation/)."""
from .omni3d_eval import (Omni3DEvaluationHelper, Omni3DEvaluator, Omni3DParams,  # noqa: F401
                          evaluate_detections)
