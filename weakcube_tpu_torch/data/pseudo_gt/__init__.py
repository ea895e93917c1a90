"""Foundation models that make pseudo ground truth (weakcube_tpu/data/pseudo_gt):
Depth Anything V2 (metric depth), GroundingDINO (text-prompted ground boxes)
and SAM-HQ (box-prompted masks)."""
from .depth_anything_v2 import DepthAnythingV2  # noqa: F401
from .grounding_dino import GroundingDINO  # noqa: F401
from .sam import Sam  # noqa: F401
from .swin import SwinT  # noqa: F401
