"""Plain PyTorch attention: the reference the flash-attention kernel
(csrc/flash_attention.cu, ops/flash_attention_cuda.py) is held to.

The same math as the einsum path of weakcube_tpu's
`data/pseudo_gt/depth_anything_v2.py::_fused_sdpa`: q scaled in its own
dtype, float32 scores, float32 softmax, the probabilities cast back to the
input dtype, then the product with v in that dtype.
"""
from __future__ import annotations

import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, H, N, d) tensors -> (B, H, N, d)."""
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    return torch.matmul(torch.softmax(s, dim=-1).to(q.dtype), v)
