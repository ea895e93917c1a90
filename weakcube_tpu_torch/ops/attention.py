"""Plain PyTorch attention: the reference the flash-attention kernel
(csrc/flash_attention.cu, ops/flash_attention_cuda.py) is held to.

The same math as the einsum path of weakcube_tpu's
`data/pseudo_gt/depth_anything_v2.py::_fused_sdpa`: q scaled in its own
dtype, float32 scores, float32 softmax, the probabilities cast back to the
input dtype, then the product with v in that dtype. With SAM's decomposed
relative-position bias (weakcube_tpu's `data/pseudo_gt/sam.py`) the scores
are computed in at least float32 (float64 stays float64) and take
bias_h[..., :, None] + bias_w[..., None, :] as one (N, N) sum, as that
module adds it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              rel_pos: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v over (B, H, N, d) tensors -> (B, H,
    N, d); rel_pos = (bias_h (B, H, N, kh), bias_w (B, H, N, kw)), N = kh *
    kw, gives key j the bias bias_h[..., j // kw] + bias_w[..., j % kw]."""
    if rel_pos is None:
        s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
        return torch.matmul(torch.softmax(s, dim=-1).to(q.dtype), v)
    dt = torch.promote_types(q.dtype, torch.float32)
    bias_h, bias_w = (b.to(dt) for b in rel_pos)
    s = torch.matmul((q * scale).to(dt), k.to(dt).transpose(-1, -2))
    s = s + (bias_h[..., :, None] + bias_w[..., None, :]).reshape(s.shape)
    return torch.matmul(torch.softmax(s, dim=-1).to(q.dtype), v)
