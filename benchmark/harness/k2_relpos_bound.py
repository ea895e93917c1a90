"""The least time of one biased K2 call (the port's flash attention with
SAM's decomposed relative-position bias, ops/flash_attention_cuda.py ->
csrc/flash_attention.cu, flash_fwd_relpos_*), frozen here so that it does
not move when the port changes: the unbiased call's operations and bytes
(harness/k2_bound.py) plus the bias's read, bias_h (B, H, N, kh) and
bias_w (B, H, N, kw) in float32 once each, 4 B H N (kh + kw) bytes. The
bias's additions run on the CUDA cores beside the tensor cores and are not
counted."""
from __future__ import annotations

from .bounds import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S
from .k2_bound import flash_attention_bytes, flash_attention_flops


def rel_pos_bytes(B: int, H: int, N: int, kh: int, kw: int) -> float:
    return 4.0 * B * H * N * (kh + kw)


def flash_attention_relpos_bound_s(B: int, H: int, N: int, d: int, kh: int, kw: int,
                                   elt: int = 2) -> float:
    """max(operations over the bf16 peak, bytes over HBM bandwidth). SAM-HQ
    ViT-L at b8: the windowed call (B 200, H 16, N 196, 14 x 14) reads
    3.21e8 + 7.02e7 bytes, 0.1168 ms; the global call (B 8, H 16, N 4096,
    64 x 64) takes 5.50e11 operations, 0.5559 ms."""
    return max(flash_attention_flops(B, H, N, d) / PEAK_BF16_FLOPS,
               (flash_attention_bytes(B, H, N, d, elt) + rel_pos_bytes(B, H, N, kh, kw))
               / PEAK_BYTES_PER_S)
