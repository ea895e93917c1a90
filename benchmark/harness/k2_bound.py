"""The least time of one K2 call (the port's flash attention,
ops/flash_attention_cuda.py -> csrc/flash_attention.cu), frozen here so that
it does not move when the port changes: softmax(q k^T d^-0.5) v over
(B, H, N, d) tensors takes 4 B H N^2 d operations (two products of
2 B H N^2 d each) on the tensor cores, and reads q, k and v once and
writes the output once, 4 B H N d values of `elt` bytes (2 in bf16)."""
from __future__ import annotations

from .bounds import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S


def flash_attention_flops(B: int, H: int, N: int, d: int) -> float:
    return 4.0 * B * H * N * N * d


def flash_attention_bytes(B: int, H: int, N: int, d: int, elt: int = 2) -> float:
    return 4.0 * B * H * N * d * elt


def flash_attention_bound_s(B: int, H: int, N: int, d: int, elt: int = 2) -> float:
    """max(operations over the bf16 peak, bytes over HBM bandwidth): at
    B16 H16 N1370 d64 the operations bound it, 0.1244 ms (the bytes alone
    0.054 ms)."""
    return max(flash_attention_flops(B, H, N, d) / PEAK_BF16_FLOPS,
               flash_attention_bytes(B, H, N, d, elt) / PEAK_BYTES_PER_S)
