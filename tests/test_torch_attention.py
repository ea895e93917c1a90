"""Attention of weakcube_tpu_torch against weakcube_tpu.

The plain PyTorch version (ops/attention.py) is held to the JAX package's
`_fused_sdpa` on the CPU (its einsum path) and to the TPU kernel itself,
JAX's pallas.ops.tpu flash_attention, in interpret mode, on a sequence
padded to a block multiple with segment ids, as the JAX encoder runs it.
The CUDA kernel is held to the plain version on the card only, in
tests/test_torch_cuda.py (marker `cuda`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weakcube_tpu.data.pseudo_gt import depth_anything_v2 as j_dav2
from weakcube_tpu_torch.ops import flash_attention_cuda
from weakcube_tpu_torch.ops.attention import attention

SCALE = 64 ** -0.5


def qkv(rng, B, H, N, d=64):
    return [rng.normal(size=(B, H, N, d)).astype(np.float32) for _ in range(3)]


def projection_views(x, H, d=64):
    """The (B, H, N, d) q, k, v views of a fused qkv projection's (B, N,
    3 H d) output, as the depth encoder passes them to the kernel."""
    B, N, _ = x.shape
    return x.reshape(B, N, 3, H, d).permute(2, 0, 3, 1, 4).unbind(0)


@pytest.mark.parametrize("N", [1, 50, 197])
def test_plain_matches_jax_einsum(N):
    """float32, the same products and softmax; only the order of the float32
    sums differs (atol 1e-5 on outputs of size ~1)."""
    q, k, v = qkv(np.random.default_rng(N), 2, 3, N)
    want = j_dav2._fused_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), SCALE)
    got = attention(*(torch.from_numpy(x) for x in (q, k, v)), SCALE)
    assert got.shape == (2, 3, N, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_real,n_pad", [(200, 256), (50, 128)])
def test_plain_matches_tpu_kernel(monkeypatch, n_real, n_pad):
    """The TPU flash-attention kernel (interpret mode) over a sequence padded
    to a block multiple, with segment ids masking the pad, against the plain
    version on the real tokens alone: float32, online vs one-pass softmax,
    atol 1e-5."""
    from jax.experimental.pallas.ops.tpu import flash_attention as fa
    orig = fa.pl.pallas_call
    monkeypatch.setattr(fa.pl, "pallas_call", lambda *a, **kw: orig(*a, interpret=True, **kw))
    B, H = 1, 2
    q, k, v = qkv(np.random.default_rng(n_real), B, H, n_pad)
    seg = jnp.asarray((np.arange(n_pad) < n_real).astype(np.int32)[None].repeat(B, 0))
    blk = 128
    bs = fa.BlockSizes(block_q=blk, block_k_major=blk, block_k=blk, block_b=1)
    want = fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              segment_ids=fa.SegmentIds(q=seg, kv=seg), causal=False,
                              sm_scale=SCALE, block_sizes=bs)
    got = attention(*(torch.from_numpy(x[:, :, :n_real]) for x in (q, k, v)), SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :, :n_real],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("N", [1, 50, 197])
def test_plain_on_projection_views(N):
    """The plain path on the strided views of a (B, N, 3, H, 64) projection
    gives what it gives on contiguous copies, and agrees with JAX's
    `_fused_sdpa` on the same q, k, v (float32, atol 1e-5)."""
    x = np.random.default_rng(N + 1).normal(size=(2, N, 3 * 3 * 64)).astype(np.float32)
    views = projection_views(torch.from_numpy(x), 3)
    assert not any(t.is_contiguous() for t in views[1:]) or N == 1
    got = attention(*views, SCALE)
    torch.testing.assert_close(got, attention(*(t.contiguous() for t in views), SCALE),
                               atol=1e-6, rtol=1e-6)
    want = j_dav2._fused_sdpa(*(jnp.asarray(t.numpy()) for t in views), SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_bf16_plain_matches_jax_einsum():
    """bfloat16 q, k, v: q scaled in bf16 (0.125 is exact), float32 scores
    and softmax, probabilities rounded to bf16, bf16 product. The two
    frameworks round the last product's float32 sum to bf16 alike, so they
    agree within one bf16 step of the output (2e-2 at |x| < 4)."""
    q, k, v = qkv(np.random.default_rng(7), 2, 2, 50)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(j_dav2._fused_sdpa(jq, jk, jv, SCALE).astype(jnp.float32))
    got = attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), SCALE)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)


def test_wrapper_takes_plain_path_on_cpu():
    """CPU tensors run the plain version (bit-identical) and launch nothing."""
    t = [torch.from_numpy(x) for x in qkv(np.random.default_rng(3), 1, 2, 33)]
    before = flash_attention_cuda.flash_attention.launches
    got = flash_attention_cuda.flash_attention(*t, SCALE)
    assert torch.equal(got, attention(*t, SCALE))
    assert flash_attention_cuda.flash_attention.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((2, 3, 17, 64))
    flash_attention_cuda._check(q, q, q)                                  # accepted
    flash_attention_cuda._check(*(q.bfloat16() for _ in range(3)))        # accepted
    for dt in (torch.float32, torch.bfloat16):                            # accepted
        flash_attention_cuda._check(*projection_views(torch.zeros((2, 17, 3 * 3 * 64), dtype=dt), 3))
        t = torch.zeros((2, 17, 3, 64), dtype=dt).transpose(1, 2)         # head-transposed
        flash_attention_cuda._check(t, t, t)
    with pytest.raises(TypeError):
        flash_attention_cuda._check(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="not \\(B, H, N >= 1, 64\\)"):
        flash_attention_cuda._check(q[..., :32], q[..., :32], q[..., :32])
    with pytest.raises(ValueError, match="not \\(B, H, N >= 1, 64\\)"):
        e = torch.zeros((2, 3, 0, 64))
        flash_attention_cuda._check(e, e, e)
    with pytest.raises(ValueError, match="last dimension .* contiguous"):
        t = torch.zeros((2, 3, 64, 17)).transpose(2, 3)
        flash_attention_cuda._check(t, t, t)
    with pytest.raises(ValueError, match="16-byte aligned"):              # row stride 65
        t = torch.zeros((2, 3, 17, 65))[..., :64]
        flash_attention_cuda._check(t, t, t)
    with pytest.raises(ValueError, match="16-byte aligned"):              # base pointer
        t = torch.zeros(2 * 3 * 17 * 64 + 1)[1:].view(2, 3, 17, 64)
        flash_attention_cuda._check(t, t, t)
    with pytest.raises(ValueError, match="share one device"):
        flash_attention_cuda._check(q, q, torch.zeros((2, 3, 18, 64)))
    with pytest.raises(ValueError, match="share one device"):
        flash_attention_cuda._check(q, q, q.bfloat16())
    with pytest.raises(ValueError, match="B \\* H"):
        big = torch.zeros((2, 40000, 1, 64))
        flash_attention_cuda._check(big, big, big)
    with pytest.raises(ValueError, match="expected all"):
        flash_attention_cuda.flash_attention(q, q, q.to("meta"), SCALE)


def test_strides_of_unit_dimensions():
    """A dimension of size 1 is never stepped over: its stride goes to the
    kernel as 64 elements, whatever the view reports, so that it meets the
    16-byte rule."""
    t = torch.zeros((1, 4, 1, 64)).as_strided((1, 4, 1, 64), (3, 64, 5, 1))
    assert flash_attention_cuda._strides(t) == (64, 64, 64)
    v = projection_views(torch.zeros((2, 5, 3 * 4 * 64)), 4)[2]
    assert flash_attention_cuda._strides(v) == (5 * 3 * 4 * 64, 64, 3 * 4 * 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kh,kw", [(14, 14), (4, 6), (3, 1)])
def test_plain_rel_pos_is_the_explicit_bias_sum(dtype, kh, kw):
    """The plain version with rel_pos = (bias_h, bias_w) equals softmax over
    the scores plus the explicit (N, N) bias bias_h[.., j // kw] +
    bias_w[.., j % kw], written out element by element, in float32 and
    float64 (float64 stays float64); projection views as the SAM encoder
    passes them."""
    rng = np.random.default_rng(kh * 10 + kw)
    B, H, N = 2, 3, kh * kw
    x = torch.from_numpy(rng.normal(size=(B, N, 3 * H * 64))).to(dtype)
    q, k, v = projection_views(x, H)
    bh = torch.from_numpy(rng.normal(size=(B, H, N, kh))).to(dtype)
    bw = torch.from_numpy(rng.normal(size=(B, H, N, kw))).to(dtype)
    got = attention(q, k, v, SCALE, (bh, bw))
    assert got.dtype == dtype and got.shape == (B, H, N, 64)
    j = torch.arange(N)
    bias = bh[..., j // kw] + bw[..., j % kw]                              # (B, H, N, N)
    s = (q * SCALE) @ k.transpose(-1, -2) + bias
    want = torch.softmax(s, -1) @ v
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    assert (got - attention(q, k, v, SCALE)).abs().max() > 1e-2        # the bias counts
    # the wrapper's CPU path is the plain version, bit for bit, and launches nothing
    before = flash_attention_cuda.flash_attention.launches
    assert torch.equal(flash_attention_cuda.flash_attention(q, k, v, SCALE, rel_pos=(bh, bw)),
                       got)
    assert flash_attention_cuda.flash_attention.launches == before


def test_plain_without_rel_pos_keeps_its_bits():
    """Without rel_pos the plain version is the unbiased math, bit for bit:
    q scaled in its own dtype, float32 scores and softmax, the product with
    v in the input dtype."""
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(x).to(dt) for x in qkv(np.random.default_rng(5), 2, 2, 37))
        s = torch.matmul((q * SCALE).float(), k.float().transpose(-1, -2))
        want = torch.matmul(torch.softmax(s, dim=-1).to(dt), v)
        assert torch.equal(attention(q, k, v, SCALE), want)
        assert torch.equal(attention(q, k, v, SCALE, None), want)
