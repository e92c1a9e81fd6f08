"""The port's attention against irw_tpu's fused_attention (Pallas interpret
mode on the CPU) and flax's dot_product_attention.

Tolerances: 1e-5 in f32 (same math, another summation order).  In bf16
both sides round the normalised probabilities and the output to bf16, so
they may land one bf16 ulp apart: 2^-7 relative to the output's scale.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen.attention import dot_product_attention as flax_attention

from irw_tpu.ops.vmem_attention import fused_attention as jax_fused_attention
from irw_tpu_torch.ops.attention import (
    attention_plain,
    dot_product_attention,
    fused_attention,
    vmem_attention_fn,
)

F32_TOL = 1e-5


def _qkv(shape, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 50, 2, 32), (3, 17, 3, 16), (2, 2, 5, 1, 8)])
def test_plain_matches_pallas_f32(shape):
    q, k, v = _qkv(shape)
    ours = attention_plain(*(torch.from_numpy(t) for t in (q, k, v))).numpy()
    ref = np.asarray(jax_fused_attention(*(jnp.asarray(t) for t in (q, k, v)), interpret=True))
    np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=F32_TOL)


def test_plain_matches_pallas_bf16():
    q, k, v = _qkv((3, 50, 2, 64), seed=1)
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    ours = attention_plain(tq, tk, tv)
    assert ours.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (tq, tk, tv))
    ref = np.asarray(jax_fused_attention(jq, jk, jv, interpret=True), np.float32)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=scale * 2 ** -7, rtol=0)


def test_explicit_scale():
    q, k, v = _qkv((2, 9, 2, 8), seed=2)
    ours = attention_plain(*(torch.from_numpy(t) for t in (q, k, v)), scale=0.3).numpy()
    ref = np.asarray(jax_fused_attention(*(jnp.asarray(t) for t in (q, k, v)),
                                         scale=0.3, interpret=True))
    np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=F32_TOL)


def test_fused_attention_raises_when_a_gradient_is_needed():
    q, k, v = (torch.from_numpy(t).requires_grad_() for t in _qkv((1, 4, 1, 8)))
    with pytest.raises(RuntimeError, match="A6/B2"):
        fused_attention(q, k, v)
    with torch.no_grad():
        fused_attention(q, k, v)  # no gradient needed: fine


def test_dot_product_attention_matches_flax_with_bias_and_mask():
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(2, 7, 2, 8).astype(np.float32) for _ in range(3))
    bias = rng.randn(2, 2, 7, 7).astype(np.float32)
    mask = rng.rand(2, 2, 7, 7) > 0.3
    mask[..., 0] = True
    ours = dot_product_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                                 bias=torch.from_numpy(bias), mask=torch.from_numpy(mask))
    ref = flax_attention(*(jnp.asarray(t) for t in (q, k, v)), bias=jnp.asarray(bias),
                         mask=jnp.asarray(mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=F32_TOL, rtol=F32_TOL)


def test_vmem_attention_fn_routing_rule():
    """bias, mask, active dropout or q.shape != k.shape take the plain flax
    attention (vmem_attention.py:338-343); plain self-attention the kernel."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(2, 6, 2, 8).astype(np.float32)) for _ in range(3))
    kv_long = torch.from_numpy(rng.randn(2, 9, 2, 8).astype(np.float32))
    mask = torch.ones(2, 2, 6, 6, dtype=torch.bool)
    bias = torch.zeros(2, 2, 6, 6)
    torch.testing.assert_close(vmem_attention_fn(q, k, v), fused_attention(q, k, v))
    torch.testing.assert_close(vmem_attention_fn(q, k, v, mask=mask),
                               dot_product_attention(q, k, v, mask=mask))
    torch.testing.assert_close(vmem_attention_fn(q, k, v, bias=bias),
                               dot_product_attention(q, k, v, bias=bias))
    torch.testing.assert_close(vmem_attention_fn(q, kv_long, kv_long),
                               dot_product_attention(q, kv_long, kv_long))
    drop = vmem_attention_fn(q, k, v, dropout_rate=0.5, deterministic=False,
                             generator=torch.Generator().manual_seed(0))
    ref = dot_product_attention(q, k, v, dropout_rate=0.5, deterministic=False,
                                generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(drop, ref)
    # inactive dropout stays on the kernel path
    torch.testing.assert_close(vmem_attention_fn(q, k, v, dropout_rate=0.5),
                               fused_attention(q, k, v))


def test_default_scale_is_inverse_sqrt_head_dim():
    q, k, v = (torch.from_numpy(t) for t in _qkv((1, 5, 1, 16), seed=6))
    torch.testing.assert_close(attention_plain(q, k, v),
                               attention_plain(q, k, v, scale=1 / math.sqrt(16)))
