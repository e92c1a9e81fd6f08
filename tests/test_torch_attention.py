"""The port's attention against irw_tpu's fused_attention (Pallas interpret
mode on the CPU) and flax's dot_product_attention, forward and backward.

Tolerances: 1e-5 in f32 (same math, another summation order).  In bf16
both sides round the normalised probabilities and the output to bf16, so
they may land one bf16 ulp apart: 2^-7 relative to the output's scale.  The
backward rounds P and ds to bf16 at the same points on both sides; another
f32 accumulation order can move a ds element by one bf16 ulp, which dq and
dk carry: 2^-6 of each gradient's max.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen.attention import dot_product_attention as flax_attention

from irw_tpu.ops.vmem_attention import fused_attention as jax_fused_attention
from irw_tpu_torch.ops.attention import (
    attention_plain,
    attention_plain_autograd,
    attention_plain_bwd,
    dot_product_attention,
    fused_attention,
    fused_attention_bwd,
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
    """A gradient of fused_attention is the backward's: on the CPU that is
    attention_plain_bwd, bit for bit; where no kernel exists (a device that
    is neither CPU nor CUDA) asking for one raises instead of falling back."""
    q, k, v = (torch.from_numpy(t).requires_grad_() for t in _qkv((1, 4, 1, 8)))
    g = torch.from_numpy(_qkv((1, 4, 1, 8), seed=9)[0])
    fused_attention(q, k, v).backward(g)
    for leaf, ref in zip((q, k, v), attention_plain_bwd(q.detach(), k.detach(), v.detach(), g)):
        torch.testing.assert_close(leaf.grad, ref, rtol=0, atol=0)
    meta = torch.empty(1, 4, 1, 32, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="no kernel"):
        fused_attention(meta, meta, meta)


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


def _jax_vjp(q, k, v, g, dtype):
    """dq, dk, dv of irw_tpu's fused_attention (its Pallas backward kernel in
    interpret mode) as f32 numpy."""
    jq, jk, jv, jg = (jnp.asarray(t).astype(dtype) for t in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: jax_fused_attention(a, b, c, interpret=True), jq, jk, jv)
    return [np.asarray(t, np.float32) for t in vjp(jg)]


@pytest.mark.parametrize("shape", [(2, 50, 2, 32), (3, 17, 3, 16), (2, 2, 21, 1, 8)])
def test_plain_bwd_matches_pallas_f32(shape):
    q, k, v = _qkv(shape, seed=7)
    g = _qkv(shape, seed=8)[0]
    ours = attention_plain_bwd(*(torch.from_numpy(t) for t in (q, k, v, g)))
    for a, ref in zip(ours, _jax_vjp(q, k, v, g, jnp.float32)):
        np.testing.assert_allclose(a.numpy(), ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("shape", [(3, 50, 2, 64), (2, 33, 2, 32)])
def test_plain_bwd_matches_pallas_bf16(shape):
    q, k, v = _qkv(shape, seed=9)
    g = _qkv(shape, seed=10)[0]
    # round the inputs to bf16 once, so both sides start from the same values
    tq, tk, tv, tg = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v, g))
    ours = attention_plain_bwd(tq, tk, tv, tg)
    refs = _jax_vjp(*(t.float().numpy() for t in (tq, tk, tv, tg)), jnp.bfloat16)
    for a, ref in zip(ours, refs):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), ref, atol=2 ** -6 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_on_cpu_is_the_plain_backward(dtype):
    """On the CPU both autograd routes, the kernel wrapper's and the plain
    one, give attention_plain_bwd's gradients exactly, and the kernel
    wrappers count no launch."""
    q, k, v = (torch.from_numpy(t).to(dtype) for t in _qkv((2, 11, 2, 32), seed=11))
    g = torch.from_numpy(_qkv((2, 11, 2, 32), seed=12)[0]).to(dtype)
    ref = attention_plain_bwd(q, k, v, g, 0.2)
    before = (fused_attention.launches, fused_attention_bwd.launches)
    for fn in (fused_attention, attention_plain_autograd):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, scale=0.2)
        torch.testing.assert_close(out, attention_plain(q, k, v, 0.2), rtol=0, atol=0)
        out.backward(g)
        for leaf, r in zip(leaves, ref):
            torch.testing.assert_close(leaf.grad, r, rtol=0, atol=0)
    assert (fused_attention.launches, fused_attention_bwd.launches) == before


@pytest.mark.parametrize("shape,dtype", [((2, 50, 2, 32), torch.float32),
                                         ((3, 17, 3, 16), torch.float32),
                                         ((2, 33, 2, 32), torch.bfloat16)])
def test_saved_statistics_and_the_backward_fed_them_match_pallas(shape, dtype):
    """When a gradient will be taken, ``_Attention`` saves the row max m and
    sum l of exp(s − m) beside q, k, v (2, B·H, N) and the backward reads
    them.  m and l against the softmax of irw_tpu's ``_bwd_kernel`` (f32
    scores of the same inputs), the gradients against its Pallas backward
    in interpret mode."""
    q, k, v = _qkv(shape, seed=13)
    g = _qkv(shape, seed=14)[0]
    tq, tk, tv, tg = (torch.from_numpy(t).to(dtype) for t in (q, k, v, g))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = fused_attention(*leaves)
    *_, stats = out.grad_fn.saved_tensors
    b, n, h, hd = shape
    assert stats.shape == (2, b * h, n) and stats.dtype == torch.float32

    # _bwd_kernel's scores and softmax statistics, in jnp, on the same values
    jq, jk = (jnp.asarray(t.float().numpy()) for t in (tq, tk))
    s = jnp.einsum("bqhd,bkhd->bhqk", jq, jk, preferred_element_type=jnp.float32) / math.sqrt(hd)
    m_ref = jnp.max(s, axis=-1)
    l_ref = jnp.sum(jnp.exp(s - m_ref[..., None]), axis=-1)
    np.testing.assert_allclose(stats[0].numpy(), np.asarray(m_ref).reshape(b * h, n), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(stats[1].numpy(), np.asarray(l_ref).reshape(b * h, n), atol=0,
                               rtol=F32_TOL)

    out.backward(tg)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    refs = _jax_vjp(*(t.float().numpy() for t in (tq, tk, tv, tg)), jdtype)
    for leaf, ref, fed in zip(leaves, refs,
                              attention_plain_bwd(tq, tk, tv, tg, 1 / math.sqrt(hd), stats)):
        torch.testing.assert_close(leaf.grad, fed, rtol=0, atol=0)
        tol = F32_TOL if dtype == torch.float32 else 2 ** -6 * np.abs(ref).max()
        np.testing.assert_allclose(leaf.grad.float().numpy(), ref, atol=tol,
                                   rtol=F32_TOL if dtype == torch.float32 else 0)
    with torch.no_grad():  # inference keeps no graph, so nothing is saved
        assert fused_attention(*leaves).grad_fn is None
