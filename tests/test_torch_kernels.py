"""The port's CUDA kernels and their build, without JAX.

The tests marked ``cuda`` hold each kernel against its plain version on the
card and skip elsewhere; on the card (no JAX there) run them with

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""

import pytest
import torch

from irw_tpu_torch import cuda_lib
from irw_tpu_torch.ops.attention import (
    attention_plain,
    attention_plain_bwd,
    fused_attention,
    fused_attention_bwd,
)
from irw_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_plain,
    flash_attention_plain_bwd,
)
from irw_tpu_torch.ops.qkv_attention import fused_qkv_attention, qkv_attention_plain
from irw_tpu_torch.ops.wavelets import (
    haar_swt2,
    haar_swt2_plain,
    lifting_multi_level,
    lifting_multi_level_plain,
)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_lib.build(["haar_swt2"])


def test_library_name_is_keyed_on_the_sources():
    paths = {name: cuda_lib.lib_path(name) for name in cuda_lib.KERNELS}
    assert all(p.parent == cuda_lib.BUILD_DIR for p in paths.values())
    assert len({p.name for p in paths.values()}) == len(paths)
    assert paths["haar_swt2"] == cuda_lib.lib_path("haar_swt2")  # stable


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 33, 47), (2, 224, 224)])
def test_swt_kernel_on_card(card, shape):
    x = torch.randn(shape, generator=torch.Generator(device=card).manual_seed(0), device=card)
    before = haar_swt2.launches
    out = haar_swt2(x)
    torch.cuda.synchronize()
    assert haar_swt2.launches == before + 1
    torch.testing.assert_close(out, haar_swt2_plain(x), rtol=0, atol=1e-5)
    xb = x.to(torch.bfloat16)
    assert haar_swt2(xb).dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,tol", [
    ((3, 50, 2, 64), torch.float32, 1e-5),
    ((2, 257, 6, 64), torch.bfloat16, 2 ** -7),
    ((2, 70, 3, 32), torch.float32, 1e-5),
    ((1, 130, 2, 128), torch.bfloat16, 2 ** -7),
    ((2, 3, 65, 1, 64), torch.float32, 1e-5),
])
def test_attention_kernel_on_card(card, shape, dtype, tol):
    gen = torch.Generator(device=card).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype) for _ in range(3))
    before = fused_attention.launches
    with torch.no_grad():
        out = fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    torch.testing.assert_close(out.float(), attention_plain(q, k, v).float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)])
def test_attention_kernel_reads_strided_inputs(card, dtype, tol):
    gen = torch.Generator(device=card).manual_seed(2)
    qkv = torch.randn(2, 40, 3, 2, 64, generator=gen, device=card).to(dtype)  # fused QKV
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    # rows 65 elements apart: not 16-byte aligned, so bf16 takes a copy
    odd = torch.randn(2, 40, 2, 65, generator=gen, device=card).to(dtype)[..., :64]
    with torch.no_grad():
        for a, b, c in ((q, k, v), (odd, k, v)):
            torch.testing.assert_close(fused_attention(a, b, c).float(),
                                       attention_plain(a, b, c).float(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_attention_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros(1, 8, 1, 48, device=card)
    with torch.no_grad(), pytest.raises(ValueError, match="head_dim"):
        fused_attention(q, q, q)
    h = torch.zeros(1, 8, 1, 64, device=card, dtype=torch.float16)
    with torch.no_grad(), pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_attention(h, h, h)


def _k3_tol(dtype, ref):
    # f32: same math, another summation order; bf16: P and ds are rounded at
    # the same points on both sides, but the f32 accumulation order can move
    # a ds element by one bf16 ulp
    return 1e-5 if dtype == torch.float32 else 2 ** -6 * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((3, 50, 2, 64), torch.float32),
    ((2, 257, 6, 64), torch.bfloat16),
    ((2, 70, 3, 32), torch.float32),
    ((2, 70, 3, 32), torch.bfloat16),
    ((1, 130, 2, 128), torch.bfloat16),
    ((2, 3, 65, 1, 64), torch.float32),
])
def test_attention_bwd_kernel_on_card(card, shape, dtype):
    gen = torch.Generator(device=card).manual_seed(3)
    q, k, v, g = (torch.randn(shape, generator=gen, device=card).to(dtype) for _ in range(4))
    before = fused_attention_bwd.launches
    outs = fused_attention_bwd(q, k, v, g)
    torch.cuda.synchronize()
    assert fused_attention_bwd.launches == before + 1
    for out, ref in zip(outs, attention_plain_bwd(q, k, v, g)):
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=_k3_tol(dtype, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_autograd_launches_both_kernels(card, dtype):
    gen = torch.Generator(device=card).manual_seed(4)
    q, k, v, g = (torch.randn(2, 40, 2, 64, generator=gen, device=card).to(dtype)
                  for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fused_attention.launches, fused_attention_bwd.launches)
    fused_attention(*leaves).backward(g)
    assert (fused_attention.launches, fused_attention_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    for leaf, ref in zip(leaves, fused_attention_bwd(q, k, v, g)):
        torch.testing.assert_close(leaf.grad, ref, rtol=0, atol=0)
    # a broadcast output gradient (stride 0) is copied before the kernel reads it
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fused_attention(*leaves).float().sum().backward()
    ones = torch.ones_like(q)
    for leaf, ref in zip(leaves, attention_plain_bwd(q, k, v, ones)):
        torch.testing.assert_close(leaf.grad.float(), ref.float(), rtol=0,
                                   atol=_k3_tol(dtype, ref))


@pytest.mark.cuda
def test_attention_bwd_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros(1, 8, 1, 48, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fused_attention_bwd(q, q, q, q)
    h = torch.zeros(1, 8, 1, 64, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_attention_bwd(h, h, h, h)


@pytest.mark.cuda
@pytest.mark.parametrize("basis,levels,shape", [
    ("haar", 1, (6, 224, 224)),
    ("haar", 3, (5, 72, 200)),
    ("cdf97", 1, (2, 448, 448)),
    ("cdf97", 2, (3, 40, 24)),
    ("bior48", 2, (4, 64, 32)),
    ("coif12", 1, (1, 6, 2)),
    ("rev_bior_spline_39", 2, (7, 36, 100)),
])
def test_lifting_kernel_on_card(card, basis, levels, shape):
    """K4 rounds each product, sum and quotient as the plain version does:
    the two agree bit for bit, well inside chip_smoke.py's limits."""
    x = torch.randn(shape, generator=torch.Generator(device=card).manual_seed(0), device=card)
    before = lifting_multi_level.launches
    out = lifting_multi_level(x, levels, basis)
    torch.cuda.synchronize()
    assert lifting_multi_level.launches == before + 1
    torch.testing.assert_close(out, lifting_multi_level_plain(x, levels, basis), rtol=0, atol=0)


@pytest.mark.cuda
def test_lifting_kernel_refuses_what_it_does_not_take(card):
    with pytest.raises(NotImplementedError, match="float32"):
        lifting_multi_level(torch.zeros(1, 8, 8, device=card, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="shared"):
        lifting_multi_level(torch.zeros(1, 8192, 8, device=card))
    with pytest.raises(ValueError, match="divide"):
        lifting_multi_level(torch.zeros(1, 12, 8, device=card), levels=3)


FLASH_CASES = [  # (shape, dtype): 1, 2 and 3 key blocks, every head_dim
    ((3, 37, 2, 32), torch.float32),
    ((2, 257, 6, 64), torch.bfloat16),
    ((2, 200, 3, 128), torch.bfloat16),
    ((2, 384, 2, 64), torch.float32),
    ((2, 3, 65, 1, 64), torch.float32),
    ((2, 256, 2, 64), torch.bfloat16),   # whole key blocks: no masked key
    ((2, 130, 2, 128), torch.float32),
]


def _k6_tol(dtype, ref, bwd):
    # of max|ref|: f32 the same math in another order; bf16 one ulp of a
    # rounded p (forward) or p, ds (backward) moved, as K2 and K3
    rel = 1e-5 if dtype == torch.float32 else (2 ** -6 if bwd else 2 ** -7)
    return rel * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", FLASH_CASES)
def test_flash_kernels_on_card(card, shape, dtype):
    gen = torch.Generator(device=card).manual_seed(5)
    q, k, v, do = (torch.randn(shape, generator=gen, device=card).to(dtype) for _ in range(4))
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    o, l, m = flash_attention_fwd(q, k, v, save_residuals=True)
    ro, rl, rm = flash_attention_plain(q, k, v, save_residuals=True)
    grads = flash_attention_bwd(q, k, v, ro, do, rl, rm)
    refs = flash_attention_plain_bwd(q, k, v, ro, do, rl, rm)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == (before[0] + 1,
                                                                            before[1] + 1)
    assert o.dtype == dtype and l.shape == m.shape == (*shape[:-3], shape[-2], shape[-3])
    torch.testing.assert_close(o.float(), ro.float(), rtol=0, atol=_k6_tol(dtype, ro, False))
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)
    torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-6)
    for out, ref in zip(grads, refs):
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=_k6_tol(dtype, ref, True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_on_the_fused_projection(card, dtype):
    """q, k, v as strided views of one (…, N, 3, H, hd) projection, as the
    ViT's FlashAttention passes them: one launch of each kernel, and the
    gradients those of the kernels called directly."""
    gen = torch.Generator(device=card).manual_seed(6)
    qkv = torch.randn(2, 130, 3, 2, 64, generator=gen, device=card).to(dtype)
    do = torch.randn(2, 130, 2, 64, generator=gen, device=card).to(dtype)
    leaf = qkv.clone().requires_grad_()
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    out = flash_attention(*leaf.unbind(-3))
    out.backward(do)
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == (before[0] + 1,
                                                                            before[1] + 1)
    q, k, v = qkv.unbind(-3)
    assert not q.is_contiguous()
    o, l, m = flash_attention_fwd(q, k, v, save_residuals=True)
    torch.testing.assert_close(out, o, rtol=0, atol=0)
    ref = torch.stack(flash_attention_bwd(q, k, v, o, do, l, m), dim=-3)
    torch.testing.assert_close(leaf.grad, ref, rtol=0, atol=0)
    with torch.no_grad():
        torch.testing.assert_close(flash_attention(q, k, v), o, rtol=0, atol=0)


@pytest.mark.cuda
def test_flash_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros(1, 8, 1, 48, device=card)
    with torch.no_grad(), pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    h = torch.zeros(1, 8, 1, 64, device=card, dtype=torch.float16)
    with torch.no_grad(), pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(h, h, h)
    s = torch.zeros(1, 1, 8, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bwd(q, q, q, q, q, s, s)


def _k5_inputs(card, b, n, d, out, dtype, seed=7):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(b, n, d, generator=gen, device=card)
    ws = [torch.randn(d, out, generator=gen, device=card) / d ** 0.5 for _ in range(3)]
    bs = [torch.randn(out, generator=gen, device=card) * 0.1 for _ in range(3)]
    return [t.to(dtype) for t in (x, *ws, *bs)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,heads,hd,dtype", [
    (3, 37, 64, 2, 32, torch.float32),       # one key tile, a scale that is no power of two
    (3, 37, 64, 2, 32, torch.bfloat16),
    (4, 257, 96, 3, 32, torch.bfloat16),     # D = 96: a ragged last chunk of x and W
    (4, 257, 96, 3, 32, torch.float32),
    (2, 257, 384, 6, 64, torch.bfloat16),    # the micro-benchmark's widths
    (2, 257, 384, 6, 64, torch.float32),
    (2, 130, 128, 1, 128, torch.bfloat16),
    (2, 100, 128, 1, 128, torch.float32),
    (2, 64, 192, 4, 64, torch.bfloat16),     # whole key tiles: no masked key; heads * hd != D
])
def test_qkv_attention_kernel_on_card(card, b, n, d, heads, hd, dtype):
    """K5 against its plain version: f32 the same math in another order;
    bf16 two ulps of max(1, max|o|), as chip_smoke.py states."""
    args = _k5_inputs(card, b, n, d, heads * hd, dtype)
    before = fused_qkv_attention.launches
    out = fused_qkv_attention(*args, heads=heads)
    torch.cuda.synchronize()
    assert fused_qkv_attention.launches == before + 1
    ref = qkv_attention_plain(*args, heads=heads)
    assert out.dtype == dtype and out.shape == ref.shape == (b, n, heads * hd)
    peak = max(1.0, ref.float().abs().max().item())
    tol = (1e-5 if dtype == torch.float32 else 2 ** -6) * peak
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_qkv_attention_kernel_reads_views(card):
    """Non-contiguous x and weight slices are copied before the launch."""
    args = _k5_inputs(card, 2, 40, 128, 128, torch.bfloat16)
    wide = _k5_inputs(card, 2, 40, 128, 256, torch.bfloat16)
    views = [args[0].transpose(0, 1).contiguous().transpose(0, 1),
             *(w[:, 64:192] for w in wide[1:4]), *(b[64:192] for b in wide[4:])]
    assert not views[0].is_contiguous() and not views[1].is_contiguous()
    out = fused_qkv_attention(*views, heads=2)
    torch.testing.assert_close(out.float(), qkv_attention_plain(*views, heads=2).float(),
                               rtol=0, atol=2 ** -6)


@pytest.mark.cuda
def test_qkv_attention_kernel_refuses_what_it_does_not_take(card):
    def args(n, d, out, dtype):
        return _k5_inputs(card, 1, n, d, out, dtype)

    before = fused_qkv_attention.launches
    with pytest.raises(ValueError, match="head_dim"):
        fused_qkv_attention(*args(8, 48, 48, torch.float32), heads=1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_qkv_attention(*args(8, 64, 64, torch.float16), heads=1)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_qkv_attention(*args(8, 12, 64, torch.bfloat16), heads=1)
    with pytest.raises(ValueError, match="shared memory"):   # f32 K and V of 257 rows at hd = 128
        fused_qkv_attention(*args(257, 128, 128, torch.float32), heads=1)
    with pytest.raises(NotImplementedError, match="no backward"):
        fused_qkv_attention(*(t.requires_grad_() for t in args(8, 64, 64, torch.float32)), heads=1)
    assert fused_qkv_attention.launches == before
