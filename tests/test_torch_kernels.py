"""The port's CUDA kernels and their build, without JAX.

The tests marked ``cuda`` hold each kernel against its plain version on the
card and skip elsewhere; on the card (no JAX there) run them with

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""

import pytest
import torch

from irw_tpu_torch import cuda_lib
from irw_tpu_torch.ops.attention import (
    _forward,
    attention_plain,
    attention_plain_bwd,
    fused_attention,
    fused_attention_bwd,
    kernel_variants,
)
from irw_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_plain,
    flash_attention_plain_bwd,
    flash_kernel_variants,
)
from irw_tpu_torch.ops.qkv_attention import (
    fused_qkv_attention,
    qkv_attention_plain,
    qkv_kernel_variants,
)
from irw_tpu_torch.ops.wavelets import (
    cdf97_multi_level,
    haar_dwt2_fused,
    haar_multi_level,
    haar_swt2,
    haar_swt2_plain,
    lifting_multi_level,
    lifting_multi_level_plain,
)
from irw_tpu_torch.ops.wavelets.lifting import BASES
from irw_tpu_torch.ops.wavelets.lifting_dwt import lifting_kernel_variants


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


# a stand-in for nvcc: writes its -o file in chunks, slowly, as a compiler
# that another process could read half-way through
FAKE_NVCC = """import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "wb") as f:
    for _ in range(8):
        f.write(b"k" * 4096)
        f.flush()
        time.sleep(0.05)
"""
BUILD_SCRIPT = """import sys, time
from pathlib import Path
from irw_tpu_torch import cuda_lib
cuda_lib.BUILD_DIR = Path(sys.argv[1])
cuda_lib._nvcc = lambda: sys.argv[2]
time.sleep(max(0.0, float(sys.argv[3]) - time.time()))
cuda_lib.build(["haar_swt2"])
print(len(cuda_lib.lib_path("haar_swt2").read_bytes()))
"""


def test_ranks_that_build_at_once_both_load_a_whole_library(tmp_path):
    """Two processes (two ranks of a group) build the same kernel at the same
    moment: each compiles to its own temporary file and swaps it in with
    ``os.replace``, so neither, nor a reader watching the path, ever sees
    half a library."""
    import subprocess
    import sys
    import time

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + FAKE_NVCC)
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build"
    start = time.time() + 2.0
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT, str(build_dir), str(nvcc),
                               str(start)], stdout=subprocess.PIPE, text=True,
                              cwd=cuda_lib.CSRC.parents[1]) for _ in range(2)]
    final = build_dir / cuda_lib.lib_path("haar_swt2").name
    seen = set()
    while any(p.poll() is None for p in procs):
        if final.exists():
            seen.add(len(final.read_bytes()))
        time.sleep(0.01)
    outs = [p.communicate()[0].split() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs == [["32768"], ["32768"]] and seen <= {32768}
    assert sorted(f.name for f in build_dir.iterdir()) == [final.name]   # no .tmp left


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


# K2 and K3 over their whole surface: head dims 32, 64, 128; N from one row
# to the ViT's 577 at 336²; both dtypes; q, k, v (and g) the strided views of
# one (B, N, 3 or 4, H, hd) projection.  bf16 at hd <= 64 and N <= 272 takes
# both plane paths, hd 128 and N = 577 the tiled ones (kernel_variants)
SURFACE = [(n, hd, dtype) for hd in (32, 64, 128) for n in (1, 50, 64, 65, 257, 577)
           for dtype in (torch.bfloat16, torch.float32)]


def _views(card, seed, b, n, h, hd, dtype, count):
    gen = torch.Generator(device=card).manual_seed(seed)
    fused = torch.randn(b, n, count, h, hd, generator=gen, device=card).to(dtype)
    return fused.unbind(2)


@pytest.mark.cuda
@pytest.mark.parametrize("n,hd,dtype", SURFACE)
def test_attention_kernels_over_the_surface(card, n, hd, dtype):
    q, k, v, g = _views(card, n + hd, 2, n, 3, hd, dtype, 4)
    assert not q.is_contiguous()
    before = (fused_attention.launches, fused_attention_bwd.launches)
    with torch.no_grad():
        out = fused_attention(q, k, v)
    grads = fused_attention_bwd(q, k, v, g)
    torch.cuda.synchronize()
    assert (fused_attention.launches, fused_attention_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    torch.testing.assert_close(out.float(), attention_plain(q, k, v).float(), rtol=0,
                               atol=1e-5 if dtype == torch.float32 else 2 ** -7)
    for got, ref in zip(grads, attention_plain_bwd(q, k, v, g)):
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=_k3_tol(dtype, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("n,hd,dtype", SURFACE)
def test_saved_statistics_route_is_the_standalone_backward(card, n, hd, dtype):
    """K2's row statistics fed to K3 give the standalone K3's gradients bit
    for bit (both form m and l by the same update over the same key
    chunks), and they hold the plain softmax's to 1e-4."""
    q, k, v, g = _views(card, 2 * n + hd, 3, n, 2, hd, dtype, 4)
    with torch.no_grad():
        _, stats = _forward(q, k, v, hd ** -0.5, with_stats=True)
        _, ref = attention_plain(q, k, v, with_stats=True)
    before = fused_attention_bwd.launches
    saved = fused_attention_bwd(q, k, v, g, stats=stats)
    alone = fused_attention_bwd(q, k, v, g)
    assert fused_attention_bwd.launches == before + 2
    for a, b in zip(saved, alone):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(stats[0], ref[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(stats[1], ref[1], rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_attention_kernels_pick_both_paths(card):
    bf16 = torch.bfloat16
    assert kernel_variants(257, 64, bf16) == {"fwd": "plane", "bwd": "plane"}
    assert kernel_variants(272, 32, bf16) == {"fwd": "plane", "bwd": "plane"}
    assert kernel_variants(273, 64, bf16) == {"fwd": "plane", "bwd": "tiled"}
    assert kernel_variants(257, 128, bf16) == {"fwd": "plane", "bwd": "tiled"}
    assert kernel_variants(577, 128, bf16) == {"fwd": "tiled", "bwd": "tiled"}
    assert kernel_variants(257, 64, torch.float32) == {"fwd": "tiled", "bwd": "tiled"}


@pytest.mark.cuda
def test_autograd_saves_statistics_only_for_a_gradient(card):
    """One K2 and one K3 launch per forward-backward; the forward saves the
    statistics only when a gradient will be taken."""
    q, k, v, g = _views(card, 9, 2, 257, 6, 64, torch.bfloat16, 4)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = (fused_attention.launches, fused_attention_bwd.launches)
    out = fused_attention(*leaves)
    assert len(out.grad_fn.saved_tensors) == 4  # q, k, v and (2, B·H, N) statistics
    out.backward(g)
    with torch.no_grad():
        fused_attention(q, k, v)
    assert (fused_attention.launches, fused_attention_bwd.launches) == (before[0] + 2,
                                                                        before[1] + 1)
    for leaf, ref in zip(leaves, fused_attention_bwd(q, k, v, g)):
        torch.testing.assert_close(leaf.grad, ref, rtol=0, atol=0)


# every basis at levels 1 and 2 and haar at 3, on planes whose tiles end
# part-way through them, then the first shapes these tests held
LIFT_SHAPES = [(3, 20, 12), (5, 72, 200), (2, 224, 224), (1, 448, 448)]
LIFT_CASES = ([(b, lvl, s) for b in BASES for lvl in (1, 2) for s in LIFT_SHAPES]
              + [("haar", 3, s) for s in [(3, 24, 16), *LIFT_SHAPES[1:]]]
              + [("haar", 1, (6, 224, 224)), ("cdf97", 2, (3, 40, 24)), ("bior48", 2, (4, 64, 32)),
                 ("coif12", 1, (1, 6, 2)), ("rev_bior_spline_39", 2, (7, 36, 100))]
              # W % 4 == 2: 8-byte loads on the register and the tile path
              + [("haar", 1, (3, 20, 6)), ("cdf97", 1, (3, 20, 6))])


@pytest.mark.cuda
@pytest.mark.parametrize("basis,levels,shape", LIFT_CASES)
def test_lifting_kernel_on_card(card, basis, levels, shape):
    """K4 rounds each product, sum and quotient as the plain version does:
    the two agree bit for bit on every path, well inside chip_smoke.py's
    limits."""
    x = torch.randn(shape, generator=torch.Generator(device=card).manual_seed(0), device=card)
    before = lifting_multi_level.launches
    out = lifting_multi_level(x, levels, basis)
    torch.cuda.synchronize()
    assert lifting_multi_level.launches == before + 1
    assert lifting_multi_level.last_path == lifting_kernel_variants(*shape[1:], levels, basis)["path"]
    torch.testing.assert_close(out, lifting_multi_level_plain(x, levels, basis), rtol=0, atol=0)


@pytest.mark.cuda
def test_lifting_kernel_picks_every_path(card):
    gen = torch.Generator(device=card).manual_seed(1)
    for basis, levels, shape, path in [("haar", 1, (4, 224, 224), "register"),
                                       ("haar", 2, (3, 36, 100), "register"),
                                       ("cdf97", 1, (2, 448, 448), "tile"),
                                       ("haar", 4, (2, 224, 224), "tile"),
                                       ("daub4", 3, (2, 224, 224), "tile"),
                                       ("cdf97", 3, (2, 448, 448), "two_pass"),
                                       ("cdf97", 5, (2, 256, 256), "two_pass"),
                                       ("cdf97", 5, (1, 8192, 64), "tile")]:
        assert lifting_kernel_variants(*shape[1:], levels, basis) == {"path": path}
        x = torch.randn(shape, generator=gen, device=card)
        before = lifting_multi_level.launches
        out = lifting_multi_level(x, levels, basis)
        torch.cuda.synchronize()
        assert (lifting_multi_level.launches, lifting_multi_level.last_path) == (before + 1, path)
        torch.testing.assert_close(out, lifting_multi_level_plain(x, levels, basis),
                                   rtol=0, atol=0)


# every path in bf16 and f16: the register path's 4-, 8- and 16-byte loads
# and 4-byte stores, the tile path's halos and 8-byte stores, both two-pass
# kernels
LOW_PRECISION_CASES = [("haar", 1, (6, 224, 224)), ("haar", 1, (3, 20, 6)),
                       ("haar", 2, (3, 36, 100)), ("haar", 3, (3, 24, 16)),
                       ("haar", 4, (2, 224, 224)),
                       ("cdf97", 1, (2, 448, 448)), ("cdf97", 1, (3, 20, 6)),
                       ("daub4", 3, (2, 224, 224)), ("bior48", 2, (4, 64, 32)),
                       ("coif12", 1, (1, 6, 2)), ("rev_bior_spline_39", 2, (7, 36, 100)),
                       ("cdf97", 3, (2, 448, 448)), ("cdf97", 5, (2, 256, 256))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("basis,levels,shape", LOW_PRECISION_CASES)
def test_lifting_kernel_low_precision_on_card(card, basis, levels, shape, dtype):
    """In bf16 and f16 K4 rounds every operation to the dtype, with the
    constants rounded to it first, as the plain version does: bit for bit."""
    gen = torch.Generator(device=card).manual_seed(2)
    x = torch.randn(shape, generator=gen, device=card).to(dtype)
    before = lifting_multi_level.launches
    out = lifting_multi_level(x, levels, basis)
    torch.cuda.synchronize()
    assert lifting_multi_level.launches == before + 1 and out.dtype == dtype
    path = lifting_kernel_variants(*shape[1:], levels, basis)["path"]
    assert lifting_multi_level.last_path == path
    torch.testing.assert_close(out, lifting_multi_level_plain(x, levels, basis), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_lifting_wrappers_launch_once(card, dtype):
    x = torch.randn(3, 64, 96, generator=torch.Generator(device=card).manual_seed(3),
                    device=card).to(dtype)
    for fn, args, basis, levels in [(haar_multi_level, (2,), "haar", 2),
                                    (cdf97_multi_level, (2,), "cdf97", 2),
                                    (haar_dwt2_fused, (), "haar", 1)]:
        before = lifting_multi_level.launches
        out = fn(x, *args)
        torch.cuda.synchronize()
        assert lifting_multi_level.launches == before + 1
        torch.testing.assert_close(out, lifting_multi_level_plain(x, levels, basis),
                                   rtol=0, atol=0)


@pytest.mark.cuda
def test_lifting_kernel_refuses_what_it_does_not_take(card):
    with pytest.raises(NotImplementedError, match="float64"):
        lifting_multi_level(torch.zeros(1, 8, 8, device=card, dtype=torch.float64))
    with pytest.raises(ValueError, match="shared"):
        lifting_multi_level(torch.zeros(1, 8192, 4096, device=card), levels=5, basis="cdf97")
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


# K6 over its surface: N from one row to the ViT's 577 at 336², through the
# one-step boundary (128, 129: a last block with one valid key) and whole
# key blocks (256); head dims 32, 64, 128; both dtypes; q, k, v, do the
# strided views of one (B, N, 4, H, hd) projection.  bf16 takes the plane
# forward up to N = 860 at hd 64 (400 at hd 128) and the plane backward at
# hd <= 64, N <= 272; the rest the tiled kernels (flash_kernel_variants)
FLASH_SURFACE = [(n, hd, dtype) for hd in (32, 64, 128)
                 for n in (1, 37, 64, 65, 127, 128, 129, 256, 257, 577)
                 for dtype in (torch.bfloat16, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,hd,dtype", FLASH_SURFACE)
def test_flash_kernels_over_the_surface(card, n, hd, dtype):
    """K6-fwd's o, l, m and K6-bwd (fed the kernel forward's o, l, m)
    against the plain versions, one launch per wrapper call.  A gradient
    that vanishes in exact arithmetic (N = 1: p = 1 and dp = di) holds only
    f32 residue on both sides: the f32 limit, 1e-5, is its floor."""
    q, k, v, do = _views(card, 3 * n + hd, 2, n, 3, hd, dtype, 4)
    assert not q.is_contiguous()
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    o, l, m = flash_attention_fwd(q, k, v, save_residuals=True)
    assert flash_attention_fwd.launches == before[0] + 1
    grads = flash_attention_bwd(q, k, v, o, do, l, m)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before[1] + 1
    ro, rl, rm = flash_attention_plain(q, k, v, save_residuals=True)
    torch.testing.assert_close(o.float(), ro.float(), rtol=0, atol=_k6_tol(dtype, ro, False))
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)
    torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-6)
    for got, ref in zip(grads, flash_attention_plain_bwd(q, k, v, o, do, l, m)):
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=max(_k6_tol(dtype, ref, True), 1e-5))


@pytest.mark.cuda
def test_flash_kernels_pick_both_paths(card):
    bf16 = torch.bfloat16
    assert flash_kernel_variants(257, 64, bf16) == {"fwd": "plane", "bwd": "plane"}
    assert flash_kernel_variants(272, 32, bf16) == {"fwd": "plane", "bwd": "plane"}
    assert flash_kernel_variants(273, 64, bf16) == {"fwd": "plane", "bwd": "tiled"}
    assert flash_kernel_variants(257, 128, bf16) == {"fwd": "plane", "bwd": "tiled"}
    assert flash_kernel_variants(577, 64, bf16) == {"fwd": "plane", "bwd": "tiled"}
    assert flash_kernel_variants(577, 128, bf16) == {"fwd": "tiled", "bwd": "tiled"}
    assert flash_kernel_variants(257, 64, torch.float32) == {"fwd": "tiled", "bwd": "tiled"}


@pytest.mark.cuda
@pytest.mark.parametrize("n,hd,dtype", [(257, 64, torch.bfloat16), (577, 64, torch.bfloat16),
                                        (577, 128, torch.bfloat16), (257, 64, torch.float32)])
def test_flash_autograd_route_is_the_wrappers_on_every_path(card, n, hd, dtype):
    """Autograd on the fused projection's views equals K6-fwd and K6-bwd
    called directly, bit for bit, on the plane and the tiled paths."""
    gen = torch.Generator(device=card).manual_seed(n + hd)
    qkv = torch.randn(2, n, 3, 2, hd, generator=gen, device=card).to(dtype)
    do = torch.randn(2, n, 2, hd, generator=gen, device=card).to(dtype)
    leaf = qkv.clone().requires_grad_()
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    out = flash_attention(*leaf.unbind(-3))
    out.backward(do)
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == (before[0] + 1,
                                                                            before[1] + 1)
    q, k, v = qkv.unbind(-3)
    o, l, m = flash_attention_fwd(q, k, v, save_residuals=True)
    torch.testing.assert_close(out, o, rtol=0, atol=0)
    ref = torch.stack(flash_attention_bwd(q, k, v, o, do, l, m), dim=-3)
    torch.testing.assert_close(leaf.grad, ref, rtol=0, atol=0)


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


# K5 over its surface (B = 2, 2 heads): N from one row to one past the
# plane envelope (288), head dims 32 and 64 (the plane path up to N = 288)
# and 128 (the tiled path), D from one chunk to ViT-B's 768 with a ragged
# 96; bf16, and f32 at a few (qkv_kernel_variants)
K5_SURFACE = ([(n, hd, d, torch.bfloat16) for n in (1, 16, 37, 64, 65, 128, 257, 288, 289)
               for hd in (32, 64, 128) for d in (64, 96, 384, 768)]
              + [(37, 32, 96, torch.float32), (257, 64, 384, torch.float32),
                 (65, 128, 64, torch.float32), (289, 32, 768, torch.float32)])


@pytest.mark.cuda
@pytest.mark.parametrize("n,hd,d,dtype", K5_SURFACE)
def test_qkv_attention_kernel_over_the_surface(card, n, hd, d, dtype):
    """K5 against its plain version at chip_smoke.py's K5_TOL, one launch a
    call, on the path qkv_kernel_variants names."""
    args = _k5_inputs(card, 2, n, d, 2 * hd, dtype, seed=n + hd + d)
    before = fused_qkv_attention.launches
    out = fused_qkv_attention(*args, heads=2)
    torch.cuda.synchronize()
    assert fused_qkv_attention.launches == before + 1
    assert fused_qkv_attention.last_path == qkv_kernel_variants(n, d, hd, dtype)["fwd"]
    ref = qkv_attention_plain(*args, heads=2)
    assert out.dtype == dtype and out.shape == ref.shape == (2, n, 2 * hd)
    tol = (1e-5 if dtype == torch.float32 else 2 ** -6) * max(1.0, ref.float().abs().max().item())
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_qkv_attention_kernel_picks_both_paths(card):
    bf16 = torch.bfloat16
    for (n, d, hd, dtype), path in [((257, 384, 64, bf16), "plane"), ((289, 384, 64, bf16), "tiled"),
                                    ((257, 384, 64, torch.float32), "tiled")]:
        assert qkv_kernel_variants(n, d, hd, dtype) == {"fwd": path}
        fused_qkv_attention(*_k5_inputs(card, 1, n, d, 6 * hd, dtype), heads=6)
        assert fused_qkv_attention.last_path == path


@pytest.mark.cuda
@pytest.mark.parametrize("n", [257, 289])   # the plane and the tiled path
def test_qkv_attention_kernel_views_of_one_weight(card, n):
    """Column views of one (D, 3·H·hd) weight and of one (3·H·hd,) bias give
    the same bits as contiguous copies of them."""
    gen = torch.Generator(device=card).manual_seed(n)
    d, out = 384, 384
    x = torch.randn(2, n, d, generator=gen, device=card).to(torch.bfloat16)
    w = (torch.randn(d, 3 * out, generator=gen, device=card) / d ** 0.5).to(torch.bfloat16)
    bias = (torch.randn(3 * out, generator=gen, device=card) * 0.1).to(torch.bfloat16)
    views = [w[:, i * out:(i + 1) * out] for i in range(3)] + [bias[i * out:(i + 1) * out]
                                                              for i in range(3)]
    assert not views[0].is_contiguous()
    got = fused_qkv_attention(x, *views, heads=6)
    ref = fused_qkv_attention(x, *(t.contiguous() for t in views), heads=6)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


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


@pytest.mark.cuda
def test_kernels_launch_on_the_tensors_card_not_the_current_one(card):
    """K1 and K2 on ``cuda:1`` while ``cuda:0`` is current: each launch (and
    K2's shared-memory attribute) goes to the tensor's card.  Skips on a
    machine with one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", 1)
    gen = torch.Generator(device=other).manual_seed(3)
    x = torch.randn(6, 40, 40, generator=gen, device=other)
    q, k, v = (torch.randn(2, 257, 6, 64, generator=gen, device=other).to(torch.bfloat16)
               for _ in range(3))
    before = (haar_swt2.launches, fused_attention.launches)
    with torch.cuda.device(0), torch.no_grad():
        assert torch.cuda.current_device() == 0
        bands = haar_swt2(x)
        out = fused_attention(q, k, v)
    torch.cuda.synchronize(other)
    assert (haar_swt2.launches, fused_attention.launches) == (before[0] + 1, before[1] + 1)
    assert bands.device == other and out.device == other
    torch.testing.assert_close(bands, haar_swt2_plain(x), rtol=0, atol=1e-5)
    torch.testing.assert_close(out.float(), attention_plain(q, k, v).float(), rtol=0,
                               atol=2 ** -7)
