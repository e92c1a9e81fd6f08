"""The attention-segment micro-benchmarks of the port against the JAX
scripts they port, on the CPU.

``benchmarks/vmem_qkv_micro.py`` and ``benchmarks/vmem_attn_micro.py`` are
loaded from their paths (importing them runs nothing).  The JAX kernel
``fused_qkv_attention`` runs in Pallas interpret mode; the port's plain
version ``qkv_attention_plain`` and the CPU route of its
``fused_qkv_attention`` are held to it, and the port's ``ref_segment`` and
``ref_attention`` to the JAX ones, on the same numpy-seeded inputs.

Tolerances.  f32: 1e-5 absolute (same math, another summation order).  bf16:
both sides round q, k, v, the normalised probabilities and the output to bf16
at the same points; another f32 accumulation order can flip one of those
roundings by a bf16 ulp, which the output carries: 2^-7 of max|o| for the
kernel (one ulp of the largest output), 2^-6 of max|o| for the production
segment, whose bf16 projections round in each framework's own way.  The stock
segment also rounds the SCORES to bf16 before its softmax: a flipped score
(an ulp is 2^-5 for |s| in [4, 8)) moves its probability, and an output that
one key dominates, by that fraction: 2^-5 of max|o|.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu_torch.benchmarks import vmem_attn_micro, vmem_qkv_micro
from irw_tpu_torch.ops.qkv_attention import fused_qkv_attention, qkv_attention_plain

REPO = Path(__file__).resolve().parents[1]
F32_TOL = 1e-5
BF16_KERNEL_TOL = 2 ** -7    # of max|o|
BF16_SEGMENT_TOL = 2 ** -6   # of max|o|
BF16_STOCK_TOL = 2 ** -5     # of max|o|


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_qkv():
    return _load("vmem_qkv_micro")


@pytest.fixture(scope="module")
def jax_attn():
    return _load("vmem_attn_micro")


def _inputs(b, n, d, seed=0):
    """x, three weights / √d, three biases · 0.1, as f32 numpy arrays."""
    rng = np.random.RandomState(seed)
    return ([rng.randn(b, n, d).astype(np.float32)]
            + [(rng.randn(d, d) / np.sqrt(d)).astype(np.float32) for _ in range(3)]
            + [(rng.randn(d) * 0.1).astype(np.float32) for _ in range(3)])


def _both(arrays, bf16):
    """The same values as torch tensors and as jnp arrays, in f32 or bf16."""
    ts = [torch.from_numpy(a).to(torch.bfloat16 if bf16 else torch.float32) for a in arrays]
    js = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if bf16 else jnp.float32) for t in ts]
    return ts, js


def _assert_close(ours, ref, bf16, bf16_tol):
    ref = np.asarray(ref, np.float32)
    assert ours.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert tuple(ours.shape) == ref.shape
    tol = bf16_tol * np.abs(ref).max() if bf16 else F32_TOL
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=tol, rtol=0)


# (b, n, d, heads): hd = 32 twice (one key tile; a scale that is no power of
# two), hd = 128; b = 3 is no multiple of the JAX wrapper's block_b
SHAPES = [(3, 37, 64, 2), (4, 257, 96, 3), (2, 130, 128, 1)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,n,d,heads", SHAPES)
def test_plain_and_cpu_route_match_the_pallas_kernel(jax_qkv, b, n, d, heads, bf16):
    ts, js = _both(_inputs(b, n, d), bf16)
    ref = jax_qkv.fused_qkv_attention(*js, heads=heads, interpret=True)
    plain = qkv_attention_plain(*ts, heads=heads)
    _assert_close(plain, ref, bf16, BF16_KERNEL_TOL)
    before = fused_qkv_attention.launches
    routed = fused_qkv_attention(*ts, heads=heads)
    assert fused_qkv_attention.launches == before  # the CPU route launches nothing
    torch.testing.assert_close(routed, plain, rtol=0, atol=0)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("vmem", [True, False], ids=["prod", "stock"])
@pytest.mark.parametrize("b,n,d,heads", SHAPES[:2])
def test_ref_segment_matches_jax(jax_qkv, b, n, d, heads, vmem, bf16):
    ts, js = _both(_inputs(b, n, d, seed=1), bf16)
    ref = jax_qkv.ref_segment(*js, heads=heads, vmem=vmem)
    with torch.no_grad():
        ours = vmem_qkv_micro.ref_segment(*ts, heads=heads, vmem=vmem)
    _assert_close(ours, ref, bf16, BF16_SEGMENT_TOL if vmem else BF16_STOCK_TOL)


def test_stock_segment_rounds_the_scale_like_jax():
    """At hd = 32 the stock segment divides q by √32 rounded to bf16 (5.65625)
    before the product; the kernel multiplies the f32 product by 1/√32.  The
    two conventions differ by more than rounding noise in the scores, and the
    port's stock segment follows the JAX one."""
    q = torch.full((1, 1, 1, 32), 3.0, dtype=torch.bfloat16)
    root = torch.full((), 32 ** 0.5, dtype=torch.bfloat16)
    assert float(root) == 5.65625
    assert float((q / root)[0, 0, 0, 0]) == float(jnp.asarray(3.0, jnp.bfloat16)
                                                  / np.sqrt(32).astype(jnp.bfloat16))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_ref_attention_matches_jax(jax_attn, bf16):
    rng = np.random.RandomState(2)
    ts, js = _both([rng.randn(2, 37, 3, 32).astype(np.float32) for _ in range(3)], bf16)
    _assert_close(vmem_attn_micro.ref_attention(*ts), jax_attn.ref_attention(*js), bf16,
                  BF16_STOCK_TOL)


def test_no_gradient_is_offered():
    ts, _ = _both(_inputs(2, 9, 64), False)
    with pytest.raises(NotImplementedError, match="no backward"):
        fused_qkv_attention(ts[0].requires_grad_(), *ts[1:], heads=2)
    with pytest.raises(NotImplementedError, match="no backward"):
        fused_qkv_attention(*ts[:6], ts[6].clone().requires_grad_(), heads=2)
    with torch.no_grad():  # a parameter under no_grad is served
        out = fused_qkv_attention(*ts, heads=2)
    assert out.shape == (2, 9, 64) and not out.requires_grad


def test_wrapper_refuses_bad_shapes_and_dtypes():
    ts, _ = _both(_inputs(2, 9, 64), False)
    with pytest.raises(ValueError, match="heads"):
        fused_qkv_attention(*ts, heads=3)
    with pytest.raises(ValueError, match="weights"):
        fused_qkv_attention(ts[0], ts[1][:, :32], *ts[2:], heads=2)
    with pytest.raises(ValueError, match="mixed dtypes"):
        fused_qkv_attention(ts[0].to(torch.bfloat16), *ts[1:], heads=2)
    with pytest.raises(ValueError, match=r"\(B, N, D\)"):
        fused_qkv_attention(ts[0][0], *ts[1:], heads=2)


def test_make_inputs_follow_the_jax_script():
    """x, then three weights / √d, then three biases · 0.01, from one
    RandomState, as benchmarks/vmem_qkv_micro.py:134-139 draws them."""
    args = vmem_qkv_micro.make_inputs(2, 5, 16, seed=0)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 16)
    w = [rng.randn(16, 16) / np.sqrt(16) for _ in range(3)]
    bias = [rng.randn(16) * 0.01 for _ in range(3)]
    for ours, ref in zip(args, [x, *w, *bias]):
        assert ours.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            ours.float().numpy(), np.asarray(jnp.asarray(ref, jnp.bfloat16), np.float32))


def test_qkv_micro_runs_on_the_cpu_when_asked():
    res = vmem_qkv_micro.run(b=3, n=37, heads=2, d=64, iters=1, device="cpu")
    assert set(res) == {"shape", "fwd_maxdiff_vs_prod", "fusedqkv_fwd_ms", "prod_fwd_ms",
                        "stock_fwd_ms", "device"}
    assert res["shape"] == [3, 37, 2, 32] and res["device"] == "cpu"
    assert res["fwd_maxdiff_vs_prod"] <= 2 ** -6
    assert all(res[k] > 0 for k in ("fusedqkv_fwd_ms", "prod_fwd_ms", "stock_fwd_ms"))


def test_attn_micro_runs_on_the_cpu_when_asked():
    res = vmem_attn_micro.run(b=2, n=37, h=2, hd=32, iters=1, device="cpu")
    assert set(res) == {"shape", "fwd_maxdiff", "grad_maxdiff", "fused_fwd_ms", "ref_fwd_ms",
                        "fused_fwdbwd_ms", "ref_fwdbwd_ms", "device"}
    assert res["shape"] == [2, 37, 2, 32] and res["device"] == "cpu"
    # the bars of the JAX package's own run of this micro, with one ulp of room
    assert res["fwd_maxdiff"] <= 2 ** -6 and res["grad_maxdiff"] <= 2 ** -5


def test_micros_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (vmem_qkv_micro.run, vmem_attn_micro.run):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
