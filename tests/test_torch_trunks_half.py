"""The CNN trunks in half precision (bfloat16 and float16) against irw_tpu's
flax modules in the same ``dtype``, op by op.

Each op takes the same inputs and the same float32 parameters in both
packages (``numpy_init`` draws them from ``jax.eval_shape``; the bridge
carries them) and is held to the JAX result within ONE ulp of the dtype at
the result's largest magnitude (``_ulps``; half an ulp for the pools,
which need no rounding beyond jnp's):

- a 3×3 conv without a bias and a depthwise 7×7 conv with one (flax
  ``promote_dtype``: the bias added after the product is rounded);
- ``BatchNorm`` in training (the output, and the float32 running statistics
  of x in float32, also within 1e-5 relative: float32 sums over 1024 values
  in another order, E[x²] − E[x]² at E[x²] ≈ 13 off by up to 24 float32
  ulps of the variance) and in eval (the running statistics);
- ``l2_normalize`` and ``global_pool`` (avg, max, avg_max) on
  half-precision features: jnp sums and means a half-precision array in
  float32 and rounds once, and so do PyTorch's CPU and CUDA reductions;
- a ``ConvNeXtBlock`` (LayerScale about 1) on a half-precision input and on
  the float32 residual stream, whose output is float32 (the LayerScale
  promotes); its ulp is the dtype's;
- ``CrossBandAttention`` with its spatial gate (bf16 Dense, conv,
  running-statistics BatchNorm and sigmoid; the gate and the output).

Inputs are N(0, 1) at (4, 16, 16, 32) unless said.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.models import attention_blocks as jax_blocks
from irw_tpu.models import convnext as jax_convnext
from irw_tpu.models import layers as jax_layers
from irw_tpu_torch.bridge import load_jax_variables
from irw_tpu_torch.models import attention_blocks, convnext, layers
from irw_tpu_torch.models.resnet import BatchNorm, Conv2d
from test_torch_fusion_heads import numpy_init
from test_torch_trunks import _layerscale_one

DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float16": (jnp.float16, torch.float16)}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _ulps(ours, ref, dtype: torch.dtype) -> float:
    """max |ours − ref| in ulps of ``dtype`` at max |ref| (the spacing of
    the binade that holds the largest entry)."""
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape
    top = float(np.abs(ref).max())
    ulp = torch.finfo(dtype).eps * 2.0 ** np.floor(np.log2(top))
    return float(np.abs(ours - ref).max()) / ulp


def _input(seed, shape=(4, 16, 16, 32)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(x, tdt):
    return torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _load_conv(conv, params):
    """A flax Conv's kernel (H, W, I, O) and bias into a ``Conv2d``."""
    with torch.no_grad():
        conv.weight.copy_(_t(params["kernel"]).permute(3, 2, 0, 1))
        if "bias" in params:
            conv.bias.copy_(_t(params["bias"]))


def _load_norm(norm, params, stats=None):
    with torch.no_grad():
        norm.weight.copy_(_t(params["scale"]))
        norm.bias.copy_(_t(params["bias"]))
        if stats is not None:
            norm.running_mean.copy_(_t(stats["mean"]))
            norm.running_var.copy_(_t(stats["var"]))


def _load_dense(lin, params):
    with torch.no_grad():
        lin.weight.copy_(_t(params["kernel"]).T)
        lin.bias.copy_(_t(params["bias"]))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["3x3", "depthwise_bias"])
def test_conv_within_one_ulp(dtype, case):
    jdt, tdt = DTYPES[dtype]
    x = _input(0)
    if case == "3x3":
        jconv = fnn.Conv(48, (3, 3), padding=1, use_bias=False, dtype=jdt)
        conv = Conv2d(32, 48, 3, padding=1, bias=False, dtype=dtype)
    else:
        jconv = fnn.Conv(32, (7, 7), padding=3, feature_group_count=32, dtype=jdt)
        conv = Conv2d(32, 32, 7, padding=3, groups=32, dtype=dtype)
    variables = numpy_init(jconv, jnp.asarray(x, jdt), seed=1)
    ref = jconv.apply(variables, jnp.asarray(x, jdt))
    _load_conv(conv, variables["params"])
    with torch.no_grad():
        out = conv(_nchw(x, tdt)).permute(0, 2, 3, 1)
    assert out.dtype == tdt and ref.dtype == jdt
    assert conv.weight.dtype == torch.float32
    assert _ulps(out, ref, tdt) <= 1.0, _ulps(out, ref, tdt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batch_norm_within_one_ulp(dtype, train):
    jdt, tdt = DTYPES[dtype]
    x = 2.0 + 3.0 * _input(2)
    jbn = fnn.BatchNorm(use_running_average=not train, momentum=0.9, dtype=jdt)
    variables = numpy_init(jbn, jnp.asarray(x, jdt), seed=3)
    if train:
        ref, upd = jbn.apply(variables, jnp.asarray(x, jdt), mutable=["batch_stats"])
    else:
        ref, upd = jbn.apply(variables, jnp.asarray(x, jdt)), None
    bn = BatchNorm(32, dtype)
    _load_norm(bn, variables["params"], variables["batch_stats"])
    bn.train(train)
    with torch.no_grad():
        out = bn(_nchw(x, tdt)).permute(0, 2, 3, 1)
    assert out.dtype == tdt and ref.dtype == jdt
    assert _ulps(out, ref, tdt) <= 1.0, _ulps(out, ref, tdt)
    assert {t.dtype for t in bn.state_dict().values() if t.is_floating_point()} == {torch.float32}
    if train:
        for key, leaf in (("running_mean", "mean"), ("running_var", "var")):
            ours, ref = bn.state_dict()[key], upd["batch_stats"][leaf]
            assert _ulps(ours, ref, tdt) <= 1.0, key
            # float32 sums over 1024 values in another order
            np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-5, atol=0, err_msg=key)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_l2_normalize_within_one_ulp(dtype):
    jdt, tdt = DTYPES[dtype]
    x = 4.0 * _input(4, (6, 512))
    ref = jax_layers.l2_normalize(jnp.asarray(x, jdt))
    out = layers.l2_normalize(torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt and ref.dtype == jdt
    assert _ulps(out, ref, tdt) <= 1.0, _ulps(out, ref, tdt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pool", ["avg", "max", "avg_max"])
def test_global_pool_rounds_as_jnp(dtype, pool):
    """jnp's mean of a half-precision array sums in float32, divides, and
    rounds once: PyTorch's mean does the same."""
    jdt, tdt = DTYPES[dtype]
    x = 1.0 + _input(5, (4, 7, 7, 256))
    ref = jax_layers.global_pool(jnp.asarray(x, jdt), pool)
    out = layers.global_pool(torch.from_numpy(x).to(tdt), pool)
    assert out.dtype == tdt and ref.dtype == jdt
    assert _ulps(out, ref, tdt) <= 0.5


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("stream", ["half", "float32"])
def test_convnext_block_within_one_ulp(dtype, stream):
    """The block on a half-precision input (the first block after the
    stem's LayerNorm) and on the float32 residual stream of every later
    block: both give float32 (x + y · gamma, gamma float32)."""
    jdt, tdt = DTYPES[dtype]
    x = _input(6, (2, 9, 9, 32))
    xin = (jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)) if stream == "half" else \
        (jnp.asarray(x), torch.from_numpy(x))
    jblock = jax_convnext.ConvNeXtBlock(32, dtype=jdt)
    variables = _layerscale_one(numpy_init(jblock, xin[0], seed=7), 7)
    ref = jblock.apply(variables, xin[0])
    block = convnext.ConvNeXtBlock(32, dtype=tdt)
    params = variables["params"]
    _load_conv(block.dwconv, params["Conv_0"])
    _load_norm(block.norm, params["LayerNorm_0"])
    _load_dense(block.fc1, params["Dense_0"])
    _load_dense(block.fc2, params["Dense_1"])
    with torch.no_grad():
        block.gamma.copy_(_t(params["gamma"]))
    with torch.no_grad():
        out = block(xin[1])
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    assert _ulps(out, ref, tdt) <= 1.0, _ulps(out, ref, tdt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cross_band_attention_within_one_ulp(dtype):
    jdt, tdt = DTYPES[dtype]
    x = _input(8, (2, 4, 6, 6, 16))
    jatt = jax_blocks.CrossBandAttention(no_spatial=False, dtype=jdt)
    variables = numpy_init(jatt, jnp.asarray(x, jdt), seed=9)
    out_ref, scale_ref = jatt.apply(variables, jnp.asarray(x, jdt))
    att = attention_blocks.CrossBandAttention(4 * 16, no_spatial=False, dtype=dtype)
    load_jax_variables(att, variables)
    for mode in (False, True):   # the spatial BatchNorm reads its running statistics in both
        att.train(mode)
        with torch.no_grad():
            out, scale = att([_nchw(x[:, s], tdt) for s in range(4)])
        out = torch.stack([y.permute(0, 2, 3, 1) for y in out], dim=1)
        assert out.dtype == scale.dtype == tdt and out_ref.dtype == scale_ref.dtype == jdt
        assert _ulps(scale, scale_ref, tdt) <= 1.0
        assert _ulps(out, out_ref, tdt) <= 1.0
