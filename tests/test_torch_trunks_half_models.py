"""Whole CNN trunks in half precision against irw_tpu's, same float32
weights, in eval and in training: the outputs, the BatchNorm statistics
after the training forward, and every parameter's gradient.

Models, small: a ResNet of basic blocks at width 16, one block a stage,
on 64² images (its last stage's 2 × 2 maps); ``DenseNet(block_sizes=(2,
2), growth_rate=8, init_features=16)`` and ``ConvNeXt(depths=(1, 1),
dims=(16, 32))`` (LayerScale about 1) on 32².  Batch 4; the loss is a
fixed random weighting of the output.  The ResNet runs here, DenseNet and
ConvNeXt in ``tests/test_torch_trunks_half_dense.py`` (each file within
45 s alone).  The staged four-band trunk's ``CrossBandAttention`` is held
op by op in ``tests/test_torch_trunks_half.py``, its dtype flow in
``tests/test_torch_trunks_half_flow.py``.

The bound, derived from JAX's own rounding: two half-precision runs of one
network that round in different places (XLA's and PyTorch's conv and
reduction orders) each stray from the float32 result by about the same
amount, so the port in half precision must stay as close to JAX's float32
result as JAX's half-precision run does, times a margin:

    |port_half − jax_f32| ≤ MARGIN · max(|jax_half − jax_f32|, FLOOR)

with max-abs distances for the outputs and statistics and L2 norms for each
gradient leaf, FLOOR one ulp of the dtype at the float32 result's largest
entry (its L2 norm times eps for a leaf).  Measured on these models the
ratio reached 1.4 on outputs and statistics (ConvNeXt, bf16) and 2.6 on a
gradient leaf (DenseNet's, f16, where BatchNorm over 4 samples of small
maps makes both runs' gradients stray 10–20 % from float32): MARGIN 2 and
GRAD_MARGIN 4.  A rounding mistake of the port (a bias added before the
rounding, a half-precision BatchNorm statistic, a float32 op where jnp
rounds) shows as a ratio far above these.  The f32 run of the port is held
to JAX's f32 run to 1e-4 as the f32 tests do; the parameters and buffers
stay float32.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from irw_tpu.models import convnext as jax_convnext
from irw_tpu.models import densenet as jax_densenet
from irw_tpu.models import resnet as jax_resnet
from irw_tpu_torch.bridge import from_jax_variables, load_jax_variables, to_flax_leaves
from irw_tpu_torch.models import convnext, densenet, resnet
from test_torch_fusion_heads import numpy_init
from test_torch_trunks import _layerscale_one

MARGIN = 2.0
GRAD_MARGIN = 4.0
F32_TOL = 1e-4
DTYPES = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}
BATCH = 4
# a side of 64 leaves the ResNets' last stage 2 × 2 maps: its training
# BatchNorm normalises 16 values a channel (4 at 32², where both packages'
# half-precision outputs stray far from float32, tests/test_torch_trunks.py)
IMG = {"resnet": 64, "densenet": 32, "convnext": 32}

_CACHE = {}


def _models(case, name):
    """(JAX module, port module) of ``case`` in the dtype ``name``."""
    dtype = jnp.dtype(name)
    if case == "resnet":
        return (jax_resnet.ResNet(stage_sizes=(1, 1, 1, 1), block=jax_resnet.BasicBlock,
                                  width=16, dtype=dtype),
                resnet.ResNet((1, 1, 1, 1), "basic", 16, dtype=name))
    if case == "densenet":
        kw = dict(block_sizes=(2, 2), growth_rate=8, init_features=16)
        return jax_densenet.DenseNet(**kw, dtype=dtype), densenet.DenseNet(**kw, dtype=name)
    kw = dict(depths=(1, 1), dims=(16, 32))
    return jax_convnext.ConvNeXt(**kw, dtype=dtype), convnext.ConvNeXt(**kw, dtype=name)


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _jax_results(case, dtype, variables, x, weights):
    """JAX's eval output, training output, statistics and gradients of the
    weighted training output, in ``dtype``."""
    jm, _ = _models(case, dtype)
    has_stats = "batch_stats" in variables

    def run(params, x):
        v = dict(variables, params=params)
        ev = _first(jm.apply(v, x, train=False))

        def loss(p):
            vp = dict(v, params=p)
            if has_stats:
                out, upd = jm.apply(vp, x, train=True, mutable=["batch_stats"])
            else:
                out, upd = jm.apply(vp, x, train=True), {}
            out = _first(out)
            return jnp.sum(out.astype(jnp.float32) * weights), (out, upd)

        (_, (tr, upd)), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return ev, tr, upd, grads

    return jax.jit(run)(variables["params"], jnp.asarray(x))


def _port_results(case, dtype, variables, x, weights):
    _, model = _models(case, dtype)
    load_jax_variables(model, variables)
    with torch.no_grad():
        ev = _first(model.eval()(torch.from_numpy(x)))
    tr = _first(model.train()(torch.from_numpy(x)))
    (tr.float() * torch.from_numpy(weights)).sum().backward()
    grads = to_flax_leaves(model, {n: p.grad for n, p in model.named_parameters()})
    return model, ev.detach(), tr.detach(), grads


def case_results(case):
    """Every run of ``case``: JAX in float32, bfloat16 and float16, the port
    in each, on one draw of weights, images and loss weights."""
    if case not in _CACHE:
        shape = (BATCH, IMG[case], IMG[case], 3)
        x = np.random.RandomState(0).randn(*shape).astype(np.float32)
        jm, _ = _models(case, "float32")
        variables = numpy_init(jm, jnp.asarray(x), seed=1, train=True)
        variables = _layerscale_one(variables, 1)
        with torch.device("meta"):
            out_shape = _first(_models(case, "float32")[1](torch.empty(shape))).shape
        weights = np.random.RandomState(2).randn(*out_shape).astype(np.float32)
        runs = {}
        for name in ("float32", *DTYPES):
            runs[name] = (_jax_results(case, name, variables, x, weights),
                          _port_results(case, name, variables, x, weights))
        _CACHE[case] = variables, runs
    return _CACHE[case]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _floor(ref, dtype):
    top = float(np.abs(ref).max())
    return torch.finfo(getattr(torch, dtype)).eps * 2.0 ** np.floor(np.log2(top))


def _held(ours, jax_half, ref, dtype, what):
    """max |ours − ref| ≤ MARGIN · max(max |jax_half − ref|, one ulp)."""
    ours, jax_half, ref = _np(ours), _np(jax_half), _np(ref)
    assert ours.shape == ref.shape, what
    bound = MARGIN * max(float(np.abs(jax_half - ref).max()), _floor(ref, dtype))
    assert float(np.abs(ours - ref).max()) <= bound, (what, float(np.abs(ours - ref).max()),
                                                      bound)


def _stats(variables, upd):
    ref = from_jax_variables({"params": variables["params"], **upd})
    return {k: v for k, v in ref.items() if k.endswith(("running_mean", "running_var"))}


CASES = ["resnet"]   # DenseNet and ConvNeXt: tests/test_torch_trunks_half_dense.py


def check_outputs_and_statistics(case, dtype):
    variables, runs = case_results(case)
    (jev32, jtr32, jupd32, _), (model32, ev32, tr32, _) = runs["float32"]
    (jev, jtr, jupd, _), (model, ev, tr, _) = runs[dtype]
    np.testing.assert_allclose(_np(ev32), _np(jev32), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(_np(tr32), _np(jtr32), rtol=F32_TOL, atol=F32_TOL)
    assert ev.dtype == getattr(torch, str(jev.dtype)) and tr.dtype == getattr(torch, str(jtr.dtype))
    _held(ev, jev, jev32, dtype, "eval output")
    _held(tr, jtr, jtr32, dtype, "training output")
    if jupd:
        ref32, ref_half = _stats(variables, jupd32), _stats(variables, jupd)
        sd = model.state_dict()
        for key in ref32:
            _held(sd[key], ref_half[key], ref32[key], dtype, key)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for b in model.buffers() if b.is_floating_point()} <= {torch.float32}


def check_gradients(case, dtype):
    """Each leaf's gradient: ‖port − jax_f32‖ ≤ GRAD_MARGIN · max(‖jax_half −
    jax_f32‖, eps · ‖jax_f32‖); the float32 gradients to 1e-4 of the leaf's
    largest entry."""
    _, runs = case_results(case)
    (_, _, _, jg32), (_, _, _, g32) = runs["float32"]
    (_, _, _, jg), (_, _, _, g) = runs[dtype]
    flat32 = {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(jg32).items()}
    flat = {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(jg).items()}
    assert set(g) == set(flat32)
    eps = torch.finfo(getattr(torch, dtype)).eps
    for path, ref in flat32.items():
        assert g[path].dtype == torch.float32, path
        np.testing.assert_allclose(g32[path].numpy(), ref, rtol=0,
                                   atol=F32_TOL * max(1.0, float(np.abs(ref).max())),
                                   err_msg=path)
        gap = max(float(np.linalg.norm(flat[path] - ref)), eps * float(np.linalg.norm(ref)))
        ours = float(np.linalg.norm(g[path].numpy() - ref))
        assert ours <= GRAD_MARGIN * gap, (path, ours, gap)




@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_half_model_outputs_and_statistics(case, dtype):
    check_outputs_and_statistics(case, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_half_model_gradients(case, dtype):
    check_gradients(case, dtype)

