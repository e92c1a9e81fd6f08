"""The dtype flow of every CNN family in half precision, exactly: each
output's dtype (eval and training, the aux dict's included) equals what
``jax.eval_shape`` gives for the JAX module in the same ``dtype``, at full
width.  The port's model is built and run on the meta device (no weights
drawn, no arithmetic), the JAX one only traced; the JAX parameter shapes
are traced once a family and shared by its dtypes.

What the flow shows, as flax and jnp promote: the trunks' outputs are in
the dtype; a classifier, a subband gate, ``ChannelGate1D``, ``ProjectionHead``
and a LayerNorm declared without a dtype compute in float32 on them; an
embedding L2-normalised straight from a trunk stays in the dtype.  Also
``ResNet(return_stages=True)``'s four stage maps, and each family's modules
computing in the dtype with float32 parameters and buffers.  K4 (the
in-model DWT) runs its plain version on the meta device.

The single trunks and the hashing ResNets run here; each other group of
``FAMILIES`` in a file of its own, each within 45 s alone (the JAX traces
of the ResNet-50 and DenseNet-121 families take 3–26 s each):
``tests/test_torch_trunks_half_flow_wave.py`` (WaveResNet),
``…_flow_wcnn.py`` (WCNN), ``…_flow_mt.py`` (``FourBranchResNet50`` and
the fusion), ``…_flow_dense.py`` (``FourBranchResNet``, DenseNet-121),
``…_flow_hybrid.py`` and ``…_flow_hybrid_f16.py``.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import jax
import jax.numpy as jnp
import pytest
import torch

from irw_tpu.models import get_model as jax_get_model
from irw_tpu_torch.models import MODEL_REGISTRY, wresnet
from irw_tpu_torch.models.resnet import BatchNorm, Conv2d
from irw_tpu_torch.ops.wavelets import lifting_multi_level_plain

DTYPES = ("bfloat16", "float16")
B = 2
# registry name → (input shape, keyword arguments both registries take)
FAMILIES = {
    "resnet18": ((B, 32, 32, 3), {}),
    "densenet121": ((B, 32, 32, 3), {}),
    "convnext": ((B, 32, 32, 3), {}),
    "wresnet": ((B, 32, 32, 3), {"attention": "cbam"}),
    "wresnet_ce": ((B, 32, 32, 3), {"num_classes": 5}),
    "wcnn": ((B, 4, 16, 16, 3), {"backbone": "resnet18"}),
    "wcnn_all_subs": ((B, 7, 16, 16, 3), {"backbone": "resnet18", "num_classes": 5}),
    "wcnn_attention_ce": ((B, 4, 16, 16, 3), {"num_classes": 5}),
    "mtwavenet": ((B, 4, 32, 32, 3), {"num_classes": 5}),
    "mtwavenet50": ((B, 4, 32, 32, 3), {}),
    "mtwavenet50_fusion": ((B, 4, 32, 32, 3), {"num_classes": 5}),
    "hybrid_mtwavenet_v2_ce": ((B, 4, 32, 32, 3), {"num_classes": 5}),
    "resnet_ce": ((B, 32, 32, 3), {"depth": 18, "num_classes": 5, "frozen_bn": False}),
    "resnet50_tanh": ((B, 32, 32, 3), {"depth": 18, "nbits": 16}),
    "resnet50_dsch": ((B, 32, 32, 3), {"use_layernorm": True, "double_pool": True}),
    "resnet50_mod": ((B, 32, 32, 3), {"n_bits": 16}),
}

_SHAPES = {}


def _dtypes(out):
    """The dtypes of an output tree in a fixed order (dict keys sorted)."""
    if isinstance(out, dict):
        return [d for k in sorted(out) for d in _dtypes(out[k])]
    if isinstance(out, (list, tuple)):
        return [d for v in out for d in _dtypes(v)]
    return [str(out.dtype).removeprefix("torch.")]


def _jax_flow(name, dtype, **call):
    """The JAX model's eval and training outputs' dtypes, traced only."""
    shape, kw = FAMILIES[name]
    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    if name not in _SHAPES:
        _SHAPES[name] = jax.eval_shape(
            lambda x: jax_get_model(name, **kw).init(rngs, x, train=True, **call), x)
    jmodel = jax_get_model(name, dtype=dtype, **kw)

    def run(v, x):
        ev = jmodel.apply(v, x, train=False, **call)
        tr = jmodel.apply(v, x, train=True, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(2)}, **call)[0]
        return ev, tr

    ev, tr = jax.eval_shape(run, _SHAPES[name], x)
    return _dtypes(ev), _dtypes(tr)


def _port_flow(name, dtype, **call):
    shape, kw = FAMILIES[name]
    with torch.device("meta"):
        model = MODEL_REGISTRY[name](torch.device("cpu"), dtype=dtype, **kw)
        x = torch.empty(shape)
        ev = model.eval()(x, **call)
        tr = model.train()(x, **call)
    return model, _dtypes(ev), _dtypes(tr)


@pytest.fixture(autouse=True)
def _k4_plain(monkeypatch):
    """K4 has no meta-device route; its plain version traces the shapes."""
    monkeypatch.setattr(wresnet, "lifting_multi_level", lifting_multi_level_plain)


def check_flow(name, dtype):
    model, ev, tr = _port_flow(name, dtype)
    assert (ev, tr) == _jax_flow(name, dtype)
    compute = {m.dtype for m in model.modules() if isinstance(m, (Conv2d, BatchNorm))}
    assert compute == {getattr(torch, dtype)}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for b in model.buffers() if b.is_floating_point()} <= {torch.float32}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["convnext", "resnet18", "resnet50_dsch", "resnet50_mod",
                                  "resnet50_tanh", "resnet_ce"])
def test_family_dtype_flow_matches_jax(name, dtype):
    check_flow(name, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_resnet_stage_dtypes_match_jax(dtype):
    _, ev, tr = _port_flow("resnet18", dtype, return_stages=True)
    assert (ev, tr) == _jax_flow("resnet18", dtype, return_stages=True) == ([dtype] * 4,) * 2
