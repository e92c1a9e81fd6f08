"""The int8 serving path (``irw_tpu_torch.ops.quant``, ``QuantDense``,
``Mlp(quant_int8=True)``, ``QuantMHA``, ``Block(quant_int8=True)``) against
``irw_tpu/ops/quant.py`` and the JAX modules.

Inputs and weights from numpy seeds; the JAX modules' weights drawn by
``numpy_init`` from ``jax.eval_shape`` and carried into the port by the
bridge.  Tolerances: the quantizer bit for bit (q and scale, f32 and bf16);
the int8 products within 1 ulp of the output dtype; the modules within
1e-5 in f32 and 1 ulp in bf16 (both packages quantize the same
activations to the same integers; the float core between the projections
rounds at other places).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.models import layers as jax_layers
from irw_tpu.models import vit as jax_vit
from irw_tpu.ops import quant as jax_quant
from irw_tpu_torch.bridge import jax_param_paths, load_jax_variables
from irw_tpu_torch.models import get_model
from irw_tpu_torch.models.layers import Linear, Mlp, QuantDense
from irw_tpu_torch.models.vit import QuantMHA, make_vit
from irw_tpu_torch.ops import quant
from test_torch_fusion_heads import numpy_init

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _pair(x: np.ndarray, key: str):
    """x in the dtype of ``key`` in both packages, the same values."""
    xj = jnp.asarray(x).astype(DTYPES[key][1])
    return torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(DTYPES[key][0]), xj


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(jnp.asarray(t, jnp.float32))


def within_ulps(ours, ref, dtype, ulps: int = 1):
    """|ours − ref| ≤ ``ulps`` spacings of ``dtype`` at the larger magnitude."""
    a, b = _np(ours), _np(ref)
    eps = float(torch.finfo(dtype).eps)
    mag = np.maximum(np.abs(a), np.abs(b))
    spacing = np.where(mag > 0, 2.0 ** np.floor(np.log2(np.maximum(mag, 1e-38))) * eps, eps)
    assert np.all(np.abs(a - b) <= ulps * spacing), np.abs(a - b).max()


@pytest.mark.parametrize("key", sorted(DTYPES))
@pytest.mark.parametrize("axes", [(-1,), (0,), (0, 1)])
def test_quantize_symmetric_is_bit_equal(key, axes):
    x = np.random.RandomState(0).randn(6, 5, 24).astype(np.float32)
    x[1] = 0.0   # a zero group: scale 1
    xt, xj = _pair(x, key)
    q, s = quant.quantize_symmetric(xt, axes)
    qj, sj = jax_quant.quantize_symmetric(xj, axes)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


@pytest.mark.parametrize("key", sorted(DTYPES))
def test_int8_dot_and_dense_within_an_ulp(key):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 7, 40).astype(np.float32)
    kernel, bias = rng.randn(40, 24).astype(np.float32), rng.randn(24).astype(np.float32)
    xt, xj = _pair(x, key)
    dtype = DTYPES[key][0]
    out = quant.int8_dot(xt, torch.from_numpy(kernel))
    ref = jax_quant.int8_dot(xj, jnp.asarray(kernel))
    assert out.dtype == dtype and out.shape == (3, 7, 24)
    within_ulps(out, ref, dtype)
    dense = quant.quant_dense_apply(xt, torch.from_numpy(kernel), torch.from_numpy(bias),
                                    out_dtype=dtype)
    within_ulps(dense, jax_quant.quant_dense_apply(xj, jnp.asarray(kernel), jnp.asarray(bias),
                                                   out_dtype=DTYPES[key][1]), dtype)


def test_int8_dot_per_band_is_each_bands_product():
    rng = np.random.RandomState(2)
    x, kernel = rng.randn(4, 3, 5, 16).astype(np.float32), rng.randn(4, 16, 8).astype(np.float32)
    out = quant.int8_dot(torch.from_numpy(x), torch.from_numpy(kernel))
    for s in range(4):
        np.testing.assert_array_equal(
            out[s].numpy(), np.asarray(jax_quant.int8_dot(jnp.asarray(x[s]),
                                                          jnp.asarray(kernel[s]))))


def _linear(kernel, bias, dtype):
    layer = Linear(*kernel.shape, dtype=dtype)
    layer.load_state_dict({"weight": torch.from_numpy(np.ascontiguousarray(kernel.T)),
                           "bias": torch.from_numpy(bias)})
    return layer


@pytest.mark.parametrize("key", sorted(DTYPES))
def test_quant_mlp_matches_jax(key):
    dtype, jdtype = DTYPES[key]
    x = np.random.RandomState(3).randn(2, 9, 32).astype(np.float32)
    jmlp = jax_layers.Mlp(hidden_dim=64, out_dim=32, quant_int8=True, dtype=jdtype)
    variables = numpy_init(jmlp, jnp.zeros((1, 9, 32)), seed=3)
    xt, xj = _pair(x, key)
    ref = jmlp.apply(variables, xj)
    mlp = Mlp(32, 64, 32, dtype=dtype, quant_int8=True)
    assert isinstance(mlp.fc1, QuantDense) and isinstance(mlp.fc2, QuantDense)
    p = variables["params"]
    mlp.fc1.load_state_dict(_linear(np.asarray(p["Dense_0"]["kernel"]),
                                    np.asarray(p["Dense_0"]["bias"]), dtype).state_dict())
    mlp.fc2.load_state_dict(_linear(np.asarray(p["Dense_1"]["kernel"]),
                                    np.asarray(p["Dense_1"]["bias"]), dtype).state_dict())
    with torch.no_grad():
        out = mlp.eval()(xt)
    assert out.dtype == dtype
    if key == "f32":
        np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=1e-5)
    else:
        within_ulps(out, ref, dtype)


@pytest.mark.parametrize("key", sorted(DTYPES))
def test_quant_mha_matches_jax(key):
    dtype, jdtype = DTYPES[key]
    d, h = 32, 2
    x = np.random.RandomState(4).randn(2, 9, d).astype(np.float32)
    jmha = jax_vit.QuantMHA(num_heads=h, dtype=jdtype)
    variables = numpy_init(jmha, jnp.zeros((1, 9, d)), seed=4)
    xt, xj = _pair(x, key)
    ref = jmha.apply(variables, xj)
    mha = QuantMHA(d, h, dtype=dtype)
    p = {k: {n: np.asarray(v) for n, v in leaf.items()} for k, leaf in variables["params"].items()}
    with torch.no_grad():
        for name in ("query", "key", "value"):
            getattr(mha, name).weight.copy_(torch.from_numpy(p[name]["kernel"].reshape(d, d).T))
            getattr(mha, name).bias.copy_(torch.from_numpy(p[name]["bias"].reshape(d)))
        mha.out.weight.copy_(torch.from_numpy(p["out"]["kernel"].reshape(d, d).T))
        mha.out.bias.copy_(torch.from_numpy(p["out"]["bias"]))
        out = mha.eval()(xt)
    if key == "f32":
        np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=1e-5)
    else:
        within_ulps(out, ref, dtype)


def _vits(key, **kw):
    """A JAX and a port ``test_tiny`` ViT with ``quant_int8`` on 16², the
    same weights."""
    dtype, jdtype = DTYPES[key]
    cfg = dict(jax_vit.vit_config("test_tiny"), quant_int8=True, dtype=jdtype, **kw)
    jmodel = jax_vit.VisionTransformer(**cfg)
    variables = numpy_init(jmodel, jnp.zeros((1, 16, 16, 3)), seed=5)
    vit = make_vit("test_tiny", img_size=16, quant_int8=True, dtype=dtype, **kw)
    return jmodel, variables, load_jax_variables(vit, variables).eval()


@pytest.mark.parametrize("key", sorted(DTYPES))
def test_quant_block_matches_jax(key):
    """A ViT block on the quant path (``QuantMHA`` and the ``QuantDense``
    Mlp; ``quant_int8`` takes precedence over ``vmem_attn`` and
    ``fused_qkv``) against JAX's ``Block`` on the same tokens."""
    jmodel, variables, vit = _vits(key, depth=1, vmem_attn=True, fused_qkv=True)
    block = vit.blocks[0]
    assert type(block.attn).__name__ == "QuantMHA"
    assert isinstance(block.mlp.fc1, QuantDense)
    jblock = jax_vit.Block(**jax_vit.block_kwargs(jmodel))
    dtype = DTYPES[key][0]
    for seed in range(3):
        xt, xj = _pair(np.random.RandomState(seed).randn(3, 5, 64).astype(np.float32), key)
        ref = jblock.apply({"params": variables["params"]["Block_0"]}, xj)
        with torch.no_grad():
            out = block(xt)
        assert out.dtype == dtype and out.shape == (3, 5, 64)
        if key == "f32":
            np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=1e-5)
        else:
            within_ulps(out, ref, dtype)


def test_quant_block_refuses_training():
    vit = make_vit("test_tiny", img_size=16, quant_int8=True)
    with pytest.raises(ValueError, match="serving-only"):
        vit.train()(torch.rand(2, 16, 16, 3))


def _flagship(quant_int8: bool):
    """The banded flagship on its scanned preset, cut: dinov2_vits14's
    ``scan_blocks`` layout at its width (384, 6 heads), 2 blocks, patch 8,
    16²."""
    return get_model("multidino_attention_hashing", device="cpu", backbone="dinov2_vits14",
                     fusion_config={"type": "cross_attention_advanced", "output_dim": 64,
                                    "num_heads": 2},
                     vit_kwargs={"img_size": 16, "depth": 2, "patch_size": 8,
                                 "quant_int8": quant_int8})


def test_compress_selects_the_scanned_quant_path_as_jax():
    """``compress_params_int8`` on the scanned banded preset: it picks the
    leaves whose flax paths JAX's picks (``blocks/Block_0/{attn/{query,
    key,value,out},Mlp_0/Dense_*}/kernel``), each with its band axis, q and
    the scales bit for bit those of the JAX compression of the same kernel
    in flax's layout; every other leaf is left as it is."""
    model = _flagship(quant_int8=True)
    paths = jax_param_paths(model)
    state = model.state_dict()
    compressed = quant.compress_params_int8(model)
    picked = sorted(n for n, v in compressed.items() if isinstance(v, quant.QuantizedLeaf))
    assert len(picked) == 2 * 6
    assert all("/blocks/Block_0/" in paths[n] for n in picked)
    for name, leaf in compressed.items():
        if name not in picked:
            assert torch.equal(leaf, state[name]), name
    for name in picked:
        parent = paths[name].split("/")[-2]
        tree = {"blocks": {parent: {"kernel": jnp.asarray(_flax_kernel(parent, state[name]))}}}
        jleaf = jax_quant.compress_params_int8(tree)["blocks"][parent]["kernel"]
        q, s = compressed[name]
        assert q.shape == state[name].shape and s.shape == (*state[name].shape[:-1], 1)
        np.testing.assert_array_equal(_flax_kernel(parent, q.float()), np.asarray(jleaf.q))
        for band in range(q.shape[0]):
            np.testing.assert_array_equal(s[band].reshape(-1).numpy(),
                                          np.asarray(jleaf.s)[band].reshape(-1))


def _flax_kernel(parent: str, w: torch.Tensor) -> np.ndarray:
    """A port (S, out, in) weight as the flax kernel under ``parent``, band
    axis first: (S, d, h, hd) for query/key/value, (S, h, hd, d) for out,
    (S, in, out) for a Dense (6 heads)."""
    t = w.transpose(-1, -2).numpy()                          # (S, in, out)
    if parent in ("query", "key", "value"):
        return t.reshape(*t.shape[:-1], 6, -1)
    if parent == "out":
        return t.reshape(t.shape[0], 6, -1, t.shape[-1])
    return t


def test_decompressed_weights_serve_within_an_ulp_of_the_float_ones():
    """A ``quant_int8`` model on ``decompress_params_int8(compress(…))``
    gives the float weights' logits to 1 ulp (the reconstruction lands on
    the int8 grid the runtime requantization snaps to) and their codes."""
    model = _flagship(quant_int8=True).eval()
    rebuilt = copy.deepcopy(model)
    rebuilt.load_state_dict(quant.decompress_params_int8(quant.compress_params_int8(model)))
    x = torch.from_numpy(np.random.RandomState(7).rand(3, 4, 16, 16, 3).astype(np.float32))
    with torch.no_grad():
        ref, _ = model.forward_logits(x)
        out, _ = rebuilt.forward_logits(x)
        codes, ref_codes = rebuilt(x)[0], model(x)[0]
    within_ulps(out, ref, torch.float32)
    assert torch.equal(codes, ref_codes)
