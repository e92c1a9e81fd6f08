"""The port's ViT against irw_tpu's VisionTransformer, same weights.

Both packages get one parameter set: the JAX init, with every bias,
LayerNorm scale and LayerScale redrawn with numpy (LayerScale near 1, so
attention reaches the output), carried across by ``irw_tpu_torch.bridge``.
``test_tiny`` exercises the unrolled ``Block_i`` layout; ``dinov2_vits14`` at
depth 2 on a 28² input the scanned ``blocks/Block_0`` layout at full width.

Tolerances: f32 CLS tokens agree to 1e-4 (same math, another summation
order and GELU/exp implementation).  In bf16 both sides round every
intermediate to bf16 at slightly different places (XLA fuses elementwise
chains in f32), so the outputs, O(1) after the final LayerNorm, agree to
0.1 absolute — a few bf16 ulps.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from irw_tpu.models.vit import VisionTransformer as JaxViT
from irw_tpu.models.vit import vit_config as jax_vit_config
from irw_tpu_torch.bridge import from_jax_variables, load_jax_variables
from irw_tpu_torch.models.vit import VisionTransformer, vit_config

F32_TOL = 1e-4
BF16_TOL = 0.1


def randomize(variables, seed: int = 0):
    """numpy copy of flax ``variables`` with biases, norm scales, LayerScale
    and BatchNorm statistics redrawn from ``seed`` (kernels keep their init)."""
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, dict(variables)))
    out = {}
    for path, leaf in flat.items():
        name = path[-1]
        leaf = np.array(leaf, dtype=np.float32)
        if name in ("scale", "ls1", "ls2", "var"):
            leaf = (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        elif name in ("bias", "mean"):
            leaf = (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        out[path] = leaf
    return traverse_util.unflatten_dict(out)


def _jax_vit(name, **kw):
    cfg = jax_vit_config(name, **kw)
    return JaxViT(**cfg), cfg


def _pair(name, img, vmem_attn, dtype=jnp.float32, batch=2, seed=0, **kw):
    jmodel, _ = _jax_vit(name, vmem_attn=vmem_attn, dtype=dtype, **kw)
    x = np.random.RandomState(seed).rand(batch, img, img, 3).astype(np.float32)
    variables = jax.jit(lambda r, x: jmodel.init(r, x))(jax.random.PRNGKey(seed), jnp.asarray(x))
    variables = randomize(variables, seed)
    ref, _ = jmodel.apply(variables, jnp.asarray(x))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    model = VisionTransformer(**vit_config(name, img_size=img, vmem_attn=vmem_attn,
                                           dtype=tdtype, **kw))
    load_jax_variables(model, variables)
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
    return ours.float().numpy(), np.asarray(ref, np.float32), variables


@pytest.mark.parametrize("vmem_attn", [False, True])
def test_tiny_unrolled_f32(vmem_attn):
    ours, ref, variables = _pair("test_tiny", 16, vmem_attn)
    assert "Block_1" in variables["params"] and "blocks" not in variables["params"]
    assert ours.shape == ref.shape == (2, 64)
    np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("vmem_attn", [False, True])
def test_vits14_scanned_f32(vmem_attn):
    ours, ref, variables = _pair("dinov2_vits14", 28, vmem_attn, depth=2)
    assert "blocks" in variables["params"]
    assert ours.shape == ref.shape == (2, 384)
    np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("vmem_attn", [False, True])
def test_vits14_bf16(vmem_attn):
    ours, ref, _ = _pair("dinov2_vits14", 28, vmem_attn, dtype=jnp.bfloat16, depth=2)
    np.testing.assert_allclose(ours, ref, atol=BF16_TOL, rtol=0)


def test_exact_gelu():
    ours, ref, _ = _pair("test_tiny", 16, False, exact_gelu=True, seed=3)
    np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=F32_TOL)


def test_scanned_and_unrolled_layouts_give_one_state_dict():
    jmodel, _ = _jax_vit("dinov2_vits14", depth=2)
    x = jnp.zeros((1, 28, 28, 3))
    variables = randomize(jax.jit(jmodel.init)(jax.random.PRNGKey(1), x), 1)
    params = dict(variables["params"])
    stack = params.pop("blocks")["Block_0"]
    for i in range(2):
        params[f"Block_{i}"] = jax.tree_util.tree_map(lambda a, i=i: a[i], stack)
    scanned = from_jax_variables(variables)
    unrolled = from_jax_variables({"params": params})
    assert scanned.keys() == unrolled.keys()
    for key in scanned:
        np.testing.assert_array_equal(scanned[key], unrolled[key])
    # every JAX parameter lands somewhere, no more and no less
    model = VisionTransformer(**vit_config("dinov2_vits14", depth=2, img_size=28))
    assert sum(v.size for v in scanned.values()) == sum(
        np.asarray(a).size for a in jax.tree_util.tree_leaves(variables["params"]))
    assert set(scanned) == set(model.state_dict())
