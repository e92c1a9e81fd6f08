"""Every fusion head of the port against irw_tpu's, same weights.

Each head type of ``get_fusion_head`` takes a seeded (B = 6, S = 4, D) band
stack.  Weights: drawn with numpy in the shapes of the JAX init (``numpy_init``:
no initializer is compiled), biases, LayerNorm scales and BatchNorm
statistics redrawn as ``randomize`` does, carried across by the bridge.  In eval mode
the output and every aux entry are held to 1e-5; in training mode (dropout 0,
no subband-LL dropout) the output, the BatchNorm's updated running
statistics (the ``cbam`` and ``eca`` heads) and the gradient of a fixed
projection of the output with respect to the bands, to 1e-5 (f32, another
summation order).  D = 24 against ``output_dim`` 16 runs every per-band
projection ``proj_i``; one case of equal widths takes the identity.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from irw_tpu.models.fusion import get_fusion_head as jax_fusion_head
from irw_tpu_torch.bridge import load_jax_variables
from irw_tpu_torch.models.fusion import get_fusion_head
from test_torch_vit import randomize

TOL = 1e-5
B, S = 6, 4
TYPES = ("standard", "temperature", "self_attention", "semantic", "gated", "temperature_gated",
         "cross_attention_bottleneck", "cross_attention_advanced", "cbam", "eca")
CASES = [(t, 24, 16) for t in TYPES] + [("standard", 16, 16)]
IDS = [f"{t}-{d}to{e}" for t, d, e in CASES]

_PAIRS = {}


def numpy_init(module, *args, seed: int = 0, **kwargs):
    """Variables of ``module.init(rngs, *args, **kwargs)`` drawn with numpy
    from the shapes alone (``jax.eval_shape``): kernels N(0, 1/fan_in) with
    fan_in every axis but the last, tokens N(0, 0.02²), then ``randomize``'s
    biases, scales, LayerScale and statistics."""
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "dropout", "band_drop"))}
    shapes = jax.eval_shape(lambda: module.init(rngs, *args, **kwargs))
    rng = np.random.RandomState(seed)
    flat = {}
    for path, leaf in traverse_util.flatten_dict(jax.tree_util.tree_map(
            lambda a: a, dict(shapes))).items():
        shape = leaf.shape
        fan_in = math.prod(shape[:-1]) if len(shape) > 1 else 1
        std = 1.0 / math.sqrt(fan_in) if path[-1] == "kernel" else 0.02
        flat[path] = (std * rng.randn(*shape)).astype(np.float32)
    return randomize(traverse_util.unflatten_dict(flat), seed)


def head_pair(ftype, d_in, embed):
    """(JAX head, its variables, port head, bands, output weights) of one
    case, built once per module."""
    key = (ftype, d_in, embed)
    if key not in _PAIRS:
        cfg = {"type": ftype, "output_dim": embed, "num_heads": 2, "dropout": 0.0,
               "sub_band_dropout_p": 0.0, "temperature": 0.5, "ortho_weight": 0.1}
        rng = np.random.RandomState(len(_PAIRS))
        bands = rng.randn(B, S, d_in).astype(np.float32)
        jhead = jax_fusion_head(cfg, d_in)
        variables = numpy_init(jhead, jnp.asarray(bands), seed=len(_PAIRS))
        head = get_fusion_head(cfg, d_in, S)
        load_jax_variables(head, variables)
        _PAIRS[key] = (jhead, variables, head, bands, rng.randn(embed).astype(np.float32))
    return _PAIRS[key]


def _close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours, np.float32), np.asarray(ref, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("ftype,d_in,embed", CASES, ids=IDS)
def test_head_eval_matches_jax(ftype, d_in, embed):
    jhead, variables, head, bands, _ = head_pair(ftype, d_in, embed)
    assert (getattr(head, "proj", None) is None) == (d_in == embed or ftype in ("cbam", "eca"))
    ref, aux_ref = jax.jit(lambda v, x: jhead.apply(v, x, train=False))(variables,
                                                                         jnp.asarray(bands))
    head.eval()
    with torch.no_grad():
        out, aux = head(torch.from_numpy(bands))
    assert out.shape == (B, embed)
    _close(out, ref)
    assert set(aux) == set(aux_ref)
    for k in aux:
        _close(aux[k], aux_ref[k])


@pytest.mark.parametrize("ftype,d_in,embed", CASES, ids=IDS)
def test_head_training_matches_jax(ftype, d_in, embed):
    """Training mode: the output, the BatchNorm's new statistics, and the
    bands' gradient of out·w."""
    jhead, variables, head, bands, w = head_pair(ftype, d_in, embed)
    jx = jnp.asarray(bands)

    def jfwd(x, v):
        out, new = jhead.apply(v, x, train=True, mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(1),
                                     "band_drop": jax.random.PRNGKey(2)})
        return jnp.sum(out[0] * w), (out, new)

    (_, ((ref, aux_ref), new_ref)), gref = jax.jit(jax.value_and_grad(jfwd, has_aux=True))(
        jx, variables)
    stats = {k: v.clone() for k, v in head.state_dict().items() if "running" in k}
    x = torch.from_numpy(bands).requires_grad_(True)
    head.train()
    out, aux = head(x, {"dropout": torch.Generator().manual_seed(1),
                        "band_drop": torch.Generator().manual_seed(2)})
    (out * torch.from_numpy(w)).sum().backward()
    try:
        _close(out.detach(), ref)
        _close(x.grad, gref)
        for k in ("ortho_loss", "ortho_raw"):
            if k in aux_ref:
                _close(aux[k].detach(), aux_ref[k])
        if ftype in ("cbam", "eca"):
            bn = new_ref["batch_stats"]["BatchNorm_0"]
            _close(head.bn.running_mean, bn["mean"])
            _close(head.bn.running_var, bn["var"])
        else:
            assert not new_ref.get("batch_stats")
    finally:  # the eval case reads the statistics the bridge loaded
        head.load_state_dict({**head.state_dict(), **stats})


def test_gate_heads_pool_a_bf16_stack_in_bf16():
    """A bf16 band stack (an autocast backbone's) through the cbam head: the
    gate's pools are rounded to bf16 as the JAX gate's are, the rest in f32."""
    jhead, variables, head, bands, _ = head_pair("cbam", 24, 16)
    xb = jnp.asarray(bands, jnp.bfloat16)
    ref, aux_ref = jax.jit(lambda v, x: jhead.apply(v, x, train=False))(variables, xb)
    head.eval()
    with torch.no_grad():
        out, aux = head(torch.from_numpy(bands).bfloat16())
    assert out.dtype == torch.float32 and str(ref.dtype) == "float32"
    _close(out, ref)
    _close(aux["gate"], aux_ref["gate"])
