"""The port's flash attention (K6's plain versions) against JAX's library
``flash_attention`` in Pallas interpret mode, on lone tensors and through an
unbanded ``use_flash`` ViT; the bridge of ``attn_qkv``/``attn_out``; and the
Block's routing (``use_flash`` before ``vmem_attn``, no attention dropout).

The JAX side gets its inputs as ``_flash_mha`` builds them (vit.py:278-295):
(B, H, N, hd), padded to a multiple of 128 with segment ids 1 (valid) and 2
(padding).  N ∈ {37, 200, 257} gives 1, 2 and 3 key blocks; N = 37 runs the
library's one-step kernel.

Tolerances, of max|ref| per output: f32 1e-5 (the same block-wise math,
another summation order and ``exp``).  bf16: both sides round p to bf16
before p·v, and p, ds before the backward products; a one-ulp flip of a
rounded value moves an output by up to one bf16 ulp of its scale: the
forward to 2⁻⁷, each gradient to 2⁻⁶ (as K2 and K3).  The bf16 ViT: every intermediate is
rounded at slightly other places (XLA fuses elementwise chains in f32), so
the CLS tokens agree to 0.1 (as ``test_torch_vit``) and each parameter's
gradient points the same way (cosine ≥ 0.99).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jax_flash
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds

from irw_tpu.models.vit import VisionTransformer as JaxViT
from irw_tpu.models.vit import vit_config as jax_vit_config
from irw_tpu_torch.bridge import from_jax_variables, load_jax_variables
from irw_tpu_torch.models.factory import pop_common
from irw_tpu_torch.models.multi_dino import MultiDinoHashing
from irw_tpu_torch.models.vit import FlashAttention, VisionTransformer, make_vit, vit_config
from irw_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_plain,
    flash_attention_plain_autograd,
    flash_attention_plain_bwd,
)
from test_torch_multi_dino import flagship_yaml
from test_torch_vit import randomize

F32_TOL = 1e-5
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, dtype, seed):
    """q, k, v, do: unit normals scaled by 2 (sharper softmax rows), rounded
    to ``dtype`` once so both packages start from the same values."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(2 * rng.randn(*shape).astype(np.float32)).to(dtype) for _ in range(4)]


def _jax_flash(q, k, v, do, jdtype):
    """``_flash_mha``'s attention core on (B, N, H, hd) numpy inputs, in
    interpret mode: (o padded (B, Np, H, hd), (dq, dk, dv) (B, N, H, hd)), f32."""
    b, n, _, hd = q.shape
    pad = (-n) % 128
    prep = [jnp.pad(jnp.swapaxes(jnp.asarray(t).astype(jdtype), 1, 2),
                    ((0, 0), (0, 0), (0, pad), (0, 0))) for t in (q, k, v)]
    seg = jnp.concatenate([jnp.ones((b, n), jnp.int32), jnp.full((b, pad), 2, jnp.int32)], axis=1)
    ids = SegmentIds(q=seg, kv=seg) if pad else None

    def core(a, b_, c):
        return jax_flash.flash_attention(a, b_, c, segment_ids=ids, sm_scale=1.0 / hd ** 0.5)

    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(core, *prep)
        g = jnp.pad(jnp.swapaxes(jnp.asarray(do).astype(jdtype), 1, 2),
                    ((0, 0), (0, 0), (0, pad), (0, 0)))
        grads = vjp(g)
    o = np.asarray(jnp.swapaxes(o, 1, 2), np.float32)
    return o, [np.asarray(jnp.swapaxes(t[:, :, :n], 1, 2), np.float32) for t in grads]


def _close(ours, ref, rel):
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,hd", [(37, 32), (200, 64), (257, 64)])
def test_plain_matches_library_kernel(n, hd, dtype):
    """Forward, and l/m through the backward: the library's rows below N
    (the padded rows past N are never read)."""
    tdtype, jdtype = DTYPES[dtype]
    q, k, v, do = _inputs((2, n, 2, hd), tdtype, seed=n + hd)
    o_ref, grads_ref = _jax_flash(*(t.float().numpy() for t in (q, k, v, do)), jdtype)
    fwd_rel, bwd_rel = (F32_TOL, F32_TOL) if dtype == "float32" else (2 ** -7, 2 ** -6)
    o, l, m = flash_attention_plain(q, k, v, save_residuals=True)
    assert o.dtype == tdtype and l.shape == m.shape == (2, 2, n) and l.dtype == torch.float32
    _close(o, o_ref[:, :n], fwd_rel)
    for ours, ref in zip(flash_attention_plain_bwd(q, k, v, o, do, l, m), grads_ref):
        assert ours.dtype == tdtype and ours.shape == q.shape
        _close(ours, ref, bwd_rel)


def _library_residuals_and_vjp(q, k, v, do, jdtype):
    """The library forward's own residuals and its VJP rule fed them, in
    interpret mode, on inputs padded and segment-masked as ``_jax_flash``
    builds them: ``_flash_attention_impl`` with ``save_residuals`` at the
    default 128 × 128 blocks, then ``_flash_attention_bwd``.  Returns o
    (B, N, H, hd), l and m (B, H, N), and (dq, dk, dv) (B, N, H, hd), the
    rows below N, f32."""
    b, n, _, hd = q.shape
    pad = (-n) % 128

    def prep(t):
        return jnp.pad(jnp.swapaxes(jnp.asarray(t).astype(jdtype), 1, 2),
                       ((0, 0), (0, 0), (0, pad), (0, 0)))

    seg = jnp.concatenate([jnp.ones((b, n), jnp.int32), jnp.full((b, pad), 2, jnp.int32)], axis=1)
    ids = SegmentIds(q=seg, kv=seg) if pad else None
    scale = 1.0 / hd ** 0.5

    def run(qp, kp, vp, dop):
        o, l, m = jax_flash._flash_attention_impl(qp, kp, vp, None, ids, True, False, scale,
                                                  1, 128, 128, 128, False)
        blocks = jax_flash.BlockSizes.get_default(*qp.shape, hd)
        grads = jax_flash._flash_attention_bwd(False, False, scale, blocks, False,
                                               (qp, kp, vp, None, ids, o, l, m), dop)[:3]
        return o, l, m, grads

    with pltpu.force_tpu_interpret_mode():
        o, l, m, grads = jax.jit(run)(*(prep(t) for t in (q, k, v, do)))

    def unpad(t):
        return np.array(jnp.swapaxes(t[:, :, :n], 1, 2), np.float32)

    return (unpad(o), np.array(l[..., :n], np.float32), np.array(m[..., :n], np.float32),
            [unpad(t) for t in grads])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,hd", [(37, 32), (128, 64), (129, 32), (257, 64)])
def test_plain_residuals_are_the_library_kernels(n, hd, dtype):
    """What the backward reads: the plain forward's l and m against the
    library's own residuals (l 1e-5 relative, m 1e-6 absolute: unit-normal
    inputs keep |m| below 8, where an f32 ulp is under 1e-6), and the plain
    backward fed those residuals against the library's VJP at the limits
    above.  N = 128 is the one-step kernel's last size, 129 a last block
    with one valid key."""
    tdtype, jdtype = DTYPES[dtype]
    q, k, v, do = (t / 2 for t in _inputs((2, n, 2, hd), tdtype, seed=2 * n + hd))
    o_lib, l_lib, m_lib, grads_ref = _library_residuals_and_vjp(
        *(t.float().numpy() for t in (q, k, v, do)), jdtype)
    _, l, m = flash_attention_plain(q, k, v, save_residuals=True)
    np.testing.assert_allclose(l.numpy(), l_lib, rtol=1e-5, atol=0)
    np.testing.assert_allclose(m.numpy(), m_lib, rtol=0, atol=1e-6)
    bwd_rel = F32_TOL if dtype == "float32" else 2 ** -6
    grads = flash_attention_plain_bwd(q, k, v, torch.from_numpy(o_lib).to(tdtype), do,
                                      torch.from_numpy(l_lib), torch.from_numpy(m_lib))
    for ours, ref in zip(grads, grads_ref):
        _close(ours, ref, bwd_rel)


def test_wrappers_and_autograd_on_cpu_are_the_plain_versions():
    """On the CPU ``flash_attention`` (the kernel route) and the plain route
    give the plain forward and backward exactly, on strided views of one
    fused projection, and count no launch."""
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.randn(2, 130, 3, 2, 32).astype(np.float32))
    q, k, v = qkv.unbind(-3)
    do = torch.from_numpy(rng.randn(2, 130, 2, 32).astype(np.float32))
    o, l, m = flash_attention_plain(q, k, v, save_residuals=True)
    ref = flash_attention_plain_bwd(q, k, v, o, do, l, m)
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    for fn in (flash_attention, flash_attention_plain_autograd):
        leaf = qkv.clone().requires_grad_()
        out = fn(*leaf.unbind(-3))
        torch.testing.assert_close(out, o, rtol=0, atol=0)
        out.backward(do)
        torch.testing.assert_close(leaf.grad, torch.stack(ref, dim=-3), rtol=0, atol=0)
    with torch.no_grad():  # no gradient needed: no residuals
        torch.testing.assert_close(flash_attention(q, k, v), o, rtol=0, atol=0)
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == before


def _vit_pair(dtype, seed=0):
    """(JAX ViT, variables, port ViT, images): unbanded test_tiny, depth 2,
    ``use_flash``, unrolled blocks, no remat."""
    jmodel = JaxViT(**jax_vit_config("test_tiny", depth=2, use_flash=True, dtype=dtype))
    x = np.random.RandomState(seed).rand(2, 24, 24, 3).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    variables = randomize(variables, seed)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    model = make_vit("test_tiny", depth=2, img_size=24, use_flash=True, dtype=tdtype)
    load_jax_variables(model, variables)
    return jmodel, variables, model, x


def test_tiny_vit_bf16_cls_and_gradients_match_jax():
    jmodel, variables, model, x = _vit_pair(jnp.bfloat16)
    w = np.random.RandomState(1).randn(2, 64).astype(np.float32)

    def objective(params):
        cls, _ = jmodel.apply({"params": params}, jnp.asarray(x))
        return jnp.sum(cls.astype(jnp.float32) * w), cls

    with pltpu.force_tpu_interpret_mode():
        (_, cls_ref), grads_ref = jax.jit(jax.value_and_grad(objective, has_aux=True))(
            variables["params"])
    grads_ref = from_jax_variables({"params": grads_ref})
    assert isinstance(model.blocks[0].attn, FlashAttention)
    cls = model(torch.from_numpy(x))
    np.testing.assert_allclose(cls.float().detach().numpy(), np.asarray(cls_ref, np.float32),
                               atol=0.1, rtol=0)
    (cls.float() * torch.from_numpy(w)).sum().backward()
    for name, p in model.named_parameters():
        ours, ref = p.grad.numpy().ravel(), np.asarray(grads_ref[name], np.float32).ravel()
        if name.endswith("attn.qkv.bias"):  # the key bias: zero in exact arithmetic
            ours, ref = (np.delete(t, np.s_[64:128]) for t in (ours, ref))
        cos = ours @ ref / (np.linalg.norm(ours) * np.linalg.norm(ref))
        assert cos >= 0.99, (name, cos)


def _banded_flash_variables(monkeypatch, depth=2, **vit_kw):
    """The small banded flagship with ``use_flash``, initialised by JAX with
    the library kernel swapped for its plain reference (the banded model does
    not run in interpret mode); (variables, the port's model)."""
    from irw_tpu.models import get_model as jax_get_model
    from irw_tpu_torch.models import get_model

    monkeypatch.setattr(jax_flash, "flash_attention", jax_flash.mha_reference_no_custom_vjp)
    cfg = flagship_yaml()
    vit_kwargs = {"depth": depth, "use_flash": True, **vit_kw}
    jmodel = jax_get_model(cfg["name"], **dict(cfg["kwargs"], vit_kwargs=vit_kwargs))
    variables = jax.jit(lambda r, x: jmodel.init(r, x, train=False))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "band_drop": jax.random.PRNGKey(2)}, jnp.zeros((1, 4, 28, 28, 3)))
    model = get_model(cfg["name"], device="cpu",
                      **dict(cfg["kwargs"], vit_kwargs=dict(vit_kwargs, img_size=28)))
    return randomize(variables, 2), model


@pytest.mark.parametrize("scan_group", [1, 2])
def test_bridge_maps_attn_qkv_and_attn_out(monkeypatch, scan_group):
    """Banded, scanned (and grouped) ``use_flash`` trees: every leaf lands,
    shapes match, and band 2's block-1 projections are the JAX ones."""
    variables, model = _banded_flash_variables(monkeypatch, scan_group=scan_group)
    vit_tree = variables["params"]["BandedViT_0"]["VmapVisionTransformer_0"]["blocks"]
    if scan_group > 1:
        assert "inner" in vit_tree
        block = jax.tree_util.tree_map(lambda a: a.reshape(4, 2, *a.shape[3:]),
                                       vit_tree["inner"]["Block_0"])
    else:
        block = vit_tree["Block_0"]
    assert set(block) >= {"attn_qkv", "attn_out"} and "attn" not in block
    sd = from_jax_variables(variables)
    assert set(sd) == set(model.state_dict())
    load_jax_variables(model, variables)
    ours = model.state_dict()
    kernel, bias = block["attn_qkv"]["kernel"][2, 1], block["attn_qkv"]["bias"][2, 1]
    assert kernel.shape == (384, 3, 6, 64) and bias.shape == (3, 6, 64)
    prefix = "backbone.vit.blocks.1.attn"
    np.testing.assert_array_equal(ours[f"{prefix}.qkv.weight"][2].numpy(), kernel.reshape(384, -1).T)
    np.testing.assert_array_equal(ours[f"{prefix}.qkv.bias"][2].numpy(), bias.reshape(-1))
    np.testing.assert_array_equal(ours[f"{prefix}.out.weight"][2].numpy(),
                                  block["attn_out"]["kernel"][2, 1].T)
    np.testing.assert_array_equal(ours[f"{prefix}.out.bias"][2].numpy(),
                                  block["attn_out"]["bias"][2, 1])


def test_use_flash_wins_over_vmem_attn_and_drops_no_attention():
    # the factory turns vmem_attn on for unfrozen backbones on the card
    # (factory.py:55); the flash route must still be taken
    cfg = flagship_yaml()
    kw = pop_common(dict(cfg["kwargs"], vit_kwargs={"depth": 1, "use_flash": True,
                                                    "img_size": 28}), torch.device("cuda"))
    assert kw["vit_kwargs"]["vmem_attn"] and kw["vit_kwargs"]["use_flash"]
    model = MultiDinoHashing(**{k: v for k, v in kw.items()
                                if k in ("backbone", "fusion_config", "nbits", "use_bn",
                                         "frozen_backbone", "vit_kwargs")})
    attn = model.backbone.vit.blocks[0].attn
    assert isinstance(attn, FlashAttention) and attn.core is flash_attention
    assert dict(attn.named_parameters()).keys() == {"qkv.weight", "qkv.bias", "out.weight",
                                                    "out.bias"}
    assert attn.qkv.weight.shape == (4, 3 * 384, 384)
    # training with dropout: the MLP drops, the flash attention does not
    vit = VisionTransformer(**vit_config("test_tiny", depth=1, img_size=16, use_flash=True,
                                         dropout=0.5, vmem_attn=True))
    vit.reset_parameters(torch.Generator().manual_seed(0))
    vit.train()
    blk = vit.blocks[0]
    y = torch.from_numpy(np.random.RandomState(0).randn(2, 5, 64).astype(np.float32))
    a, b = (blk.attn(y, torch.Generator().manual_seed(s)) for s in (0, 1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    m1, m2 = (blk.mlp(y, torch.Generator().manual_seed(s)) for s in (0, 1))
    assert not torch.equal(m1, m2)
