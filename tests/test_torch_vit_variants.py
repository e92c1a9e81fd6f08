"""The ViT Block variants ``fused_qkv``, ``split_cls`` and ``ln_fused`` of
the port against irw_tpu's, same weights through the bridge, on the CPU.

- each variant as an unbanded ViT (test_tiny; N = 257 and N = 10 tokens at
  width 64, the shapes ``tests/test_models.py`` holds ``split_cls`` at; the
  scanned dinov2_vits14 in bf16) and as the banded small flagship (4 bands);
- ``fused_layernorm``: forward and its three gradients against ``jax.vjp`` of
  ``irw_tpu.ops.fused_ln.fused_layernorm``, and what its autograd function
  saves;
- one train step pair of the small flagship with ``ln_fused`` against
  ``irw_tpu``'s train step, as ``test_torch_train_step``;
- the A/B slice: the tiny frozen flagship's three variants (``stock``,
  ``vmem``, ``vmem+ln``) through ``benchmarks.infer_vmem_ab``'s pipeline,
  codes equal to the JAX model's.

Tolerances: f32 outputs to 1e-5 where the ViT is two blocks of width 64 and
to ``test_torch_vit``'s 1e-4 for the 257-token and banded full-width cases
(same math, another summation order, longer sums); bf16 outputs to
``test_torch_vit``'s 0.1 and codes wherever |logit| > 0.05, as
``test_torch_multi_dino``.  ``fused_layernorm``: f32 1e-5 of max(1, max|ref|);
bf16 2^-7 of max(1, max|ref|), one bf16 ulp of the largest value (both sides
compute y and dx in f32 and round once; dscale and dbias are f32 sums of the
same bf16 inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from irw_tpu.models import get_model as jax_get_model
from irw_tpu.models.vit import VisionTransformer as JaxViT
from irw_tpu.models.vit import vit_config as jax_vit_config
from irw_tpu.ops.fused_ln import fused_layernorm as jax_fused_layernorm
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu_torch.benchmarks import infer_vmem_ab
from irw_tpu_torch.bridge import from_jax_variables, load_jax_variables
from irw_tpu_torch.models import get_model
from irw_tpu_torch.models.layers import LayerNorm
from irw_tpu_torch.models.vit import (
    Attention,
    Block,
    FlashAttention,
    FusedMHA,
    SplitCLSMHA,
    make_vit,
)
from irw_tpu_torch.ops.attention import dot_product_attention, vmem_attention_fn
from irw_tpu_torch.ops.fused_ln import FusedLayerNorm, fused_layernorm
from test_torch_multi_dino import BF16_MARGIN, build_pair, jax_eval
from test_torch_train_step import STEPS, check_step_metrics, check_step_updates, run_steps
from test_torch_vit import BF16_TOL, F32_TOL, _pair, randomize

VARIANTS = ("fused_qkv", "split_cls", "ln_fused")
TIGHT_F32 = 1e-5
# width 64, 4 heads, patch 8: 16 x 16 + 1 = 257 tokens at 128², 3 x 3 + 1 = 10 at 24²
WIDE = dict(embed_dim=64, depth=1, num_heads=4, patch_size=8)


@pytest.mark.parametrize("flag", VARIANTS)
def test_variant_tiny_f32(flag):
    ours, ref, _ = _pair("test_tiny", 16, False, **{flag: True})
    assert ours.shape == ref.shape == (2, 64)
    np.testing.assert_allclose(ours, ref, atol=TIGHT_F32, rtol=TIGHT_F32)


@pytest.mark.parametrize("img,tokens", [(128, 257), (24, 10)])
@pytest.mark.parametrize("flag", VARIANTS)
def test_variant_token_counts_f32(flag, img, tokens):
    ours, ref, variables = _pair("test_tiny", img, False, batch=1, seed=1, **WIDE, **{flag: True})
    assert variables["params"]["pos_embed"].shape == (1, tokens, 64)
    np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("flag", VARIANTS)
def test_variant_vits14_scanned_bf16(flag):
    ours, ref, variables = _pair("dinov2_vits14", 28, flag == "ln_fused", dtype=jnp.bfloat16,
                                 depth=2, **{flag: True})
    assert "blocks" in variables["params"]
    np.testing.assert_allclose(ours, ref, atol=BF16_TOL, rtol=0)


@pytest.mark.parametrize("flag", VARIANTS)
def test_variant_banded_f32(flag):
    jmodel, variables, model, bands = build_pair({"depth": 2, "dtype": "float32", flag: True})
    _, _, logits_ref = jax_eval(jmodel, variables, bands)
    with torch.no_grad():
        logits, _ = model.forward_logits(torch.from_numpy(bands))
    np.testing.assert_allclose(logits.numpy(), logits_ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("flag", VARIANTS)
def test_variant_banded_bf16_codes_agree_past_margin(flag):
    jmodel, variables, model, bands = build_pair({"depth": 2, flag: True}, seed=1)
    assert model.backbone.vit.dtype == torch.bfloat16
    codes_ref, _, logits_ref = jax_eval(jmodel, variables, bands)
    with torch.no_grad():
        codes, _ = model(torch.from_numpy(bands))
        logits, _ = model.forward_logits(torch.from_numpy(bands))
    np.testing.assert_allclose(logits.numpy(), logits_ref, atol=BF16_MARGIN, rtol=0)
    sure = np.abs(logits_ref) > BF16_MARGIN
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(codes.numpy()[sure], codes_ref[sure])


@pytest.mark.parametrize("flag", VARIANTS)
def test_variants_keep_the_mha_parameter_tree(flag):
    """The three variants have the default Block's flax parameter tree, so
    the bridge needs no new layout: the same state-dict keys and values, and
    the port's variant modules take them strictly."""
    x = jnp.zeros((1, 16, 16, 3))
    trees = {}
    for on in (False, True):
        jmodel = JaxViT(**jax_vit_config("test_tiny", **{flag: on}))
        trees[on] = from_jax_variables(jax.jit(jmodel.init)(jax.random.PRNGKey(3), x))
    assert trees[True].keys() == trees[False].keys()
    for key in trees[True]:
        np.testing.assert_array_equal(trees[True][key], trees[False][key])
    model = make_vit("test_tiny", img_size=16, **{flag: True})
    assert set(model.state_dict()) == set(trees[True])
    assert {"blocks.0.attn.query.weight", "blocks.0.attn.out.bias",
            "blocks.0.norm1.weight", "norm.bias"} <= set(trees[True])


def test_block_routing_order():
    """quant_int8 → use_flash → split_cls → fused_qkv → MHA with or without
    vmem_attn (irw_tpu/models/vit.py:345-374)."""
    kw = dict(dim=64, num_heads=2)
    assert isinstance(Block(**kw, use_flash=True, split_cls=True, fused_qkv=True,
                            vmem_attn=True).attn, FlashAttention)
    assert isinstance(Block(**kw, split_cls=True, fused_qkv=True, vmem_attn=True).attn, SplitCLSMHA)
    assert isinstance(Block(**kw, fused_qkv=True, vmem_attn=True).attn, FusedMHA)
    plain, kernel = Block(**kw).attn, Block(**kw, vmem_attn=True).attn
    assert type(plain) is type(kernel) is Attention
    assert plain.core is dot_product_attention and kernel.core is vmem_attention_fn
    blk = Block(**kw, ln_fused=True)
    assert isinstance(blk.norm1, FusedLayerNorm) and isinstance(blk.norm2, FusedLayerNorm)
    assert isinstance(Block(**kw).norm1, LayerNorm)
    vit = make_vit("test_tiny", img_size=16, ln_fused=True, bands=4)
    assert isinstance(vit.norm, FusedLayerNorm) and vit.norm.weight.shape == (4, 64)


@pytest.mark.parametrize("cls", [FusedMHA, SplitCLSMHA])
def test_variant_attention_dropout_is_live_in_training_only(cls):
    torch.manual_seed(0)
    attn = cls(32, 2, dropout=0.5)
    for proj in (attn.query, attn.key, attn.value, attn.out):
        proj.reset_parameters(torch.Generator().manual_seed(1))
    y = torch.randn(2, 6, 32)
    with torch.no_grad():
        quiet = attn.eval()(y, torch.Generator().manual_seed(2))
        a = attn.train()(y, torch.Generator().manual_seed(2))
        b = attn.train()(y, torch.Generator().manual_seed(2))
        c = attn.train()(y, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)   # the generator decides the masks
    assert not torch.equal(a, quiet) and not torch.equal(a, c)
    assert torch.isfinite(a).all()


# ---------------------------------------------------------------- fused_layernorm

def _ln_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32) * 2.0 + 0.5,
            (1.0 + 0.1 * rng.randn(shape[-1])).astype(np.float32),
            (0.1 * rng.randn(shape[-1])).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 7, 64), (2, 3, 5, 32)])
def test_fused_layernorm_forward_and_gradients_match_jax_vjp(shape, bf16):
    x, scale, bias, dy = _ln_inputs(shape, seed=len(shape))
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32, jnp.float32)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ts, tb = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))   # f32 parameters
    tdy = torch.from_numpy(dy).to(tdt)
    y = fused_layernorm(tx, ts, tb, 1e-6, tdt)
    y.backward(tdy)
    jx, jdy = (jnp.asarray(t.detach().float().numpy()).astype(jdt) for t in (tx, tdy))
    ref_y, vjp = jax.vjp(lambda a, s, b: jax_fused_layernorm(a, s, b, 1e-6, jdt),
                         jx, jnp.asarray(scale), jnp.asarray(bias))
    pairs = {"y": (y, ref_y), **{name: (t.grad, g) for name, t, g in
                                 zip(("dx", "dscale", "dbias"), (tx, ts, tb), vjp(jdy))}}
    for name, (ours, ref) in pairs.items():
        ref = np.asarray(ref, np.float32)
        assert tuple(ours.shape) == ref.shape, name
        peak = max(1.0, np.abs(ref).max())
        tol = (2 ** -7 * peak) if bf16 else TIGHT_F32 * peak
        np.testing.assert_allclose(ours.detach().float().numpy(), ref, atol=tol, rtol=0,
                                   err_msg=name)
    assert y.dtype == tx.grad.dtype == tdt and ts.grad.dtype == tb.grad.dtype == torch.float32


def test_fused_layernorm_saves_exactly_x_and_scale():
    x, scale, bias, _ = _ln_inputs((4, 9, 32), seed=5)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    ts, tb = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))
    y = fused_layernorm(tx, ts, tb)
    assert y.dtype == torch.bfloat16                      # out_dtype defaults to x's
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 2
    assert saved[0].data_ptr() == tx.data_ptr() and saved[1].data_ptr() == ts.data_ptr()


def test_fused_layernorm_under_block_checkpoint():
    """``torch.utils.checkpoint`` refuses a second unpack of the saved
    tensors: the backward unpacks them once."""
    x, scale, bias, dy = _ln_inputs((2, 5, 16), seed=6)
    ln = FusedLayerNorm(16)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    tx = torch.from_numpy(x).requires_grad_()
    checkpoint(lambda t: ln(t) * 2.0, tx, use_reentrant=False).backward(torch.from_numpy(dy))
    direct = torch.from_numpy(x).requires_grad_()
    grads = torch.autograd.grad(ln(direct) * 2.0, (direct, ln.weight), torch.from_numpy(dy))
    torch.testing.assert_close(tx.grad, grads[0], rtol=0, atol=0)
    torch.testing.assert_close(ln.weight.grad, grads[1], rtol=0, atol=0)


def test_fused_layernorm_module_matches_the_plain_module_per_band():
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(4, 2, 5, 32).astype(np.float32))
    plain, fused = LayerNorm(32, bands=4), FusedLayerNorm(32, bands=4)
    with torch.no_grad():
        plain.weight.copy_(torch.from_numpy(1.0 + 0.1 * rng.randn(4, 32).astype(np.float32)))
        plain.bias.copy_(torch.from_numpy(0.1 * rng.randn(4, 32).astype(np.float32)))
    fused.load_state_dict(plain.state_dict())
    torch.testing.assert_close(fused(x), plain(x), rtol=1e-5, atol=1e-5)
    g = torch.from_numpy(rng.randn(4, 2, 5, 32).astype(np.float32))
    for mod in (plain, fused):
        mod(x).backward(g)
    torch.testing.assert_close(fused.weight.grad, plain.weight.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fused.bias.grad, plain.bias.grad, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- training with ln_fused

@pytest.fixture(scope="module")
def ln_steps():
    steps = run_steps({"depth": 2, "dtype": "float32", "vmem_attn": True, "ln_fused": True})
    vit = steps[3].model.backbone.vit
    assert vit.remat_blocks and isinstance(vit.blocks[0].norm1, FusedLayerNorm)
    assert isinstance(vit.norm, FusedLayerNorm)
    return steps


def test_ln_fused_step_metrics_match_jax(ln_steps):
    check_step_metrics(ln_steps)


@pytest.mark.parametrize("i", range(STEPS))
def test_ln_fused_step_updates_match_jax(ln_steps, i):
    check_step_updates(ln_steps, i)


# ---------------------------------------------------------------- the A/B slice

TINY_AB = dict(backbone="test_tiny", nbits=16, embed_dim=64, num_heads=2, dtype="float32")
IMG = 16


@pytest.fixture(scope="module")
def ab_reference():
    """The tiny frozen flagship of the A/B on the JAX side: one set of
    variables (the stock variant's init, redrawn) for all three variants."""
    def build(flags):
        return jax_get_model(
            "multidino_attention_hashing_ortho", backbone=TINY_AB["backbone"], nbits=16,
            frozen_backbone=True, vit_kwargs={"dtype": "float32", **flags},
            fusion_config={"type": "cross_attention_advanced", "output_dim": 64,
                           "num_queries": 4, "num_heads": 2, "ortho_weight": 0.01})

    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "band_drop": jax.random.PRNGKey(2)}
    variables = jax.jit(lambda r, x: build({}).init(r, x, train=False))(
        rngs, jnp.zeros((1, 4, IMG, IMG, 3)))
    images = np.random.RandomState(4).randint(0, 255, (6, IMG, IMG, 3), dtype=np.uint8)
    return build, randomize(variables, 4), images


@pytest.mark.parametrize("label,flags", infer_vmem_ab.VARIANTS, ids=[v[0] for v in infer_vmem_ab.VARIANTS])
def test_ab_slice_codes_match_jax(ab_reference, label, flags):
    build, variables, images = ab_reference
    bands = JaxDeviceTransform([("SWTTransform", {"level": 1, "wavelet": "haar"})])(
        jnp.asarray(images))
    ref, _ = build(flags).apply(variables, bands, train=False)
    model, pipeline = infer_vmem_ab.build_pipeline("cpu", vit_kwargs={"img_size": IMG},
                                                   **TINY_AB, **flags)
    load_jax_variables(model, variables)
    vit = model.backbone.vit
    assert model.frozen_backbone and not vit.remat_blocks
    # vmem_attn given explicitly reaches the frozen backbone's blocks
    assert vit.blocks[0].attn.core is (vmem_attention_fn if flags.get("vmem_attn")
                                       else dot_product_attention)
    assert isinstance(vit.norm, FusedLayerNorm) == bool(flags.get("ln_fused"))
    codes = pipeline(images)
    assert codes.shape == (6, 16) and set(np.unique(codes.numpy())) <= {-1.0, 1.0}
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref))


def test_ab_sweep_runs_on_the_cpu_when_asked():
    res = infer_vmem_ab.run(batches=(2, 3), iters=1, device="cpu", image_size=IMG,
                            vit_kwargs={"img_size": IMG}, **TINY_AB)
    assert [(r["variant"], r["batch"]) for r in res] == [
        (v, b) for v in ("stock", "vmem", "vmem+ln") for b in (2, 3)]
    for r in res:
        assert set(r) == {"variant", "batch", "ips", "ms", "mfu", "peak"}
        assert r["ips"] > 0 and r["ms"] > 0 and r["mfu"] is None and r["peak"] == "cpu"


def test_factory_keeps_an_explicit_vmem_attn_on_a_frozen_backbone():
    """The reference dialect turns ``vmem_attn`` on only for unfrozen
    backbones on the card; given explicitly it reaches a frozen one too."""
    kw = {"backbones_config": [{"name": "test_tiny", "frozen": True}] * 4,
          "fusion_config": {"type": "cross_attention_advanced", "output_dim": 64, "num_heads": 2}}
    default = get_model("MultiDinoHashing", device="cpu", **kw, vit_kwargs={"img_size": IMG})
    asked = get_model("MultiDinoHashing", device="cpu", **kw,
                      vit_kwargs={"img_size": IMG, "vmem_attn": True, "ln_fused": True,
                                  "fused_qkv": False, "split_cls": False})
    assert default.frozen_backbone and asked.frozen_backbone
    assert default.backbone.vit.blocks[0].attn.core is dot_product_attention
    assert asked.backbone.vit.blocks[0].attn.core is vmem_attention_fn
    assert isinstance(asked.backbone.vit.blocks[1].norm2, FusedLayerNorm)
