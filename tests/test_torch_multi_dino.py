"""The port's MultiDinoHashing against irw_tpu's, same weights, eval mode.

Small flagship: the flagship YAML's kwargs (4 × dinov2_vits14 at full width,
cross_attention_advanced fusion, 64 bits) cut to depth 2 on 28² bands.
Weights: the JAX init with biases, norm scales, LayerScale (near 1) and
BatchNorm statistics redrawn with numpy, carried across by the bridge.

Tolerances: f32 logits and aux to 1e-4.  bf16 backbones (the flagship's
``with_autocast``) round differently in the two frameworks: there the
codes must agree wherever |logit| > 0.05 and the logits to 0.05.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from irw_tpu.models import get_model as jax_get_model
from irw_tpu_torch.bridge import from_jax_variables, load_jax_variables
from irw_tpu_torch.models import get_model
from irw_tpu_torch.models.fusion import CrossAttentionBottleneckHead
from test_torch_vit import randomize

YAML = Path(__file__).resolve().parents[1] / "configs/model/multidino_attention_hashing_ortho.yaml"
F32_TOL = 1e-4
BF16_MARGIN = 0.05


def flagship_yaml():
    with open(YAML) as f:
        return yaml.safe_load(f)


def build_pair(vit_kwargs, seed=0, batch=3, img=28, fusion=None):
    """(JAX model, JAX variables, port model, bands) for the small flagship;
    ``fusion`` overrides keys of its fusion config."""
    cfg = flagship_yaml()
    kw = dict(cfg["kwargs"], vit_kwargs=dict(vit_kwargs))
    if fusion:
        kw["fusion_config"] = dict(kw["fusion_config"], **fusion)
    jmodel = jax_get_model(cfg["name"], **kw)
    bands = np.random.RandomState(seed).randn(batch, 4, img, img, 3).astype(np.float32)
    rngs = {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1),
            "band_drop": jax.random.PRNGKey(2)}
    variables = jax.jit(lambda r, x: jmodel.init(r, x, train=False))(rngs, jnp.asarray(bands))
    variables = randomize(variables, seed)
    model = get_model(cfg["name"], device="cpu", **dict(kw, vit_kwargs=dict(vit_kwargs, img_size=img)))
    load_jax_variables(model, variables)
    return jmodel, variables, model, bands


def jax_eval(jmodel, variables, bands):
    """(codes, aux, pre-sign logits) of the JAX model in eval mode."""
    (codes, aux), inter = jmodel.apply(variables, jnp.asarray(bands), train=False,
                                       capture_intermediates=True, mutable=["intermediates"])
    logits = inter["intermediates"]["HashHead_0"]["__call__"][0]
    return np.asarray(codes), {k: np.asarray(v) for k, v in aux.items()}, np.asarray(logits)


@pytest.mark.parametrize("fusion", [
    None,  # the flagship: cross_attention_advanced at the backbone width
    # the other mode, narrower than the backbone: per-band projections first
    {"type": "cross_attention_bottleneck", "output_dim": 128, "num_heads": 4},
])
def test_eval_parity_f32_kernel_route(fusion):
    jmodel, variables, model, bands = build_pair({"depth": 2, "dtype": "float32",
                                                  "vmem_attn": True}, fusion=fusion)
    assert (model.head.proj is None) == (fusion is None)
    codes_ref, aux_ref, logits_ref = jax_eval(jmodel, variables, bands)
    with torch.no_grad():
        logits, aux = model.forward_logits(torch.from_numpy(bands))
        codes, _ = model(torch.from_numpy(bands))
    np.testing.assert_allclose(logits.numpy(), logits_ref, atol=F32_TOL, rtol=F32_TOL)
    assert set(aux) == set(aux_ref) == {"ortho_loss", "ortho_raw", "attn_weights"}
    for key in aux:
        np.testing.assert_allclose(aux[key].numpy(), aux_ref[key], atol=F32_TOL, rtol=F32_TOL)
    sure = np.abs(logits_ref) > 1e-3
    np.testing.assert_array_equal(codes.numpy()[sure], codes_ref[sure])
    torch.testing.assert_close(codes, torch.sign(logits))


def test_eval_parity_bf16_codes_agree_past_margin():
    jmodel, variables, model, bands = build_pair({"depth": 2}, seed=1)  # bf16 from YAML
    assert model.backbone.vit.dtype == torch.bfloat16
    codes_ref, aux_ref, logits_ref = jax_eval(jmodel, variables, bands)
    with torch.no_grad():
        codes, aux = model(torch.from_numpy(bands))
        logits, _ = model.forward_logits(torch.from_numpy(bands))
    np.testing.assert_allclose(logits.numpy(), logits_ref, atol=BF16_MARGIN, rtol=0)
    sure = np.abs(logits_ref) > BF16_MARGIN
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(codes.numpy()[sure], codes_ref[sure])
    np.testing.assert_allclose(aux["attn_weights"].numpy(), aux_ref["attn_weights"],
                               atol=BF16_MARGIN, rtol=0)


def test_bridge_shapes_round_trip():
    _, variables, model, _ = build_pair({"depth": 2}, seed=2, batch=1)
    sd = from_jax_variables(variables)
    ours = model.state_dict()
    assert set(sd) == set(ours)
    for key, value in sd.items():
        assert tuple(value.shape) == tuple(ours[key].shape), key
        if value.dtype.kind == "f":  # loaded values are the converted ones
            np.testing.assert_array_equal(ours[key].numpy(), value)
    n_jax = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(variables))
    assert sum(v.size for k, v in sd.items() if not k.endswith("num_batches_tracked")) == n_jax
    # band axis 0: band 2's block-1 query kernel is the JAX (D, H, hd) one, transposed
    qk = variables["params"]["BandedViT_0"]["VmapVisionTransformer_0"]["blocks"][
        "Block_0"]["attn"]["query"]["kernel"][2, 1]
    np.testing.assert_array_equal(
        ours["backbone.vit.blocks.1.attn.query.weight"][2].numpy(), qk.reshape(384, 384).T)
    np.testing.assert_array_equal(ours["hash_head.bn.running_var"].numpy(),
                                  variables["batch_stats"]["HashHead_0"]["BatchNorm_0"]["var"])


def test_factory_builds_flagship_from_yaml():
    cfg = flagship_yaml()
    model = get_model(cfg["name"], device="cpu", **dict(cfg["kwargs"], vit_kwargs={"depth": 1}))
    vit = model.backbone.vit
    assert vit.dtype == torch.bfloat16 and vit.embed_dim == 384
    assert vit.cls_token.shape == (4, 1, 384) and vit.pos_embed.shape == (4, 257, 384)
    attn = vit.blocks[0].attn
    assert attn.num_heads == 6
    # unfrozen backbones → vmem_attn only on the card (factory.py:106)
    assert attn.core.__name__ == "dot_product_attention"
    head = model.head
    assert isinstance(head, CrossAttentionBottleneckHead) and head.advanced
    assert head.num_queries == 4 and head.core.attn.num_heads == 8
    assert head.ortho_weight == 0.01 and head.proj is None
    assert model.hash_head.linear.weight.shape == (64, 384)
    assert not model.training


def test_chip_smoke_config_equals_yaml():
    import chip_smoke

    cfg = flagship_yaml()
    assert chip_smoke.FLAGSHIP == {"name": cfg["name"], "kwargs": cfg["kwargs"]}
    configs = YAML.parents[1]
    for name, path in (("HASH_LOSS", "loss/hash_loss.yaml"), ("OPTIMIZER", "optimizer/basic.yaml")):
        with open(configs / path) as f:
            assert getattr(chip_smoke, name) == yaml.safe_load(f), name
    with open(configs / "experience/default.yaml") as f:
        experience = yaml.safe_load(f)
    with open(YAML.parents[2] / "studies/voc_lambda_protocol.yaml") as f:
        protocol = yaml.safe_load(f)["base_overrides"]
    assert "experience.clip_grad=null" in protocol and "experience.sub_batch=96" in protocol
    assert chip_smoke.PROTOCOL == {"clip_grad": None, "warm_up": experience["warm_up"],
                                   "ortho_scale": experience["ortho_scale"]}
    assert "dataset.sampler.kwargs.batch_size=96" in protocol and chip_smoke.TRAIN_BATCH == 96


def test_training_mode_waits_for_the_training_slice():
    """The training slice has landed: ``.train()`` trains.  Logits, not
    codes, the advanced head's ortho term, BatchNorm batch statistics with
    updated running statistics, and gradients through the remat'd banded
    backbone; back in eval mode the model serves codes again."""
    cfg = flagship_yaml()
    model = get_model(cfg["name"], device="cpu", **dict(cfg["kwargs"],
                                                        vit_kwargs={"depth": 1, "img_size": 28}))
    assert model.backbone.vit.remat_blocks and not model.frozen_backbone
    model.train()
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 4, 28, 28, 3).astype(np.float32))
    rngs = {"dropout": torch.Generator().manual_seed(1),
            "band_drop": torch.Generator().manual_seed(2)}
    var_before = model.hash_head.bn.running_var.clone()
    logits, aux = model(x, rngs)
    assert logits.shape == (3, 64) and not torch.isin(logits.detach(), torch.tensor([-1.0, 1.0])).all()
    assert aux["ortho_raw"].item() > 0
    assert aux["ortho_loss"].item() == pytest.approx(0.01 * aux["ortho_raw"].item())
    assert not torch.equal(model.hash_head.bn.running_var, var_before)
    (logits.sum() + aux["ortho_loss"]).backward()
    vit = model.backbone.vit
    for p in (vit.patch_embed.weight, vit.blocks[0].norm1.weight, vit.blocks[0].attn.query.weight,
              model.head.query_tokens, model.hash_head.bn.weight):
        assert p.grad is not None and p.grad.abs().sum() > 0
    model.eval()
    with torch.no_grad():
        codes, aux = model(x)
    assert torch.isin(codes, torch.tensor([-1.0, 1.0])).all() and aux["ortho_raw"] == 0
