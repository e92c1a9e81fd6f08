"""The port's training-mode model against irw_tpu's, same weights.

Small flagship: the flagship YAML's kwargs (4 × dinov2_vits14 at full width,
cross_attention_advanced fusion, 64 bits, unfrozen: block remat) cut to
depth 2 on 28² bands, attention on the kernel route (Pallas interpret mode
on the JAX side), fusion dropout 0 (the two frameworks' random bits cannot
match).  Weights: ``test_torch_multi_dino.build_pair``.

Tolerances: f32 logits, aux and BatchNorm running statistics to 1e-4;
per-leaf gradients of HashLoss + ortho to 1e-4 of each leaf's largest
gradient (same math, another summation order through two remat'd blocks).
In bf16 the two frameworks round at other places: the loss agrees to 1e-2
relative and the gradients point the same way (cosine ≥ 0.99).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.losses.base import LossContext as JaxLossContext
from irw_tpu.losses.hashing import HashLoss as JaxHashLoss
from irw_tpu_torch.bridge import from_jax_variables
from irw_tpu_torch.losses import HashLoss, LossContext
from irw_tpu_torch.models.layers import apply_dropout
from irw_tpu_torch.models.vit import VisionTransformer, vit_config
from irw_tpu_torch.ops.attention import dot_product_attention
from test_torch_multi_dino import build_pair

F32_TOL = 1e-4
NO_DROPOUT = {"dropout": 0.0}
VK_F32 = {"depth": 2, "dtype": "float32", "vmem_attn": True}
# gradients that are zero in exact arithmetic, where both sides hold rounding
# noise: the key biases (softmax is shift-invariant along the keys) and the
# head's last LayerNorm bias (the training BatchNorm removes any shift that
# is the same for the whole batch)
EXACT_ZEROS = ("attn.key.bias", "head.norm2.bias")


def _labels(batch, seed=0):
    labels = (np.random.RandomState(seed).rand(batch, 20) > 0.8).astype(np.float32)
    labels[:, 0] = 1.0  # every image has a positive
    return labels


def _jax_train(jmodel, variables, bands):
    rngs = {"dropout": jax.random.PRNGKey(1), "band_drop": jax.random.PRNGKey(2)}
    return jmodel.apply(variables, bands, train=True, mutable=["batch_stats"], rngs=rngs)


def _jax_train_jit(jmodel, variables, bands):
    return jax.jit(lambda v, x: _jax_train(jmodel, v, x))(variables, jnp.asarray(bands))


def _rngs():
    return {"dropout": torch.Generator().manual_seed(1),
            "band_drop": torch.Generator().manual_seed(2)}


def _losses(seed=0):
    """(JAX HashLoss, its proxies, the port's HashLoss with the same proxies)."""
    jloss = JaxHashLoss(num_classes=20, embedding_size=64, quant_weight=0.1, scale=15.0)
    proxies = jloss.init_params(jax.random.PRNGKey(seed))
    loss = HashLoss(num_classes=20, embedding_size=64, quant_weight=0.1, scale=15.0)
    with torch.no_grad():
        loss.proxies.copy_(torch.from_numpy(np.array(proxies["proxies"])))
    return jloss, proxies, loss


def _jax_grads(jmodel, variables, bands, labels, jloss, proxies):
    def objective(params):
        (logits, aux), _ = _jax_train(jmodel, {**variables, "params": params}, jnp.asarray(bands))
        value, _ = jloss(JaxLossContext(embeddings=logits, labels=jnp.asarray(labels)), proxies)
        return value + aux["ortho_loss"]

    value, grads = jax.jit(jax.value_and_grad(objective))(variables["params"])
    # map the gradient tree onto the port's parameter names
    named = from_jax_variables({"params": grads, "batch_stats": variables["batch_stats"]})
    return float(value), named


def _port_grads(model, bands, labels, loss):
    model.train()
    model.zero_grad(set_to_none=True)
    logits, aux = model(torch.from_numpy(bands), _rngs())
    value, _ = loss(LossContext(embeddings=logits, labels=torch.from_numpy(labels)))
    total = value + aux["ortho_loss"]
    total.backward()
    return total.item(), {name: p.grad for name, p in model.named_parameters()}


@pytest.fixture(scope="module")
def f32_pair():
    return build_pair(VK_F32, batch=4, fusion=NO_DROPOUT)


def test_train_forward_matches_jax(f32_pair):
    jmodel, variables, model, bands = f32_pair
    (logits_ref, aux_ref), new_vars = _jax_train_jit(jmodel, variables, bands)
    model.train()
    stats_before = model.hash_head.bn.running_mean.clone()
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(bands), _rngs())
    assert model.backbone.vit.remat_blocks and model.backbone.vit.blocks[0].attn.core.__name__ == \
        "vmem_attention_fn"
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref), atol=F32_TOL, rtol=F32_TOL)
    assert set(aux) == set(aux_ref)
    assert float(aux_ref["ortho_raw"]) > 0  # the training term is live
    for key in aux:
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(aux_ref[key]), atol=F32_TOL,
                                   rtol=F32_TOL)
    # flax BatchNorm: momentum 0.99 and the biased batch variance
    stats = new_vars["batch_stats"]["HashHead_0"]["BatchNorm_0"]
    assert not torch.equal(model.hash_head.bn.running_mean, stats_before)
    np.testing.assert_allclose(model.hash_head.bn.running_mean.numpy(), np.asarray(stats["mean"]),
                               atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(model.hash_head.bn.running_var.numpy(), np.asarray(stats["var"]),
                               atol=F32_TOL, rtol=F32_TOL)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in from_jax_variables(variables).items()})


def test_gradients_match_jax(f32_pair):
    jmodel, variables, model, bands = f32_pair
    labels = _labels(bands.shape[0])
    jloss, proxies, loss = _losses()
    value_ref, grads_ref = _jax_grads(jmodel, variables, bands, labels, jloss, proxies)
    value, grads = _port_grads(model, bands, labels, loss)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in from_jax_variables(variables).items()})
    assert value == pytest.approx(value_ref, rel=1e-5)
    assert set(grads) <= set(grads_ref)
    largest = max(np.abs(g).max() for g in grads_ref.values())
    for name, grad in grads.items():
        ref = grads_ref[name]
        assert grad is not None, name
        if name.endswith(EXACT_ZEROS):
            assert max(np.abs(ref).max(), grad.abs().max().item()) <= 1e-6 * largest, name
            continue
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(grad.numpy(), ref, atol=F32_TOL * scale, rtol=0, err_msg=name)


def _module_cosines(grads, grads_ref):
    out = {}
    for module in ("backbone", "head", "hash_head"):
        names = sorted(n for n in grads if n.split(".")[0] == module)
        a = np.concatenate([grads[n].float().numpy().ravel() for n in names])
        b = np.concatenate([np.asarray(grads_ref[n], np.float32).ravel() for n in names])
        out[module] = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    return out


def test_bf16_flagship_dtype_agrees_with_jax():
    jmodel, variables, model, bands = build_pair({"depth": 2, "vmem_attn": True}, seed=3,
                                                 batch=4, fusion=NO_DROPOUT)
    assert model.backbone.vit.dtype == torch.bfloat16  # with_autocast from the YAML
    labels = _labels(bands.shape[0], seed=3)
    jloss, proxies, loss = _losses(seed=3)
    value_ref, grads_ref = _jax_grads(jmodel, variables, bands, labels, jloss, proxies)
    value, grads = _port_grads(model, bands, labels, loss)
    assert value == pytest.approx(value_ref, rel=1e-2)
    for module, cos in _module_cosines(grads, grads_ref).items():
        assert cos >= 0.99, (module, cos)


@pytest.mark.parametrize("ftype", ["cross_attention_advanced", "cross_attention_bottleneck"])
def test_sub_band_dropout_p_one_drops_the_ll_band(ftype):
    """sub_band_dropout_p = 1 drops the LL band in every batch, whatever the
    draw: deterministic, so the port matches JAX exactly; the bottleneck
    head's attention ortho term is zeroed with it, the advanced head's Gram
    term does not see the bands."""
    fusion = {**NO_DROPOUT, "type": ftype, "sub_band_dropout_p": 1.0}
    if ftype == "cross_attention_bottleneck":
        fusion.update(output_dim=128, num_heads=4)
    jmodel, variables, model, bands = build_pair(VK_F32, seed=4, batch=3, fusion=fusion)
    (logits_ref, aux_ref), _ = _jax_train_jit(jmodel, variables, bands)
    model.train()
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(bands), _rngs())
        # the LL band carries nothing: zeroing it in the input's embedding
        # path gives the same output as dropping it
        bands_cls = model.backbone(torch.from_numpy(bands))
        kv_kept = model.head(bands_cls.clone(), _rngs())[0]
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(aux["ortho_raw"].numpy(), np.asarray(aux_ref["ortho_raw"]),
                               atol=F32_TOL, rtol=F32_TOL)
    if ftype == "cross_attention_bottleneck":
        assert aux["ortho_raw"].item() == 0.0
    else:
        assert aux["ortho_raw"].item() > 0.0
    head = model.head
    head.sub_band_dropout_p = 0.0
    with torch.no_grad():
        if head.proj is None:
            bands_cls[:, 0] = 0.0
            kv_zeroed = head(bands_cls, _rngs())[0]
            torch.testing.assert_close(kv_kept, kv_zeroed, rtol=1e-5, atol=1e-5)


def test_dropout_keep_rate_and_scale():
    x = torch.ones(1_000_000)
    y = apply_dropout(x, 0.1, True, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 2e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert apply_dropout(x, 0.1, False) is x  # eval: identity


def test_attention_dropout_is_broadcast_over_batch_and_heads():
    """flax's broadcast_dropout: one (q, k) mask for every batch row and
    head.  With q = 0 the probabilities are uniform, and with one-hot values
    the output reads the mask back."""
    b, n, h = 3, 16, 2
    q = torch.zeros(b, n, h, n)
    v = torch.eye(n).reshape(1, n, 1, n).expand(b, n, h, n)
    out = dot_product_attention(q, q, v, dropout_rate=0.25, deterministic=False,
                                generator=torch.Generator().manual_seed(0))
    mask = out * n * 0.75  # 1 where kept, 0 where dropped
    torch.testing.assert_close(mask, mask[:1, :, :1].expand_as(mask))
    assert set(mask.round().unique().tolist()) == {0.0, 1.0}
    assert abs(mask.mean().item() - 0.75) < 0.1


def test_remat_blocks_redraw_the_same_dropout_masks():
    """A ViT with dropout, trained with block remat, gives the gradients of
    the same ViT without remat: each block draws from its own generator,
    forked from the dropout stream, so the recompute in the backward draws
    the masks of the forward again."""
    x = torch.from_numpy(np.random.RandomState(5).rand(2, 16, 16, 3).astype(np.float32))
    grads, outs = [], []
    for remat in (False, True):
        torch.manual_seed(0)  # the same init
        vit = VisionTransformer(**vit_config("test_tiny", img_size=16, dropout=0.2,
                                             remat_blocks=remat)).train()
        vit.reset_parameters(torch.Generator().manual_seed(0))
        out = vit(x, torch.Generator().manual_seed(3))
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append([p.grad.clone() for p in vit.parameters()])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    vit.eval()
    with torch.no_grad():  # eval: no dropout, the generator is not needed
        torch.testing.assert_close(vit(x), vit(x), rtol=0, atol=0)
