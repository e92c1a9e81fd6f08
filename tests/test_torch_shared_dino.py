"""The flagship's siblings against irw_tpu's, same weights: the shared tower
(``SharedDinoHashing``) with and without prompts and DSLN,
``MultiDinoAttention``, the flagship without BatchNorm in its hash head, and
one train step of the shared tower, unfrozen and frozen with prompts and
DSLN, through both packages' ``build_train_step``.

Small models: test_tiny width (D = 64, 2 heads, patch 8), one block, 16²
bands, the family's YAML kwargs with the fusion head cut to test width and
its dropout 0.  Weights: numpy draws in the shapes of the JAX init
(``numpy_init``), carried across by the bridge.

Tolerances: f32 logits and embeddings to 1e-4.  bf16 towers round
differently in the two frameworks: the codes must agree wherever |logit| >
0.05 and the logits to 0.05.  The train step: total_loss to 1e-5 relative;
the parameters after one SGD step (lr 0.1, so a parameter moves by 0.1 of
its gradient) to 1e-5; the frozen tower's parameters, its DSLN rows
included, unchanged bit for bit in both packages.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util

from irw_tpu.engine import optimizers as jax_optimizers
from irw_tpu.engine.train import _build_hyper as jax_build_hyper
from irw_tpu.engine.train_state import TrainState as JaxTrainState
from irw_tpu.engine.train_step import build_train_step as jax_build_train_step
from irw_tpu.getter import Getter
from irw_tpu.losses import build_losses as jax_build_losses
from irw_tpu.models import get_model as jax_get_model
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu_torch.bridge import from_jax_variables, load_jax_loss_params, load_jax_variables
from irw_tpu_torch.engine import build_train_step, init_train_state
from irw_tpu_torch.engine.train import _build_hyper
from irw_tpu_torch.losses import build_losses
from irw_tpu_torch.models import get_model
from irw_tpu_torch.models.vit import DomainLayerNorm
from irw_tpu_torch.transforms import DeviceTransform
from test_torch_fusion_heads import numpy_init

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
F32_TOL = 1e-4
BF16_MARGIN = 0.05
IMG, BATCH = 16, 6
TINY_FUSION = {"output_dim": 64, "num_heads": 2, "dropout": 0.0}
OPS = [("SWTTransform", {"level": 1, "wavelet": "haar"})]
SGD = [{"name": "SGD", "params": None, "kwargs": {"lr": 0.1}}]


def model_yaml(name):
    with open(CONFIGS / "model" / f"{name}.yaml") as f:
        return yaml.safe_load(f)


def tiny(name, vit_kwargs=None, **overrides):
    """(registry name, kwargs) of ``configs/model/<name>.yaml`` at test width."""
    cfg = model_yaml(name)
    kw = dict(cfg["kwargs"], **overrides)
    for key in ("backbones_config", "backbone_config"):
        if isinstance(kw.get(key), list):
            kw[key] = [dict(b, name="test_tiny") for b in kw[key]]
        elif key in kw:
            kw[key] = dict(kw[key], name="test_tiny")
    if "backbone" in kw:
        kw["backbone"] = "test_tiny"
    kw["fusion_config"] = dict(kw.get("fusion_config") or {}, **TINY_FUSION)
    kw["vit_kwargs"] = dict({"depth": 1}, **(vit_kwargs or {}))
    return cfg["name"], kw


def build_pair(name, kw, seed=0):
    """(JAX model, variables, port model) built from one config, weights from
    ``seed``."""
    jmodel = jax_get_model(name, **kw)
    x = jnp.zeros((2, 4, IMG, IMG, 3), jnp.float32)
    variables = numpy_init(jmodel, x, seed=seed, train=False)
    model = get_model(name, device="cpu",
                      **dict(kw, vit_kwargs=dict(kw["vit_kwargs"], img_size=IMG)))
    load_jax_variables(model, variables)
    return jmodel, variables, model


def _bands(seed, batch=3):
    return np.random.RandomState(seed).randn(batch, 4, IMG, IMG, 3).astype(np.float32)


def jax_eval(jmodel, variables, bands, hashing=True):
    """(output, aux, pre-sign logits or None) of the JAX model in eval mode."""
    def run(v, x):
        return jmodel.apply(v, x, train=False, capture_intermediates=True,
                            mutable=["intermediates"])

    (out, aux), inter = jax.jit(run)(variables, jnp.asarray(bands))
    logits = inter["intermediates"]["HashHead_0"]["__call__"][0] if hashing else None
    return np.asarray(out), aux, None if logits is None else np.asarray(logits)


def check_hashing(name, kw, seed, bf16=False):
    jmodel, variables, model = build_pair(name, kw, seed)
    bands = _bands(seed)
    codes_ref, _, logits_ref = jax_eval(jmodel, variables, bands)
    with torch.no_grad():
        logits, _ = model.forward_logits(torch.from_numpy(bands))
        codes, _ = model(torch.from_numpy(bands))
    torch.testing.assert_close(codes, torch.sign(logits))
    if not bf16:
        np.testing.assert_allclose(logits.numpy(), logits_ref, atol=F32_TOL, rtol=F32_TOL)
        sure = np.abs(logits_ref) > 1e-3
    else:
        np.testing.assert_allclose(logits.numpy(), logits_ref, atol=BF16_MARGIN, rtol=0)
        sure = np.abs(logits_ref) > BF16_MARGIN
        assert sure.mean() > 0.5
    np.testing.assert_array_equal(codes.numpy()[sure], codes_ref[sure])
    return model, variables


@pytest.mark.parametrize("ftype", ["standard", "cbam"])
def test_multidino_attention_matches_jax(ftype):
    """The L2-normalised fused embedding and the head's aux, f32."""
    name, kw = tiny("multidino_attention" if ftype == "standard" else "multidino_attention_cbam",
                    {"dtype": "float32"})
    jmodel, variables, model = build_pair(name, kw, seed=1)
    assert type(model).__name__ == "MultiDinoAttention" and not model.frozen_backbone
    bands = _bands(1)
    ref, aux_ref, _ = jax_eval(jmodel, variables, bands, hashing=False)
    with torch.no_grad():
        out, aux = model(torch.from_numpy(bands))
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=-1), 1.0, atol=1e-5)
    assert set(aux) == set(aux_ref)
    for k in aux:
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(aux_ref[k]), atol=F32_TOL,
                                   rtol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_tower_unfrozen_matches_jax(dtype):
    """shareddino_attention_hashing_ortho.yaml: one tower over the band-major
    batch, the factory's unfrozen defaults (block remat; bf16 from
    ``with_autocast`` unless f32 is asked)."""
    name, kw = tiny("shareddino_attention_hashing_ortho", {"dtype": dtype})
    model, _ = check_hashing(name, kw, seed=2, bf16=dtype == "bfloat16")
    vit = model.backbone.vit
    assert type(model).__name__ == "SharedDinoHashing" and not model.frozen_backbone
    assert vit.remat_blocks and vit.dtype == getattr(torch, dtype) and vit.prompts is None


def test_shared_tower_with_prompts_matches_jax():
    """Prompts alone: ten (S, P, D) tokens after each sample's CLS token."""
    name, kw = tiny("shared_dino_hashing", {"dtype": "float32"}, num_prompts=10)
    model, variables = check_hashing("prompted_shared_dino_hashing", kw, seed=3)
    assert model.prompts.shape == (4, 10, 64)
    np.testing.assert_array_equal(model.prompts.detach().numpy(),
                                  variables["params"]["prompts"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_tower_with_dsln_matches_jax(dtype):
    """DSLN alone: every LayerNorm of the tower with one row per band."""
    name, kw = tiny("shared_dino_hashing", {"dtype": dtype}, use_dsln=True)
    model, _ = check_hashing(name, kw, seed=4, bf16=dtype == "bfloat16")
    norms = [m for m in model.backbone.vit.modules() if isinstance(m, DomainLayerNorm)]
    assert len(norms) == 3 and norms[0].weight.shape == (4, 64)


def test_dsln_dtype_follows_the_jax_module():
    """bf16 in, f32 out (the f32 rows promote it), the statistics in bf16."""
    from irw_tpu.models.vit import DomainLayerNorm as JaxDomainLayerNorm

    x = np.random.RandomState(5).randn(4, 7, 64).astype(np.float32)
    domain = np.array([0, 1, 2, 3])
    jln = JaxDomainLayerNorm(4, dtype=jnp.bfloat16)
    variables = numpy_init(jln, jnp.asarray(x, jnp.bfloat16), jnp.asarray(domain), seed=5)
    ref = jax.jit(jln.apply)(variables, jnp.asarray(x, jnp.bfloat16), jnp.asarray(domain))
    ln = DomainLayerNorm(64, 4)
    ln.load_state_dict({"weight": torch.from_numpy(variables["params"]["scale"]),
                        "bias": torch.from_numpy(variables["params"]["bias"])})
    out = ln(torch.from_numpy(x).bfloat16(), torch.from_numpy(domain))
    assert out.dtype == torch.float32 and str(ref.dtype) == "float32"
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2 ** -6, rtol=0)


def test_bare_vit_with_its_own_prompts_matches_jax():
    """A ViT with ``num_prompts`` and no ``prompts`` passed uses its own
    (1, P, D) tokens, after CLS and without position embeddings."""
    from irw_tpu.models.vit import make_vit as jax_make_vit
    from irw_tpu_torch.models import make_vit

    x = np.random.RandomState(9).rand(3, IMG, IMG, 3).astype(np.float32)
    jvit = jax_make_vit("test_tiny", depth=1, num_prompts=3)
    variables = numpy_init(jvit, jnp.asarray(x), seed=9)
    ref, _ = jax.jit(jvit.apply)(variables, jnp.asarray(x))
    vit = make_vit("test_tiny", depth=1, num_prompts=3, img_size=IMG)
    load_jax_variables(vit, variables)
    with torch.no_grad():
        out = vit(torch.from_numpy(x))
    assert vit.prompts.shape == (1, 3, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL, rtol=F32_TOL)


def test_flagship_without_batch_norm_matches_jax():
    """HashHead(use_bn=False): a Dense with a bias, no BatchNorm."""
    name, kw = tiny("multidino_attention_hashing_ortho", {"dtype": "float32"}, use_bn=False)
    kw["fusion_config"]["sub_band_dropout_p"] = 0
    model, variables = check_hashing(name, kw, seed=6)
    assert model.hash_head.bn is None and model.hash_head.linear.bias is not None
    assert "BatchNorm_0" not in variables["params"]["HashHead_0"]


# --- one train step in each package ---------------------------------------

def _batch(seed=0):
    rng = np.random.RandomState(seed)
    labels = (rng.rand(BATCH, 20) > 0.8).astype(np.float32)
    labels[:, 0] = 1.0
    return {"image": rng.randint(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8), "label": labels}


def _jax_state(jmodel, variables, jlosses, entries, loss_tx):
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    loss_params = {str(i): loss.init_params(jax.random.PRNGKey(i))
                   for i, (loss, _) in enumerate(jlosses)}
    return JaxTrainState(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables.get("batch_stats", {})),
        opt_states={e.name: e.tx.init(params if e.target is None else params[e.target])
                    for e in entries},
        loss_params=loss_params, loss_opt_state=loss_tx.init(loss_params),
        loss_states={str(i): loss.init_state() for i, (loss, _) in enumerate(jlosses)},
        xbm=None, rng=jax.random.PRNGKey(7), step=jnp.int32(0), epoch=jnp.int32(0),
        model_alpha=jnp.float32(1.0))


def one_step(name, kw, seed):
    """One step of each package from the same weights: (JAX metrics, JAX
    state after, port metrics, port model, JAX params before)."""
    with open(CONFIGS / "loss/hash_loss.yaml") as f:
        loss_cfg = yaml.safe_load(f)
    jmodel, variables, model = build_pair(name, kw, seed)
    jlosses = jax_build_losses(loss_cfg)
    frozen = jmodel.frozen_param_collections
    entries = jax_optimizers.build_optimizers(SGD, variables["params"],
                                              frozen_collections=frozen)
    loss_tx = Getter().get_loss_optimizer(loss_cfg)
    jstate = _jax_state(jmodel, variables, jlosses, entries, loss_tx)
    jdt = JaxDeviceTransform(OPS)
    jstep = jax.jit(jax_build_train_step(jmodel, jlosses, entries, loss_tx, device_transform=jdt,
                                         frozen_collections=frozen))
    batch = _batch(seed)
    jstate2, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax_build_hyper(entries, 1, 0, 0, None, None))

    state = init_train_state(model, build_losses(loss_cfg), SGD, loss_cfg, seed=0)
    load_jax_loss_params(state.losses, jstate.loss_params)
    step = build_train_step(DeviceTransform(OPS, device="cpu"))
    metrics = step(state, batch, _build_hyper(state.optimizer_entries, 1, 0, 0, None))
    return ({k: float(v) for k, v in jm.items()}, jstate2,
            {k: float(v) for k, v in metrics.items()}, model, jstate.params)


def _flat(params):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(params).items()}


_STEPS = {}


@pytest.fixture(scope="module", params=["unfrozen", "prompts_dsln"])
def stepped(request):
    """One step of shareddino_attention_hashing_ortho.yaml (unfrozen, f32 at
    test width) or of prompted_shared_dino.yaml (frozen tower, 10 prompts,
    DSLN, the standard head)."""
    if request.param == "unfrozen":
        name, kw = tiny("shareddino_attention_hashing_ortho", {"dtype": "float32"})
    else:
        name, kw = tiny("prompted_shared_dino")
    return request.param, one_step(name, kw, seed=8)


def test_train_step_loss_and_frozen_tower_match_jax(stepped):
    case, (jm, jafter, m, model, jbefore) = stepped
    assert model.frozen_backbone == (case == "prompts_dsln")
    for k in ("total_loss", "loss_0_HashLoss", "grad_norm"):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, atol=0, err_msg=k)
    assert np.isfinite(m["grad_norm"])
    tower = {k: v for k, v in _flat(jbefore).items() if k.startswith("VisionTransformer_0")}
    after = _flat(jafter.params)
    moved = [k for k, v in tower.items() if not np.array_equal(after[k], v)]
    if case == "prompts_dsln":  # the tower and its DSLN rows stay as they were, in both
        assert not moved and any(k.endswith("norm1/scale") for k in tower)
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        ln = sd["backbone.vit.blocks.0.norm1.weight"]
        np.testing.assert_array_equal(ln, _flat(jbefore)["VisionTransformer_0/Block_0/norm1/scale"])
        assert all(p.grad is None for p in model.backbone.parameters())
        assert model.prompts.grad is not None and model.prompts.grad.abs().sum() > 0
    else:
        assert moved


def test_train_step_updates_match_jax(stepped):
    """Every parameter and BatchNorm statistic after the step, the JAX
    state's carried across by the bridge."""
    _, (_, jafter, _, model, _) = stepped
    ours = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    ref = from_jax_variables({"params": jafter.params, "batch_stats": jafter.batch_stats})
    assert set(ref) == set(ours)
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, atol=1e-5, rtol=0, err_msg=k)
