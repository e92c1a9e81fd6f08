"""The single-backbone baselines against irw_tpu's, same weights:
``DINOHashBaseline`` (and its ``head_out``), ``SingleBandNet`` in hashing
and metric mode, ``DinoModelCE``, ``MultiDinoModel`` with a subset of
bands, each with a frozen and an unfrozen tower, in eval and training
mode; the bf16 configs (``single_band.yaml``, ``detail_tester.yaml``,
``dino_hashing.yaml``) through both factories; and one train step of
``single_band_net`` unfrozen through both packages' ``build_train_step``.

Small models: vit_tiny (D = 64, 2 heads, patch 8, depth 2) on 16² images or
band stacks.  Weights: numpy draws in the shapes of the JAX init
(``numpy_init``): biases, norms and LayerScale redrawn about their init,
``DinoModelCE``'s zero-initialised classifier drawn like any Dense (a
parity at zeros proves nothing).

Tolerances: f32 outputs and BatchNorm statistics to 1e-4, ±1 codes equal
wherever |logit| > 1e-3.  bf16 towers round differently in the two
frameworks: outputs within 0.1, codes equal wherever |logit| > 0.05.  The
train step: the metrics to 1e-5 relative; every parameter after one SGD
step (lr 0.1) within 1e-5 plus 1e-3 of the JAX step's move (the gradient
passes the HashHead's BatchNorm over 6 samples, which magnifies f32
rounding).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from irw_tpu.engine import optimizers as jax_optimizers
from irw_tpu.engine.train import _build_hyper as jax_build_hyper
from irw_tpu.engine.train_step import build_train_step as jax_build_train_step
from irw_tpu.getter import Getter
from irw_tpu.losses import build_losses as jax_build_losses
from irw_tpu.models import baselines as jax_baselines
from irw_tpu.models import get_model as jax_get_model
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu_torch.bridge import from_jax_variables, load_jax_loss_params, load_jax_variables
from irw_tpu_torch.engine import build_train_step, init_train_state
from irw_tpu_torch.engine.train import _build_hyper
from irw_tpu_torch.losses import build_losses
from irw_tpu_torch.models import baselines, get_model
from test_torch_fusion_heads import numpy_init
from test_torch_shared_dino import CONFIGS, OPS, SGD, _jax_state, model_yaml

F32_TOL = 1e-4
BF16_TOL = 0.1
BF16_MARGIN = 0.05
IMG, BATCH = 16, 3
VIT = {"img_size": IMG}

_DRAWS = {}


def _images(seed, bands=False):
    shape = (BATCH, 4, IMG, IMG, 3) if bands else (BATCH, IMG, IMG, 3)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _draw(key, jmodel, x, seed):
    """One ``numpy_init`` draw (training-mode init) per parameter tree,
    shared by the frozen and unfrozen cases."""
    if key not in _DRAWS:
        _DRAWS[key] = numpy_init(jmodel, jnp.asarray(x), seed=seed, train=True)
    return _DRAWS[key]


def run_jax(jmodel, variables, x, train: bool):
    """(output, pre-sign HashHead logits or None, batch_stats after)."""
    def run(v, x):
        return jmodel.apply(v, x, train=train, capture_intermediates=True,
                            mutable=["intermediates", "batch_stats"])

    (out, aux), upd = jax.jit(run)(variables, jnp.asarray(x))
    head = upd["intermediates"].get("HashHead_0")
    assert set(aux) == {"ortho_loss"} and float(aux["ortho_loss"]) == 0.0
    return out, None if head is None else np.asarray(head["__call__"][0]), upd.get("batch_stats")


def run_port(model, x, train: bool):
    model.train(train)
    with torch.no_grad():
        out, aux = model(torch.from_numpy(x))
    assert set(aux) == {"ortho_loss"} and float(aux["ortho_loss"]) == 0.0
    return out


def _close(ours, ref, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(ours, np.float32), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _codes(ours, logits, margin=1e-3):
    assert set(np.unique(np.asarray(ours))) <= {-1.0, 1.0}
    sure = np.abs(logits) > margin
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(np.asarray(ours)[sure], np.sign(logits)[sure])


def _stats(model, variables, stats):
    ref = from_jax_variables({"params": variables["params"], "batch_stats": stats})
    sd = model.state_dict()
    keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        _close(sd[k].numpy(), ref[k])


def _check_frozen(model, frozen):
    assert model.frozen_param_collections == (("backbone",) if frozen else ())
    model.train()
    assert model.backbone.training == (not frozen)


# --- each baseline in both modes -------------------------------------------------

@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "unfrozen"])
def test_dino_hash_baseline_matches_jax(frozen):
    """Eval: ±1 codes; training: the HashHead's logits and its BatchNorm
    statistics; ``head_out`` on CLS tokens as the JAX method."""
    kw = dict(backbone="vit_tiny", nbits=16, frozen_backbone=frozen, vit_kwargs=VIT)
    jm = jax_baselines.DINOHashBaseline(**kw)
    x = _images(1)
    variables = _draw("dino_hash", jm, x, 1)
    model = load_jax_variables(baselines.DINOHashBaseline(**kw), variables)
    _check_frozen(model, frozen)
    _, logits, _ = run_jax(jm, variables, x, train=False)
    _codes(run_port(model, x, train=False), logits)
    ref, _, stats = run_jax(jm, variables, x, train=True)
    _close(run_port(model, x, train=True), ref)
    _stats(model, variables, stats)
    load_jax_variables(model, variables)

    cls = np.random.RandomState(2).randn(BATCH, 64).astype(np.float32)
    jref, _ = jm.apply(variables, jnp.asarray(cls), method="head_out")
    model.eval()
    with torch.no_grad():
        out, _ = model.head_out(torch.from_numpy(cls))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jref))


@pytest.mark.parametrize("mode", ["hashing", "metric"])
@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "unfrozen"])
def test_single_band_matches_jax(mode, frozen):
    """Band 2 of the stack.  Hashing: tanh of the logits in training, ±1
    codes in eval; metric: the L2-normalised CLS in both."""
    kw = dict(backbone="vit_tiny", band=2, mode=mode, nbits=16, frozen_backbone=frozen,
              vit_kwargs=VIT)
    jm = jax_baselines.SingleBandNet(**kw)
    x = _images(3, bands=True)
    variables = _draw(("single_band", mode), jm, x, 3)
    model = load_jax_variables(baselines.SingleBandNet(**kw), variables)
    _check_frozen(model, frozen)
    ref, logits, _ = run_jax(jm, variables, x, train=False)
    ours = run_port(model, x, train=False)
    if mode == "hashing":
        _codes(ours, logits)
    else:
        _close(ours, ref)
        np.testing.assert_allclose(np.linalg.norm(ours.numpy(), axis=-1), 1.0, atol=1e-5)
    ref, _, stats = run_jax(jm, variables, x, train=True)
    ours = run_port(model, x, train=True)
    _close(ours, ref)
    if mode == "hashing":
        assert float(ours.abs().max()) < 1.0
        _stats(model, variables, stats)
        load_jax_variables(model, variables)


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "unfrozen"])
def test_dino_ce_matches_jax(frozen):
    """Training: the classifier's logits (its weights drawn, not zero);
    eval: the L2-normalised CLS."""
    kw = dict(backbone="vit_tiny", num_classes=7, frozen_backbone=frozen, vit_kwargs=VIT)
    jm = jax_baselines.DinoModelCE(**kw)
    x = _images(4)
    variables = _draw("dino_ce", jm, x, 4)
    model = load_jax_variables(baselines.DinoModelCE(**kw), variables)
    _check_frozen(model, frozen)
    assert model.classifier.weight.detach().abs().max() > 0
    ref, _, _ = run_jax(jm, variables, x, train=True)
    ours = run_port(model, x, train=True)
    assert ours.shape == (BATCH, 7)
    _close(ours, ref)
    ref, _, _ = run_jax(jm, variables, x, train=False)
    _close(run_port(model, x, train=False), ref)
    fresh = get_model("dino_ce", device="cpu", backbone="vit_tiny", num_classes=7,
                      vit_kwargs=VIT)
    assert not fresh.classifier.weight.any() and not fresh.classifier.bias.any()


@pytest.mark.parametrize("branches,frozen", [((0, 2), True), ((0, 1, 2, 3), False)],
                         ids=["bands_0_2-frozen", "all_bands-unfrozen"])
def test_multi_dino_model_matches_jax(branches, frozen):
    """Training: one CLS per chosen band; eval: their normalised concat."""
    kw = dict(backbone="vit_tiny", branches=branches, frozen_backbone=frozen, vit_kwargs=VIT)
    jm = jax_baselines.MultiDinoModel(**kw)
    x = _images(5, bands=True)
    variables = numpy_init(jm, jnp.asarray(x), seed=5, train=True)
    model = load_jax_variables(baselines.MultiDinoModel(**kw), variables)
    _check_frozen(model, frozen)
    assert model.backbone.vit.pos_embed.shape[0] == len(branches)
    ref, _, _ = run_jax(jm, variables, x, train=True)
    model.train()
    with torch.no_grad():
        ours, _ = model(torch.from_numpy(x))
    assert isinstance(ours, list) and len(ours) == len(ref) == len(branches)
    for o, r in zip(ours, ref):
        _close(o, r)
    ref, _, _ = run_jax(jm, variables, x, train=False)
    ours = run_port(model, x, train=False)
    assert ours.shape == (BATCH, 64 * len(branches))
    _close(ours, ref)


# --- the bf16 configs through both factories ------------------------------------------

BF16 = {"single_band": ("backbone_name", True), "detail_tester": ("backbone_name", True),
        "dino_hashing": ("dino_backbone", False)}


@pytest.mark.parametrize("config", sorted(BF16))
def test_bf16_config_matches_jax(config):
    """``with_autocast`` reaches the ViT of the class adapters as bf16
    (factory.py:84-85): ``single_band.yaml`` (metric), ``detail_tester.yaml``
    (64-bit hashing) on band 0 and ``dino_hashing.yaml`` on images, each at
    vit_tiny width."""
    cfg = model_yaml(config)
    key, bands = BF16[config]
    kw = dict(cfg["kwargs"], **{key: "vit_tiny"}, vit_kwargs=VIT)
    jm = jax_get_model(cfg["name"], **kw)
    x = _images(6, bands=bands)
    variables = numpy_init(jm, jnp.asarray(x), seed=6, train=False)
    model = load_jax_variables(get_model(cfg["name"], device="cpu", **kw), variables)
    assert model.backbone.dtype == torch.bfloat16 and jm.vit_kwargs["dtype"] == "bfloat16"
    ref, logits, _ = run_jax(jm, variables, x, train=False)
    ours = run_port(model, x, train=False)
    if logits is None:
        assert model.hash_head is None and ours.dtype == torch.bfloat16
        _close(ours.float(), ref.astype(jnp.float32), BF16_TOL)
    else:
        _codes(ours, logits, BF16_MARGIN)
        model.eval()
        with torch.no_grad():
            cls = model.backbone(torch.from_numpy(x[:, 0] if bands else x))
            _close(model.hash_head(cls), logits, BF16_TOL)


# --- one train step of single_band_net, unfrozen ----------------------------------------

@pytest.fixture(scope="module")
def stepped():
    """single_band_tiny.yaml's model (single_band_net, unfrozen) at depth 1
    on 16² band stacks, one SGD step of HashLoss in each package."""
    with open(CONFIGS / "loss/hash_loss.yaml") as f:
        loss_cfg = yaml.safe_load(f)
    kw = dict(model_yaml("single_band_tiny")["kwargs"], vit_kwargs=dict(VIT, depth=1))
    assert kw["frozen_backbone"] is False and kw["backbone"] == "vit_tiny"
    jm = jax_get_model("single_band_net", **kw)
    x = jnp.zeros((2, 4, IMG, IMG, 3))
    variables = numpy_init(jm, x, seed=8, train=False)
    model = load_jax_variables(get_model("single_band_net", device="cpu", **kw), variables)

    jlosses = jax_build_losses(loss_cfg)
    entries = jax_optimizers.build_optimizers(SGD, variables["params"])
    loss_tx = Getter().get_loss_optimizer(loss_cfg)
    jstate = _jax_state(jm, variables, jlosses, entries, loss_tx)
    jstep = jax.jit(jax_build_train_step(jm, jlosses, entries, loss_tx,
                                         device_transform=JaxDeviceTransform(OPS)))
    rng = np.random.RandomState(8)
    labels = (rng.rand(6, 20) > 0.8).astype(np.float32)
    labels[:, 0] = 1.0
    batch = {"image": rng.randint(0, 256, (6, IMG, IMG, 3), dtype=np.uint8), "label": labels}
    jafter, jm_metrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                               jax_build_hyper(entries, 1, 0, 0, None, None))

    from irw_tpu_torch.transforms import DeviceTransform

    state = init_train_state(model, build_losses(loss_cfg), SGD, loss_cfg, seed=0)
    load_jax_loss_params(state.losses, jstate.loss_params)
    metrics = build_train_step(DeviceTransform(OPS, device="cpu"))(
        state, batch, _build_hyper(state.optimizer_entries, 1, 0, 0, None))
    before = from_jax_variables(variables)
    return ({k: float(v) for k, v in jm_metrics.items()}, jafter,
            {k: float(v) for k, v in metrics.items()}, model, before)


def test_single_band_train_step_metrics_match_jax(stepped):
    jm, _, m, _, _ = stepped
    for k in ("total_loss", "loss_0_HashLoss", "grad_norm", "batch_map"):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_single_band_train_step_updates_match_jax(stepped):
    """Every parameter and BatchNorm statistic after the step; the tower
    moved (unfrozen)."""
    _, jafter, _, model, before = stepped
    ours = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    ref = from_jax_variables({"params": jafter.params, "batch_stats": jafter.batch_stats})
    assert set(ref) == set(ours)
    for k, v in ref.items():
        move = np.abs(v.astype(np.float64) - before[k])
        assert np.all(np.abs(ours[k] - v) <= 1e-5 + 1e-3 * move), k
    assert model.backbone.pos_embed.grad is not None
