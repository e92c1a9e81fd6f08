"""The HF vision wrapper and its three towers against irw_tpu's, same
weights: CLIP (``FlaxCLIPVisionModule``), the HF ViT (``FlaxViTModule``)
and SigLIP (``irw_tpu.models.siglip.SiglipVisionTower``), each through
``HuggingFaceVisionWrapper``; SigLIP's resized position table; CLIP's and
the ViT's fixed one (JAX raises at another patch count, the port too); the
``hidden_act`` and ``layer_norm_eps`` overrides; one train step of
``RetrievalNet`` over the tiny CLIP and SigLIP; and the seven registry names
and the three ``configs/model`` files at full width on the meta device.

Tiny towers: ``config_overrides`` of width 64, 2 layers, 4 heads, patch 8,
image size 32, MLP 128.  Weights: drawn from a seed with numpy in the shapes
of the JAX init (``numpy_init``: no initializer is compiled; biases and
LayerNorm scales redrawn), carried across by the bridge.  Inputs: seeded
numpy images.  Tolerances: unit outputs to 1e-5 absolute; the train step's
metrics (the gradient's norm among them) to 1e-5 relative, every parameter
after it to ``TOL`` of ``test_torch_trunks.py`` (1e-4).  The step is
``basic.yaml``'s AdamW as the configs train (lr 1e-5): at a larger rate the
key projections' biases, whose gradient is zero but for rounding (softmax
ignores a score shift shared by a row), take Adam steps of either sign.
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
from irw_tpu.models import hf_wrapper as jax_hf
from irw_tpu.models.factory import build_retrieval_net as jax_build_retrieval_net
from irw_tpu.models.retrieval_net import RetrievalNet as JaxRetrievalNet
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu_torch.bridge import from_jax_variables, load_jax_loss_params, load_jax_variables
from irw_tpu_torch.engine import build_train_step, init_train_state
from irw_tpu_torch.engine.train import _build_hyper
from irw_tpu_torch.losses import build_losses
from irw_tpu_torch.models import get_model
from irw_tpu_torch.models.hf_wrapper import HF_DEFAULT_CONFIGS, HuggingFaceVisionWrapper
from irw_tpu_torch.models.registry import MODEL_REGISTRY
from irw_tpu_torch.models.retrieval_net import RetrievalNet
from irw_tpu_torch.transforms import DeviceTransform
from test_torch_fusion_heads import numpy_init
from test_torch_shared_dino import CONFIGS, _jax_state, model_yaml

OUT_TOL = 1e-5
TOL = 1e-4          # tests/test_torch_trunks.py's
IMG = 32
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, image_size=IMG,
            patch_size=8, intermediate_size=128)
VARIANTS = ("clip_vit_b16", "vit_b16_hf", "siglip2")
# the leaves of the JAX wrappers at full width (jax.eval_shape of their init)
FULL_WIDTH = {"clip_vit_b16": 85_799_424, "clip_vit_b32": 87_456_000,
              "vit_b16_hf": 86_389_248, "siglip2": 92_884_224, "metaclip2": 85_799_424,
              "clip": 85_799_424, "openclip": 85_799_424}
HF_CONFIGS = {"openclip": 86_094_720, "metaclip2": 86_094_720, "siglip2": 93_179_520}
OPS = [("Normalize", {})]

_PAIRS = {}


def _images(seed, h=IMG, w=IMG, batch=3):
    return np.random.RandomState(seed).randn(batch, h, w, 3).astype(np.float32)


def pair(variant, **overrides):
    """(JAX wrapper, variables, port wrapper) of a tiny tower, built once."""
    key = (variant, tuple(sorted(overrides.items())))
    if key not in _PAIRS:
        cfg = dict(TINY, **overrides)
        jm = jax_hf.HuggingFaceVisionWrapper(variant=variant, config_overrides=cfg)
        variables = numpy_init(jm, jnp.zeros((1, IMG, IMG, 3)), seed=len(_PAIRS))
        model = HuggingFaceVisionWrapper(variant, config_overrides=cfg)
        _PAIRS[key] = (jm, variables, load_jax_variables(model, variables))
    return _PAIRS[key]


def run_both(variant, x, **overrides):
    """(port output, JAX output) of the wrapper in eval mode."""
    jm, variables, model = pair(variant, **overrides)
    ref, jaux = jax.jit(lambda v, x: jm.apply(v, x))(variables, jnp.asarray(x))
    with torch.no_grad():
        out, aux = model(torch.from_numpy(x))
    assert float(jaux["ortho_loss"]) == 0.0 and set(aux) == {"ortho_loss"}
    assert float(aux["ortho_loss"]) == 0.0
    return out.numpy(), np.asarray(ref)


def _close(ours, ref, tol=OUT_TOL):
    np.testing.assert_allclose(ours, ref, atol=tol, rtol=0)


# --- the towers' forward ----------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_wrapper_matches_jax(variant):
    ours, ref = run_both(variant, _images(1))
    assert ours.shape == (3, 64)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=-1), 1.0, atol=1e-6)
    _close(ours, ref)


def test_siglip_resizes_its_position_table():
    """48² images against an ``image_size`` of 32: a 6 × 6 grid, the 4 × 4
    table resized (antialias-free upsampling) as ``jax.image.resize``."""
    _, _, model = pair("siglip2")
    table = model.tower.position_embedding
    assert model.tower.positions(6, 6).shape == (36, 64) and table.shape == (16, 64)
    ours, ref = run_both("siglip2", _images(2, 48, 48))
    _close(ours, ref)
    # a 2 × 8 grid holds the table's 16 rows: no resize, in either package
    ours, ref = run_both("siglip2", _images(3, 16, 64))
    assert model.tower.positions(2, 8) is table
    _close(ours, ref)


@pytest.mark.parametrize("variant", ["clip_vit_b16", "vit_b16_hf"])
def test_fixed_position_table_as_jax(variant):
    """CLIP's and the ViT's tables keep their N + 1 rows: at 48² (36
    patches against 16) the Flax module's sum fails to broadcast and the
    port raises, at the forward and at ``get_model(image_size=...)``, as the
    JAX init does; a 16 × 64 image (2 × 8 = 16 patches) runs in both."""
    jm, variables, model = pair(variant)
    x = _images(4, 48, 48)
    with pytest.raises(TypeError, match="broadcast"):
        jm.apply(variables, jnp.asarray(x))
    with pytest.raises(ValueError, match="fixed length"):
        model(torch.from_numpy(x))
    with pytest.raises(ValueError, match="fixed length"):
        get_model(variant, device="cpu", image_size=(48, 48), config_overrides=TINY)
    get_model(variant, device="cpu", image_size=(16, 64), config_overrides=TINY)
    ours, ref = run_both(variant, _images(5, 16, 64))
    _close(ours, ref)


@pytest.mark.parametrize("variant,act,eps", [("clip_vit_b16", "gelu", 1e-3),
                                             ("vit_b16_hf", "quick_gelu", 1e-2),
                                             ("siglip2", "relu", 1e-3)])
def test_overrides_reach_the_tower(variant, act, eps):
    """The tower runs ``act`` and ``eps`` (the same weights under the
    variant's defaults give another output); an unknown activation raises."""
    _, variables, model = pair(variant, hidden_act=act, layer_norm_eps=eps)
    assert {m.eps for m in model.modules() if hasattr(m, "eps")} == {eps}
    default = load_jax_variables(HuggingFaceVisionWrapper(variant, config_overrides=TINY),
                                 variables)
    x = _images(6)
    ours, ref = run_both(variant, x, hidden_act=act, layer_norm_eps=eps)
    _close(ours, ref)
    with torch.no_grad():
        assert np.abs(default(torch.from_numpy(x))[0].numpy() - ours).max() > 1e-3
    with pytest.raises(ValueError, match="unsupported hidden_act 'mish'"):
        HuggingFaceVisionWrapper(variant, config_overrides=dict(TINY, hidden_act="mish"))


# --- one train step of RetrievalNet over a tiny tower -----------------------------------

_STEPS = {}


def stepped(variant):
    """``RetrievalNet`` (embed_dim 16) over the tiny ``variant``: one step of
    ``pair_loss.yaml``'s PairLoss with ``basic.yaml``'s AdamW in each
    package, on 6 seeded uint8 images through Normalize."""
    if variant in _STEPS:
        return _STEPS[variant]
    with open(CONFIGS / "loss/pair_loss.yaml") as f:
        loss_cfg = yaml.safe_load(f)
    with open(CONFIGS / "optimizer/basic.yaml") as f:
        opt_cfg = yaml.safe_load(f)
    jm = JaxRetrievalNet(backbone=jax_hf.HuggingFaceVisionWrapper(
        variant=variant, config_overrides=TINY), embed_dim=16)
    variables = numpy_init(jm, jnp.zeros((2, IMG, IMG, 3)), seed=9, train=True)
    model = load_jax_variables(RetrievalNet(HuggingFaceVisionWrapper(
        variant, config_overrides=TINY), embed_dim=16), variables)

    jlosses = jax_build_losses(loss_cfg)
    entries = jax_optimizers.build_optimizers(opt_cfg, variables["params"])
    loss_tx = Getter().get_loss_optimizer(loss_cfg)
    jstate = _jax_state(jm, variables, jlosses, entries, loss_tx)
    jstep = jax.jit(jax_build_train_step(jm, jlosses, entries, loss_tx,
                                         device_transform=JaxDeviceTransform(OPS)))
    rng = np.random.RandomState(9)
    batch = {"image": rng.randint(0, 256, (6, IMG, IMG, 3), dtype=np.uint8),
             "label": np.array([0, 0, 1, 1, 2, 2], dtype=np.int32)}
    jafter, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax_build_hyper(entries, 1, 0, 0, None, None))

    state = init_train_state(model, build_losses(loss_cfg), opt_cfg, loss_cfg, seed=0)
    load_jax_loss_params(state.losses, jstate.loss_params)
    metrics = build_train_step(DeviceTransform(OPS, device="cpu"))(
        state, batch, _build_hyper(state.optimizer_entries, 1, 0, 0, None))
    _STEPS[variant] = ({k: float(v) for k, v in jmetrics.items()}, jafter,
                       {k: float(v) for k, v in metrics.items()}, model,
                       from_jax_variables(variables))
    return _STEPS[variant]


@pytest.mark.parametrize("variant", ["clip_vit_b16", "siglip2"])
def test_retrieval_step_metrics_match_jax(variant):
    jm, _, m, _, _ = stepped(variant)
    for k in ("total_loss", "loss_0_PairLoss", "grad_norm"):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("variant", ["clip_vit_b16", "siglip2"])
def test_retrieval_step_updates_match_jax(variant):
    """Every parameter after the step within TOL of JAX's, and every one of
    the tower's moved."""
    _, jafter, _, model, before = stepped(variant)
    ours = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    ref = from_jax_variables({"params": jafter.params})
    assert set(ref) == set(ours)
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, atol=TOL, rtol=TOL, err_msg=k)
    still = [k for k in ours if k.startswith("backbone.") and np.array_equal(ours[k], before[k])]
    assert not still


# --- full width on the meta device ------------------------------------------------------

_SHAPES = {}


def _jax_shapes(key, build):
    """{state-dict name: shape} of ``build()``'s JAX init at 224², through
    the bridge on zero-stride views (no array is made)."""
    if key not in _SHAPES:
        shapes = jax.eval_shape(lambda: build().init(jax.random.PRNGKey(0),
                                                     jnp.zeros((1, 224, 224, 3))))
        views = jax.tree_util.tree_map(
            lambda s: np.lib.stride_tricks.as_strided(np.zeros((), np.float32), s.shape,
                                                      (0,) * len(s.shape)), shapes)
        _SHAPES[key] = {k: v.shape for k, v in from_jax_variables(views).items()}
    return _SHAPES[key]


def _port_shapes(model) -> dict:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_registry_names_build_at_full_width(name):
    variant = {"clip": "clip_vit_b16", "openclip": "clip_vit_b16"}.get(name, name)
    with torch.device("meta"):
        model = MODEL_REGISTRY[name](torch.device("cpu"))
    assert isinstance(model, HuggingFaceVisionWrapper) and model.variant == variant
    assert sum(p.numel() for p in model.parameters()) == FULL_WIDTH[name]
    assert _port_shapes(model) == _jax_shapes(
        ("wrapper", variant), lambda: jax_hf.HuggingFaceVisionWrapper(variant=variant))


@pytest.mark.parametrize("config", sorted(HF_CONFIGS))
def test_hf_configs_build_at_full_width(config):
    cfg = model_yaml(config)
    with torch.device("meta"):
        model = MODEL_REGISTRY[cfg["name"]](torch.device("cpu"), **cfg["kwargs"])
    assert isinstance(model.backbone, HuggingFaceVisionWrapper)
    assert HF_DEFAULT_CONFIGS[model.backbone.variant]["kind"] == (
        "siglip" if config == "siglip2" else "clip")
    assert all(p.dtype == torch.float32 for p in model.parameters())   # with_autocast: f32
    assert sum(p.numel() for p in model.parameters()) == HF_CONFIGS[config]
    assert _port_shapes(model) == _jax_shapes(
        ("config", config), lambda: jax_build_retrieval_net(**cfg["kwargs"]))
