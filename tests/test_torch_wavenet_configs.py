"""The 13 wavelet-CNN configs of ``configs/model/`` (``wresnet*``,
``mtwavenet*``, ``hybrid_wavenet*``) through both factories, at full width.

- each config, composed over ``configs/default.yaml``, builds the same
  resolved module in both packages (the JAX factory's drops mirrored:
  ``mtwavenet50`` builds ``FourBranchResNet50`` from no key, since the
  function's accepted set is ``{kw}``; ``pooling_mode``, the kwargs'
  ``freeze_batch_norm`` and, for ``WaveResNetCE`` and the mtwavenet classes,
  ``attention`` are dropped; ``with_autocast`` reaches none: f32);
- the port's parameters, on the meta device, have the names, shapes and
  count of ``jax.eval_shape`` of the JAX init (``train=True``, as
  ``irw_tpu/getter.py:167`` inits; ``mtwavenet_fusion_dml``, whose
  training init raises in JAX, in eval);
- ``bridge.jax_param_paths`` names, for each port parameter, the flax leaf
  the bridge carries into it (``tests/test_torch_param_paths.py``'s check);
- ``model.freeze_batch_norm`` selects the same parameters of
  ``mtwavenet50`` in both packages;
- ``chip_smoke.py``'s ``wavenets`` phase choices held to the YAML files.

Construction only: no forward, no JAX compile (``jax.eval_shape`` traces).
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

from irw_tpu.models import attention_blocks as jax_blocks
from irw_tpu.models import get_model as jax_get_model
from irw_tpu.utils import freezing as jax_freezing
from irw_tpu_torch.bridge import from_jax_variables
from irw_tpu_torch.config import compose
from irw_tpu_torch.models import MODEL_REGISTRY
from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
from irw_tpu_torch.utils.freezing import config_freeze_set, frozen_names
from test_torch_param_paths import assert_paths_are_the_leaves

REPO = Path(__file__).resolve().parents[1]
WRESNET = ("wresnet", "wresnet_cifar", "wresnet_cifar_ce", "wresnet_sdd", "wresnet_sdd_ce")
MTWAVENET = ("mtwavenet", "mtwavenet50", "mtwavenet50_fusion", "mtwavenet_fusion",
             "mtwavenet_fusion_dml", "mtwavenet_tuned", "hybrid_wavenet", "hybrid_wavenet_v2")
STATS = ("running_mean", "running_var", "num_batches_tracked")

_SHAPES = {}


def _composed(config):
    cfg = compose(CONFIG_DIR, "default", [f"model={config}"])
    return cfg, cfg.model.name, cfg.model.kwargs.to_dict()


def _jax_tree(jmodel, fill=lambda path: 0.0):
    """``jax.eval_shape`` of ``jmodel``'s init as zero-stride numpy views
    holding ``fill(path)``: on images for ``WaveResNet(CE)``, on a band
    stack for the others; in training, as the JAX getter inits, but for
    the fusion without classes, whose training init raises."""
    kind = type(jmodel).__name__
    # WaveResNet never reads feature_size: configs that differ in it alone
    # share one trace
    key = repr(jmodel.clone(feature_size=0) if kind == "WaveResNet" else jmodel)
    if key not in _SHAPES:
        x = jnp.zeros((1, 32, 32, 3) if kind.startswith("WaveResNet") else (1, 4, 64, 64, 3))
        train = not (kind == "FourBranchResNet50Fusion" and jmodel.num_classes is None)
        rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
        _SHAPES[key] = jax.eval_shape(lambda: jmodel.init(rngs, x, train=train))
    flat = traverse_util.flatten_dict(dict(_SHAPES[key]))
    return traverse_util.unflatten_dict(
        {path: np.broadcast_to(np.float32(fill(path)), leaf.shape) for path, leaf in flat.items()})


def resolved(m) -> dict:
    """The fields a JAX or a port wavelet CNN resolved to."""
    port = isinstance(m, torch.nn.Module)
    kind = type(m).__name__
    out = {"kind": kind}
    if kind.startswith("WaveResNet"):
        if port:
            trunk = m.backbone.branches[0]
            out.update(levels=m.decom_level, wave=m.wave, bands=len(m.backbone.branches),
                       stem=trunk.stem.kernel_size[0], frozen_bn=trunk.frozen_bn)
        else:
            out.update(levels=m.decom_level, wave=m.wave, stem=1, frozen_bn=m.frozen_bn,
                       bands=1 if getattr(m, "ll_only", False) else 4)
        if kind == "WaveResNet":
            if port:
                out["gate"] = None if m.gate is None else type(m.gate).__name__
            else:
                gated = m.attention in jax_blocks.SUBBAND_GATES and not m.ll_only
                out["gate"] = jax_blocks.SUBBAND_GATES[m.attention].__name__ if gated else None
        else:
            out["classes"] = m.branch_classifier.weight.shape[0] if port else m.num_classes
        return out
    if kind == "HybridMultiBranch":
        out["frozen_bn"] = m.ll_trunk.frozen_bn if port else m.frozen_bn
        out["classes"] = (None if m.classifier is None else m.classifier.weight.shape[0]) \
            if port else m.num_classes
        return out
    if port:
        head = m.branch_classifier
        out.update(classes=None if head is None else head.weight.shape[0], pool=m.backbone.pool,
                   frozen_bn=m.backbone.branches[0].frozen_bn,
                   layernorm=m.backbone.branch_ln is not None,
                   depth=18 if len(m.backbone.branches[0].blocks) == 8 else 50)
    else:
        out.update(classes=m.num_classes, pool=m.pool, frozen_bn=m.frozen_bn,
                   layernorm=kind == "FourBranchResNet50Fusion" or m.layernorm,
                   depth=50 if kind == "FourBranchResNet50Fusion" else m.depth)
    return out


EXPECTED = {
    "wresnet": {"kind": "WaveResNet", "gate": None},
    "wresnet_cifar": {"kind": "WaveResNet", "gate": "SubbandEca"},
    "wresnet_sdd": {"kind": "WaveResNet", "gate": "SubbandEca"},
    "wresnet_cifar_ce": {"kind": "WaveResNetCE", "classes": 100},
    "wresnet_sdd_ce": {"kind": "WaveResNetCE", "classes": 120},
    "mtwavenet": {"kind": "FourBranchResNet", "classes": 64, "depth": 18},
    "mtwavenet_tuned": {"kind": "FourBranchResNet", "classes": 100, "frozen_bn": False},
    "mtwavenet50": {"kind": "FourBranchResNet", "classes": None, "depth": 50,
                    "layernorm": True},
    "mtwavenet50_fusion": {"kind": "FourBranchResNet50Fusion", "classes": 100},
    "mtwavenet_fusion": {"kind": "FourBranchResNet50Fusion", "classes": 200, "pool": "avg"},
    "mtwavenet_fusion_dml": {"kind": "FourBranchResNet50Fusion", "classes": None},
    "hybrid_wavenet": {"kind": "HybridMultiBranch", "classes": 200},
    "hybrid_wavenet_v2": {"kind": "HybridMultiBranch", "classes": 200},
}


@pytest.mark.parametrize("config", WRESNET + MTWAVENET)
def test_wavenet_config_builds_what_jax_builds(config):
    """Full width, construction only: the same resolved module in both
    factories, and the port's parameters those of the JAX init by name,
    shape and count, f32."""
    _, name, kwargs = _composed(config)
    jmodel = jax_get_model(name, **kwargs)
    with torch.device("meta"):
        model = MODEL_REGISTRY[name](torch.device("cpu"), **kwargs)
    ours = resolved(model)
    assert ours == resolved(jmodel)
    assert EXPECTED[config].items() <= ours.items()
    ref = {k: tuple(np.shape(v)) for k, v in from_jax_variables(_jax_tree(jmodel)).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == ref
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s)) for k, s in ref.items() if not k.endswith(STATS))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    if config.startswith("wresnet"):
        assert model.backbone.branches[0].stem.kernel_size == (1, 1)
        assert not model.backbone.branches[0].stem_pool


@pytest.mark.parametrize("config", WRESNET + MTWAVENET)
def test_wavenet_config_param_paths_are_the_flax_leaves(config):
    _, name, kwargs = _composed(config)
    jmodel = jax_get_model(name, **kwargs)
    with torch.device("meta"):
        model = MODEL_REGISTRY[name](torch.device("cpu"), **kwargs)
    assert_paths_are_the_leaves(model, _jax_tree(jmodel))


def test_freeze_batch_norm_selects_what_jax_selects():
    """``mtwavenet50``'s ``model.freeze_batch_norm: true``: each JAX leaf
    holds 1 where the JAX freezing set selects its path
    (``irw_tpu/engine/optimizers.py:257``: the '/'-joined path contains a
    substring), 0 elsewhere; carried by the bridge, the ones land exactly on
    the port parameters the port's freezing set selects."""
    cfg, name, kwargs = _composed("mtwavenet50")
    assert cfg.model.freeze_batch_norm is True
    jmodel = jax_get_model(name, **kwargs)
    jax_set = jax_freezing.freeze_batch_norm_params()
    with torch.device("meta"):
        model = MODEL_REGISTRY[name](torch.device("cpu"), **kwargs)
    port_set = config_freeze_set(model, cfg.model.to_dict())
    assert port_set == jax_set

    def fill(path):
        return float(path[0] == "params" and any(f in "/".join(path[1:]) for f in jax_set))

    marks = from_jax_variables(_jax_tree(jmodel, fill))
    selected = frozen_names(model, port_set)
    params = dict(model.named_parameters())
    assert selected and selected <= set(params)
    for pname in params:
        assert bool(np.all(marks[pname] == 1.0)) == (pname in selected), pname
        assert bool(np.any(marks[pname] == 1.0)) == (pname in selected), pname
    # every BatchNorm's scale and bias, the per-band LayerNorm and the stage
    # attentions not among them
    assert len(selected) == 2 * 4 * 53
    assert not any("branch_ln" in n or "att_blocks" in n for n in selected)


def test_wavenets_phase_choices_match_the_yaml():
    """The phase's configs, transforms, losses and batches: every A10b
    config once, a transform whose input fits it, and losses and batch
    sizes read from ``configs/``."""
    import chip_smoke

    phase = chip_smoke.WAVENET_CONFIGS
    assert set(phase) == set(WRESNET + MTWAVENET) and len(phase) == 13
    assert all((REPO / "configs/model" / f"{c}.yaml").exists() for c in phase)
    for config, (transform, loss) in phase.items():
        assert (REPO / "configs/transform" / f"{transform}.yaml").exists()
        assert loss is None or (REPO / "configs/loss" / loss).exists()
        bands = "CustomTransform" in (REPO / "configs/transform"
                                      / f"{transform}.yaml").read_text()
        assert bands == (not config.startswith("wresnet")), config
    assert phase["mtwavenet_fusion_dml"][1] is None    # trains in neither package
    first = {c: yaml.safe_load((REPO / "configs/loss" / loss).read_text())[0]["name"]
             for c, (_, loss) in phase.items() if loss}
    assert first["hybrid_wavenet"] == first["hybrid_wavenet_v2"] == "CrossEntropy"
    assert first["mtwavenet_fusion"] == first["wresnet_sdd_ce"] == "MultiCrossEntropyLoss"
    assert first["wresnet"] == first["mtwavenet50"] == "PairLoss"
    main = chip_smoke.WAVENET_MAIN
    assert main["wresnet_sdd_ce"][:2] == ("sdd", "multi_ce.yaml")
    assert main["mtwavenet50"][:2] == ("cub_dwt", "pair_loss.yaml")
    assert main["mtwavenet50"][2] == yaml.safe_load(
        (REPO / "configs/dataset/cub.yaml").read_text())["sampler"]["kwargs"]["batch_size"]
    assert chip_smoke.WAVENET_OPTIMIZER == yaml.safe_load(
        (REPO / "configs/optimizer/basic.yaml").read_text())
    assert yaml.safe_load((REPO / "configs/model/mtwavenet50.yaml").read_text())[
        "freeze_batch_norm"] is True
