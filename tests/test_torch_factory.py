"""The port's reference-config factory against irw_tpu's (ROADMAP C1, C2,
C8, C9).

The JAX class adapter renames ``dino_backbone`` to ``backbone``, reads a
single ``backbone_config``, and drops only the keys its module does not
declare; ``MultiDinoHashingTF`` trains on tanh-binarised logits.  The port
builds the same model from the same keys, raises where it cannot (a key the
JAX module takes), and its ``tanh_train`` model matches the JAX one through
the bridge at test_tiny width: f32, 1e-4 on the outputs.  Every config of
the multi-band ViT family in ``configs/model/`` builds, at full width, to the
same resolved fields in both packages (construction only: the port's
parameters on the meta device, no JAX init), ``PromptedSharedDinoHashing``'s
drop of every key but ``num_prompts`` included (C9); a
``backbone_config.use_dsln`` reaches ``SharedDinoHashing`` and is dropped
for ``MultiDinoHashing`` (C8).

Every file of ``configs/model/`` composes through the port's ``compose``
over ``configs/default.yaml`` and builds (the port's parameters on the meta
device), the HF wrapper's three included
(``tests/test_torch_hf_towers.py`` holds them to JAX).  The 22 files of the single-trunk models
(the baselines, the hashing ResNets, ``RetrievalNet``'s ``dino_ce``,
``multi_dino*`` and wrapped trunks) build the same resolved fields in both
factories: the tower's width, depth, patch, dtype, remat and K2 route, the
trunk's stages or widths, the head's sizes and flags.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from irw_tpu.models import baselines as jax_baselines
from irw_tpu.models import get_model as jax_get_model
from irw_tpu.models import hashing_nets as jax_hashing_nets
from irw_tpu.models import mtwavenet as jax_mtwavenet
from irw_tpu.models import multi_dino as jax_multi_dino
from irw_tpu.models import wresnet as jax_wresnet
from irw_tpu.models.factory import _accepted as jax_accepted
from irw_tpu.models.fusion import get_fusion_head as jax_fusion_head
from irw_tpu.models.vit import VIT_DIMS as JAX_VIT_DIMS
from irw_tpu.models.vit import vit_config as jax_vit_config
from irw_tpu_torch.bridge import load_jax_variables
from irw_tpu_torch.config import compose
from irw_tpu_torch.getter import Getter
from irw_tpu_torch.models import MODEL_REGISTRY, get_model
from irw_tpu_torch.models.vit import DomainLayerNorm
from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
from irw_tpu_torch.studies.run_plan import expand_jobs, load_plan
from test_torch_vit import randomize

REPO = Path(__file__).resolve().parents[1]
# every config of configs/model/ whose model is of the multi-band ViT family
FAMILY = ("multidino_attention", "multidino_attention_cbam", "multidino_original_attention",
          "multidino_attention_hashing", "multidino_attention_hashing_ortho",
          "multidino_attention_pretrain", "multidino_hashing_attention_pretrained",
          "multidino_tiny", "shared_dino_hashing", "shareddino_attention_hashing_ortho",
          "shareddino_attention_hashing_ortho_prtun",
          "shareddino_attention_hashing_ortho_prtun_dmln", "prompted_shared_dino")

TOL = 1e-4
TINY_FUSION = {"use_all_tokens": False, "type": "cross_attention_advanced", "output_dim": 64,
               "num_heads": 2, "dropout": 0.0, "num_queries": 4, "sub_band_dropout_p": 0,
               "ortho_weight": 0.01}


def tiny_kwargs(**kw):
    """The flagship YAML's dialect at test_tiny width, one block, f32."""
    return dict({"binary_config": {"nbits": 16}, "use_bn": True, "fusion_config": TINY_FUSION,
                 "vit_kwargs": {"depth": 1, "dtype": "float32"}}, **kw)


def test_jax_fields_copy_matches_irw_tpu():
    from irw_tpu_torch.models.factory import JAX_FIELDS

    modules = {"MultiDinoHashing": jax_multi_dino.MultiDinoHashing, "WCNN": jax_wresnet.WCNN,
               "WCNNAttention": jax_wresnet.WCNNAttention,
               "MultiDinoAttention": jax_multi_dino.MultiDinoAttention,
               "SharedDinoHashing": jax_multi_dino.SharedDinoHashing,
               "PromptedSharedDinoHashing": jax_multi_dino.PromptedSharedDinoHashing,
               **{name: getattr(jax_baselines, name) for name in
                  ("DINOHashBaseline", "SingleBandNet", "DinoModelCE", "MultiDinoModel")},
               **{name: getattr(jax_hashing_nets, name) for name in
                  ("ResNetCE", "ResNetHashing", "ResNet50DSCH", "ResNet50Mod")},
               "WaveResNet": jax_wresnet.WaveResNet, "WaveResNetCE": jax_wresnet.WaveResNetCE,
               **{name: getattr(jax_mtwavenet, name) for name in
                  ("FourBranchResNet", "FourBranchResNet50", "FourBranchResNet50Fusion",
                   "HybridMultiBranch")}}
    assert set(JAX_FIELDS) == set(modules)
    for name, cls in modules.items():
        assert JAX_FIELDS[name] == jax_accepted(cls), name


@pytest.mark.parametrize("dialect", [
    {"dino_backbone": "test_tiny"},
    {"backbone_config": {"name": "test_tiny", "frozen": False}},
    {"backbones_config": [{"name": "test_tiny", "frozen": False}] * 4, "branches": [0, 1]},
])
def test_backbone_keys_build_the_backbone_jax_builds(dialect):
    kw = tiny_kwargs(**dialect)
    jmodel = jax_get_model("MultiDinoHashing", **kw)
    model = get_model("MultiDinoHashing", device="cpu", **kw)
    assert model.backbone.vit.embed_dim == 64 and jmodel.backbone == "test_tiny"
    assert model.frozen_backbone == jmodel.frozen_backbone


def test_dsln_key_is_dropped_for_the_banded_flagship_as_jax_drops_it():
    """C8: ``backbone_config.use_dsln`` becomes ``use_dsln``, which
    MultiDinoHashing does not declare: both factories build the flagship
    without per-domain LayerNorms."""
    kw = tiny_kwargs(backbone_config={"name": "test_tiny", "frozen": False, "use_dsln": True})
    jmodel = jax_get_model("MultiDinoHashing", **kw)
    model = get_model("MultiDinoHashing", device="cpu", **kw)
    assert resolved(model) == jax_resolved(jmodel)
    assert not any(isinstance(m, DomainLayerNorm) for m in model.modules())


def test_factory_drops_only_what_the_jax_factory_drops():
    base = {"backbone_name": "wcnn", "backbone": "resnet18", "num_classes": 3}
    # a key no JAX module declares: dropped by both factories
    model = get_model("RetrievalNet", device="cpu", **base, feature_size=512, wave="haar")
    assert len(model.backbone.branches) == 4
    # keys the JAX WCNN takes reach the port's: frozen_bn, and dtype
    model = get_model("RetrievalNet", device="cpu", **base, frozen_bn=True)
    assert model.backbone.branches[0].frozen_bn
    model = get_model("RetrievalNet", device="cpu", **dict(base, backbone_name="wcnn_attention"),
                      dtype="float32")
    assert not model.backbone.branches[0].frozen_bn
    model = get_model("RetrievalNet", device="cpu", **base, dtype="bfloat16")
    assert model.backbone.branches[0].dtype == torch.bfloat16
    # a key the JAX module takes and the port's does not: no silent drop
    with pytest.raises(NotImplementedError, match="takes \\['parent'\\]"):
        get_model("RetrievalNet", device="cpu", **base, parent=None)


@pytest.mark.parametrize("name", ["MultiDinoHashingTF", "MultiDinoHashing"])
def test_tanh_train_matches_jax(name):
    """Training mode returns tanh(logits) with ``tanh_train`` (identity
    logits without); eval mode the sign codes; both as the JAX model."""
    kw = tiny_kwargs(backbones_config=[{"name": "test_tiny", "frozen": False}] * 4)
    img = 28
    jmodel = jax_get_model(name, **kw)
    bands = np.random.RandomState(5).randn(4, 4, img, img, 3).astype(np.float32)
    rngs = {"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(1),
            "band_drop": jax.random.PRNGKey(2)}
    variables = jax.jit(lambda r, x: jmodel.init(r, x, train=False))(rngs, jnp.asarray(bands))
    variables = randomize(variables, 5)
    model = get_model(name, device="cpu",
                      **dict(kw, vit_kwargs=dict(kw["vit_kwargs"], img_size=img)))
    load_jax_variables(model, variables)
    assert model.tanh_train == (name == "MultiDinoHashingTF")

    (ref, _), _ = jmodel.apply(variables, jnp.asarray(bands), train=True,
                               mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(1),
                                     "band_drop": jax.random.PRNGKey(2)})
    model.train()
    with torch.no_grad():
        out, _ = model(torch.from_numpy(bands), {"dropout": torch.Generator().manual_seed(1),
                                                 "band_drop": torch.Generator().manual_seed(2)})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    assert (out.abs().max() < 1.0) == model.tanh_train
    model.eval()
    with torch.no_grad():
        codes, _ = model(torch.from_numpy(bands))
    jcodes, _ = jmodel.apply(variables, jnp.asarray(bands), train=False)
    assert set(np.unique(codes.numpy())) <= {-1.0, 1.0}
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))


def jax_resolved(jmodel) -> dict:
    """The fields a JAX model of the family resolved to, in the terms
    ``resolved`` reads off a port model."""
    kind = type(jmodel).__name__
    vit = jax_vit_config(jmodel.backbone, **(jmodel.vit_kwargs or {}))
    dim = JAX_VIT_DIMS[jmodel.backbone]
    head = jax_fusion_head(jmodel.fusion_config or {"output_dim": dim}, dim)
    out = {"kind": kind, "width": vit["embed_dim"], "depth": vit["depth"],
           "dtype": str(jnp.dtype(vit.get("dtype", jnp.float32))),
           "remat": bool(vit.get("remat_blocks", False)),
           "vmem_attn": bool(vit.get("vmem_attn", False)),
           "frozen": jmodel.frozen_backbone, "head": type(head).__name__,
           "head_width": head.embed_dim, "temperature": getattr(head, "temperature", None),
           "residual_query": getattr(head, "residual_query", False)}
    if kind != "MultiDinoAttention":
        out["nbits"] = jmodel.nbits
        out["use_bn"] = getattr(jmodel, "use_bn", True)
        out["tanh"] = getattr(jmodel, "tanh_train", kind == "SharedDinoHashing")
    if kind == "SharedDinoHashing":
        out["prompts"] = jmodel.num_prompts
        out["dsln"] = jmodel.use_dsln
    return out


def resolved(model) -> dict:
    kind = type(model).__name__
    vit = model.backbone.vit
    out = {"kind": kind, "width": vit.embed_dim, "depth": len(vit.blocks),
           "dtype": str(vit.dtype).replace("torch.", ""), "remat": vit.remat_blocks,
           "vmem_attn": vit.blocks[0].attn.core.__name__ == "vmem_attention_fn",
           "frozen": model.frozen_backbone, "head": type(model.head).__name__,
           "head_width": model.head.embed_dim,
           "temperature": getattr(model.head, "temperature", None),
           "residual_query": getattr(model.head, "residual_query", False)}
    if kind != "MultiDinoAttention":
        out["nbits"] = model.hash_head.linear.weight.shape[0]
        out["use_bn"] = model.hash_head.bn is not None
        out["tanh"] = getattr(model, "tanh_train", kind == "SharedDinoHashing")
    if kind == "SharedDinoHashing":
        out["prompts"] = model.num_prompts
        out["dsln"] = model.use_dsln
    return out


@pytest.mark.parametrize("config", FAMILY)
def test_family_config_builds_what_jax_builds(config):
    """Full width, construction only: the port's parameters on the meta
    device, the JAX module unbound."""
    with open(REPO / "configs/model" / f"{config}.yaml") as f:
        cfg = yaml.safe_load(f)
    jmodel = jax_get_model(cfg["name"], **cfg["kwargs"])
    with torch.device("meta"):
        model = MODEL_REGISTRY[cfg["name"]](torch.device("cpu"), **cfg["kwargs"])
    assert resolved(model) == jax_resolved(jmodel)
    if config.startswith("shareddino_attention_hashing_ortho_prtun"):
        # C9: only num_prompts reaches the model; every field else is the default
        assert resolved(model) == dict(resolved_defaults(), prompts=10)


def resolved_defaults() -> dict:
    return {"kind": "SharedDinoHashing", "width": 384, "depth": 12, "dtype": "float32",
            "remat": False, "vmem_attn": False, "frozen": True, "head": "StandardFusionHead",
            "head_width": 384, "temperature": None, "residual_query": False, "nbits": 64,
            "use_bn": True, "tanh": True, "dsln": False}


def test_bn_ablation_job_without_batch_norm_builds_through_the_getter():
    """studies/bn_ablation_hard_cpu.yaml's use_bn=false job: composed by the
    port and JAX alike, and its model built by the port's getter without the
    hash head's BatchNorm."""
    from irw_tpu.config import compose as jax_compose

    jobs = expand_jobs(load_plan(REPO / "studies/bn_ablation_hard_cpu.yaml"))
    (_, overrides), *_ = [(n, o) for n, o in jobs if "model.kwargs.use_bn=False" in o]
    cfg = compose(CONFIG_DIR, "default", overrides)
    assert cfg.to_dict() == jax_compose(CONFIG_DIR, "default", overrides).to_dict()
    model = Getter().get_model(cfg.model, device="cpu")
    jmodel = jax_get_model(cfg.model.name, **cfg.model.kwargs.to_dict())
    assert model.hash_head.bn is None and model.hash_head.linear.bias is not None
    assert resolved(model) == jax_resolved(jmodel)
    assert resolved(model)["nbits"] == 32 and not model.frozen_backbone


# --- every file of configs/model/ through compose -------------------------------------

# the single-trunk models' configs (ROADMAP A10c1: the first 8; A10c2: the rest)
SINGLE_TRUNK = ("single_band_tiny", "single_band", "detail_tester", "dino_hash_baseline",
                "dino_hashing", "dino_default", "multi_dino", "multi_dino_v3",
                "resnet", "resnet50", "resnet50_ce", "resnet50_tanh", "resnet_ce", "resnet_dsch",
                "resnet_hashing", "resnet_hashing_2", "resnet_max_ln", "dino", "dino_v3", "deit",
                "ibot", "convnext")
WCNN_FAMILY = ("wcnn", "wcnn_all_subs", "wcnn_attention", "wcnn_attention_ce",
               "wcnn_attention_wo_dwt", "wresnet_text", "wcnn_attention_all_subs")
# the in-model-DWT and staged multi-branch wavelet CNNs (ROADMAP A10b;
# tests/test_torch_wavenet_configs.py holds them to the JAX factory)
WAVENETS = ("wresnet", "wresnet_cifar", "wresnet_cifar_ce", "wresnet_sdd", "wresnet_sdd_ce",
            "mtwavenet", "mtwavenet50", "mtwavenet50_fusion", "mtwavenet_fusion",
            "mtwavenet_fusion_dml", "mtwavenet_tuned", "hybrid_wavenet", "hybrid_wavenet_v2")
# the HF vision wrapper's towers (ROADMAP A10d; tests/test_torch_hf_towers.py
# holds them to the JAX factory)
HF_TOWERS = ("openclip", "metaclip2", "siglip2")
MODEL_CONFIGS = sorted(p.stem for p in (REPO / "configs/model").glob("*.yaml"))


def test_model_configs_split_into_built_and_later():
    """Every file of ``configs/model`` is in a built group; none is left for later."""
    built = set(FAMILY) | set(SINGLE_TRUNK) | set(WCNN_FAMILY) | set(WAVENETS) | set(HF_TOWERS)
    assert len(MODEL_CONFIGS) == 58 and len(built) == 58 and built == set(MODEL_CONFIGS)


def _composed(config):
    cfg = compose(CONFIG_DIR, "default", [f"model={config}"])
    return cfg.model.name, cfg.model.kwargs.to_dict()


@pytest.mark.parametrize("config", MODEL_CONFIGS)
def test_model_config_composes_and_builds_or_names_its_item(config):
    """The default composition with ``model=<config>``: its model builds on
    the meta device."""
    name, kwargs = _composed(config)
    with torch.device("meta"):
        model = MODEL_REGISTRY[name](torch.device("cpu"), **kwargs)
    assert next(model.parameters()).is_meta


def _jax_tower(cfg: dict) -> tuple:
    return ("ViT", cfg["embed_dim"], cfg["depth"], cfg.get("patch_size", 14),
            str(jnp.dtype(cfg.get("dtype") or jnp.float32)), bool(cfg.get("remat_blocks")),
            bool(cfg.get("vmem_attn")))


def _tower(vit) -> tuple:
    return ("ViT", vit.embed_dim, len(vit.blocks), vit.patch_embed.patch_size,
            str(vit.dtype).replace("torch.", ""), vit.remat_blocks,
            vit.blocks[0].attn.core.__name__ == "vmem_attention_fn")


_DEPTHS = {18: ((2, 2, 2, 2), "BasicBlock"), 101: ((3, 4, 23, 3), "Bottleneck")}


def _jax_trunk(trunk) -> tuple:
    kind = type(trunk).__name__
    if kind == "VisionTransformer":
        return _jax_tower({f: getattr(trunk, f) for f in ("embed_dim", "depth", "patch_size",
                                                          "dtype", "remat_blocks", "vmem_attn")})
    if kind == "ResNet":
        return ("ResNet", tuple(trunk.stage_sizes), trunk.block.__name__)
    return ("ConvNeXt", tuple(trunk.depths), tuple(trunk.dims))


def _trunk(trunk) -> tuple:
    kind = type(trunk).__name__
    if kind == "VisionTransformer":
        return _tower(trunk)
    if kind == "ResNet":
        ends = [0, *trunk.stage_ends]
        return ("ResNet", tuple(b - a for a, b in zip(ends[:-1], ends[1:])),
                type(trunk.blocks[0]).__name__)
    return ("ConvNeXt", trunk.depths, (trunk.stem.out_channels,
                                       *(d.out_channels for d in trunk.downsamples)))


def jax_single_resolved(jm) -> dict:
    """The fields a JAX single-trunk model resolved to."""
    kind = type(jm).__name__
    out = {"kind": kind}
    if kind in ("DINOHashBaseline", "SingleBandNet", "DinoModelCE", "MultiDinoModel"):
        out["tower"] = _jax_tower(jax_vit_config(jm.backbone, **(jm.vit_kwargs or {})))
        out["frozen"] = jm.frozen_backbone
        if kind == "SingleBandNet":
            out.update(band=jm.band, mode=jm.mode)
        if kind == "DINOHashBaseline" or (kind == "SingleBandNet" and jm.mode == "hashing"):
            out["nbits"] = jm.nbits
        if kind == "DinoModelCE":
            out["num_classes"] = jm.num_classes
        if kind == "MultiDinoModel":
            out["branches"] = tuple(jm.branches)
    elif kind == "RetrievalNet":
        out.update(trunk=_jax_trunk(jm.backbone), pooling=jm.pooling, standardize=jm.standardize,
                   without_fc=jm.without_fc, frozen=jm.frozen_backbone)
        if not jm.without_fc:
            out.update(embed_dim=jm.embed_dim, projection_norm=jm.projection_norm)
    elif kind in ("ResNetCE", "ResNetHashing"):
        stages, block = _DEPTHS.get(jm.depth, ((3, 4, 6, 3), "Bottleneck"))
        out.update(trunk=("ResNet", stages, block), frozen_bn=jm.frozen_bn,
                   width=jm.num_classes if kind == "ResNetCE" else jm.nbits)
    else:  # ResNet50Mod
        out["width"] = jm.n_bits
    return out


def single_resolved(model) -> dict:
    """``jax_single_resolved``'s fields, read off a port model."""
    kind = type(model).__name__
    out = {"kind": kind}
    if kind in ("DINOHashBaseline", "SingleBandNet", "DinoModelCE", "MultiDinoModel"):
        vit = model.backbone.vit if kind == "MultiDinoModel" else model.backbone
        out["tower"] = _tower(vit)
        out["frozen"] = model.frozen_backbone
        if kind == "SingleBandNet":
            out.update(band=model.band, mode=model.mode)
        if getattr(model, "hash_head", None) is not None:
            out["nbits"] = model.hash_head.linear.weight.shape[0]
        if kind == "DinoModelCE":
            out["num_classes"] = model.classifier.weight.shape[0]
        if kind == "MultiDinoModel":
            out["branches"] = model.branches
    elif kind == "RetrievalNet":
        out.update(trunk=_trunk(model.backbone), pooling=model.pooling,
                   standardize=model.norm is not None, without_fc=model.fc is None,
                   frozen=model.frozen_backbone)
        if model.fc is not None:
            out.update(embed_dim=model.fc.layers[-1].weight.shape[0],
                       projection_norm=model.fc.norm_kind)
    elif kind in ("ResNetCE", "ResNetHashing"):
        out.update(trunk=_trunk(model.trunk), frozen_bn=model.trunk.frozen_bn,
                   width=model.fc.weight.shape[0])
    else:  # ResNet50Mod
        out["width"] = model.dsch.fc.weight.shape[0]
    return out


@pytest.mark.parametrize("config", SINGLE_TRUNK)
def test_single_trunk_config_builds_what_jax_builds(config):
    """Full width, construction only, after ``compose``: the traps mirrored
    (``with_autocast`` a bf16 ViT only through the class adapters and
    ``build_single_band``; no RetrievalNet route remats or takes K2; a
    ResNet trunk's ``pooling`` inert; ``vit_deit_distilled`` a DeiT-S/16)."""
    name, kwargs = _composed(config)
    jmodel = jax_get_model(name, **kwargs)
    with torch.device("meta"):
        model = MODEL_REGISTRY[name](torch.device("cpu"), **kwargs)
    resolved_ = single_resolved(model)
    assert resolved_ == jax_single_resolved(jmodel)
    tower = resolved_.get("tower") or resolved_.get("trunk")
    if config in ("single_band", "detail_tester", "dino_hashing"):
        assert tower[4] == "bfloat16"
    elif tower and tower[0] == "ViT":
        assert tower[4] == "float32" and not tower[5] and not tower[6]
    if config == "deit":
        assert tower[1:4] == (384, 12, 16)
