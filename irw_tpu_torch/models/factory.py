"""Reference-config dialect (port of ``irw_tpu/models/factory.py``).

The reference's presets name torch classes with their own kwargs dialect
(``backbones_config`` lists, ``binary_config.nbits``, ``with_autocast``,
``attention`` + ``attention_type`` pairs, ``backbone_name``/``detail_index``
…); the adapters accept it verbatim, so the multi-band ViT family's configs
(``configs/model/multidino_*.yaml``, ``shareddino_*.yaml``), the baselines'
(``single_band*``, ``detail_tester``, ``dino_hash*``), the wavelet-CNN
routes of ``RetrievalNet`` (``wcnn*``, ``wresnet*``, ``mtwavenet*``,
``hybrid_mtwavenet*``) and its single-trunk routes (the hashing ResNets,
``dino_ce``, ``multi_dino*``, and the embedding trunks it wraps) build their
models.  Keys the JAX module does not declare are dropped, as the JAX
factory drops them; a key the JAX module takes and the port's does not
raises.

Traps kept on purpose, as the JAX factory has them:

- ``PromptedSharedDinoHashing`` is a function ``(num_prompts=10, **kw)``,
  so the JAX factory's accepted set is its signature, {num_prompts, kw}, and
  it drops every other key of a config (factory.py:30-35).  The ``_prtun``
  configs therefore build a frozen f32 ``SharedDinoHashing`` with the
  ``standard`` head, 64 bits and no DSLN, whatever else they say;
- ``with_autocast`` is a parameter of ``build_retrieval_net``, so it never
  reaches the shared dialect there: every ``RetrievalNet`` route builds in
  f32, ``dino_ce`` and ``multi_dino*`` included; the class adapters and
  ``build_single_band`` pass it on, as a bf16 ViT (factory.py:84-85);
- a config's own ``dtype`` key (``+model.kwargs.dtype=bfloat16``) reaches
  every module that declares one, as the JAX factory hands it on: the
  wavelet CNNs and the hashing ResNets compute their trunks in it; the
  wrapped trunks (``resnet50``, ``convnext``, …) are built without it
  (factory.py:229-243) and stay f32, and ``mtwavenet50``'s function drops it
  with every other key;
- the embedding trunks are built without ``vit_kwargs`` (factory.py:229-249),
  so no ``RetrievalNet`` ViT trunk remats or takes K2/K3;
- a ResNet trunk returns pooled (B, C) features, so ``pooling`` does nothing
  (``resnet_max_ln.yaml``'s ``max`` included);
- ``FourBranchResNet50`` is a function ``(**kw)`` too, so the
  ``mtwavenet50`` route builds it from no key at all: no classes (training
  returns the embedding), ``avg`` pooling, BatchNorm not frozen;
- ``WaveResNetCE`` and the mtwavenet classes declare no ``attention``, and
  the mtwavenet classes no ``pooling_mode`` (the field is ``pool``) and no
  ``freeze_batch_norm`` (the field is ``frozen_bn``): the configs' keys are
  dropped.  ``model.freeze_batch_norm`` at the config's top level is the
  freezing set (``utils.freezing``), another mechanism.
"""

from __future__ import annotations

import inspect
import logging

import torch

from irw_tpu_torch.models import (baselines, convnext, hashing_nets, mtwavenet, multi_dino,
                                  resnet, wresnet)
from irw_tpu_torch.models.hf_wrapper import HuggingFaceVisionWrapper
from irw_tpu_torch.models.retrieval_net import RetrievalNet
from irw_tpu_torch.models.vit import make_vit

LOGGER = logging.getLogger(__name__)


# the fields of each JAX module the factory builds (flax's ``parent`` and
# ``name`` included): the JAX factory passes these and drops every other key
# (irw_tpu/models/factory.py:30-52); tests/test_torch_factory.py holds each
# set to irw_tpu's modules
JAX_FIELDS = {
    "MultiDinoAttention": frozenset({"backbone", "fusion_config", "num_bands", "frozen_backbone",
                                     "vit_kwargs", "parent", "name"}),
    "MultiDinoHashing": frozenset({"backbone", "fusion_config", "nbits", "use_bn", "num_bands",
                                   "frozen_backbone", "tanh_train", "vit_kwargs", "parent",
                                   "name"}),
    "SharedDinoHashing": frozenset({"backbone", "fusion_config", "nbits", "num_bands",
                                    "frozen_backbone", "num_prompts", "use_dsln", "vit_kwargs",
                                    "parent", "name"}),
    # a function: its signature, the **kw parameter's name included
    "PromptedSharedDinoHashing": frozenset({"num_prompts", "kw"}),
    "WCNN": frozenset({"num_classes", "backbone", "ce", "frozen_bn", "dtype", "parent", "name"}),
    "WCNNAttention": frozenset({"num_classes", "attention", "ce", "backbone", "frozen_bn", "dtype",
                                "parent", "name"}),
    "DINOHashBaseline": frozenset({"backbone", "nbits", "frozen_backbone", "vit_kwargs", "parent",
                                   "name"}),
    "SingleBandNet": frozenset({"backbone", "band", "mode", "nbits", "frozen_backbone",
                                "vit_kwargs", "parent", "name"}),
    "DinoModelCE": frozenset({"backbone", "num_classes", "frozen_backbone", "vit_kwargs",
                              "parent", "name"}),
    "MultiDinoModel": frozenset({"backbone", "branches", "frozen_backbone", "vit_kwargs",
                                 "parent", "name"}),
    "ResNetCE": frozenset({"num_classes", "depth", "frozen_bn", "dtype", "parent", "name"}),
    "ResNetHashing": frozenset({"nbits", "depth", "frozen_bn", "dtype", "parent", "name"}),
    "ResNet50DSCH": frozenset({"n_bits", "double_pool", "use_layernorm", "normalize", "frozen_bn",
                               "dtype", "parent", "name"}),
    "ResNet50Mod": frozenset({"n_bits", "dtype", "parent", "name"}),
    "WaveResNet": frozenset({"decom_level", "wave", "feature_size", "attention", "ll_only",
                             "frozen_bn", "dtype", "parent", "name"}),
    "WaveResNetCE": frozenset({"num_classes", "decom_level", "wave", "frozen_bn", "dtype",
                               "parent", "name"}),
    "FourBranchResNet": frozenset({"num_classes", "depth", "layernorm", "pool", "frozen_bn",
                                   "dtype", "parent", "name"}),
    # a function, as PromptedSharedDinoHashing
    "FourBranchResNet50": frozenset({"kw"}),
    "FourBranchResNet50Fusion": frozenset({"num_classes", "pool", "frozen_bn", "dtype",
                                           "parent", "name"}),
    "HybridMultiBranch": frozenset({"num_classes", "frozen_bn", "dtype", "parent", "name"}),
}


def _filter_kwargs(ctor, kw: dict, renames: dict | None = None) -> dict:
    """The keys of ``kw`` (after ``renames``) that ``ctor`` takes.  A key it
    does not take is dropped where the JAX factory drops it too; one the JAX
    module takes raises, rather than build another model without a word."""
    accepted = set(inspect.signature(ctor).parameters)
    jax_fields = JAX_FIELDS[ctor.__name__]
    renames = renames or {}
    out, missing = {}, []
    for k, v in kw.items():
        k2 = renames.get(k, k)
        if k2 in accepted:
            out[k2] = v
        elif k2 in jax_fields:
            missing.append(k2)
    if missing:
        raise NotImplementedError(f"{ctor.__name__}: the JAX model takes {sorted(missing)}, "
                                  "which the port does not take")
    return out


def pop_common(kw: dict, device: torch.device) -> dict:
    """Normalise the shared reference dialect (factory.py:54-109).

    - ``with_autocast`` → the bf16 compute policy;
    - ``binary_config.nbits`` → ``nbits``;
    - ``backbones_config[0]``, or a single ``backbone_config``, →
      ``backbone`` and ``frozen_backbone``, and its ``use_dsln``
      (domain-specific LayerNorm) → ``use_dsln``, which ``SharedDinoHashing``
      takes and the filter drops for every other module;
    - unfrozen backbones → block remat with policy ``"nothing"``
      (factory.py:86-88) and ``vmem_attn`` on the card (factory.py:106 reads
      "on TPU"; here it means kernels K2 and K3 on a CUDA device).
    """
    kw = dict(kw)
    autocast = kw.pop("with_autocast", None)
    kw.pop("modelhooks", None)
    binary = kw.pop("binary_config", None)
    if isinstance(binary, dict) and binary.get("nbits") is not None:
        kw.setdefault("nbits", int(binary["nbits"]))
    bcfgs = kw.pop("backbones_config", None)
    if bcfgs:
        first = dict(bcfgs[0])
        kw.setdefault("backbone", first.get("name", "dinov2_vits14"))
        kw.setdefault("frozen_backbone", bool(first.get("frozen", False)))
    bcfg = kw.pop("backbone_config", None)
    if bcfg:
        kw.setdefault("backbone", bcfg.get("name", "dinov2_vits14"))
        kw.setdefault("frozen_backbone", bool(bcfg.get("frozen", False)))
        if bcfg.get("use_dsln"):
            kw.setdefault("use_dsln", True)
    vit_kw = dict(kw.get("vit_kwargs") or {})
    if autocast:
        vit_kw.setdefault("dtype", "bfloat16")
    if kw.get("frozen_backbone") is False:
        vit_kw.setdefault("remat_blocks", True)
        vit_kw.setdefault("remat_policy", "nothing")
        vit_kw.setdefault("vmem_attn", device.type == "cuda")
    if vit_kw:
        kw["vit_kwargs"] = vit_kw
    return kw


def class_adapter(cls, renames: dict | None = None, **fixed):
    """The class adapter of ``reference_model_entries`` (factory.py:112-122):
    the shared dialect, then ``fixed`` (``MultiDinoHashingTF``:
    ``tanh_train=True``; ``PretrainedMultiDinoHashing``:
    ``frozen_backbone=True``, over the config's), a list ``branches`` as a
    tuple, ``dino_backbone`` read as ``backbone`` (and ``renames``), and the
    keys ``cls`` takes."""
    renames = {"dino_backbone": "backbone", **(renames or {})}

    def build(device: torch.device, **kw):
        kw = pop_common(kw, device)
        kw.update(fixed)
        if isinstance(kw.get("branches"), list):
            kw["branches"] = tuple(kw["branches"])
        return cls(**_filter_kwargs(cls, kw, renames))

    return build


def build_single_band(device: torch.device, **kw):
    """``SingleBandNet``/``DetailTesterNet`` (factory.py:125-139): the
    reference keys ``backbone_name``, ``detail_index``, ``is_hashing``
    (hashing unless false) and ``output_dim`` (the bit count in hashing
    mode, dropped in metric mode)."""
    kw = pop_common(kw, device)
    is_hashing = kw.pop("is_hashing", True)
    kw.setdefault("mode", "hashing" if is_hashing else "metric")
    out_dim = kw.pop("output_dim", None)
    if out_dim and kw["mode"] == "hashing":
        kw.setdefault("nbits", int(out_dim))
    return baselines.SingleBandNet(**_filter_kwargs(
        baselines.SingleBandNet, kw,
        {"backbone_name": "backbone", "detail_index": "band", "dino_backbone": "backbone"}))


_N_BITS = {"nbits": "n_bits", "num_bits": "n_bits"}


REFERENCE_ENTRIES = {
    "MultiDinoAttention": class_adapter(multi_dino.MultiDinoAttention),
    "MultiDinoHashing": class_adapter(multi_dino.MultiDinoHashing),
    "MultiDinoHashingTF": class_adapter(multi_dino.MultiDinoHashing, tanh_train=True),
    "PretrainedMultiDinoHashing": class_adapter(multi_dino.MultiDinoHashing,
                                                frozen_backbone=True),
    "SharedDinoHashing": class_adapter(multi_dino.SharedDinoHashing),
    "PromptedSharedDinoHashing": class_adapter(multi_dino.PromptedSharedDinoHashing),
    "DINOHashBaseline": class_adapter(baselines.DINOHashBaseline),
    "SingleBandNet": build_single_band,
    "DetailTesterNet": build_single_band,
    "ResNet50Mod": class_adapter(hashing_nets.ResNet50Mod, _N_BITS),
    "ResNet50DSCH": class_adapter(hashing_nets.ResNet50DSCH, _N_BITS),
}


def _attention_kw(kw: dict) -> dict:
    """The reference pairs a bool ``attention`` with an ``attention_type``
    string; the modules take one ``attention`` string (factory.py:142-153)."""
    out = dict(kw)
    att = out.pop("attention", None)
    atype = out.pop("attention_type", "cbam")
    if att is True:
        out["attention"] = atype
    elif isinstance(att, str) and att:
        out["attention"] = att
    return out


# backbone_name → (module, attention kwargs, ce): the wavelet-CNN trunks
# (factory.py:194-201)
_WCNN_ROUTES = {
    "wcnn": (wresnet.WCNN, False, False),
    "wcnn_ce": (wresnet.WCNN, False, True),
    "wcnn_attention": (wresnet.WCNNAttention, True, False),
    "wcnn_attention_ce": (wresnet.WCNNAttention, True, True),
}
_HASH_RENAMES = {"num_bits": "nbits", "n_bits": "nbits"}
# backbone_name → (module, fixed kwargs): the in-model-DWT and staged
# multi-branch trunks, each given the attention pair as one string
# (factory.py:190-193, :218-227)
_WAVENET_ROUTES = {
    "wresnet": (wresnet.WaveResNet, {}),
    "wresnet_ce": (wresnet.WaveResNetCE, {}),
    "mtwavenet": (mtwavenet.FourBranchResNet, {"depth": 18}),
    "mtwavenet50": (mtwavenet.FourBranchResNet50, {}),
    "mtwavenet50_fusion": (mtwavenet.FourBranchResNet50Fusion, {}),
    "hybrid_mtwavenet_ce": (mtwavenet.HybridMultiBranch, {}),
    "hybrid_mtwavenet_v2_ce": (mtwavenet.HybridMultiBranchV2, {}),
}
# backbone_name → the HF vision wrapper's variant (factory.py:250-256)
_HF_ROUTES = {"clip": "clip_vit_b16", "openclip": "clip_vit_b16", "siglip2": "siglip2",
              "metaclip2": "metaclip2"}


def _direct(device, cls, kw, renames=None, **fixed):
    """factory.py:184-187: the shared dialect, the keys ``cls`` takes, then
    ``fixed``."""
    kw = _filter_kwargs(cls, pop_common(kw, device), renames)
    kw.update(fixed)
    return cls(**kw)


def _passthrough(device, name: str, kw: dict):
    """The trunks the reference's forward returns untouched
    (factory.py:184-227), or None for a wrapped embedding trunk."""
    if name in _WCNN_ROUTES:
        cls, attention, ce = _WCNN_ROUTES[name]
        if attention:
            kw = _attention_kw(kw)
        kw = pop_common(kw, device)
        kw.setdefault("num_bands", _subband_count(kw.get("decom_level", 1),
                                                  kw.get("coarse_only", True)))
        return cls(**dict(_filter_kwargs(cls, kw), ce=ce))
    if name == "resnet_ce":
        return _direct(device, hashing_nets.ResNetCE, kw, depth=50)
    if name == "resnet18_ce":
        return _direct(device, hashing_nets.ResNetCE, kw, depth=18)
    if name in ("resnet50_tanh", "resnet_hashing_2"):
        return _direct(device, hashing_nets.ResNetHashing, kw, _HASH_RENAMES, depth=50)
    if name == "dino_ce":
        return _direct(device, baselines.DinoModelCE, kw, {"dino_backbone": "backbone"})
    if name in ("multi_dino", "multi_dino_v3"):
        kw = pop_common(kw, device)
        if isinstance(kw.get("branches"), list):
            kw["branches"] = tuple(kw["branches"])
        return baselines.MultiDinoModel(**_filter_kwargs(baselines.MultiDinoModel, kw,
                                                         {"dino_backbone": "backbone"}))
    if name in _WAVENET_ROUTES:
        cls, fixed = _WAVENET_ROUTES[name]
        return _direct(device, cls, _attention_kw(kw), **fixed)
    return None


def _embedding_trunk(name: str, kw: dict):
    """The trunk ``RetrievalNet`` wraps (factory.py:229-261), built without
    ``vit_kwargs``."""
    if name in ("resnet18", "resnet50", "resnet101"):
        return getattr(resnet, name)()
    if name == "vit":
        return make_vit("vit_small", patch_size=16)
    if name.startswith("vit_deit"):
        return make_vit("deit_base" if "base" in name else "deit_small", patch_size=16)
    if name in ("dino", "dino_v3"):
        return make_vit(kw.get("dino_backbone", "dinov2_vits14"))
    if name == "convnext":
        bb = kw.get("bb_name", "convnext_tiny")
        return convnext.convnext_small() if "small" in bb else convnext.convnext_tiny()
    if name == "ibot":
        bb = kw.get("bb_name", "vit_small")
        return make_vit("vit_base" if "base" in bb else "vit_small", patch_size=16)
    if name in _HF_ROUTES:
        return HuggingFaceVisionWrapper(variant=_HF_ROUTES[name])
    raise ValueError(f"RetrievalNet: unknown backbone_name {name!r} (net.py:20-414 dispatch)")


def build_retrieval_net(device: torch.device, backbone_name: str, embed_dim: int = 512,
                        norm_features=False, without_fc=False, with_autocast=False,
                        pooling: str = "default", projection_normalization_layer: str = "none",
                        pretrained=False, frozen=False, **kw):
    """``RetrievalNet`` presets (factory.py:158-272).  Two routes, as the
    reference's: the trunks its forward returns untouched (the wavelet CNNs,
    the hashing ResNets, ``dino_ce``, ``multi_dino*``) build their module
    directly; every other trunk is wrapped by ``RetrievalNet`` (pool →
    standardize → projection → L2).  ``with_autocast`` and the wrapper's own
    keys (``embed_dim``, ``pooling``, …) do not reach a passthrough trunk;
    ``pretrained`` hub weights do not exist offline, so the flag only logs."""
    if pretrained:
        LOGGER.info(f"model preset asks pretrained={pretrained!r} for {backbone_name!r}: the "
                    "port draws random weights (load converted ones with bridge)")
    model = _passthrough(device, backbone_name, kw)
    if model is not None:
        return model
    proj_norm = projection_normalization_layer
    return RetrievalNet(_embedding_trunk(backbone_name, kw), embed_dim=int(embed_dim),
                        pooling=pooling, standardize=bool(norm_features),
                        projection_norm=None if proj_norm in (None, "none") else proj_norm,
                        without_fc=bool(without_fc), frozen_backbone=bool(frozen))


def _subband_count(levels, coarse_only=True) -> int:
    """Bands of ``CustomTransform``'s stack (transforms/pipeline.py): the
    coarsest level's [LL, LH, HL, HH], or with ``coarse_only`` False and
    more than one level every level's details around one LL, 3·levels + 1.
    The JAX modules read the count from their input; the port builds that
    many branches."""
    levels = int(levels)
    return 4 if coarse_only or levels == 1 else 3 * levels + 1
