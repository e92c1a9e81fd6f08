"""Reference-config dialect for the multi-band ViT family and the
wavelet-CNN routes of ``RetrievalNet`` (port of
``irw_tpu/models/factory.py:30-122, 142-201, 275-300``).

The reference's presets name torch classes with their own kwargs dialect
(``backbones_config`` lists, ``binary_config.nbits``, ``with_autocast``,
``attention`` + ``attention_type`` pairs); the adapters accept it verbatim,
so the family's configs (``configs/model/multidino_*.yaml``,
``shareddino_*.yaml``) and ``configs/model/wcnn_attention_ce.yaml`` build
their models.  Keys the JAX module does not declare are dropped, as the JAX
factory drops them; a key the JAX module takes and the port's does not
raises, naming the ROADMAP item that will port it.

One drop is a trap kept on purpose: ``PromptedSharedDinoHashing`` is a
function ``(num_prompts=10, **kw)``, so the JAX factory's accepted set is
its signature, {num_prompts, kw}, and it drops every other key of a config
(factory.py:30-35).  The ``_prtun`` configs therefore build a frozen f32
``SharedDinoHashing`` with the ``standard`` head, 64 bits and no DSLN,
whatever else they say; the port builds the same.
"""

from __future__ import annotations

import inspect

import torch

from irw_tpu_torch.models import multi_dino, wresnet


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
                                  "which the port does not take yet (ROADMAP A10b)")
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


def class_adapter(cls, **fixed):
    """The class adapter of ``reference_model_entries`` (factory.py:112-122):
    the shared dialect, then ``fixed`` (``MultiDinoHashingTF``:
    ``tanh_train=True``; ``PretrainedMultiDinoHashing``:
    ``frozen_backbone=True``, over the config's), a list ``branches`` as a
    tuple, ``dino_backbone`` read as ``backbone``, and the keys ``cls``
    takes."""

    def build(device: torch.device, **kw):
        kw = pop_common(kw, device)
        kw.update(fixed)
        if isinstance(kw.get("branches"), list):
            kw["branches"] = tuple(kw["branches"])
        return cls(**_filter_kwargs(cls, kw, {"dino_backbone": "backbone"}))

    return build


REFERENCE_ENTRIES = {
    "MultiDinoAttention": class_adapter(multi_dino.MultiDinoAttention),
    "MultiDinoHashing": class_adapter(multi_dino.MultiDinoHashing),
    "MultiDinoHashingTF": class_adapter(multi_dino.MultiDinoHashing, tanh_train=True),
    "PretrainedMultiDinoHashing": class_adapter(multi_dino.MultiDinoHashing,
                                                frozen_backbone=True),
    "SharedDinoHashing": class_adapter(multi_dino.SharedDinoHashing),
    "PromptedSharedDinoHashing": class_adapter(multi_dino.PromptedSharedDinoHashing),
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


# backbone_name → (module, attention kwargs, ce): the passthrough trunks of
# this slice (factory.py:189-196)
_WCNN_ROUTES = {
    "wcnn": (wresnet.WCNN, False, False),
    "wcnn_ce": (wresnet.WCNN, False, True),
    "wcnn_attention": (wresnet.WCNNAttention, True, False),
    "wcnn_attention_ce": (wresnet.WCNNAttention, True, True),
}


def build_retrieval_net(device: torch.device, backbone_name: str, embed_dim: int = 512,
                        norm_features=False, without_fc=False, with_autocast=False,
                        pooling: str = "default", projection_normalization_layer: str = "none",
                        pretrained=False, frozen=False, **kw):
    """``RetrievalNet`` presets (factory.py:156-201): the wavelet-CNN trunks,
    which the reference's forward returns untouched, build their module
    directly.  ``with_autocast`` and the wrapper's own keys (``embed_dim``,
    ``pooling``, …) do not reach them; ``pretrained`` hub weights do not exist
    offline, so the flag does nothing.  Every other trunk, and the wrapped
    embedding route, wait for ROADMAP A10b (``wresnet``, ``mtwavenet``) and
    A10c (the embedding trunks)."""
    if backbone_name not in _WCNN_ROUTES:
        raise ValueError(f"RetrievalNet: backbone_name {backbone_name!r} waits for ROADMAP "
                         f"A10b or A10c; the port builds {sorted(_WCNN_ROUTES)}")
    cls, attention, ce = _WCNN_ROUTES[backbone_name]
    if attention:
        kw = _attention_kw(kw)
    kw = pop_common(kw, device)
    kw.setdefault("num_bands", _subband_count(kw.get("decom_level", 1), kw.get("coarse_only", True)))
    return cls(**dict(_filter_kwargs(cls, kw), ce=ce))


def _subband_count(levels, coarse_only=True) -> int:
    """Bands of ``CustomTransform``'s stack (transforms/pipeline.py): the
    coarsest level's [LL, LH, HL, HH], or with ``coarse_only`` False and
    more than one level every level's details around one LL, 3·levels + 1.
    The JAX modules read the count from their input; the port builds that
    many branches."""
    levels = int(levels)
    return 4 if coarse_only or levels == 1 else 3 * levels + 1
