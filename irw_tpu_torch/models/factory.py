"""Reference-config dialect for ``MultiDinoHashing`` and the wavelet-CNN
routes of ``RetrievalNet`` (port of ``irw_tpu/models/factory.py:30-122,
142-201, 275-300``).

The reference's presets name torch classes with their own kwargs dialect
(``backbones_config`` lists, ``binary_config.nbits``, ``with_autocast``,
``attention`` + ``attention_type`` pairs); the adapters accept it verbatim,
so ``configs/model/multidino_attention_hashing_ortho.yaml``'s and
``configs/model/wcnn_attention_ce.yaml``'s ``kwargs`` build their models.
Keys a module does not declare are dropped, as the JAX factory does.
"""

from __future__ import annotations

import inspect

import torch

from irw_tpu_torch.models import wresnet
from irw_tpu_torch.models.multi_dino import MultiDinoHashing


def _filter_kwargs(ctor, kw: dict) -> dict:
    accepted = set(inspect.signature(ctor).parameters)
    return {k: v for k, v in kw.items() if k in accepted}


def pop_common(kw: dict, device: torch.device) -> dict:
    """Normalise the shared reference dialect (factory.py:54-109).

    - ``with_autocast`` → the bf16 compute policy;
    - ``binary_config.nbits`` → ``nbits``;
    - ``backbones_config[0]`` → ``backbone`` and ``frozen_backbone``;
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


def build_multidino_hashing(device: torch.device, **kw) -> MultiDinoHashing:
    """The ``MultiDinoHashing`` entry of ``reference_model_entries``."""
    return MultiDinoHashing(**_filter_kwargs(MultiDinoHashing, pop_common(kw, device)))


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
    embedding route, wait for ROADMAP A10."""
    if backbone_name not in _WCNN_ROUTES:
        raise ValueError(f"RetrievalNet: backbone_name {backbone_name!r} waits for ROADMAP "
                         f"A10; this slice builds {sorted(_WCNN_ROUTES)}")
    cls, attention, ce = _WCNN_ROUTES[backbone_name]
    if attention:
        kw = _attention_kw(kw)
    return cls(**dict(_filter_kwargs(cls, pop_common(kw, device)), ce=ce))
