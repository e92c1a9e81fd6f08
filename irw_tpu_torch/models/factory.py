"""Reference-config dialect for ``MultiDinoHashing`` (port of
``irw_tpu/models/factory.py:30-122, 275-300``).

The reference's presets name torch classes with their own kwargs dialect
(``backbones_config`` lists, ``binary_config.nbits``, ``with_autocast``);
the adapter accepts it verbatim, so ``configs/model/
multidino_attention_hashing_ortho.yaml``'s ``kwargs`` build the flagship.
Keys a module does not declare are dropped, as the JAX factory does.
"""

from __future__ import annotations

import inspect

import torch

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
