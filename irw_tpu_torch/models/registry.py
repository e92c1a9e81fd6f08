"""Model registry: name → constructor (port of
``irw_tpu/models/registry.py:56-63, 74-75, 88-91, 109-135`` for the models
the port serves: the flagship and the wavelet-CNN family).

``get_model`` builds on the CPU, draws the weights from a seeded
``torch.Generator``, moves the model to ``device`` and returns it in eval
mode.  ``device=None`` means the card; without a GPU it raises unless
``device="cpu"`` is passed.
"""

from __future__ import annotations

import torch

from irw_tpu_torch.device import resolve_device
from irw_tpu_torch.models import wresnet
from irw_tpu_torch.models.factory import (
    build_multidino_hashing,
    build_retrieval_net,
    multidino_adapter,
)
from irw_tpu_torch.models.multi_dino import MultiDinoHashing


def _direct(cls, **fixed):
    return lambda device, **kw: cls(**kw, **fixed)


MODEL_REGISTRY = {
    # reference-preset class names, reference kwargs dialect (factory.py)
    "MultiDinoHashing": build_multidino_hashing,
    "MultiDinoHashingTF": multidino_adapter(tanh_train=True),
    "RetrievalNet": build_retrieval_net,
    "retrieval_net": build_retrieval_net,
    # native names (registry.py:56-63, 74-75)
    "multidino_attention_hashing": _direct(MultiDinoHashing),
    "multidino_attention_hashing_ortho": _direct(MultiDinoHashing),
    "wcnn": _direct(wresnet.WCNN, ce=False),
    "wcnn_ce": _direct(wresnet.WCNN, ce=True),
    "wcnn_all_subs": _direct(wresnet.WCNN_ALL),
    "wcnn_attention": _direct(wresnet.WCNNAttention, ce=False),
    "wcnn_attention_ce": _direct(wresnet.WCNNAttention, ce=True),
}


def get_model(name: str, device: str | torch.device | None = None, seed: int = 0,
              **kwargs):
    """Instantiate a registered model with random weights from ``seed``.

    ``vit_kwargs["dtype"]`` may be a string ('bfloat16'/'float32') from YAML
    configs.  Other models of the JAX registry wait for ROADMAP A10.  Weights
    are drawn on the CPU, then moved: the same seed gives the same model on
    either device.
    """
    device = resolve_device(device)
    try:
        ctor = MODEL_REGISTRY[name]
    except KeyError as exc:
        raise ValueError(f"unknown model {name!r}; this slice serves "
                         f"{sorted(MODEL_REGISTRY)} (the rest: ROADMAP A10)") from exc
    model = ctor(device, **kwargs)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
