"""Model registry: name → constructor (port of
``irw_tpu/models/registry.py:56-63, 73-81, 88-91, 109-135`` for the models
the port serves: the multi-band ViT family and the wavelet-CNN family).

``get_model`` builds on the CPU, draws the weights from a seeded
``torch.Generator``, moves the model to ``device`` and returns it in eval
mode.  ``device=None`` means the card; without a GPU it raises unless
``device="cpu"`` is passed.
"""

from __future__ import annotations

import torch

from irw_tpu_torch.device import resolve_device
from irw_tpu_torch.models import multi_dino, wresnet
from irw_tpu_torch.models.factory import REFERENCE_ENTRIES, build_retrieval_net


def _direct(cls, **fixed):
    return lambda device, **kw: cls(**kw, **fixed)


MODEL_REGISTRY = {
    # reference-preset class names, reference kwargs dialect (factory.py)
    **REFERENCE_ENTRIES,
    "RetrievalNet": build_retrieval_net,
    "retrieval_net": build_retrieval_net,
    # native names (registry.py:56-63, 73-81)
    "multidino_attention": _direct(multi_dino.MultiDinoAttention),
    "multidino_attention_hashing": _direct(multi_dino.MultiDinoHashing),
    "multidino_attention_hashing_ortho": _direct(multi_dino.MultiDinoHashing),
    "multidino_hashing_tf": _direct(multi_dino.MultiDinoHashing, tanh_train=True),
    "shared_dino_hashing": _direct(multi_dino.SharedDinoHashing),
    "prompted_shared_dino_hashing": _direct(multi_dino.PromptedSharedDinoHashing),
    "pretrained_multidino_hashing": _direct(multi_dino.PretrainedMultiDinoHashing),
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
    configs.  Other models of the JAX registry wait for ROADMAP A10b–A10d.  Weights
    are drawn on the CPU, then moved: the same seed gives the same model on
    either device.
    """
    device = resolve_device(device)
    try:
        ctor = MODEL_REGISTRY[name]
    except KeyError as exc:
        raise ValueError(f"unknown model {name!r}; this slice serves "
                         f"{sorted(MODEL_REGISTRY)} (the rest: ROADMAP A10b-A10d)") from exc
    model = ctor(device, **kwargs)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
