"""Model registry: name → constructor (port of
``irw_tpu/models/registry.py``: the multi-band ViT family, the wavelet CNNs
(WCNN, WaveResNet, the mtwavenet family and the hybrid), the baselines and
the single-trunk models, the HF vision wrapper's presets, and the bare
trunks).  A bare trunk (``resnet50``,
``densenet121``, ``convnext``, ``vit_small``, …) returns its pooled (B, D)
features without an aux dict, as the JAX registry's.

``get_model`` builds on the CPU, draws the weights from a seeded
``torch.Generator``, moves the model to ``device`` and returns it in eval
mode.  ``device=None`` means the card; without a GPU it raises unless
``device="cpu"`` is passed.
"""

from __future__ import annotations

import torch

from irw_tpu_torch.device import resolve_device
from irw_tpu_torch.models import (baselines, convnext, densenet, hashing_nets, mtwavenet,
                                  multi_dino, resnet, wresnet)
from irw_tpu_torch.models.factory import REFERENCE_ENTRIES, build_retrieval_net
from irw_tpu_torch.models.hf_towers import CLIPVisionTower, ViTTower
from irw_tpu_torch.models.hf_wrapper import HF_DEFAULT_CONFIGS, HuggingFaceVisionWrapper
from irw_tpu_torch.models.vit import VisionTransformer, make_vit


def _direct(cls, **fixed):
    return lambda device, **kw: cls(**kw, **fixed)


def _vit(name: str):
    return lambda device, **kw: make_vit(name, **kw)


MODEL_REGISTRY = {
    # reference-preset class names, reference kwargs dialect (factory.py)
    **REFERENCE_ENTRIES,
    "RetrievalNet": build_retrieval_net,
    "retrieval_net": build_retrieval_net,
    # native names (registry.py:35-85): plain trunks
    "resnet18": _direct(resnet.resnet18),
    "resnet34": _direct(resnet.resnet34),
    "resnet50": _direct(resnet.resnet50),
    "resnet101": _direct(resnet.resnet101),
    "densenet121": _direct(densenet.densenet121),
    "convnext": _direct(convnext.convnext_tiny),
    "convnext_tiny": _direct(convnext.convnext_tiny),
    "convnext_small": _direct(convnext.convnext_small),
    "vit_small": _vit("vit_small"),
    "vit_base": _vit("vit_base"),
    "vit_tiny": _vit("vit_tiny"),
    "deit_small": _vit("deit_small"),
    "dino": _vit("dinov2_vits14"),
    # CE and hashing single trunks
    "resnet_ce": _direct(hashing_nets.ResNetCE),
    "resnet18_ce": _direct(hashing_nets.ResNetCE, depth=18),
    "resnet50_tanh": _direct(hashing_nets.ResNetHashing),
    "resnet_hashing_2": _direct(hashing_nets.ResNetHashing),
    "resnet_hashing_alpha": _direct(hashing_nets.ResNetHashingAlpha),
    "resnet50_dsch": _direct(hashing_nets.ResNet50DSCH),
    "resnet50_mod": _direct(hashing_nets.ResNet50Mod),
    # the baselines
    "dino_ce": _direct(baselines.DinoModelCE),
    "multi_dino": _direct(baselines.MultiDinoModel),
    "dino_hash_baseline": _direct(baselines.DINOHashBaseline),
    "single_band_net": _direct(baselines.SingleBandNet),
    "detail_tester": _direct(baselines.DetailTesterNet),
    # the multi-band ViT and wavelet-CNN families
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
    "wresnet": _direct(wresnet.WaveResNet),
    "wresnet_ce": _direct(wresnet.WaveResNetCE),
    "mtwavenet": _direct(mtwavenet.FourBranchResNet, depth=18),
    "mtwavenet50": _direct(mtwavenet.FourBranchResNet50),
    "mtwavenet50_fusion": _direct(mtwavenet.FourBranchResNet50Fusion),
    "hybrid_mtwavenet_ce": _direct(mtwavenet.HybridMultiBranch),
    "hybrid_mtwavenet_v2_ce": _direct(mtwavenet.HybridMultiBranchV2),
    # the HF vision wrapper's presets (registry.py:94-106); clip and openclip
    # alias clip_vit_b16
    **{variant: _direct(HuggingFaceVisionWrapper, variant=variant)
       for variant in HF_DEFAULT_CONFIGS},
}
MODEL_REGISTRY["clip"] = MODEL_REGISTRY["openclip"] = MODEL_REGISTRY["clip_vit_b16"]


def get_model(name: str, device: str | torch.device | None = None, seed: int = 0,
              image_size: tuple[int, int] | None = None, **kwargs):
    """Instantiate a registered model with random weights from ``seed``.

    ``vit_kwargs["dtype"]`` and a CNN's ``dtype`` may be a string
    ('bfloat16'/'float16'/'float32') from YAML configs.  Weights are drawn on the CPU, then moved: the same seed gives the
    same model on either device.  ``image_size`` (height, width of the model's input, a
    band's for a band stack) sizes every ViT's position embeddings, as the
    JAX init sizes them from its sample input; without it a ViT takes its
    ``img_size``; the HF wrapper's SigLIP tower resizes its position table at
    each call and its CLIP and ViT towers raise on another patch count, as
    the JAX init does; the mtwavenet family with ``pool="none"`` sizes the
    layers after its pool from it (``fit_image``).
    """
    device = resolve_device(device)
    try:
        ctor = MODEL_REGISTRY[name]
    except KeyError as exc:
        raise ValueError(f"unknown model {name!r}; the port builds "
                         f"{sorted(MODEL_REGISTRY)}") from exc
    model = ctor(device, **kwargs)
    if image_size is not None:
        for mod in model.modules():
            if isinstance(mod, (VisionTransformer, CLIPVisionTower, ViTTower)):
                mod.fit_grid(*image_size)
        if hasattr(model, "fit_image"):
            model.fit_image(*image_size)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
