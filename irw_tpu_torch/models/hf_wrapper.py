"""The HF vision wrapper (port of ``irw_tpu/models/hf_wrapper.py``): a
CLIP, ViT or SigLIP tower built from a config preset, its pooled output
L2-normalised.

``HF_DEFAULT_CONFIGS`` are the JAX package's presets; ``tower_config`` is
the ``config_overrides`` dialect of its ``build_hf_config`` (the keys
``hidden_size``, ``num_hidden_layers``, ``num_attention_heads``,
``image_size``, ``patch_size``, ``intermediate_size`` (4 × hidden_size by
default), and ``hidden_act`` and ``layer_norm_eps`` where given, else the
tower's own default).  The towers are native (``models/hf_towers.py``,
``models/siglip.py``); pretrained weights are carried in by ``bridge`` from
a converted flax tree.
"""

from __future__ import annotations

from torch import nn

from irw_tpu_torch.models.hf_towers import CLIPVisionTower, ViTTower
from irw_tpu_torch.models.layers import l2_normalize, zero_aux
from irw_tpu_torch.models.siglip import SiglipVisionTower

HF_DEFAULT_CONFIGS = {
    "clip_vit_b32": dict(kind="clip", hidden_size=768, num_hidden_layers=12,
                         num_attention_heads=12, image_size=224, patch_size=32),
    "clip_vit_b16": dict(kind="clip", hidden_size=768, num_hidden_layers=12,
                         num_attention_heads=12, image_size=224, patch_size=16),
    "vit_b16_hf": dict(kind="vit", hidden_size=768, num_hidden_layers=12,
                       num_attention_heads=12, image_size=224, patch_size=16),
    # google/siglip2-base-patch16-224: the SigLIP vision architecture
    "siglip2": dict(kind="siglip", hidden_size=768, num_hidden_layers=12,
                    num_attention_heads=12, image_size=224, patch_size=16),
    "metaclip2": dict(kind="clip", hidden_size=768, num_hidden_layers=12,
                      num_attention_heads=12, image_size=224, patch_size=16),
}


def tower_config(variant: str, **overrides) -> tuple[str, dict]:
    """(kind, the tower's constructor kwargs) of ``variant`` with
    ``overrides`` (``build_hf_config``'s dialect)."""
    cfg = {**HF_DEFAULT_CONFIGS[variant], **overrides}
    kw = {k: cfg[k] for k in ("hidden_size", "num_hidden_layers", "num_attention_heads",
                              "image_size", "patch_size")}
    kw["intermediate_size"] = cfg.get("intermediate_size", cfg["hidden_size"] * 4)
    kw.update({k: cfg[k] for k in ("hidden_act", "layer_norm_eps") if k in cfg})
    return cfg["kind"], kw


class HuggingFaceVisionWrapper(nn.Module):
    """The tower's pooled output, L2-normalised with ``normalize``:
    (B, H, W, C) → ((B, D), {"ortho_loss": 0})."""

    def __init__(self, variant: str = "clip_vit_b16", normalize: bool = True,
                 config_overrides: dict | None = None):
        super().__init__()
        self.variant = variant
        self.normalize = normalize
        kind, kw = tower_config(variant, **(config_overrides or {}))
        self.out_dim = kw["hidden_size"]
        if kind == "siglip":  # the JAX module's field names
            kw["num_layers"] = kw.pop("num_hidden_layers")
            kw["num_heads"] = kw.pop("num_attention_heads")
        self.tower = {"clip": CLIPVisionTower, "vit": ViTTower,
                      "siglip": SiglipVisionTower}[kind](**kw)

    def reset_parameters(self, generator=None):
        self.tower.reset_parameters(generator)

    def forward(self, x, rngs: dict | None = None):
        pooled, _ = self.tower(x)
        return (l2_normalize(pooled) if self.normalize else pooled), zero_aux(pooled)
