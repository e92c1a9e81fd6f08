"""Multi-band ViT hashing model (port of
``irw_tpu/models/multi_dino.py:37-93, 125-156``).

``BandedViT`` holds the four per-band backbones as ONE ViT whose parameters
carry a leading band axis: per-band projections are batched matmuls over
that axis, and attention sees (S·B, N, H, hd), so a forward launches the
attention kernel once per block, not once per block and band.  Band input
layout is (B, S, H, W, C), S ordered [LL, LH, HL, HH].
"""

from __future__ import annotations

import torch
from torch import nn

from irw_tpu_torch.models.fusion import get_fusion_head
from irw_tpu_torch.models.layers import HashHead, binarize
from irw_tpu_torch.models.vit import VIT_DIMS, VisionTransformer, vit_config


class BandedViT(nn.Module):
    """(B, S, H, W, C) → CLS stack (B, S, D), independent weights per band."""

    def __init__(self, backbone: str = "dinov2_vits14", num_bands: int = 4,
                 vit_kwargs: dict | None = None):
        super().__init__()
        self.vit = VisionTransformer(**vit_config(backbone, **(vit_kwargs or {})),
                                     bands=num_bands)

    def reset_parameters(self, generator=None):
        self.vit.reset_parameters(generator)

    def forward(self, x, generator: torch.Generator | None = None):
        return self.vit(x.transpose(0, 1), generator).transpose(0, 1)


class MultiDinoHashing(nn.Module):
    """BandedViT → fusion head → HashHead (multi_dino.py:125-156).

    ``forward(x, rngs)`` returns ``(codes, aux)`` in eval mode (±1 codes) and
    ``(logits, aux)`` in training mode (``binarize(train=True,
    "identity")``), or ``tanh(logits)`` with ``tanh_train`` (the
    ``MultiDinoHashingTF`` continuation variant, multi_dino.py:151);
    ``forward_logits`` returns the logits in either mode.
    ``rngs`` maps flax's rng streams ``"dropout"`` and ``"band_drop"`` to
    ``torch.Generator``s.  ``frozen_backbone`` (the JAX default) runs the
    backbone in eval mode under ``no_grad`` and names it in
    ``frozen_param_collections``, which the optimizers leave out, as
    ``requires_grad=False`` did in the reference.
    """

    def __init__(self, backbone: str = "dinov2_vits14", fusion_config: dict | None = None,
                 nbits: int = 64, use_bn: bool = True, num_bands: int = 4,
                 frozen_backbone: bool = True, tanh_train: bool = False,
                 vit_kwargs: dict | None = None):
        super().__init__()
        dim = VIT_DIMS[backbone]
        self.frozen_backbone = frozen_backbone
        self.tanh_train = tanh_train
        self.backbone = BandedViT(backbone, num_bands, vit_kwargs)
        self.head = get_fusion_head(fusion_config or {"output_dim": dim}, dim, num_bands)
        self.hash_head = HashHead(self.head.embed_dim, nbits, use_bn)

    @property
    def frozen_param_collections(self) -> tuple:
        return ("backbone",) if self.frozen_backbone else ()

    def train(self, mode: bool = True):
        super().train(mode)
        if self.frozen_backbone:
            self.backbone.train(False)
        return self

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.backbone.reset_parameters(generator)
        self.head.reset_parameters(generator)
        self.hash_head.reset_parameters(generator)

    def forward_logits(self, x, rngs: dict | None = None):
        rngs = rngs or {}
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.frozen_backbone):
            bands = self.backbone(x, rngs.get("dropout"))
        fused, aux = self.head(bands, rngs)
        return self.hash_head(fused), aux

    def forward(self, x, rngs: dict | None = None):
        logits, aux = self.forward_logits(x, rngs)
        return binarize(logits, self.training, "tanh" if self.tanh_train else "identity"), aux
