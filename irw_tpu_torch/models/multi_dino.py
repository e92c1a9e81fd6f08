"""Multi-band ViT hashing model, eval forward (port of
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

    def forward(self, x):
        return self.vit(x.transpose(0, 1)).transpose(0, 1)


class MultiDinoHashing(nn.Module):
    """BandedViT → fusion head → HashHead; ±1 codes in eval
    (multi_dino.py:125-156).  ``forward`` returns ``(codes, aux)``;
    ``forward_logits`` returns the pre-sign logits instead.  Training mode,
    and with it ``frozen_backbone``, waits for the training slice (ROADMAP
    A6)."""

    def __init__(self, backbone: str = "dinov2_vits14", fusion_config: dict | None = None,
                 nbits: int = 64, use_bn: bool = True, num_bands: int = 4,
                 vit_kwargs: dict | None = None):
        super().__init__()
        dim = VIT_DIMS[backbone]
        self.backbone = BandedViT(backbone, num_bands, vit_kwargs)
        self.head = get_fusion_head(fusion_config or {"output_dim": dim}, dim, num_bands)
        self.hash_head = HashHead(self.head.embed_dim, nbits, use_bn)

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.backbone.reset_parameters(generator)
        self.head.reset_parameters(generator)
        self.hash_head.reset_parameters(generator)

    def forward_logits(self, x):
        if self.training:
            raise NotImplementedError("MultiDinoHashing trains with the training slice "
                                      "(ROADMAP A6); call .eval() to serve")
        fused, aux = self.head(self.backbone(x))
        return self.hash_head(fused), aux

    def forward(self, x):
        logits, aux = self.forward_logits(x)
        return binarize(logits, train=False), aux
