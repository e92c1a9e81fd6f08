"""Single-backbone baselines and probes (port of
``irw_tpu/models/baselines.py``).

Each ``forward(x, rngs) -> (output, {"ortho_loss": 0})``:

- ``DINOHashBaseline``: one ViT over plain images (B, H, W, C) → HashHead
  (Linear without bias + BatchNorm); logits in training, ±1 codes in eval
  (baselines.py:21-54).  ``head_out`` is the head and binarisation alone,
  on precomputed CLS tokens;
- ``SingleBandNet`` (= ``DetailTesterNet``): one band ``x[:, band]`` of the
  (B, S, H, W, C) stack through one ViT; ``mode="hashing"`` gives tanh of
  the HashHead's logits in training and ±1 codes in eval, ``"metric"`` the
  L2-normalised CLS (baselines.py:57-83);
- ``DinoModelCE``: the CLS through a zero-initialised Linear classifier in
  training, the L2-normalised CLS in eval (baselines.py:86-105);
- ``MultiDinoModel``: the bands ``branches`` through per-band ViTs
  (``BandedViT``); a list of per-band CLS tokens in training, the
  L2-normalised concatenation in eval (baselines.py:108-128).

A frozen backbone (the default) runs in eval mode under ``no_grad`` (the
JAX ``stop_gradient``) and is named in ``frozen_param_collections``, which
the optimizers leave out and whose gradients the train step drops.
"""

from __future__ import annotations

import torch
from torch import nn

from irw_tpu_torch.models.layers import HashHead, Linear, binarize, l2_normalize, zero_aux
from irw_tpu_torch.models.multi_dino import BandedViT, _FrozenTower
from irw_tpu_torch.models.vit import VIT_DIMS, make_vit


class DINOHashBaseline(_FrozenTower):
    """One ViT → HashHead; logits in training, ±1 codes in eval."""

    def __init__(self, backbone: str = "dinov2_vits14", nbits: int = 64,
                 frozen_backbone: bool = True, vit_kwargs: dict | None = None):
        super().__init__()
        self.frozen_backbone = frozen_backbone
        self.backbone = make_vit(backbone, **(vit_kwargs or {}))
        self.hash_head = HashHead(VIT_DIMS[backbone], nbits, use_bn=True)

    def forward(self, x, rngs: dict | None = None):
        return self.head_out(self._bands(x, rngs or {}))

    def head_out(self, cls):
        """The hash head and binarisation on CLS tokens (B, D)."""
        logits = self.hash_head(cls)
        return binarize(logits, self.training), zero_aux(logits)


class SingleBandNet(_FrozenTower):
    """One band of the stack → one ViT → hashing or metric output."""

    def __init__(self, backbone: str = "dinov2_vits14", band: int = 0, mode: str = "hashing",
                 nbits: int = 64, frozen_backbone: bool = True, vit_kwargs: dict | None = None):
        super().__init__()
        self.frozen_backbone = frozen_backbone
        self.band = band
        self.mode = mode
        self.backbone = make_vit(backbone, **(vit_kwargs or {}))
        self.hash_head = (HashHead(VIT_DIMS[backbone], nbits, use_bn=True)
                          if mode == "hashing" else None)

    def forward(self, x, rngs: dict | None = None):
        cls = self._bands(x[:, self.band], rngs or {})
        if self.hash_head is not None:
            logits = self.hash_head(cls)
            return binarize(logits, self.training, "tanh"), zero_aux(logits)
        return l2_normalize(cls), zero_aux(cls)


DetailTesterNet = SingleBandNet


class DinoModelCE(_FrozenTower):
    """CLS → classifier logits in training, the normalised CLS in eval.  The
    classifier's weight and bias start at zero."""

    def __init__(self, backbone: str = "dinov2_vits14", num_classes: int = 100,
                 frozen_backbone: bool = True, vit_kwargs: dict | None = None):
        super().__init__()
        self.frozen_backbone = frozen_backbone
        self.backbone = make_vit(backbone, **(vit_kwargs or {}))
        self.classifier = Linear(VIT_DIMS[backbone], num_classes)

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.backbone.reset_parameters(generator)
        nn.init.zeros_(self.classifier.weight)
        nn.init.zeros_(self.classifier.bias)

    def forward(self, x, rngs: dict | None = None):
        cls = self._bands(x, rngs or {})
        if self.training:
            logits = self.classifier(cls)
            return logits, zero_aux(logits)
        return l2_normalize(cls), zero_aux(cls)


class MultiDinoModel(_FrozenTower):
    """The bands ``branches`` → per-band ViTs; per-band CLS tokens in
    training, their normalised concatenation in eval."""

    def __init__(self, backbone: str = "dinov2_vits14", branches: tuple = (0, 1, 2, 3),
                 frozen_backbone: bool = True, vit_kwargs: dict | None = None):
        super().__init__()
        self.frozen_backbone = frozen_backbone
        self.branches = tuple(branches)
        self.backbone = BandedViT(backbone, len(self.branches), vit_kwargs)

    def forward(self, x, rngs: dict | None = None):
        cls = self._bands(x[:, list(self.branches)], rngs or {})     # (B, S, D)
        if self.training:
            return [cls[:, i] for i in range(cls.shape[1])], zero_aux(cls)
        return l2_normalize(cls.reshape(cls.shape[0], -1)), zero_aux(cls)
