"""Wavelet-CNN family: ResNet branches over externally supplied subbands
(port of ``irw_tpu/models/wresnet.py:33-82, 150-205``).

- ``BandedResNet``: one ResNet per band, (B, S, H, W, C) → (B, S, D).  The
  JAX package vmaps one ResNet over the band axis with per-band parameters;
  here the S ResNets run one after another (batching them is ROADMAP B6).
- ``WCNN``: per-band classifier logits in training with ``ce``, else the
  per-band L2-normalised features, concatenated and L2-normalised again
  (wresnet.py:405-445); ``WCNN_ALL`` is the same module over 7 bands.
- ``WCNNAttention``: a CBAM/ECA subband gate fuses the bands; eval returns
  the L2-normalised fused embedding, training with ``ce`` the per-band
  logits and the fused logits (wresnet.py:485-546).

Every forward takes ``(x, rngs=None)`` as the train step calls a model (no
module here draws a mask) and returns ``(out, aux)`` with ``aux["ortho_loss"] = 0`` (and
``aux["gate"]``, (B, S), for ``WCNNAttention``).  The JAX modules' options
that no config sets (``frozen_bn``, the gates' reduction ratio, pool types
and ECA width) are the JAX defaults here.  The branches use the 7×7
stride-2 stem with max-pool; the 1×1 stem belongs to ``WaveResNet``, which
waits for ROADMAP A10b.  f32 throughout: the JAX factory's ``with_autocast``
reaches only ``vit_kwargs``, which these modules do not take.
"""

from __future__ import annotations

import torch
from torch import nn

from irw_tpu_torch.models.attention_blocks import SUBBAND_GATES
from irw_tpu_torch.models.layers import Linear, l2_normalize
from irw_tpu_torch.models.resnet import ResNet

_BRANCHES = {"resnet18": ((2, 2, 2, 2), "basic"), "resnet50": ((3, 4, 6, 3), "bottleneck")}


class BandedResNet(nn.Module):
    """S independent ResNets, one per band: (B, S, H, W, C) → (B, S, D)."""

    def __init__(self, num_bands: int = 4, stage_sizes=(3, 4, 6, 3), block: str = "bottleneck"):
        super().__init__()
        self.branches = nn.ModuleList(ResNet(stage_sizes, block) for _ in range(num_bands))
        self.out_dim = self.branches[0].out_dim

    def reset_parameters(self, generator=None):
        for branch in self.branches:
            branch.reset_parameters(generator)

    def forward(self, x):
        if x.shape[1] != len(self.branches):
            raise ValueError(f"BandedResNet holds {len(self.branches)} branches, "
                             f"got {x.shape[1]} bands")
        return torch.stack([branch(x[:, s]) for s, branch in enumerate(self.branches)], dim=1)


def _branches(backbone: str, num_bands: int) -> BandedResNet:
    """``_wcnn_branch_feats``: resnet18 branches, or resnet50 for any other name."""
    return BandedResNet(num_bands, *_BRANCHES.get(backbone, _BRANCHES["resnet50"]))


def _zero_aux(x) -> dict:
    return {"ortho_loss": torch.zeros((), dtype=torch.float32, device=x.device)}


class WCNN(nn.Module):
    """Branches over (B, S, H, W, C) subbands; per-band classifiers (one
    Dense shared by the bands, zero-initialised) when ``ce``."""

    def __init__(self, num_classes: int = 100, backbone: str = "resnet50", ce: bool = True,
                 num_bands: int = 4):
        super().__init__()
        self.backbone = _branches(backbone, num_bands)
        self.ce = ce
        self.branch_classifier = Linear(self.backbone.out_dim, num_classes) if ce else None

    def reset_parameters(self, generator=None):
        self.backbone.reset_parameters(generator)
        if self.branch_classifier is not None:
            nn.init.zeros_(self.branch_classifier.weight)
            nn.init.zeros_(self.branch_classifier.bias)

    def forward(self, x, rngs: dict | None = None):
        feats = self.backbone(x)
        aux = _zero_aux(x)
        if self.training and self.ce:
            logits = self.branch_classifier(feats)
            return [logits[:, i] for i in range(logits.shape[1])], aux
        emb = l2_normalize(feats, dim=-1).reshape(feats.shape[0], -1)
        return l2_normalize(emb), aux


def WCNN_ALL(**kw) -> WCNN:
    """The 7-branch two-level variant (wresnet.py:447-483): ``WCNN`` over
    the 7-band ``CustomTransform`` stack."""
    kw.setdefault("num_bands", 7)
    return WCNN(**kw)


class WCNNAttention(nn.Module):
    """Branches → subband gate (``attention``: cbam, eca or channel) → the
    L2-normalised fused embedding; in training with ``ce``, [per-band
    logits..., fused logits] (both classifiers zero-initialised)."""

    def __init__(self, num_classes: int = 100, attention: str = "cbam", ce: bool = False,
                 backbone: str = "resnet50", num_bands: int = 4):
        super().__init__()
        self.backbone = _branches(backbone, num_bands)
        self.gate = SUBBAND_GATES[attention](num_subbands=num_bands)
        self.ce = ce
        dim = self.backbone.out_dim
        self.branch_classifier = Linear(dim, num_classes) if ce else None
        self.classifier = Linear(dim, num_classes) if ce else None

    def reset_parameters(self, generator=None):
        self.backbone.reset_parameters(generator)
        self.gate.reset_parameters(generator)
        for lin in (self.branch_classifier, self.classifier):
            if lin is not None:
                nn.init.zeros_(lin.weight)
                nn.init.zeros_(lin.bias)

    def forward(self, x, rngs: dict | None = None):
        feats = self.backbone(x)
        fused, alphas = self.gate(feats)
        aux = dict(_zero_aux(x), gate=alphas)
        if self.training and self.ce:
            logits = self.branch_classifier(feats)
            return [logits[:, i] for i in range(logits.shape[1])] + [self.classifier(fused)], aux
        return l2_normalize(fused), aux
