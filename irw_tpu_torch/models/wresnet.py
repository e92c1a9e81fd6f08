"""Wavelet-CNN family: ResNet branches over wavelet subbands (port of
``irw_tpu/models/wresnet.py``).

- ``BandedResNet``: one ResNet per band, (B, S, H, W, C) → (B, S, D).  The
  JAX package vmaps one ResNet over the band axis with per-band parameters;
  here the S ResNets run one after another (batching them is ROADMAP B6).
- ``decompose_to_bands``: the in-model DWT, (B, H, W, C) images → the
  coarsest level's (B, 4, h, w, C) [LL, LH, HL, HH] stack of the lifting
  DWT (wresnet.py:65-71); on the card through kernel K4.
- ``WaveResNet``: the in-model DWT → 4 ResNet-50 branches with a 1×1
  stride-1 stem and no max-pool → optionally a subband gate (``attention``:
  cbam, eca or channel; none with ``ll_only``, which keeps the LL band
  alone).  The output is NOT normalised: the gate's fused (B, 2048), else
  the flat (B, S·2048), in both modes (wresnet.py:85-114).  ``feature_size``
  is taken and unused, as in JAX.
- ``WaveResNetCE``: the same trunk; per-band logits of one zero-initialised
  classifier shared by the bands in training, else the per-band
  L2-normalised features, concatenated and L2-normalised again
  (wresnet.py:117-147).
- ``WCNN``: per-band classifier logits in training with ``ce``, else the
  per-band L2-normalised features, concatenated and L2-normalised again
  (wresnet.py:405-445); ``WCNN_ALL`` is the same module over 7 bands.
- ``WCNNAttention``: a CBAM/ECA subband gate fuses the bands; eval returns
  the L2-normalised fused embedding, training with ``ce`` the per-band
  logits and the fused logits (wresnet.py:485-546).

Every forward takes ``(x, rngs=None)`` as the train step calls a model (no
module here draws a mask) and returns ``(out, aux)`` with
``aux["ortho_loss"] = 0`` (and ``aux["gate"]``, (B, S), with a gate).
``frozen_bn`` pins every branch BatchNorm to its running statistics in
training.  The gates' options that no config sets (reduction ratio, pool
types, ECA width) are the JAX defaults.  ``dtype`` (float32, bfloat16 or
float16; ``resnet.compute_dtype``) is the branches' compute dtype, as the
JAX modules hand it to their ResNets; the DWT before them stays in the
images' dtype, and the gates and the zero-initialised classifiers, which
take no dtype in JAX, compute in float32 on the half-precision features,
as jnp promotes them.  An eval embedding without a gate stays in the
branches' dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from irw_tpu_torch.models.attention_blocks import SUBBAND_GATES
from irw_tpu_torch.models.layers import Linear, l2_normalize, zero_aux
from irw_tpu_torch.models.resnet import ResNet
from irw_tpu_torch.ops.wavelets.lifting import lifting_decompose
from irw_tpu_torch.ops.wavelets.lifting_dwt import lifting_multi_level

_BRANCHES = {"resnet18": ((2, 2, 2, 2), "basic"), "resnet50": ((3, 4, 6, 3), "bottleneck")}


class BandedResNet(nn.Module):
    """S independent ResNets, one per band: (B, S, H, W, C) → (B, S, D)."""

    def __init__(self, num_bands: int = 4, stage_sizes=(3, 4, 6, 3), block: str = "bottleneck",
                 stem_kernel: int = 7, stem_stride: int = 2, frozen_bn: bool = False,
                 width: int = 64, dtype="float32"):
        super().__init__()
        self.branches = nn.ModuleList(
            ResNet(stage_sizes, block, width, frozen_bn, stem_kernel, stem_stride, dtype)
            for _ in range(num_bands))
        self.out_dim = self.branches[0].out_dim

    def reset_parameters(self, generator=None):
        for branch in self.branches:
            branch.reset_parameters(generator)

    def forward(self, x):
        if x.shape[1] != len(self.branches):
            raise ValueError(f"BandedResNet holds {len(self.branches)} branches, "
                             f"got {x.shape[1]} bands")
        return torch.stack([branch(x[:, s]) for s, branch in enumerate(self.branches)], dim=1)


def _branches(backbone: str, num_bands: int, frozen_bn: bool, dtype) -> BandedResNet:
    """``_wcnn_branch_feats``: resnet18 branches, or resnet50 for any other name."""
    return BandedResNet(num_bands, *_BRANCHES.get(backbone, _BRANCHES["resnet50"]),
                        frozen_bn=frozen_bn, dtype=dtype)


def decompose_to_bands(x: torch.Tensor, levels: int, basis: str) -> torch.Tensor:
    """(B, H, W, C) images → (B, 4, H/2ˡ, W/2ˡ, C), the coarsest level's
    [LL, LH, HL, HH] of the lifting DWT.  H and W divisible by 2ˡ: one call
    of ``lifting_multi_level`` over the B·C planes (kernel K4 on the card,
    its plain version on the CPU); K4 has no backward, so a CUDA input that
    requires grad raises.  Any other size: the plain ``lifting_decompose``,
    as ``CustomTransform`` dispatches (the JAX module runs that lifting on
    every size)."""
    b, h, w, c = x.shape
    if h % 2 ** levels or w % 2 ** levels:
        approx, details = lifting_decompose(x.movedim(-1, 1), levels=levels, basis=basis)
        return torch.stack([approx[-1], *details[-1]], dim=1).movedim(2, -1)
    if x.device.type == "cuda" and x.requires_grad:
        raise NotImplementedError("decompose_to_bands: kernel K4 has no backward; the images "
                                  "of the in-model DWT must not require grad on the card")
    flat = lifting_multi_level(x.permute(0, 3, 1, 2).reshape(b * c, h, w), levels, basis)
    ho, wo = flat.shape[-2:]
    return flat.reshape(b, c, 4, ho, wo).permute(0, 2, 3, 4, 1)


def _wave_trunk(num_bands: int, frozen_bn: bool, dtype) -> BandedResNet:
    """The ResNet-50 branches of ``WaveResNet``: a 1×1 stride-1 stem, no
    max-pool (wresnet.py:260-261's stem surgery)."""
    return BandedResNet(num_bands, (3, 4, 6, 3), "bottleneck", stem_kernel=1, stem_stride=1,
                        frozen_bn=frozen_bn, dtype=dtype)


class WaveResNet(nn.Module):
    """The in-model DWT → ResNet-50 branches → an optional subband gate."""

    def __init__(self, decom_level: int = 1, wave: str = "haar", feature_size: int = 2048,
                 attention: str | None = None, ll_only: bool = False, frozen_bn: bool = False,
                 dtype="float32"):
        super().__init__()
        self.decom_level, self.wave, self.ll_only = int(decom_level), wave, ll_only
        num_bands = 1 if ll_only else 4
        self.backbone = _wave_trunk(num_bands, frozen_bn, dtype)
        gated = attention in SUBBAND_GATES and not ll_only
        self.gate = SUBBAND_GATES[attention](num_subbands=num_bands) if gated else None

    def reset_parameters(self, generator=None):
        self.backbone.reset_parameters(generator)
        if self.gate is not None:
            self.gate.reset_parameters(generator)

    def forward(self, x, rngs: dict | None = None):
        bands = decompose_to_bands(x, self.decom_level, self.wave)
        if self.ll_only:
            bands = bands[:, :1]
        feats = self.backbone(bands)
        aux = zero_aux(x)
        if self.gate is not None:
            fused, alphas = self.gate(feats)
            return fused, dict(aux, gate=alphas)
        return feats.reshape(feats.shape[0], -1), aux


class WaveResNetCE(nn.Module):
    """The in-model DWT → ResNet-50 branches; per-band logits in training
    (``branch_classifier``, zero-initialised, shared by the bands)."""

    def __init__(self, num_classes: int = 100, decom_level: int = 1, wave: str = "haar",
                 frozen_bn: bool = False, dtype="float32"):
        super().__init__()
        self.decom_level, self.wave = int(decom_level), wave
        self.backbone = _wave_trunk(4, frozen_bn, dtype)
        self.branch_classifier = Linear(self.backbone.out_dim, num_classes)

    def reset_parameters(self, generator=None):
        self.backbone.reset_parameters(generator)
        nn.init.zeros_(self.branch_classifier.weight)
        nn.init.zeros_(self.branch_classifier.bias)

    def forward(self, x, rngs: dict | None = None):
        feats = self.backbone(decompose_to_bands(x, self.decom_level, self.wave))
        aux = zero_aux(x)
        if self.training:
            logits = self.branch_classifier(feats)
            return [logits[:, i] for i in range(logits.shape[1])], aux
        emb = l2_normalize(feats, dim=-1).reshape(feats.shape[0], -1)
        return l2_normalize(emb), aux


class WCNN(nn.Module):
    """Branches over (B, S, H, W, C) subbands; per-band classifiers (one
    Dense shared by the bands, zero-initialised) when ``ce``."""

    def __init__(self, num_classes: int = 100, backbone: str = "resnet50", ce: bool = True,
                 frozen_bn: bool = False, dtype="float32", num_bands: int = 4):
        super().__init__()
        self.backbone = _branches(backbone, num_bands, frozen_bn, dtype)
        self.ce = ce
        self.branch_classifier = Linear(self.backbone.out_dim, num_classes) if ce else None

    def reset_parameters(self, generator=None):
        self.backbone.reset_parameters(generator)
        if self.branch_classifier is not None:
            nn.init.zeros_(self.branch_classifier.weight)
            nn.init.zeros_(self.branch_classifier.bias)

    def forward(self, x, rngs: dict | None = None):
        feats = self.backbone(x)
        aux = zero_aux(x)
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
                 backbone: str = "resnet50", frozen_bn: bool = False, dtype="float32",
                 num_bands: int = 4):
        super().__init__()
        self.backbone = _branches(backbone, num_bands, frozen_bn, dtype)
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
        aux = dict(zero_aux(x), gate=alphas)
        if self.training and self.ce:
            logits = self.branch_classifier(feats)
            return [logits[:, i] for i in range(logits.shape[1])] + [self.classifier(fused)], aux
        return l2_normalize(fused), aux
