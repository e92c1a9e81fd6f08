"""Stage-interleaved multi-branch ResNets with cross-band attention (port of
``irw_tpu/models/mtwavenet.py``).

- ``BandedStagedResNet``: one ResNet per band (7×7 stride-2 stem with
  max-pool, BatchNorm momentum 0.9), driven stage by stage; after every
  stage a ``CrossBandAttention`` gates the S bands' maps over their S·C
  band-major channels; then ``global_pool`` (``avg``, ``max``, ``avg_max``
  or ``none``) per band and an optional LayerNorm over D shared by the bands
  (flax eps 1e-6): (B, S, H, W, C) → (B, S, D) (mtwavenet.py:25-99).  The
  JAX package vmaps the stem and each stage over the bands; here the bands
  run one after another (batching them is ROADMAP B6).
- ``FourBranchResNet`` (``depth`` 18 or 50): in training with classes,
  dropout 0.5 on the (B, S, D) features (the ``dropout`` generator), then
  one zero-initialised classifier shared by the bands → per-band logits;
  otherwise the flat features, L2-normalised (mtwavenet.py:102-134).
  ``FourBranchResNet50`` is a function (``**kw``), as in JAX: depth 50 with
  the LayerNorm (mtwavenet.py:137-143).
- ``FourBranchResNet50Fusion``: ``ChannelGate1D`` sums the gated bands;
  in training [per-band logits of the dropped-out features..., the fused
  features' logits], otherwise the fused features L2-normalised
  (mtwavenet.py:146-177).  Without classes training raises, as the JAX
  init does (``Dense(None)``).
- ``HybridMultiBranch`` (and ``HybridMultiBranchV2``, the same class): a
  ResNet-50 on LL and a DenseNet-121 per detail band; the 2048 + 3·1024
  concat, L2-normalised, or in training with classes ONE logits tensor of a
  zero-initialised classifier (mtwavenet.py:180-214).

``frozen_bn`` pins every trunk BatchNorm to its running statistics in
training.  Forwards take ``(x, rngs=None)`` and return ``(out, aux)`` with
``aux["ortho_loss"] = 0`` (and ``aux["gate"]``, (B, S), for the fusion).

``dtype`` (``resnet.compute_dtype``) is the compute dtype of the trunks and
the ``CrossBandAttention`` blocks, as the JAX modules pass it; the
LayerNorm, ``ChannelGate1D`` and the classifiers take none in JAX, so they
compute in float32 on half-precision features, as jnp promotes them.

With ``pool="none"`` a band's feature is its flattened last-stage map, so
the LayerNorm and the classifiers after the pool are as wide as that map:
the JAX modules size them from the input at init (mtwavenet.py:95-98,
:127), the port from ``fit_image(h, w)`` (a band's size), which
``get_model(..., image_size=(h, w))`` calls and ``run`` passes from its
first batch.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from irw_tpu_torch.models.attention_blocks import ChannelGate1D, CrossBandAttention
from irw_tpu_torch.models.densenet import DenseNet
from irw_tpu_torch.models.layers import (LayerNorm, Linear, apply_dropout, global_pool,
                                         l2_normalize, zero_aux)
from irw_tpu_torch.models.resnet import ResNet

DROPOUT = 0.5   # fixed in the JAX modules (mtwavenet.py:126, :168)
_DEPTHS = {18: ((2, 2, 2, 2), "basic"), 50: ((3, 4, 6, 3), "bottleneck")}


def _unsized(what: str):
    return ValueError(f"pool='none' sizes {what} from a band's flattened map: build the model "
                      "with get_model(..., image_size=(h, w)) or call fit_image(h, w) first")


def _zero_(lin: Linear) -> None:
    nn.init.zeros_(lin.weight)
    nn.init.zeros_(lin.bias)


class BandedStagedResNet(nn.Module):
    """Per-band ResNets run stage by stage, a ``CrossBandAttention`` after
    each stage: (B, S, H, W, C) → (B, S, D)."""

    def __init__(self, stage_sizes, block: str, num_bands: int = 4, width: int = 64,
                 layernorm: bool = False, pool: str = "avg", frozen_bn: bool = False,
                 dtype="float32"):
        super().__init__()
        self.branches = nn.ModuleList(ResNet(stage_sizes, block, width, frozen_bn, dtype=dtype)
                                      for _ in range(num_bands))
        self.att_blocks = nn.ModuleList(CrossBandAttention(num_bands * dim, dtype=dtype)
                                        for dim in self.branches[0].stage_dims)
        self.pool = pool
        self.layernorm = layernorm
        self.out_dim = self.branch_ln = None
        if pool != "none":
            self._size(self.branches[0].out_dim)

    def _size(self, dim: int):
        self.out_dim = dim
        self.branch_ln = LayerNorm(dim) if self.layernorm else None

    def fit_image(self, h: int, w: int):
        """With ``pool="none"``: D = C·h'·w' of a band's last-stage map (the
        stem's conv and max-pool and each later stage halve a side, rounding
        up), and the LayerNorm that wide."""
        if self.pool != "none":
            return
        for _ in range(len(self.att_blocks) + 1):
            h, w = math.ceil(h / 2), math.ceil(w / 2)
        self._size(self.branches[0].out_dim * h * w)

    def reset_parameters(self, generator=None):
        for mod in (*self.branches, *self.att_blocks):
            mod.reset_parameters(generator)
        if self.branch_ln is not None:
            nn.init.ones_(self.branch_ln.weight)
            nn.init.zeros_(self.branch_ln.bias)

    def forward(self, x):
        if x.shape[1] != len(self.branches):
            raise ValueError(f"BandedStagedResNet holds {len(self.branches)} branches, "
                             f"got {x.shape[1]} bands")
        if self.layernorm and self.branch_ln is None:
            raise _unsized("the LayerNorm")
        bands = [branch.stem_forward(x[:, s].permute(0, 3, 1, 2))   # NCHW views
                 for s, branch in enumerate(self.branches)]
        for stage, att in enumerate(self.att_blocks):
            bands = [branch.stage_forward(stage, y) for branch, y in zip(self.branches, bands)]
            bands, _ = att(bands)
        emb = torch.stack([global_pool(y.permute(0, 2, 3, 1), self.pool) for y in bands], dim=1)
        if self.branch_ln is not None:
            emb = self.branch_ln(emb)
        return emb


class FourBranchResNet(nn.Module):
    """Staged ResNet-18 (or ResNet-50) branches; per-band logits in training
    with classes, else the L2-normalised flat features."""

    def __init__(self, num_classes: int | None = None, depth: int = 18, layernorm: bool = False,
                 pool: str = "avg", frozen_bn: bool = False, dtype="float32"):
        super().__init__()
        sizes, block = _DEPTHS[18] if depth == 18 else _DEPTHS[50]
        self.backbone = BandedStagedResNet(sizes, block, layernorm=layernorm, pool=pool,
                                           frozen_bn=frozen_bn, dtype=dtype)
        self.num_classes = num_classes
        self._size_heads()

    def _size_heads(self):
        dim = self.backbone.out_dim
        self.branch_classifier = (None if self.num_classes is None or dim is None
                                  else Linear(dim, self.num_classes))

    def fit_image(self, h: int, w: int):
        """``BandedStagedResNet.fit_image``, and the classifier that wide."""
        self.backbone.fit_image(h, w)
        self._size_heads()

    def reset_parameters(self, generator=None):
        self.backbone.reset_parameters(generator)
        if self.branch_classifier is not None:
            _zero_(self.branch_classifier)

    def forward(self, x, rngs: dict | None = None):
        emb = self.backbone(x)
        aux = zero_aux(x)
        if self.training and self.num_classes is not None:
            if self.branch_classifier is None:
                raise _unsized("the classifier")
            emb = apply_dropout(emb, DROPOUT, True, (rngs or {}).get("dropout"))
            logits = self.branch_classifier(emb)
            return [logits[:, i] for i in range(logits.shape[1])], aux
        return l2_normalize(emb.reshape(emb.shape[0], -1)), aux


def FourBranchResNet50(**kw) -> FourBranchResNet:
    """``FourBranchResNet`` at depth 50 with the per-band LayerNorm."""
    kw.setdefault("depth", 50)
    kw.setdefault("layernorm", True)
    return FourBranchResNet(**kw)


class FourBranchResNet50Fusion(nn.Module):
    """Staged ResNet-50 branches with the LayerNorm, ``ChannelGate1D``
    fusion; [per-band logits..., fused logits] in training."""

    def __init__(self, num_classes: int | None = 100, pool: str = "avg", frozen_bn: bool = False,
                 dtype="float32"):
        super().__init__()
        self.backbone = BandedStagedResNet(*_DEPTHS[50], layernorm=True, pool=pool,
                                           frozen_bn=frozen_bn, dtype=dtype)
        self.gate = ChannelGate1D(num_subbands=4)
        self.num_classes = num_classes
        self._size_heads()

    def _size_heads(self):
        dim, n = self.backbone.out_dim, self.num_classes
        sized = n is not None and dim is not None
        self.branch_classifier = Linear(dim, n) if sized else None
        self.classifier = Linear(dim, n) if sized else None

    def fit_image(self, h: int, w: int):
        """``BandedStagedResNet.fit_image``, and the classifiers that wide."""
        self.backbone.fit_image(h, w)
        self._size_heads()

    def reset_parameters(self, generator=None):
        self.backbone.reset_parameters(generator)
        self.gate.reset_parameters(generator)
        for lin in (self.branch_classifier, self.classifier):
            if lin is not None:
                _zero_(lin)

    def forward(self, x, rngs: dict | None = None):
        emb = self.backbone(x)
        fused, alphas = self.gate(emb)
        aux = dict(zero_aux(x), gate=alphas)
        if self.training:
            if self.num_classes is None:
                raise TypeError("FourBranchResNet50Fusion trains only with num_classes: the JAX "
                                "module's classifiers are Dense(None) (mtwavenet.py:168-172), "
                                "which its training init refuses")
            if self.classifier is None:
                raise _unsized("the classifiers")
            dropped = apply_dropout(emb, DROPOUT, True, (rngs or {}).get("dropout"))
            logits = self.branch_classifier(dropped)
            return [logits[:, i] for i in range(logits.shape[1])] + [self.classifier(fused)], aux
        return l2_normalize(fused), aux


class HybridMultiBranch(nn.Module):
    """ResNet-50 on the LL band, a DenseNet-121 per detail band."""

    def __init__(self, num_classes: int | None = None, frozen_bn: bool = False,
                 dtype="float32"):
        super().__init__()
        self.ll_trunk = ResNet((3, 4, 6, 3), "bottleneck", frozen_bn=frozen_bn, dtype=dtype)
        self.detail_trunks = nn.ModuleList(DenseNet(frozen_bn=frozen_bn, dtype=dtype)
                                           for _ in range(3))
        dim = self.ll_trunk.out_dim + sum(t.out_dim for t in self.detail_trunks)
        self.classifier = None if num_classes is None else Linear(dim, num_classes)

    def reset_parameters(self, generator=None):
        self.ll_trunk.reset_parameters(generator)
        for trunk in self.detail_trunks:
            trunk.reset_parameters(generator)
        if self.classifier is not None:
            _zero_(self.classifier)

    def forward(self, x, rngs: dict | None = None):
        if x.shape[1] != 1 + len(self.detail_trunks):
            raise ValueError(f"HybridMultiBranch takes LL and {len(self.detail_trunks)} detail "
                             f"bands, got {x.shape[1]} bands")
        emb = torch.cat([self.ll_trunk(x[:, 0]),
                         *(trunk(x[:, s + 1]) for s, trunk in enumerate(self.detail_trunks))],
                        dim=-1)
        aux = zero_aux(x)
        if self.training and self.classifier is not None:
            return self.classifier(emb), aux
        return l2_normalize(emb), aux


HybridMultiBranchV2 = HybridMultiBranch
