"""``RetrievalNet``: a feature trunk wrapped into an L2-normalised embedder
(port of ``irw_tpu/models/retrieval_net.py``).

``forward(x, rngs) -> (embedding, {})``: the trunk on plain images
(B, H, W, C); a 4-D output (B, h, w, C) is pooled (``pooling``); then
optionally a LayerNorm (``standardize``), the ``ProjectionHead`` ``fc`` of
one Linear to ``embed_dim`` unless ``without_fc``, and L2 normalisation.
The port's trunks (``ResNet``, ``VisionTransformer``, ``ConvNeXt``,
``DenseNet``, ``HuggingFaceVisionWrapper``) return pooled (B, C) features,
so ``pooling`` does nothing for them, as in JAX (retrieval_net.py:41).  A
frozen trunk (``frozen_backbone``) runs in eval mode under ``no_grad`` and
is named in ``frozen_param_collections``.  The aux is the trunk's, as the
JAX module's: ``{}`` for a trunk that returns features alone, the HF
wrapper's ``{"ortho_loss": 0}`` (it returns (features, aux)).
"""

from __future__ import annotations

import torch
from torch import nn

from irw_tpu_torch.models.layers import LayerNorm, ProjectionHead, global_pool, l2_normalize


class RetrievalNet(nn.Module):
    def __init__(self, backbone: nn.Module, embed_dim: int = 512, pooling: str = "default",
                 standardize: bool = False, projection_norm: str | None = None,
                 without_fc: bool = False, frozen_backbone: bool = False):
        super().__init__()
        # a ViT's width is its embed_dim; the CNN trunks' their out_dim
        dim = getattr(backbone, "out_dim", None) or backbone.embed_dim
        self.backbone = backbone
        self.pooling = pooling
        self.frozen_backbone = frozen_backbone
        self.norm = LayerNorm(dim) if standardize else None
        self.fc = None if without_fc else ProjectionHead(dim, (embed_dim,), projection_norm)

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
        if self.norm is not None:
            nn.init.ones_(self.norm.weight)
            nn.init.zeros_(self.norm.bias)
        if self.fc is not None:
            self.fc.reset_parameters(generator)

    def forward(self, x, rngs: dict | None = None):
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.frozen_backbone):
            out = self.backbone(x)
        feats, aux = out if isinstance(out, tuple) else (out, {})
        if feats.dim() == 4:
            feats = global_pool(feats, self.pooling)
        if self.norm is not None:
            feats = self.norm(feats)
        if self.fc is not None:
            feats = self.fc(feats)
        return l2_normalize(feats), aux
