"""Deep-hashing losses (port of ``irw_tpu/losses/hashing.py:24-60``,
``HashLoss``; the other hashing losses wait for ROADMAP A11)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from irw_tpu_torch.losses.base import LossBase, LossContext, LossKind


class HashLoss(LossBase):
    """GSPH/CSQ-style proxy hashing loss: tanh → L2-normalise →
    cosine-to-proxies × scale → BCE with the multi-label targets, + L1
    quantization penalty.  The proxies are a parameter (C, D), xavier-uniform
    at init, optimised by the loss optimizer."""

    kind = LossKind.EMBEDDINGS

    def __init__(self, num_classes: int = 20, embedding_size: int = 64,
                 quant_weight: float = 0.1, scale: float = 15.0, **kw):
        super().__init__()
        self.num_classes = num_classes
        self.embedding_size = embedding_size
        self.quant_weight = quant_weight
        self.scale = scale
        self.proxies = nn.Parameter(torch.empty(num_classes, embedding_size))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        nn.init.xavier_uniform_(self.proxies, generator=generator)

    def forward(self, ctx: LossContext, state: dict | None = None):
        emb = torch.tanh(ctx.embeddings)
        norm_emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)
        prox = self.proxies
        prox = prox / torch.clamp(torch.linalg.vector_norm(prox, dim=1, keepdim=True), min=1e-12)
        logits = (norm_emb @ prox.T) * self.scale
        labels = ctx.labels
        if labels.dim() == 1:
            labels = F.one_hot(labels.long(), self.num_classes).to(logits.dtype)
        bce = torch.mean(torch.clamp(logits, min=0) - logits * labels
                         + torch.log1p(torch.exp(-torch.abs(logits))))
        quant = torch.mean(torch.abs(torch.abs(emb) - 1.0))
        return bce + self.quant_weight * quant, state
