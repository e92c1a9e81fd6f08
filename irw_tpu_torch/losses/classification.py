"""Classification-style losses: CE, per-branch CE, ArcFace (port of
``irw_tpu/losses/classification.py``).

ArcFace's class-weight matrix is a parameter of the loss, optimised by the
loss's own optimizer (``engine.optimizers.build_loss_optimizers``, from the
config entry's nested ``optimizer:``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from irw_tpu_torch.losses.base import LossBase, LossContext, LossKind, clip, l2n, one_hot


def _softmax_ce(logits, labels, label_smoothing: float = 0.0):
    """Mean softmax cross-entropy.  Integer labels at or past the class
    count give a zero target row (``jax.nn.one_hot``), so they add nothing
    but the smoothing term; multi-label rows are normalised to sum 1."""
    num = logits.shape[-1]
    if labels.dim() == 1:
        target = one_hot(labels, num, logits.dtype)
    else:
        labels = labels.to(logits.dtype)
        target = labels / torch.clamp(labels.sum(-1, keepdim=True), min=1e-12)
    if label_smoothing:
        target = target * (1 - label_smoothing) + label_smoothing / num
    return -(target * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


class CrossEntropy(LossBase):
    kind = LossKind.LOGITS

    def __init__(self, label_smoothing: float = 0.0, **kw):
        super().__init__()
        self.label_smoothing = label_smoothing

    def forward(self, ctx: LossContext, state=None):
        return _softmax_ce(ctx.embeddings, ctx.labels, self.label_smoothing), state


class MultiCrossEntropyLoss(LossBase):
    """Per-branch CE, weighted mean.  The weights are ``branch_weights``;
    the configs' ``weights:`` key falls into ``**kw``, as in the JAX
    package, so there every branch weighs 1."""

    kind = LossKind.BRANCHES

    def __init__(self, branch_weights=None, label_smoothing: float = 0.0, **kw):
        super().__init__()
        self.branch_weights = branch_weights
        self.label_smoothing = label_smoothing

    def forward(self, ctx: LossContext, state=None):
        branches = ctx.branches
        weights = self.branch_weights or [1.0] * len(branches)
        total = sum(w * _softmax_ce(b, ctx.labels, self.label_smoothing)
                    for w, b in zip(weights, branches))
        return total / sum(weights), state


class ArcFaceLoss(LossBase):
    """Additive-angular-margin softmax over a (C, D) class-weight parameter,
    drawn as normal × 0.01.  A margin above 1 is in degrees and is converted
    in float32, as ``jnp.deg2rad`` does."""

    kind = LossKind.EMBEDDINGS

    def __init__(self, num_classes: int, embedding_size: int, margin: float = 28.6,
                 scale: float = 64.0, **kw):
        super().__init__()
        self.num_classes = num_classes
        self.embedding_size = embedding_size
        self.margin = (float(np.float32(margin) * np.float32(np.pi / 180)) if margin > 1.0
                       else margin)
        self.scale = scale
        self.weights = nn.Parameter(torch.empty(num_classes, embedding_size))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weights.copy_(torch.randn(self.weights.shape, generator=generator) * 0.01)

    def forward(self, ctx: LossContext, state=None):
        emb = l2n(ctx.embeddings)
        w = l2n(self.weights)
        cos = clip(emb @ w.T, -1 + 1e-7, 1 - 1e-7)
        theta = torch.arccos(cos)
        target = one_hot(ctx.labels, self.num_classes, cos.dtype)
        logits = self.scale * torch.cos(theta + self.margin * target)
        return _softmax_ce(logits, ctx.labels), state
