"""Pairwise contrastive losses (port of ``irw_tpu/losses/pairwise.py``).

Both read the XBM memory (``accepts_refs``): given reference embeddings the
pairs run between the batch and the memory, else within the batch with the
diagonal left out.
"""

from __future__ import annotations

import torch

from irw_tpu_torch.losses.base import LossBase, LossContext, LossKind, maximum
from irw_tpu_torch.utils.label_matrix import create_label_matrix


def _pair_setup(ctx: LossContext):
    """(similarities, positive mask, negative mask) between the batch and
    the memory, or the batch itself."""
    emb = ctx.embeddings
    self_pairs = ctx.ref_embeddings is None
    ref, ref_labels = (emb, ctx.labels) if self_pairs else (ctx.ref_embeddings, ctx.ref_labels)
    sims = emb @ ref.T
    rel = create_label_matrix(ctx.labels, ref_labels)
    if self_pairs:
        diag = torch.eye(sims.shape[0], dtype=rel.dtype, device=rel.device)
        rel_pos = rel * (1.0 - diag)
    else:
        rel_pos = rel
        diag = torch.zeros_like(rel)
    neg = (1.0 - rel) * (1.0 - diag)
    return sims, rel_pos, neg


def _avg_nonzero(x):
    """PML's AvgNonZeroReducer: the mean over the entries with a non-zero loss."""
    return torch.sum(x) / torch.clamp(torch.sum((x > 0).to(x.dtype)), min=1.0)


class CalibrationLoss(LossBase):
    """ROADMAP's calibration loss: contrastive on dot-product similarities
    with absolute margins, each side reduced by ``_avg_nonzero``."""

    accepts_refs = True
    kind = LossKind.EMBEDDINGS

    def __init__(self, pos_margin: float = 0.9, neg_margin: float = 0.6, **kw):
        super().__init__()
        self.pos_margin = pos_margin
        self.neg_margin = neg_margin

    def forward(self, ctx: LossContext, state=None):
        sims, pos, neg = _pair_setup(ctx)
        pos_loss = maximum(self.pos_margin - sims, 0.0) * pos
        neg_loss = maximum(sims - self.neg_margin, 0.0) * neg
        return _avg_nonzero(pos_loss) + _avg_nonzero(neg_loss), state


class PairLoss(LossBase):
    """The XBM paper's contrastive loss: per anchor, the sum of 1 − s over
    positives with s < 1 − 1e-5 and of s over negatives with s > margin,
    averaged over anchors."""

    accepts_refs = True
    kind = LossKind.EMBEDDINGS

    def __init__(self, margin: float = 0.5):
        super().__init__()
        self.margin = margin

    def forward(self, ctx: LossContext, state=None):
        sims, pos, neg = _pair_setup(ctx)
        pos_active = pos * (sims < 1.0 - 1e-5)
        neg_active = neg * (sims > self.margin)
        per_anchor = (torch.sum((1.0 - sims) * pos_active, dim=1)
                      + torch.sum(sims * neg_active, dim=1))
        return per_anchor.mean(), state
