"""Deep-hashing losses (port of ``irw_tpu/losses/hashing.py``): proxy BCE
(``HashLoss``), HashNet's weighted pairwise likelihood with its tanh
continuation, CSQ's Hadamard hash centers, HHF's hinge to proxies, DSCH's
Hamming-bound hinge and a schedulable quantization penalty.

Schedules (HashNet's scale, the quantization weight) are the loss's state
dict, advanced by ``step_update`` / ``epoch_update``; its numbers are
Python scalars holding the float32 values the JAX package computes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from irw_tpu_torch.losses.base import (LossBase, LossContext, LossKind, absolute, clip, l2n,
                                       maximum, one_hot)
from irw_tpu_torch.utils.label_matrix import create_label_matrix


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
        logits = (l2n(emb) @ l2n(self.proxies).T) * self.scale
        labels = ctx.labels
        if labels.dim() == 1:
            labels = one_hot(labels, self.num_classes, logits.dtype)
        bce = torch.mean(maximum(logits, 0.0) - logits * labels
                         + torch.log1p(torch.exp(-absolute(logits))))
        quant = torch.mean(absolute(absolute(emb) - 1.0))
        return bce + self.quant_weight * quant, state


class HashNetLoss(LossBase):
    """HashNet's class-balanced pairwise likelihood on tanh(scale · u); the
    scale steps up every ``step_continuation`` epochs of
    ``batches_per_epoch`` batches, counted by ``step_update``."""

    kind = LossKind.EMBEDDINGS

    def __init__(self, embedding_size: int = 64, alpha: float = 0.1,
                 step_continuation: int = 20, batches_per_epoch: int = 49, **kw):
        super().__init__()
        self.alpha = alpha
        self.step_continuation = step_continuation
        self.batches_per_epoch = batches_per_epoch

    def init_state(self):
        return {"global_batch_step": 0, "scale": 1.0}

    def step_update(self, state):
        step = state["global_batch_step"] + 1
        epoch = step // self.batches_per_epoch
        return {"global_batch_step": step, "scale": float(epoch // self.step_continuation + 1)}

    def forward(self, ctx: LossContext, state=None):
        u = torch.tanh(state["scale"] * ctx.embeddings)
        s = create_label_matrix(ctx.labels, dtype=u.dtype)
        dot = self.alpha * (u @ u.T)
        # log(1 + exp(dot)) − s·dot, numerically stable
        neg_log = maximum(dot, 0.0) + torch.log1p(torch.exp(-absolute(dot))) - s * dot
        s1 = torch.sum(s)
        s0 = torch.sum(1.0 - s)
        total = s0 + s1
        # positives weigh total/S1, negatives total/S0
        w = torch.where(s > 0, total / torch.clamp(s1, min=1.0), total / torch.clamp(s0, min=1.0))
        return torch.mean(w * neg_log), state


def hadamard_hash_targets(n_class: int, nbits: int, seed: int = 0) -> np.ndarray:
    """Hadamard-matrix hash centers: the rows of [H; −H], then for classes
    past 2·nbits random ±1 rows with balanced bits from ``RandomState(seed)``."""
    h = np.array([[1.0]])
    while h.shape[0] < nbits:
        h = np.block([[h, h], [h, -h]])
    h = h[:nbits, :nbits]
    h2k = np.concatenate([h, -h], axis=0)
    if n_class <= h2k.shape[0]:
        return h2k[:n_class]
    rng = np.random.RandomState(seed)
    extra = []
    for _ in range(n_class - h2k.shape[0]):
        ones = np.ones(nbits)
        ones[rng.choice(nbits, nbits // 2, replace=False)] = -1
        extra.append(ones)
    return np.concatenate([h2k, np.stack(extra)], axis=0)


class CSQLoss(LossBase):
    """Central Similarity Quantization: BCE of (tanh(u) + 1) / 2 against the
    class's hash center, + λ · mean((|tanh(u)| − 1)²).  A multi-label row
    takes the sign of its centers' sum, and the random center
    (``RandomState(seed + 1)``) where that sum is 0."""

    kind = LossKind.EMBEDDINGS

    def __init__(self, embedding_size: int = 64, num_classes: int = 20,
                 lambda_param: float = 1e-4, is_multi_label: bool = True, seed: int = 0, **kw):
        super().__init__()
        self.nbits = embedding_size
        self.num_classes = num_classes
        self.lam = lambda_param
        self.is_multi_label = is_multi_label
        targets = hadamard_hash_targets(num_classes, embedding_size, seed)
        rng = np.random.RandomState(seed + 1)
        center = 2.0 * rng.randint(0, 2, size=embedding_size) - 1.0
        self.register_buffer("hash_targets", torch.tensor(targets, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("random_center", torch.tensor(center, dtype=torch.float32),
                             persistent=False)

    def _label2center(self, y):
        if not self.is_multi_label or y.dim() == 1:
            idx = y if y.dim() == 1 else torch.argmax(y, dim=1)
            n = self.hash_targets.shape[0]
            # a gather in JAX wraps a negative index once and clamps the rest
            idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
            return self.hash_targets[idx.long()]
        center_sum = y.float() @ self.hash_targets
        center_sum = torch.where(center_sum == 0, self.random_center[None, :], center_sum)
        return 2.0 * (center_sum > 0).float() - 1.0

    def forward(self, ctx: LossContext, state=None):
        u = torch.tanh(ctx.embeddings)
        center = self._label2center(ctx.labels)
        p = clip(0.5 * (u + 1.0), 1e-6, 1 - 1e-6)
        t = 0.5 * (center + 1.0)
        bce = -torch.mean(t * torch.log(p) + (1 - t) * torch.log(1 - p))
        q = torch.mean((absolute(u) - 1.0) ** 2)
        return bce + self.lam * q, state


class HHFLoss(LossBase):
    """Hinge on the cosine to (C, D) class proxies (xavier-uniform at init,
    optimised by the loss optimizer): positives above 1 − margin, negatives
    below margin, each side averaged, + an L1 quantization penalty."""

    kind = LossKind.EMBEDDINGS

    def __init__(self, embedding_size: int = 64, num_classes: int = 20,
                 quant_weight: float = 0.1, margin: float = 0.25, **kw):
        super().__init__()
        self.nbits = embedding_size
        self.num_classes = num_classes
        self.quant_weight = quant_weight
        self.margin = margin
        self.proxies = nn.Parameter(torch.empty(num_classes, embedding_size))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        nn.init.xavier_uniform_(self.proxies, generator=generator)

    def forward(self, ctx: LossContext, state=None):
        emb = torch.tanh(ctx.embeddings)
        cos = l2n(emb) @ l2n(self.proxies).T
        labels = ctx.labels
        if labels.dim() == 1:
            pos = one_hot(labels, self.num_classes, cos.dtype)
        else:
            pos = (labels > 0).to(cos.dtype)
        pos_loss = maximum((1.0 - self.margin) - cos, 0.0) * pos
        neg_loss = maximum(cos - self.margin, 0.0) * (1.0 - pos)
        hinge = (pos_loss.sum() / torch.clamp(pos.sum(), min=1.0)
                 + neg_loss.sum() / torch.clamp((1.0 - pos).sum(), min=1.0))
        quant = torch.mean(absolute(absolute(emb) - 1.0))
        return hinge + self.quant_weight * quant, state


class SCHLoss(LossBase):
    """DSCH's pairwise Hamming-bound hinge on relaxed ±1 codes: similar
    pairs pulled to distance 0, dissimilar ones pushed past nbits / gamma,
    averaged over the off-diagonal pairs.  ``dsch.yaml``'s ``n_bits``,
    ``alpha`` and ``beta`` fall into ``**kw``, as in the JAX package."""

    kind = LossKind.EMBEDDINGS

    def __init__(self, nbits: int = 64, gamma: float = 2.0, **kw):
        super().__init__()
        self.nbits = nbits
        self.gamma = gamma

    def forward(self, ctx: LossContext, state=None):
        u = ctx.embeddings
        s = create_label_matrix(ctx.labels, dtype=u.dtype)
        dist = 0.5 * (self.nbits - u @ u.T)
        bound = self.nbits / self.gamma
        pos_loss = s * maximum(dist - 0.0, 0.0)
        neg_loss = (1.0 - s) * maximum(bound - dist, 0.0)
        off_diag = 1.0 - torch.eye(u.shape[0], dtype=u.dtype, device=u.device)
        return (torch.sum((pos_loss + neg_loss) * off_diag)
                / torch.clamp(off_diag.sum(), min=1.0)), state


class QuantizationLoss(LossBase):
    """weight · mean((|x| − target)²), the weight a linear ramp over
    ``steps`` epochs or multiplied by ``alpha`` at each epoch of ``steps``
    (the first activation sets ``starting_weight``), advanced by
    ``epoch_update``."""

    kind = LossKind.EMBEDDINGS

    def __init__(self, target_value: float = 1.0, step_type: str = "linear",
                 steps=None, alpha: float = 1.0, starting_weight: float = 1e-4,
                 warmup_step=False, **kw):
        super().__init__()
        self.target_value = target_value
        self.step_type = step_type
        self.steps = steps
        self.alpha = alpha
        self.starting_weight = starting_weight
        self.warmup_step = warmup_step

    def init_state(self):
        if self.step_type == "linear":
            weight = 0.0
        else:
            weight = 0.0 if self.warmup_step else self.starting_weight
        return {"epoch": 0, "weight": float(np.float32(weight))}

    def epoch_update(self, state):
        epoch = state["epoch"] + 1
        if self.step_type == "linear":
            warm = int(self.warmup_step) if not isinstance(self.warmup_step, bool) else 0
            ramp = np.float32(epoch - warm) / np.float32(float(self.steps))
            return {"epoch": epoch, "weight": float(np.clip(ramp, 0.0, 1.0))}
        weight = np.float32(state["weight"])
        for milestone in list(self.steps or []):
            if epoch == milestone:
                weight = (np.float32(self.starting_weight) if weight == 0.0
                          else weight * np.float32(self.alpha))
        return {"epoch": epoch, "weight": float(weight)}

    def forward(self, ctx: LossContext, state=None):
        q = torch.mean((absolute(ctx.embeddings) - self.target_value) ** 2)
        return state["weight"] * q, state
