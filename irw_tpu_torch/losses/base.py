"""Loss protocol (port of ``irw_tpu/losses/base.py:12-60``).

A loss is an ``nn.Module``: its trainable leaves (proxies, classifier
weights) are its parameters, optimised by the loss's own optimizer
(``engine.optimizers.build_loss_optimizers``); its non-trainable schedule
state is a dict threaded through ``forward`` and the ``*_update`` hooks.
``forward(ctx, state) -> (loss, new_state)``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn


class LossKind(enum.Enum):
    SCORES = "scores"  # f(similarity matrix, label matrix)
    EMBEDDINGS = "embeddings"  # f(embeddings, labels [, ref_embeddings, ref_labels])
    LOGITS = "logits"  # f(classifier logits, int labels)
    BRANCHES = "branches"  # f(list of per-branch outputs, labels)


@dataclass
class LossContext:
    """Everything a loss might consume, prepared once per step by the engine."""

    embeddings: Any = None  # (B, D) or list for BRANCHES
    labels: Any = None  # (B,) int or (B, C) multi-label
    scores: Any = None  # (B, B') similarity matrix
    label_matrix: Any = None  # (B, B') relevance 0/1
    ref_embeddings: Any = None  # XBM memory embeddings
    ref_labels: Any = None
    branches: Any = None  # list of per-branch outputs (BRANCHES losses)
    train: bool = True


def one_hot(labels, num: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a label outside [0, num) gives a zero row (where
    ``F.one_hot`` raises)."""
    return (labels.long()[..., None] == torch.arange(num, device=labels.device)).to(dtype)


def maximum(x, bound: float) -> torch.Tensor:
    """``jnp.maximum(x, bound)``: where x equals the bound the gradient is
    split between the two sides (1/2), as ``torch.maximum`` does and
    ``clamp`` does not."""
    return torch.maximum(x, x.new_full((), bound))


def clip(x, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: 1/2 of the gradient at either bound."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def absolute(x) -> torch.Tensor:
    """``jnp.abs``: gradient 1 at 0, where ``torch.abs`` gives 0."""
    return torch.where(x >= 0, x, -x)


def l2n(x, dim: int = 1) -> torch.Tensor:
    """x / max(‖x‖, 1e-12) along ``dim``."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=1e-12)


class LossBase(nn.Module):
    kind: LossKind = LossKind.EMBEDDINGS
    # XBM-aware: the loss reads ctx.ref_embeddings / ref_labels
    accepts_refs: bool = False

    def reset_parameters(self, generator=None) -> None:
        """Draw the trainable leaves anew (``init_params``)."""

    def init_state(self) -> dict:
        """Non-trainable schedule state."""
        return {}

    def forward(self, ctx: LossContext, state: dict | None = None):
        raise NotImplementedError

    def epoch_update(self, state: dict) -> dict:
        """Per-epoch schedule hook (reference ``epoch_step()``)."""
        return state

    def step_update(self, state: dict) -> dict:
        """Per-batch schedule hook (reference ``HashNetAdapter.step()``)."""
        return state
