"""Multi-branch loss wrappers and distillation (port of
``irw_tpu/losses/multi.py``).

A wrapper's inner losses are its submodules, named as the JAX package keys
their parameters (``inner``; ``b<branch>_l<loss>``), so a JAX
``loss_params`` tree flattened with dots is the wrapper's state dict.
"""

from __future__ import annotations

import dataclasses

import torch

from irw_tpu_torch.losses.base import LossBase, LossContext, LossKind, l2n
from irw_tpu_torch.utils.label_matrix import create_label_matrix


def _branch_ctx(ctx: LossContext, branch):
    """A branch's context: its output as the embeddings, and for score
    losses the cosine similarities of its normalised output with the
    batch's label matrix."""
    norm = l2n(branch)
    return dataclasses.replace(ctx, embeddings=branch, scores=norm @ norm.T,
                               label_matrix=create_label_matrix(ctx.labels), branches=None)


def _zero(ctx: LossContext):
    return torch.zeros((), dtype=torch.float32, device=ctx.branches[0].device)


class MultiEmbeddingLoss(LossBase):
    """One inner loss, given as a {name, kwargs} dict or a loss, over every
    branch, weighted mean by ``branch_weights``.  Other keys fall into
    ``**kw`` as in the JAX package: ``multi_roadmap_loss.yaml``'s
    ``loss_name:`` leaves the inner loss None, so that config fails when
    its state is initialised."""

    kind = LossKind.BRANCHES

    def __init__(self, loss=None, branch_weights=None, **kw):
        super().__init__()
        from irw_tpu_torch.losses import get_loss

        if isinstance(loss, dict):
            loss = get_loss(loss["name"], **(loss.get("kwargs") or {}))
        self.inner = loss
        self.branch_weights = branch_weights

    def reset_parameters(self, generator=None) -> None:
        self.inner.reset_parameters(generator)

    def init_state(self):
        return {"inner": self.inner.init_state()}

    def forward(self, ctx: LossContext, state=None):
        weights = self.branch_weights or [1.0] * len(ctx.branches)
        total = 0.0
        inner_state = (state or {}).get("inner")
        for w, branch in zip(weights, ctx.branches):
            value, inner_state = self.inner(_branch_ctx(ctx, branch), inner_state)
            total = total + w * value
        return total / sum(weights), {"inner": inner_state}

    def epoch_update(self, state):
        return {"inner": self.inner.epoch_update(state["inner"])}

    def step_update(self, state):
        return {"inner": self.inner.step_update(state["inner"])}


class MultiLoss(LossBase):
    """Per-branch loss lists: ``losses`` holds, for each branch, a list of
    {name, weight, kwargs}; their weighted values add up.  The configs key
    their lists ``criterion:`` and ``weights:``, which fall into ``**kw`` as
    in the JAX package, so ``multi_roadmap.yaml`` builds no branch loss and
    adds 0."""

    kind = LossKind.BRANCHES

    def __init__(self, losses=None, **kw):
        super().__init__()
        from irw_tpu_torch.losses import build_losses

        self.branch_losses = [build_losses(entry) for entry in (losses or [])]
        for key, loss, _ in self._entries():
            self.add_module(key, loss)

    def _entries(self):
        return [(f"b{b}_l{i}", loss, weight) for b, entries in enumerate(self.branch_losses)
                for i, (loss, weight) in enumerate(entries)]

    def reset_parameters(self, generator=None) -> None:
        for _, loss, _ in self._entries():
            loss.reset_parameters(generator)

    def init_state(self):
        return {key: loss.init_state() for key, loss, _ in self._entries()}

    def forward(self, ctx: LossContext, state=None):
        total = _zero(ctx)
        new_state = {}
        for b, (branch, entries) in enumerate(zip(ctx.branches, self.branch_losses)):
            bctx = _branch_ctx(ctx, branch)
            for i, (loss, weight) in enumerate(entries):
                key = f"b{b}_l{i}"
                value, new_state[key] = loss(bctx, (state or {}).get(key))
                total = total + weight * value
        return total, new_state

    def epoch_update(self, state):
        return {key: loss.epoch_update(state[key]) for key, loss, _ in self._entries()}


class FeatureDistillationLoss(LossBase):
    """Cosine distillation from the detached teacher branch to the others:
    the mean over students of mean(1 − cos(teacher, student)).  The
    configs' ``teacher_idx`` / ``student_idx`` fall into ``**kw``, as in the
    JAX package."""

    kind = LossKind.BRANCHES

    def __init__(self, teacher_index: int = 0, **kw):
        super().__init__()
        self.teacher_index = teacher_index

    def forward(self, ctx: LossContext, state=None):
        branches = ctx.branches
        t = l2n(branches[self.teacher_index].detach())
        total, count = _zero(ctx), 0
        for i, student in enumerate(branches):
            if i == self.teacher_index:
                continue
            total = total + torch.mean(1.0 - torch.sum(t * l2n(student), dim=1))
            count += 1
        return total / max(count, 1), state
