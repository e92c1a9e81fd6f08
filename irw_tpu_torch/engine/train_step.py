"""The optimization step (port of ``irw_tpu/engine/train_step.py:47-116,
209-495``).

One ``step(state, batch, hyper)`` call:

- the device transform (Haar SWT: kernel K1);
- the training-mode forward, dropout and band-drop masks from the state's
  generators (attention: kernels K2 forward, and K3 in the backward; with
  block remat each block's forward runs again in the backward, so K2 runs
  twice per block);
- the weighted loss sum plus the fusion head's ortho term, scaled by the
  runtime ``hyper["ortho_scale"]``;
- one backward;
- the global gradient norm over the network's parameters and global-norm
  clipping, min(1, clip / (norm + 1e-6));
- per-entry optimizer steps at the host-computed group learning rates
  (``hyper["lrs"]``); an entry whose ``hyper["active"]`` flag is off (warm-up
  gating) does not step, so its moments stay untouched;
- the losses' own optimizer steps (the reference's ``crit.step()``) on the
  unclipped loss gradients, and the per-batch ``step_update`` schedules;
- the batch proxy mAP.

With an XBM memory, every step inserts the detached embeddings, the labels
and ``batch["index"]`` into ``state.xbm_state`` before the losses
(``irw_tpu/engine/train_step.py:338-347``).  Only score-based or ref-aware
losses (``accepts_refs``) read the memory (:270-278); the port has neither
yet, so with the memory on (``xbm_active``) such a loss raises naming
ROADMAP A11b, and for the rest the memory term is inert, as the JAX step
warns once.

It returns the metrics as 0-dim tensors on the device, under the JAX step's
names (``total_loss``, ``grad_norm``, ``batch_map``, ``loss_<i>_<Loss>``,
``ortho_raw``, ``ortho_loss``).  Micro-batching (``sub_batch`` below the
batch) and adaptive loss weighting (ROADMAP A12), and a pipeline-parallel
``apply_fn`` (A13) raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np
import torch

from irw_tpu_torch.engine.optimizers import set_group_lrs
from irw_tpu_torch.losses.base import LossContext, LossKind
from irw_tpu_torch.utils.label_matrix import create_label_matrix

LOGGER = logging.getLogger(__name__)


def batch_proxy_map(embeddings, labels, metric: str = "cosine"):
    """Training-time self-retrieval mAP over the batch (batch_map.py:9-36):
    rank the batch against itself (self dropped, ties in index order, as
    ``jnp.argsort``), exact AP."""
    if metric == "hamming":
        codes = torch.sign(embeddings)
        sims = codes @ codes.T
    else:
        e = embeddings / torch.clamp(torch.linalg.vector_norm(embeddings, dim=-1, keepdim=True),
                                     min=1e-12)
        sims = e @ e.T
    b = sims.shape[0]
    eye = torch.eye(b, dtype=sims.dtype, device=sims.device)
    sims = sims - 1e9 * eye
    rel = create_label_matrix(labels, dtype=sims.dtype) * (1.0 - eye)
    order = torch.argsort(-sims, dim=1, stable=True)
    ranked_rel = torch.gather(rel, 1, order)
    ranks = torch.arange(1, b + 1, dtype=sims.dtype, device=sims.device)
    cum = torch.cumsum(ranked_rel, dim=1)
    ap = torch.sum((cum / ranks) * ranked_rel, dim=1) / torch.clamp(rel.sum(1), min=1.0)
    valid = rel.sum(1) > 0
    return torch.where(valid, ap, 0.0).sum() / torch.clamp(valid.sum(), min=1)


def _as_device(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def build_train_step(device_transform: Callable | None = None, clip_grad: float | None = None,
                     proxy_map_metric: str = "cosine", xbm=None, sub_batch: int | None = None,
                     adaptive_weights: bool = False, apply_fn: Callable | None = None,
                     xbm_active: bool = False):
    """Returns ``step(state, batch, hyper) -> metrics``.  ``batch``: ``image``
    (B, H, W, 3) uint8 or float, numpy or tensor, ``label`` and, with a
    unique ``xbm``, ``index``.  ``hyper``: ``lrs`` (entry name → label →
    lr), ``active`` (entry name → bool) and optionally ``ortho_scale`` —
    what ``engine.train._build_hyper`` makes.  ``xbm_active``: the memory
    term is on (the loop turns it on at ``xbm.activate_after``)."""
    if adaptive_weights:
        raise NotImplementedError("adaptive loss weighting waits for ROADMAP A12")
    if apply_fn is not None:
        raise NotImplementedError("a pipeline-parallel apply_fn waits for ROADMAP A13")

    def compute_losses(output, aux, labels, state, ortho_scale):
        total = output.new_zeros((), dtype=torch.float32)
        parts, new_states = {}, {}
        for idx, (loss, weight) in enumerate(state.losses):
            key = str(idx)
            if loss.kind != LossKind.EMBEDDINGS:
                raise NotImplementedError(f"{loss.kind} losses wait for ROADMAP A11")
            value, new_states[key] = loss(LossContext(embeddings=output, labels=labels),
                                          state.loss_states.get(key))
            if value.dim() > 0:
                value = value.mean()
            total = total + weight * value
            parts[f"loss_{idx}_{type(loss).__name__}"] = value.detach()
        ortho = aux.get("ortho_loss", total.new_zeros(()))
        # the constraint violation before ortho_weight and ortho_scale
        parts["ortho_raw"] = aux.get("ortho_raw", ortho).detach()
        if ortho_scale is not None:
            ortho = ortho * ortho_scale
        total = total + ortho
        parts["ortho_loss"] = ortho.detach()
        return total, parts, new_states

    use_xbm = xbm is not None and xbm_active
    warned = False

    def check_memory_consumers(losses):
        """The JAX step's memory-term rule (train_step.py:195-207, 270-278)."""
        nonlocal warned
        readers = [type(loss).__name__ for loss, _ in losses
                   if loss.kind == LossKind.SCORES or getattr(loss, "accepts_refs", False)]
        if readers:
            raise NotImplementedError(f"the XBM memory term of {readers} waits for ROADMAP A11b")
        if not warned:
            warned = True
            LOGGER.warning("XBM memory is configured but no loss consumes it "
                           f"({[type(loss).__name__ for loss, _ in losses]} are neither "
                           "score-based nor ref-aware) — the memory term is inert")

    def step(state, batch: dict, hyper: dict) -> dict:
        model = state.model
        device = next(model.parameters()).device
        if use_xbm:
            check_memory_consumers(state.losses)
        images = batch["image"]
        if device_transform is not None:
            x = device_transform(images)
        else:
            x = _as_device(images, device)
            if x.dtype == torch.uint8:
                x = x.float() / 255.0
        labels = _as_device(batch["label"], device)
        # copied before the forward: a copy from pageable memory waits for the stream
        index = (_as_device(batch["index"], device)
                 if xbm is not None and batch.get("index") is not None else None)
        if sub_batch is not None and sub_batch < x.shape[0]:
            raise NotImplementedError("micro-batching (sub_batch below the batch) waits for "
                                      "ROADMAP A12")

        model.train()
        params = list(model.parameters())
        for p in params + [p for loss, _ in state.losses for p in loss.parameters()]:
            p.grad = None
        output, aux = model(x, state.generators)
        if xbm is not None:  # inserted before the losses read it (train_step.py:338-347)
            state.xbm_state = xbm.update(state.xbm_state, output.detach(), labels, index)
        total, parts, new_loss_states = compute_losses(output, aux, labels, state,
                                                       hyper.get("ortho_scale"))
        total.backward()

        # frozen parameters ran under no_grad and have no gradient: the JAX
        # step's zeroed frozen leaves add nothing to its norm either
        grads = [p.grad for p in params if p.grad is not None]
        # optax.global_norm: sqrt of the summed squares (torch.sum's cascade
        # sum: vector_norm accumulates less exactly on the CPU)
        grad_norm = torch.sqrt(torch.stack([torch.sum(g.float() ** 2) for g in grads]).sum())
        if clip_grad:
            scale = torch.clamp(clip_grad / (grad_norm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(scale)
        for entry in state.optimizer_entries:
            if not hyper["active"][entry.name]:
                continue  # warm-up gating: no update, moments untouched
            set_group_lrs(entry.optimizer, hyper["lrs"][entry.name])
            entry.optimizer.step()
        for opt in state.loss_optimizers.values():
            opt.step()
        state.loss_states = {str(idx): loss.step_update(new_loss_states.get(str(idx)) or {})
                             for idx, (loss, _) in enumerate(state.losses)}
        state.step += 1

        emb = output.detach()
        return {
            "total_loss": total.detach(),
            "grad_norm": grad_norm.detach(),
            "batch_map": batch_proxy_map(emb, labels, proxy_map_metric) if emb.dim() == 2
            else emb.new_zeros(()),
            **parts,
        }

    return step
