"""The training state (port of ``irw_tpu/engine/train_state.py:20-32`` and
``irw_tpu/getter.py:149-202``, ``init_train_state``).

PyTorch keeps parameters, BatchNorm statistics and optimizer moments inside
the modules and optimizers, so the state holds those objects rather than
their arrays: the model, the network's optimizer entries, the losses with
their own optimizers and schedule states, the XBM memory and its buffers,
the step and epoch counters, the continuation α, and one
``torch.Generator`` per rng stream (``dropout``, ``band_drop``) in place of
the JAX PRNG key.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from irw_tpu_torch.engine.optimizers import build_loss_optimizers, build_optimizers
from irw_tpu_torch.engine.xbm import XBM, XBMState


@dataclass
class TrainState:
    model: nn.Module
    optimizer_entries: list  # [OptimizerEntry]
    losses: list  # [(LossBase, weight)]
    loss_optimizers: dict  # loss idx → torch optimizer over that loss's parameters
    loss_states: dict  # loss idx → schedule state
    generators: dict  # rng stream → torch.Generator on the model's device
    xbm: XBM | None = None
    xbm_state: XBMState | None = None  # the memory's buffers on the model's device
    step: int = 0  # global batch counter
    epoch: int = 0
    # continuation α for tanh(α·x) models (HashNet/DSCH); no ported model takes it
    model_alpha: float = 1.0


def init_train_state(model: nn.Module, losses, optimizer_config, loss_config=(),
                     seed: int = 0, xbm=None) -> TrainState:
    """Set up training for ``model`` (built on its device, e.g. by
    ``get_model``): the losses' parameters drawn from ``seed`` and moved to
    the model's device, the network's optimizers from ``optimizer_config``
    (``configs/optimizer/*.yaml``), the losses' own optimizers from
    ``loss_config`` (``configs/loss/*.yaml``), the ``xbm`` memory's empty
    buffers on the model's device, and the rng streams seeded from
    ``seed``.  Returns the model in training mode."""
    device = next(model.parameters()).device
    gen = torch.Generator().manual_seed(seed)
    for loss, _ in losses:
        loss.reset_parameters(gen)
        loss.to(device)
    generators = {name: torch.Generator(device=device).manual_seed(seed + 1 + i)
                  for i, name in enumerate(("dropout", "band_drop"))}
    return TrainState(
        model=model.train(),
        optimizer_entries=build_optimizers(list(optimizer_config), model),
        losses=list(losses),
        loss_optimizers=build_loss_optimizers(loss_config, losses),
        loss_states={str(i): loss.init_state() for i, (loss, _) in enumerate(losses)},
        generators=generators,
        xbm=xbm,
        xbm_state=None if xbm is None else xbm.init(device),
    )
