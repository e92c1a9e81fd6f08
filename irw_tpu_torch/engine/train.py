"""Host-side pieces of the epoch loop (port of
``irw_tpu/engine/train.py:67-92``): the per-epoch loss schedule hook and
the ``hyper`` dict a train step reads.  The loop itself, checkpoints, the
loader and the runner wait for ROADMAP A8.
"""

from __future__ import annotations


def _apply_loss_epoch_updates(losses, state):
    """Advance every loss's per-epoch schedule in ``state.loss_states``."""
    new_states = dict(state.loss_states)
    for idx, (loss, _) in enumerate(losses):
        key = str(idx)
        if new_states.get(key):
            new_states[key] = loss.epoch_update(new_states[key])
    state.loss_states = new_states
    return state


def _build_hyper(optimizer_entries, epoch, step, warm_up, warm_up_key, ortho_scale=None):
    """Per-entry group learning rates at (epoch, step) and the warm-up gate:
    while ``epoch < warm_up`` only the entry named ``warm_up_key`` steps."""
    lrs, active = {}, {}
    for entry in optimizer_entries:
        lrs[entry.name] = entry.group_lrs(epoch, step)
        active[entry.name] = (epoch >= warm_up) or (warm_up_key is not None
                                                    and entry.name == warm_up_key)
    hyper = {"lrs": lrs, "active": active}
    if ortho_scale is not None:
        hyper["ortho_scale"] = float(ortho_scale)
    return hyper
