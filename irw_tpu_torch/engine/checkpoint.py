"""Checkpoint and resume (port of ``irw_tpu/engine/checkpoint.py:22-169``,
with ``torch.save``/``torch.load``, and the restore half of
``run.py:147-166``).

Layout under ``log_dir/weights/``, as the JAX package's: ``rolling`` every
save, ``epoch_N`` at the ``save_model_every`` cadence.  Each is one file
holding ``{"state": ..., "meta": {config, epoch, score, best_score}}``;
``state`` holds what the JAX ``TrainState`` holds: the model's
``state_dict`` (parameters and BatchNorm statistics), every optimizer
entry's ``state_dict``, the losses' parameters, optimizers and schedule
states, the XBM buffers, every generator's state, ``step``, ``epoch`` and
``model_alpha``.  The tensors are copied to the host first, as
``jax.device_get`` does.  A plateau scheduler's state is host state outside
the JAX ``TrainState`` and is not saved there either.

Every file is written under a temporary name and then ``os.replace``d.  An
async save writes ``rolling.next`` on one background thread, at most one
save in flight; the next save, ``finalize_checkpoints`` and
``load_checkpoint`` promote it to ``rolling`` through ``rolling.old``, so a
crash at any point leaves a complete checkpoint for ``load_checkpoint``.
Each save logs its host-copy and write seconds and its size, also as the
log record's ``checkpoint`` attribute.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor

import torch

LOGGER = logging.getLogger(__name__)

# the one background writer and its save in flight (the JAX module's
# process-wide AsyncCheckpointer)
_WRITER: ThreadPoolExecutor | None = None
_PENDING: Future | None = None


def _ckpt_dir(log_dir: str) -> str:
    return os.path.join(os.path.abspath(log_dir), "weights")


def _to_host(obj):
    """A copy of ``obj`` with every tensor copied to the host (a CPU tensor
    too: the training goes on changing it while an async save writes)."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _to_device(obj, device):
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    return obj


def train_state_payload(tstate) -> dict:
    """Everything ``restore_train_state`` puts back, copied to the host."""
    xbm = tstate.xbm_state
    return _to_host({
        "model": tstate.model.state_dict(),
        "optimizers": {e.name: e.optimizer.state_dict() for e in tstate.optimizer_entries},
        "losses": {str(i): loss.state_dict() for i, (loss, _) in enumerate(tstate.losses)},
        "loss_optimizers": {k: opt.state_dict() for k, opt in tstate.loss_optimizers.items()},
        "loss_states": tstate.loss_states,
        "xbm": None if xbm is None else {"embeddings": xbm.embeddings, "labels": xbm.labels,
                                         "valid": xbm.valid, "ptr": xbm.ptr},
        "generators": {name: gen.get_state() for name, gen in tstate.generators.items()},
        "step": int(tstate.step),
        "epoch": int(tstate.epoch),
        "model_alpha": float(tstate.model_alpha),
    })


def restore_train_state(tstate, payload: dict):
    """Put a saved ``state`` back into ``tstate``, a freshly built
    ``TrainState`` of the same model, losses, optimizers and memory: the
    tensors are copied into the state's own, on its device."""
    device = next(tstate.model.parameters()).device
    tstate.model.load_state_dict(payload["model"])
    for entry in tstate.optimizer_entries:
        entry.optimizer.load_state_dict(payload["optimizers"][entry.name])
    for i, (loss, _) in enumerate(tstate.losses):
        loss.load_state_dict(payload["losses"][str(i)])
    for key, opt in tstate.loss_optimizers.items():
        opt.load_state_dict(payload["loss_optimizers"][key])
    tstate.loss_states = _to_device(payload["loss_states"], device)
    if (payload["xbm"] is None) != (tstate.xbm_state is None):
        raise ValueError("the checkpoint and the train state disagree on the XBM memory")
    if tstate.xbm_state is not None:
        for name, saved in payload["xbm"].items():
            getattr(tstate.xbm_state, name).copy_(saved)
    for name, gen in tstate.generators.items():
        gen.set_state(payload["generators"][name])
    tstate.step = payload["step"]
    tstate.epoch = payload["epoch"]
    tstate.model_alpha = payload["model_alpha"]
    return tstate


def _replace_file(write, path: str) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _write(payload: dict, path: str, epoch_path: str | None, info: dict, t0: float) -> None:
    _replace_file(lambda tmp: torch.save(payload, tmp), path)
    if epoch_path:
        _replace_file(lambda tmp: shutil.copyfile(path, tmp), epoch_path)
    info.update(write_seconds=time.perf_counter() - t0, bytes=os.path.getsize(path))
    LOGGER.info(f"checkpoint written: {path} (epoch {info['epoch']}"
                + (", async" if info["async"] else "")
                + f"): host copy {info['copy_seconds']:.3f} s, write "
                f"{info['write_seconds']:.3f} s, {info['bytes']} bytes",
                extra={"checkpoint": dict(info, path=path)})


def wait_for_checkpoints() -> None:
    """Block until the save in flight has been written (and raise its
    error, if it failed)."""
    global _PENDING
    if _PENDING is not None:
        pending, _PENDING = _PENDING, None
        pending.result()


def finalize_checkpoints(log_dir: str) -> None:
    """End-of-training barrier: write the save in flight and promote
    ``rolling.next`` to ``rolling``, so a finished run has its final
    ``weights/rolling`` on disk."""
    wait_for_checkpoints()
    _promote_rolling(_ckpt_dir(log_dir))


def _promote_rolling(base: str) -> None:
    """Promote a written ``rolling.next`` to ``rolling``: ``rolling`` →
    ``rolling.old``, ``rolling.next`` → ``rolling``, then drop
    ``rolling.old``; a crash between the renames leaves ``rolling.old``,
    which ``load_checkpoint`` falls back to."""
    nxt = os.path.join(base, "rolling.next")
    cur = os.path.join(base, "rolling")
    old = os.path.join(base, "rolling.old")
    if not os.path.exists(nxt):
        return
    if os.path.exists(old):
        os.remove(old)
    if os.path.exists(cur):
        os.rename(cur, old)
    os.rename(nxt, cur)
    if os.path.exists(old):
        os.remove(old)


def save_checkpoint(log_dir: str, tstate, config: dict, epoch: int, score: float | None = None,
                    best_score: float | None = None, save_model_every: int | None = None,
                    async_save: bool = False) -> None:
    """Write ``weights/rolling`` every call and ``weights/epoch_N`` when
    ``save_model_every`` divides ``epoch`` (chepoint.py:57-62).

    The state is copied to the host before this returns.  ``async_save``
    writes the file on the background thread, after waiting for the save
    before it and promoting that one; ``load_checkpoint`` waits for it, so
    no reader sees a half-written file."""
    global _WRITER, _PENDING
    base = _ckpt_dir(log_dir)
    os.makedirs(base, exist_ok=True)
    t0 = time.perf_counter()
    payload = {
        "state": train_state_payload(tstate),
        "meta": {"config": config, "epoch": int(epoch),
                 "score": None if score is None else float(score),
                 "best_score": None if best_score is None else float(best_score)},
    }
    info = {"epoch": int(epoch), "async": bool(async_save),
            "copy_seconds": time.perf_counter() - t0}
    path = os.path.join(base, "rolling")
    epoch_path = (os.path.join(base, f"epoch_{epoch}")
                  if save_model_every and epoch % save_model_every == 0 else None)
    if async_save:
        wait_for_checkpoints()
        _promote_rolling(base)  # commit the previous async save first
        if _WRITER is None:
            _WRITER = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
        # rolling.next, never rolling: the last good checkpoint stays until
        # this one is complete
        _PENDING = _WRITER.submit(_write, payload, path + ".next", epoch_path, info,
                                  time.perf_counter())
    else:
        # a stale rolling.next (a crashed async run) must not shadow this
        # newer save at the next load's promotion
        if os.path.exists(path + ".next"):
            os.remove(path + ".next")
        _write(payload, path, epoch_path, info, time.perf_counter())


def load_checkpoint(log_dir: str, map_location=None):
    """The rolling checkpoint as (state, meta), or None if there is none
    (the ``maybe_resume`` probe).  ``map_location`` as ``torch.load``'s;
    the tensors were saved from the host."""
    wait_for_checkpoints()  # never read a half-written async save
    base = _ckpt_dir(log_dir)
    _promote_rolling(base)  # adopt a written rolling.next
    path = os.path.join(base, "rolling")
    if not os.path.exists(path):
        # a crash between the promotion's renames: the previous save
        old = os.path.join(base, "rolling.old")
        if not os.path.exists(old):
            return None
        os.rename(old, path)
    payload = torch.load(path, map_location=map_location, weights_only=True)
    LOGGER.info(f"checkpoint restored from {path}")
    return payload["state"], payload["meta"]


def maybe_resume(tstate, log_dir: str, map_location=None) -> dict | None:
    """Resume ``tstate`` from ``log_dir``'s rolling checkpoint and return its
    meta; with none, rotate a stale ``metrics.jsonl`` (a crashed attempt
    before its first save, or a re-run under the same name) to
    ``metrics.jsonl.stale`` so the logger does not append to it, and return
    None (``run.py:147-166``)."""
    restored = load_checkpoint(log_dir, map_location)
    if restored is not None:
        payload, meta = restored
        restore_train_state(tstate, payload)
        LOGGER.info(f"resumed from epoch {meta['epoch']}")
        return meta
    stale = os.path.join(log_dir, "metrics.jsonl")
    if os.path.exists(stale):
        os.replace(stale, stale + ".stale")
        LOGGER.info("rotated stale metrics.jsonl from a previous attempt")
    return None
