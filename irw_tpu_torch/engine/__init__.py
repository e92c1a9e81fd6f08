"""Retrieval evaluation, the train step, the epoch loop, checkpoints and the
XBM memory on one device."""

from irw_tpu_torch.engine.checkpoint import (
    finalize_checkpoints,
    load_checkpoint,
    maybe_resume,
    restore_train_state,
    save_checkpoint,
    wait_for_checkpoints,
)
from irw_tpu_torch.engine.evaluate import compute_embeddings, evaluate
from irw_tpu_torch.engine.train import MetricsLogger, train
from irw_tpu_torch.engine.train_state import TrainState, init_train_state
from irw_tpu_torch.engine.train_step import batch_proxy_map, build_train_step
from irw_tpu_torch.engine.xbm import XBM, XBMState, get_memory

__all__ = ["MetricsLogger", "TrainState", "XBM", "XBMState", "batch_proxy_map",
           "build_train_step", "compute_embeddings", "evaluate", "finalize_checkpoints",
           "get_memory", "init_train_state", "load_checkpoint", "maybe_resume",
           "restore_train_state", "save_checkpoint", "train", "wait_for_checkpoints"]
