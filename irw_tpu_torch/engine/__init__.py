"""Retrieval evaluation and training on one device."""

from irw_tpu_torch.engine.evaluate import compute_embeddings, evaluate
from irw_tpu_torch.engine.train_state import TrainState, init_train_state
from irw_tpu_torch.engine.train_step import batch_proxy_map, build_train_step

__all__ = ["TrainState", "batch_proxy_map", "build_train_step", "compute_embeddings",
           "evaluate", "init_train_state"]
