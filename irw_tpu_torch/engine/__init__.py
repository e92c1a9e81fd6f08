"""Retrieval evaluation on one device."""

from irw_tpu_torch.engine.evaluate import compute_embeddings, evaluate

__all__ = ["compute_embeddings", "evaluate"]
