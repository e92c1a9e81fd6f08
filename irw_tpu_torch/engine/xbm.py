"""Cross-batch memory as a fixed-size buffer on the model's device (port of
``irw_tpu/engine/xbm.py:24-68``).

- ``unique=True``: a direct-mapped table, one slot per dataset index
  (slot = ``index % size``; size == the dataset's size keeps one entry per
  sample, as the reference's path-keyed dict did);
- ``unique=False``: a ring buffer with a rolling write pointer.

``update`` writes in place; ``weight`` scales the memory-loss term and
``activate_after`` is the first epoch that term runs in (the train loop's
gate); inserts happen in every epoch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class XBMState:
    embeddings: torch.Tensor  # (size, D)
    labels: torch.Tensor  # (size,) or (size, C)
    valid: torch.Tensor  # (size,) bool
    ptr: torch.Tensor  # 0-d int64 (ring mode)


@dataclass(frozen=True)
class XBM:
    size: int
    embedding_dim: int
    label_shape: tuple = ()
    unique: bool = True
    weight: float = 1.0
    activate_after: int = 0

    def init(self, device=None, dtype=torch.float32) -> XBMState:
        return XBMState(
            embeddings=torch.zeros((self.size, self.embedding_dim), dtype=dtype, device=device),
            labels=torch.zeros((self.size,) + tuple(self.label_shape), device=device,
                               dtype=dtype if self.label_shape else torch.int32),
            valid=torch.zeros((self.size,), dtype=torch.bool, device=device),
            ptr=torch.zeros((), dtype=torch.int64, device=device),
        )

    def update(self, state: XBMState, embeddings, labels, indices=None) -> XBMState:
        """Insert a batch: ``embeddings`` (detached), ``labels`` and, with
        ``unique``, ``indices`` (dataset positions) as tensors on the
        buffer's device.  Nothing is read back to the host."""
        b = embeddings.shape[0]
        if self.unique:
            if indices is None:
                raise ValueError("a unique XBM is keyed on the batch's dataset indices")
            slots = indices.to(torch.int64) % self.size
        else:
            slots = (state.ptr + torch.arange(b, device=state.ptr.device)) % self.size
        state.embeddings[slots] = embeddings.detach().to(state.embeddings.dtype)
        state.labels[slots] = labels.to(state.labels.dtype)
        state.valid[slots] = True
        state.ptr.copy_((state.ptr + b) % self.size)
        return state

    def contents(self, state: XBMState):
        """(embeddings, labels, valid) at fixed shapes; a consumer masks the
        invalid slots."""
        return state.embeddings, state.labels, state.valid


def get_memory(memory_config, embedding_dim: int, label_shape=()) -> XBM | None:
    """The XBM of a ``configs/memory/*.yaml`` preset (port of
    ``irw_tpu/getter.py:127-146``): ``weight`` and ``activate_after`` at the
    top level or in ``kwargs`` with {size, unique}; ``name: null`` or
    ``size: null`` means no memory."""
    if not memory_config or not memory_config.get("name", "XBM"):
        return None
    kwargs = dict(memory_config.get("kwargs") or memory_config)
    kwargs.pop("name", None)
    if kwargs.get("size") in (None, 0):
        return None
    return XBM(
        size=int(kwargs["size"]),
        embedding_dim=embedding_dim,
        label_shape=tuple(label_shape),
        unique=bool(kwargs.get("unique", True)),
        weight=float(kwargs.get("weight", memory_config.get("weight", 1.0) or 1.0)),
        activate_after=int(kwargs.get("activate_after",
                                      memory_config.get("activate_after", 0) or 0)),
    )
