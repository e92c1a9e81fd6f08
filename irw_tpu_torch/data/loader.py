"""The epoch loader (in place of ``irw_tpu/data/loader.py:21-182``).

A plain in-memory iterator over the sampler's batch index lists: each batch
is ``{"image": (B, H, W, 3) uint8, "label", "index"}`` gathered from the
dataset's ``images`` and ``labels``; ``index`` is the dataset positions the
XBM memory is keyed on.  The host transform stage (PIL geometry,
``ColorJitter``) waits for ROADMAP A8b: with ``host_transform=None`` the
images pass through as stored, and any other transform raises.  ``seed``
and ``train`` are the JAX constructor's, kept for that stage.  With
``num_workers`` > 0 the gathers run up to ``prefetch`` batches ahead on
that many threads (numpy copies without the interpreter lock) and come out
in the sampler's order; with 0 each is made when it is asked for.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class EpochLoader:
    def __init__(self, dataset, batches, host_transform=None, num_workers: int = 8,
                 prefetch: int = 4, train: bool = True, seed: int = 0):
        if host_transform is not None:
            raise NotImplementedError("a host transform stage waits for ROADMAP A8b; pass "
                                      "host_transform=None to use the stored images")
        self.dataset = dataset
        self.batches = list(batches)
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.train = train
        self.seed = seed

    def __len__(self):
        return len(self.batches)

    def _gather(self, indices) -> dict:
        indices = np.asarray(indices)
        return {"image": self.dataset.images[indices], "label": self.dataset.labels[indices],
                "index": indices}

    def __iter__(self):
        if self.num_workers <= 0:
            for indices in self.batches:
                yield self._gather(indices)
            return
        with ThreadPoolExecutor(self.num_workers, thread_name_prefix="loader") as pool:
            pending = deque()
            try:
                for indices in self.batches:
                    pending.append(pool.submit(self._gather, indices))
                    if len(pending) > self.prefetch:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:  # the consumer stopped early: drop what has not started
                for future in pending:
                    future.cancel()
