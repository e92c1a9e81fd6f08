"""The epoch loader (port of ``irw_tpu/data/loader.py:21-182``, its PIL
path).

Iterates the sampler's batch index lists; each batch is ``{"image": (B, H,
W, 3) uint8, "label", "index"}``, ``index`` being the dataset positions the
XBM memory is keyed on.  With a ``host_transform``
(``transforms.HostTransform``) batch ``b`` draws its augmentations from
``np.random.RandomState(seed * 100003 + b)`` (``train`` selects them) and
the host stage makes its images from the dataset's stored ones; with
``host_transform=None`` the stored images pass through as they are.  With
``num_workers`` > 0 the batches are made up to ``prefetch`` ahead on that
many threads (numpy releases the interpreter lock in its loops) and come
out in the sampler's order; with 0 each is made when it is asked for.

The native C++ decode path of the JAX loader serves file-backed datasets,
which wait for ROADMAP A8c with it.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class EpochLoader:
    def __init__(self, dataset, batches, host_transform=None, num_workers: int = 8,
                 prefetch: int = 4, train: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batches = list(batches)
        self.host_transform = host_transform
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.train = train
        self.seed = seed

    def __len__(self):
        return len(self.batches)

    def _load_batch(self, batch_idx: int, indices) -> dict:
        indices = np.asarray(indices)
        if self.host_transform is None:
            images = self.dataset.images[indices]
        else:
            rng = np.random.RandomState(self.seed * 100003 + batch_idx)
            images = self.host_transform.batch([self.dataset.images[i] for i in indices], rng,
                                               self.train)
        return {"image": images, "label": self.dataset.labels[indices], "index": indices}

    def __iter__(self):
        if self.num_workers <= 0:
            for b_idx, indices in enumerate(self.batches):
                yield self._load_batch(b_idx, indices)
            return
        with ThreadPoolExecutor(self.num_workers, thread_name_prefix="loader") as pool:
            pending = deque()
            try:
                for b_idx, indices in enumerate(self.batches):
                    pending.append(pool.submit(self._load_batch, b_idx, indices))
                    if len(pending) > self.prefetch:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:  # the consumer stopped early: drop what has not started
                for future in pending:
                    future.cancel()
