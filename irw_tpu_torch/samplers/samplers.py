"""Epoch-static batch samplers (port of ``irw_tpu/samplers/samplers.py``).

Pure numpy index algebra: each ``reshuffle(epoch)`` makes the same sequence
of calls on a ``np.random.RandomState(seed + epoch)`` as the JAX package,
so one (seed, epoch) gives the same batches in both packages.

- ``RandomSampler``: a plain shuffle, fixed batches, the remainder dropped;
- ``MPerClassSampler``: class-depleting batches of ``samples_per_class``
  instances from ``batch_size / samples_per_class`` classes, drawn from
  ``dataset.instance_dict``;
- ``HierarchicalSampler``: ``batches_per_super_pair`` batches for every
  ``nb_categories``-sized combination of super-labels, split evenly between
  them (``dataset.super_dict``); under-filled batches are dropped, as in the
  JAX package, so every batch has one shape.
"""

from __future__ import annotations

import itertools
import logging

import numpy as np

LOGGER = logging.getLogger(__name__)


class SamplerBase:
    def __init__(self, dataset, batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.seed = seed
        self.batches: list[np.ndarray] = []

    def reshuffle(self, epoch: int = 0):
        raise NotImplementedError

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


class RandomSampler(SamplerBase):
    """Plain shuffle, fixed batch, remainder dropped (samplers.py:40-52)."""

    def reshuffle(self, epoch: int = 0):
        rng = np.random.RandomState(self.seed + epoch)
        order = rng.permutation(len(self.dataset))
        n_batches = len(order) // self.batch_size
        self.batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                        for i in range(n_batches)]
        return self


class MPerClassSampler(SamplerBase):
    """Class-depleting batches (samplers.py:54-106): every class pool is
    shuffled once an epoch; each sweep over the shuffled class order takes
    ``samples_per_class`` instances from the first classes that still hold
    that many, one batch a sweep, until a sweep cannot fill a batch."""

    def __init__(self, dataset, batch_size: int, samples_per_class: int = 4,
                 seed: int = 0, **kw):
        super().__init__(dataset, batch_size, seed)
        if samples_per_class <= 1 or batch_size % samples_per_class:
            raise ValueError(f"samples_per_class {samples_per_class} must exceed 1 and divide "
                             f"batch_size {batch_size}")
        self.samples_per_class = int(samples_per_class)

    def reshuffle(self, epoch: int = 0):
        rng = np.random.RandomState(self.seed + epoch)
        spc = self.samples_per_class
        classes_per_batch = self.batch_size // spc

        # the JAX package's rng call order: each class pool in dict order,
        # then the class order, then within each flushed batch, then the
        # batch list
        pools: dict = {}
        for cls, idxs in self.dataset.instance_dict.items():
            pool = list(idxs)
            rng.shuffle(pool)
            pools[cls] = pool
        classes = list(pools)
        rng.shuffle(classes)

        batches: list[list[int]] = []
        groups: list[list[int]] = []
        while True:
            for cls in classes:
                if len(pools[cls]) >= spc and len(groups) < classes_per_batch:
                    groups.append(pools[cls][:spc])
                    pools[cls] = pools[cls][spc:]
            if len(groups) != classes_per_batch:
                break
            flat = [i for grp in groups for i in grp]
            rng.shuffle(flat)
            batches.append(flat)
            groups = []

        rng.shuffle(batches)
        self.batches = [np.asarray(b) for b in batches]
        return self


class HierarchicalSampler(SamplerBase):
    """Batches per super-label combination (samplers.py:109-193):
    ``samples_per_class`` instances a class (with replacement iff the class
    is smaller), or all of a class's instances with ``samples_per_class=0``;
    a class that would overflow its super's share is skipped."""

    def __init__(self, dataset, batch_size: int, samples_per_class: int = 4,
                 batches_per_super_pair: int = 10, nb_categories: int = 2, seed: int = 0,
                 drop_incomplete: bool = True, **kw):
        super().__init__(dataset, batch_size, seed)
        self.batches_per_super_pair = int(batches_per_super_pair)
        self.nb_categories = int(nb_categories)
        if self.batch_size % self.nb_categories:
            raise ValueError(f"batch_size should be a multiple of {self.nb_categories}")
        self.sub_batch_len = self.batch_size // self.nb_categories
        samples_per_class = int(samples_per_class)
        if samples_per_class > 0 and self.sub_batch_len % samples_per_class:
            raise ValueError("batch_size not a multiple of samples_per_class")
        self.samples_per_class = samples_per_class or None  # None: all instances
        self.drop_incomplete = drop_incomplete
        supers = sorted(set(np.asarray(dataset.super_labels).tolist()))
        if len(supers) < self.nb_categories:
            raise ValueError("not enough super-labels for hierarchical sampling")
        self.super_pairs = list(itertools.combinations(supers, self.nb_categories))

    def reshuffle(self, epoch: int = 0):
        rng = np.random.RandomState(self.seed + epoch)
        super_dict = self.dataset.super_dict  # super → {class → indices}

        batches: list[list[int]] = []
        for combo in self.super_pairs:
            for _ in range(self.batches_per_super_pair):
                batch: list[int] = []
                for sup in combo:
                    sub_batch: list[int] = []
                    class_dict = super_dict[sup]
                    all_classes = list(class_dict)
                    rng.shuffle(all_classes)
                    for cls in all_classes:
                        instances = np.asarray(class_dict[cls])
                        k = self.samples_per_class or len(instances)
                        if len(sub_batch) + k > self.sub_batch_len:
                            continue
                        sub_batch.extend(rng.choice(instances, size=k,
                                                    replace=len(instances) < k).tolist())
                    batch.extend(sub_batch)
                rng.shuffle(batch)
                batches.append(batch)
        rng.shuffle(batches)

        if self.drop_incomplete:
            full = [b for b in batches if len(b) == self.batch_size]
            if len(full) != len(batches):
                LOGGER.warning(f"HierarchicalSampler dropped {len(batches) - len(full)} "
                               "under-filled batches (every batch keeps one shape)")
            batches = full
        self.batches = [np.asarray(b) for b in batches]
        return self


SAMPLERS = {
    "RandomSampler": RandomSampler,
    "MPerClassSampler": MPerClassSampler,
    "HierarchicalSampler": HierarchicalSampler,
}


def get_sampler(name: str, dataset, **kwargs):
    try:
        cls = SAMPLERS[name]
    except KeyError as exc:
        raise ValueError(f"unknown sampler {name!r}; available: {sorted(SAMPLERS)}") from exc
    return cls(dataset, **kwargs)
