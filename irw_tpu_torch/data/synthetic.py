"""Deterministic in-memory datasets (port of
``irw_tpu/data/synthetic.py:16-67, 88-125``).

The images are drawn with numpy exactly as the JAX package draws them, so
one seed gives the same uint8 arrays in both packages.  They are kept as an
(N, H, W, 3) uint8 array in ``images`` (no PIL).  The multi-object
``hard=True`` generator of ``SyntheticVOCDataset`` waits for ROADMAP A8.
"""

from __future__ import annotations

import numpy as np


class SyntheticDataset:
    """Class-dependent frequency patterns + noise; ``labels`` are (N,) class
    ids, or (N, num_label_dims) float multi-label vectors."""

    def __init__(self, num_samples: int = 256, num_classes: int = 8, image_size: int = 64,
                 multi_label: bool = False, num_label_dims: int = 20, seed: int = 0):
        rng = np.random.RandomState(seed)
        if multi_label:
            labels = np.zeros((num_samples, num_label_dims), np.float32)
            primary = rng.randint(0, num_classes, num_samples)
            for i, p in enumerate(primary):
                labels[i, p % num_label_dims] = 1.0
                extra = rng.randint(0, num_label_dims, 2)
                labels[i, extra] = 1.0
            class_id = primary
        else:
            class_id = rng.randint(0, num_classes, num_samples)
            labels = class_id
        self.labels = np.asarray(labels)

        yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32)
        images = np.zeros((num_samples, image_size, image_size, 3), np.uint8)
        for i in range(num_samples):
            freq = 2 * np.pi * (1 + class_id[i]) / image_size
            phase = rng.rand() * np.pi
            base = np.stack([np.sin(freq * xx + phase),
                             np.cos(freq * yy + phase),
                             np.sin(freq * (xx + yy) / 2 + phase)], axis=-1)
            noisy = base + 0.3 * rng.randn(image_size, image_size, 3)
            images[i] = np.clip((noisy * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
        self.images = images

    def __len__(self):
        return len(self.images)


class SyntheticVOCDataset(SyntheticDataset):
    """VOC2012Hashing-shaped protocol: train == database == gallery
    (``num_train``, default 5717), query/val/test a disjoint draw
    (``num_query``, default 5823), 20-dim float multi-label vectors."""

    def __init__(self, num_train: int = 5717, num_query: int = 5823, mode: str = "train",
                 seed: int = 0, hard: bool = False, **kw):
        if hard:
            raise NotImplementedError("SyntheticVOCDataset(hard=True) waits for ROADMAP A8")
        is_query = mode in ("query", "test", "val")
        kw.setdefault("multi_label", True)
        kw.setdefault("num_label_dims", 20)
        kw.setdefault("num_classes", 20)
        kw.pop("num_samples", None)
        n = int(num_query) if is_query else int(num_train)
        super().__init__(num_samples=n, seed=seed * 10 + (1 if is_query else 0), **kw)
