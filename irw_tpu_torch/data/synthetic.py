"""Deterministic in-memory datasets (port of ``irw_tpu/data/synthetic.py:16-201``).

The images are drawn with numpy exactly as the JAX package draws them, so
one seed gives the same uint8 arrays and labels in both packages.  They are
kept as an (N, H, W, 3) uint8 array in ``images`` (no PIL).  The JAX
classes' ``paths`` are not kept: the XBM memory is keyed on the dataset
index instead.
"""

from __future__ import annotations

import numpy as np

from irw_tpu_torch.data.base import InMemoryDataset


class SyntheticDataset(InMemoryDataset):
    """Class-dependent frequency patterns + noise; ``labels`` are (N,) class
    ids, or (N, num_label_dims) float multi-label vectors."""

    def __init__(self, num_samples: int = 256, num_classes: int = 8, image_size: int = 64,
                 multi_label: bool = False, num_label_dims: int = 20, seed: int = 0,
                 mode: str = "train", **kw):
        # every mode draws the same set, and other keys are ignored, as in JAX
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
        self.super_labels = class_id % max(num_classes // 2, 2)

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


class SyntheticHashingDataset(SyntheticDataset):
    """The query/gallery protocol over one class distribution: disjoint
    seeded draws for train, query (= test, a quarter of ``num_samples``, at
    least 8) and gallery (= database)."""

    _MODE_SEEDS = {"train": 0, "query": 1, "test": 1, "gallery": 2, "database": 2}

    def __init__(self, num_samples: int = 256, mode: str = "train", seed: int = 0, **kw):
        sizes = {"train": num_samples, "query": max(num_samples // 4, 8)}
        n = sizes.get("train" if mode == "train" else
                      ("query" if mode in ("query", "test") else "gallery"), num_samples)
        super().__init__(num_samples=n if mode in ("train", "query", "test") else num_samples,
                         seed=seed * 10 + self._MODE_SEEDS.get(mode, 0), mode=mode, **kw)


class SyntheticVOCDataset(SyntheticDataset):
    """VOC2012Hashing-shaped protocol: train == database == gallery
    (``num_train``, default 5717), query/val/test a disjoint draw
    (``num_query``, default 5823), 20-dim float multi-label vectors.

    ``hard=True`` is the multi-object generator (synthetic.py:113-201):
    labels drawn from 6 scene topics with overlapping class preferences, at
    most 3 objects an image, each a localised oriented Gabor patch with
    jittered position, size, amplitude, orientation and frequency, over a
    label-independent low-frequency background and noise.
    """

    def __init__(self, num_train: int = 5717, num_query: int = 5823, mode: str = "train",
                 seed: int = 0, hard: bool = False, **kw):
        is_query = mode in ("query", "test", "val")
        kw.setdefault("multi_label", True)
        kw.setdefault("num_label_dims", 20)
        kw.setdefault("num_classes", 20)
        kw.pop("num_samples", None)
        n = int(num_query) if is_query else int(num_train)
        sub_seed = seed * 10 + (1 if is_query else 0)
        if not hard:
            super().__init__(num_samples=n, seed=sub_seed, mode=mode, **kw)
            return
        num_classes = int(kw["num_classes"])
        rng = np.random.RandomState(sub_seed)
        self.labels = self._sample_scene_labels(rng, n, num_classes)
        self.super_labels = self.labels.argmax(axis=1) % max(num_classes // 2, 2)
        self.images = self._render(rng, self.labels, int(kw.get("image_size", 64)))

    _N_SCENES = 6

    @classmethod
    def _scene_class_probs(cls, num_classes: int) -> np.ndarray:
        """The fixed scene → class preference matrix: each scene prefers an
        overlapping band of 7 classes; the first two classes are likely in
        every scene (VOC's 'person')."""
        srng = np.random.RandomState(12345)
        probs = np.full((cls._N_SCENES, num_classes), 0.02)
        for s in range(cls._N_SCENES):
            start = (s * num_classes) // cls._N_SCENES
            band = [(start + j) % num_classes for j in range(7)]
            probs[s, band] = srng.uniform(0.1, 0.4, len(band))
        probs[:, :2] += 0.15
        return probs

    @classmethod
    def _sample_scene_labels(cls, rng, n: int, num_classes: int) -> np.ndarray:
        probs = cls._scene_class_probs(num_classes)
        scenes = rng.randint(0, cls._N_SCENES, n)
        labels = (rng.rand(n, num_classes) < probs[scenes]).astype(np.float32)
        # at least one object an image: the scene's top class
        empty = labels.sum(1) == 0
        labels[empty, probs[scenes[empty]].argmax(1)] = 1.0
        # at most 3 objects, dropped uniformly
        for i in np.nonzero(labels.sum(1) > 3)[0]:
            on = np.nonzero(labels[i])[0]
            off = rng.choice(on, int(labels[i].sum()) - 3, replace=False)
            labels[i, off] = 0.0
        return labels

    @staticmethod
    def _render(rng, labels: np.ndarray, size: int) -> np.ndarray:
        n, num_classes = labels.shape
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
        # class signature: an orientation × frequency grid over low and high bands
        thetas = np.pi * np.arange(num_classes) / num_classes
        freqs = 2 * np.pi * (2.0 + 2.5 * (np.arange(num_classes) % 5)) / size
        crng = np.random.RandomState(54321)
        colors = crng.dirichlet(np.ones(3), num_classes).astype(np.float32)
        images = np.zeros((n, size, size, 3), np.uint8)
        for i in range(n):
            # distractor background: low-frequency illumination + noise
            th_b = rng.rand() * np.pi
            fb = 2 * np.pi * rng.uniform(0.5, 1.5) / size
            u = xx * np.cos(th_b) + yy * np.sin(th_b)
            img = 0.35 * np.sin(fb * u + rng.rand() * 2 * np.pi)[..., None]
            img = img + 0.2 * rng.randn(size, size, 1)
            img = np.repeat(img, 3, axis=-1).astype(np.float32)
            for c in np.nonzero(labels[i])[0]:
                cx, cy = rng.uniform(0.2, 0.8, 2) * size
                sigma = rng.uniform(0.15, 0.3) * size
                amp = rng.uniform(0.5, 1.0)
                th = thetas[c] + rng.uniform(-0.12, 0.12)
                f = freqs[c] * rng.uniform(0.85, 1.15)
                v = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
                env = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma ** 2))
                patch = amp * env * np.sin(f * v + rng.rand() * 2 * np.pi)
                img += patch[..., None] * (0.5 + colors[c])
            img *= rng.uniform(0.8, 1.2)  # contrast jitter
            images[i] = np.clip((img * 0.35 + 0.5) * 255, 0, 255).astype(np.uint8)
        return images
