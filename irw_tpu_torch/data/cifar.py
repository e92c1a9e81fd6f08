"""CIFAR datasets from the standard python pickle batches, read directly
(port of ``irw_tpu/data/cifar.py``).

``Cifar10Retrieval`` is the 54k-database hashing protocol: 100 queries
and 500 train images a class, drawn from ``seed``; the database is
everything but the queries.  The images stay in memory (``images``).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from irw_tpu_torch.data.base import InMemoryDataset


def _load_cifar10(data_dir: str):
    root = data_dir
    if os.path.isdir(os.path.join(root, "cifar-10-batches-py")):
        root = os.path.join(root, "cifar-10-batches-py")
    images, labels = [], []
    for fname in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(root, fname), "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        images.append(batch[b"data"])
        labels.extend(batch[b"labels"])
    images = np.concatenate(images).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return images, np.asarray(labels)


def _load_cifar100(data_dir: str):
    root = data_dir
    if os.path.isdir(os.path.join(root, "cifar-100-python")):
        root = os.path.join(root, "cifar-100-python")
    images, labels, supers = [], [], []
    for fname in ("train", "test"):
        with open(os.path.join(root, fname), "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        images.append(batch[b"data"])
        labels.extend(batch[b"fine_labels"])
        supers.extend(batch[b"coarse_labels"])
    images = np.concatenate(images).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return images, np.asarray(labels), np.asarray(supers)


class _InMemory(InMemoryDataset):
    def __init__(self, images, labels, supers=None, mode="train"):
        paths = [f"cifar://{i}" for i in range(len(images))]
        super().__init__(paths, labels, supers, mode)
        self.images = images


class CifarDataset(_InMemory):
    """cifar.py:5 — plain CIFAR-10 (train = 50k batches, test = test batch)."""

    def __init__(self, data_dir: str, mode: str = "train", **kw):
        images, labels = _load_cifar10(data_dir)
        if mode == "train":
            sel = slice(0, 50000)
        else:
            sel = slice(50000, 60000)
        super().__init__(images[sel], labels[sel], mode=mode)


class Cifar100RetrievalDataset(_InMemory):
    """cifar100_v2.py:6 — class-disjoint retrieval: fine labels 0-49 train,
    50-99 test."""

    def __init__(self, data_dir: str, mode: str = "train", **kw):
        images, labels, supers = _load_cifar100(data_dir)
        mask = labels < 50 if mode == "train" else labels >= 50
        super().__init__(images[mask], labels[mask], supers[mask], mode=mode)


class Cifar10Retrieval(_InMemory):
    """cifar10_hashing.py:9-70 — hashing protocol: per class 100 query +
    500 train; database = everything except queries (54k)."""

    def __init__(self, data_dir: str, mode: str = "train", seed: int = 0, **kw):
        images, labels = _load_cifar10(data_dir)
        rng = np.random.RandomState(seed)
        query_idx, train_idx = [], []
        for cls in range(10):
            idx = np.where(labels == cls)[0]
            rng.shuffle(idx)
            query_idx.extend(idx[:100])
            train_idx.extend(idx[100:600])
        query_idx = np.asarray(sorted(query_idx))
        train_idx = np.asarray(sorted(train_idx))
        if mode in ("query", "test"):
            sel = query_idx
        elif mode == "train":
            sel = train_idx
        else:  # gallery / database: all except queries
            mask = np.ones(len(labels), bool)
            mask[query_idx] = False
            sel = np.where(mask)[0]
        super().__init__(images[sel], labels[sel], mode=mode)
