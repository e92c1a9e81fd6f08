"""Cross-validation splits (port of ``irw_tpu/engine/splits.py``).

Three protocols, each returning (train indices, val indices) per fold:

- ``class_disjoint`` (alias ``open_set``): the folds partition the class
  set, so a val fold holds classes the train side never sees;
- ``hierarchical``: class-disjoint, each super-label's classes spread over
  the folds;
- ``closed_set``: stratified k-fold over the samples (multi-label
  stratifies on each row's first active class).

``closed_set`` is scikit-learn's ``StratifiedKFold(shuffle=True,
random_state=seed)`` written in numpy (the port does not import
scikit-learn): the classes encoded in order of first appearance, each
class's per-fold counts from a round robin over the sorted labels, and each
class's block of fold ids shuffled by one ``RandomState(seed)`` in class
order.  It gives scikit-learn 1.9's folds index for index and raises as it
does.
"""

from __future__ import annotations

import warnings

import numpy as np


def _class_folds(classes, n_splits, rng):
    classes = np.asarray(classes)
    rng.shuffle(classes)
    return np.array_split(classes, n_splits)


def _held_out(labels, fold_classes) -> tuple:
    val_mask = np.isin(labels, np.asarray(fold_classes))
    return np.where(~val_mask)[0], np.where(val_mask)[0]


def class_disjoint_splits(labels, n_splits: int = 4, seed: int = 0):
    labels = np.asarray(labels)
    rng = np.random.RandomState(seed)
    return [_held_out(labels, fold) for fold in _class_folds(np.unique(labels), n_splits, rng)]


def hierarchical_splits(labels, super_labels, n_splits: int = 4, seed: int = 0):
    labels = np.asarray(labels)
    super_labels = np.asarray(super_labels)
    rng = np.random.RandomState(seed)
    fold_classes = [[] for _ in range(n_splits)]
    for sup in np.unique(super_labels):
        folds = _class_folds(np.unique(labels[super_labels == sup]), n_splits, rng)
        order = rng.permutation(n_splits)
        for i, fold in enumerate(folds):
            fold_classes[order[i]].extend(fold.tolist())
    return [_held_out(labels, fold) for fold in fold_classes]


def stratified_test_folds(strat, n_splits: int, seed: int) -> np.ndarray:
    """Each sample's test fold: ``StratifiedKFold._make_test_folds`` with
    ``shuffle=True`` and ``random_state=seed``."""
    if n_splits < 2:
        raise ValueError("k-fold cross-validation requires at least one train/test split by "
                         f"setting n_splits=2 or more, got n_splits={n_splits}.")
    if n_splits > len(strat):
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater than the "
                         f"number of samples: n_samples={len(strat)}.")
    rng = np.random.RandomState(seed)
    _, first, inverse = np.unique(strat, return_index=True, return_inverse=True)
    _, class_perm = np.unique(first, return_inverse=True)  # classes by first appearance
    encoded = class_perm[inverse]
    n_classes = len(first)
    counts = np.bincount(encoded)
    if np.all(n_splits > counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of members "
                         "in each class.")
    if n_splits > counts.min():
        warnings.warn(f"The least populated class in y has only {counts.min()} members, "
                      f"which is less than n_splits={n_splits}.", UserWarning)
    ordered = np.sort(encoded)
    allocation = np.asarray([np.bincount(ordered[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    folds = np.empty(len(strat), dtype="i")
    for k in range(n_classes):
        fold_ids = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(fold_ids)
        folds[encoded == k] = fold_ids
    return folds


def closed_set_splits(labels, n_splits: int = 4, seed: int = 0):
    labels = np.asarray(labels)
    strat = labels.argmax(axis=1) if labels.ndim > 1 else labels
    folds = stratified_test_folds(strat, n_splits, seed)
    indices = np.arange(len(strat))
    return [(indices[folds != i], indices[folds == i]) for i in range(n_splits)]


def get_splits(labels, super_labels=None, kind: str = "class_disjoint", n_splits: int = 4,
               seed: int = 0):
    """The folds of ``kind`` over ``labels``: [(train indices, val indices)]."""
    if kind in ("class_disjoint", "open_set"):
        return class_disjoint_splits(labels, n_splits, seed)
    if kind == "hierarchical":
        assert super_labels is not None
        return hierarchical_splits(labels, super_labels, n_splits, seed)
    if kind == "closed_set":
        return closed_set_splits(labels, n_splits, seed)
    raise ValueError(f"unknown split kind {kind!r}")
