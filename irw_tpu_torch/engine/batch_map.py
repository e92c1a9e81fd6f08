"""The fast-eval subset (port of ``irw_tpu/engine/batch_map.py:14-37``).

The per-batch proxy mAP is ``engine.train_step.batch_proxy_map``.
"""

from __future__ import annotations

import numpy as np

from irw_tpu_torch.data.base import subset


def build_fast_eval_subset(dataset, per_class: int = 5, max_classes: int | None = None,
                           seed: int = 0, min_per_class: int = 2):
    """A fixed stratified subset for a cheap eval in training: ``per_class``
    samples of each class with at least ``min_per_class`` members (a
    singleton would be a lone self-retrieval query), the classes shuffled
    before the ``max_classes`` cap, drawn without replacement by one
    ``RandomState(seed)``, in index order, in eval mode."""
    rng = np.random.RandomState(seed)
    inst = dataset.instance_dict
    classes = sorted(c for c in inst if len(inst[c]) >= min_per_class)
    rng.shuffle(classes)
    if max_classes is not None:
        classes = classes[:max_classes]
    keep = []
    for cls in classes:
        idxs = np.asarray(inst[cls])
        keep.extend(rng.choice(idxs, min(per_class, len(idxs)), replace=False).tolist())
    return subset(dataset, sorted(keep), mode="eval")
