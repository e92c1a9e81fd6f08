"""Pairwise relevance matrix (port of ``irw_tpu/utils/label_matrix.py``).

Integer class ids (B,): relevance is equality.  Multi-label vectors (B, C):
relevance is "shares at least one positive label", ``(labels @ otherᵀ) > 0``.
"""

from __future__ import annotations

import torch


def create_label_matrix(labels, other_labels=None, dtype=torch.float32):
    """The (B, B') 0/1 relevance matrix between two label sets."""
    if other_labels is None:
        other_labels = labels
    if labels.dim() == 1:
        matrix = labels[:, None] == other_labels[None, :]
    else:
        matrix = (labels.float() @ other_labels.float().T) > 0
    return matrix.to(dtype)
