"""Exact k-NN in query chunks (port of ``irw_tpu/ops/knn.py``).

Ranking reproduces ``jax.lax.top_k``'s order exactly: among equal scores
the LOWER gallery index comes first.  Hamming distances on 64-bit codes tie
constantly and ``torch.topk`` promises no order among ties, so the port
ranks with a stable descending sort instead.  Self-matches under
``same_source`` are masked by index, not by distance (duplicate-safe).
"""

from __future__ import annotations

import torch

from irw_tpu_torch.ops.distances import is_similarity, pairwise_distance


def top_k(scores, k: int):
    """(values, indices) of the k largest per row, ties broken by lower
    index first (``jax.lax.top_k`` semantics)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def masked_scores(q_chunk, gallery, metric: str, offset: int, same_source: bool,
                  gallery_valid=None):
    """(chunk, G) similarities (distances negated), with invalid gallery rows
    and — under ``same_source`` — each query's own index pushed to −inf."""
    mat = pairwise_distance(q_chunk, gallery, metric)
    if not is_similarity(metric):
        mat = -mat
    if gallery_valid is not None:
        mat = torch.where(gallery_valid[None, :], mat, float("-inf"))
    if same_source:
        rows = offset + torch.arange(q_chunk.shape[0], device=mat.device)
        mat[torch.arange(q_chunk.shape[0], device=mat.device), rows] = float("-inf")
    return mat


def knn(queries, gallery, k: int, metric: str = "cosine", same_source: bool = False,
        query_chunk: int = 1024, gallery_valid=None):
    """(indices, scores) of the k nearest gallery items per query; scores are
    similarities (distances negated) whatever the metric."""
    k = min(k, gallery.shape[0])
    idx, scores = [], []
    for start in range(0, queries.shape[0], query_chunk):
        mat = masked_scores(queries[start:start + query_chunk], gallery, metric,
                            start, same_source, gallery_valid)
        s, i = top_k(mat, k)
        scores.append(s)
        idx.append(i)
    return torch.cat(idx), torch.cat(scores)
