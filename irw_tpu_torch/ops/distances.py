"""Pairwise distance / similarity matrices (port of
``irw_tpu/ops/distances.py``), computed in f32 with ``torch.matmul`` —
the JAX package left these products to XLA, outside any Pallas kernel.

Metrics: ``l2``, ``sql2``, ``ip``, ``cosine`` and ``hamming``, the Hamming
distance between ±1 codes 0.5·(nbits − q·gᵀ).
"""

from __future__ import annotations

import torch

SIMILARITY_METRICS = ("ip", "cosine")
DISTANCE_METRICS = ("l2", "sql2", "hamming")


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    return x * torch.rsqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


def pairwise_distance(queries, gallery, metric: str = "cosine"):
    """(Q, D) × (G, D) → (Q, G) distance or similarity matrix, f32."""
    q = queries.float()
    g = gallery.float()
    if metric == "cosine":
        return l2_normalize(q) @ l2_normalize(g).T
    if metric == "ip":
        return q @ g.T
    if metric in ("l2", "sql2"):
        qq = torch.sum(q * q, dim=-1, keepdim=True)
        gg = torch.sum(g * g, dim=-1, keepdim=True)
        sq = torch.clamp(qq + gg.T - 2.0 * (q @ g.T), min=0.0)
        return sq if metric == "sql2" else torch.sqrt(sq)
    if metric == "hamming":
        return 0.5 * (q.shape[-1] - q @ g.T)
    raise ValueError(f"unknown metric {metric!r}")


def is_similarity(metric: str) -> bool:
    """True if larger values mean more relevant (ip/cosine)."""
    if metric in SIMILARITY_METRICS:
        return True
    if metric in DISTANCE_METRICS:
        return False
    raise ValueError(f"unknown metric {metric!r}")
