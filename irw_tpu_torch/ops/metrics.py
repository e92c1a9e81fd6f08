"""Retrieval metrics on device (port of ``irw_tpu/ops/metrics.py:1-185,
191-346, 349-412``).

Same semantics as the JAX suite, which follows the reference's
``AccuracyCalculator``:

- multi-label relevance = label-vector dot product > 0; integer labels =
  equality;
- lone queries (no relevant gallery item) are excluded from the means of
  map, map_at_r, r_precision, precision_at_1 and mean_reciprocal_rank, but
  NOT from recall_at_k or maphashing, which divide by every query
  (metrics.py:278-290);
- under ``same_source`` each query's own index is dropped from the ranking;
- ``map`` is torchmetrics.RetrievalMAP (denominator = positives in the
  retrieved list), ``map_at_r`` PML's (denominator R = total relevant),
  ``r_precision`` torchmetrics' (R = relevant within the list).

Queries are ranked in chunks with ``ops.knn.top_k`` (``jax.lax.top_k``'s
tie order).  The PR curve (``with_curve``) is not on the eval path and waits
for ROADMAP A7's remainder.
"""

from __future__ import annotations

from typing import Sequence

import torch

from irw_tpu_torch.ops.knn import masked_scores, top_k
from irw_tpu_torch.utils.label_matrix import create_label_matrix

DEFAULT_RECALL_KS = (1, 2, 4, 8, 10, 16, 20, 30, 32, 100)


def relevance_counts(query_labels, gallery_labels, same_source: bool = False):
    """Per-query number of relevant gallery items (minus self under
    same-source).  Returns (counts, not_lone_mask)."""
    counts = create_label_matrix(query_labels, gallery_labels).sum(dim=1)
    if same_source:
        counts = counts - 1.0
    return counts, counts > 0


def _ranks(k: int, ref):
    return torch.arange(1, k + 1, dtype=ref.dtype, device=ref.device)


def average_precision(rel):
    """Per-query AP over the ranked list; denominator = positives in it."""
    cum = torch.cumsum(rel, dim=1)
    precision_at_hit = (cum / _ranks(rel.shape[1], rel)) * rel
    return precision_at_hit.sum(dim=1) / torch.clamp(rel.sum(dim=1), min=1.0)


def average_precision_at_r(rel, num_relevant):
    """PML mAP@R: ranks ≤ R count, denominator R (capped at the list length)."""
    k = rel.shape[1]
    ranks = _ranks(k, rel)
    r = torch.clamp(num_relevant.to(rel.dtype), max=float(k))[:, None]
    in_r = (ranks[None, :] <= r).to(rel.dtype)
    precision_at_hit = (torch.cumsum(rel, dim=1) / ranks) * rel * in_r
    return precision_at_hit.sum(dim=1) / torch.clamp(r[:, 0], min=1.0)


def r_precision(rel):
    """torchmetrics RetrievalRPrecision on the list: R = relevant within it."""
    ranks = _ranks(rel.shape[1], rel)
    r = rel.sum(dim=1)[:, None]
    return (rel * (ranks[None, :] <= r)).sum(dim=1) / torch.clamp(r[:, 0], min=1.0)


def recall_at_k(rel, k: int):
    """1 if any relevant item is in the top k."""
    return (rel[:, :k].sum(dim=1) > 0).to(torch.float32)


def mean_reciprocal_rank(rel):
    ranks = _ranks(rel.shape[1], rel)
    first_hit = torch.where(rel > 0, ranks[None, :], torch.inf).amin(dim=1)
    return torch.where(torch.isfinite(first_hit), 1.0 / first_hit, 0.0)


def bit_balance(codes, valid=None):
    """Per-bit balance over gallery sign codes: 1 = 50/50, 0 = dead bit."""
    positive = (codes > 0).to(torch.float32)
    if valid is None:
        frac = positive.mean(dim=0)
    else:
        v = valid.to(torch.float32)
        frac = (positive * v[:, None]).sum(dim=0) / torch.clamp(v.sum(), min=1.0)
    return 1.0 - 2.0 * torch.abs(frac - 0.5)


def determine_k(query_labels, gallery_labels, k, same_source: bool) -> int:
    """Retrieval depth: ``None`` = the full gallery (minus self),
    ``"max_bin_count"`` = the largest gallery class (minus self), else
    ``min(k, gallery − self)`` (metrics.py:167-184)."""
    n_gallery = int(gallery_labels.shape[0])
    if k is None:
        return max(n_gallery - int(same_source), 1)
    if k == "max_bin_count":
        counts, _ = relevance_counts(gallery_labels, gallery_labels, same_source)
        return max(int(counts.max()), 1)
    return min(int(k), n_gallery - int(same_source))


def metric_keys(recall_ks, k: int) -> list:
    """The sums ``chunk_sums`` returns, in order."""
    keys = ["map", "map_at_r", "r_precision", "precision_at_1",
            "mean_reciprocal_rank", "maphashing", "n_valid", "n_queries"]
    return keys + [f"recall_at_{rk}" for rk in recall_ks if rk <= k]


def chunk_sums(q_c, ql_c, gallery, gallery_labels, k: int, metric: str, start: int,
               same_source: bool, recall_ks, gallery_valid=None):
    """The metric sums of the query chunk from ``start`` (metrics.py:191-346),
    a (len(metric_keys),) tensor."""
    _, idx = top_k(masked_scores(q_c, gallery, metric, start, same_source, gallery_valid), k)
    relmat = create_label_matrix(ql_c, gallery_labels)   # (chunk, G)
    rel = torch.gather(relmat, 1, idx)                   # relevance of the ranking
    counts = relmat.sum(dim=1) - float(same_source)
    w = (counts > 0).to(torch.float32)
    ap = average_precision(rel)
    sums = [torch.sum(ap * w), torch.sum(average_precision_at_r(rel, counts) * w),
            torch.sum(r_precision(rel) * w), torch.sum(rel[:, 0] * w),
            torch.sum(mean_reciprocal_rank(rel) * w),
            torch.sum(ap),   # maphashing: every query, lone ones adding 0
            torch.sum(w), torch.tensor(float(q_c.shape[0]), device=rel.device)]
    sums += [torch.sum(recall_at_k(rel, rk)) for rk in recall_ks if rk <= k]
    return torch.stack([s.to(torch.float32) for s in sums])


def means(keys, total, recall_ks) -> dict:
    """The metrics (Python floats) from the sums over every query chunk."""
    sums = dict(zip(keys, total))
    denom = torch.clamp(sums["n_valid"], min=1.0)
    denom_all = torch.clamp(sums["n_queries"], min=1.0)
    all_query_keys = {"maphashing"} | {f"recall_at_{rk}" for rk in recall_ks}
    return {key: float(sums[key] / (denom_all if key in all_query_keys else denom))
            for key in keys if key not in ("n_valid", "n_queries")}


def resolve_k(query_labels, gallery_labels, k, same_source: bool, gallery_valid=None) -> int:
    k_resolved = determine_k(query_labels, gallery_labels, k, same_source)
    if gallery_valid is not None:
        k_resolved = min(k_resolved, int(gallery_valid.sum()) - int(same_source))
    return k_resolved


def finish(out: dict, k_resolved: int, hashing_stats) -> dict:
    """``out`` with the hashing protocol's bit balance (``hashing_stats``:
    a (mean, worst) pair, or None without it) and ``num_k``."""
    if hashing_stats is not None:
        out["bit_balance"], out["worst_bit_balance"] = hashing_stats
    else:
        out.pop("maphashing", None)
    out["num_k"] = k_resolved
    return out


def hashing_stats(gallery, gallery_valid=None) -> tuple:
    bal = bit_balance(gallery, valid=gallery_valid)
    return float(bal.mean()), float(bal.min())


def compute_retrieval_metrics(query, query_labels, gallery, gallery_labels,
                              metric: str = "cosine", k: int | str | None = None,
                              same_source: bool = False,
                              recall_ks: Sequence[int] = DEFAULT_RECALL_KS,
                              with_curve: bool = False, with_hashing_stats: bool = False,
                              gallery_valid=None, query_chunk: int = 512) -> dict:
    """The reference's ``CustomCalculator.get_accuracy`` on device
    (metrics.py:358-412).  Inputs are tensors on one device; returns a dict
    of Python floats.  ``metric='hamming'`` on ±1 codes is the hashing
    protocol, with ``maphashing``, ``bit_balance`` and ``worst_bit_balance``."""
    if with_curve:
        raise NotImplementedError("the precision-recall curve waits for ROADMAP A7's remainder")
    query_labels = torch.as_tensor(query_labels, device=query.device)
    gallery_labels = torch.as_tensor(gallery_labels, device=query.device)
    k_resolved = resolve_k(query_labels, gallery_labels, k, same_source, gallery_valid)
    keys = metric_keys(recall_ks, k_resolved)
    total = torch.zeros(len(keys), dtype=torch.float32, device=query.device)
    for start in range(0, query.shape[0], query_chunk):
        total = total + chunk_sums(query[start:start + query_chunk],
                                   query_labels[start:start + query_chunk], gallery,
                                   gallery_labels, k_resolved, metric, start, same_source,
                                   recall_ks, gallery_valid)
    return finish(means(keys, total, recall_ks), k_resolved,
                  hashing_stats(gallery, gallery_valid) if with_hashing_stats else None)
