"""Retrieval metrics over a process group (the port's counterpart of
``irw_tpu/parallel/eval_sharding.py:20-56``).

JAX shards the gallery over its mesh and replicates the queries.  The port
splits the other axis: every rank holds the whole gallery (``engine.evaluate``
gathers the embeddings for the distractor and landmark paths anyway), and
the query chunks of ``ops.metrics.compute_retrieval_metrics`` are dealt out
in contiguous blocks, one a rank.  A rank ranks each of its chunks against
the whole gallery with the single device's code at the single device's
shapes; the ranks gather the per-chunk sums and every rank adds them in
chunk order.  So every rank returns the single device's dict bit for bit,
and the score products, the sorts and the label matrices are split over
the ranks.

Why not the gallery: a rank that ranks a gallery block scores it with a
product of the block's width, and cuBLAS picks its f32 GEMM by shape.  On
an H100 the 162 × 2897 × 2048 product rounds scores up to 8.3e-7 away from
the 162 × 5794 × 2048 one, which reorders near-tied cosine scores (a
randomly drawn ResNet-50's CUB-sized eval moved its metrics by 1.7e-4).
Splitting the gallery pays only once the gallery outgrows one card: its
G × D × 4 bytes past 80 GB, some 9.8 M embeddings of 2048 floats.  No
configuration of the repo comes near that (VOC 5717, CUB 5794).

A device that runs out of memory in a rank's share makes every rank raise
(``mesh.agreed``), so all retry or none does.
"""

from __future__ import annotations

from typing import Sequence

import torch

from irw_tpu_torch.ops.metrics import (
    DEFAULT_RECALL_KS,
    chunk_sums,
    finish,
    hashing_stats,
    means,
    metric_keys,
    resolve_k,
)
from irw_tpu_torch.parallel.mesh import agreed, all_gather_rows, rank, world_size


def sharded_retrieval_metrics(query, query_labels, gallery, gallery_labels,
                              metric: str = "cosine", k: int | str | None = None,
                              same_source: bool = False,
                              recall_ks: Sequence[int] = DEFAULT_RECALL_KS,
                              with_curve: bool = False, with_hashing_stats: bool = False,
                              gallery_valid=None, query_chunk: int = 512) -> dict:
    """``compute_retrieval_metrics`` with its query chunks split over the
    process group.  Every rank passes the same tensors (labels may be numpy)
    and gets the same dict, the single device's; without a group it is the
    single device's computation."""
    if with_curve:
        raise NotImplementedError("the precision-recall curve waits for ROADMAP A7's remainder")
    starts = range(0, query.shape[0], query_chunk)
    per = -(-len(starts) // world_size())
    mine = starts[rank() * per:(rank() + 1) * per]

    def share():   # everything a rank allocates before the gather
        ql = torch.as_tensor(query_labels, device=query.device)
        gl = torch.as_tensor(gallery_labels, device=query.device)
        k_resolved = resolve_k(ql, gl, k, same_source, gallery_valid)
        keys = metric_keys(recall_ks, k_resolved)
        sums = torch.zeros((per, len(keys)), dtype=torch.float32, device=query.device)
        for row, start in enumerate(mine):
            sums[row] = chunk_sums(query[start:start + query_chunk],
                                   ql[start:start + query_chunk], gallery, gl, k_resolved,
                                   metric, start, same_source, recall_ks, gallery_valid)
        stats = hashing_stats(gallery, gallery_valid) if with_hashing_stats else None
        return k_resolved, keys, sums, stats

    k_resolved, keys, sums, stats = agreed(share)
    total = torch.zeros(len(keys), dtype=torch.float32)
    for row in all_gather_rows(sums)[:len(starts)].cpu():   # chunk order
        total = total + row
    return finish(means(keys, total, recall_ks), k_resolved, stats)
