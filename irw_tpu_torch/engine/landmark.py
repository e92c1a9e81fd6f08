"""Revisited Oxford/Paris landmark evaluation (port of
``irw_tpu/engine/landmark.py``): the junk-corrected trapezoid mAP of the
revisitop protocols.

- medium: positives = easy ∪ hard, junk = junk;
- hard:   positives = hard,        junk = junk ∪ easy.

``landmark_evaluation`` scores every query at once with one batched torch
function on the device it is given (the card unless ``device="cpu"``):
L2 norms floored at 1e-12, the query × gallery cosine in full f32 whatever
the TF32 flag (one flipped pair of ranks moves an AP), a stable argsort of
the negated similarities (``jnp.argsort``'s order of ties), the junk
correction by a running count, and the trapezoid terms as int ÷ int in f32,
as jnp computes them.  ``compute_ap`` and ``_ap_for_query`` are the scalar
oracles.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from irw_tpu_torch.device import resolve_device


def compute_ap(ranks: np.ndarray, nres: int) -> float:
    """Average precision from the sorted 0-based ranks of the positives
    among the ranked gallery with junk removed: the revisitop trapezoid,
    with precision 1 before the first item at rank 0."""
    if nres == 0:
        return 0.0
    ap = 0.0
    recall_step = 1.0 / nres
    for j, rank in enumerate(ranks):
        precision_0 = 1.0 if rank == 0 else j / rank
        precision_1 = (j + 1) / (rank + 1)
        ap += (precision_0 + precision_1) * recall_step / 2.0
    return ap


def _ap_for_query(order: np.ndarray, positives: set, junk: set):
    """The AP of one query from its gallery ``order``: a positive's rank
    less the junk ranked above it."""
    ranks = []
    junk_seen = 0
    for rank, idx in enumerate(order):
        if idx in junk:
            junk_seen += 1
            continue
        if idx in positives:
            ranks.append(rank - junk_seen)
    return compute_ap(np.asarray(ranks), len(positives))


def _masks_from_gnd(gnd, num_gallery: int, protocol: str):
    """(Q, G) positive and junk boolean masks for a revisitop protocol."""
    nq = len(gnd)
    pos = np.zeros((nq, num_gallery), bool)
    junk = np.zeros((nq, num_gallery), bool)
    for qi, entry in enumerate(gnd):
        easy = np.atleast_1d(np.asarray(entry.get("easy", []), dtype=np.int64))
        hard = np.atleast_1d(np.asarray(entry.get("hard", []), dtype=np.int64))
        jnk = np.atleast_1d(np.asarray(entry.get("junk", []), dtype=np.int64))
        if protocol == "medium":
            pos[qi, easy] = True
            pos[qi, hard] = True
            junk[qi, jnk] = True
        else:  # hard
            pos[qi, hard] = True
            junk[qi, jnk] = True
            junk[qi, easy] = True
    return pos, junk


@contextlib.contextmanager
def _full_f32_matmul():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def batched_junk_corrected_map(query: torch.Tensor, gallery: torch.Tensor,
                               pos_mask: torch.Tensor, junk_mask: torch.Tensor) -> torch.Tensor:
    """The mean over queries with positives of the junk-corrected trapezoid
    AP, as a 0-d f32 tensor (port of ``_batched_junk_corrected_map``,
    ``irw_tpu/engine/landmark.py:72-102``)."""
    q = query / torch.linalg.vector_norm(query, dim=1, keepdim=True).clamp_min(1e-12)
    gal = gallery / torch.linalg.vector_norm(gallery, dim=1, keepdim=True).clamp_min(1e-12)
    with _full_f32_matmul():
        sims = q @ gal.T
    orders = torch.argsort(-sims, dim=1, stable=True)
    junk_r = torch.take_along_dim(junk_mask, orders, dim=1)
    pos_r = torch.take_along_dim(pos_mask, orders, dim=1) & ~junk_r
    junk_r = junk_r.to(torch.int32)
    # corrected rank: the position less the junk ranked above it
    junk_before = torch.cumsum(junk_r, dim=1, dtype=torch.int32) - junk_r
    rank = torch.arange(sims.shape[1], dtype=torch.int32, device=sims.device)[None] - junk_before
    j = torch.cumsum(pos_r, dim=1, dtype=torch.int32) - 1  # the index among the positives
    prec0 = torch.where(rank == 0, 1.0, j.float() / rank.clamp_min(1).float())
    prec1 = (j + 1).float() / (rank + 1).float()
    terms = torch.where(pos_r, (prec0 + prec1) / 2.0, 0.0)
    npos = pos_mask.sum(dim=1, dtype=torch.int32)
    ap = terms.sum(dim=1) / npos.clamp_min(1).float()
    valid = npos > 0
    return torch.where(valid, ap, 0.0).sum() / valid.sum(dtype=torch.int32).clamp_min(1).float()


def landmark_evaluation(query_emb, gallery_emb, gnd, protocols=("medium", "hard"),
                        device=None) -> dict:
    """``{"map_<protocol>": mAP}`` for one city.  ``gnd``: per query
    ``{"easy": [...], "hard": [...], "junk": [...]}``
    (``RevisitedDataset.gnd``); the embeddings (numpy or tensors) are moved
    to ``device`` (None: the card) in f32."""
    device = resolve_device(device)
    q = torch.as_tensor(query_emb, device=device).float()
    g = torch.as_tensor(gallery_emb, device=device).float()
    out = {}
    for protocol in protocols:
        pos, junk = _masks_from_gnd(gnd, int(g.shape[0]), protocol)
        out[f"map_{protocol}"] = float(batched_junk_corrected_map(
            q, g, torch.from_numpy(pos).to(device), torch.from_numpy(junk).to(device)))
    return out


def evaluate_cities(model, data_dir, cities=("roxford5k", "rparis6k"), device_transform=None,
                    batch_size: int = 128, device=None, host_transform=None,
                    num_workers: int = 8) -> dict:
    """The revisited protocol over ``cities``: each city's queries and
    gallery embedded with ``model``, ``{"<city>_map_medium", ...}``."""
    from irw_tpu_torch.data.landmarks import RevisitedDataset
    from irw_tpu_torch.engine.evaluate import compute_embeddings

    device = resolve_device(device)
    results = {}
    for city in cities:
        query_ds = RevisitedDataset(data_dir, city=city, mode="query")
        gallery_ds = RevisitedDataset(data_dir, city=city, mode="gallery")
        q_emb, _ = compute_embeddings(model, query_ds, device_transform, batch_size, device,
                                      host_transform, num_workers)
        g_emb, _ = compute_embeddings(model, gallery_ds, device_transform, batch_size, device,
                                      host_transform, num_workers)
        for key, value in landmark_evaluation(q_emb, g_emb, query_ds.gnd,
                                              device=device).items():
            results[f"{city}_{key}"] = value
    return results
