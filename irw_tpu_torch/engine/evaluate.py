"""Retrieval evaluation (port of ``irw_tpu/engine/evaluate.py:26-82,
85-150, 153-274``), on one device or over a process group.

``compute_embeddings`` runs the eval-mode forward over a dataset in
batches, walking it in order through ``EpochLoader(train=False)`` (the host
stage with its eval ops, or the stored images with ``host_transform=None``),
padding the tail batch to keep one shape.  ``evaluate`` ranks and scores the
embeddings with ``ops.metrics.compute_retrieval_metrics``; a query set that
carries ``gnd`` (revisited Oxford/Paris) is scored by
``engine.landmark.landmark_evaluation`` instead, and a ``distractor``
dataset joins the gallery with labels no query matches.  A card that runs
out of memory gets one retry at half the batch (at least 32) and a query
chunk of 256.

Under a process group of more than one rank (``parallel.init_group``), as
the JAX package shards over its ``data`` mesh (:42-52, :112-140): each rank
embeds its block of every global batch (``parallel.local_rows``; the batch
size must divide by the ranks, else every rank embeds the whole set, with
JAX's warning), and one gather puts the embeddings in order on every rank.
Each label level is scored by ``parallel.eval_sharding``'s
``sharded_retrieval_metrics`` (the query chunks split over the ranks, the
single device's answer bit for bit) unless ``force_single_device`` is set.
The landmark protocol and the distractor concat run on the gathered
embeddings, alike on every rank.  Whatever a rank allocates on the card
between two collectives runs inside one ``parallel.agreed`` step (its whole
embedding sweep, its share of the scoring), so when one rank runs out of
memory every rank retries, or none does; only rank 0 logs.
"""

from __future__ import annotations

import functools
import logging

import numpy as np
import torch

from irw_tpu_torch.data.loader import EpochLoader
from irw_tpu_torch.device import resolve_device
from irw_tpu_torch.ops.metrics import compute_retrieval_metrics
from irw_tpu_torch.parallel.eval_sharding import sharded_retrieval_metrics
from irw_tpu_torch.parallel.mesh import (
    agreed,
    all_gather_rows,
    local_rows,
    pad_to_multiple,
    rank,
    world_size,
)

LOGGER = logging.getLogger(__name__)
DISTRACTOR_LABEL = -424242  # a class id no query holds


def _warn(msg: str) -> None:
    if rank() == 0:
        LOGGER.warning(msg)


def compute_embeddings(model, dataset, device_transform=None, batch_size: int = 256,
                       device=None, host_transform=None, num_workers: int = 8):
    """Embed ``dataset`` with ``model`` in eval mode.  Returns (embeddings on
    ``device``, labels as numpy); under a group, every rank's are the whole
    set's."""
    device = resolve_device(device)
    world = world_size()
    if world > 1 and batch_size % world:
        _warn(f"eval batch_size {batch_size} not divisible by the {world}-rank group — "
              "falling back to single-device embedding sweep (pick eval_bs as a multiple "
              "of the ranks to scale it)")
    split = world > 1 and batch_size % world == 0
    per = batch_size // world if split else batch_size
    rows = local_rows(batch_size, rank(), world) if split else slice(0, batch_size)
    order = np.arange(len(dataset))
    batches = [order[i:i + batch_size] for i in range(0, len(order), batch_size)]
    # each rank reads its block of every batch; a block past the tail reads
    # the batch's first row in its place (its embedding is dropped)
    batches = [b[rows] if len(b[rows]) else b[:1] for b in batches]
    loader = EpochLoader(dataset, batches, host_transform, num_workers=num_workers, train=False)

    def embed(images):
        if device_transform is not None:
            x = device_transform(images)
        else:
            x = torch.from_numpy(images).to(device).float() / 255.0
        out = model(x)
        return out[0] if isinstance(out, tuple) else out

    def sweep():
        with torch.inference_mode():
            # the tail padded to keep one batch shape (:72-74)
            return torch.cat([embed(pad_to_multiple(batch["image"], per)[0])
                              for batch in loader])

    emb = agreed(sweep)
    if split:   # every rank's blocks, (world, batches, per) rows → the batches' order
        emb = agreed(lambda t: t.unflatten(0, (world, len(batches), per)).transpose(0, 1)
                     .flatten(0, 2), all_gather_rows(emb))
    return emb[:len(dataset)], dataset.labels


def _looks_multilabel(labels: np.ndarray) -> bool:
    """Float labels, or {0, 1} labels of any dtype, are multi-label
    indicator vectors; anything else 2-D is a multi-level class hierarchy."""
    if labels.dtype.kind == "f":
        return True
    u = np.unique(labels)
    return u.size <= 2 and bool(np.isin(u, (0, 1)).all())


def _metric_suite(query_emb, query_labels, gallery_emb, gallery_labels, cfg):
    """The metric suite per label level (metrics suffixed ``_levelL``); the
    query chunks split over a group of more than one rank unless
    ``cfg["force_single_device"]``."""
    ql, gl = np.asarray(query_labels), np.asarray(gallery_labels)
    multi_level = ql.ndim == 2 and not cfg.get("multi_label", _looks_multilabel(ql))
    levels = ql.shape[1] if multi_level else 1
    if world_size() > 1 and not cfg.get("force_single_device"):
        metrics = sharded_retrieval_metrics
    else:   # one device's suite (agreed on, under a group)
        metrics = functools.partial(agreed, compute_retrieval_metrics)
    out = {}
    for level in range(levels):
        q = ql[:, level] if multi_level else ql
        g = gl[:, level] if multi_level else gl
        res = metrics(
            query_emb, q, gallery_emb, g, metric=cfg["distance_metric"],
            k=cfg["top_k"], same_source=cfg["same_source"],
            with_hashing_stats=cfg["distance_metric"] == "hamming",
            query_chunk=cfg["query_chunk"])
        out.update({f"{name}_level{level}": value for name, value in res.items()})
    return out


def evaluate(model, datasets, device_transform=None, batch_size: int = 256, top_k=None,
             distance_metric: str = "cosine", multi_label: bool | None = None,
             query_chunk: int = 512, device=None, host_transform=None,
             num_workers: int = 8) -> dict:
    """Evaluate retrieval quality; returns a flat dict of metrics.

    ``datasets`` is one dataset (self-retrieval, drop-self) or
    ``{"query": ds, "gallery": ds}``, with an optional ``"distractor"``
    dataset.  ``device=None`` means the card: the model (and the transform)
    must live there.  Out of memory on the card, it retries once at
    ``max(batch_size // 2, 32)`` and a query chunk of 256; a second
    out-of-memory error propagates.  Under a group every rank calls it with
    the same arguments and gets the same dict.
    """
    device = resolve_device(device)
    args = (model, datasets, device_transform, top_k, distance_metric, multi_label, device,
            host_transform, num_workers)
    try:
        return _evaluate_once(*args, batch_size=batch_size, query_chunk=query_chunk)
    except torch.cuda.OutOfMemoryError:
        pass  # retried outside the handler: its traceback holds the failed pass's tensors
    small = max(batch_size // 2, 32)
    _warn(f"eval out of memory at batch {batch_size}; retrying once at batch {small} "
          "/ query_chunk 256")
    return _evaluate_once(*args, batch_size=small, query_chunk=256)


def _evaluate_once(model, datasets, device_transform, top_k, distance_metric, multi_label,
                   device, host_transform, num_workers, batch_size, query_chunk) -> dict:
    cfg = {"top_k": top_k, "distance_metric": distance_metric, "query_chunk": query_chunk}
    if multi_label is not None:
        cfg["multi_label"] = multi_label

    def embed(dataset):
        return compute_embeddings(model, dataset, device_transform, batch_size, device,
                                  host_transform, num_workers)

    if not isinstance(datasets, dict):
        emb, labels = embed(datasets)
        cfg["same_source"] = True
        return _metric_suite(emb, labels, emb, labels, cfg)
    q_emb, q_labels = embed(datasets["query"])
    if datasets["gallery"] is datasets["query"]:
        g_emb, g_labels = q_emb, q_labels
    else:
        g_emb, g_labels = embed(datasets["gallery"])
    if "distractor" in datasets:
        d_emb, _ = embed(datasets["distractor"])
        g_emb = agreed(torch.cat, [g_emb, d_emb])
        gl = np.asarray(g_labels)
        if gl.ndim == 1:
            d_labels = np.full(d_emb.shape[0], DISTRACTOR_LABEL, gl.dtype)
        elif cfg.get("multi_label", _looks_multilabel(gl)):
            # all-zero indicator rows: relevant to no query
            d_labels = np.zeros((d_emb.shape[0], gl.shape[1]), gl.dtype)
        else:  # class ids per level: 0 is a class, so an impossible id
            d_labels = np.full((d_emb.shape[0], gl.shape[1]), DISTRACTOR_LABEL, gl.dtype)
        g_labels = np.concatenate([gl, d_labels])
    gnd = getattr(datasets["query"], "gnd", None)
    if gnd is not None:
        from irw_tpu_torch.engine.landmark import landmark_evaluation

        return agreed(landmark_evaluation, q_emb, g_emb, gnd, device=device)
    # one dataset wrapped as query and gallery (a distractor split): drop-self
    cfg["same_source"] = datasets["query"] is datasets["gallery"]
    return _metric_suite(q_emb, q_labels, g_emb, g_labels, cfg)
