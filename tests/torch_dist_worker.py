"""The ranks of the port's process-group tests.

``spawn_group(world, workdir, tasks)`` starts ``world`` processes (the
``spawn`` start method) that join a ``gloo`` group through a file
rendezvous under ``workdir`` (no TCP port to collide with another test
worker), run every task of ``tasks`` in order on the CPU, and write their
answers to ``workdir/rank<r>.pt``; ``handle.results()`` waits for them and
returns one dict a rank.  This module imports only the port (never JAX,
which ``tests/conftest.py`` imports), so a rank starts in a few seconds.

A task is ``(kind, kwargs)``, ``kind`` a key of ``TASKS``.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp


def spawn_group(world: int, workdir, tasks: dict):
    """Start the group; returns a handle whose ``results()`` joins it."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    context = mp.start_processes(run_rank, args=(world, workdir, tasks), nprocs=world,
                                 join=False, start_method="spawn")
    return _Group(context, world, workdir)


class _Group:
    def __init__(self, context, world, workdir):
        self.context, self.world, self.workdir = context, world, workdir

    def results(self, timeout: float = 240.0) -> list:
        """Each rank's {task name: answer}; raises if a rank failed, or, once
        ``timeout`` seconds have passed, kills the ranks still running and
        raises naming them."""
        deadline = time.monotonic() + timeout
        while not self.context.join(max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                alive = [r for r, p in enumerate(self.context.processes) if p.is_alive()]
                for p in self.context.processes:
                    if p.is_alive():
                        p.kill()
                        p.join()
                raise TimeoutError(f"ranks {alive} of {self.world} still running after "
                                   f"{timeout} s")
        return [torch.load(os.path.join(self.workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(self.world)]


def run_rank(rank: int, world: int, workdir: str, tasks: dict) -> None:
    torch.set_num_threads(1)
    from irw_tpu_torch.parallel import close_group, init_group

    init_group(backend="gloo", init_method=f"file://{workdir}/pg", world_size=world,
               rank=rank)
    out = {}
    try:
        for name, (kind, kwargs) in tasks.items():
            try:
                out[name] = TASKS[kind](**kwargs)
            except Exception as exc:  # noqa: BLE001 — the test reads the failure
                out[name] = {"error": f"{type(exc).__name__}: {exc}",
                             "traceback": traceback.format_exc()}
    finally:
        close_group()
    # what a rank imported of the reference stack: nothing
    out["reference_modules"] = sorted(m for m in sys.modules
                                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "irw_tpu"))
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


# --- tasks -------------------------------------------------------------------


def metrics_task(query, query_labels, gallery, gallery_labels, **kwargs) -> dict:
    """``sharded_retrieval_metrics`` on numpy inputs."""
    from irw_tpu_torch.parallel.eval_sharding import sharded_retrieval_metrics

    return {"metrics": sharded_retrieval_metrics(torch.from_numpy(query), query_labels,
                                                 torch.from_numpy(gallery), gallery_labels,
                                                 **kwargs)}


def build_model(name: str, kwargs: dict, weights: str):
    """The port's model ``name`` on the CPU with the state dict saved at
    ``weights``."""
    from irw_tpu_torch.models import get_model

    model = get_model(name, device="cpu", **kwargs)
    model.load_state_dict(torch.load(weights, weights_only=True))
    return model.eval()


def make_dataset(kind: str, kwargs: dict, levels: bool = False):
    """A synthetic dataset of the port; ``levels`` stacks two levels of class
    ids (the class and the class // 2)."""
    from irw_tpu_torch.data import SyntheticDataset, SyntheticVOCDataset

    ds = {"single": SyntheticDataset, "voc": SyntheticVOCDataset}[kind](**kwargs)
    if levels:
        ds.labels = np.stack([ds.labels, ds.labels // 2], axis=1)
    return ds


def make_datasets(spec):
    """``spec``: one dataset spec, or {"query", "gallery"[, "distractor"]}
    of specs (``"gallery": "query"`` for the query set itself)."""
    if "kind" in spec:
        return make_dataset(**spec)
    out = {"query": make_dataset(**spec["query"])}
    out["gallery"] = (out["query"] if spec["gallery"] == "query"
                      else make_dataset(**spec["gallery"]))
    if "distractor" in spec:
        out["distractor"] = make_dataset(**spec["distractor"])
    return out


class OutOfMemoryOnce(torch.nn.Module):
    """``model`` that raises ``torch.OutOfMemoryError`` at its ``at``-th
    call on rank ``on_rank`` (once), recording every batch size it sees."""

    def __init__(self, model, at: int, on_rank: int):
        super().__init__()
        self.model, self.at, self.on_rank = model, at, on_rank
        self.calls, self.batches, self.raised = 0, [], False

    def forward(self, x):
        from irw_tpu_torch.parallel import rank

        self.calls += 1
        self.batches.append(int(x.shape[0]))
        if not self.raised and self.calls == self.at and rank() == self.on_rank:
            self.raised = True
            raise torch.OutOfMemoryError("CUDA out of memory (raised by the test)")
        return self.model(x)


@contextlib.contextmanager
def metric_out_of_memory_once(at: int, on_rank: int):
    """``ops.metrics.average_precision`` (a chunk's scoring) raises
    ``torch.OutOfMemoryError`` at its ``at``-th call on rank ``on_rank``
    (once) while the context is open; yields the rows of every call."""
    from irw_tpu_torch.ops import metrics
    from irw_tpu_torch.parallel import rank

    plain, calls = metrics.average_precision, []

    def average_precision(rel):
        calls.append(int(rel.shape[0]))
        if len(calls) == at and rank() == on_rank:
            raise torch.OutOfMemoryError("CUDA out of memory (raised by the test)")
        return plain(rel)

    metrics.average_precision = average_precision
    try:
        yield calls
    finally:
        metrics.average_precision = plain


def first_indices(emb, metric: str, n: int = 8, k: int = 10):
    """The top-``k`` indices of the first ``n`` rows of ``emb`` among its
    rows (drop-self)."""
    from irw_tpu_torch.ops.knn import knn

    return knn(emb[:n], emb, min(k, emb.shape[0] - 1), metric, same_source=True)[0].numpy()


def evaluate_task(model: dict, datasets, ops, oom: dict | None = None,
                  oom_metric: dict | None = None, **kwargs) -> dict:
    """``engine.evaluate`` of ``build_model(**model)`` over
    ``make_datasets(datasets)`` with the device ops ``ops``; with ``oom``
    (``at``, ``on_rank``) the model runs out of memory once, with
    ``oom_metric`` the scoring does.  Also the first queries' top-k indices
    over the query set's embeddings as the eval gathered them."""
    from irw_tpu_torch.transforms import DeviceTransform

    net = build_model(**model)
    if oom is not None:
        net = OutOfMemoryOnce(net, **oom)
    transform = DeviceTransform(ops, device="cpu")
    data = make_datasets(datasets)
    module = importlib.import_module("irw_tpu_torch.engine.evaluate")
    swept, embed = [], module.compute_embeddings

    def kept(*args, **kw):
        out = embed(*args, **kw)
        swept.append(out[0])
        return out

    module.compute_embeddings = kept
    try:
        with (metric_out_of_memory_once(**oom_metric) if oom_metric is not None
              else contextlib.nullcontext()) as calls:
            metrics = module.evaluate(net, data, transform, device="cpu",
                                               num_workers=0, **kwargs)
    finally:
        module.compute_embeddings = embed
    per_pass = 1 if "kind" in datasets else (
        1 + (datasets["gallery"] != "query") + ("distractor" in datasets))
    out = {"metrics": metrics,   # the query set's embeddings of the last pass
           "first": first_indices(swept[-per_pass], kwargs.get("distance_metric", "cosine"))}
    if oom is not None:
        out["batches"] = net.batches
    if oom_metric is not None:
        out["metric_calls"] = calls
    return out


def suite_task(query, query_labels, gallery, gallery_labels, cfg: dict) -> dict:
    """``engine.evaluate._metric_suite`` on numpy embeddings."""
    from irw_tpu_torch.engine.evaluate import _metric_suite

    return _metric_suite(torch.from_numpy(query), query_labels, torch.from_numpy(gallery),
                         gallery_labels, cfg)


def training_task() -> dict:
    """What training raises under the group: ``build_train_step`` and ``run``."""
    from irw_tpu_torch.engine import build_train_step
    from irw_tpu_torch.run import run

    out = {}
    for name, call in (("build_train_step", lambda: build_train_step()),
                       ("run", lambda: run({"experience": {}}))):
        try:
            call()
            out[name] = None
        except NotImplementedError as exc:
            out[name] = str(exc)
    return out


def replicate_task(seed: int) -> dict:
    """A module drawn from ``seed + rank`` after ``replicate``: rank 0's
    parameters and buffers on every rank."""
    from irw_tpu_torch.parallel import rank, replicate

    torch.manual_seed(seed + rank())
    net = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    net[1].running_mean.normal_()
    net[1].num_batches_tracked.fill_(rank() + 5)
    replicate(net)
    return {k: v.clone() for k, v in net.state_dict().items()}


TASKS = {"metrics": metrics_task, "evaluate": evaluate_task, "suite": suite_task,
         "training": training_task, "replicate": replicate_task}
