"""Construction root (port of ``run.py:28-214``): from a composed config to
a trained, resumable run on one device.

``run(config)`` builds the transforms, datasets, sampler, model, losses,
optimizers and XBM memory through ``Getter``, initialises the train state,
resumes it from the run's rolling checkpoint (``experience.resume`` or
``maybe_resume``) or rotates a stale ``metrics.jsonl`` aside, and hands it
to ``engine.train``.  ``device=None`` means the card.

The config's ``model.freeze_batch_norm`` and ``model.freeze_pos_embedding``
join the model's frozen collections in the freezing set no optimizer holds
(``run.py:113-130``).  With ``experience.kfold.use_kfold`` the training set
is split by ``engine.splits.get_splits`` (``kind``, ``n_splits``, the run's
seed): the held-out ``fold`` becomes the ``val`` eval split and the rest the
training set (``run.py:66-80``).  ``experience.hooks_configs.active``
attaches a ``hooks.FixedBatchInstrumentor`` writing to
``<log_dir>/instrumentation`` at ``target_epochs``; ``experience.dsch_train``
trains by ``engine.dsch.train_dsch`` instead of ``engine.train`` and
returns the best epoch's metrics (``run.py:175-197``).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from irw_tpu_torch.config import Config
from irw_tpu_torch.data.base import subset
from irw_tpu_torch.engine.checkpoint import maybe_resume, rotate_stale_metrics
from irw_tpu_torch.engine.dsch import train_dsch
from irw_tpu_torch.engine.splits import get_splits
from irw_tpu_torch.engine.train import train as engine_train
from irw_tpu_torch.engine.train_state import init_train_state
from irw_tpu_torch.getter import Getter
from irw_tpu_torch.hooks import FixedBatchInstrumentor
from irw_tpu_torch.utils.freezing import config_freeze_set

LOGGER = logging.getLogger(__name__)


def log_dir_of(exp) -> str:
    return os.path.join(os.path.expanduser(exp.get("log_dir", "experiments")),
                        str(exp.get("experiment_name", "default")))


def first_sampler(getter, config, train_ds, seed: int):
    """The run's sampler (``dataset.sampler``) at epoch 0."""
    sampler_cfg = config.dataset.get("sampler",
                                     {"name": "RandomSampler", "kwargs": {"batch_size": 32}})
    sampler = getter.get_sampler(train_ds, sampler_cfg)
    sampler.seed = seed
    sampler.reshuffle(0)
    return sampler


def first_sample(sampler, train_ds, host_train, device_train, seed: int) -> torch.Tensor:
    """The first batch through the train stages: its size fixes the ViTs'
    token count, as the JAX init reads it from a sample batch."""
    first = sampler.batches[0]
    images = host_train.batch([train_ds.load_image(int(i)) for i in first],
                              np.random.RandomState(seed), True)
    with torch.inference_mode():
        return device_train(images)


def run(config, device=None) -> dict:
    """Train the run ``config`` describes; returns the last eval's metrics
    by split."""
    if not isinstance(config, Config):
        config = Config(config)
    exp = config.experience
    log_dir = log_dir_of(exp)
    os.makedirs(log_dir, exist_ok=True)
    seed = int(exp.get("seed", 333))

    getter = Getter()
    (host_train, device_train), _ = getter.get_transform(config.get("transform", {}), device)
    train_ds, eval_datasets = getter.get_dataset(config.dataset)

    # dataset.num_classes: null → infer it from the built dataset and carry it
    # into the losses' class counts
    if config.dataset.get("num_classes") is None:
        labels = train_ds.labels
        inferred = int(labels.shape[1]) if labels.ndim > 1 else int(labels.max()) + 1
        config.dataset["num_classes"] = inferred
        for entry in config.get("loss") or []:
            kwargs = entry.get("kwargs")
            if kwargs and kwargs.get("num_classes") not in (None, inferred):
                LOGGER.info(f"loss {entry.get('name')}: num_classes {kwargs['num_classes']} "
                            f"-> {inferred} (inferred from dataset)")
                kwargs["num_classes"] = inferred

    kfold = exp.get("kfold") or {}
    if kfold.get("use_kfold"):
        folds = get_splits(train_ds.labels, train_ds.super_labels,
                           kind=kfold.get("kind", "class_disjoint"),
                           n_splits=int(kfold.get("n_splits", 4)), seed=seed)
        train_idx, val_idx = folds[int(kfold.get("fold", 0))]
        eval_datasets = dict(eval_datasets, val=subset(train_ds, val_idx, mode="eval"))
        train_ds = subset(train_ds, train_idx, mode="train")

    sampler = first_sampler(getter, config, train_ds, seed)
    sample = first_sample(sampler, train_ds, host_train, device_train, seed)
    model = getter.get_model(config.model, device, seed, image_size=tuple(sample.shape[-3:-1]))
    loss_config = config.get("loss", [])
    losses = getter.get_loss(loss_config)

    xbm = None
    memory_cfg = config.get("memory")
    if memory_cfg:
        # the memory's embedding size from one eval-mode forward of that batch
        with torch.inference_mode():
            out = model(sample)
        emb = out[0] if isinstance(out, tuple) else out
        label_shape = train_ds.labels.shape[1:] if train_ds.labels.ndim > 1 else ()
        xbm = getter.get_memory(memory_cfg, int(emb.shape[-1]), label_shape)

    optimizer_cfg = config.get("optimizer", [{"name": "AdamW", "params": None,
                                              "kwargs": {"lr": 1e-4}}])
    state = init_train_state(model, losses, optimizer_cfg, loss_config, seed=seed, xbm=xbm,
                             frozen_collections=config_freeze_set(model, config.model))
    if exp.get("resume") or exp.get("maybe_resume"):
        maybe_resume(state, log_dir)
    else:
        rotate_stale_metrics(log_dir)

    instrumentor = None
    hooks_cfg = exp.get("hooks_configs") or {}
    if hooks_cfg.get("active"):
        instrumentor = FixedBatchInstrumentor(
            model, os.path.join(log_dir, "instrumentation"),
            target_epochs=tuple(hooks_cfg.get("target_epochs", (1, 5, 10, 25, 40, 50))))

    # the JAX loop is given the train host stage for its evals too
    if exp.get("dsch_train"):
        _, metrics = train_dsch(state, train_ds, sampler, eval_datasets, host_train, device_train,
                                config.to_dict(), log_dir)
        return metrics
    _, metrics = engine_train(state, train_ds, sampler, eval_datasets, host_train, device_train,
                              config.to_dict(), log_dir, instrumentor=instrumentor)
    return metrics
