"""``experience.kfold.use_kfold`` through ``run``, over the default
composition's tiny model on single-label synthetic data (its super-labels
are the class modulo 4): the held-out fold is the ``val`` eval split
(evaluated with ``val_eval_freq`` 1: the experience's default of -1 leaves
it out) and the rest the training set.

``closed_set`` runs through both packages' ``run`` from the same weights
(the run metrics to 1e-5 relative, the step test's); every kind runs
through the port's ``run``, whose ``val`` split holds the samples of
``get_splits``'s held-out fold (held to irw_tpu's folds in
``tests/test_torch_engine_extras.py``).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import json

import numpy as np
import pytest

from irw_tpu_torch import run as port_run
from irw_tpu_torch.config import compose
from irw_tpu_torch.data.synthetic import SyntheticDataset
from irw_tpu_torch.engine.splits import get_splits
from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
from test_torch_default_runs import _no_tensorboard, check_runs, run_both  # noqa: F401
from test_torch_engine_extras import SMALL

KFOLD = SMALL + ["dataset.kwargs.multi_label=false", "experience.kfold.use_kfold=true",
                 "experience.kfold.n_splits=3", "experience.kfold.fold=1",
                 "experience.max_iter=1", "experience.val_eval_freq=1"]


def _records(log_dir):
    with open(log_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_closed_set_kfold_run_matches_jax(tmp_path):
    jax_metrics, metrics, _, cfg = run_both(KFOLD + ["experience.kfold.kind=closed_set"],
                                            tmp_path)
    check_runs(tmp_path, cfg, jax_metrics, metrics)
    assert {"val", "test"} <= set(metrics)


@pytest.mark.parametrize("kind", ["class_disjoint", "hierarchical", "closed_set"])
def test_kfold_run_evaluates_the_held_out_fold(kind, tmp_path, monkeypatch):
    cfg = compose(CONFIG_DIR, "default", KFOLD + [f"experience.kfold.kind={kind}",
                                                  f"experience.log_dir={tmp_path}"])
    seen = {}
    train = port_run.engine_train

    def spy(state, train_ds, sampler, eval_datasets, *args, **kwargs):
        seen.update(train=train_ds, val=eval_datasets["val"])
        return train(state, train_ds, sampler, eval_datasets, *args, **kwargs)

    monkeypatch.setattr(port_run, "engine_train", spy)
    metrics = port_run.run(cfg, device="cpu")
    full = SyntheticDataset(**dict(cfg.dataset.kwargs))
    tr, va = get_splits(full.labels, full.super_labels, kind=kind, n_splits=3,
                        seed=int(cfg.experience.seed))[1]
    np.testing.assert_array_equal(seen["val"].labels, full.labels[va])
    np.testing.assert_array_equal(seen["train"].images, full.images[tr])
    assert seen["val"].mode == "eval" and len(va) and len(tr)
    assert "map_level0" in metrics["val"]
    assert any("val/map_level0" in r for r in _records(tmp_path / cfg.experience.experiment_name))
