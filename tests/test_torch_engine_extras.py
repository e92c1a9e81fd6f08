"""The engine extras against irw_tpu: k-fold splits, the fast-eval subset
and the DSCH protocol.

- ``get_splits``: every kind (``class_disjoint``, its alias ``open_set``,
  ``hierarchical``, ``closed_set``) on single- and multi-label labels at
  several seeds and fold counts, index for index; ``closed_set`` is
  irw_tpu's call of scikit-learn's ``StratifiedKFold``, so the port's numpy
  allocation is held to scikit-learn itself, its raise and its warning
  included.
- ``build_fast_eval_subset``: the same samples, in eval mode.
- ``EarlyStopping`` and ``dsch_alpha``: the same decisions and values.
- The DSCH recipe (``loss=dsch optimizer=resnet_dsch
  experience.dsch_train=true``) over the default composition's tiny model
  through both packages' ``run`` from the same weights: the same α per
  epoch, the same stop epoch, and the best epoch's metrics returned.
  ``tests/test_torch_kfold_runs.py`` runs ``kfold.use_kfold`` and
  ``tests/test_torch_hooks.py`` ``with_fast_eval`` and the instrumentor
  through ``run``.

Tolerances: the run metrics to 1e-5 relative (the step test's).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import json
import warnings

import numpy as np
import pytest

from irw_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from irw_tpu.engine import dsch as jax_dsch
from irw_tpu.engine import splits as jax_splits
from irw_tpu.engine.batch_map import build_fast_eval_subset as jax_fast_eval_subset
from irw_tpu_torch.data.synthetic import SyntheticDataset
from irw_tpu_torch.engine import dsch, splits
from irw_tpu_torch.engine.batch_map import build_fast_eval_subset
from test_torch_default_runs import LOCAL, _no_tensorboard, check_runs, run_both  # noqa: F401

KINDS = ["class_disjoint", "open_set", "hierarchical", "closed_set"]


def _labels(multi: bool, seed: int, n: int = 97, classes: int = 10):
    rng = np.random.RandomState(seed)
    # imbalanced classes: counts from about 3 to about 20
    ids = rng.choice(classes, n, p=np.linspace(1, 6, classes) / np.linspace(1, 6, classes).sum())
    supers = ids % 3
    if not multi:
        return ids, supers
    labels = np.zeros((n, classes), np.float32)
    labels[np.arange(n), ids] = 1.0
    labels[rng.rand(n, classes) > 0.85] = 1.0
    return labels, supers


@pytest.mark.parametrize("n_splits", [3, 4])
@pytest.mark.parametrize("seed", [0, 7, 333])
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("kind", KINDS)
def test_splits_match_jax(kind, multi, seed, n_splits):
    labels, supers = _labels(multi, seed)
    ours = splits.get_splits(labels, supers, kind=kind, n_splits=n_splits, seed=seed)
    ref = jax_splits.get_splits(labels, supers, kind=kind, n_splits=n_splits, seed=seed)
    assert len(ours) == len(ref) == n_splits
    for (tr, va), (jtr, jva) in zip(ours, ref):
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(va, jva)
    if kind == "closed_set":  # a partition of the samples
        held = np.sort(np.concatenate([va for _, va in ours]))
        np.testing.assert_array_equal(held, np.arange(len(labels)))


def test_stratified_folds_raise_and_warn_as_scikit_learn():
    from sklearn.model_selection import StratifiedKFold

    few = np.array([0, 0, 0, 1, 1, 2, 2, 2, 2])  # largest class: 4 members
    for n_splits in (5, 1, 10):
        with pytest.raises(ValueError) as ours:
            splits.closed_set_splits(few, n_splits, seed=0)
        with pytest.raises(ValueError) as ref:
            list(StratifiedKFold(n_splits, shuffle=True, random_state=0).split(few, few))
        assert str(ours.value) == str(ref.value)
    with warnings.catch_warnings(record=True) as ours:
        warnings.simplefilter("always")
        splits.closed_set_splits(few, 3, seed=0)
    with warnings.catch_warnings(record=True) as ref:
        warnings.simplefilter("always")
        list(StratifiedKFold(3, shuffle=True, random_state=0).split(few, few))
    assert [str(w.message) for w in ours] == [str(w.message) for w in ref]
    with pytest.raises(ValueError, match="unknown split kind"):
        splits.get_splits(few, kind="leave_one_out")


@pytest.mark.parametrize("kw", [{}, {"max_classes": 3, "seed": 4}, {"per_class": 2, "seed": 9},
                                {"min_per_class": 15}])
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_fast_eval_subset_matches_jax(multi, kw):
    args = dict(num_samples=120, num_classes=8, image_size=8, multi_label=multi, seed=3)
    ds, jds = SyntheticDataset(**args), JaxSyntheticDataset(**args)
    ours, ref = build_fast_eval_subset(ds, **kw), jax_fast_eval_subset(jds, **kw)
    assert ours.mode == ref.mode == "eval"
    np.testing.assert_array_equal(ours.labels, ref.labels)
    np.testing.assert_array_equal(ours.images, ref.images)


def test_early_stopping_and_alpha_match_jax():
    scores = [0.1, 0.3, 0.3, 0.2, 0.35, 0.34, 0.34, 0.1, 0.5]
    for patience in (1, 2, 3):
        for delta in (0.0, 0.02):
            ours, ref = dsch.EarlyStopping(patience, delta), jax_dsch.EarlyStopping(patience, delta)
            assert [ours.update(s) for s in scores] == [ref.update(s) for s in scores]
            assert (ours.best, ours.bad_epochs) == (ref.best, ref.bad_epochs)
    for epoch in range(60):
        for gamma, power, step in ((0.005, 0.5, 1), (1.0, 0.5, 1), (0.1, 2.0, 3)):
            assert dsch.dsch_alpha(epoch, gamma, power, step) == \
                jax_dsch.dsch_alpha(epoch, gamma, power, step)


def _records(log_dir):
    with open(log_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


SMALL = ["dataset=synthetic", "dataset.kwargs.num_samples=48", "dataset.kwargs.image_size=32",
         "dataset.sampler.kwargs.batch_size=8", "experience.eval_bs=24", "transform=dwt_small",
         "experience.step_per_epoch=2"] + LOCAL


@pytest.fixture(scope="module")
def dsch_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("dsch")
    overrides = SMALL + ["loss=dsch", "optimizer=resnet_dsch", "experience.dsch_train=true",
                         "experience.max_iter=4", "experience.train_eval_freq=1",
                         "+experience.dsch.patience=1", "+experience.dsch.alpha_gamma=0.5"]
    return root, run_both(overrides, root)


def test_dsch_recipe_runs_as_jax(dsch_run):
    """The same α each epoch (from ``experience.dsch``, not the top-level
    ``alpha_gamma``), the same stop, the best epoch's metrics returned."""
    root, (jax_metrics, metrics, _, cfg) = dsch_run
    check_runs(root, cfg, jax_metrics, metrics)
    records = _records(root / "port" / cfg.experience.experiment_name)
    alphas = [r["train/model_alpha"] for r in records if "train/model_alpha" in r]
    assert alphas == [dsch.dsch_alpha(e, 0.5, 0.5) for e in range(1, len(alphas) + 1)]
    scores = {r["step"]: r["test/map_level0"] for r in records if "test/map_level0" in r}
    best = max(scores, key=lambda e: (scores[e], -e))  # the first epoch at the best score
    assert metrics["test"]["map_level0"] == scores[best]
    # patience 1: the run stops at the first epoch that does not beat the best
    # (here epoch 2), and the metrics are the better first epoch's
    last = max(scores)
    assert last < 4 and scores[last] <= max(scores[e] for e in scores if e < last)
    assert best != last


def test_chip_smoke_engine_extras_configs():
    """``chip_smoke.py``'s engine_extras phase: its adaptive losses are
    ``configs/loss/roadmap_adaptative.yaml``, and its runs compose to the
    DSCH recipe and to the flagship with the options they drive."""
    from pathlib import Path

    import yaml

    import chip_smoke
    from irw_tpu_torch.config import compose
    from irw_tpu_torch.single_experiment_runner import CONFIG_DIR

    with open(Path(CONFIG_DIR) / "loss" / "roadmap_adaptative.yaml") as f:
        assert chip_smoke.ROADMAP_ADAPTIVE == yaml.safe_load(f)
    cfg = compose(CONFIG_DIR, "default", chip_smoke.DSCH_JOB)
    assert (cfg.model.name, cfg.loss[0]["name"], cfg.optimizer[0]["name"]) == \
        ("ResNet50Mod", "SCHLoss", "SGD")
    assert cfg.experience.dsch_train and cfg.experience.dsch.patience == 1
    for kind in chip_smoke.KFOLD_KINDS:
        cfg = compose(CONFIG_DIR, "default", chip_smoke.EXTRAS_JOB + [
            "experience.kfold.use_kfold=true", f"experience.kfold.kind={kind}"])
        assert cfg.model.name == "MultiDinoHashing" and cfg.experience.kfold.kind == kind
        assert not cfg.dataset.kwargs.multi_label
