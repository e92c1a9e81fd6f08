"""The study scripts read the port's run directories as they read the JAX
package's: ``studies/aggregate_results.py`` (``read_last_metrics``,
``collect_runs``, ``aggregate``), ``studies/paired_analysis.py``
(``read_last``, ``collect``) and ``studies/snapshot_results.py``
(``read_series``), none of them edited, over both packages' run of
``studies/smoke_plan.yaml``'s first job from the same weights
(``test_torch_default_runs.run_both``: the default composition at 64²,
one epoch of two steps and its eval, seed 1).  The flagship job of
``tests/test_torch_runner.py`` reads alike but its JAX run alone takes
most of a test file's time.

Shared keys are equal (the metrics to 1e-5 relative, the step test's
tolerance); the port-only timing keys (``train/train_seconds``,
``*/eval_seconds``) are the only extra keys.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import sys
from pathlib import Path

import pytest

from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
# _no_tensorboard: the autouse fixture that keeps TensorFlow from importing
from test_torch_default_runs import LOCAL, _no_tensorboard, run_both  # noqa: F401
from test_torch_runner import PORT_ONLY
from test_torch_smoke_plan import _smoke_jobs
from test_torch_train_step import METRIC_TOL

sys.path.insert(0, str(Path(CONFIG_DIR).parent / "studies"))
import aggregate_results  # noqa: E402
import paired_analysis  # noqa: E402
import snapshot_results  # noqa: E402

STUDY = "smoke"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' run of the job under ``<root>/jax`` and ``<root>/port``;
    (root, the job's run name)."""
    root = tmp_path_factory.mktemp("study_readers")
    name, overrides = _smoke_jobs()[0]
    run_both([o for o in overrides if not o.startswith("experience.log_dir=")] + LOCAL, root)
    return root, name


def _same(ours: dict, ref: dict):
    """The JAX run's keys and the port-only timing keys; shared values equal."""
    assert set(ours) - set(ref) <= PORT_ONLY and set(ref) <= set(ours)
    assert set(ours) - set(ref), "the port logs its timing keys"
    for key, value in ref.items():
        if key.endswith("seconds"):
            continue
        if isinstance(value, float):
            assert ours[key] == pytest.approx(value, rel=METRIC_TOL, abs=1e-7), key
        else:
            assert ours[key] == value, key


def test_last_metrics_read_alike(runs):
    runs, name = runs
    for read in (aggregate_results.read_last_metrics, paired_analysis.read_last):
        ours, ref = read(str(runs / "port" / name)), read(str(runs / "jax" / name))
        assert "test/map_level0" in ref and ref["step"] == 1
        _same(ours, ref)


def test_collect_and_aggregate_read_alike(runs):
    runs, name = runs
    ours = aggregate_results.collect_runs(str(runs / "port"), STUDY)
    ref = aggregate_results.collect_runs(str(runs / "jax"), STUDY)
    assert [Path(d).name for d, _ in ours] == [Path(d).name for d, _ in ref] == [name]
    _same(ours[0][1], ref[0][1])
    key = "test/map_level0"
    agg, agg_ref = (aggregate_results.aggregate(r, key) for r in (ours, ref))
    assert list(agg) == list(agg_ref) == ["smoke"]
    for (mean, std, n), (mean_ref, std_ref, n_ref) in zip(agg.values(), agg_ref.values()):
        assert (std, n) == (std_ref, n_ref) == (0.0, 1)
        assert mean == pytest.approx(mean_ref, rel=METRIC_TOL)


def test_paired_collect_reads_alike(runs):
    runs, _ = runs
    ours = paired_analysis.collect(str(runs / "port"), STUDY, "seed")
    ref = paired_analysis.collect(str(runs / "jax"), STUDY, "seed")
    assert list(ours) == list(ref) == [(0.0, 1.0, 1)]
    _same(ours[(0.0, 1.0, 1)], ref[(0.0, 1.0, 1)])


def test_snapshot_series_read_alike(runs):
    runs, name = runs
    ours = snapshot_results.read_series(str(runs / "port" / name))
    ref = snapshot_results.read_series(str(runs / "jax" / name))
    assert set(ours) - set(ref) <= PORT_ONLY and set(ref) <= set(ours)
    for key, points in ref.items():
        assert [s for s, _ in ours[key]] == [s for s, _ in points], key
        if not key.endswith("seconds"):
            for (_, value), (_, ref_value) in zip(ours[key], points):
                assert value == pytest.approx(ref_value, rel=METRIC_TOL, abs=1e-7), key
