"""``with_fast_eval`` and the fixed-batch instrumentor
(``hooks_configs.active``) through both packages' ``run`` from the same
weights: the default composition's tiny model, two epochs with the test
eval at the second only and the dumps at epochs 1 and 2.  ``fast_eval/`` is
logged at epoch 1 as JAX logs it, and both epochs' dumps and the fixed
batch equal JAX's (the same keys, the values within 1e-4 of each entry's
largest).  Tolerances of the run metrics: 1e-5 relative (the step test's).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import json

import pytest

from test_torch_default_runs import _no_tensorboard, check_runs, run_both  # noqa: F401
from test_torch_engine_extras import SMALL
from test_torch_hooks import _same_files


@pytest.fixture(scope="module")
def extras_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("extras")
    overrides = SMALL + ["experience.with_fast_eval=true", "experience.max_iter=2",
                         "experience.train_eval_freq=2", "experience.test_eval_freq=2",
                         "experience.hooks_configs.active=true",
                         "experience.hooks_configs.target_epochs=[1, 2]"]
    return root, run_both(overrides, root)


def test_fast_eval_and_hooks_run_as_jax(extras_run):
    root, (jax_metrics, metrics, _, cfg) = extras_run
    check_runs(root, cfg, jax_metrics, metrics)
    name = cfg.experience.experiment_name
    with open(root / "port" / name / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records if any(k.startswith("fast_eval/") for k in r)] == [1]
    for epoch in (1, 2):
        file = f"analysis_epoch_{epoch}.npz"
        keys = _same_files(root / "port" / name / "instrumentation" / file,
                           root / "jax" / name / "instrumentation" / file)
        assert any(k.startswith("feat/HashHead_0/") for k in keys)
    _same_files(root / "port" / name / "instrumentation" / "fixed_batch.npz",
                root / "jax" / name / "instrumentation" / "fixed_batch.npz")
