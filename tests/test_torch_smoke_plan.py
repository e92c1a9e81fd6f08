"""``studies/smoke_plan.yaml`` through both packages' ``run``, on synthetic
data (ROADMAP A10c1).

The plan's two jobs (the default composition with ``transform=dwt_small``:
64² images, 32² bands; one epoch of two steps; seeds 1 and 2) run as the
plan says, with the log directory in the test's own, the JAX mesh off and
the loaders in the main thread; both packages train from the same weights
(``test_torch_default_runs.run_both``).

Tolerances: the train and eval metrics to 1e-5 relative (the step test's).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
from pathlib import Path

import pytest

from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
from irw_tpu_torch.studies import run_plan
# _no_tensorboard: the autouse fixture that keeps TensorFlow from importing
from test_torch_default_runs import LOCAL, _no_tensorboard, check_runs, run_both  # noqa: F401

SMOKE = Path(CONFIG_DIR).parent / "studies" / "smoke_plan.yaml"


def _smoke_jobs():
    plan = run_plan.load_plan(str(SMOKE))
    return run_plan.expand_jobs(plan)


@pytest.mark.parametrize("job", [0, 1], ids=["seed_1", "seed_2"])
def test_smoke_plan_job_runs_as_jax(job, tmp_path):
    jobs = _smoke_jobs()
    assert len(jobs) == 2
    name, overrides = jobs[job]
    assert f"experience.seed={job + 1}" in overrides and "transform=dwt_small" in overrides
    overrides = [o for o in overrides if not o.startswith("experience.log_dir=")] + LOCAL
    jax_metrics, metrics, _, cfg = run_both(overrides, tmp_path)
    assert cfg.experience.seed == job + 1 and cfg.model.name == "single_band_net"
    check_runs(tmp_path, cfg, jax_metrics, metrics)
