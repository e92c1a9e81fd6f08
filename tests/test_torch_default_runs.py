"""The repo's default composition through both packages' ``run``, on
synthetic data (ROADMAP A10c1).

``configs/default.yaml`` names ``model=single_band_tiny`` (``SingleBandNet``
over band 0 of a vit_tiny, 64 bits, unfrozen) and ``transform=dwt`` (a
224² crop, a haar level-1 lifting DWT: 112² bands).  It runs with no
``model=`` override, cut to 64 images, one epoch of two steps of 32 and an
eval of those 64 against themselves in batches of 32.
``tests/test_torch_smoke_plan.py`` runs ``studies/smoke_plan.yaml`` so.  Both packages train from
the same weights: the JAX ``init_train_state``'s, biases, norms and
LayerScale redrawn (``test_torch_vit.randomize``), bridged into the port, as
``tests/test_torch_runner.py`` runs the flagship study.  The port sizes the
ViT's position embeddings from the first batch, as the JAX init does.  The
JAX mesh is off and the loaders run in the main thread in both.

Tolerances: the train metrics to 1e-5 relative (the step test's), the eval
metrics to 1e-5 relative (the codes agree).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import json
import sys

import jax
import jax.numpy as jnp
import pytest

import run as jax_run
from irw_tpu.config import compose as jax_compose
from irw_tpu_torch import run as port_run
from irw_tpu_torch.bridge import load_jax_loss_params, load_jax_variables
from irw_tpu_torch.config import compose
from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
from test_torch_runner import PORT_ONLY
from test_torch_train_step import METRIC_TOL
from test_torch_vit import randomize

LOCAL = ["experience.num_workers=0", "experience.use_mesh=false"]


@pytest.fixture(scope="module", autouse=True)
def _no_tensorboard():
    """TensorBoard imports TensorFlow, which takes longer than a test."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


def run_both(overrides, root):
    """Both packages' ``run`` of ``compose(default, overrides)`` from the
    same weights: (JAX metrics, port metrics, JAX config, port config)."""
    captured = {}
    jax_init = jax_run.init_train_state
    port_init = port_run.init_train_state

    def jax_state(*args, **kwargs):
        state = jax_init(*args, **kwargs)
        variables = randomize({"params": state.params, "batch_stats": state.batch_stats}, 0)
        captured.update(variables=variables, loss_params=jax.device_get(state.loss_params))
        return state.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                             batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                                variables["batch_stats"]))

    def port_state(model, losses, *args, **kwargs):
        state = port_init(model, losses, *args, **kwargs)
        load_jax_variables(model, captured["variables"])
        load_jax_loss_params(losses, captured["loss_params"])
        return state

    jcfg = jax_compose(CONFIG_DIR, "default", overrides + [f"experience.log_dir={root}/jax"])
    cfg = compose(CONFIG_DIR, "default", overrides + [f"experience.log_dir={root}/port"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_run, "init_train_state", jax_state)
        mp.setattr(port_run, "init_train_state", port_state)
        jax_metrics = jax_run.run(jcfg)
        metrics = port_run.run(cfg, device="cpu")
    return jax_metrics, metrics, jcfg, cfg


def _records(log_dir):
    with open(log_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def check_runs(root, cfg, jax_metrics, metrics):
    name = cfg.experience.experiment_name
    ours, ref = _records(root / "port" / name), _records(root / "jax" / name)
    assert [r["step"] for r in ours] == [r["step"] for r in ref]
    for o, r in zip(ours, ref):
        assert set(o) - PORT_ONLY == set(r)
        for key, value in r.items():
            if not key.endswith("seconds"):
                assert o[key] == pytest.approx(value, rel=METRIC_TOL, abs=1e-7), (o["step"], key)
    assert set(metrics) == set(jax_metrics) and metrics
    for split, values in jax_metrics.items():
        for key, value in values.items():
            assert metrics[split][key] == pytest.approx(value, rel=METRIC_TOL, abs=1e-7), key


@pytest.fixture(scope="module")
def default_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("default")
    overrides = ["dataset=synthetic", "dataset.kwargs.num_samples=64", "experience.eval_bs=32",
                 "experience.max_iter=1", "experience.step_per_epoch=2"] + LOCAL
    return root, run_both(overrides, root)


def test_default_composition_builds_single_band_tiny(default_run):
    """No ``model=`` override: ``single_band_net`` on vit_tiny, its 112²
    bands sized from the DWT of the 224² crop."""
    _, (_, _, jcfg, cfg) = default_run
    assert cfg.model.name == jcfg.model.name == "single_band_net"
    assert cfg.model.kwargs.backbone == "vit_tiny" and cfg.transform.train.CustomTransform


def test_default_composition_runs_as_jax(default_run):
    root, (jax_metrics, metrics, _, cfg) = default_run
    check_runs(root, cfg, jax_metrics, metrics)
    assert metrics["test"]["map_level0"] > 0
