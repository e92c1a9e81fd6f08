"""The port's YAML reader, ``compose``, ``expand_sweeps`` and the study
plans' job expansion against PyYAML and irw_tpu's.

``irw_tpu_torch.config.yaml_lite`` reads every ``.yaml`` under ``configs/``
and ``studies/`` as ``yaml.safe_load`` does, and every override value the
study plans and these tests pass; ``compose`` gives the JAX ``compose``'s
tree for the flagship study's jobs.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import importlib.util
import math
from pathlib import Path

import pytest
import yaml

from irw_tpu.config import compose as jax_compose
from irw_tpu.config import expand_sweeps as jax_expand_sweeps
from irw_tpu.config import parse_overrides as jax_parse_overrides
from irw_tpu_torch.config import compose, expand_sweeps, parse_overrides
from irw_tpu_torch.config.yaml_lite import load, loads
from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
from irw_tpu_torch.studies.run_plan import build_command, expand_jobs, load_plan

REPO = Path(__file__).resolve().parents[1]
YAML_DIRS = sorted({p.parent.relative_to(REPO) for p in REPO.glob("configs/**/*.yaml")}
                   | {p.parent.relative_to(REPO) for p in REPO.glob("studies/**/*.yaml")})
PLANS = sorted(p.name for p in (REPO / "studies").glob("*.yaml"))
STUDY = REPO / "studies/voc_lambda_protocol.yaml"
# values the tests and the chip smoke's runner phase pass besides the plans'
EXTRA_VALUES = ["[{name: test_tiny, frozen: false}]", "{img_size: 16}", "false", "0.0", "1e-5",
                "1.0e-05", "null", "~", "", "'${dataset.num_classes}'", "\"a b\"", "0x1F", "012",
                ".5", "-3", "+4", "yes", "Off", "[]", "{}", "[0.16, 1]", "experiments/protocol",
                "/tmp/runs", "1_000", "3.", "-.inf"]


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


def _jax_run_plan():
    spec = importlib.util.spec_from_file_location("jax_run_plan", REPO / "studies/run_plan.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_yaml_directory_is_held():
    assert sum(len(list((REPO / d).glob("*.yaml"))) for d in YAML_DIRS) == 197


@pytest.mark.parametrize("directory", [str(d) for d in YAML_DIRS])
def test_yaml_reader_matches_pyyaml(directory):
    for path in sorted((REPO / directory).glob("*.yaml")):
        with open(path) as f:
            assert load(path) == yaml.safe_load(f), path


def test_override_values_match_pyyaml():
    values = set(EXTRA_VALUES)
    for name in PLANS:
        plan = yaml.safe_load((REPO / "studies" / name).read_text())
        values.update(o.partition("=")[2] for o in plan.get("base_overrides") or [])
        values.update(str(v) for vs in (plan.get("sweep") or {}).values() for v in vs)
    for value in sorted(values):
        assert _same(loads(value), yaml.safe_load(value)), value


def test_yaml_reader_refuses_what_it_does_not_read():
    for text in ("a: &x 1", "a: !!int 3", "a: |\n  text", "a: 2001-12-14", "a: 1:20"):
        with pytest.raises(ValueError):
            loads(text)


def test_parse_overrides_matches_jax():
    overrides = ["model=multidino_attention_hashing_ortho", "experience.seed=3",
                 "+experience.new_key={a: [1, 2]}", "loss.0.kwargs.scale=15.0",
                 "experience.clip_grad=null", "dataset.kwargs.image_size=64"]
    assert parse_overrides(overrides) == jax_parse_overrides(overrides)


@pytest.mark.parametrize("ortho", ["0", "0.01", "0.1", "1", "10"])
def test_compose_matches_jax_for_the_study(ortho):
    """The flagship study's base overrides with each sweep point."""
    jobs = expand_jobs(load_plan(STUDY))
    (_, overrides), = [(n, o) for n, o in jobs
                       if f"model.kwargs.fusion_config.ortho_weight={ortho}" in o]
    ours = compose(CONFIG_DIR, "default", overrides)
    ref = jax_compose(CONFIG_DIR, "default", overrides)
    assert ours.to_dict() == ref.to_dict()
    assert ours.model.kwargs.fusion_config.ortho_weight == loads(ortho)


@pytest.mark.parametrize("overrides", [
    [], ["dataset=voc_synthetic", "+extra.key=3", "experience.seed=7"],
    ["model=wcnn_attention_all_subs", "transform=dwt_all_subs"],
    ["dataset=cub", "model=resnet_ce", "loss=multi_ce"],
    ["memory=voc", "optimizer=cifar"], ["seed_root=5"]],
    ids=["default", "adds", "interpolation", "groups", "swaps", "root_set"])
def test_compose_matches_jax(overrides):
    assert (compose(CONFIG_DIR, "default", overrides).to_dict()
            == jax_compose(CONFIG_DIR, "default", overrides).to_dict())


def test_compose_errors_match_jax():
    for bad in (["experience.no_such_key=1"], ["model=no_such_model"]):
        with pytest.raises((KeyError, FileNotFoundError)) as ours:
            compose(CONFIG_DIR, "default", bad)
        with pytest.raises((KeyError, FileNotFoundError)) as ref:
            jax_compose(CONFIG_DIR, "default", bad)
        assert type(ours.value) is type(ref.value)


@pytest.mark.parametrize("overrides", [
    ["a=1,2,3", "b.c=x,y", "d=4"], ["a=[1,2]", "b='x,y'"], ["a=1"], []])
def test_expand_sweeps_matches_jax(overrides):
    assert list(expand_sweeps(overrides)) == list(jax_expand_sweeps(overrides))


@pytest.mark.parametrize("plan", PLANS)
def test_expand_jobs_matches_jax(plan):
    jax_plan = _jax_run_plan()
    ours = expand_jobs(load_plan(REPO / "studies" / plan))
    assert ours == jax_plan.expand_jobs(jax_plan.load_plan(REPO / "studies" / plan))


def test_build_command_runs_the_port_module():
    cmd = build_command(["experience.seed=1"])
    assert cmd[1:] == ["-m", "irw_tpu_torch.single_experiment_runner", "experience.seed=1"]
