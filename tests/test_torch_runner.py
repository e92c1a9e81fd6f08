"""The port's getter, ``run`` and runner against irw_tpu's, and the runner's
finished-run check, resume and refusals.

The flagship study's ortho 0.1 job (``studies/voc_lambda_protocol.yaml``)
at test width: one ``test_tiny`` backbone config (4 bands of a 64-wide,
2-block ViT on 16² images), f32, fusion dropout 0, 24 synthetic VOC images
of 20² through ``voc_swt``'s host stage cut to Resize 20 / crop 16, batch
6, two epochs of two steps, ``memory=voc``, one Hamming eval at epoch 2.
Both packages' ``run`` train from the JAX ``init_train_state``'s weights
with biases, norms and LayerScale redrawn (``test_torch_vit.randomize``:
at the init LayerScale of 1e-5 the bands barely differ, and the hash head's
BatchNorm over 6 samples would magnify rounding), bridged into the port.
At basic.yaml's LR of 1e-5 the epoch metrics stay within the loop test's
1e-5 (``tests/test_torch_loop.py``).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import run as jax_run
from irw_tpu.config import compose as jax_compose
from irw_tpu.getter import Getter as JaxGetter
from irw_tpu_torch import run as port_run
from irw_tpu_torch import single_experiment_runner as runner
from irw_tpu_torch.bridge import load_jax_loss_params, load_jax_variables
from irw_tpu_torch.config import compose
from irw_tpu_torch.engine import load_checkpoint
from irw_tpu_torch.getter import Getter
from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
from irw_tpu_torch.studies import run_plan
from test_torch_config import STUDY
from test_torch_train_step import METRIC_TOL
from test_torch_vit import randomize

JOB = "model.kwargs.fusion_config.ortho_weight=0.1"
# the port's measurement keys, which the JAX loop does not log
# the port's timing keys beside the JAX loop's (each split's eval seconds)
PORT_ONLY = {"train/train_seconds", "test/eval_seconds", "val/eval_seconds"}
TINY = ["model.kwargs.backbones_config=[{name: test_tiny, frozen: false}]",
        "+model.kwargs.vit_kwargs={img_size: 16}", "model.kwargs.with_autocast=false",
        "model.kwargs.fusion_config.dropout=0.0", "dataset.kwargs.num_train=24",
        "dataset.kwargs.num_query=8", "dataset.kwargs.image_size=20",
        "transform.train.Resize.size=20", "transform.train.RandomResizedCrop.size=16",
        "dataset.sampler.kwargs.batch_size=6", "experience.sub_batch=6",
        "experience.step_per_epoch=2", "experience.train_eval_freq=2",
        "experience.test_eval_freq=2", "experience.checkpoint_freq=1", "experience.eval_bs=8",
        "experience.evaluation.top_k=24", "experience.num_workers=0",
        "experience.use_mesh=false"]


def _job():
    (name, overrides), = [(n, o) for n, o in run_plan.expand_jobs(run_plan.load_plan(STUDY))
                          if JOB in o]
    return name, overrides


def _overrides(log_dir, max_iter=2):
    return _job()[1] + TINY + [f"experience.max_iter={max_iter}",
                               f"experience.log_dir={log_dir}"]


def _records(log_dir):
    with open(log_dir / _job()[0] / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module", autouse=True)
def _no_tensorboard():
    """TensorBoard imports TensorFlow, which takes longer than a test."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``run`` of the job, from the same weights."""
    root = tmp_path_factory.mktemp("runner")
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

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_run, "init_train_state", jax_state)
        mp.setattr(port_run, "init_train_state", port_state)
        jax_metrics = jax_run.run(jax_compose(CONFIG_DIR, "default", _overrides(root / "jax")))
        metrics = port_run.run(compose(CONFIG_DIR, "default", _overrides(root / "port")),
                               device="cpu")
    return {"root": root, "metrics": metrics, "jax_metrics": jax_metrics}


def test_runner_metrics_jsonl_matches_jax(runs):
    ours, ref = _records(runs["root"] / "port"), _records(runs["root"] / "jax")
    assert [r["step"] for r in ours] == [r["step"] for r in ref] == [1, 2, 2]
    for o, r in zip(ours, ref):
        assert set(o) - PORT_ONLY == set(r)
        for key, value in r.items():
            if not key.endswith("seconds"):
                assert o[key] == pytest.approx(value, rel=METRIC_TOL), (o["step"], key)


def test_runner_eval_metrics_match_jax(runs):
    ours, ref = runs["metrics"], runs["jax_metrics"]
    assert set(ours) == set(ref) == {"test"} and set(ours["test"]) == set(ref["test"])
    for key, value in ref["test"].items():
        assert ours["test"][key] == pytest.approx(value, rel=METRIC_TOL, abs=1e-7), key


def test_runner_checkpoint_holds_the_finished_run(runs):
    weights = runs["root"] / "port" / _job()[0] / "weights"
    assert sorted(p.name for p in weights.iterdir()) == ["rolling"]  # save_model=10
    _, meta = load_checkpoint(str(weights.parent))
    score = runs["metrics"]["test"]["map_level0"]
    assert meta["epoch"] == 2 and meta["score"] == meta["best_score"] == score
    assert meta["config"]["model"]["kwargs"]["fusion_config"]["ortho_weight"] == 0.1


def test_finished_run_check_returns_without_building(tmp_path, monkeypatch):
    """A second call of a finished job returns its best score and builds,
    trains and logs nothing."""
    first = runner.run_one(_overrides(tmp_path), device="cpu")
    records = _records(tmp_path)

    def refuse(*args, **kwargs):
        raise AssertionError("the finished-run check built a model")

    monkeypatch.setattr(Getter, "get_model", refuse)
    monkeypatch.setattr(Getter, "get_dataset", refuse)
    assert runner.run_one(_overrides(tmp_path), device="cpu") == first
    assert _records(tmp_path) == records
    assert runner.main(_overrides(tmp_path), device="cpu") == 0


def test_stopped_run_resumes_to_the_uninterrupted_one(tmp_path):
    """A run stopped after epoch 1 and called again with max_iter 2 resumes
    from its rolling checkpoint and trains epoch 2 as the uninterrupted run
    did, bit for bit."""
    runner.run_one(_overrides(tmp_path / "full"), device="cpu")
    runner.run_one(_overrides(tmp_path / "resumed", max_iter=1), device="cpu")
    runner.run_one(_overrides(tmp_path / "resumed"), device="cpu")
    full, resumed = _records(tmp_path / "full"), _records(tmp_path / "resumed")
    assert [r["step"] for r in resumed] == [1, 1, 2, 2]  # epoch 1 ended its run: an eval
    for a, b in zip([r for r in full if "train/total_loss" in r],
                    [r for r in resumed if "train/total_loss" in r]):
        assert {k: v for k, v in a.items() if not k.endswith("seconds")} == {
            k: v for k, v in b.items() if not k.endswith("seconds")}
    (state_a, _), (state_b, _) = (load_checkpoint(str(tmp_path / d / _job()[0]))
                                  for d in ("full", "resumed"))
    for key, value in state_a["model"].items():
        assert torch.equal(value, state_b["model"][key]), key
    assert state_b["epoch"] == 2 and state_b["step"] == 4


@pytest.mark.parametrize("dataset", ["voc_synthetic", "synthetic_hashing", "synthetic"])
def test_getter_datasets_and_sampler_match_jax(dataset):
    """The train set and the eval side (a query/gallery pair, or one test
    set), images and labels, and the sampler's batches of epochs 0-2."""
    overrides = [f"dataset={dataset}"] + {
        "voc_synthetic": ["dataset.kwargs.num_train=30", "dataset.kwargs.num_query=10",
                          "dataset.kwargs.image_size=16"],
        "synthetic_hashing": ["dataset.kwargs.num_samples=40", "dataset.kwargs.image_size=16"],
        "synthetic": ["dataset.kwargs.num_samples=30", "dataset.kwargs.image_size=16"]}[dataset]
    cfg = compose(CONFIG_DIR, "default", overrides).dataset
    ours, ref = Getter().get_dataset(cfg), JaxGetter().get_dataset(cfg)
    pairs = [(ours[0], ref[0])]
    if isinstance(ref[1]["test"], dict):
        assert set(ours[1]["test"]) == set(ref[1]["test"]) == {"query", "gallery"}
        pairs += [(ours[1]["test"][k], ref[1]["test"][k]) for k in ("query", "gallery")]
    else:
        pairs.append((ours[1]["test"], ref[1]["test"]))
    for a, b in pairs:
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    sampler, jsampler = (g.get_sampler(ds, cfg.sampler)
                         for g, ds in ((Getter(), ours[0]), (JaxGetter(), ref[0])))
    for epoch in range(3):
        for a, b in zip(sampler.reshuffle(epoch).batches, jsampler.reshuffle(epoch).batches,
                        strict=True):
            np.testing.assert_array_equal(a, b)


def test_getter_memory_matches_jax():
    cfg = compose(CONFIG_DIR, "default", ["memory=voc"]).memory
    ours, ref = Getter().get_memory(cfg, 64, (20,)), JaxGetter().get_memory(cfg, 64, (20,))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("preset", ["basic", "cub", "sgd", "warmcos", "fast", "ce_opt",
                                    "cub_wresnet", "sdd_ap"])
def test_getter_optimizer_hyperparameters_match_jax(preset):
    """Each entry's name, target, group base LRs and scheduled group LRs over
    epochs 1-3 at steps 0, 10 and 1000."""
    cfg = compose(CONFIG_DIR, "default", [f"optimizer={preset}"]).optimizer
    ours = Getter().get_optimizer(torch.nn.Linear(2, 2), cfg)
    ref = JaxGetter().get_optimizer({"weight": jnp.zeros((2, 2)), "bias": jnp.zeros(2)}, cfg)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert (a.name, a.target, a.group_base_lr) == (b.name, b.target, b.group_base_lr)
        for epoch in (1, 2, 3):
            for step in (0, 10, 1000):
                got, want = a.group_lrs(epoch, step), b.group_lrs(epoch, step)
                assert got.keys() == want.keys()
                for label, lr in want.items():
                    assert got[label] == pytest.approx(float(lr), rel=1e-6), (epoch, step)


def test_getter_loss_optimizer_follows_the_loss_config():
    """hash_loss.yaml's own optimizer for the proxies: AdamW at its lr and
    weight decay, as the JAX getter's ``make_tx`` reads them."""
    cfg = compose(CONFIG_DIR, "default", ["loss=hash_loss"]).loss
    getter = Getter()
    losses = getter.get_loss(cfg)
    (key, opt), = getter.get_loss_optimizer(cfg, losses).items()
    kw = cfg[0].kwargs.optimizer.kwargs
    assert key == "0" and isinstance(opt, torch.optim.AdamW)
    assert (opt.defaults["lr"], opt.defaults["weight_decay"]) == (kw.lr, kw.weight_decay)
    assert opt.param_groups[0]["params"] == list(losses[0][0].parameters())


@pytest.mark.parametrize("transform", ["voc_swt", "cub_swt", "cub_dwt", "dwt", "swt"])
def test_getter_transform_op_lists_match_jax(transform):
    cfg = compose(CONFIG_DIR, "default", [f"transform={transform}"]).transform
    ours, ref = Getter().get_transform(cfg, device="cpu"), JaxGetter().get_transform(cfg)
    for (host, dev), (jhost, jdev) in zip(ours, ref):
        assert host.ops == jhost.ops
        assert [(n, tuple(sorted(kw.items()))) for n, kw in dev.ops] == list(jdev.ops)


def test_chip_smoke_runner_job_composes():
    """``chip_smoke.py``'s runner phase: its job is the plan's, its cuts set
    keys the config has, and the rest is the study's."""
    import chip_smoke

    overrides = _job()[1] + chip_smoke.RUNNER_CUTS + ["experience.log_dir=/tmp/x"]
    assert chip_smoke.RUNNER_JOB == JOB
    cfg = compose(CONFIG_DIR, "default", overrides)
    assert (cfg.dataset.sampler.kwargs.batch_size, cfg.experience.eval_bs,
            cfg.experience.num_workers, cfg.dataset.kwargs.image_size) == (96, 1000, 8, 64)
    assert cfg.dataset.kwargs.num_train == chip_smoke.RUNNER_TRAIN
    assert cfg.memory.kwargs.size == 5717 and cfg.transform.train.ColorJitter.hue == 0


@pytest.mark.parametrize("flags", [["--jobs", "2"], ["--chips-per-job", "1"]])
def test_run_plan_parallel_jobs_name_a13(flags, capsys):
    """Parallel lanes are ported (A13a): the dry run lists each job's lane
    (and its card under ``--chips-per-job 1``); a job over two cards still
    names its item, A13b."""
    assert run_plan.main([str(STUDY), "--dry-run"] + flags) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "single_experiment_runner" in ln]
    assert len(lines) == 5
    if "--jobs" in flags:
        assert [ln.split()[1] for ln in lines] == ["0]", "1]", "0]", "1]", "0]"]
        assert not any("CUDA_VISIBLE_DEVICES" in ln for ln in lines)
    else:
        assert all(ln.split()[0] == "CUDA_VISIBLE_DEVICES=0" for ln in lines)
    with pytest.raises(NotImplementedError, match="A13b"):
        run_plan.main([str(STUDY), "--dry-run"] + flags + ["--chips-per-job", "2"])


def test_run_plan_dry_run_lists_the_jobs(capsys):
    assert run_plan.main([str(STUDY), "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "5 jobs" in out and out.count("-m irw_tpu_torch.single_experiment_runner") == 5


def test_runner_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.main(_overrides(tmp_path))
