"""The tools that read a run (``irw_tpu_torch.evaluate``, ``attention``,
``plot_exemples``) against the JAX package's CLIs (``evaluate.py``,
``attention.py``, ``plot_exemples.py``) on the same trained weights.

The port's run of the flagship study's job at the width of
``tests/test_torch_runner.py`` (a 64-wide, 2-block ``test_tiny`` ViT a
band, f32, fusion dropout 0), cut to one epoch of one step with its eval;
its final weights carried into a JAX checkpoint (``bridge.to_flax_leaves``,
the BatchNorm statistics by ``bridge.jax_module_paths``) with the run's
config and epoch, which the JAX CLIs read.  (That both packages' ``run``
train to the same weights is ``test_torch_runner.py``'s.)  The images are
16², the train stage's Resize and crop 16 and the test stage Resize 16 /
CenterCrop 16: every geometric op is the identity, so the offline metrics
equal the run's own last eval (taken with the train stage in eval mode),
and the JAX checkpoint's config, whose transform ops orbax restores in
alphabetical order, gives the same pixels.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import json
import shutil
import sys

import numpy as np
import pytest
import torch
from flax import traverse_util
from PIL import Image

import attention as jax_attention
import evaluate as jax_evaluate
import plot_exemples as jax_plot
from irw_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from irw_tpu_torch import attention as port_attention
from irw_tpu_torch import evaluate as port_evaluate
from irw_tpu_torch import plot_exemples as port_plot
from irw_tpu_torch import run as port_run
from irw_tpu_torch.bridge import jax_module_paths, to_flax_leaves
from irw_tpu_torch.config import compose
from irw_tpu_torch.engine.checkpoint import load_checkpoint
from irw_tpu_torch.run_dir import load_run
from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
from test_torch_runner import TINY, _job
from test_torch_train_step import METRIC_TOL

CUTS = ["experience.max_iter=1", "experience.step_per_epoch=1", "experience.train_eval_freq=1",
        "experience.test_eval_freq=1", "dataset.kwargs.image_size=16",
        "transform.train.Resize.size=16", "transform.test.Resize.size=16",
        "transform.test.CenterCrop.size=16"]


def job_overrides(log_dir) -> list:
    return _job()[1] + TINY + CUTS + [f"experience.log_dir={log_dir}"]


@pytest.fixture(scope="module", autouse=True)
def _no_tensorboard():
    """TensorBoard imports TensorFlow, which takes longer than a test."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


def jax_variables(model) -> dict:
    """``model``'s parameters and BatchNorm statistics as the flax
    variables the bridge reads them from (the statistics of the per-band
    trunks stacked on a leading band axis, as ``to_flax_leaves`` stacks
    their parameters)."""
    params = to_flax_leaves(model, {n: p.detach() for n, p in model.named_parameters()})
    scopes = jax_module_paths(model)
    grouped = {}
    for name, module in model.named_modules():
        if getattr(module, "running_mean", None) is not None:
            grouped.setdefault(f"{scopes[name]}/mean", []).append(module.running_mean)
            grouped.setdefault(f"{scopes[name]}/var", []).append(module.running_var)
    stats = {k: v[0] if len(v) == 1 else torch.stack(v) for k, v in grouped.items()}
    return {kind: traverse_util.unflatten_dict({tuple(k.split("/")): np.array(v.numpy())
                                                for k, v in tree.items()})
            for kind, tree in (("params", params), ("batch_stats", stats))}


def write_jax_run(port_dir: str, jax_dir: str) -> dict:
    """The JAX package's checkpoint of the port run's weights, config and
    epoch under ``jax_dir``; returns the flax variables."""
    run = load_run(port_dir, device="cpu")
    variables = jax_variables(run.model)
    jax_save_checkpoint(jax_dir, variables, run.meta["config"], run.meta["epoch"],
                        run.meta["score"], run.meta["best_score"])
    return variables


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's run of the cut job and the JAX checkpoint of its weights."""
    root = tmp_path_factory.mktemp("run_tools")
    metrics = port_run.run(compose(CONFIG_DIR, "default", job_overrides(root / "port")),
                           device="cpu")
    port_dir = str(root / "port" / _job()[0])
    write_jax_run(port_dir, str(root / "jax"))
    return {"port": port_dir, "jax": str(root / "jax"), "metrics": metrics["test"]}


def _same_metrics(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for key, value in ref.items():
        assert ours[key] == pytest.approx(value, rel=METRIC_TOL, abs=1e-7), key


def test_load_and_evaluate_matches_jax_and_the_runs_last_eval(runs):
    ours = port_evaluate.load_and_evaluate(runs["port"], batch_size=8, num_workers=0,
                                           device="cpu")
    ref = jax_evaluate.load_and_evaluate(runs["jax"], batch_size=8, num_workers=0)
    _same_metrics(ours, {k: float(v) for k, v in ref.items()})
    _same_metrics(ours, runs["metrics"])
    assert ours["num_k_level0"] == 24 and 0.0 < ours["map_level0"] <= 1.0


def test_evaluate_cli_appends_a_line_per_run(runs, tmp_path):
    """``--parse-file`` lists the runs, ``--append-file`` gets one JSON line
    each, as the JAX CLI writes them; ``--k`` and ``--metric`` override the
    run's evaluation."""
    listing = tmp_path / "runs.txt"
    listing.write_text(f"{runs['port']}\n\n{runs['port']}\n")
    out = tmp_path / "results.jsonl"
    port_evaluate.main(["--run", "unused", "--parse-file", str(listing), "--append-file",
                        str(out), "--bs", "8", "--nw", "0", "--k", "5", "--metric", "hamming",
                        "--device", "cpu"])
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert [line["run"] for line in lines] == [runs["port"]] * 2
    assert lines[0] == lines[1] and lines[0]["num_k_level0"] == 5


def test_mean_attention_matches_jax(runs):
    ours = port_attention.mean_attention(runs["port"], batch_size=5, device="cpu")
    ref = np.asarray(jax_attention.mean_attention(runs["jax"], batch_size=5))
    assert ours.shape == ref.shape == (4, 4)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    assert port_attention.BAND_NAMES == jax_attention.BAND_NAMES


def test_retrieval_panels_match_jax_pixel_for_pixel(runs, tmp_path):
    """The same top-k and border colours, the thumbnails Pillow's bicubic
    resize, and the PNG (decoded with Pillow) equal to the JAX ``render``'s
    pixel for pixel, two runs stacked."""
    ours = port_plot.retrieval_rows(runs["port"], num_queries=3, topk=4, thumb=12,
                                    device="cpu")
    ref = jax_plot.retrieval_rows(runs["jax"], num_queries=3, topk=4, thumb=12)
    assert [[c for _, c in row] for row in ours] == [[c for _, c in row] for row in ref]
    assert {c for row in ours for _, c in row} >= {"blue", "green", "red"}
    for row, ref_row in zip(ours, ref):
        for (img, _), (ref_img, _) in zip(row, ref_row):
            np.testing.assert_array_equal(img, np.asarray(ref_img))
    port_plot.render([ours, ours[:2]], tmp_path / "port.png", thumb=12)
    jax_plot.render([ref, ref[:2]], str(tmp_path / "jax.png"), thumb=12)
    with Image.open(tmp_path / "port.png") as a, Image.open(tmp_path / "jax.png") as b:
        assert a.mode == b.mode == "RGB" and a.size == b.size == (5 * 26, 5 * 26)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_load_run_sizes_the_vit_as_the_run_did(runs):
    run = load_run(runs["port"], device="cpu")
    assert run.image_size == (16, 16) and not run.model.training
    assert run.model.backbone.vit.pos_embed.shape == (4, 5, 64)
    assert run.meta["epoch"] == 1


def test_load_run_names_both_shapes_of_a_moved_position_embedding(runs, tmp_path):
    """A checkpoint whose train stage no longer gives the images it trained
    on: the rebuilt ViT's position embeddings and the checkpoint's differ,
    and ``load_run`` names both shapes."""
    moved = tmp_path / "moved"
    shutil.copytree(runs["port"], moved)
    state, meta = load_checkpoint(str(moved))
    meta["config"]["transform"]["train"]["RandomResizedCrop"]["size"] = 8
    torch.save({"state": state, "meta": meta}, moved / "weights" / "rolling")
    with pytest.raises(ValueError, match=r"\(4, 5, 64\).*\(4, 2, 64\)"):
        load_run(str(moved), device="cpu")


def test_run_tools_need_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="no rolling checkpoint"):
        load_run(str(tmp_path), device="cpu")
