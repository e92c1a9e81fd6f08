"""The port's epoch loop against irw_tpu's ``train``, resume, and the XBM
memory.

Both packages train the small flagship (the YAML's kwargs at depth 2 on 28²
images, f32, attention on the kernel route, block remat, fusion dropout 0)
from the same bridged weights for two epochs of two steps at batch 6 on
synthetic VOC data, with ``configs/loss/hash_loss.yaml``,
``configs/optimizer/basic.yaml``, ``clip_grad`` 5,
``ortho_scale`` 2, a unique XBM (inert for HashLoss), rolling async
checkpoints every epoch with ``epoch_N`` at each, and one Hamming eval of a
query set against the train set at the last epoch.  The JAX host stage is
the identity (a resize to the stored size) and its mesh is off.

The loop cannot restart each step from the JAX parameters, as the train
step test (``tests/test_torch_train_step.py``) does, so the optimizer runs
at basic.yaml's own LR of 1e-5: a parameter whose gradient is at rounding
level moves by ±lr in either package, and at 1e-5 that drift keeps the
next steps' metrics within the step test's tolerance.  Tolerances: each
epoch's mean metrics to 1e-5 relative (the step test's).  The final
parameters: each within 2·lr·(1 + wd·|p|) a step of the JAX one (the step
test's bound where a gradient's sign can differ), and all but 1 % of every
leaf within 1e-3·lr (the step test's limit where the gradient is large)
plus one f32 rounding of the parameter a step.  The BatchNorm statistics to
1e-5, the eval metrics to 1e-6 (the served slice's: the codes agree).  A
resumed run equals the uninterrupted one bit for bit.
"""

import copy
import dataclasses
import json
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from irw_tpu.data.synthetic import SyntheticVOCDataset as JaxSyntheticVOC
from irw_tpu.engine import optimizers as jax_optimizers
from irw_tpu.engine.train import train as jax_train
from irw_tpu.engine.xbm import XBM as JaxXBM
from irw_tpu.getter import Getter
from irw_tpu.getter import init_train_state as jax_init_train_state
from irw_tpu.losses import build_losses as jax_build_losses
from irw_tpu.models import get_model as jax_get_model
from irw_tpu.samplers import RandomSampler as JaxRandomSampler
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu.transforms.pipeline import HostTransform
from irw_tpu_torch.bridge import from_jax_variables, load_jax_loss_params
from irw_tpu_torch.data import SyntheticVOCDataset
from irw_tpu_torch.engine import (XBM, build_train_step, get_memory, init_train_state,
                                  maybe_resume, train)
from irw_tpu_torch.engine import optimizers
from irw_tpu_torch.engine.train import _build_hyper
from irw_tpu_torch.losses import build_losses
from irw_tpu_torch.models import get_model
from irw_tpu_torch.samplers import RandomSampler
from irw_tpu_torch.transforms import DeviceTransform
from test_torch_multi_dino import YAML, flagship_yaml
from test_torch_train_model import EXACT_ZEROS
from test_torch_train_step import (CLIP, METRIC_TOL, METRICS, OPS, ORTHO_SCALE, _RefAwareLoss,
                                   _yaml)
from test_torch_vit import randomize

IMG, BATCH, STEPS_PER_EPOCH, EPOCHS = 28, 6, 2, 2
TINY_IMG = 16
N_TRAIN, N_QUERY = 18, 8
LR, WD = 1e-5, 5e-4  # configs/optimizer/basic.yaml's
EVAL_TOL = 1e-6
CONFIG = {"experience": {
    "max_iter": EPOCHS, "step_per_epoch": STEPS_PER_EPOCH, "seed": 0, "num_workers": 0,
    "train_eval_freq": -1, "test_eval_freq": EPOCHS, "eval_bs": 8, "eval_split": "test",
    "principal_metric": "map_level0",
    "evaluation": {"top_k": N_TRAIN, "distance_metric": "hamming"},
    "clip_grad": CLIP, "ortho_scale": ORTHO_SCALE, "warm_up": 0, "checkpoint_freq": 1,
    "save_model": 1, "async_checkpoint": True, "use_mesh": False}}


def _configs():
    opt_cfg, loss_cfg = _yaml("optimizer/basic.yaml"), _yaml("loss/hash_loss.yaml")
    assert opt_cfg[0]["kwargs"] == {"lr": LR, "weight_decay": WD}
    return opt_cfg, loss_cfg


def _model_kwargs():
    cfg = flagship_yaml()
    fusion = dict(cfg["kwargs"]["fusion_config"], dropout=0.0)
    vit = {"depth": 2, "dtype": "float32", "vmem_attn": True}
    return cfg["name"], dict(cfg["kwargs"], vit_kwargs=vit, fusion_config=fusion)


def _port_state(weights, proxies, seed=0, xbm=True):
    """A port TrainState of the small flagship with the state dict
    ``weights`` and the HashLoss ``proxies`` (numpy)."""
    name, kw = _model_kwargs()
    opt_cfg, loss_cfg = _configs()
    model = get_model(name, device="cpu", **dict(kw, vit_kwargs=dict(kw["vit_kwargs"],
                                                                     img_size=IMG)))
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in weights.items()})
    memory = XBM(size=N_TRAIN, embedding_dim=64, label_shape=(20,)) if xbm else None
    state = init_train_state(model, build_losses(loss_cfg), opt_cfg, loss_cfg, seed=seed,
                             xbm=memory)
    load_jax_loss_params(state.losses, {"0": {"proxies": proxies}})
    return state


def _records(log_dir):
    with open(log_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module", autouse=True)
def _no_tensorboard():
    """Both packages' loggers write JSONL alone here: TensorBoard imports
    TensorFlow, which takes longer than a test."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``train`` from one state."""
    return _run_both(tmp_path_factory.mktemp("loop"))


def _run_both(root):
    name, kw = _model_kwargs()
    opt_cfg, loss_cfg = _configs()
    ds = SyntheticVOCDataset(num_train=N_TRAIN, image_size=IMG, seed=4)
    query = SyntheticVOCDataset(num_query=N_QUERY, mode="query", image_size=IMG, seed=4)
    jds = JaxSyntheticVOC(num_train=N_TRAIN, image_size=IMG, seed=4)
    jquery = JaxSyntheticVOC(num_query=N_QUERY, mode="query", image_size=IMG, seed=4)

    jmodel = jax_get_model(name, **kw)
    jdt = JaxDeviceTransform(OPS)
    batch = {"image": ds.images[:BATCH], "label": ds.labels[:BATCH]}
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "band_drop": jax.random.PRNGKey(2)}
    variables = jax.jit(lambda r, x: jmodel.init(r, x, train=True))(
        rngs, jdt(jnp.asarray(batch["image"])))
    variables = randomize(variables, 0)
    jlosses = jax_build_losses(loss_cfg)
    entries = jax_optimizers.build_optimizers(opt_cfg, variables["params"])
    loss_tx = Getter().get_loss_optimizer(loss_cfg)
    jxbm = JaxXBM(size=N_TRAIN, embedding_dim=64, label_shape=(20,))
    jstate = jax_init_train_state(jmodel, jlosses, entries, loss_tx, batch, jdt, xbm=jxbm,
                                  seed=0)
    jstate = jstate.replace(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]))
    start = from_jax_variables({"params": jstate.params, "batch_stats": jstate.batch_stats})
    start_proxies = np.array(jstate.loss_params["0"]["proxies"])
    state = _port_state(start, start_proxies)

    jdir, pdir = root / "jax", root / "port"
    jfinal, jmetrics = jax_train(
        jmodel, jstate, jlosses, entries, loss_tx, jds, JaxRandomSampler(jds, BATCH, seed=0),
        {"test": {"query": jquery, "gallery": jds}}, HostTransform([("Resize", {"size": IMG})]),
        jdt, CONFIG, str(jdir), xbm=jxbm)
    state, metrics = train(state, ds, RandomSampler(ds, BATCH, seed=0),
                           {"test": {"query": query, "gallery": ds}}, None,
                           DeviceTransform(OPS, device="cpu"), CONFIG, str(pdir))
    return {"jstate": jfinal, "jmetrics": jmetrics, "state": state, "metrics": metrics,
            "jdir": jdir, "pdir": pdir, "start": start, "start_proxies": start_proxies}


def test_loop_epoch_metrics_match_jax(runs):
    ours = [r for r in _records(runs["pdir"]) if "train/total_loss" in r]
    ref = [r for r in _records(runs["jdir"]) if "train/total_loss" in r]
    assert [r["step"] for r in ours] == [r["step"] for r in ref] == list(range(1, EPOCHS + 1))
    for o, r in zip(ours, ref):
        for name in METRICS + ("loss_0_HashLoss", "lr"):
            key = f"train/{name}"
            assert o[key] == pytest.approx(r[key], rel=METRIC_TOL), (o["step"], key)
        assert o["train/train_seconds"] >= o["train/step_seconds"] > 0
    assert runs["state"].step == EPOCHS * STEPS_PER_EPOCH and runs["state"].epoch == EPOCHS
    assert runs["state"].model_alpha == np.sqrt(EPOCHS)  # α = f(E - 1) in the last epoch
    assert float(runs["jstate"].model_alpha) == pytest.approx(np.sqrt(EPOCHS), rel=1e-7)


def test_loop_eval_metrics_match_jax(runs):
    ours, ref = runs["metrics"], runs["jmetrics"]
    assert set(ours) == set(ref) == {"test"}
    assert set(ours["test"]) == set(ref["test"])
    for key, value in ref["test"].items():
        assert abs(ours["test"][key] - value) <= EVAL_TOL, key
    logged = [r for r in _records(runs["pdir"]) if "test/map_level0" in r]
    assert [r["step"] for r in logged] == [EPOCHS] and logged[0]["test/eval_seconds"] > 0


def test_loop_final_parameters_match_jax(runs):
    jstate = runs["jstate"]
    ref = from_jax_variables({"params": jstate.params, "batch_stats": jstate.batch_stats})
    start = runs["start"]
    n = EPOCHS * STEPS_PER_EPOCH
    moved = 0
    for name, p in runs["state"].model.named_parameters():
        ours = p.detach().numpy()
        diff = np.abs(ours - ref[name])
        assert np.all(diff <= n * 2 * LR * (1 + WD * np.abs(start[name]))), name
        if not name.endswith(EXACT_ZEROS):  # their gradients are rounding noise
            close = n * (1e-3 * LR + np.spacing(np.abs(ref[name])))
            assert np.mean(diff > close) <= 0.01, name
            moved += int(np.any(ours != start[name]))
    assert moved > 0
    for buf in ("hash_head.bn.running_mean", "hash_head.bn.running_var"):
        ours = runs["state"].model.state_dict()[buf].numpy()
        np.testing.assert_allclose(ours, ref[buf], atol=1e-5, rtol=1e-5, err_msg=buf)


def test_loop_xbm_matches_jax(runs):
    """The memory after both runs: the same slots filled with the same
    labels, one slot per distinct index inserted, and each slot's last
    insert (training-mode logits) within 1e-3 of the largest: the hash
    head's BatchNorm divides by the standard deviation of 6 samples, which
    carries the parameters' drift into every logit."""
    ours, ref = runs["state"].xbm_state, runs["jstate"].xbm
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(ours.labels.numpy(), np.asarray(ref.labels))
    emb, emb_ref = ours.embeddings.numpy(), np.asarray(ref.embeddings)
    assert np.abs(emb - emb_ref).max() <= 1e-3 * np.abs(emb_ref).max()
    sampler = RandomSampler(range(N_TRAIN), BATCH, seed=0)
    seen = set()
    for epoch in range(1, EPOCHS + 1):
        for b in sampler.reshuffle(epoch).batches[:STEPS_PER_EPOCH]:
            seen.update(b.tolist())
    assert int(ours.valid.sum()) == len(seen) and int(ours.ptr) == int(ref.ptr)


def test_loop_checkpoint_layout(runs):
    """The JAX layout after ``finalize_checkpoints``, and the last save's
    meta: its epoch, the eval's principal metric as score and best score."""
    weights = runs["pdir"] / "weights"
    assert sorted(p.name for p in weights.iterdir()) == ["epoch_1", "epoch_2", "rolling"]
    jweights = runs["jdir"] / "weights"
    assert sorted(p.name for p in jweights.iterdir()) == ["epoch_1", "epoch_2", "rolling"]
    meta = torch.load(weights / "rolling", weights_only=True)["meta"]
    score = runs["metrics"]["test"]["map_level0"]
    assert meta == {"config": CONFIG, "epoch": EPOCHS, "score": score, "best_score": score}
    first = torch.load(weights / "epoch_1", weights_only=True)["meta"]
    assert first["epoch"] == 1 and first["score"] is None and first["best_score"] is None


def test_resume_equals_uninterrupted_bit_for_bit(runs, tmp_path):
    """A fresh state resumed from the uninterrupted run's ``epoch_1`` trains
    epoch 2 to the uninterrupted run's parameters, metrics and memory, bit
    for bit."""
    resumed = tmp_path / "resumed"
    (resumed / "weights").mkdir(parents=True)
    shutil.copyfile(runs["pdir"] / "weights" / "epoch_1", resumed / "weights" / "rolling")
    # other generator seeds: the checkpoint restores them
    state = _port_state(runs["start"], runs["start_proxies"], seed=5)
    meta = maybe_resume(state, str(resumed))
    assert meta["epoch"] == 1 and state.epoch == 1 and state.step == STEPS_PER_EPOCH
    ds = SyntheticVOCDataset(num_train=N_TRAIN, image_size=IMG, seed=4)
    state, _ = train(state, ds, RandomSampler(ds, BATCH, seed=0), {}, None,
                     DeviceTransform(OPS, device="cpu"), CONFIG, str(resumed))
    full = runs["state"]
    for (name, a), b in zip(state.model.state_dict().items(), full.model.state_dict().values()):
        assert torch.equal(a, b), name
    for field in ("embeddings", "labels", "valid", "ptr"):
        assert torch.equal(getattr(state.xbm_state, field), getattr(full.xbm_state, field))
    assert torch.equal(state.losses[0][0].proxies, full.losses[0][0].proxies)
    ours = [r for r in _records(resumed) if "train/total_loss" in r]
    ref = [r for r in _records(runs["pdir"]) if "train/total_loss" in r]
    assert [r["step"] for r in ours] == [EPOCHS]
    for name in METRICS:
        assert ours[0][f"train/{name}"] == ref[-1][f"train/{name}"], name



@pytest.mark.parametrize("unique", [True, False])
def test_xbm_buffer_matches_jax(unique):
    """Five inserts of batch 6 into a memory of 14 slots (the ring wraps;
    the table maps indices past its size onto earlier slots), both packages
    fed the same embeddings, multi-label labels and indices."""
    rng = np.random.RandomState(3)
    ours, ref = XBM(14, 8, (20,), unique=unique), JaxXBM(14, 8, (20,), unique=unique)
    state, jstate = ours.init(), ref.init()
    for _ in range(5):
        emb = rng.randn(6, 8).astype(np.float32)
        labels = (rng.rand(6, 20) > 0.8).astype(np.float32)
        index = rng.choice(30, 6, replace=False)
        state = ours.update(state, torch.from_numpy(emb), torch.from_numpy(labels),
                            torch.from_numpy(index))
        jstate = ref.update(jstate, jnp.asarray(emb), jnp.asarray(labels), jnp.asarray(index))
    for a, b in zip(ours.contents(state), ref.contents(jstate)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(state.ptr) == int(jstate.ptr) == 30 % 14


def _state(model, xbm=None):
    opt_cfg, loss_cfg = _configs()
    return init_train_state(model, build_losses(loss_cfg), opt_cfg, loss_cfg, xbm=xbm)


def _tiny_state(xbm=None):
    """The loop's control flow needs no width: a test_tiny backbone on
    TINY_IMG² images."""
    return _state(get_model("multidino_attention_hashing", device="cpu", backbone="test_tiny",
                            frozen_backbone=False, vit_kwargs={"img_size": TINY_IMG},
                            fusion_config={"type": "cross_attention_advanced",
                                           "output_dim": 64, "num_heads": 2}), xbm)


def _tiny_data(n=N_TRAIN):
    return SyntheticVOCDataset(num_train=n, image_size=TINY_IMG, seed=4)


def test_xbm_is_inert_for_hashloss():
    """The flagship's step with ``memory=voc``'s kind of memory on
    (unique, active) and without it: the same metrics and parameters, bit
    for bit, over two steps; the memory holds the batch."""
    ds = SyntheticVOCDataset(num_train=N_TRAIN, image_size=IMG, seed=4)
    memory = XBM(size=N_TRAIN, embedding_dim=64, label_shape=(20,), activate_after=1)
    name, kw = _model_kwargs()
    model = get_model(name, device="cpu", **dict(kw, vit_kwargs=dict(kw["vit_kwargs"],
                                                                     img_size=IMG)))
    states = [_state(copy.deepcopy(model), xbm=memory), _state(model)]
    steps = [build_train_step(DeviceTransform(OPS, device="cpu"), xbm=memory, xbm_active=True),
             build_train_step(DeviceTransform(OPS, device="cpu"))]
    metrics = [[], []]
    for i in range(2):
        index = np.arange(i * BATCH, (i + 1) * BATCH)
        batch = {"image": ds.images[index], "label": ds.labels[index], "index": index}
        for state, step, out in zip(states, steps, metrics):
            out.append(step(state, batch, _build_hyper(state.optimizer_entries, 1, state.step,
                                                       0, None)))
    for a, b in zip(*metrics):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    with_memory, without = (s.model.state_dict() for s in states)
    for name, value in with_memory.items():
        assert torch.equal(value, without[name]), name
    assert torch.equal(states[0].losses[0][0].proxies, states[1].losses[0][0].proxies)
    held = states[0].xbm_state
    assert held.valid.tolist() == [True] * (2 * BATCH) + [False] * (N_TRAIN - 2 * BATCH)
    np.testing.assert_array_equal(held.labels[:2 * BATCH].numpy(), ds.labels[:2 * BATCH])


def test_memory_before_activate_after_only_takes_inserts():
    """Before ``activate_after`` the step inserts and no loss reads the
    memory, so a ref-aware loss trains as it would without one (with the
    memory on it raises naming A11b: ``tests/test_torch_train_step.py``)."""
    memory = XBM(size=N_TRAIN, embedding_dim=64, label_shape=(20,))
    state = _tiny_state(xbm=memory)
    state.losses.append((_RefAwareLoss(), 1.0))
    ds = _tiny_data(BATCH)
    batch = {"image": ds.images, "label": ds.labels, "index": np.arange(BATCH)}
    hyper = _build_hyper(state.optimizer_entries, 1, 0, 0, None)
    metrics = build_train_step(DeviceTransform(OPS, device="cpu"), xbm=memory)(state, batch,
                                                                                hyper)
    assert "loss_1__RefAwareLoss" in metrics and torch.isfinite(metrics["total_loss"])
    assert int(state.xbm_state.valid.sum()) == BATCH


REFUSALS = {
    "instrumentor": ({}, {"instrumentor": object()}, "A12"),
    "with_fast_eval": ({"with_fast_eval": True}, {}, "A12"),
    "freeze_batch_norm": ({}, {"model": {"freeze_batch_norm": True}}, "A12"),
    "freeze_pos_embedding": ({}, {"model": {"freeze_pos_embedding": True}}, "A12"),
    "sub_batch": ({"sub_batch": 3}, {}, "A12"),
    "model_parallel": ({"model_parallel": 2}, {}, "A13"),
    "band_parallel": ({"band_parallel": 2}, {}, "A13"),
    "pipeline_parallel": ({"pipeline_parallel": 4}, {}, "A13"),
    "host_transform": ({}, {"host_transform": object()}, "A8b"),
}


@pytest.mark.parametrize("option", sorted(REFUSALS))
def test_unported_loop_options_name_their_roadmap_item(option, tmp_path):
    exp, extra, item = REFUSALS[option]
    config = {"experience": dict(CONFIG["experience"], **exp), "model": extra.get("model", {})}
    ds = _tiny_data()
    state = _tiny_state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with pytest.raises(NotImplementedError, match=item):
        train(state, ds, RandomSampler(ds, BATCH, seed=0), {}, extra.get("host_transform"),
              DeviceTransform(OPS, device="cpu"), config, str(tmp_path),
              instrumentor=extra.get("instrumentor"))
    assert state.step == 0 and all(torch.equal(v, before[k])
                                   for k, v in state.model.state_dict().items())


def test_mesh_keys_at_one_are_ignored(tmp_path):
    """``use_mesh`` and the parallel degrees at 1 train on the one device."""
    exp = dict(CONFIG["experience"], use_mesh=True, model_parallel=1, band_parallel=1,
               pipeline_parallel=1, max_iter=1, step_per_epoch=1, test_eval_freq=-1,
               async_checkpoint=False)
    ds = _tiny_data()
    state, metrics = train(_tiny_state(), ds, RandomSampler(ds, BATCH, seed=0), {}, None,
                           DeviceTransform(OPS, device="cpu"), {"experience": exp}, str(tmp_path))
    assert state.step == 1 and state.epoch == 1 and metrics == {}
    assert (tmp_path / "weights" / "rolling").exists()


def test_profile_epoch_and_plateau(tmp_path):
    """``profile_epoch`` writes a torch.profiler trace of that epoch; an
    entry's plateau scheduler is fed its key from every eval of
    ``eval_split`` (the principal metric when the key is not a metric)."""
    opt_cfg, _ = _configs()
    plateau = {"name": "ReduceLROnPlateau", "key": "map_level0",
               "kwargs": {"mode": "max", "patience": 0, "factor": 0.5}}
    opt_cfg = [dict(opt_cfg[0], scheduler_on_val=plateau)]
    state = _tiny_state()
    state.optimizer_entries = optimizers.build_optimizers(opt_cfg, state.model)
    exp = dict(CONFIG["experience"], profile_epoch=2, max_iter=2, step_per_epoch=1,
               test_eval_freq=1, async_checkpoint=False)
    ds = _tiny_data()
    seen = []
    entry = state.optimizer_entries[0]
    update = entry.plateau.update
    entry.plateau.update = lambda value: seen.append(value) or update(value)
    state, metrics = train(state, ds, RandomSampler(ds, BATCH, seed=0), {"test": ds}, None,
                           DeviceTransform(OPS, device="cpu"), {"experience": exp}, str(tmp_path))
    logged = [r["test/map_level0"] for r in _records(tmp_path) if "test/map_level0" in r]
    assert len(seen) == 2 and seen == logged and seen[-1] == metrics["test"]["map_level0"]
    assert [p.name for p in (tmp_path / "profile").iterdir()] == ["epoch_2.json"]


def test_chip_smoke_memory_equals_voc_yaml():
    """``chip_smoke.py``'s inlined ``memory=voc`` (the card has no PyYAML)."""
    import chip_smoke

    with open(YAML.parents[1] / "memory/voc.yaml") as f:
        assert chip_smoke.MEMORY == yaml.safe_load(f)


@pytest.mark.parametrize("preset", ["cub", "default", "inaturalist", "sop", "synthetic", "voc"])
def test_get_memory_matches_jax(preset):
    """Every ``configs/memory`` preset gives the memory the JAX getter gives."""
    with open(YAML.parents[1] / f"memory/{preset}.yaml") as f:
        cfg = yaml.safe_load(f)
    ours, ref = get_memory(cfg, 64, (20,)), Getter().get_memory(cfg, 64, (20,))
    assert (ours is None) == (ref is None) == (preset == "default")
    if ours is not None:
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
