"""The WCNN CE training path on both packages: ``wcnn_attention_ce`` with
resnet18 branches and a CBAM gate, five classes, trained with
``configs/loss/multi_ce_fusionloss.yaml`` (label smoothing 0.1; its
``weights:`` key swallowed, so every branch weighs 1) and
``configs/optimizer/ce_opt.yaml`` (SGD, Nesterov, weight decay 5e-4,
``MultiStepLR``), on 32² uint8 images through ``configs/transform/cub_dwt.yaml``'s
device ops (Normalize, then the haar DWT: 16² subbands), batch 8, labels in
[0, 8): three of the eight classes lie past the model's five, so their
one-hot rows are zero.

Same weights through the bridge, with BatchNorm statistics, biases and the
zero-initialised classifiers redrawn (otherwise the first step's branch
gradients are trivially equal).  Two ``build_train_step`` steps, each from
the JAX parameters; then one ``engine.train`` epoch of two steps against
the JAX ``train``.

Tolerances (f32, other summation orders): the metrics to 1e-5 relative;
the updated parameters to the SGD step's learning rate times 1e-3 of the
leaf's largest gradient, plus one f32 rounding of the parameter (training
BatchNorm over the few values of the last stage's 1 × 1 maps is
ill-conditioned, as in ``tests/test_torch_wcnn.py``: the deepest blocks'
gradients differ by up to 1.6e-4 of their largest entry); the BatchNorm
statistics to 1e-5.  The epoch cannot restart its second step from the JAX
parameters, and at ce_opt's LR of 0.09 the first step's rounding grows past
1e-5 in the second; so the epoch trains with ``configs/optimizer/cub_wresnet.yaml``
(Adam at 1e-5, the CUB recipe), as the loop test trains at basic.yaml's 1e-5.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from irw_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from irw_tpu.engine import optimizers as jax_optimizers
from irw_tpu.engine.train import _build_hyper as jax_build_hyper
from irw_tpu.engine.train import train as jax_train
from irw_tpu.engine.train_step import build_train_step as jax_build_train_step
from irw_tpu.getter import Getter
from irw_tpu.losses import build_losses as jax_build_losses
from irw_tpu.models import get_model as jax_get_model
from irw_tpu.samplers import RandomSampler as JaxRandomSampler
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu.transforms.pipeline import HostTransform
from irw_tpu_torch.bridge import from_jax_variables, load_jax_variables
from irw_tpu_torch.data import SyntheticDataset
from irw_tpu_torch.engine import build_train_step, init_train_state, train
from irw_tpu_torch.engine.train import _build_hyper
from irw_tpu_torch.losses import build_losses
from irw_tpu_torch.models import get_model
from irw_tpu_torch.samplers import RandomSampler
from irw_tpu_torch.transforms import DeviceTransform
from test_torch_loop import _records
from test_torch_resnet import randomize_all
from test_torch_train_step import _yaml, jax_state_from

IMG, BATCH, STEPS, CLASSES, LABELS = 32, 8, 2, 5, 8
MODEL = {"backbone": "resnet18", "num_classes": CLASSES, "attention": "cbam"}
METRIC_TOL = 1e-5
# BatchNorm over the 8 values of the last stage's 1 × 1 maps is ill-conditioned:
# the deepest blocks' gradients differ by up to 1.6e-4 of their largest entry
UPDATE_TOL = 1e-3
METRICS = ("total_loss", "loss_0_MultiCrossEntropyLoss", "grad_norm", "batch_map", "ortho_loss",
           "ortho_raw")
CONFIG = {"experience": {
    "max_iter": 1, "step_per_epoch": STEPS, "seed": 0, "num_workers": 0, "train_eval_freq": -1,
    "test_eval_freq": -1, "eval_split": "test", "warm_up": 0, "checkpoint_freq": 1,
    "async_checkpoint": False, "use_mesh": False, "evaluation": {"distance_metric": "cosine"}}}


def _configs(optimizer="ce_opt"):
    opt_cfg, loss_cfg = _yaml(f"optimizer/{optimizer}.yaml"), _yaml("loss/multi_ce_fusionloss.yaml")
    assert loss_cfg[0]["kwargs"]["weights"] == [0.75, 0.75, 0.75, 0.75, 2.0]
    return opt_cfg, loss_cfg


def _variables(jstate):
    return {"params": jstate.params, "batch_stats": jstate.batch_stats}


@pytest.fixture(scope="module", autouse=True)
def _no_tensorboard():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


@pytest.fixture(scope="module")
def start():
    """The JAX model, losses, optimizer entries and a state with redrawn
    weights; the datasets of both packages."""
    opt_cfg, loss_cfg = _configs()
    ds = SyntheticDataset(num_samples=BATCH * STEPS, num_classes=LABELS, image_size=IMG, seed=6)
    jds = JaxSyntheticDataset(num_samples=BATCH * STEPS, num_classes=LABELS, image_size=IMG,
                              seed=6)
    np.testing.assert_array_equal(ds.images, jds.images)
    assert ds.labels.max() >= CLASSES
    jmodel = jax_get_model("wcnn_attention_ce", **MODEL)
    jdt = JaxDeviceTransform(chip_smoke.DWT_OPS)
    batch = {"image": ds.images[:BATCH], "label": ds.labels[:BATCH]}
    variables = jax.jit(lambda r, x: jmodel.init(r, x, train=True))(
        {"params": jax.random.PRNGKey(0)}, jdt(jnp.asarray(batch["image"])))
    variables = randomize_all(variables, 3)
    jlosses = jax_build_losses(loss_cfg)
    entries = jax_optimizers.build_optimizers(opt_cfg, variables["params"])
    loss_tx = Getter().get_loss_optimizer(loss_cfg)
    jstate = jax_state_from(variables, jlosses, entries, loss_tx)
    return {"jmodel": jmodel, "jlosses": jlosses, "entries": entries, "loss_tx": loss_tx,
            "jstate": jstate, "jdt": jdt, "ds": ds, "jds": jds}


def _port_state(variables, optimizer="ce_opt"):
    opt_cfg, loss_cfg = _configs(optimizer)
    model = get_model("wcnn_attention_ce", device="cpu", **MODEL)
    load_jax_variables(model, variables)
    return init_train_state(model, build_losses(loss_cfg), opt_cfg, loss_cfg, seed=0)


@pytest.fixture(scope="module")
def steps(start):
    """STEPS steps on both packages, each from the JAX state; the port's
    parameters and gradients after each."""
    jstate, ds = start["jstate"], start["ds"]
    jstep = jax.jit(jax_build_train_step(start["jmodel"], start["jlosses"], start["entries"],
                                         start["loss_tx"], device_transform=start["jdt"]))
    state = _port_state(_variables(jstate))
    step = build_train_step(DeviceTransform(chip_smoke.DWT_OPS, device="cpu"))
    jstates, jmetrics, metrics, updated, grads = [jstate], [], [], [], []
    for i in range(STEPS):
        batch = {"image": ds.images[i * BATCH:(i + 1) * BATCH],
                 "label": ds.labels[i * BATCH:(i + 1) * BATCH]}
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax_build_hyper(start["entries"], 1, i, 0, None))
        jstates.append(jstate)
        jmetrics.append({k: float(v) for k, v in m.items()})
        metrics.append({k: float(v) for k, v in step(
            state, batch, _build_hyper(state.optimizer_entries, 1, state.step, 0, None)).items()})
        updated.append({k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()})
        grads.append({n: p.grad.numpy().copy() for n, p in state.model.named_parameters()})
        load_jax_variables(state.model, _variables(jstate))
    return jstates, jmetrics, metrics, updated, grads


def test_wcnn_ce_step_metrics_match_jax(steps):
    _, jmetrics, metrics, _, _ = steps
    for i, (ours, ref) in enumerate(zip(metrics, jmetrics)):
        assert set(ours) == set(ref)
        for name in METRICS:
            assert ours[name] == pytest.approx(ref[name], rel=METRIC_TOL, abs=1e-7), (i, name)
        # batch_map reads the first branch's logits: not 0, as for a list it once was said to be
        assert 0.0 < ours["batch_map"] <= 1.0


@pytest.mark.parametrize("i", range(STEPS))
def test_wcnn_ce_step_updates_match_jax(steps, i):
    """Step i from the JAX parameters: SGD moves a parameter by lr times its
    gradient (with momentum and decay), so each leaf's update is held to
    lr · UPDATE_TOL of its largest gradient; the BatchNorm statistics move."""
    jstates, _, _, updated, grads = steps
    start, ref = (from_jax_variables(_variables(s)) for s in jstates[i:i + 2])
    lr = 0.09
    for name, value in updated[i].items():
        if name in grads[i]:
            g = np.abs(grads[i][name]).max()
            assert g > 0, name
            tol = lr * UPDATE_TOL * g + np.abs(start[name]) * np.finfo(np.float32).eps
            np.testing.assert_array_less(np.abs(value - ref[name]), tol + 1e-12, err_msg=name)
            assert not np.array_equal(value, start[name]), name
        elif name.endswith(("running_mean", "running_var")):
            assert not np.array_equal(value, start[name]), name
            np.testing.assert_allclose(value, ref[name], rtol=1e-5, atol=1e-5, err_msg=name)


def test_wcnn_ce_epoch_matches_jax_train(start, tmp_path):
    """One epoch of two steps through both packages' ``train``: the epoch's
    metric names and means, ``batch_map`` among them."""
    jstate = start["jstate"]
    opt_cfg, _ = _configs("cub_wresnet")
    entries = jax_optimizers.build_optimizers(opt_cfg, jstate.params)
    jstate = jstate.replace(opt_states={e.name: e.tx.init(jstate.params) for e in entries})
    state = _port_state(_variables(jstate), "cub_wresnet")
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jds, ds = start["jds"], start["ds"]
    jax_train(start["jmodel"], jstate, start["jlosses"], entries, start["loss_tx"], jds,
              JaxRandomSampler(jds, BATCH, seed=0), {}, HostTransform([("Resize", {"size": IMG})]),
              start["jdt"], CONFIG, str(jdir))
    state, _ = train(state, ds, RandomSampler(ds, BATCH, seed=0), {}, None,
                     DeviceTransform(chip_smoke.DWT_OPS, device="cpu"), CONFIG, str(pdir))
    assert state.step == STEPS
    ours = [r for r in _records(pdir) if "train/total_loss" in r]
    ref = [r for r in _records(jdir) if "train/total_loss" in r]
    assert len(ours) == len(ref) == 1
    names = {k for k in ref[0] if not k.endswith("_seconds")}
    assert names == {k for k in ours[0] if not k.endswith("_seconds")}
    for key in names - {"step"}:
        assert ours[0][key] == pytest.approx(ref[0][key], rel=METRIC_TOL, abs=1e-7), key
    assert ours[0]["train/batch_map"] > 0.0


@pytest.mark.parametrize("name,path", [
    ("WCNN_CE_LOSS", "loss/multi_ce_fusionloss.yaml"), ("CUB_WRESNET", "optimizer/cub_wresnet.yaml"),
    ("ROADMAP_LOSS", "loss/roadmap.yaml"), ("CUB_MEMORY", "memory/cub.yaml"),
    ("CUB_OPTIMIZER", "optimizer/cub.yaml"), ("WCNN_EMB", "model/wcnn_attention.yaml")])
def test_chip_smoke_train_configs_match_the_yaml(name, path):
    """``chip_smoke.py``'s inlined configs of its WCNN training phases are the files'."""
    assert getattr(chip_smoke, name) == _yaml(path)
    assert chip_smoke.CUB_BATCH == _yaml("dataset/cub.yaml")["sampler"]["kwargs"]["batch_size"]
    assert chip_smoke.CUB_CLASSES == _yaml("dataset/cub.yaml")["num_classes"]
