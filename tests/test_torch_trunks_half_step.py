"""One ``build_train_step`` step of the bfloat16 ``wcnn_attention_ce``
through both packages (the ``+model.kwargs.dtype=bfloat16`` override is
``tests/test_torch_trunks_half_config.py``'s).

The step: resnet18-style branches (basic blocks) at width 8 and one block a
stage (``tests/test_torch_wavenets.py``'s narrow trunk, in both packages),
a CBAM gate, five classes,
``configs/loss/multi_ce_fusionloss.yaml`` and ``configs/optimizer/ce_opt.yaml``
(SGD, Nesterov, weight decay) on 32² uint8 images through ``cub_dwt``'s
device ops (Normalize, then the haar DWT), batch 8, as
``tests/test_torch_wcnn_train.py`` runs it in float32 (weights from
``numpy_init``, the classifiers redrawn).  JAX runs the step in bfloat16, the port in float32 and in
bfloat16; the float32 step stands for JAX's, which
``tests/test_torch_wcnn_train.py`` holds it to (within 1e-3 of the SGD
step of each leaf's largest gradient; a second JAX compile would double
the file's time).  The bound is the one
``tests/test_torch_trunks_half_models.py`` derives: the port's bf16 step
no further from the f32 step than JAX's bf16 step is, times MARGIN (the
metrics, the statistics) or GRAD_MARGIN (each parameter's update, in L2
norm), floored at one bf16 ulp.  The
parameters, the gradients and the optimizer's state stay float32 in both
packages (flax's ``param_dtype``; optax keeps the parameters' dtype).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from irw_tpu.engine import optimizers as jax_optimizers
from irw_tpu.engine.train import _build_hyper as jax_build_hyper
from irw_tpu.engine.train_step import build_train_step as jax_build_train_step
from irw_tpu.getter import Getter as JaxGetter
from irw_tpu.losses import build_losses as jax_build_losses
from irw_tpu.models import get_model as jax_get_model
from irw_tpu.models import wresnet as jax_wresnet
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu_torch.bridge import from_jax_variables, load_jax_variables
from irw_tpu_torch.data import SyntheticDataset
from irw_tpu_torch.engine import build_train_step, init_train_state
from irw_tpu_torch.engine.train import _build_hyper
from irw_tpu_torch.losses import build_losses
from irw_tpu_torch.models import MODEL_REGISTRY, wresnet
from irw_tpu_torch.models.resnet import BatchNorm, Conv2d
from irw_tpu_torch.transforms import DeviceTransform
from test_torch_fusion_heads import numpy_init
from test_torch_resnet import randomize_all
from test_torch_train_step import jax_state_from
from test_torch_trunks_half_models import GRAD_MARGIN, MARGIN
from test_torch_wavenets import BandedResNet, NarrowBandedResNet
from test_torch_wcnn_train import BATCH, IMG, LABELS, MODEL, _configs

EPS = float(torch.finfo(torch.bfloat16).eps)


@pytest.fixture(scope="module", autouse=True)
def _narrow():
    """Both packages' WCNN branches at width 8, one block a stage; no
    TensorBoard import."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setattr(jax_wresnet, "BandedResNet", BandedResNet)
        mp.setattr(wresnet, "BandedResNet", NarrowBandedResNet)
        yield


def _port_step(variables, dtype, batch):
    opt_cfg, loss_cfg = _configs()
    # every parameter and statistic comes from ``variables``: no draw of its own
    model = MODEL_REGISTRY["wcnn_attention_ce"](torch.device("cpu"), **MODEL, dtype=dtype)
    load_jax_variables(model, variables)
    state = init_train_state(model, build_losses(loss_cfg), opt_cfg, loss_cfg, seed=0)
    step = build_train_step(DeviceTransform(chip_smoke.DWT_OPS, device="cpu"))
    metrics = step(state, batch, _build_hyper(state.optimizer_entries, 1, state.step, 0, None))
    return state, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def steps():
    """One step from the same state: JAX in bfloat16, the port in float32
    and in bfloat16; each package's state after it."""
    opt_cfg, loss_cfg = _configs()
    ds = SyntheticDataset(num_samples=BATCH, num_classes=LABELS, image_size=IMG, seed=6)
    batch = {"image": ds.images[:BATCH], "label": ds.labels[:BATCH]}
    jdt = JaxDeviceTransform(chip_smoke.DWT_OPS)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_get_model("wcnn_attention_ce", **MODEL, dtype="bfloat16")
    variables = randomize_all(numpy_init(jmodel, jdt(jbatch["image"]), seed=3, train=True), 3)
    jlosses = jax_build_losses(loss_cfg)
    entries = jax_optimizers.build_optimizers(opt_cfg, variables["params"])
    loss_tx = JaxGetter().get_loss_optimizer(loss_cfg)
    jstate = jax_state_from(variables, jlosses, entries, loss_tx)
    jstep = jax.jit(jax_build_train_step(jmodel, jlosses, entries, loss_tx, device_transform=jdt))
    jstate, m = jstep(jstate, jbatch, jax_build_hyper(entries, 1, 0, 0, None))
    return (variables, (jstate, {k: float(v) for k, v in m.items()}),
            _port_step(variables, "float32", batch), _port_step(variables, "bfloat16", batch))


def _flat(jstate):
    return from_jax_variables({"params": jstate.params, "batch_stats": jstate.batch_stats})


def test_bf16_step_metrics_held_to_jax(steps):
    """The continuous metrics; ``batch_map`` ranks the bf16 logits, where
    one rounding can swap two neighbours, and ``ortho_*`` are 0 here."""
    _, (_, ref16), (_, ref32), (_, metrics) = steps
    assert set(metrics) == set(ref16) == set(ref32)
    for name in ("total_loss", "loss_0_MultiCrossEntropyLoss", "grad_norm"):
        gap = max(abs(ref16[name] - ref32[name]), EPS * abs(ref32[name]))
        assert abs(metrics[name] - ref32[name]) <= MARGIN * gap, (name, metrics[name],
                                                                  ref16[name], ref32[name])
    # chip_smoke.py holds the card's first bf16 step to HALF_LOSS_REL of the
    # f32 step's: at least five times the gap JAX's own bf16 step shows here
    rel = abs(ref16["total_loss"] - ref32["total_loss"]) / abs(ref32["total_loss"])
    assert 5 * rel <= chip_smoke.HALF_LOSS_REL, rel


def test_bf16_step_updates_and_statistics_held_to_jax(steps):
    """Each parameter's move from the start (L2 norm) and each running
    statistic (max-abs) against the f32 step, JAX's bf16 step the yardstick."""
    variables, (jstate, _), (state32, _), (state, _) = steps
    start = from_jax_variables(variables)
    ref16 = _flat(jstate)
    ref32 = {k: v.numpy() for k, v in state32.model.state_dict().items()}
    sd = state.model.state_dict()
    params = dict(state.model.named_parameters())
    assert set(params) < set(ref32) == set(ref16)
    for key, r32 in ref32.items():
        ours = sd[key].numpy()
        if key in params:
            move32, move16 = r32 - start[key], ref16[key] - start[key]
            gap = max(float(np.linalg.norm(move16 - move32)), EPS * float(np.linalg.norm(move32)))
            assert float(np.linalg.norm(ours - start[key] - move32)) <= GRAD_MARGIN * gap, key
        elif key.endswith(("running_mean", "running_var")):
            gap = max(float(np.abs(ref16[key] - r32).max()), EPS * float(np.abs(r32).max()))
            assert float(np.abs(ours - r32).max()) <= MARGIN * gap, key


def test_bf16_step_keeps_float32_parameters_and_optimizer_state(steps):
    _, (jstate, _), _, (state, _) = steps
    model = state.model
    assert {m.dtype for m in model.modules() if isinstance(m, (Conv2d, BatchNorm))} \
        == {torch.bfloat16}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {p.grad.dtype for p in model.parameters() if p.grad is not None} == {torch.float32}
    assert {b.dtype for b in model.buffers() if b.is_floating_point()} == {torch.float32}
    opt_state = [t for entry in state.optimizer_entries
                 for s in entry.optimizer.state.values() for t in s.values()
                 if isinstance(t, torch.Tensor) and t.is_floating_point()]
    assert opt_state and {t.dtype for t in opt_state} == {torch.float32}
    leaves = jax.tree_util.tree_leaves((jstate.params, jstate.opt_states))
    assert {str(a.dtype) for a in leaves if jnp.issubdtype(a.dtype, jnp.floating)} == {"float32"}
