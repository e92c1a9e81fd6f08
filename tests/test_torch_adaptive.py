"""The port's adaptive loss weighting against irw_tpu's (``adaptive_weights``
in ``build_train_step``: one forward, one pullback per entry of the loss
vector, each term weighted by mean(head norms) / its head norm).

One step of both packages from one state on three models at test width
(test_tiny towers of one block on 16² images, f32), each where the JAX
step's head scope resolves differently:

- ``hash_head``: ``multidino_attention_hashing`` (``HashHead_0``), HashLoss
  and CalibrationLoss at ``weight: adaptative`` with a 32-slot XBM memory
  (CalibrationLoss reads it: a memory term in the vector);
- ``every_leaf``: ``multidino_attention`` (no path holds a fallback name),
  ``configs/loss/roadmap_adaptative.yaml`` (CalibrationLoss and SupAP);
- ``fc``: ``RetrievalNet`` over vit_tiny with its ``fc`` projection,
  ``roadmap_adaptative.yaml`` (in ``test_torch_adaptive_fc.py``, so that
  each file keeps to its time).

Weights: ``numpy_init`` from ``jax.eval_shape`` (no init compile), carried by
the bridge; basic.yaml's AdamW at lr 1e-3.  Tolerances: the weights and the
metrics within 1e-5 relative; the parameters' moves as
``test_torch_train_step.py`` (1e-3·lr where the gradient is well
conditioned).  The head's parameters the port selects are the ones whose
flax leaves the JAX rule selects, carried by name through the bridge.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util

from irw_tpu.engine import optimizers as jax_optimizers
from irw_tpu.engine.train import _build_hyper as jax_build_hyper
from irw_tpu.engine.train_step import build_train_step as jax_build_train_step
from irw_tpu.engine.xbm import XBM as JaxXBM
from irw_tpu.getter import Getter
from irw_tpu.losses import build_losses as jax_build_losses
from irw_tpu.models import get_model as jax_get_model
from irw_tpu.models.retrieval_net import RetrievalNet as JaxRetrievalNet
from irw_tpu.models.vit import make_vit as jax_make_vit
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu_torch.bridge import from_jax_variables, load_jax_loss_params, load_jax_variables
from irw_tpu_torch.engine import XBM, build_train_step, init_train_state
from irw_tpu_torch.engine.train import _build_hyper
from irw_tpu_torch.engine.train_step import HEAD_FALLBACKS, head_parameter_names
from irw_tpu_torch.losses import build_losses
from irw_tpu_torch.models import get_model
from irw_tpu_torch.models.retrieval_net import RetrievalNet
from irw_tpu_torch.models.vit import make_vit
from irw_tpu_torch.transforms import DeviceTransform
from test_torch_fusion_heads import numpy_init
from test_torch_train_model import EXACT_ZEROS
from test_torch_train_step import _configs, _deltas_agree, jax_state_from, jstate_variables

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
IMG, BATCH, MEM, LR = 16, 8, 32, 1e-3
SWT = [("SWTTransform", {"level": 1, "wavelet": "haar"})]
FUSION = {"type": "cross_attention_advanced", "output_dim": 64, "num_heads": 2, "dropout": 0.0}
TINY = {"backbone": "test_tiny", "fusion_config": FUSION, "frozen_backbone": False,
        "vit_kwargs": {"depth": 1}}
TOL = 1e-5


def _loss_yaml(name):
    with open(CONFIGS / "loss" / f"{name}.yaml") as f:
        return yaml.safe_load(f)


HASH_CALIBRATION = [dict(_loss_yaml("hash_loss")[0], weight="adaptative"),
                    dict(_loss_yaml("roadmap_adaptative")[0])]


def _cases():
    return {
        "hash_head": dict(
            jax=lambda: jax_get_model("multidino_attention_hashing", **TINY),
            port=lambda: get_model("multidino_attention_hashing", device="cpu", **dict(
                TINY, vit_kwargs={"depth": 1, "img_size": IMG})),
            ops=SWT, loss=HASH_CALIBRATION, xbm=True, head=("hash_head.",)),
        "every_leaf": dict(
            jax=lambda: jax_get_model("multidino_attention", **TINY),
            port=lambda: get_model("multidino_attention", device="cpu", **dict(
                TINY, vit_kwargs={"depth": 1, "img_size": IMG})),
            ops=SWT, loss=_loss_yaml("roadmap_adaptative"), xbm=False, head=("",)),
        "fc": dict(
            jax=lambda: JaxRetrievalNet(backbone=jax_make_vit("vit_tiny", depth=1), embed_dim=24,
                                        projection_norm="ln"),
            port=lambda: RetrievalNet(make_vit("vit_tiny", depth=1, img_size=IMG), embed_dim=24,
                                      projection_norm="ln"),
            ops=[], loss=_loss_yaml("roadmap_adaptative"), xbm=False, head=("fc.",)),
    }


def _batch():
    rng = np.random.RandomState(5)
    labels = np.eye(20, dtype=np.float32)[rng.randint(0, 4, BATCH)]  # positives and negatives
    labels[:, 4:] = (rng.rand(BATCH, 16) > 0.9)
    return {"image": rng.randint(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8),
            "label": labels, "index": np.arange(BATCH, dtype=np.int32) + MEM - BATCH // 2}


def _memory_fill(dim):
    rng = np.random.RandomState(9)
    emb = rng.randn(MEM, dim).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb, (rng.rand(MEM, 20) > 0.8).astype(np.float32)


# irw_tpu's fallback keys, in its order (irw_tpu/engine/train_step.py, ``head_norm``)
JAX_FALLBACKS = ("HashHead", "hash_fc", "fc", "head", "projection")


def test_head_fallbacks_are_irw_tpus():
    assert HEAD_FALLBACKS == JAX_FALLBACKS


def _jax_head_key(names, key="HashHead"):
    """The JAX step's ``head_norm`` key resolution over flax leaf names."""
    if any(key in n for n in names):
        return key
    return next((c for c in JAX_FALLBACKS if any(c in n for n in names)), "")


_PAIRS = {}


def _pair(case):
    """One adaptive step of both packages at ``case``, built once."""
    if case in _PAIRS:
        return _PAIRS[case]
    c = _cases()[case]
    batch = _batch()
    jdt = JaxDeviceTransform(c["ops"]) if c["ops"] else None
    x = jdt(jnp.asarray(batch["image"])) if jdt else jnp.asarray(batch["image"]) / 255.0
    jmodel = c["jax"]()
    variables = numpy_init(jmodel, x, seed=3, train=True)
    opt_cfg, _ = _configs()
    loss_cfg = c["loss"]
    jlosses = jax_build_losses(loss_cfg)
    entries = jax_optimizers.build_optimizers(opt_cfg, variables["params"])
    loss_tx = Getter().get_loss_optimizer(loss_cfg)
    model = c["port"]()
    load_jax_variables(model, variables)
    dim = int(model.train()(DeviceTransform(c["ops"], device="cpu")(batch["image"])
                            if c["ops"] else torch.from_numpy(batch["image"]).float() / 255)[0]
              .shape[-1])
    jxbm = JaxXBM(size=MEM, embedding_dim=dim, label_shape=(20,), weight=0.5) if c["xbm"] \
        else None
    jstate = jax_state_from(variables, jlosses, entries, loss_tx, xbm=jxbm)
    xbm = XBM(size=MEM, embedding_dim=dim, label_shape=(20,), weight=0.5) if c["xbm"] else None
    load_jax_variables(model, variables)  # the probe above moved the running statistics
    state = init_train_state(model, build_losses(loss_cfg), opt_cfg, loss_cfg, seed=0, xbm=xbm)
    load_jax_loss_params(state.losses, jstate.loss_params)
    if c["xbm"]:
        emb, labels = _memory_fill(dim)
        jstate = jstate.replace(xbm=jxbm.update(jstate.xbm, jnp.asarray(emb),
                                                jnp.asarray(labels), jnp.arange(MEM)))
        state.xbm_state = xbm.update(state.xbm_state, torch.from_numpy(emb),
                                     torch.from_numpy(labels), torch.arange(MEM))
    jstep = jax.jit(jax_build_train_step(jmodel, jlosses, entries, loss_tx, xbm=jxbm,
                                         xbm_active=c["xbm"], device_transform=jdt,
                                         adaptive_weights=True))
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                     jax_build_hyper(entries, 1, 0, 0, None))
    step = build_train_step(DeviceTransform(c["ops"], device="cpu") if c["ops"] else None,
                            xbm=xbm, xbm_active=c["xbm"], adaptive_weights=True)
    metrics = step(state, batch, _build_hyper(state.optimizer_entries, 1, 0, 0, None))
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
             if p.grad is not None}
    _PAIRS[case] = (jstate, jnew, {k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in metrics.items()}, state, grads, variables)
    return _PAIRS[case]


CASES = ["hash_head", "every_leaf"]


@pytest.mark.parametrize("case", CASES)
def test_adaptive_weights_match_jax(case):
    check_weights(case)


@pytest.mark.parametrize("case", CASES)
def test_adaptive_updates_match_jax(case):
    check_updates(case)


@pytest.mark.parametrize("case", CASES)
def test_head_parameters_are_the_leaves_jax_selects(case):
    check_head(case)


def check_weights(case):
    jstate, jnew, jm, metrics, state, grads, _ = _pair(case)
    assert set(metrics) == set(jm), set(metrics) ^ set(jm)
    n_terms = len([k for k in jm if k.startswith("adaptive_weight_")])
    assert n_terms == (3 if case == "hash_head" else 2)
    for key in sorted(jm):
        assert metrics[key] == pytest.approx(jm[key], rel=TOL, abs=1e-7), (case, key)
    weights = [metrics[f"adaptive_weight_{i}"] for i in range(n_terms)]
    assert np.std(weights) > 1e-3  # the terms' head norms differ
    assert np.mean([1.0 / w for w in weights]) == pytest.approx(1.0, rel=1e-5)


def check_updates(case):
    jstate, jnew, _, _, state, grads, _ = _pair(case)
    start, ref = (from_jax_variables(jstate_variables(s)) for s in (jstate, jnew))
    for name, p in state.model.named_parameters():
        # the key bias's and the last norm's gradients are rounding noise
        if name in grads and not name.endswith(EXACT_ZEROS):
            _deltas_agree(name, p.detach().numpy(), ref[name], start[name], [grads[name]],
                          LR, 5e-4)
    for idx, (loss, _) in enumerate(state.losses):
        for pname, p in loss.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jnew.loss_params[str(idx)][pname]),
                                       rtol=0, atol=2e-4 * 1e-4 + 1e-6, err_msg=pname)


def check_head(case):
    """JAX's selected leaves set to one and the rest to zero, carried by the
    bridge: the port tensors that receive a one are the head it selects."""
    *_, state, _, variables = _pair(case)
    flat = traverse_util.flatten_dict(variables["params"], sep="/")
    key = _jax_head_key(list(flat))
    mask = traverse_util.unflatten_dict(
        {tuple(k.split("/")): np.full(np.shape(v), float(key in k), np.float32)
         for k, v in flat.items()})
    stats = jax.tree_util.tree_map(np.zeros_like, variables.get("batch_stats", {}))
    carried = from_jax_variables({"params": mask, "batch_stats": stats})
    params = dict(state.model.named_parameters())
    selected = {n for n in params if np.any(carried[n] != 0)}
    assert selected == set(head_parameter_names(state.model))
    assert selected and all(n.startswith(_cases()[case]["head"]) for n in selected)
    assert (selected == set(params)) == (key == "")
