"""The port's train step against irw_tpu's ``build_train_step``, and the
schedules and host-side hyper-parameters around it.

Two full steps on both packages from one state: the small flagship (the
YAML's kwargs at depth 2 on 28² images, f32, attention on the kernel route,
block remat, fusion dropout 0), ``configs/loss/hash_loss.yaml``,
``configs/optimizer/basic.yaml`` at a test LR of 1e-3, ``clip_grad`` 5 and
``ortho_scale`` 2, on uint8 images through the device transform (Haar SWT).
The JAX state's parameters, BatchNorm statistics and HashLoss proxies are
carried into the port by the bridge.

Tolerances: the metrics to 1e-5 relative (f32, another summation order).
Adam's first step moves every parameter by about lr·sign(g), so parameter
deltas are held to 1e-3·lr where |g| ≥ 1e-2 of the leaf's largest gradient
(in the second step: where both steps' gradients are, with one sign);
elsewhere a rounding-level gradient can flip the sign, and the delta is only
bounded by 2·lr·(1 + wd·|p|).  Each step starts both packages from the JAX
parameters, so that such flips do not carry into the next step.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from irw_tpu.engine import optimizers as jax_optimizers
from irw_tpu.engine.train import _build_hyper as jax_build_hyper
from irw_tpu.engine.train_step import build_train_step as jax_build_train_step
from irw_tpu.getter import Getter
from irw_tpu.engine.train_state import TrainState as JaxTrainState
from irw_tpu.losses import build_losses as jax_build_losses
from irw_tpu.models import get_model as jax_get_model
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu_torch.bridge import from_jax_variables, load_jax_loss_params, load_jax_variables
from irw_tpu_torch.engine import build_train_step, init_train_state
from irw_tpu_torch.engine import optimizers
from irw_tpu_torch.engine.train import _apply_loss_epoch_updates, _build_hyper
from irw_tpu_torch.losses import LossBase, build_losses
from irw_tpu_torch.models import get_model
from irw_tpu_torch.models.vit import VisionTransformer
from irw_tpu_torch.transforms import DeviceTransform
from test_torch_multi_dino import YAML, flagship_yaml
from test_torch_train_model import EXACT_ZEROS
from test_torch_vit import randomize

CONFIGS = YAML.parents[1]
IMG, BATCH, STEPS = 28, 6, 2
LR, CLIP, ORTHO_SCALE = 1e-3, 5.0, 2.0
OPS = [("SWTTransform", {"level": 1, "wavelet": "haar"})]
METRIC_TOL = 1e-5
METRICS = ("total_loss", "loss_0_HashLoss", "ortho_raw", "ortho_loss", "grad_norm", "batch_map")


def _yaml(path):
    with open(CONFIGS / path) as f:
        return yaml.safe_load(f)


def _configs():
    opt_cfg = _yaml("optimizer/basic.yaml")
    opt_cfg[0]["kwargs"]["lr"] = LR
    return opt_cfg, _yaml("loss/hash_loss.yaml")


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    labels = (rng.rand(BATCH, 20) > 0.8).astype(np.float32)
    labels[:, 0] = 1.0
    return {"image": rng.randint(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8), "label": labels}


@pytest.fixture(scope="module")
def steps():
    return run_steps({"depth": 2, "dtype": "float32", "vmem_attn": True})


def run_steps(vit_kwargs):
    """Both packages from one state through STEPS steps of the small
    flagship with ``vit_kwargs``: (JAX states, JAX metrics, port metrics,
    port state, the port's parameters and gradients after each step)."""
    cfg = flagship_yaml()
    fusion = dict(cfg["kwargs"]["fusion_config"], dropout=0.0)
    kw = dict(cfg["kwargs"], vit_kwargs=vit_kwargs, fusion_config=fusion)
    opt_cfg, loss_cfg = _configs()
    batch = _batch()

    jmodel = jax_get_model(cfg["name"], **kw)
    jdt = JaxDeviceTransform(OPS)
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "band_drop": jax.random.PRNGKey(2)}
    variables = jax.jit(lambda r, x: jmodel.init(r, x, train=True))(
        rngs, jdt(jnp.asarray(batch["image"])))
    variables = randomize(variables, 0)
    jlosses = jax_build_losses(loss_cfg)
    entries = jax_optimizers.build_optimizers(opt_cfg, variables["params"])
    loss_tx = Getter().get_loss_optimizer(loss_cfg)
    jstate = jax_state_from(variables, jlosses, entries, loss_tx)

    model = get_model(cfg["name"], device="cpu",
                      **dict(kw, vit_kwargs=dict(vit_kwargs, img_size=IMG)))
    load_jax_variables(model, jstate_variables(jstate))
    state = init_train_state(model, build_losses(loss_cfg), opt_cfg, loss_cfg, seed=0)
    load_jax_loss_params(state.losses, jstate.loss_params)

    jstep = jax.jit(jax_build_train_step(jmodel, jlosses, entries, loss_tx, device_transform=jdt,
                                         clip_grad=CLIP))
    step = build_train_step(DeviceTransform(OPS, device="cpu"), clip_grad=CLIP)
    jstates, jmetrics, metrics, updated, grads = [jstate], [], [], [], []
    for i in range(STEPS):
        jhyper = jax_build_hyper(entries, 1, i, 0, None, ORTHO_SCALE)
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jhyper)
        jstates.append(jstate)
        jmetrics.append({k: float(v) for k, v in m.items()})
        hyper = _build_hyper(state.optimizer_entries, 1, state.step, 0, None, ORTHO_SCALE)
        metrics.append({k: float(v) for k, v in step(state, batch, hyper).items()})
        loss = state.losses[0][0]
        updated.append({**{k: v.detach().numpy().copy() for k, v in model.state_dict().items()},
                        "proxies": loss.proxies.detach().numpy().copy()})
        grads.append({**{n: p.grad.numpy().copy() for n, p in model.named_parameters()},
                      "proxies": loss.proxies.grad.numpy().copy()})
        # start the next step from the JAX state: where a gradient is at
        # rounding level, Adam's first step moves a parameter by ±lr on
        # either side, and that drift would outgrow the next step's
        # tolerances; the optimizer moments stay the port's own
        load_jax_variables(model, jstate_variables(jstate))
        load_jax_loss_params(state.losses, jstate.loss_params)
    return jstates, jmetrics, metrics, state, updated, grads


def jax_state_from(variables, losses, entries, loss_tx, xbm=None, seed: int = 0):
    """The state ``irw_tpu.getter.init_train_state`` returns, with
    ``variables`` as its parameters and BatchNorm statistics, without
    compiling the model's init: the same keys split from ``seed`` for the
    loss parameters and the state's rng, and the optimizer and memory
    states, which do not read the parameters' values."""
    _, _, _, l_rng, state_rng = jax.random.split(jax.random.PRNGKey(seed), 5)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    loss_params, loss_states = {}, {}
    for idx, (loss, _) in enumerate(losses):
        l_rng, sub = jax.random.split(l_rng)
        loss_params[str(idx)] = loss.init_params(sub)
        loss_states[str(idx)] = loss.init_state()
    return JaxTrainState(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables.get("batch_stats", {})),
        opt_states={e.name: e.tx.init(params if e.target is None else params[e.target])
                    for e in entries},
        loss_params=loss_params, loss_opt_state=loss_tx.init(loss_params),
        loss_states=loss_states, xbm=None if xbm is None else xbm.init(), rng=state_rng,
        step=jnp.int32(0), epoch=jnp.int32(0), model_alpha=jnp.float32(1.0))


def jstate_variables(jstate):
    return {"params": jstate.params, "batch_stats": jstate.batch_stats}


def test_step_metrics_match_jax(steps):
    check_step_metrics(steps)


def check_step_metrics(steps):
    _, jmetrics, metrics, state, _, _ = steps
    assert state.step == STEPS
    for i, (ours, ref) in enumerate(zip(metrics, jmetrics)):
        assert set(METRICS) <= set(ours) and set(METRICS) <= set(ref)
        for name in METRICS:
            assert ours[name] == pytest.approx(ref[name], rel=METRIC_TOL), (i, name)
        assert ours["grad_norm"] > CLIP  # the clip is live
        assert ours["ortho_loss"] == pytest.approx(0.01 * ORTHO_SCALE * ours["ortho_raw"], rel=1e-6)


def _deltas_agree(name, ours, ref, start, grads, lr, wd):
    """``grads``: the gradients of every step so far.  Adam's update is
    well-conditioned where each is large and all share one sign; where they
    cancel, m̂ is a small difference and any rounding moves it."""
    delta, delta_ref = ours - start, ref - start
    big = np.all([np.abs(g) >= 1e-2 * np.abs(g).max() for g in grads], axis=0)
    big &= np.all([np.sign(g) == np.sign(grads[0]) for g in grads], axis=0)
    assert big.any(), name
    np.testing.assert_allclose(delta[big], delta_ref[big], atol=1e-3 * lr, rtol=0, err_msg=name)
    assert np.all(np.abs(delta - delta_ref) <= 2 * lr * (1 + wd * np.abs(start))), name


@pytest.mark.parametrize("i", range(STEPS))
def test_step_updates_match_jax(steps, i):
    check_step_updates(steps, i)


def check_step_updates(steps, i):
    """Step i from the same parameters: the updated parameters, the HashLoss
    proxies (the loss's own AdamW: lr 1e-4, weight decay 1e-4) and the
    HashHead running statistics."""
    jstates, _, _, state, updated, grads = steps
    start, ref = (from_jax_variables(jstate_variables(s)) for s in jstates[i:i + 2])
    ours = updated[i]
    for name, _ in state.model.named_parameters():
        if not name.endswith(EXACT_ZEROS):  # their gradients are rounding noise
            _deltas_agree(name, ours[name], ref[name], start[name],
                          [g[name] for g in grads[:i + 1]], LR, 5e-4)
    for buf in ("hash_head.bn.running_mean", "hash_head.bn.running_var"):
        assert not np.array_equal(ours[buf], start[buf])
        np.testing.assert_allclose(ours[buf], ref[buf], atol=1e-5, rtol=1e-5, err_msg=buf)
    p0, p_ref = (np.asarray(s.loss_params["0"]["proxies"]) for s in jstates[i:i + 2])
    _deltas_agree("proxies", ours["proxies"], p_ref, p0, [g["proxies"] for g in grads[:i + 1]],
                  1e-4, 1e-4)


def test_warm_up_gated_entry_leaves_params_and_moments_untouched():
    cfg = flagship_yaml()
    model = get_model(cfg["name"], device="cpu", **dict(
        cfg["kwargs"], vit_kwargs={"depth": 1, "img_size": IMG, "dtype": "float32"}))
    opt_cfg, loss_cfg = _configs()
    state = init_train_state(model, build_losses(loss_cfg), opt_cfg, loss_cfg, seed=1)
    before = {k: v.clone() for k, v in model.named_parameters()}
    proxies = state.losses[0][0].proxies.detach().clone()
    step = build_train_step(DeviceTransform(OPS, device="cpu"))
    hyper = _build_hyper(state.optimizer_entries, 0, 0, warm_up=1, warm_up_key=None)
    assert hyper["active"] == {"net": False}
    metrics = step(state, _batch(1), hyper)
    assert np.isfinite(float(metrics["total_loss"]))
    for name, p in model.named_parameters():
        torch.testing.assert_close(p, before[name], rtol=0, atol=0)
    assert not state.optimizer_entries[0].optimizer.state  # no moments allocated
    # the loss's own optimizer is not gated, as in the JAX step
    assert not torch.equal(state.losses[0][0].proxies, proxies)


SCHEDULES = [
    {"name": "CosineAnnealingLR", "kwargs": {"T_max": 50, "eta_min": 1e-7}},
    {"name": "MultiStepLR", "kwargs": {"milestones": [10, 30], "gamma": 0.5}},
    {"name": "StepLR", "kwargs": {"step_size": 7, "gamma": 0.3}},
    {"name": "ExponentialLR", "kwargs": {"gamma": 0.95}},
    {"name": "LinearLR", "kwargs": {"start_factor": 0.25, "total_iters": 8}},
    {"name": "warmcos", "kwargs": {"total_steps": 60, "warmup_steps": 5}},
    {"name": "ConstantLR"},
    {"name": "OneCycleLR", "kwargs": {"max_lr": 1e-3, "epochs": 6, "steps_per_epoch": 10}},
    {"name": "SequentialLR", "kwargs": {
        "milestones": [5], "schedulers": [{"name": "LinearLR", "kwargs": {"total_iters": 5}},
                                          {"name": "CosineAnnealingLR", "kwargs": {"T_max": 55}}]}},
]


@pytest.mark.parametrize("schedule", SCHEDULES, ids=[s["name"] for s in SCHEDULES])
def test_schedules_match_jax(schedule):
    ours, ref = (m.make_schedule(schedule, 1e-5) for m in (optimizers, jax_optimizers))
    for t in range(60):
        assert ours(t) == ref(t), t


@pytest.mark.parametrize("mode", ["max", "min"])
def test_reduce_on_plateau_matches_jax(mode):
    values = [0.1, 0.2, 0.2, 0.19, 0.18, 0.25, 0.1, 0.1, 0.1, 0.3, 0.05]
    ours = optimizers.ReduceOnPlateau(mode=mode, factor=0.5, patience=1)
    ref = jax_optimizers.ReduceOnPlateau(mode=mode, factor=0.5, patience=1)
    assert [ours.update(v) for v in values] == [ref.update(v) for v in values]
    assert ours.scale < 1.0


def test_optimizer_entry_group_lrs_and_hyper_match_jax():
    """basic.yaml's entry over 60 epochs: group LRs (epoch E trains at
    f(E − 1)) and the warm-up gate of ``_build_hyper``."""
    cfg = [{"name": "AdamW", "params": None, "kwargs": {"lr": 1e-5, "weight_decay": 5e-4},
            "bias_kwargs": {"lr": 2e-5}, "modules": [{"name": "hash_head", "kwargs": {"lr": 1e-4}}],
            "scheduler_on_epoch": {"name": "CosineAnnealingLR", "kwargs": {"T_max": 50,
                                                                           "eta_min": 1e-7}},
            "scheduler_on_step": {"name": "warmcos", "kwargs": {"total_steps": 600}}},
           {"name": "SGD", "params": "head", "kwargs": {"lr": 1e-3, "momentum": 0.9}}]
    model = get_model("multidino_attention_hashing", device="cpu", backbone="test_tiny",
                      frozen_backbone=False,
                      fusion_config={"type": "cross_attention_advanced", "output_dim": 64,
                                     "num_heads": 2},
                      vit_kwargs={"img_size": 16})
    ours = optimizers.build_optimizers(cfg, model)
    jparams = {"hash_head": {"kernel": jnp.zeros((2, 2)), "bias": jnp.zeros(2)},
               "head": {"kernel": jnp.zeros((2, 2))}, "x": {"kernel": jnp.zeros((2, 2))}}
    ref = jax_optimizers.build_optimizers(cfg, jparams)
    assert [e.name for e in ours] == [e.name for e in ref] == ["net", "head"]
    for epoch in range(60):
        for warm_up, key in ((0, None), (3, "head")):
            h, jh = (b(e, epoch, 10 * epoch, warm_up, key) for b, e in
                     ((_build_hyper, ours), (jax_build_hyper, ref)))
            assert h["active"] == {k: bool(v) for k, v in jh["active"].items()}
            assert h["lrs"].keys() == jh["lrs"].keys()
            for name, lrs in jh["lrs"].items():
                assert h["lrs"][name] == pytest.approx({k: float(v) for k, v in lrs.items()},
                                                       rel=1e-6)
    labels = {g["label"]: len(g["params"]) for g in ours[0].optimizer.param_groups}
    assert set(labels) == {"weight", "bias", "hash_head"}
    assert isinstance(ours[1].optimizer, torch.optim.SGD)
    assert ours[1].optimizer.param_groups[0]["momentum"] == 0.9


def test_frozen_backbone_is_left_out_and_untrained():
    model = get_model("multidino_attention_hashing", device="cpu", backbone="test_tiny",
                      fusion_config={"type": "cross_attention_advanced", "output_dim": 64,
                                     "num_heads": 2},
                      vit_kwargs={"img_size": 16})
    assert model.frozen_backbone and model.frozen_param_collections == ("backbone",)
    opt_cfg, loss_cfg = _configs()
    state = init_train_state(model, build_losses(loss_cfg), opt_cfg, loss_cfg)
    held = {id(p) for g in state.optimizer_entries[0].optimizer.param_groups for p in g["params"]}
    assert not any(id(p) in held for p in model.backbone.parameters())
    assert not model.backbone.training and model.head.training
    before = [p.clone() for p in model.backbone.parameters()]
    images = np.random.RandomState(2).randint(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    batch = {"image": images, "label": _batch()["label"][:4]}
    step = build_train_step(DeviceTransform(OPS, device="cpu"))
    step(state, batch, _build_hyper(state.optimizer_entries, 1, 0, 0, None))
    assert all(p.grad is None for p in model.backbone.parameters())
    for p, b in zip(model.backbone.parameters(), before):
        torch.testing.assert_close(p, b, rtol=0, atol=0)


class _RefAwareLoss(LossBase):
    """An EMBEDDINGS loss marked as a reader of the XBM memory (it ignores it)."""

    accepts_refs = True

    def forward(self, ctx, state=None):
        return ctx.embeddings.square().mean(), state


def test_unported_training_paths_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="A13f"):
        build_train_step(apply_fn=lambda *a: a)
    with pytest.raises(NotImplementedError, match="A6-remainder"):
        VisionTransformer(depth=1, remat_blocks=True, remat_policy="dots_no_batch")
    with pytest.raises(ValueError, match="remat_policy"):
        VisionTransformer(depth=1, remat_policy="sometimes")
    model = get_model("multidino_attention_hashing", device="cpu", backbone="test_tiny",
                      fusion_config={"type": "cross_attention_advanced", "output_dim": 64,
                                     "num_heads": 2}, vit_kwargs={"img_size": 16})
    opt_cfg, loss_cfg = _configs()
    state = init_train_state(model, build_losses(loss_cfg), opt_cfg, loss_cfg)
    assert _apply_loss_epoch_updates(state.losses, state) is state
