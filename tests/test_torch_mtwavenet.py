"""The port's stage-interleaved multi-branch ResNets (mtwavenet) and the
hybrid ResNet/DenseNet against irw_tpu's, same weights.

- ``FourBranchResNet`` at depth 18, full width, on 32² bands (batch 4):
  eval with ``pool`` avg, max and avg_max; training with 5 classes (the
  per-band logits after dropout 0.5) and without classes (the normalised
  features), and the updated running statistics;
- ``FourBranchResNet50`` (5 classes) and ``FourBranchResNet50Fusion`` on
  64² bands (batch 3), the staged trunk at width 8 and one bottleneck a
  stage: eval (the fusion's gate and fused embedding) and training (the
  branch and fused logits);
- ``HybridMultiBranch`` on 64² bands, its ResNet-50 at width 8 and one
  bottleneck a stage, its DenseNets narrow (growth 4, 8 initial features,
  blocks (2, 2)): eval and training (one logits tensor).

Each JAX compile of a four-band trunk is what the file's time goes to, so
the ResNet-50 trunks are cut to one block a stage; the full-depth
ResNet-50 branches are held in ``tests/test_torch_wcnn.py``.

The JAX classes hard-code their widths; the test replaces the reference's
classes inside the test by subclasses of the same names
(``_BandedStagedResNet``; ``ResNet`` and ``DenseNet``, which
``HybridMultiBranch`` imports inside its call), so flax keeps its
auto-names, and the port's likewise.  Dropout's mask cannot match JAX's
bits: the JAX apply captures its ``Dropout_0`` output (kept = output ≠ 0)
and the port's call applies that mask through a test-side patch of
``mtwavenet.apply_dropout``.

The JAX model runs whole once in eval and once in training per trunk,
capturing the trunk's output (and the last stage attention's maps);
``FourBranchResNet``'s other pools and ``FourBranchResNet50``'s outputs,
which share those trunks, are the JAX pool and head arithmetic applied to
the captures (mtwavenet.py:91-95, :124-134).  Weights: ``numpy_init`` (the
classifiers drawn, not zero), carried by ``bridge.load_jax_variables``.
Tolerances: 1e-4 on normalised embeddings and gates; on logits 1e-4 ·
max(1, max|logit|), and 1e-3 · max(1, max|logit|) in training, where
BatchNorm normalises stage 4's 1×1 (depth 18) or 2² maps over the batch
(``tests/test_torch_wcnn.py``).  The running statistics to 1e-5 at depth
18 and, past ResNet-50's stage 4 on 12 values a channel, to 1e-4, as
``tests/test_torch_trunks.py`` holds them.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.models import densenet as jax_densenet
from irw_tpu.models import layers as jax_layers
from irw_tpu.models import mtwavenet as jax_mtwavenet
from irw_tpu.models import resnet as jax_resnet
from irw_tpu_torch.bridge import from_jax_variables, load_jax_variables
from irw_tpu_torch.models import mtwavenet
from irw_tpu_torch.models.densenet import DenseNet
from irw_tpu_torch.models.resnet import ResNet
from test_torch_fusion_heads import numpy_init

TOL = 1e-4
TRAIN_TOL = 1e-3
STATS_TOL = {"d18": 1e-5, "deep": 1e-4}
NARROW = 8
SHALLOW = (1, 1, 1, 1)   # one bottleneck a stage: the full ResNet-50 is tests/test_torch_wcnn.py's
CLASSES = 5
POOLS = ("avg", "max", "avg_max")

_CACHE = {}


class _BandedStagedResNet(jax_mtwavenet._BandedStagedResNet):
    width: int = NARROW

    def __post_init__(self):
        object.__setattr__(self, "stage_sizes", SHALLOW)
        super().__post_init__()


class JaxNarrowResNet(jax_resnet.ResNet):
    width: int = NARROW

    def __post_init__(self):
        object.__setattr__(self, "stage_sizes", SHALLOW)
        super().__post_init__()


JaxNarrowResNet.__name__ = "ResNet"


class JaxNarrowDenseNet(jax_densenet.DenseNet):
    block_sizes: tuple = (2, 2)
    growth_rate: int = 4
    init_features: int = NARROW


JaxNarrowDenseNet.__name__ = "DenseNet"


class NarrowStaged(mtwavenet.BandedStagedResNet):
    def __init__(self, stage_sizes, block, **kw):
        super().__init__(SHALLOW, block, **dict(kw, width=NARROW))


class NarrowResNet(ResNet):
    def __init__(self, stage_sizes, block, **kw):
        super().__init__(SHALLOW, block, **dict(kw, width=NARROW))


class NarrowDenseNet(DenseNet):
    def __init__(self, **kw):
        super().__init__(block_sizes=(2, 2), growth_rate=4, init_features=NARROW, **kw)


def _close(ours, ref, tol):
    ref = np.asarray(ref)
    ours = ours.detach().numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


def _unit(x):
    x = np.asarray(x)
    return x / np.sqrt((x * x).sum(-1, keepdims=True) + 1e-12)


def _capture(names):
    return lambda mdl, method: method == "__call__" and mdl.name in names


def _intermediate(tree, *path):
    for key in path:
        tree = tree[key]
    return tree["__call__"][0]


def _run(jmodel, variables, x, seed):
    """The JAX model in eval and in training (dropout from ``seed``), with
    the trunk's output, the last stage attention's maps and the dropout
    output captured."""
    names = ("_BandedStagedResNet_0", "att_block4", "Dropout_0")

    def run(v, x):
        ev, ev_vars = jmodel.apply(v, x, train=False, mutable=["intermediates"],
                                   capture_intermediates=_capture(names))
        tr, tr_vars = jmodel.apply(v, x, train=True, rngs={"dropout": jax.random.PRNGKey(seed)},
                                   mutable=["batch_stats", "intermediates"],
                                   capture_intermediates=_capture(names))
        return ev, ev_vars.get("intermediates", {}), tr, tr_vars

    return jax.jit(run)(variables, jnp.asarray(x))


def _port(model, variables):
    """The port model with the JAX variables, in eval mode."""
    load_jax_variables(model, variables)
    return model.eval()


def _without(variables, *names):
    """``variables`` without the top-level parameters ``names`` (the
    classifiers a model without classes does not hold)."""
    params = {k: v for k, v in variables["params"].items() if k not in names}
    return {**variables, "params": params}


def _dropout_with(keep):
    """``apply_dropout`` that drops where the JAX mask did."""
    def drop(x, rate, training, generator=None):
        assert rate == mtwavenet.DROPOUT and training
        return torch.where(keep, x / (1.0 - rate), 0.0)
    return drop


# --- FourBranchResNet, depth 18, full width ------------------------------------------


def depth18():
    if "d18" not in _CACHE:
        x = np.random.RandomState(0).randn(4, 4, 32, 32, 3).astype(np.float32)
        jmodel = jax_mtwavenet.FourBranchResNet(depth=18, num_classes=CLASSES)
        variables = numpy_init(jmodel, jnp.asarray(x), train=True, seed=0)
        _CACHE["d18"] = (x, variables, *_run(jmodel, variables, x, seed=1))
    return _CACHE["d18"]


@pytest.mark.parametrize("pool", POOLS)
def test_four_branch_resnet18_eval_matches_jax(pool):
    """Eval: the flat features, L2-normalised, for each pool: the JAX
    ``global_pool`` of the last stage attention's gated maps."""
    x, variables, (ref, _), ev_int, _, _ = depth18()
    maps = _intermediate(ev_int, "_BandedStagedResNet_0", "att_block4")[0]   # (B, S, h, w, C)
    pooled = jax_layers.global_pool(maps.reshape((-1,) + maps.shape[2:]), pool)
    expected = _unit(np.asarray(pooled).reshape(x.shape[0], -1))
    if pool == "avg":
        np.testing.assert_allclose(expected, np.asarray(ref), rtol=0, atol=1e-6)
    model = _port(mtwavenet.FourBranchResNet(depth=18, num_classes=CLASSES, pool=pool),
                  variables)
    assert len(model.backbone.branches[0].blocks) == 8
    assert [a.fc1.weight.shape[0] for a in model.backbone.att_blocks] == [256, 512, 1024, 2048]
    with torch.no_grad():
        out, aux = model(torch.from_numpy(x))
    assert out.shape == (4, 4 * 512) and set(aux) == {"ortho_loss"}
    np.testing.assert_allclose(out.numpy(), expected, rtol=0, atol=TOL)


@pytest.mark.parametrize("classes", [CLASSES, None])
def test_four_branch_resnet18_training_matches_jax(classes, monkeypatch):
    """Training: per-band logits of the dropped-out features (the JAX mask
    carried across), or without classes the normalised features, no
    dropout; every running statistic as flax moves it."""
    x, variables, _, _, (ref, _), tr_vars = depth18()
    model = _port(mtwavenet.FourBranchResNet(depth=18, num_classes=classes),
                  variables if classes else _without(variables, "DenseGeneral_0")).train()
    ints = tr_vars["intermediates"]
    if classes is None:
        emb = _intermediate(ints, "_BandedStagedResNet_0")
        refs = [_unit(np.asarray(emb).reshape(x.shape[0], -1))]
        monkeypatch.setattr(mtwavenet, "apply_dropout", None)   # never called
    else:
        refs = ref
        keep = torch.from_numpy(np.asarray(_intermediate(ints, "Dropout_0")) != 0)
        assert 0.3 < float(keep.float().mean()) < 0.7
        monkeypatch.setattr(mtwavenet, "apply_dropout", _dropout_with(keep))
    out, _ = model(torch.from_numpy(x), {"dropout": torch.Generator().manual_seed(0)})
    outs = out if classes else [out]
    assert len(outs) == len(refs) == (4 if classes else 1)
    for ours, r in zip(outs, refs):
        _close(ours, r, TRAIN_TOL)
    moved = from_jax_variables({"params": variables["params"],
                                "batch_stats": tr_vars["batch_stats"]})
    sd = model.state_dict()
    for key, value in moved.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[key].numpy(), value, rtol=0, atol=STATS_TOL["d18"],
                                       err_msg=key)


def test_four_branch_dropout_draws_from_the_dropout_generator():
    """The port's own mask: from ``rngs["dropout"]``, the same for the same
    seed, about half kept, and none without a ``dropout`` generator's rate."""
    x, variables, *_ = depth18()
    model = _port(mtwavenet.FourBranchResNet(depth=18, num_classes=CLASSES), variables).train()
    state = copy.deepcopy(model.state_dict())

    def logits(seed):
        model.load_state_dict(state)
        with torch.no_grad():
            out, _ = model(torch.from_numpy(x), {"dropout": torch.Generator().manual_seed(seed)})
        return torch.stack(out)

    a, b, c = logits(3), logits(3), logits(4)
    assert torch.equal(a, b) and not torch.equal(a, c)


# --- the ResNet-50 staged trunk at width 8: FourBranchResNet50 and the fusion ----------


def staged50():
    if "r50" not in _CACHE:
        x = np.random.RandomState(1).randn(3, 4, 64, 64, 3).astype(np.float32)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_mtwavenet, "_BandedStagedResNet", _BandedStagedResNet)
            jmodel = jax_mtwavenet.FourBranchResNet50Fusion(num_classes=CLASSES)
            variables = numpy_init(jmodel, jnp.asarray(x), train=True, seed=2)
            _CACHE["r50"] = (x, variables, *_run(jmodel, variables, x, seed=3))
    return _CACHE["r50"]


def _staged_model(cls, variables, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mtwavenet, "BandedStagedResNet", NarrowStaged)
        model = cls(**kw)
    return _port(model, variables)


def test_four_branch_resnet50_fusion_matches_jax(monkeypatch):
    """Eval: the ChannelGate1D's gate and its fused features L2-normalised;
    training: [4 branch logits of the dropped-out features, the fused
    logits], and the statistics."""
    x, variables, (ref, aux_ref), _, (tr_ref, _), tr_vars = staged50()
    model = _staged_model(mtwavenet.FourBranchResNet50Fusion, variables, num_classes=CLASSES)
    assert model.backbone.branch_ln is not None
    with torch.no_grad():
        out, aux = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    np.testing.assert_allclose(aux["gate"].numpy(), np.asarray(aux_ref["gate"]), rtol=0,
                               atol=TOL)
    keep = torch.from_numpy(np.asarray(_intermediate(tr_vars["intermediates"], "Dropout_0")) != 0)
    monkeypatch.setattr(mtwavenet, "apply_dropout", _dropout_with(keep))
    out, aux = model.train()(torch.from_numpy(x), {})
    assert len(out) == len(tr_ref) == 5
    for ours, r in zip(out, tr_ref):
        _close(ours, r, TRAIN_TOL)
    assert float(np.abs(np.asarray(tr_ref[4])).max()) > 1e-2
    sd = model.state_dict()
    for key, value in from_jax_variables({"params": variables["params"],
                                          "batch_stats": tr_vars["batch_stats"]}).items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[key].numpy(), value, rtol=0, atol=STATS_TOL["deep"],
                                       err_msg=key)


def test_four_branch_resnet50_matches_jax(monkeypatch):
    """``FourBranchResNet50`` (depth 50, the LayerNorm) over the same
    trunk: the normalised flat features in eval; in training the shared
    classifier on the dropped-out features."""
    x, variables, _, ev_int, _, tr_vars = staged50()
    head = variables["params"]["DenseGeneral_0"]
    model = _staged_model(mtwavenet.FourBranchResNet50,
                          _without(variables, "ChannelGate1D_0", "Dense_0"), num_classes=CLASSES)
    assert isinstance(model, mtwavenet.FourBranchResNet) and model.backbone.branch_ln is not None
    with torch.no_grad():
        out, _ = model(torch.from_numpy(x))
    emb = np.asarray(_intermediate(ev_int, "_BandedStagedResNet_0"))
    np.testing.assert_allclose(out.numpy(), _unit(emb.reshape(3, -1)), rtol=0, atol=TOL)
    ints = tr_vars["intermediates"]
    dropped = np.asarray(_intermediate(ints, "Dropout_0"))
    ref = dropped @ np.asarray(head["kernel"]) + np.asarray(head["bias"])
    monkeypatch.setattr(mtwavenet, "apply_dropout", _dropout_with(torch.from_numpy(dropped != 0)))
    out, _ = model.train()(torch.from_numpy(x))
    for i, ours in enumerate(out):
        _close(ours, ref[:, i], TRAIN_TOL)


def test_fusion_without_classes_serves_and_refuses_training():
    """``mtwavenet_fusion_dml``'s ``num_classes: null``: the model serves;
    training raises, as the JAX training init does (``Dense(None)``)."""
    x, variables, (ref, _), *_ = staged50()
    model = _staged_model(mtwavenet.FourBranchResNet50Fusion,
                          _without(variables, "DenseGeneral_0", "Dense_0"), num_classes=None)
    with torch.no_grad():
        out, _ = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    with pytest.raises(TypeError, match="num_classes"):
        model.train()(torch.from_numpy(x))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mtwavenet, "_BandedStagedResNet", _BandedStagedResNet)
        with pytest.raises(TypeError):
            jax.eval_shape(lambda: jax_mtwavenet.FourBranchResNet50Fusion(num_classes=None).init(
                {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                jnp.asarray(x), train=True))


# --- HybridMultiBranch ----------------------------------------------------------------


def hybrid():
    if "hybrid" not in _CACHE:
        x = np.random.RandomState(4).randn(3, 4, 64, 64, 3).astype(np.float32)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_resnet, "ResNet", JaxNarrowResNet)
            mp.setattr(jax_densenet, "DenseNet", JaxNarrowDenseNet)
            jmodel = jax_mtwavenet.HybridMultiBranch(num_classes=CLASSES)
            variables = numpy_init(jmodel, jnp.asarray(x), train=True, seed=5)
            _CACHE["hybrid"] = (x, variables, *_run(jmodel, variables, x, seed=6))
    return _CACHE["hybrid"]


def test_hybrid_multi_branch_matches_jax():
    """Eval: the 2048·w/64 + 3 DenseNet features, concatenated and
    normalised; training: ONE logits tensor (not a list), and the
    statistics of the ResNet and the three DenseNets."""
    x, variables, (ref, _), _, (tr_ref, _), tr_vars = hybrid()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mtwavenet, "ResNet", NarrowResNet)
        mp.setattr(mtwavenet, "DenseNet", NarrowDenseNet)
        model = _port(mtwavenet.HybridMultiBranchV2(num_classes=CLASSES), variables)
    with torch.no_grad():
        out, _ = model(torch.from_numpy(x))
    assert out.shape == np.asarray(ref).shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    logits, _ = model.train()(torch.from_numpy(x))
    assert isinstance(logits, torch.Tensor) and logits.shape == (3, CLASSES)
    _close(logits, tr_ref, TRAIN_TOL)
    sd = model.state_dict()
    for key, value in from_jax_variables({"params": variables["params"],
                                          "batch_stats": tr_vars["batch_stats"]}).items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[key].numpy(), value, rtol=0, atol=STATS_TOL["deep"],
                                       err_msg=key)


def test_frozen_bn_pins_every_trunk_statistic():
    """``frozen_bn`` on the staged trunk and on the hybrid's ResNet and
    DenseNets: training leaves every running statistic as it was (eval's
    output), and the gradient still reaches the BatchNorms' scale and
    bias."""
    from irw_tpu_torch.models.resnet import BatchNorm

    x, variables, *_ = hybrid()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mtwavenet, "ResNet", NarrowResNet)
        mp.setattr(mtwavenet, "DenseNet", NarrowDenseNet)
        model = _port(mtwavenet.HybridMultiBranch(num_classes=CLASSES, frozen_bn=True),
                      variables)
    x = torch.from_numpy(x)
    with torch.no_grad():
        served, _ = model(x)
    before = copy.deepcopy(model.state_dict())
    logits, _ = model.train()(x)
    logits.square().sum().backward()
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert norms and not any(m.training for m in norms)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    # every scale and bias gets its gradient (a narrow DenseLayer whose
    # output the last ReLU silences gets zeros), and each trunk's is non-zero
    assert all(m.weight.grad is not None and m.bias.grad is not None for m in norms)
    for trunk in (model.ll_trunk, *model.detail_trunks):
        grads = [m.weight.grad.abs().sum() + m.bias.grad.abs().sum() for m in trunk.modules()
                 if isinstance(m, BatchNorm)]
        assert sum(g > 0 for g in grads) >= len(grads) - 2
    emb = torch.nn.functional.normalize(torch.cat(
        [model.ll_trunk(x[:, 0]), *(t(x[:, s + 1]) for s, t in enumerate(model.detail_trunks))],
        -1), dim=-1)
    torch.testing.assert_close(emb.detach(), served, rtol=0, atol=1e-6)
