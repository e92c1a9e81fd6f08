"""The single-trunk models against irw_tpu's, same weights: the hashing
ResNets (``ResNetCE``, ``ResNetHashing``, ``ResNet50DSCH``, ``ResNet50Mod``),
``DenseNet``, ``ConvNeXt``, ``RetrievalNet`` over a ResNet and a ViT trunk,
``ProjectionHead`` and ``global_pool``; the full-depth constructors'
parameter shapes; and the continuation α of ``state.model_alpha`` reaching
``ResNetHashing`` through the port's ``build_train_step``.

Small models: ResNet-18 (and the DSCH trunk's ResNet-50) on 32² images,
``DenseNet(block_sizes=(2, 2), growth_rate=8, init_features=16)``,
``ConvNeXt(depths=(1, 1), dims=(16, 32))`` at 32² and at 33² (flax's
``'SAME'`` padding of the strided convs pads there), vit_tiny on 32².
Weights: numpy draws in the shapes of the JAX init (``numpy_init``): the
zero-initialised classifiers and ConvNeXt's 1e-6 LayerScale get drawn
values (LayerScale about 1), since a parity at their init proves nothing.

Tolerances: f32 throughout, 1e-4 on outputs and BatchNorm statistics; ±1
codes equal wherever |logit| > 1e-3.  One exception, stated where it
applies: a ResNet-50 in training on 32² images normalises 1×1 maps by the
statistics of the batch alone, where both packages stray about 1e-3 from
float64; there a float64 run arbitrates (``test_dsch_matches_jax``).
PyTorch's CPU convolutions do not use TF32.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util

from irw_tpu.models import convnext as jax_convnext
from irw_tpu.models import densenet as jax_densenet
from irw_tpu.models import hashing_nets as jax_hashing
from irw_tpu.models import layers as jax_layers
from irw_tpu.models import resnet as jax_resnet
from irw_tpu.models.retrieval_net import RetrievalNet as JaxRetrievalNet
from irw_tpu.models.vit import make_vit as jax_make_vit
from irw_tpu_torch.bridge import _projection, from_jax_variables, load_jax_variables
from irw_tpu_torch.engine import build_train_step, init_train_state
from irw_tpu_torch.engine.train import _build_hyper
from irw_tpu_torch.losses import build_losses
from irw_tpu_torch.models import convnext, densenet, hashing_nets, layers, resnet
from irw_tpu_torch.models.retrieval_net import RetrievalNet
from irw_tpu_torch.models.vit import make_vit
from test_torch_fusion_heads import numpy_init
from test_torch_shared_dino import CONFIGS

TOL = 1e-4
# ResNet-50 training on batch statistics of 1×1 maps: JAX's distance to a
# float64 run stays below this (test_dsch_matches_jax)
DEEP_BN_ERR = 0.05
IMG, BATCH = 32, 4
SGD = [{"name": "SGD", "params": None, "kwargs": {"lr": 0.1}}]

_PAIRS = {}


def _images(seed, img=IMG, batch=BATCH):
    return np.random.RandomState(seed).randn(batch, img, img, 3).astype(np.float32)


def _layerscale_one(variables, seed):
    """ConvNeXt's ``gamma`` redrawn about 1 (numpy_init draws it at 0.02)."""
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(variables)
    for path in flat:
        if path[-1] == "gamma":
            flat[path] = (1.0 + 0.1 * rng.randn(*flat[path].shape)).astype(np.float32)
    return traverse_util.unflatten_dict(flat)


def pair(key, jmodel, model, img=IMG, seed=0, variables=None):
    """(JAX model, variables, port model, images) of one case, built once:
    the variables from a training-mode init (classifiers that only training
    creates included), or ``variables(x)``, carried into ``model`` by the
    bridge."""
    if key not in _PAIRS:
        x = _images(seed, img)
        if variables is None:
            variables = _layerscale_one(numpy_init(jmodel, jnp.asarray(x), seed=seed,
                                                   train=True), seed)
        else:
            variables = variables(x)
        load_jax_variables(model, variables)
        _PAIRS[key] = (jmodel, variables, model, x)
    return _PAIRS[key]


_DRAWS = {}


def _draw(key, jmodel, x, seed):
    """One ``numpy_init`` draw shared by the cases of one parameter tree."""
    if key not in _DRAWS:
        _DRAWS[key] = numpy_init(jmodel, jnp.asarray(x), seed=seed, train=True)
    return _DRAWS[key]


def _split(out):
    return out if isinstance(out, tuple) else (out, {})


def run_both(jmodel, variables, model, x, train: bool, **kw):
    """(port output, JAX output, JAX batch_stats after) in one mode."""
    if train:
        out, upd = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"],
                                                     **kw))(variables, jnp.asarray(x))
        stats = upd.get("batch_stats")
    else:
        out, stats = jax.jit(lambda v, x: jmodel.apply(v, x, train=False, **kw))(
            variables, jnp.asarray(x)), None
    model.train(train)
    with torch.no_grad():
        ours = _split(model(torch.from_numpy(x), **kw))[0]
    return ours, _split(out)[0], stats


def _close(ours, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=tol, rtol=tol)


def _codes_agree(ours, ref_logits):
    sure = np.abs(np.asarray(ref_logits)) > 1e-3
    np.testing.assert_array_equal(np.sign(np.asarray(ours))[sure],
                                  np.sign(np.asarray(ref_logits))[sure])


def _stats_match(model, variables, stats):
    """The port's BatchNorm buffers against the JAX ``batch_stats``."""
    ref = from_jax_variables({"params": variables["params"], "batch_stats": stats})
    sd = model.state_dict()
    keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        _close(sd[k].numpy(), ref[k])


# --- the hashing ResNets ------------------------------------------------------

@pytest.mark.parametrize("frozen_bn", [True, False], ids=["frozen_bn", "batch_bn"])
def test_resnet_ce_matches_jax(frozen_bn):
    """Eval: the normalised pooled features; training: the (drawn)
    classifier's logits and the BatchNorm statistics after the forward,
    which ``frozen_bn`` leaves as they were."""
    jm, variables, model, x = pair(("ce", frozen_bn),
                                   jax_hashing.ResNetCE(num_classes=5, depth=18,
                                                        frozen_bn=frozen_bn),
                                   hashing_nets.ResNetCE(num_classes=5, depth=18,
                                                         frozen_bn=frozen_bn), seed=1,
                                   variables=lambda x: _draw("ce", jax_hashing.ResNetCE(
                                       num_classes=5, depth=18), x, 1))
    ours, ref, _ = run_both(jm, variables, model, x, train=False)
    _close(ours, ref)
    np.testing.assert_allclose(np.linalg.norm(ours.numpy(), axis=-1), 1.0, atol=1e-5)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ours, ref, stats = run_both(jm, variables, model, x, train=True)
    _close(ours, ref)
    assert ours.shape == (BATCH, 5) and float(ours.abs().max()) > 0
    _stats_match(model, variables, stats)
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    assert (not moved) == frozen_bn
    load_jax_variables(model, variables)


def _step_batch():
    """A training batch for ``ResNetHashing``: uint8 images and VOC-like labels."""
    rng = np.random.RandomState(9)
    labels = (rng.rand(BATCH, 20) > 0.7).astype(np.float32)
    labels[:, 0] = 1.0
    return {"image": rng.randint(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8), "label": labels}


def _hashing_pair():
    """``ResNetHashing`` (16 bits, depth 18) on the step batch's images / 255,
    with the JAX training output at α = 2 computed once."""
    jm, variables, model, _ = pair("hashing", jax_hashing.ResNetHashing(nbits=16, depth=18),
                                   hashing_nets.ResNetHashing(nbits=16, depth=18), seed=2)
    load_jax_variables(model, variables)
    x = _step_batch()["image"].astype(np.float32) / 255.0
    if "hashing_ref" not in _DRAWS:
        _DRAWS["hashing_ref"] = run_both(jm, variables, model, x, train=True, alpha=2.0)[1]
    return jm, variables, model, x, _DRAWS["hashing_ref"]


def test_resnet_hashing_matches_jax_with_alpha():
    """tanh(α·fc) in training with α = 2; sign(fc) in eval."""
    jm, variables, model, x, ref = _hashing_pair()
    model.train()
    with torch.no_grad():
        ours, _ = model(torch.from_numpy(x), alpha=2.0)
        ours1, _ = model(torch.from_numpy(x))
    _close(ours, ref)
    _close(torch.atanh(ours1) * 2.0, torch.atanh(ours))  # α scales the pre-tanh codes
    codes, _, _ = run_both(jm, variables, model, x, train=False)
    assert set(np.unique(codes.numpy())) <= {-1.0, 1.0}
    _codes_agree(codes, torch.atanh(ours1).numpy())


# every option of ResNet50DSCH on, in one module: one ResNet-50 compile
DSCH_OPTIONS = {"double_pool": True, "use_layernorm": True, "normalize": True}


@pytest.mark.parametrize("case", ["options", "ResNet50Mod"])
def test_dsch_matches_jax(case):
    """ResNet50DSCH with ``double_pool``, ``use_layernorm`` and
    ``normalize`` (avg + max pooling, LayerNorm, L2), and ResNet50Mod's
    sign(codes), in eval to 1e-4.  ResNet50Mod in training, tanh(α·codes):
    the trunk's BatchNorm normalises the last stage's 1×1 maps with the
    statistics of 4 values, where both packages' f32 outputs stray about
    1e-3 from a float64 run of the same module (up to 1e-2 where a
    channel's four values nearly agree), so a float64 run of the port
    arbitrates: the port no further from it than JAX is, plus 1e-4."""
    if case == "ResNet50Mod":
        jm, model = jax_hashing.ResNet50Mod(n_bits=16), hashing_nets.ResNet50Mod(n_bits=16)
    else:
        jm = jax_hashing.ResNet50DSCH(n_bits=16, **DSCH_OPTIONS)
        model = hashing_nets.ResNet50DSCH(n_bits=16, **DSCH_OPTIONS)
    jm, variables, model, x = pair(("dsch", case), jm, model, seed=3)
    kw = {"alpha": 1.5}
    ours, ref, _ = run_both(jm, variables, model, x, train=False, **kw)
    if case != "ResNet50Mod":
        _close(ours, ref)
        np.testing.assert_allclose(np.linalg.norm(ours.numpy(), axis=-1), 1.0, atol=1e-5)
        return
    assert set(np.unique(ours.numpy())) <= {-1.0, 1.0}
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))

    ours, ref, _ = run_both(jm, variables, model, x, train=True, **kw)
    f64 = copy.deepcopy(model).double()
    load_jax_variables(f64, variables)
    f64.train()
    with torch.no_grad():
        exact = f64(torch.from_numpy(x).double(), **kw)[0].numpy()
    jax_err = np.abs(np.asarray(ref) - exact).max()
    assert jax_err < DEEP_BN_ERR
    assert np.abs(ours.numpy() - exact).max() <= jax_err + TOL
    load_jax_variables(model, variables)


# --- DenseNet and ConvNeXt ------------------------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_densenet_matches_jax(train):
    jm, variables, model, x = pair(
        "densenet", jax_densenet.DenseNet(block_sizes=(2, 2), growth_rate=8, init_features=16),
        densenet.DenseNet(block_sizes=(2, 2), growth_rate=8, init_features=16), seed=4)
    ours, ref, stats = run_both(jm, variables, model, x, train=train)
    assert ours.shape == (BATCH, model.out_dim) == (BATCH, 32)
    _close(ours, ref)
    if train:
        _stats_match(model, variables, stats)
        load_jax_variables(model, variables)


@pytest.mark.parametrize("img", [IMG, IMG + 1], ids=["even", "odd"])
def test_convnext_matches_jax(img):
    """At 33² the 4×4/4 stem and the 2×2/2 downsampling pad as flax's
    ``'SAME'`` (the odd extra row and column at the bottom and right)."""
    jm, variables, model, x = pair(("convnext", img),
                                   jax_convnext.ConvNeXt(depths=(1, 1), dims=(16, 32)),
                                   convnext.ConvNeXt(depths=(1, 1), dims=(16, 32)), img, seed=5)
    ours, ref, _ = run_both(jm, variables, model, x, train=False)
    assert ours.shape == (BATCH, 32)
    _close(ours, ref)
    assert np.abs(np.asarray(variables["params"]["ConvNeXtBlock_0"]["gamma"]) - 1).max() < 0.5
    if img % 2:  # a padding on the wrong side moves the output
        shifted = np.roll(x, 1, axis=1)
        moved, _, _ = run_both(jm, variables, model, shifted, train=False)
        assert np.abs(moved.numpy() - ours.numpy()).max() > 1e-3


# --- RetrievalNet, ProjectionHead, global_pool -----------------------------------

RETRIEVAL = {
    "resnet18-standardize": dict(trunk="resnet18", standardize=True),
    "resnet18-frozen": dict(trunk="resnet18", frozen_backbone=True, pooling="max"),
    "vit_tiny-ln": dict(trunk="vit_tiny", projection_norm="ln"),
    "vit_tiny-without_fc": dict(trunk="vit_tiny", without_fc=True),
}


def _retrieval_pair(case):
    kw = dict(RETRIEVAL[case])
    trunk = kw.pop("trunk")
    if trunk == "resnet18":
        jtrunk, ptrunk = jax_resnet.resnet18(), resnet.resnet18()
    else:
        jtrunk, ptrunk = jax_make_vit("vit_tiny"), make_vit("vit_tiny", img_size=IMG)
    return pair(("retrieval", case), JaxRetrievalNet(backbone=jtrunk, embed_dim=24, **kw),
                RetrievalNet(ptrunk, embed_dim=24, **kw), seed=6)


@pytest.mark.parametrize("case", sorted(RETRIEVAL))
def test_retrieval_net_matches_jax(case):
    """The L2-normalised embedding in both modes; a frozen trunk keeps its
    BatchNorm statistics in training and is the frozen collection."""
    jm, variables, model, x = _retrieval_pair(case)
    assert model.frozen_param_collections == jm.frozen_param_collections
    for train in (False, True):
        ours, ref, stats = run_both(jm, variables, model, x, train=train)
        _close(ours, ref)
        width = 64 if RETRIEVAL[case].get("without_fc") else 24
        assert ours.shape == (BATCH, width)
        np.testing.assert_allclose(np.linalg.norm(ours.numpy(), axis=-1), 1.0, atol=1e-5)
        if train and stats:
            _stats_match(model, variables, stats)
    load_jax_variables(model, variables)
    if model.pooling == "max":  # a ResNet trunk's features come pooled: `pooling` is inert
        model.eval()
        with torch.no_grad():
            pooled, _ = model(torch.from_numpy(x))
            model.pooling = "default"
            try:
                torch.testing.assert_close(model(torch.from_numpy(x))[0], pooled, rtol=0, atol=0)
            finally:
                model.pooling = "max"


@pytest.mark.parametrize("norm", [None, "bn", "ln"])
def test_projection_head_matches_jax(norm):
    """Two Linear layers with the norm and ReLU between, training mode (the
    BatchNorm on batch statistics, flax momentum 0.99)."""
    x = np.random.RandomState(7).randn(6, 20).astype(np.float32)
    jhead = jax_layers.ProjectionHead((24, 12), norm=norm)
    variables = numpy_init(jhead, jnp.asarray(x), seed=7, train=True)
    head = layers.ProjectionHead(20, (24, 12), norm)
    head.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                          _projection(variables["params"],
                                      variables.get("batch_stats", {})).items()})
    (ref, upd) = jax.jit(lambda v, x: jhead.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    head.train()
    with torch.no_grad():
        out = head(torch.from_numpy(x))
    _close(out, ref)
    if norm == "bn":
        _close(head.norms[0].running_var.numpy(), upd["batch_stats"]["BatchNorm_0"]["var"])


@pytest.mark.parametrize("pool", ["default", "avg", "max", "avg_max", "none"])
def test_global_pool_matches_jax(pool):
    x = np.random.RandomState(8).randn(3, 5, 4, 6).astype(np.float32)
    ref = jax_layers.global_pool(jnp.asarray(x), pool)
    nhwc = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).permute(0, 2, 3, 1)  # a view
    _close(layers.global_pool(nhwc, pool), ref)


# --- full-depth constructors -------------------------------------------------------

FULL = {
    "resnet101": (jax_resnet.resnet101, resnet.resnet101),
    "densenet121": (jax_densenet.densenet121, densenet.densenet121),
    "convnext_tiny": (jax_convnext.convnext_tiny, convnext.convnext_tiny),
    "convnext_small": (jax_convnext.convnext_small, convnext.convnext_small),
}


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_depth_trunk_has_the_jax_shapes(name):
    """Every parameter and statistic of the JAX init's shapes (no init is
    compiled) has its place and shape in the port's module, built on the
    meta device."""
    jctor, ctor = FULL[name]
    shapes = jax.eval_shape(lambda: jctor().init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 64, 64, 3)), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    ref = {k: v.shape for k, v in from_jax_variables(zeros).items()}
    with torch.device("meta"):
        model = ctor()
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours == ref
    width = {"resnet101": 2048, "densenet121": 1024}.get(name, 768)
    assert model.out_dim == width


# --- the continuation α through the train step ----------------------------------------

def test_model_alpha_reaches_resnet_hashing_in_the_train_step():
    """``state.model_alpha`` = 2 reaches ``ResNetHashing``'s forward through
    ``build_train_step`` (``irw_tpu/engine/train_step.py:94-107``): the loss
    sees the JAX module's tanh(2·fc) on the batch."""
    with open(CONFIGS / "loss/hash_loss.yaml") as f:
        loss_cfg = yaml.safe_load(f)
    loss_cfg[0]["kwargs"]["embedding_size"] = 16
    _, _, model, _, ref = _hashing_pair()
    state = init_train_state(model, build_losses(loss_cfg), SGD, loss_cfg, seed=0)
    state.model_alpha = 2.0
    seen = []
    hook = state.losses[0][0].register_forward_hook(
        lambda mod, args, out: seen.append(args[0].embeddings.detach()))
    try:
        metrics = build_train_step()(state, _step_batch(),
                                     _build_hyper(state.optimizer_entries, 1, 0, 0, None))
    finally:
        hook.remove()
    assert np.isfinite(float(metrics["total_loss"]))
    _close(seen[0], ref)
