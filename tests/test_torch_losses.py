"""The port's loss zoo against irw_tpu's, from the same seeded numpy inputs.

Every name of the JAX ``LOSS_REGISTRY`` (adapter aliases included) over
single-label labels (class ids 0..C, so C itself lies past the class count
of the classification and hashing losses: their zero one-hot row) and
multi-label rows; the memory readers (score losses and ``accepts_refs``
losses) also against a memory (non-square (B, M) scores, or reference
embeddings), with the general rank path cut into chunks of two queries.
The JAX losses' parameters are drawn by ``init_params`` and carried over by
``bridge.load_jax_loss_params``.

Tolerances (f32 on both sides, other summation orders): each value within
1e-6 relative, and the AP losses, whose value is 1 − mAP, also within two
ulps of 1 (2.4e-7) absolute: the difference from 1 cancels, and a
one-ulp difference of a per-query AP near 1 reaches 1.5e-6 relative of
BlackBoxAP's 0.077; the gradient with respect to the embeddings, scores or
branches within 1e-5 relative, elementwise, plus 1e-5 of its largest
magnitude (an entry near zero carries only the others' rounding).

Then the memory term through both packages' ``build_train_step``: a small
Dense embedding model (the same in flax and torch) trains two steps with
``configs/loss/{roadmap,pair_loss,smoothap}.yaml`` and a 32-slot unique XBM
filled through its own insert (all slots valid, or 20 of 32).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import dataclasses
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from irw_tpu.engine import optimizers as jax_optimizers
from irw_tpu.engine.train import _build_hyper as jax_build_hyper
from irw_tpu.engine.train_step import build_train_step as jax_build_train_step
from irw_tpu.engine.xbm import XBM as JaxXBM
from irw_tpu.getter import Getter
from irw_tpu.getter import init_train_state as jax_init_train_state
from irw_tpu.losses import LOSS_REGISTRY as JAX_REGISTRY
from irw_tpu.losses import LossContext as JaxContext
from irw_tpu.losses import LossKind as JaxKind
from irw_tpu.losses import build_losses as jax_build_losses
from irw_tpu.losses.hashing import hadamard_hash_targets as jax_hadamard
from irw_tpu.losses.rank_ap import true_ranker as jax_true_ranker
from irw_tpu.utils.label_matrix import create_label_matrix as jax_label_matrix
from irw_tpu_torch.bridge import load_jax_loss_params
from irw_tpu_torch.engine import XBM, build_train_step, init_train_state
from irw_tpu_torch.engine.train import _build_hyper
from irw_tpu_torch.losses import LOSS_REGISTRY, LossContext, LossKind, build_losses, get_loss
from irw_tpu_torch.losses import rank_ap
from irw_tpu_torch.losses.hashing import hadamard_hash_targets
from irw_tpu_torch.utils.label_matrix import create_label_matrix

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
B, D, C, M, NB = 12, 16, 4, 20, 3
VALUE_TOL, GRAD_TOL = 1e-6, 1e-5
ONE_MINUS_MAP = ("HeavisideAP", "SmoothAP", "SupAP", "AffineAP", "SoftBinAP", "BlackBoxAP",
                 "FastAP")

# constructor kwargs where a loss needs some (class counts, widths, inner losses)
KWARGS = {
    "ArcFaceLoss": {"num_classes": C, "embedding_size": D},
    "HashLoss": {"num_classes": C, "embedding_size": D},
    "CSQLoss": {"num_classes": C, "embedding_size": D},
    "CSQAdapter": {"num_classes": C, "embedding_size": D},
    "HHFLoss": {"num_classes": C, "embedding_size": D},
    "HHFAdapter": {"num_classes": C, "embedding_size": D},
    "SCHLoss": {"nbits": D},
    "MultiCrossEntropyLoss": {"branch_weights": [0.5, 1.0, 2.0], "label_smoothing": 0.1},
    "CrossEntropy": {"label_smoothing": 0.1},
    "QuantizationLoss": {"step_type": "multi", "steps": [1, 2], "alpha": 10,
                         "starting_weight": 0.01, "warmup_step": True},
    "MultiEmbeddingLoss": {"loss": {"name": "HHFLoss",
                                    "kwargs": {"num_classes": C, "embedding_size": D}},
                           "branch_weights": [1.0, 0.5, 2.0]},
    "MultiLoss": {"losses": [
        [{"name": "CalibrationLoss", "weight": 1.0, "kwargs": {}},
         {"name": "SupAP", "weight": 0.5, "kwargs": {"offset": 1.44}}],
        [{"name": "HHFLoss", "weight": 2.0,
          "kwargs": {"num_classes": C, "embedding_size": D}}],
        [{"name": "SmoothAP", "weight": 1.0, "kwargs": {}},
         {"name": "QuantizationLoss", "weight": 0.1, "kwargs": {"step_type": "multi",
                                                                "steps": [1]}}]]},
    "FeatureDistillationLoss": {"teacher_index": 1},
    "SupAP": {"offset": 1.44},
    "SoftBinAP": {"nq": 20, "min": -1, "max": 1},
}
# epochs / batches of schedule applied before the call (a non-trivial state)
EPOCHS = {"QuantizationLoss": 2, "MultiLoss": 1}
STEPS = {"HashNetLoss": 3, "HashNetAdapter": 3}
HASHNET_KW = {"batches_per_epoch": 1, "step_continuation": 2}
# ArcFace takes class ids: multi-label rows fail to broadcast in both packages
RAISES = {("ArcFaceLoss", "multi")}

NAMES = sorted(JAX_REGISTRY)
READERS = [n for n in NAMES if JAX_REGISTRY[n].kind == JaxKind.SCORES
           or getattr(JAX_REGISTRY[n], "accepts_refs", False)]
CASES = ([(n, labels, False) for n in NAMES for labels in ("single", "multi")]
         + [(n, labels, True) for n in READERS for labels in ("single", "multi")])


def _labels(rng, kind, n):
    if kind == "single":
        return rng.randint(0, C + 1, size=n).astype(np.int32)
    y = (rng.rand(n, C) > 0.6).astype(np.float32)
    y[np.arange(n), rng.randint(0, C, size=n)] = 1.0
    return y


def _unit(rng, n, d=D):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _inputs(name, kind, memory, seed=0):
    """The seeded numpy inputs of a case: {"x": the differentiated input (an
    array, or a list for branch losses), "labels", and for a memory case
    "ref" / "ref_labels"}."""
    rng = np.random.RandomState(seed)
    loss_kind = JAX_REGISTRY[name].kind
    labels = _labels(rng, kind, B)
    out = {"labels": labels}
    if loss_kind == JaxKind.BRANCHES:
        width = C if name == "MultiCrossEntropyLoss" else D
        out["x"] = [rng.randn(B, width).astype(np.float32) for _ in range(NB)]
    elif loss_kind == JaxKind.LOGITS:
        out["x"] = 2.0 * rng.randn(B, C).astype(np.float32)
    elif loss_kind == JaxKind.SCORES:
        emb = _unit(rng, B)
        if memory:
            ref, ref_labels = _unit(rng, M), _labels(rng, kind, M)
            out["x"], out["label_matrix"] = emb @ ref.T, (ref_labels, )
        else:
            out["x"], out["label_matrix"] = emb @ emb.T, None
    else:
        scale = 3.0 if name in ("SCHLoss", "QuantizationLoss") else 1.0
        out["x"] = scale * rng.randn(B, D).astype(np.float32)
        if name in ("CalibrationLoss", "PairLoss", "FastAP"):
            out["x"] = _unit(rng, B)
        if memory:
            out["ref"], out["ref_labels"] = _unit(rng, M), _labels(rng, kind, M)
    return out


def _jax_ctx(loss_kind, inp, x):
    labels = jnp.asarray(inp["labels"])
    if loss_kind == JaxKind.BRANCHES:
        return JaxContext(labels=labels, branches=list(x))
    if loss_kind == JaxKind.SCORES:
        other = None if inp["label_matrix"] is None else jnp.asarray(inp["label_matrix"][0])
        return JaxContext(labels=labels, scores=x, label_matrix=jax_label_matrix(labels, other))
    if "ref" in inp:
        return JaxContext(labels=labels, embeddings=x, ref_embeddings=jnp.asarray(inp["ref"]),
                          ref_labels=jnp.asarray(inp["ref_labels"]))
    return JaxContext(labels=labels, embeddings=x)


def _port_ctx(loss_kind, inp, x):
    labels = torch.from_numpy(inp["labels"])
    if loss_kind == LossKind.BRANCHES:
        return LossContext(labels=labels, branches=list(x))
    if loss_kind == LossKind.SCORES:
        other = (None if inp["label_matrix"] is None
                 else torch.from_numpy(inp["label_matrix"][0]))
        return LossContext(labels=labels, scores=x,
                           label_matrix=create_label_matrix(labels, other))
    if "ref" in inp:
        return LossContext(labels=labels, embeddings=x, ref_embeddings=torch.from_numpy(inp["ref"]),
                           ref_labels=torch.from_numpy(inp["ref_labels"]))
    return LossContext(labels=labels, embeddings=x)


def _kwargs(name):
    kw = dict(KWARGS.get(name, {}))
    if name in STEPS:
        kw.update(HASHNET_KW)
    return kw


def _jax_loss(name):
    loss = JAX_REGISTRY[name](**_kwargs(name))
    params = loss.init_params(jax.random.PRNGKey(3))
    state = loss.init_state()
    for _ in range(EPOCHS.get(name, 0)):
        state = loss.epoch_update(state)
    for _ in range(STEPS.get(name, 0)):
        state = loss.step_update(state)
    return loss, params, state


def _port_loss(name, params):
    loss = get_loss(name, **_kwargs(name))
    load_jax_loss_params([(loss, 1.0)], {"0": params})
    state = loss.init_state()
    for _ in range(EPOCHS.get(name, 0)):
        state = loss.epoch_update(state)
    for _ in range(STEPS.get(name, 0)):
        state = loss.step_update(state)
    return loss, state


def _close(ours, ref, what):
    ref = np.asarray(ref)
    ours = ours.detach().numpy()
    assert ours.shape == ref.shape, what
    atol = GRAD_TOL * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(ours, ref, rtol=GRAD_TOL, atol=atol, err_msg=what)


def _leaves(state):
    if isinstance(state, dict):
        return {k: _leaves(v) for k, v in state.items()}
    return float(np.asarray(state))


@pytest.mark.parametrize("name,labels,memory", CASES,
                         ids=[f"{n}-{lab}{'-memory' if m else ''}" for n, lab, m in CASES])
def test_loss_value_and_gradient_match_jax(name, labels, memory, monkeypatch):
    # the general rank path in chunks of two queries, each recomputed in the backward
    monkeypatch.setattr(rank_ap, "GENERAL_CHUNK_ELEMENTS", 2 * M * M)
    inp = _inputs(name, labels, memory)
    jloss, params, jstate = _jax_loss(name)
    loss, state = _port_loss(name, params)
    assert type(loss).__name__ == type(jloss).__name__ and loss.kind.value == jloss.kind.value
    assert getattr(loss, "accepts_refs", False) == getattr(jloss, "accepts_refs", False)
    assert _leaves(state) == _leaves(jstate)

    branches = isinstance(inp["x"], list)
    jx = [jnp.asarray(v) for v in inp["x"]] if branches else jnp.asarray(inp["x"])

    def jax_value(x):
        value, new_state = jloss(_jax_ctx(jloss.kind, inp, x), params, jstate)
        return jnp.mean(value), new_state

    x = ([torch.tensor(v, requires_grad=True) for v in inp["x"]] if branches
         else torch.tensor(inp["x"], requires_grad=True))
    if (name, labels) in RAISES:
        with pytest.raises(ValueError):
            jax_value(jx)
        with pytest.raises(RuntimeError):
            loss(_port_ctx(loss.kind, inp, x), state)
        return
    (ref, ref_state), ref_grad = jax.jit(jax.value_and_grad(jax_value, has_aux=True))(jx)
    value, new_state = loss(_port_ctx(loss.kind, inp, x), state)
    value = value.mean()
    assert value.dtype == torch.float32 and value.dim() == 0
    atol = 2 * np.finfo(np.float32).eps if name in ONE_MINUS_MAP else 0.0
    assert float(value.detach()) == pytest.approx(float(ref), rel=VALUE_TOL, abs=atol), name
    assert _leaves(new_state) == _leaves(ref_state)
    if value.requires_grad:
        value.backward()
    for i, (ours, r) in enumerate(zip(x if branches else [x], ref_grad if branches else [ref_grad])):
        grad = ours.grad if ours.grad is not None else torch.zeros_like(ours)
        _close(grad, r, f"{name} gradient {i}")


def test_registry_is_the_jax_registry():
    assert sorted(LOSS_REGISTRY) == NAMES
    for name in NAMES:
        assert LOSS_REGISTRY[name].__name__ == JAX_REGISTRY[name].__name__, name


def _loss_yaml(path, num_classes=C, embed_dim=D):
    text = path.read_text().replace("${dataset.num_classes}", str(num_classes))
    return yaml.safe_load(text.replace("${model.kwargs.embed_dim}", str(embed_dim)))


def _attributes(loss):
    skip = ("training", "hash_targets", "random_center", "inner", "branch_losses")
    return {k: (float(np.asarray(v)) if hasattr(v, "shape") else v)
            for k, v in vars(loss).items() if not k.startswith("_") and k not in skip}


@pytest.mark.parametrize("path", sorted(CONFIGS.glob("loss/*.yaml")), ids=lambda p: p.stem)
def test_loss_configs_build_as_in_jax(path):
    """Every ``configs/loss`` file builds the same losses, weights and
    settings in both packages: the keys the JAX constructors swallow
    (``weights``, ``criterion``, ``loss_name``, ``n_bits``, ``alpha``, ...)
    are swallowed here too."""
    cfg = _loss_yaml(path)
    ours, ref = build_losses(cfg), jax_build_losses(cfg)
    assert [(type(l).__name__, w) for l, w in ours] == [(type(l).__name__, w) for l, w in ref]
    for (loss, _), (jloss, _) in zip(ours, ref):
        assert _attributes(loss) == _attributes(jloss), path.stem
        assert (loss.inner is None) == (jloss.inner is None) if hasattr(jloss, "inner") else True
        if hasattr(jloss, "branch_losses"):
            assert len(loss.branch_losses) == len(jloss.branch_losses)


def test_arcface_margin_and_hash_targets_match_jax():
    ours, ref = get_loss("ArcFaceLoss", num_classes=3, embedding_size=4), JAX_REGISTRY[
        "ArcFaceLoss"](num_classes=3, embedding_size=4)
    assert np.float32(ours.margin) == np.asarray(ref.margin)  # 28.6° in float32
    for n_class, nbits in ((20, 64), (200, 64), (10, 16), (5, 12)):
        np.testing.assert_array_equal(hadamard_hash_targets(n_class, nbits, 3),
                                      jax_hadamard(n_class, nbits, 3))
    csq, jcsq = get_loss("CSQLoss", num_classes=40, embedding_size=16), JAX_REGISTRY[
        "CSQLoss"](num_classes=40, embedding_size=16)
    np.testing.assert_array_equal(csq.random_center.numpy(), np.asarray(jcsq.random_center))
    assert "hash_targets" not in csq.state_dict()


@pytest.mark.parametrize("kw", [
    {"step_type": "linear", "steps": 3},
    {"step_type": "linear", "steps": 4, "warmup_step": 2},
    {"step_type": "multi", "steps": [10, 20, 30], "alpha": 10, "starting_weight": 0.01,
     "warmup_step": True},
    {"step_type": "multi", "steps": [2, 5], "alpha": 0.3, "starting_weight": 0.7},
], ids=["linear", "linear-warmup", "multi-warmup", "multi"])
def test_quantization_and_hashnet_schedules_match_jax(kw):
    ours, ref = get_loss("QuantizationLoss", **kw), JAX_REGISTRY["QuantizationLoss"](**kw)
    state, jstate = ours.init_state(), ref.init_state()
    hashnet = get_loss("HashNetLoss", batches_per_epoch=3, step_continuation=2)
    jhashnet = JAX_REGISTRY["HashNetLoss"](batches_per_epoch=3, step_continuation=2)
    hstate, jhstate = hashnet.init_state(), jhashnet.init_state()
    for _ in range(35):
        assert _leaves(state) == _leaves(jstate) and _leaves(hstate) == _leaves(jhstate)
        state, jstate = ours.epoch_update(state), ref.epoch_update(jstate)
        hstate, jhstate = hashnet.step_update(hstate), jhashnet.step_update(jhstate)
    assert state["weight"] > 0 and hstate["scale"] > 1


def test_true_ranker_matches_jax_with_ties():
    """Ranks from a stable double argsort (ties in index order) and the
    black-box backward's perturbed re-rank."""
    rng = np.random.RandomState(1)
    scores = np.round(rng.rand(6, 40), 1).astype(np.float32)  # many ties
    cot = rng.randn(6, 40).astype(np.float32)
    ref, vjp = jax.vjp(lambda s: jax_true_ranker(s, 4.0), jnp.asarray(scores))
    x = torch.tensor(scores, requires_grad=True)
    ranks = rank_ap.true_ranker(x, 4.0)
    np.testing.assert_array_equal(ranks.detach().numpy(), np.asarray(ref))
    ranks.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), rtol=1e-6)


def test_multi_embedding_loss_without_inner_fails_as_in_jax():
    """``multi_roadmap_loss.yaml`` keys its inner loss ``loss_name:``, which
    the constructor swallows: the state cannot be made, in either package."""
    cfg = _loss_yaml(CONFIGS / "loss" / "multi_roadmap_loss.yaml")
    ours, ref = build_losses(cfg), jax_build_losses(cfg)
    with pytest.raises(AttributeError):
        ref[0][0].init_params(jax.random.PRNGKey(0))
    with pytest.raises(AttributeError):
        ours[0][0].reset_parameters()


# --- the memory term through both train steps -------------------------------------------------

IMG, MEM, EMB, STEP_BATCH = 4, 32, 16, 8
MEMORY_LOSSES = ("roadmap", "pair_loss", "smoothap")
STEP_METRICS = ("total_loss", "grad_norm", "batch_map")
ADAM = [{"name": "Adam", "params": None, "kwargs": {"lr": 1e-3, "weight_decay": 4e-4}}]


class _JaxEmbedder(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = True):
        y = fnn.Dense(EMB)(x.reshape(x.shape[0], -1))
        return y / jnp.maximum(jnp.linalg.norm(y, axis=-1, keepdims=True), 1e-12)


class _Embedder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(IMG * IMG * 3, EMB)

    def forward(self, x, generators=None):
        y = self.dense(x.reshape(x.shape[0], -1))
        y = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-12)
        return y, {"ortho_loss": y.new_zeros(())}


def _memory_batches(seed):
    rng = np.random.RandomState(seed)
    fill = {"emb": _unit(rng, MEM, EMB), "labels": rng.randint(0, 6, MEM).astype(np.int32)}
    batches = [{"image": rng.randint(0, 256, (STEP_BATCH, IMG, IMG, 3)).astype(np.uint8),
                "label": rng.randint(0, 6, STEP_BATCH).astype(np.int32),
                "index": rng.choice(MEM, STEP_BATCH, replace=False).astype(np.int32)}
               for _ in range(2)]
    return fill, batches


@pytest.mark.parametrize("filled", [MEM, 20], ids=["full", "partial"])
@pytest.mark.parametrize("config", MEMORY_LOSSES)
def test_memory_term_matches_jax_train_step(config, filled):
    loss_cfg = _loss_yaml(CONFIGS / "loss" / f"{config}.yaml")
    fill, batches = _memory_batches(7)

    jmodel = _JaxEmbedder()
    jlosses = jax_build_losses(loss_cfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    entries = jax_optimizers.build_optimizers(ADAM, variables["params"])
    loss_tx = Getter().get_loss_optimizer(loss_cfg)
    jxbm = JaxXBM(size=MEM, embedding_dim=EMB, weight=0.5)
    jstate = jax_init_train_state(jmodel, jlosses, entries, loss_tx, batches[0], xbm=jxbm,
                                  seed=0)
    jstate = dataclasses.replace(jstate, xbm=jxbm.update(
        jstate.xbm, jnp.asarray(fill["emb"][:filled]), jnp.asarray(fill["labels"][:filled]),
        jnp.arange(filled)))
    jstep = jax.jit(jax_build_train_step(jmodel, jlosses, entries, loss_tx, xbm=jxbm,
                                         xbm_active=True))

    model = _Embedder()
    kernel = np.asarray(jstate.params["Dense_0"]["kernel"])
    bias = np.asarray(jstate.params["Dense_0"]["bias"])
    model.load_state_dict({"dense.weight": torch.from_numpy(kernel.T.copy()),
                           "dense.bias": torch.from_numpy(bias.copy())})
    xbm = XBM(size=MEM, embedding_dim=EMB, weight=0.5)
    state = init_train_state(model, build_losses(loss_cfg), ADAM, loss_cfg, seed=0, xbm=xbm)
    load_jax_loss_params(state.losses, jstate.loss_params)
    state.xbm_state = xbm.update(state.xbm_state, torch.from_numpy(fill["emb"][:filled]),
                                 torch.from_numpy(fill["labels"][:filled]),
                                 torch.arange(filled))
    step = build_train_step(xbm=xbm, xbm_active=True)

    names = [f"loss_{i}_{kind}{e['name']}" for i, e in enumerate(loss_cfg)
             for kind in ("", "memory_")]
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax_build_hyper(entries, 1, i, 0, None))
        m = step(state, batch, _build_hyper(state.optimizer_entries, 1, state.step, 0, None))
        assert set(m) == set(jm) and set(names) <= set(m), (set(m) ^ set(jm), names)
        for key in names + list(STEP_METRICS):
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=GRAD_TOL, abs=1e-7), \
                (i, key)
        np.testing.assert_allclose(model.dense.weight.detach().numpy().T,
                                   np.asarray(jstate.params["Dense_0"]["kernel"]),
                                   rtol=0, atol=1e-6)
    mem_emb, mem_labels, valid = xbm.contents(state.xbm_state)
    np.testing.assert_allclose(mem_emb.numpy(), np.asarray(jstate.xbm.embeddings), atol=1e-6)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jstate.xbm.valid))
    np.testing.assert_array_equal(mem_labels.numpy(), np.asarray(jstate.xbm.labels))


class _JaxBranches(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = True):
        flat = x.reshape(x.shape[0], -1)
        return [fnn.Dense(EMB)(flat), fnn.Dense(EMB)(flat)]


class _Branches(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = torch.nn.ModuleList(torch.nn.Linear(IMG * IMG * 3, EMB) for _ in range(2))

    def forward(self, x, generators=None):
        flat = x.reshape(x.shape[0], -1)
        return [d(flat) for d in self.dense], {"ortho_loss": flat.new_zeros(())}


def test_multi_loss_without_branch_losses_steps_as_in_jax():
    """``multi_roadmap.yaml`` builds no branch loss (its ``criterion:`` is
    swallowed), so the step's loss is 0: every parameter gets a zero
    gradient and moves by Adam's weight decay alone, as in the JAX step;
    ``batch_map`` reads the first branch."""
    loss_cfg = _loss_yaml(CONFIGS / "loss" / "multi_roadmap.yaml")
    _, batches = _memory_batches(3)
    jmodel = _JaxBranches()
    jlosses = jax_build_losses(loss_cfg)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, IMG, IMG, 3)))
    entries = jax_optimizers.build_optimizers(ADAM, variables["params"])
    loss_tx = Getter().get_loss_optimizer(loss_cfg)
    jstate = jax_init_train_state(jmodel, jlosses, entries, loss_tx, batches[0], seed=0)
    jstep = jax.jit(jax_build_train_step(jmodel, jlosses, entries, loss_tx))
    model = _Branches()
    model.load_state_dict({f"dense.{i}.{k}": torch.from_numpy(
        np.asarray(jstate.params[f"Dense_{i}"]["kernel" if k == "weight" else "bias"]).T.copy())
        for i in range(2) for k in ("weight", "bias")})
    state = init_train_state(model, build_losses(loss_cfg), ADAM, loss_cfg, seed=0)
    step = build_train_step()
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batches[0].items()},
                       jax_build_hyper(entries, 1, 0, 0, None))
    m = step(state, batches[0], _build_hyper(state.optimizer_entries, 1, 0, 0, None))
    assert set(m) == set(jm)
    assert float(m["total_loss"]) == float(jm["total_loss"]) == 0.0
    assert float(m["grad_norm"]) == float(jm["grad_norm"]) == 0.0
    assert float(m["batch_map"]) == pytest.approx(float(jm["batch_map"]), rel=1e-6)
    assert float(m["batch_map"]) > 0
    for i in range(2):
        np.testing.assert_allclose(model.dense[i].weight.detach().numpy().T,
                                   np.asarray(jstate.params[f"Dense_{i}"]["kernel"]),
                                   rtol=0, atol=1e-7)
        assert torch.equal(model.dense[i].weight.grad, torch.zeros_like(model.dense[i].weight))
