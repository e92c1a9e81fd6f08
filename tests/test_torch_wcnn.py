"""The port's wavelet-CNN models against irw_tpu's, same weights.

``WCNN`` and ``WCNNAttention`` with resnet18 branches (full width) on 32²
subbands, one resnet50 case, and ``WCNN_ALL`` over 7 bands.  The flax
variables come from ``init(train=True)``, as ``irw_tpu/getter.py:167``
makes them (so the CE classifiers are in the tree), with BatchNorm
parameters and statistics, biases and the zero-initialised classifier
kernels redrawn with numpy; ``bridge.from_jax_variables`` carries them.

Tolerance 1e-4 on the L2-normalised embeddings and the gates, and on the
CE logits 1e-4 · max(1, max|logit|) (they are not normalised and reach
about 7); f32 on both sides, another summation order.  In training the
BatchNorms normalise with the batch statistics and move the running ones.  Training BatchNorm over the few values of a small map is
ill-conditioned: in the resnet50 case (64² subbands, batch 4) the JAX
package's own f32 logits lie 1.2e-3 from the same model run in f64 (the
port's 3.2e-4), so its training logits are held to 1e-3 · max(1, max|logit|).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.models import get_model as jax_get_model
from irw_tpu_torch.bridge import from_jax_variables, load_jax_variables
from irw_tpu_torch.models import get_model
from irw_tpu_torch.models.wresnet import WCNNAttention
from test_torch_resnet import randomize_all

TOL = 1e-4


def build_pair(name, bands, seed=0, size=32, batch=4, **kw):
    jmodel = jax_get_model(name, **kw)
    x = np.random.RandomState(seed).randn(batch, bands, size, size, 3).astype(np.float32)
    variables = jax.jit(lambda r, v: jmodel.init(r, v, train=True))(
        {"params": jax.random.PRNGKey(seed)}, jnp.asarray(x))
    variables = randomize_all(variables, seed)
    model = get_model(name, device="cpu", **kw)
    load_jax_variables(model, variables)
    return jmodel, variables, model, x


def check_eval(jmodel, variables, model, x):
    emb_ref, aux_ref = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        emb, aux = model(torch.from_numpy(x))
    assert emb.shape == emb_ref.shape and float(aux["ortho_loss"]) == 0.0
    np.testing.assert_allclose(emb.numpy(), np.asarray(emb_ref), rtol=0, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(emb.numpy(), axis=-1), 1.0, atol=1e-6)
    assert set(aux) == set(aux_ref)
    if "gate" in aux:
        np.testing.assert_allclose(aux["gate"].numpy(), np.asarray(aux_ref["gate"]), rtol=0,
                                   atol=TOL)


def check_train_logits(jmodel, variables, model, x, tol=TOL):
    (ref, aux_ref), _ = jmodel.apply(variables, jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
    model.train()
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(x))
    assert len(logits) == len(ref)
    for ours, r in zip(logits, ref):
        r = np.asarray(r)
        assert ours.shape == r.shape
        np.testing.assert_allclose(ours.numpy(), r, rtol=0, atol=tol * max(1.0, np.abs(r).max()))
    if "gate" in aux_ref:
        np.testing.assert_allclose(aux["gate"].numpy(), np.asarray(aux_ref["gate"]), rtol=0,
                                   atol=TOL)
    assert float(np.abs(np.asarray(ref[0])).max()) > 1e-2  # the classifiers do reach the logits


@pytest.mark.parametrize("name,kw", [
    ("wcnn_attention_ce", {"attention": "cbam"}),
    ("wcnn_attention_ce", {"attention": "eca"}),
    ("wcnn_attention", {"attention": "channel"}),
    ("wcnn_ce", {}),
    ("wcnn", {}),
])
def test_wcnn_resnet18_matches_jax(name, kw):
    pair = build_pair(name, 4, backbone="resnet18", num_classes=5, **kw)
    check_eval(*pair)
    if name.endswith("_ce"):
        check_train_logits(*pair)


def test_wcnn_attention_training_updates_batch_stats():
    """BatchNorm in both modes: training normalises with the batch and
    moves every branch's running statistics as flax does; eval then reads
    the moved statistics."""
    jmodel, variables, model, x = build_pair("wcnn_attention_ce", 4, seed=1,
                                             backbone="resnet18", num_classes=3)
    check_train_logits(jmodel, variables, model, x)
    _, updated = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    moved = {"params": variables["params"], **updated}
    sd = model.state_dict()
    for key, value in from_jax_variables(moved).items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[key].numpy(), value, rtol=0, atol=1e-5, err_msg=key)
    check_eval(jmodel, moved, model.eval(), x)


def test_wcnn_all_seven_bands_matches_jax():
    pair = build_pair("wcnn_all_subs", 7, seed=2, size=16, backbone="resnet18", num_classes=4,
                      ce=False)
    check_eval(*pair)
    with pytest.raises(ValueError, match="7 branches"):
        pair[2](torch.zeros(1, 4, 16, 16, 3))


def test_wcnn_attention_resnet50_matches_jax():
    pair = build_pair("wcnn_attention_ce", 4, seed=3, size=64, num_classes=6)
    assert isinstance(pair[2], WCNNAttention) and pair[2].backbone.out_dim == 2048
    check_eval(*pair)
    check_train_logits(*pair, tol=1e-3)


def test_wcnn_attention_all_subs_yaml_matches_jax():
    """configs/model/wcnn_attention_all_subs.yaml: two levels with
    ``coarse_only: false`` give CustomTransform's 7-band stack; the JAX
    module reads the band count from its input, the port derives it from
    ``decom_level`` / ``coarse_only`` (resnet18 branches here)."""
    import yaml

    path = Path(__file__).resolve().parents[1] / "configs/model/wcnn_attention_all_subs.yaml"
    cfg = yaml.safe_load(path.read_text())
    kw = dict(cfg["kwargs"], decom_level=2, backbone="resnet18", num_classes=4)
    assert kw["coarse_only"] is False and cfg["name"] == "RetrievalNet"
    jmodel, variables, model, x = build_pair(cfg["name"], 7, seed=4, size=16, **kw)
    assert isinstance(model, WCNNAttention) and len(model.backbone.branches) == 7
    check_eval(jmodel, variables, model, x)
