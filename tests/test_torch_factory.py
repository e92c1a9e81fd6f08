"""The port's reference-config factory against irw_tpu's (ROADMAP C1, C2).

The JAX class adapter renames ``dino_backbone`` to ``backbone``, reads a
single ``backbone_config``, and drops only the keys its module does not
declare; ``MultiDinoHashingTF`` trains on tanh-binarised logits.  The port
builds the same model from the same keys, raises where it cannot (a key the
JAX module takes, DSLN), and its ``tanh_train`` model matches the JAX one
through the bridge at test_tiny width: f32, 1e-4 on the outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.models import get_model as jax_get_model
from irw_tpu.models import multi_dino as jax_multi_dino
from irw_tpu.models import wresnet as jax_wresnet
from irw_tpu.models.factory import _accepted as jax_accepted
from irw_tpu_torch.bridge import load_jax_variables
from irw_tpu_torch.models import get_model
from test_torch_vit import randomize

TOL = 1e-4
TINY_FUSION = {"use_all_tokens": False, "type": "cross_attention_advanced", "output_dim": 64,
               "num_heads": 2, "dropout": 0.0, "num_queries": 4, "sub_band_dropout_p": 0,
               "ortho_weight": 0.01}


def tiny_kwargs(**kw):
    """The flagship YAML's dialect at test_tiny width, one block, f32."""
    return dict({"binary_config": {"nbits": 16}, "use_bn": True, "fusion_config": TINY_FUSION,
                 "vit_kwargs": {"depth": 1, "dtype": "float32"}}, **kw)


def test_jax_fields_copy_matches_irw_tpu():
    from irw_tpu_torch.models.factory import JAX_FIELDS

    modules = {"MultiDinoHashing": jax_multi_dino.MultiDinoHashing, "WCNN": jax_wresnet.WCNN,
               "WCNNAttention": jax_wresnet.WCNNAttention}
    assert set(JAX_FIELDS) == set(modules)
    for name, cls in modules.items():
        assert JAX_FIELDS[name] == jax_accepted(cls), name


@pytest.mark.parametrize("dialect", [
    {"dino_backbone": "test_tiny"},
    {"backbone_config": {"name": "test_tiny", "frozen": False}},
    {"backbones_config": [{"name": "test_tiny", "frozen": False}] * 4, "branches": [0, 1]},
])
def test_backbone_keys_build_the_backbone_jax_builds(dialect):
    kw = tiny_kwargs(**dialect)
    jmodel = jax_get_model("MultiDinoHashing", **kw)
    model = get_model("MultiDinoHashing", device="cpu", **kw)
    assert model.backbone.vit.embed_dim == 64 and jmodel.backbone == "test_tiny"
    assert model.frozen_backbone == jmodel.frozen_backbone


def test_dsln_raises_naming_the_roadmap():
    kw = tiny_kwargs(backbone_config={"name": "test_tiny", "frozen": False, "use_dsln": True})
    with pytest.raises(NotImplementedError, match="A10"):
        get_model("MultiDinoHashing", device="cpu", **kw)


def test_factory_drops_only_what_the_jax_factory_drops():
    base = {"backbone_name": "wcnn", "backbone": "resnet18", "num_classes": 3}
    # a key no JAX module declares: dropped by both factories
    model = get_model("RetrievalNet", device="cpu", **base, feature_size=512, wave="haar")
    assert len(model.backbone.branches) == 4
    # a key the JAX WCNN takes and the port's does not: no silent drop
    with pytest.raises(NotImplementedError, match="frozen_bn.*A10"):
        get_model("RetrievalNet", device="cpu", **base, frozen_bn=True)
    with pytest.raises(NotImplementedError, match="dtype.*A10"):
        get_model("RetrievalNet", device="cpu", **dict(base, backbone_name="wcnn_attention"),
                  dtype="float32")


@pytest.mark.parametrize("name", ["MultiDinoHashingTF", "MultiDinoHashing"])
def test_tanh_train_matches_jax(name):
    """Training mode returns tanh(logits) with ``tanh_train`` (identity
    logits without); eval mode the sign codes; both as the JAX model."""
    kw = tiny_kwargs(backbones_config=[{"name": "test_tiny", "frozen": False}] * 4)
    img = 28
    jmodel = jax_get_model(name, **kw)
    bands = np.random.RandomState(5).randn(4, 4, img, img, 3).astype(np.float32)
    rngs = {"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(1),
            "band_drop": jax.random.PRNGKey(2)}
    variables = jax.jit(lambda r, x: jmodel.init(r, x, train=False))(rngs, jnp.asarray(bands))
    variables = randomize(variables, 5)
    model = get_model(name, device="cpu",
                      **dict(kw, vit_kwargs=dict(kw["vit_kwargs"], img_size=img)))
    load_jax_variables(model, variables)
    assert model.tanh_train == (name == "MultiDinoHashingTF")

    (ref, _), _ = jmodel.apply(variables, jnp.asarray(bands), train=True,
                               mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(1),
                                     "band_drop": jax.random.PRNGKey(2)})
    model.train()
    with torch.no_grad():
        out, _ = model(torch.from_numpy(bands), {"dropout": torch.Generator().manual_seed(1),
                                                 "band_drop": torch.Generator().manual_seed(2)})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    assert (out.abs().max() < 1.0) == model.tanh_train
    model.eval()
    with torch.no_grad():
        codes, _ = model(torch.from_numpy(bands))
    jcodes, _ = jmodel.apply(variables, jnp.asarray(bands), train=False)
    assert set(np.unique(codes.numpy())) <= {-1.0, 1.0}
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
