"""The half-precision trunks as a config reaches them, through both
packages: the ``+model.kwargs.dtype=bfloat16`` override of
``model=wcnn_attention_ce transform=cub_dwt`` through ``compose`` and the
``Getter``, the wrapped-trunk routes of ``RetrievalNet``, and ``pool="none"``
in the mtwavenet family (ROADMAP A10b-rest).

The override: both packages compose the same config, and both factories
build a WCNNAttention whose trunks compute in bf16 at full width, the gate
and the classifiers in float32; its outputs on the composed transform's
batch have the dtypes of the JAX module's (``jax.eval_shape``).  The
``RetrievalNet`` routes that wrap a trunk build it without the key in both
packages (irw_tpu/models/factory.py:229-243): a float32 trunk.

``pool="none"``: ``FourBranchResNet50`` with classes sizes its LayerNorm
and classifier from the flattened map, which ``get_model(...,
image_size=(h, w))`` gives the port, against JAX's lazy init on 40 × 72
bands (a 2 × 3 map: each halving rounds a side up), at width 8, one
bottleneck a stage (``tests/test_torch_mtwavenet.py``'s narrow trunk).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.config import compose as jax_compose
from irw_tpu.getter import Getter as JaxGetter
from irw_tpu.models import get_model as jax_get_model
from irw_tpu.models import mtwavenet as jax_mtwavenet
from irw_tpu_torch.bridge import load_jax_variables
from irw_tpu_torch.config import compose
from irw_tpu_torch.getter import Getter
from irw_tpu_torch.models import MODEL_REGISTRY, get_model, mtwavenet
from irw_tpu_torch.models.layers import Linear
from irw_tpu_torch.models.resnet import BatchNorm, Conv2d
from test_torch_fusion_heads import numpy_init
from test_torch_mtwavenet import (CLASSES, NarrowStaged, _BandedStagedResNet, _dropout_with,
                                  _intermediate, _run)

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"
OVERRIDES = ["model=wcnn_attention_ce", "transform=cub_dwt", "+model.kwargs.dtype=bfloat16"]


def _dtypes(out):
    if isinstance(out, dict):
        return [d for k in sorted(out) for d in _dtypes(out[k])]
    if isinstance(out, (list, tuple)):
        return [d for v in out for d in _dtypes(v)]
    return [str(out.dtype).removeprefix("torch.")]


def test_dtype_override_builds_as_the_jax_getter():
    cfg = compose(CONFIG_DIR, "default", OVERRIDES)
    jcfg = jax_compose(CONFIG_DIR, "default", OVERRIDES)
    assert cfg.to_dict() == jcfg.to_dict()
    assert cfg.model.kwargs.dtype == "bfloat16"
    jmodel = JaxGetter().get_model(jcfg.model)
    model = Getter().get_model(cfg.model, device="cpu")
    assert type(jmodel).__name__ == type(model).__name__ == "WCNNAttention"
    assert (jmodel.dtype, jmodel.backbone, jmodel.attention, jmodel.ce) == \
        ("bfloat16", "resnet50", "cbam", True)
    assert len(model.backbone.branches) == 4 and model.backbone.out_dim == 2048
    assert {m.dtype for m in model.modules() if isinstance(m, (Conv2d, BatchNorm))} \
        == {torch.bfloat16}
    assert {m.dtype for m in model.modules() if isinstance(m, Linear)} == {torch.float32}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    _, (_, jdevice) = JaxGetter().get_transform(jcfg.transform)
    _, (_, device) = Getter().get_transform(cfg.transform, device="cpu")
    images = np.random.RandomState(0).randint(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    bands = device(torch.from_numpy(images))
    jbands = jdevice(jnp.asarray(images))
    assert tuple(bands.shape) == jbands.shape == (2, 4, 16, 16, 3)
    rngs = {"params": jax.random.PRNGKey(0)}
    ref = jax.eval_shape(lambda x: jmodel.apply(jmodel.init(rngs, x, train=True), x), jbands)
    with torch.no_grad():
        ours = model(bands)
    assert _dtypes(ours) == _dtypes(ref) == ["float32"] * 3   # gate alphas, embedding, ortho
    assert np.isfinite(ours[0].numpy()).all()


@pytest.mark.parametrize("trunk", ["resnet50", "convnext"])
def test_wrapped_trunks_build_in_float32_in_both_packages(trunk):
    """``RetrievalNet`` over ``resnet50()`` or ``convnext_tiny()``: neither
    factory hands the trunk the ``dtype`` key."""
    from irw_tpu.models.retrieval_net import RetrievalNet as JaxRetrievalNet

    jmodel = jax_get_model("RetrievalNet", backbone_name=trunk, dtype="bfloat16")
    assert isinstance(jmodel, JaxRetrievalNet) and jmodel.backbone.dtype == jnp.float32
    with torch.device("meta"):
        model = MODEL_REGISTRY["RetrievalNet"](torch.device("cpu"), backbone_name=trunk,
                                               dtype="bfloat16")
    assert model.backbone.dtype == torch.float32


def test_pool_none_sizes_the_layers_from_the_image_as_jax(monkeypatch):
    """``FourBranchResNet50`` with classes and ``pool="none"``: JAX sizes the
    LayerNorm and the classifier from the flattened 2 × 3 map of a 40 × 72
    band at init; the port from ``image_size``.  Eval: the normalised flat
    features; training: the per-band logits (JAX's dropout mask)."""
    x = np.random.RandomState(3).randn(2, 4, 40, 72, 3).astype(np.float32)
    monkeypatch.setattr(jax_mtwavenet, "_BandedStagedResNet", _BandedStagedResNet)
    jmodel = jax_mtwavenet.FourBranchResNet50(num_classes=CLASSES, pool="none")
    variables = numpy_init(jmodel, jnp.asarray(x), train=True, seed=4)
    width = 256 * 2 * 3
    assert variables["params"]["_BandedStagedResNet_0"]["branch_ln"]["scale"].shape == (width,)
    ref, _, (tr_ref, _), tr_vars = _run(jmodel, variables, x, seed=5)
    monkeypatch.setattr(mtwavenet, "BandedStagedResNet", NarrowStaged)
    with pytest.raises(ValueError, match="image_size"):
        get_model("mtwavenet50", device="cpu", num_classes=CLASSES, pool="none")(
            torch.from_numpy(x))
    model = get_model("mtwavenet50", device="cpu", num_classes=CLASSES, pool="none",
                      image_size=(40, 72))
    assert model.backbone.out_dim == width
    assert model.branch_classifier.weight.shape == (CLASSES, width)
    load_jax_variables(model, variables)
    with torch.no_grad():
        out, _ = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref[0]), rtol=0, atol=1e-4)
    keep = torch.from_numpy(np.asarray(_intermediate(tr_vars["intermediates"], "Dropout_0")) != 0)
    monkeypatch.setattr(mtwavenet, "apply_dropout", _dropout_with(keep))
    with torch.no_grad():
        logits, _ = model.train()(torch.from_numpy(x), {})
    assert len(logits) == len(tr_ref) == 4
    for ours, r in zip(logits, tr_ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-3 * max(1.0, float(np.abs(np.asarray(r)).max())))
