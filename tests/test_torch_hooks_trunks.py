"""``capture_features`` against irw_tpu's with every path kept
(``tests/test_torch_hooks.py`` holds the flagship under the default
filter): the same keys as flax's ``capture_intermediates`` and the values
within 1e-4, in eval mode, on seeded numpy inputs and weights
(``numpy_init`` from ``jax.eval_shape``, carried by the bridge).

The models: the ``configs/model`` files ``convnext``
(``RetrievalNet`` over ConvNeXt-T) and ``resnet`` (over ResNet-18), where
the default filter (``Block_(2|5|10)\\b|fusion|Head``) keeps
``ConvNeXtBlock_2/5/10`` and ``BasicBlock_2/5``; ``wcnn_attention`` over
ResNet-18s (the per-band trunks stacked on a leading axis, as flax's
``vmap`` stacks them; the subband gate's shared MLP as ``Sequential_0``);
``SharedDinoHashing`` (its port-only ``SharedViT`` wrapper records
nothing); and the small flagship, unscanned and scanned.

Images are 32², band stacks 16²; the convolutions' channels-first outputs
are recorded channels-last, as flax computes them.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.hooks import capture_features as jax_capture_features
from irw_tpu.models import get_model as jax_get_model
from irw_tpu_torch.bridge import load_jax_variables
from irw_tpu_torch.config import compose
from irw_tpu_torch.hooks import capture_features
from irw_tpu_torch.hooks.instrumentation import _default_filter
from irw_tpu_torch.models import get_model
from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
from test_torch_fusion_heads import numpy_init
from test_torch_hooks import FUSION
from test_torch_hooks import _pair as flagship_pair

TOL = 1e-4
IMAGES, BANDS = (2, 32, 32, 3), (2, 4, 16, 16, 3)


def _every_path(_path, _value) -> bool:
    return True


def _config(config):
    cfg = compose(CONFIG_DIR, "default", [f"model={config}"])
    return cfg.model.name, cfg.model.kwargs.to_dict()


def _same_captures(jmodel, variables, model, x) -> dict:
    """Every path of both captures: the same keys, shapes and values."""
    ref = jax.jit(lambda v, b: jax_capture_features(jmodel, v, b, filter_fn=_every_path)[2])(
        variables, jnp.asarray(x))
    _, _, ours = capture_features(model, torch.from_numpy(x), filter_fn=_every_path)
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        value = np.asarray(value, np.float32)
        assert tuple(ours[key].shape) == value.shape, key
        scale = max(float(np.abs(value).max()), 1.0)
        np.testing.assert_allclose(ours[key].numpy(), value, rtol=0, atol=TOL * scale,
                                   err_msg=key)
    return ref


CASES = {
    "convnext": (*_config("convnext"), IMAGES),
    "resnet": (*_config("resnet"), IMAGES),
    "wcnn_attention": ("wcnn_attention", {"backbone": "resnet18"}, BANDS),
    "shared_dino_hashing": ("shared_dino_hashing",
                            {"backbone": "test_tiny", "fusion_config": FUSION}, (2, 4, 16, 16, 3)),
}
# what the default filter keeps of each
DEFAULT_BLOCKS = {"convnext": {"ConvNeXtBlock_2", "ConvNeXtBlock_5", "ConvNeXtBlock_10"},
                  "resnet": {"BasicBlock_2", "BasicBlock_5"}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_capture_features_matches_jax(case):
    name, kwargs, shape = CASES[case]
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    jmodel = jax_get_model(name, **kwargs)
    variables = numpy_init(jmodel, jnp.asarray(x), seed=1, train=True)
    port_kwargs = dict(kwargs, vit_kwargs={"img_size": 16}) if "fusion_config" in kwargs else kwargs
    model = get_model(name, device="cpu", **port_kwargs)
    load_jax_variables(model, variables)
    ref = _same_captures(jmodel, variables, model.eval(), x)
    kept = {k.split("/")[1] for k in ref if _default_filter(tuple(k.split("/")), None)
            and k.startswith("backbone/")}
    assert kept == DEFAULT_BLOCKS.get(case, set())


@pytest.mark.parametrize("scan", [False, True], ids=["unscanned", "scanned"])
def test_flagship_every_path_matches_jax(scan):
    """The small flagship of ``tests/test_torch_hooks.py`` with every path
    kept: the patch embedding's ``PatchEmbed_0`` and its conv grid, the
    towers' (features, aux) pairs, nothing inside a scanned stack."""
    jmodel, variables, model, bands = flagship_pair(scan)
    ref = _same_captures(jmodel, variables, model, bands)
    assert any(k.endswith("PatchEmbed_0/Conv_0/__call__/[0]") for k in ref)
    assert not any("/blocks/" in k for k in ref)
